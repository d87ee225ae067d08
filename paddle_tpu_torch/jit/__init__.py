"""paddle.jit on torch: the port of ``paddle_tpu/jit/__init__.py``
(reference: paddle.jit.to_static, jit/api.py:195).

The reference traces a whole step (forward, ``loss.backward()``,
``optimizer.step()``) into one XLA program by threading the device state
through it. The port keeps that design and its observable contract: the
guarded specializations, the dynamic-dim shape families and buckets,
``report()``, the flags, the counters, ``save``/``load``. Only the program
changes:

    state_in (params, buffers, opt slots, scaler) ─┐
    seed (drawn from the port's Generator) ────────┤ graph ── outputs
    args (batch) ──────────────────────────────────┘   ├── rebound state
                                                       └── guard values

- **trace**: ``make_fx(..., tracing_mode="fake")`` of the pure step, once per
  specialization and input shape. The backward and the optimizer's in-place
  update are traced into the same graph; a state tensor written in place is
  a mutated graph input, one rebound (``_assign_array``) a graph output.
- **compile**: the graph goes to a ``torch.compile`` backend, called as
  torch.compile calls it after dynamo: ``"inductor"`` by default,
  ``to_static(backend=...)`` picks another, and ``_testing.force_cpu()``
  makes ``"aot_eager"`` the default. Dynamo itself is skipped: on a
  large train step its retrace of the already flat aten graph costs more
  than the backend's own work, and its guards could only recompile or fall
  back. A graph is compiled once, for the input signature it was traced
  at (shapes, strides, dtypes, devices, grad mode).
- **save**: ``torch.export`` (non-strict), ``-1``/``None`` dims as
  ``torch.export.Dim``.

Randomness is threaded as a seed (core/generator.py): each call takes
``Generator.next_seed()`` as an input and the trace draws from it.

A call runs eagerly for the reference's four reasons only, each with its
warning and its ``report()`` field: a value read the trace cannot follow
(``fallback``), the specialization cap, a volatile float guard, and the
dynamic-shape cap (``shape_overflowed``). Errors of the backend compiler or
of a kernel raise.
"""
from __future__ import annotations

import functools
import sys
import threading
import time
import warnings
import weakref
from typing import Any, List

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..core import generator as gen_mod
from ..core import tensor as _tensor_mod
from ..core.flags import get_flag
from ..core.tensor import Tensor, TracedValueError
from ..observability import compile_tracker as _ct
from ..observability import metrics as _omet

# the backend of to_static when the caller names none (force_cpu sets
# "aot_eager": inductor's C++ compile costs tens of seconds on a CPU)
_DEFAULT_BACKEND = ["inductor"]


def set_default_backend(name):
    """Sets the torch.compile backend of later ``to_static`` programs that
    name none; returns the previous one."""
    prev = _DEFAULT_BACKEND[0]
    _DEFAULT_BACKEND[0] = name
    return prev


def default_backend():
    return _DEFAULT_BACKEND[0]


def _collect_objects(args):
    """Find Layers/Optimizers/GradScalers among positional objects."""
    from ..nn.layer.layers import Layer
    from ..optimizer.optimizer import Optimizer
    layers, opts, scalers = [], [], []
    for a in args or ():
        if isinstance(a, Layer):
            layers.append(a)
        elif isinstance(a, Optimizer):
            opts.append(a)
        elif hasattr(a, "_scale") and hasattr(a, "step"):
            scalers.append(a)
    return layers, opts, scalers


def _state_tensors(layers, opts, scalers) -> List[Tensor]:
    seen = set()
    out = []

    def add(t):
        if t is not None and id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    for lay in layers:
        for _, p in lay.named_parameters():
            add(p)
        for _, b in lay.named_buffers():
            add(b)
    for o in opts:
        for t in o._state_tensors():
            add(t)
    for s in scalers:
        for t in s._trace_state():
            add(t)
    return out


def _tree_flatten_args(args, kwargs):
    """Flatten (args, kwargs) into (arrays, treedef-with-static-leaves)."""
    leaves, treedef = pytree.tree_flatten((args, kwargs))
    arrays = []
    spec = []  # ("T", stop_gradient) | ("S", value)
    for leaf in leaves:
        if isinstance(leaf, Tensor):
            arrays.append(leaf._data)
            spec.append(("T", leaf.stop_gradient))
        else:
            spec.append(("S", leaf))
    return arrays, (treedef, tuple(spec))


def _tree_unflatten_args(arrays, meta):
    treedef, spec = meta
    arrays = list(arrays)
    leaves = []
    for s in spec:
        if s[0] == "T":
            leaves.append(Tensor._wrap(arrays.pop(0), stop_gradient=s[1]))
        else:
            leaves.append(s[1])
    return pytree.tree_unflatten(leaves, treedef)


def _flatten_out(out):
    leaves, treedef = pytree.tree_flatten(out)
    arrays = []
    spec = []
    for leaf in leaves:
        if isinstance(leaf, Tensor):
            arrays.append(leaf._data)
            spec.append("T")
        else:
            spec.append(("S", leaf))
    return arrays, (treedef, spec)


def _unflatten_out(arrays, spec):
    treedef, kinds = spec
    arrays = list(arrays)
    leaves = []
    for k in kinds:
        if k == "T":
            leaves.append(Tensor._wrap(arrays.pop(0), stop_gradient=True))
        else:
            leaves.append(k[1])
    return pytree.tree_unflatten(leaves, treedef)


# --------------------------------------------------------------------------
# Guarded specialization (the reference's SOT equivalent, jit/__init__.py
# :109-284): python control flow on tensor VALUES surfaces as a
# scalarization through the Tensor seam (core/tensor.py). In probe mode
# (eager) each (kind, value) is recorded: the decision trace of one
# specialization. In replay mode (under the trace) each query is answered
# from the recorded decisions and the queried value becomes an extra
# program output (the guard). A call validates the guards of the
# specialization it ran and, on a mismatch, re-probes eagerly with the
# caller's state untouched (decision specializations never donate).
# --------------------------------------------------------------------------
class GraphBreak(Exception):
    """Python control flow consumed a traced tensor value (query #idx)."""

    def __init__(self, kind, index):
        self.kind = kind
        self.index = index
        super().__init__(
            f"graph break: python {kind}() on a traced tensor "
            f"(scalarization query #{index})")


class _ProbeCtx:
    __slots__ = ("decisions",)

    def __init__(self):
        self.decisions = []


class _ReplayCtx:
    __slots__ = ("decisions", "idx", "preds")

    def __init__(self, decisions):
        self.decisions = decisions
        self.idx = 0
        self.preds = []


class _CtxStack(threading.local):
    """Per-thread probe/replay stack: a trace in one thread must not
    hijack Tensor scalarizations happening on other threads (data
    prefetch, logging)."""

    def __init__(self):
        self.items: List[Any] = []

    def __bool__(self):
        return bool(self.items)

    def append(self, x):
        self.items.append(x)

    def pop(self):
        return self.items.pop()

    def __getitem__(self, i):
        return self.items[i]


_ctx_stack = _CtxStack()

_CONCRETIZE = {
    "bool": lambda a: bool(a),
    "int": lambda a: int(a),
    "float": lambda a: float(a),
    "item": lambda a: a.item(),
}


def _decisions_match(a, b):
    """Compare decision traces; float-valued float()/item() guards get
    a small relative tolerance — the compiled program may differ from
    the eager probe by an ulp (fusion/reduction order), and exact
    equality would ping-pong probe/compiled forever.

    CAVEAT (documented contract): float guards are therefore
    APPROXIMATE. A live value landing within 1e-6 of the recorded one
    but on the other side of a user threshold (``if x.item() > 0.5``
    with values 0.5 +/- 5e-7) validates the cached specialization and
    takes the recorded branch. Mixed-sign pairs never match (the most
    common threshold is 0); user code comparing against knife-edge
    constants at sub-1e-6 resolution should branch on int/bool guards
    instead."""
    if len(a) != len(b):
        return False
    for (ka, va), (kb, vb) in zip(a, b):
        if ka != kb:
            return False
        if isinstance(va, float) and isinstance(vb, float):
            if (va > 0) != (vb > 0):
                return False       # sign flip: always re-probe
            if va != vb and not (
                    abs(va - vb) <= 1e-6 * max(1.0, abs(va), abs(vb))):
                return False
        elif va != vb:
            return False
    return True


def _scalarize_interceptor(kind, array):
    if not _ctx_stack:
        return False, None
    ctx = _ctx_stack[-1]
    if isinstance(ctx, _ProbeCtx):
        val = _CONCRETIZE[kind](array.detach())
        ctx.decisions.append((kind, val))
        return True, val
    i = ctx.idx
    if i >= len(ctx.decisions) or ctx.decisions[i][0] != kind:
        raise GraphBreak(kind, i)
    ctx.idx += 1
    ctx.preds.append(array.detach().reshape(()))
    return True, ctx.decisions[i][1]


_tensor_mod.set_scalarize_interceptor(_scalarize_interceptor)

#: default cap on cached specializations per input signature; the LIVE
#: value is FLAGS_max_specializations (this constant is its default and
#: is kept for back-compat readers)
MAX_SPECIALIZATIONS = 8

#: weak registry of StaticFunctions for the module-level report API
_static_functions: "weakref.WeakSet" = weakref.WeakSet()


def _consistent(decisions, observed):
    """True when a spec's decisions agree with an observed (kind, value)
    prefix from another spec's run — same queries up to the shorter."""
    n = min(len(decisions), len(observed))
    return _decisions_match(tuple(decisions[:n]), tuple(observed[:n]))


class _Spec:
    __slots__ = ("decisions", "jitted", "out_spec", "hits")

    def __init__(self, decisions):
        self.decisions = decisions
        self.jitted = None          # set by StaticFunction._build
        self.out_spec = None        # set by this spec's own trace
        self.hits = 0


def _float_thrash(new, old):
    """True when two decision traces differ ONLY in float-valued
    float()/item() guards — the raw value of a logged loss, never
    stable call-to-call. Compiling one specialization per observed
    float would burn a full compile every step."""
    if len(new) != len(old):
        return False
    diff = [(a, b) for a, b in zip(new, old) if a != b]
    return bool(diff) and all(
        a[0] == b[0] and a[0] in ("float", "item")
        and isinstance(a[1], float) and isinstance(b[1], float)
        for a, b in diff)


def _untraceable_errors():
    """The exceptions that mean "a value was read that the trace cannot
    follow" (the reference's TracerBoolConversionError family)."""
    out = [TracedValueError]
    try:
        from torch._subclasses import fake_tensor as ft
        out += [getattr(ft, n) for n in ("DataDependentOutputException",
                                         "DynamicOutputShapeException")
                if hasattr(ft, n)]
    except ImportError:
        pass
    try:
        from torch.fx.experimental import symbolic_shapes as ss
        if hasattr(ss, "GuardOnDataDependentSymNode"):
            out.append(ss.GuardOnDataDependentSymNode)
    except ImportError:
        pass
    return tuple(out)


_UNTRACEABLE = None


def _untraceable():
    global _UNTRACEABLE
    if _UNTRACEABLE is None:
        _UNTRACEABLE = _untraceable_errors()
    return _UNTRACEABLE


def _trainable(a):
    return a.is_floating_point() or a.is_complex()


_SLOTS = ("_data", "_sg", "_leaf", "_grad_t", "_grad_of", "_version")


class _tracing:
    """Marks this thread as tracing (``core.tensor.tracing()``)."""

    def __enter__(self):
        _tensor_mod._TRACING.depth = getattr(_tensor_mod._TRACING,
                                             "depth", 0) + 1

    def __exit__(self, *exc):
        _tensor_mod._TRACING.depth -= 1
        return False


def _install(t, a):
    """Puts the traced array ``a`` into state tensor ``t`` (a trainable
    one as a fresh leaf, so the traced backward reaches it)."""
    if not t._sg and _trainable(a):
        x = a.detach().requires_grad_(True)
        t._data = t._leaf = x
    else:
        t._data = a
        t._leaf = None
    t._grad_t = None
    t._grad_of = None
    return t._data, t._data._version


class _Graph:
    """One traced and compiled program: a specialization at one input
    signature."""
    __slots__ = ("run", "n_out", "rebound", "mutated", "draws", "gm",
                 "trace_s", "compile_s")


class _Executable:
    """A specialization's executable: one graph per input signature
    (shapes, dtypes, devices, grad mode), traced and compiled on first
    use, like a jitted function's executable cache."""

    def __init__(self, sf, spec, meta, donate):
        self._sf = sf
        self._spec = spec
        self._meta = meta
        self._donate = donate
        self._graphs = {}
        self._zero_seed = {}

    def _cache_size(self):
        return len(self._graphs)

    def _seed(self, device, g):
        """The seed input: drawn from the generator for a graph that
        draws, a fixed zero for one that does not."""
        s = gen_mod.default_generator().next_seed()
        if g is not None and g.draws == 0:
            z = self._zero_seed.get(device)
            if z is None:
                z = self._zero_seed[device] = torch.zeros(
                    (), dtype=torch.int64, device=device)
            return z
        return torch.tensor(s, dtype=torch.int64, device=device)

    def __call__(self, state_arrays, arg_arrays):
        key = (torch.is_grad_enabled(),) + tuple(
            (tuple(a.shape), a.stride(), a.dtype, a.device)
            for a in (*state_arrays, *arg_arrays))
        g = self._graphs.get(key)
        first = (arg_arrays or state_arrays)
        device = first[0].device if first else torch.device("cpu")
        seed = self._seed(device, g)
        if g is None:
            g = self._trace(state_arrays, seed, arg_arrays)
            self._graphs[key] = g
        with torch.no_grad():
            flat = g.run(*state_arrays, seed, *arg_arrays)
        flat = list(flat)
        n = g.n_out
        k = n + len(g.rebound)
        return (flat[:n], list(zip(g.rebound, flat[n:k])), g.mutated,
                flat[k:])

    def _trace(self, state_arrays, seed, arg_arrays):
        from torch.fx.experimental.proxy_tensor import make_fx
        sf, spec = self._sf, self._spec
        g = _Graph()
        layout = {}
        pure = sf._make_pure(spec, self._meta, layout)
        ns = len(state_arrays)

        def flat_fn(*flat):
            return pure(list(flat[:ns]), flat[ns], list(flat[ns + 1:]))
        _ct.note_trace()
        t0 = time.perf_counter()
        gm = make_fx(flat_fn, tracing_mode="fake",
                     _allow_non_fake_inputs=True)(
            *state_arrays, seed, *arg_arrays)
        g.n_out, g.rebound, g.mutated, g.draws = (
            layout["n_out"], layout["rebound"], layout["mutated"],
            layout["draws"])
        g.trace_s = time.perf_counter() - t0
        if get_flag("FLAGS_print_jaxpr"):
            print(f"to_static {sf._name}: traced graph\n{gm.code}",
                  file=sys.stderr)
        g.gm = gm
        # the backend compiles the traced graph as torch.compile hands it a
        # graph after dynamo: dynamo's own retrace of an already flat aten
        # graph (and its guards, which can only recompile) is skipped
        t0 = time.perf_counter()
        with torch.no_grad():
            g.run = sf._compile(gm, [*state_arrays, seed, *arg_arrays])
        g.compile_s = time.perf_counter() - t0
        return g


class StaticFunction:
    def __init__(self, fn, objs=None, donate_states=True, backend=None,
                 input_spec=None, pad_dynamic_dims=False,
                 pad_mask_arg=None):
        self._fn = fn
        self._objs = objs
        self._donate = donate_states
        self._backend = backend
        self._cache = {}          # signature -> entry dict
        # symbolic-shape surface (reference: PIR shape dialect /
        # InputSpec(-1) dims, SURVEY §2.4). Dims declared None/-1 in
        # input_spec are DYNAMIC: each concretization compiles once
        # (exact numerics; the graphs are static-shape), the set of
        # compiled shapes is reported (report()["shape_specializations"])
        # and capped by FLAGS_max_shape_specializations — past the cap new
        # shapes run eagerly instead of silently compiling forever.
        # pad_dynamic_dims=True instead PADS every dynamic dim up to
        # the next power-of-two bucket so ONE graph serves all sizes in a
        # bucket; outputs carrying the first dynamic dim's bucket size on
        # axis 0 are sliced back to the true size. Padded rows flow
        # through the function, so by default this mode is for
        # row-independent (inference-style) fns and refuses stateful
        # train-step objs.
        #
        # pad_mask_arg="name" lifts that refusal for TRAIN steps: the call
        # injects a float mask keyword argument `name` of shape [bucket] —
        # 1.0 on true positions of the FIRST dynamic dim, 0.0 on padding —
        # and the function contract is to use it as the loss weight. Pad
        # positions then carry exactly zero loss weight, so grads — and
        # therefore the optimizer/scaler state — match the unpadded run.
        # Right-padding is exact for causal models; non-causal models must
        # also mask attention themselves.
        self._dyn_dims = self._parse_dynamic_dims(input_spec)
        self._pad_dynamic = bool(pad_dynamic_dims)
        self._pad_mask_arg = pad_mask_arg
        if self._pad_dynamic and not self._dyn_dims:
            raise ValueError(
                "pad_dynamic_dims=True needs an input_spec with "
                "None/-1 dims to know which axes to bucket")
        if pad_mask_arg is not None and not self._pad_dynamic:
            raise ValueError(
                "pad_mask_arg requires pad_dynamic_dims=True")
        self._fn_sig = None
        if pad_mask_arg is not None:
            import inspect
            try:
                self._fn_sig = inspect.signature(fn)
            except (TypeError, ValueError):
                pass
        self._shape_family = set()
        self._shape_overflow = False
        self._slice_plans = {}
        if self._pad_dynamic and pad_mask_arg is None:
            check_objs = objs
            if check_objs is None:
                owner = getattr(fn, "__self__", None)
                check_objs = [owner] if owner is not None else []
            _, opts, scalers = _collect_objects(check_objs)
            if opts or scalers:
                raise ValueError(
                    "pad_dynamic_dims pads rows through the function, "
                    "which would corrupt stateful (optimizer/scaler) "
                    "updates — pass pad_mask_arg='<kwarg name>' and "
                    "weight the loss by that mask for bucketed TRAIN "
                    "steps, or use exact dynamic shapes "
                    "(pad_dynamic_dims=False)")
        functools.update_wrapper(self, fn, updated=[])
        _static_functions.add(self)
        qn = getattr(fn, "__qualname__", str(fn))
        self._name = qn
        self._m_calls = _omet.REGISTRY.counter("jit.fn_calls", fn=qn)
        self._m_hits = _omet.REGISTRY.counter("jit.fn_cache_hits", fn=qn)
        self._m_probes = _omet.REGISTRY.counter("jit.fn_probes", fn=qn)
        self._m_builds = _omet.REGISTRY.counter("jit.fn_builds", fn=qn)
        self._m_breaks = _omet.REGISTRY.counter(
            "jit.fn_graph_breaks", fn=qn)

    def _compile(self, gm, example_inputs):
        """The graph compiled by this function's torch.compile backend
        (a name or a callable), counted by the compile tracker. An error
        of the backend raises: the call never turns eager on it."""
        backend = self._backend or default_backend()
        if isinstance(backend, str):
            from torch._dynamo import lookup_backend
            backend = lookup_backend(backend)
        _ct.note_compile()
        return backend(gm, example_inputs)

    def _mask_bound_positionally(self, args, kwargs):
        """True when the call already binds the pad-mask parameter
        through its positionals. The signature is computed once."""
        if self._fn_sig is None:
            return False
        try:
            bound = self._fn_sig.bind_partial(*args, **kwargs)
            return self._pad_mask_arg in bound.arguments
        except TypeError:
            return False

    @staticmethod
    def _parse_dynamic_dims(input_spec):
        """[(tensor_leaf_index, dim_index)] for every None/-1 dim; the
        i-th InputSpec aligns with the i-th Tensor leaf of the call."""
        if not input_spec:
            return []
        out = []
        for li, s in enumerate(input_spec):
            shape = getattr(s, "shape", None)
            if shape is None:
                continue
            for di, d in enumerate(shape):
                if d in (-1, None):
                    out.append((li, di))
        return out

    @staticmethod
    def _bucket(n):
        n = int(n)
        return 1 if n <= 1 else 1 << (n - 1).bit_length()

    def _dyn_sizes(self, arg_arrays):
        """Concrete sizes of the declared dynamic dims, with a clear
        error when the call's rank disagrees with the InputSpec."""
        out = []
        for li, di in self._dyn_dims:
            if li >= len(arg_arrays):
                continue
            a = arg_arrays[li]
            if di >= a.ndim:
                raise ValueError(
                    f"input_spec declares dynamic dim {di} on tensor "
                    f"argument {li}, but the call passed a rank-"
                    f"{a.ndim} tensor of shape {tuple(a.shape)}")
            out.append((li, di, int(a.shape[di])))
        return out

    def _pad_args(self, arg_arrays):
        """Pad every dynamic dim to its power-of-two bucket; returns
        (padded arrays, (true size, padded size) of the first dynamic
        dim)."""
        arrays = list(arg_arrays)
        first = None
        for li, di, true in self._dyn_sizes(arg_arrays):
            a = arrays[li]
            pad = self._bucket(true) - true
            if first is None:
                first = (true, self._bucket(true))
            if pad:
                shape = list(a.shape)
                shape[di] = pad
                arrays[li] = torch.cat([a, a.new_zeros(shape)], dim=di)
        return arrays, first

    def _slice_plan(self, meta, unpadded_arrays, true, padded,
                    state=None):
        """Which output leaves actually DERIVE their axis 0 from the
        padded dim: shape-run the fn on fake UNPADDED inputs (no compute,
        no compile) and mark leaves whose dim 0 is the true size. A
        size-equality heuristic alone would also truncate batch-
        independent outputs that coincidentally carry the bucket size on
        axis 0. The state is swapped for fake tensors and restored."""
        key = (repr(meta[0]), tuple(tuple(a.shape) for a in unpadded_arrays))
        if key in self._slice_plans:
            return self._slice_plans[key]
        try:
            outs = self._fake_run(_Spec(()), meta, unpadded_arrays,
                                  state or [])
            plan = tuple(o.dim() >= 1 and o.shape[0] == true
                         for o in outs)
        except Exception:
            # untraceable fn: fall back to the dim0-size heuristic
            plan = None
        self._slice_plans[key] = plan
        return plan

    def _fake_run(self, spec, meta, arg_arrays, state):
        """The function's outputs as fake tensors (shapes only)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        layout = {}
        pure = self._make_pure(spec, meta, layout, shapes_only=True)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fs = [mode.from_tensor(t._data.detach()) for t in state]
            fa = [mode.from_tensor(a) for a in arg_arrays]
            seed = mode.from_tensor(torch.zeros((), dtype=torch.int64))
            flat = pure(fs, seed, fa)
        return flat[:layout["n_out"]]

    def _slice_outputs(self, result, true, padded, plan=None):
        """Undo the bucket padding on outputs derived from the first
        dynamic dim (per `plan`; dim0==padded heuristic when the fn is
        untraceable for the shape probe)."""
        if true == padded:
            return result
        leaves, treedef = pytree.tree_flatten(result)
        out = []
        for i, v in enumerate(leaves):
            take = (plan[i] if plan is not None and i < len(plan)
                    else (isinstance(v, Tensor) and v.ndim >= 1
                          and v.shape[0] == padded))
            if take and isinstance(v, Tensor) and v.ndim >= 1 and \
                    v.shape[0] == padded:
                v = v[:true]
            out.append(v)
        return pytree.tree_unflatten(out, treedef)

    def _resolve_objs(self):
        objs = self._objs
        if objs is None:
            # bound Layer method: use the owning layer
            owner = getattr(self._fn, "__self__", None)
            objs = [owner] if owner is not None else []
        return _collect_objects(objs)

    def _resolve_state(self):
        return _state_tensors(*self._resolve_objs())

    # -- report API (reference: sot graph-break / guard introspection) --
    def specializations(self):
        """Per input signature: the list of decision traces compiled."""
        return {sig: [s.decisions for s in e["specs"]]
                for sig, e in self._cache.items()}

    def report(self):
        out = []
        for sig, e in self._cache.items():
            out.append({
                "signature": repr(sig),
                "specializations": [
                    {"decisions": s.decisions, "hits": s.hits}
                    for s in e["specs"]],
                "graph_breaks": e["breaks"],
                "eager_probes": e["probes"],
                "fallback": e["fallback"],
            })
        return {"function": self._name,
                "signatures": out,
                "dynamic_dims": list(self._dyn_dims),
                "shape_specializations": sorted(self._shape_family),
                "shape_overflowed": self._shape_overflow,
                "pad_dynamic_dims": self._pad_dynamic,
                "pad_mask_arg": self._pad_mask_arg}

    def _finish(self, result, pad_slice, pad_plan):
        if pad_slice is not None:
            result = self._slice_outputs(result, *pad_slice, plan=pad_plan)
        return result

    def __call__(self, *args, **kwargs):
        if _ctx_stack or _tensor_mod.tracing():
            # already inside a to_static probe/replay or a trace: inline
            # into the enclosing program (the outer context owns the
            # scalarization decisions)
            return self._fn(*args, **kwargs)
        state = self._resolve_state()
        arg_arrays, meta = _tree_flatten_args(args, kwargs)
        if _omet._ENABLED:
            self._m_calls.inc()
        pad_slice = None
        pad_plan = None
        if self._dyn_dims:
            if self._pad_dynamic:
                unpadded = list(arg_arrays)
                arg_arrays, pad_slice = self._pad_args(arg_arrays)
                if self._pad_mask_arg is not None and \
                        pad_slice is None and \
                        self._pad_mask_arg not in kwargs and \
                        not self._mask_bound_positionally(args, kwargs):
                    # none of the declared dynamic dims bound to this
                    # call's tensor args AND the caller did not supply
                    # the mask themselves, so its length is unknowable
                    raise ValueError(
                        f"pad_mask_arg={self._pad_mask_arg!r}: this "
                        "call bound none of the input_spec's dynamic "
                        "(None/-1) dims, so the loss-weight mask's "
                        "length is unknown. Pass "
                        f"{self._pad_mask_arg!r} explicitly (all-ones "
                        "of the true length), or align input_spec "
                        "with the call's tensor arguments")
                if self._pad_mask_arg is not None and \
                        pad_slice is not None:
                    # inject the loss-weight mask for the first dynamic
                    # dim (1.0 true / 0.0 pad) and re-flatten so the mask
                    # rides the compiled signature; the slice-plan probe
                    # gets the matching all-ones mask at the TRUE size
                    true, padded = pad_slice
                    dev = arg_arrays[0].device
                    mask = torch.from_numpy(
                        (np.arange(padded) < true).astype(np.float32)
                    ).to(dev)
                    args_p, kwargs_p = _tree_unflatten_args(
                        list(arg_arrays), meta)
                    kwargs_p[self._pad_mask_arg] = Tensor._wrap(mask, True)
                    args_u, kwargs_u = _tree_unflatten_args(
                        list(unpadded), meta)
                    kwargs_u[self._pad_mask_arg] = Tensor._wrap(
                        torch.ones(true, device=dev), True)
                    arg_arrays, meta = _tree_flatten_args(
                        args_p, kwargs_p)
                    unpadded, _meta_u = _tree_flatten_args(
                        args_u, kwargs_u)
                if pad_slice is not None and \
                        pad_slice[0] != pad_slice[1]:
                    pad_plan = self._slice_plan(meta, unpadded,
                                                *pad_slice, state=state)
                args, kwargs = _tree_unflatten_args(arg_arrays, meta)
            else:
                dyn_key = tuple(
                    sz for _li, _di, sz in self._dyn_sizes(arg_arrays))
                if dyn_key not in self._shape_family:
                    cap = get_flag("FLAGS_max_shape_specializations")
                    if len(self._shape_family) >= cap:
                        if not self._shape_overflow:
                            warnings.warn(
                                f"to_static: {self._name} "
                                f"saw more than {cap} distinct dynamic "
                                "shapes (FLAGS_max_shape_"
                                "specializations); new shapes run "
                                "eagerly. Consider pad_dynamic_dims="
                                "True (bucketed) for inference fns",
                                stacklevel=2)
                            self._shape_overflow = True
                        return self._fn(*args, **kwargs)
                    self._shape_family.add(dyn_key)
        sig = (repr(meta[0]), tuple(
            s if s[0] == "S" and _hashable(s) else ("T",)
            for s in meta[1]), len(state))
        entry = self._cache.get(sig)
        if entry is None:
            entry = self._cache[sig] = {
                "specs": [], "mru": 0, "breaks": 0, "probes": 0,
                "fallback": None}
        if entry["fallback"] is not None:
            return self._finish(self._fn(*args, **kwargs), pad_slice,
                                pad_plan)

        if not entry["specs"]:
            # optimistic first specialization: no decisions
            spec0 = _Spec(())
            self._build(spec0, meta, donate=self._donate)
            entry["specs"].append(spec0)
            entry["mru"] = 0
        tried = set()
        idx = entry["mru"]
        while True:
            spec = entry["specs"][idx]
            tried.add(idx)
            try:
                ok, result, observed = self._run_spec(
                    spec, state, arg_arrays)
            except GraphBreak:
                entry["breaks"] += 1
                if _omet._ENABLED:
                    self._m_breaks.inc()
                if not spec.decisions:
                    entry["specs"].pop(idx)        # invalid skeleton
                    entry["mru"] = 0
                result = self._probe(entry, meta, args, kwargs)
                return self._finish(result, pad_slice, pad_plan)
            except _untraceable() as e:
                # a value read the trace cannot follow (numpy() of a
                # traced value, a raw torch scalar read, a draw with no
                # traced form): this signature stays eager
                warnings.warn(
                    f"to_static: {self._name} is not "
                    f"traceable ({type(e).__name__}); falling back to "
                    f"eager execution", stacklevel=2)
                entry["fallback"] = f"{type(e).__name__}: {e}"
                if not spec.decisions and spec in entry["specs"]:
                    entry["specs"].remove(spec)
                result = self._fn(*args, **kwargs)
                return self._finish(result, pad_slice, pad_plan)
            if ok:
                spec.hits += 1
                if _omet._ENABLED:
                    self._m_hits.inc()
                entry["mru"] = idx
                return self._finish(result, pad_slice, pad_plan)
            # guard mismatch: another cached specialization whose
            # decisions agree with the observed predicate values can
            # serve this call compiled; it re-validates its own guards
            nxt = None
            for i, s in enumerate(entry["specs"]):
                if i not in tried and _consistent(s.decisions, observed):
                    nxt = i
                    break
            if nxt is None:
                entry["breaks"] += 1
                if _omet._ENABLED:
                    self._m_breaks.inc()
                result = self._probe(entry, meta, args, kwargs)
                return self._finish(result, pad_slice, pad_plan)
            idx = nxt

    def _run_spec(self, spec, state, arg_arrays):
        """Returns (guards_ok, result, observed decision values); state
        committed only when guards pass. A specialization that does not
        donate runs on copies of the state."""
        donate = spec.jitted._donate
        state_arrays = [t._data.detach() for t in state]
        if not donate:
            state_arrays = [a.clone() for a in state_arrays]
        out_arrays, rebound, mutated, preds = spec.jitted(
            state_arrays, [a.detach().contiguous() for a in arg_arrays])
        if spec.decisions:
            # one device->host transfer for all guards
            host = torch.stack([p.to(torch.float64) for p in preds]).tolist()
            observed = []
            for h, p, (kind, _) in zip(host, preds, spec.decisions):
                if kind == "item":
                    kind_fn = (float if p.dtype.is_floating_point else
                               bool if p.dtype == torch.bool else int)
                else:
                    kind_fn = {"bool": bool, "int": int,
                               "float": float}[kind]
                observed.append((kind, kind_fn(h)))
        else:
            observed = []
        if not _decisions_match(observed, list(spec.decisions)):
            return False, None, observed
        with torch.no_grad():
            for i in mutated:
                if not donate:
                    state[i]._data.copy_(state_arrays[i])
                else:
                    state[i]._version += 1
        for i, a in rebound:
            state[i]._assign_array(a)
        for s in self._resolve_objs()[2]:
            s._compiled_step_ran()
        return True, _unflatten_out(out_arrays, spec.out_spec), observed

    def _probe(self, entry, meta, args, kwargs):
        """Eager probe: run the python function concretely, capturing
        the decision trace; then select or compile the matching
        specialization for future calls."""
        entry["probes"] += 1
        if _omet._ENABLED:
            self._m_probes.inc()
        ctx = _ProbeCtx()
        _ctx_stack.append(ctx)
        try:
            result = self._fn(*args, **kwargs)
        finally:
            _ctx_stack.pop()
        decisions = tuple(ctx.decisions)
        if not decisions:
            # the break did not come through the Tensor seam — nothing
            # to guard on; stay eager for this signature
            entry["fallback"] = "graph break outside the Tensor seam"
            return result
        for i, s in enumerate(entry["specs"]):
            if _decisions_match(s.decisions, decisions):
                entry["mru"] = i
                return result
        n_float_twins = sum(_float_thrash(decisions, s.decisions)
                            for s in entry["specs"])
        if n_float_twins >= 2:
            # raw float guards that never repeat (logged loss values):
            # at the third distinct value, stay eager for this signature
            warnings.warn(
                f"to_static: {self._name} consumes a "
                "volatile float tensor value in python "
                "(float()/item()); guards on it never repeat, so this "
                "signature stays eager", stacklevel=3)
            entry["fallback"] = "volatile float guard"
            return result
        cap = get_flag("FLAGS_max_specializations")
        if len(entry["specs"]) >= cap:
            warnings.warn(
                f"to_static: {self._name} exceeded {cap} specializations "
                "for one input signature (value-dependent control flow "
                "thrashes); falling back to eager execution", stacklevel=3)
            entry["fallback"] = "specialization limit exceeded"
            return result
        # decision specializations never donate: a later guard mismatch
        # must leave the caller's state intact for the re-probe
        spec = _Spec(decisions)
        self._build(spec, meta, donate=False)
        entry["specs"].append(spec)
        entry["mru"] = len(entry["specs"]) - 1
        return result

    def _build(self, spec, meta, donate):
        if _omet._ENABLED:
            self._m_builds.inc()
        spec.jitted = _Executable(self, spec, meta, donate)
        return spec

    def _make_pure(self, spec, meta, layout, shapes_only=False):
        """The step as a function of arrays: state in, (outputs, rebound
        state, guard values) out. ``layout`` receives what the caller
        needs to split the flat outputs: which state tensors were rebound
        (outputs) and which written in place (mutated inputs)."""
        fn = self._fn
        outer = self
        decisions = spec.decisions

        def pure(state_arrays, seed, arg_arrays):
            state = outer._resolve_state()
            saved = [tuple(getattr(t, s) for s in _SLOTS) for t in state]
            ctx = _ReplayCtx(decisions)
            _ctx_stack.append(ctx)
            draws = gen_mod.TracedDraws(seed)
            try:
                with _tracing(), gen_mod.trace_draws(draws):
                    installed = [_install(t, a)
                                 for t, a in zip(state, state_arrays)]
                    args, kwargs = _tree_unflatten_args(arg_arrays, meta)
                    out = fn(*args, **kwargs)
                    out_arrays, out_spec = _flatten_out(out)
                    if not shapes_only:
                        # each spec owns its out_spec (branches may
                        # return different pytree structures)
                        spec.out_spec = out_spec
                    rebound, mutated = [], []
                    for i, (t, (a, v0)) in enumerate(zip(state,
                                                         installed)):
                        if t._data is not a:
                            rebound.append(i)
                        elif a._version != v0:
                            mutated.append(i)
                    layout.update(n_out=len(out_arrays), rebound=rebound,
                                  mutated=mutated, draws=draws.n)
                    return tuple(
                        [a.detach() for a in out_arrays]
                        + [state[i]._data.detach() for i in rebound]
                        + ctx.preds)
            finally:
                _ctx_stack.pop()
                for t, vals in zip(state, saved):
                    for s, v in zip(_SLOTS, vals):
                        setattr(t, s, v)
        return pure


def sot_report():
    """Graph-break / specialization report across every to_static
    function (reference: paddle.jit.sot introspection utilities)."""
    return [sf.report() for sf in _static_functions]


def _hashable(s):
    try:
        hash(s)
        return True
    except TypeError:
        return False


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph=True, objs=None, donate=True,
              **kwargs):
    """paddle.jit.to_static equivalent.

    `objs`: the Layers / Optimizers / GradScalers whose device state the
    compiled program threads through (auto-detected for bound Layer
    methods). Compile a whole train step by passing [model, optimizer].
    `backend`: the torch.compile backend (a name or a callable); None is
    the default (``default_backend()``).
    """
    pad_dynamic_dims = kwargs.pop("pad_dynamic_dims", False)
    pad_mask_arg = kwargs.pop("pad_mask_arg", None)

    def decorate(fn):
        from ..nn.layer.layers import Layer
        if isinstance(fn, Layer):
            sf = StaticFunction(fn.forward, objs=[fn] + list(objs or ()),
                                donate_states=donate, backend=backend,
                                input_spec=input_spec,
                                pad_dynamic_dims=pad_dynamic_dims,
                                pad_mask_arg=pad_mask_arg)
            fn.forward = sf
            return fn
        return StaticFunction(fn, objs=objs, donate_states=donate,
                              backend=backend, input_spec=input_spec,
                              pad_dynamic_dims=pad_dynamic_dims,
                              pad_mask_arg=pad_mask_arg)
    if function is not None:
        return decorate(function)
    return decorate


def not_to_static(fn):
    return fn


def ignore_module(modules):
    pass


def enable_to_static(flag):
    pass


# ---------------------------------------------------------------------
# save / load over torch.export
# ---------------------------------------------------------------------
class _ExportModule(torch.nn.Module):
    """The forward of a port Layer as a torch Module for torch.export: the
    Layer's parameters and buffers are this module's buffers, put into
    the Layer's tensors for the trace and taken out after it."""

    def __init__(self, fn, state):
        super().__init__()
        self._fn = fn
        self._state = state
        for i, t in enumerate(state):
            self.register_buffer(f"state_{i}", t._data.detach())

    def forward(self, *xs):
        saved = [tuple(getattr(t, s) for s in _SLOTS) for t in self._state]
        try:
            for i, t in enumerate(self._state):
                t._data = getattr(self, f"state_{i}")
                t._leaf = t._grad_t = t._grad_of = None
            with _tracing():
                out = self._fn(*[Tensor._wrap(x) for x in xs])
            arrs, _ = _flatten_out(out)
            return tuple(arrs)
        finally:
            for t, vals in zip(self._state, saved):
                for s, v in zip(_SLOTS, vals):
                    setattr(t, s, v)


def _export(layer, input_spec):
    """torch.export (non-strict) of ``layer``'s forward at ``input_spec``:
    a -1/None dim is a ``torch.export.Dim`` of its own, traced at size 2 so
    that export does not specialize it to 0 or 1."""
    from ..core import dtype as dtype_mod
    from ..core.place import default_device
    from ..nn.layer.layers import Layer
    if isinstance(layer, Layer):
        fn = layer.forward
        state = _state_tensors([layer], [], [])
    else:
        fn, state = layer, []
    device = state[0]._data.device if state else default_device()
    examples, dyn = [], []
    for n, s in enumerate(input_spec):
        if isinstance(s, Tensor):
            examples.append(s._data)
            dyn.append(None)
            continue
        shape, dims = [], {}
        for di, d in enumerate(s.shape):
            if d in (-1, None):
                dims[di] = torch.export.Dim(f"d{n}_{di}", min=1,
                                            max=1 << 30)
                shape.append(2)
            else:
                shape.append(int(d))
        dt = dtype_mod.torch_dtype(s.dtype)
        examples.append(torch.zeros(shape, dtype=dt, device=device))
        dyn.append(dims or None)
    mod = _ExportModule(fn, state)
    with torch.no_grad():
        # forward(*xs): the varargs are one input of the export
        return torch.export.export(
            mod, tuple(examples), strict=False,
            dynamic_shapes=(tuple(dyn),) if any(dyn) else None)


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save (reference jit/api.py save): persists the
    state_dict (.pdiparams) and — when input_spec is given — the traced
    program as a ``torch.export`` archive (.pdmodel, weights frozen in it,
    the reference's inference-program analog) plus its graph's text
    (.graph.txt) for inspection."""
    from ..framework.io import save as _save
    from ..nn.layer.layers import Layer
    if isinstance(layer, Layer):
        _save(layer.state_dict(), path + ".pdiparams")
    if input_spec:
        ep = _export(layer, input_spec)
        with open(path + ".pdmodel", "wb") as f:
            torch.export.save(ep, f)
        with open(path + ".graph.txt", "w") as f:
            f.write(str(ep.graph))


class TranslatedLayer:
    """A loaded jit.save program, callable like the original Layer
    (reference jit/translated_layer.py: runs the saved inference program;
    here: the ExportedProgram's module)."""

    def __init__(self, program, state=None):
        self._program = program
        self._module = program.module()
        self._state = state or {}

    def forward(self, *args):
        arrs = [a._data if isinstance(a, Tensor) else torch.as_tensor(a)
                for a in args]
        with torch.no_grad():
            outs = self._module(*arrs)
        outs = [Tensor._wrap(o) for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)

    __call__ = forward

    def state_dict(self):
        return dict(self._state)

    def eval(self):
        return self

    def train(self):
        raise RuntimeError("TranslatedLayer is an inference program; "
                           "training it is not supported")


def load(path, **configs):
    """paddle.jit.load: returns a TranslatedLayer when a .pdmodel
    program exists, else the raw state dict (reference jit/api.py
    load)."""
    import os as _os
    from ..framework.io import load as _load
    state = None
    if _os.path.exists(path + ".pdiparams"):
        state = _load(path + ".pdiparams")
    if _os.path.exists(path + ".pdmodel"):
        # the library attention ops a program may call are registered
        # before the program is read
        from ..ops.hopper import flash_attention  # noqa: F401
        with open(path + ".pdmodel", "rb") as f:
            return TranslatedLayer(torch.export.load(f), state)
    return state


# --- dy2static logging knobs (reference jit/dy2static/logging_utils) ---
_verbosity = 0
_code_level = -1


def set_verbosity(level=0, also_to_stdout=False):
    global _verbosity
    _verbosity = int(level)


def set_code_level(level=100, also_to_stdout=False):
    global _code_level
    _code_level = int(level)


class InputSpec:
    """Static-shape declaration (reference paddle.static.InputSpec)."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=True):
        from ..core import dtype as dtype_mod
        self.shape = tuple(-1 if s is None else int(s) for s in shape)
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient


def _tree_split(vals):
    """Split a pytree of Tensors into (torch leaves, rebuild fn)."""
    leaves, treedef = pytree.tree_flatten(vals)
    arrs = [v._data if isinstance(v, Tensor) else v for v in leaves]
    was_tensor = [isinstance(v, Tensor) for v in leaves]

    def rebuild(new_arrs):
        new_leaves = [Tensor._wrap(a) if t else a
                      for a, t in zip(new_arrs, was_tensor)]
        return pytree.tree_unflatten(new_leaves, treedef)
    return arrs, rebuild


def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
    """paddle.static.nn.cond equivalent. Eager: a python branch. Under a
    trace: both branches run and each output is selected on ``pred`` with
    ``torch.where``, so the program stays one graph (the reference uses
    lax.cond)."""
    p = pred._data if isinstance(pred, Tensor) else pred
    if _tensor_mod.tracing() and isinstance(p, torch.Tensor):
        out_t = true_fn()
        if false_fn is None:
            if out_t is None:
                return None
            raise ValueError(
                "cond: false_fn is required under jit tracing when "
                "true_fn returns a value (both branches must produce the "
                "same structure)")
        out_f = false_fn()
        arrs_t, rebuild = _tree_split(out_t)
        arrs_f, _ = _tree_split(out_f)
        c = p.reshape(()).to(torch.bool)
        return rebuild([torch.where(c, a, b) for a, b in zip(arrs_t,
                                                             arrs_f)])
    concrete = bool(p)
    return true_fn() if concrete else (false_fn() if false_fn else None)


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """paddle.static.nn.while_loop equivalent: a python loop. Under a
    trace its condition is a value the trace cannot follow, so the call
    runs eagerly (the reference uses lax.while_loop)."""
    vars_ = list(loop_vars)
    r = cond_fn(*vars_)
    if _tensor_mod.tracing() and isinstance(r, (Tensor, torch.Tensor)):
        raise TracedValueError(
            "while_loop on a tensor condition inside a traced program")
    keep = bool(r._data if isinstance(r, Tensor) else r)
    while keep:
        out = body_fn(*vars_)
        vars_ = list(out) if isinstance(out, (list, tuple)) else [out]
        r = cond_fn(*vars_)
        keep = bool(r._data if isinstance(r, Tensor) else r)
    return vars_
