"""paddle.autograd: the port of ``paddle_tpu/autograd/__init__.py``.

Grad-mode guards, ``backward``, ``grad`` (GeneralGrad, eager/general_grad.h),
``PyLayer``, ``saved_tensors_hooks`` and the functional ``jacobian`` /
``hessian``, all on ``torch.autograd``:

- ``grad`` is ``torch.autograd.grad``; with ``create_graph=True`` the
  gradient is itself recorded, so ``grad`` of a gradient is a second
  derivative (the reference replays its tape as one jax function for this);
- ``PyLayer.apply`` runs a ``torch.autograd.Function`` whose forward and
  backward call the user's static methods on Tensors; a backward written in
  paddle ops is differentiable again, as the reference's PyLayer contract
  says;
- ``jacobian`` / ``hessian`` are ``torch.autograd.functional``'s.
"""
from __future__ import annotations

import functools

import torch

from ..core import dispatch as _dispatch
from ..core.tensor import Tensor
from .tape import run_backward

__all__ = [
    "backward", "grad", "no_grad", "enable_grad", "set_grad_enabled",
    "is_grad_enabled", "PyLayer", "PyLayerContext", "jacobian", "hessian",
    "saved_tensors_hooks",
]


class _GradGuard:
    """Context manager + decorator (paddle.no_grad / enable_grad)."""

    def __init__(self, mode: bool):
        self._mode = mode
        self._prev = None

    def __enter__(self):
        self._prev = _dispatch.set_grad_enabled(self._mode)
        return self

    def __exit__(self, *exc):
        _dispatch.set_grad_enabled(self._prev)
        return False

    def __call__(self, fn):
        if not callable(fn):
            raise TypeError("no_grad used as decorator needs a callable")
        mode = self._mode

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with _GradGuard(mode):
                return fn(*a, **k)
        return wrapper


class no_grad(_GradGuard):
    def __init__(self):
        super().__init__(False)


class enable_grad(_GradGuard):
    def __init__(self):
        super().__init__(True)


class set_grad_enabled(_GradGuard):
    def __init__(self, mode: bool):
        super().__init__(mode)


def is_grad_enabled() -> bool:
    return _dispatch.grad_enabled()


def backward(tensors, grad_tensors=None, retain_graph=False):
    tensors = tensors if isinstance(tensors, (list, tuple)) else [tensors]
    if grad_tensors is not None and not isinstance(grad_tensors,
                                                   (list, tuple)):
        grad_tensors = [grad_tensors]
    run_backward(list(tensors), grad_tensors, retain_graph=retain_graph)


def _unused():
    return RuntimeError("one of the input tensors received no gradient; pass "
                        "allow_unused=True to get None instead")


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """paddle.grad: gradients of ``outputs`` with respect to ``inputs``,
    without touching any ``.grad``. With ``create_graph=True`` the results
    are recorded too (they do not stop gradient), for higher orders."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None and not isinstance(grad_outputs,
                                                   (list, tuple)):
        grad_outputs = [grad_outputs]
    if grad_outputs is None:
        grad_outputs = [None] * len(outputs)
    if retain_graph is None:
        retain_graph = create_graph
    outs, cts = [], []
    for t, g in zip(outputs, grad_outputs):
        a = t._data
        if t._sg or not a.requires_grad:
            continue
        outs.append(a)
        cts.append(torch.ones_like(a) if g is None else
                   (g._data if isinstance(g, Tensor) else
                    torch.as_tensor(g, dtype=a.dtype, device=a.device)))
    wanted = [i for i, t in enumerate(inputs)
              if not t._sg and t._data.requires_grad]
    found = [None] * len(inputs)
    if outs and wanted:
        res = torch.autograd.grad(outs, [inputs[i]._data for i in wanted],
                                  cts, retain_graph=retain_graph,
                                  create_graph=create_graph,
                                  allow_unused=True)
        for i, g in zip(wanted, res):
            found[i] = g
    result = []
    for g in found:
        if g is None:
            if not allow_unused:
                raise _unused()
            result.append(None)
        else:
            result.append(Tensor._wrap(g, stop_gradient=not create_graph))
    return result


# ---------------------------------------------------------------------------
# PyLayer: user-defined autograd function (reference eager/pylayer)
# ---------------------------------------------------------------------------
#: active (pack, unpack) hook pairs for tensors a PyLayer saves for backward
_saved_tensors_hooks = []


class saved_tensors_hooks:
    """Context manager: pack_hook(tensor) runs when a PyLayer saves a tensor
    for backward, unpack_hook(packed) when its backward reads it back (the
    CPU-offload / recompute seam)."""

    def __init__(self, pack_hook, unpack_hook):
        self.pack_hook = pack_hook
        self.unpack_hook = unpack_hook

    def __enter__(self):
        _saved_tensors_hooks.append((self.pack_hook, self.unpack_hook))
        return self

    def __exit__(self, *exc):
        _saved_tensors_hooks.pop()
        return False


class PyLayerContext:
    def __init__(self, torch_ctx=None):
        self._torch_ctx = torch_ctx
        self._saved = ()
        self._unpack = None
        self._slots = None       # Tensor positions saved on the torch ctx
        self.materialize_grads = True
        self._non_differentiable = ()

    def save_for_backward(self, *tensors):
        """Without hooks the tensors are saved on the torch ctx, which keeps
        no reference cycle and serves them to a higher-order backward."""
        self._unpack = None
        if _saved_tensors_hooks:
            pack, unpack = _saved_tensors_hooks[-1]
            self._saved = tuple(pack(t) for t in tensors)
            self._unpack = unpack
        elif self._torch_ctx is not None:
            self._slots = [isinstance(t, Tensor) for t in tensors]
            self._saved = tuple(None if s else t
                                for s, t in zip(self._slots, tensors))
            self._torch_ctx.save_for_backward(
                *(t._data for t in tensors if isinstance(t, Tensor)))
        else:
            self._saved = tensors

    def _unpacked(self):
        if self._unpack is not None:
            return tuple(self._unpack(p) for p in self._saved)
        if self._slots is None:
            return self._saved
        stored = iter(self._torch_ctx.saved_tensors)
        out = []
        for is_tensor, v in zip(self._slots, self._saved):
            if is_tensor:
                a = next(stored)
                v = Tensor._wrap(a, not a.requires_grad)
            out.append(v)
        return tuple(out)

    @property
    def saved_tensor(self):
        return self._unpacked()

    def saved_tensors(self):
        return self._unpacked()

    def mark_non_differentiable(self, *tensors):
        self._non_differentiable = tensors

    def set_materialize_grads(self, value: bool):
        self.materialize_grads = bool(value)


class _PyLayerFunction(torch.autograd.Function):
    """The torch Function behind every PyLayer: the positional Tensor
    arguments are its inputs, everything else rides in ``spec``."""

    @staticmethod
    def forward(ctx, layer, spec, kwargs, meta, *arrays):
        pctx = PyLayerContext(ctx)
        ctx.pctx, ctx.layer = pctx, layer
        ctx.in_dtypes = [a.dtype for a in arrays]
        args = [(Tensor._wrap(arrays[v], sg) if kind == "T" else v)
                for kind, v, sg in spec]
        outs = layer.forward(pctx, *args, **kwargs)
        single = not isinstance(outs, (tuple, list))
        out_list = [outs] if single else list(outs)
        meta["single"] = single
        meta["tensor_pos"] = [i for i, o in enumerate(out_list)
                              if isinstance(o, Tensor)]
        nondiff = {id(t) for t in pctx._non_differentiable}
        res = [o._data if isinstance(o, Tensor) else o for o in out_list]
        marked = [r for o, r in zip(out_list, res) if id(o) in nondiff]
        if marked:
            ctx.mark_non_differentiable(*marked)
        ctx.set_materialize_grads(pctx.materialize_grads)
        ctx.tensor_pos = meta["tensor_pos"]
        return res[0] if single else tuple(res)

    @staticmethod
    def backward(ctx, *grads):
        cts = [None if grads[i] is None
               else Tensor._wrap(grads[i], not grads[i].requires_grad)
               for i in ctx.tensor_pos]
        gin = ctx.layer.backward(ctx.pctx, *cts)
        gin = [gin] if isinstance(gin, Tensor) or gin is None else list(gin)
        # one gradient per floating Tensor input, in order (the reference's
        # diff_inputs)
        it = iter(gin)
        out = []
        for dt in ctx.in_dtypes:
            g = next(it, None) if (dt.is_floating_point or dt.is_complex) \
                else None
            if isinstance(g, Tensor):
                g = g._data
            out.append(None if g is None else g.to(dt))
        return (None, None, None, None, *out)


class PyLayer:
    """Subclass with static forward(ctx, *args) / backward(ctx, *grads)."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def apply(cls, *args, **kwargs):
        spec, arrays = [], []
        for a in args:
            if isinstance(a, Tensor):
                spec.append(("T", len(arrays), a._sg))
                arrays.append(a._data)
            else:
                spec.append(("V", a, None))
        meta = {}
        out = _PyLayerFunction.apply(cls, spec, kwargs, meta, *arrays)
        res = [out] if meta["single"] else list(out)
        tensor_pos = set(meta["tensor_pos"])
        wrapped = [Tensor._wrap(r, not r.requires_grad)
                   if i in tensor_pos else r for i, r in enumerate(res)]
        return wrapped[0] if meta["single"] else tuple(wrapped)


# ---------------------------------------------------------------------------
# Functional higher-order API (paddle.autograd.jacobian / hessian)
# ---------------------------------------------------------------------------
def _as_pure(func):
    def pure(*arrays):
        out = func(*(Tensor._wrap(a, stop_gradient=not a.requires_grad)
                     for a in arrays))
        return out._data if isinstance(out, Tensor) else out
    return pure


def jacobian(func, xs, create_graph=False):
    xs_l = xs if isinstance(xs, (list, tuple)) else [xs]
    jac = torch.autograd.functional.jacobian(
        _as_pure(func), tuple(x._data.detach() for x in xs_l))
    outs = [Tensor._wrap(j) for j in jac]
    return outs[0] if not isinstance(xs, (list, tuple)) else outs


def hessian(func, xs, create_graph=False):
    xs_l = xs if isinstance(xs, (list, tuple)) else [xs]
    hes = torch.autograd.functional.hessian(
        _as_pure(func), tuple(x._data.detach() for x in xs_l))
    if not isinstance(xs, (list, tuple)):
        return Tensor._wrap(hes[0][0])
    return tuple(tuple(Tensor._wrap(h) for h in row) for row in hes)
