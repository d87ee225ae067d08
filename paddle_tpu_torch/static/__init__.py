"""paddle.static on torch: the port of ``paddle_tpu/static/__init__.py``.

Reference: Program/Executor (python/paddle/static, base/executor.py:1746 →
StandaloneExecutor → PirInterpreter). The reference's Program is an eager
facade: ``data()`` declares placeholder inputs, building ops under
``program_guard`` records a python callable, and ``Executor.run`` binds the
feeds and re-executes it. The port keeps that facade as it is; compiled
programs are ``jit.to_static``'s.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.place import CPUPlace, CUDAPlace, default_device, get_device, \
    set_device
from ..core.tensor import Parameter, Tensor
from ..jit import InputSpec  # noqa: F401
from ..nn.layer.layers import ParamAttr


class Variable(Tensor):
    """Placeholder tensor declared by static.data()."""

    pass


class Program:
    def __init__(self):
        self._inputs: Dict[str, Variable] = {}
        self._actions = []  # list of (fn, out_names)
        self._fetch_cache = {}
        self.random_seed = None

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self

    def record(self, fn):
        """Record a build function returning a Tensor / list / dict of
        Tensors. It runs once now (producing stable fetch handles — the
        Variables of the reference Program); Executor.run re-executes it
        and writes results back into those same handles."""
        originals = fn()
        self._actions.append((fn, originals))
        return originals

    _record = record

    def __repr__(self):
        return f"<Program inputs={list(self._inputs)} " \
               f"ops={len(self._actions)}>"


_default_main = Program()
_default_startup = Program()
_prog_stack: List[Program] = []


def default_main_program() -> Program:
    return _prog_stack[-1] if _prog_stack else _default_main


def default_startup_program() -> Program:
    return _default_startup


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    _prog_stack.append(main_program)
    try:
        yield
    finally:
        _prog_stack.pop()


def data(name, shape, dtype="float32", lod_level=0):
    """Declare a feed placeholder."""
    shape = [1 if s in (-1, None) else int(s) for s in shape]
    v = Variable.__new__(Variable)
    v._init_from_array(
        torch.zeros(shape, dtype=dtype_mod.torch_dtype(dtype),
                    device=default_device()), True, name)
    prog = default_main_program()
    prog._inputs[name] = v
    return v


class Executor:
    """reference Executor (base/executor.py:1746): run(feed, fetch_list).
    The captured-program path re-executes the recorded eager graph."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True):
        program = program or default_main_program()
        feed = feed or {}
        fetch_list = fetch_list or []
        # bind feeds into placeholders, then re-evaluate fetches through
        # their recorded build functions
        for name, value in feed.items():
            if name in program._inputs:
                v = program._inputs[name]
                arr = value._data if isinstance(value, Tensor) else \
                    dtype_mod.from_numpy(np.asarray(value))
                v._assign_array(arr.to(device=v._data.device,
                                       dtype=v._data.dtype))

        def _writeback(orig, new):
            if isinstance(orig, Tensor):
                orig._assign_array(new._data)
            elif isinstance(orig, dict):
                for k in orig:
                    _writeback(orig[k], new[k])
            elif isinstance(orig, (list, tuple)):
                for o, n_ in zip(orig, new):
                    _writeback(o, n_)

        for fn, originals in program._actions:
            _writeback(originals, fn())
        outs = []
        for f in fetch_list:
            t = f if isinstance(f, Tensor) else program._inputs[f]
            outs.append(t.numpy() if return_numpy else t)
        return outs


class CompiledProgram:
    def __init__(self, program, build_strategy=None):
        self.program = program


class BuildStrategy:
    pass


class ExecutionStrategy:
    pass


def name_scope(prefix=None):
    return contextlib.nullcontext()


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    from ..autograd import grad
    return grad(targets, inputs, grad_outputs=target_gradients,
                allow_unused=True)


def save(program, model_path, protocol=4):
    pass


def load(program, model_path, executor=None, var_list=None):
    pass


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor,
                         **kwargs):
    """Writes the marker file of an inference artifact (the reference
    writes a StableHLO placeholder); a servable program is jit.save's."""
    import os
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    with open(path_prefix + ".graph.txt", "w") as f:
        f.write("; paddle_tpu_torch inference artifact: use jit.save\n")


def load_inference_model(path_prefix, executor, **kwargs):
    raise NotImplementedError(
        "load_inference_model: use paddle_tpu_torch.jit.load")


class ParallelExecutor:
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "ParallelExecutor is deprecated in the reference; use "
            "paddle_tpu_torch.jit instead")


from . import nn  # noqa: E402,F401

# ---------------------------------------------------------------------
# remaining paddle.static surface (reference: python/paddle/static/
# {io,param_attr,scope_guard,...})
# ---------------------------------------------------------------------


class Scope:
    """Variable scope (reference global_scope): name -> Tensor map."""

    def __init__(self):
        self.vars = {}

    def var(self, name):
        if name not in self.vars:
            self.vars[name] = Tensor(np.zeros((), np.float32))
        return self.vars[name]

    def find_var(self, name):
        return self.vars.get(name)


_global_scope = Scope()
_scope_stack = []


def global_scope():
    return _scope_stack[-1] if _scope_stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """reference append_backward: adds grad ops to the program. In the
    eager-capture design gradients come from paddle.grad; this returns
    (param, grad) pairs for API parity."""
    from ..autograd import grad
    params = list(parameter_list or [])
    grads = grad(loss, params, retain_graph=True,
                 allow_unused=True) if params else []
    return list(zip(params, grads))


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    msg = message or ""
    arr = np.asarray(input.numpy())
    print(f"{msg} {'shape=' + str(arr.shape) if print_tensor_shape else ''}"
          f" {arr.ravel()[:summarize]}")
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    return nn.py_func(func, x, out, backward_func,
                      skip_vars_in_backward_input)


class WeightNormParamAttr(ParamAttr):
    """Weight-normalized parameter attribute (reference
    WeightNormParamAttr); the norm reparameterization is applied by
    nn.utils.weight_norm at layer level."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer,
                         learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable)
        self.dim = dim


class ExponentialMovingAverage:
    """EMA of trainable parameters (reference static
    ExponentialMovingAverage): update() after each step; apply()/restore()
    swap the EMA weights in and out."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self.decay = decay
        self._ema = {}
        self._backup = {}
        self._params = []
        self._step = 0

    def update(self, parameters=None):
        if parameters is None and not self._params:
            raise ValueError("pass parameters on first update()")
        if parameters is not None:
            self._params = list(parameters)
        self._step += 1
        d = min(self.decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            key = id(p)
            if key not in self._ema:
                self._ema[key] = np.asarray(p.numpy())
            else:
                self._ema[key] = d * self._ema[key] \
                    + (1 - d) * np.asarray(p.numpy())

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        for p in self._params:
            self._backup[id(p)] = np.asarray(p.numpy())
            p.set_value(self._ema[id(p)])
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.set_value(self._backup.pop(id(p)))


# --- program serialization (the artifact is pickled state + meta,
# reference serialize_program/persistables) ---

def serialize_program(feed_vars, fetch_vars, **kwargs):
    import pickle
    return pickle.dumps({"feeds": [getattr(v, "name", None)
                                   for v in _as_list(feed_vars)],
                         "fetches": len(_as_list(fetch_vars))})


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs):
    import pickle
    prog = default_main_program()
    return pickle.dumps({k: np.asarray(v.numpy())
                         for k, v in getattr(prog, "_persistables",
                                             {}).items()})


def save_to_file(path, content):
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path):
    with open(path, "rb") as f:
        return f.read()


def deserialize_program(data):
    import pickle
    meta = pickle.loads(data)
    p = Program()
    p._meta = meta
    return p


def deserialize_persistables(program, data, executor=None):
    import pickle
    vals = pickle.loads(data)
    program._persistables = {k: Tensor(v) for k, v in vals.items()}
    return program._persistables


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    return program


def load_program_state(model_path, var_list=None):
    from ..framework.io import load as _load
    return _load(model_path + ".pdparams") \
        if not model_path.endswith(".pdparams") else _load(model_path)


def set_program_state(program, state_dict):
    program._persistables = {k: Tensor(np.asarray(v))
                             for k, v in state_dict.items()}


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


# --- places / misc ---

def cpu_places(device_count=None):
    n = device_count or 1
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    ids = device_ids if device_ids is not None else [0]
    return [CUDAPlace(i) for i in ids]


def xpu_places(device_ids=None):
    raise NotImplementedError("XPUPlace is not in the port (ROADMAP queue "
                              "1, item 4.3)")


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    from ..ops.creation import full
    t = full(shape, value, dtype=dtype)
    t.persistable = persistable
    if name:
        t.name = name
        prog = default_main_program()
        if not hasattr(prog, "_persistables"):
            prog._persistables = {}
        prog._persistables[name] = t
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None) -> Parameter:
    return nn._param(shape, dtype, attr=attr if attr is not None else name,
                     is_bias=is_bias, default_initializer=default_initializer)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    from .. import ops
    topk = ops.search.argsort(input, axis=-1, descending=True)[:, :k]
    lab = ops.manipulation.reshape(label, [-1, 1])
    hit = ops.math.sum(ops.manipulation.cast(topk == lab, "float32"), axis=1)
    return ops.math.mean(ops.manipulation.cast(hit > 0, "float32"))


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1,
        slide_steps=1, ins_tag_weight=None):
    """Batch AUC (reference static auc op) computed host-side."""
    probs = np.asarray(input.numpy())[:, 1] if input.shape[-1] == 2 \
        else np.asarray(input.numpy()).ravel()
    labs = np.asarray(label.numpy()).ravel()
    order = np.argsort(-probs)
    labs = labs[order]
    tps = np.cumsum(labs)
    fps = np.cumsum(1 - labs)
    tpr = tps / max(tps[-1], 1)
    fpr = fps / max(fps[-1], 1)
    value = float(np.trapezoid(tpr, fpr) if hasattr(np, "trapezoid")
                  else np.trapz(tpr, fpr))
    t = Tensor(np.asarray(value, np.float32))
    return t, t, [t]


@contextlib.contextmanager
def device_guard(device=None):
    """reference device_guard: pins ops to a device inside a program; here
    it scopes set_device."""
    prev = get_device()
    try:
        if device:
            set_device(device.split(":")[0])
        yield
    finally:
        set_device(prev)


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    yield


def set_ipu_shard(call_func, index=-1, stage=-1):
    return call_func


class IpuCompiledProgram:
    def __init__(self, *a, **k):
        raise NotImplementedError("IPU backend is not supported; this "
                                  "framework targets one NVIDIA H100")


class IpuStrategy:
    def __init__(self):
        self.options = {}

    def set_options(self, opts):
        self.options.update(opts)


def ctr_metric_bundle(input, label, ins_tag_weight=None):
    a, _, _ = auc(input, label)
    return a, a, a, a
