"""Eager op dispatch: the port of ``paddle_tpu/core/dispatch.py``.

``run_op(name, fn, *inputs)`` unwraps the Tensor inputs, runs ``fn`` on
torch tensors and wraps what it returns. Where the reference runs ``fn``
under ``jax.vjp`` and records a GradNode, the port lets torch's autograd
record ``fn`` exactly when the reference would: grad mode on, the op
differentiable, and some input a floating tensor that does not stop
gradient. Grad mode is torch's own (``torch.is_grad_enabled``), so
``no_grad`` here and in torch are one switch, and a ``PyLayer``'s backward
runs with it on exactly when a higher-order gradient is being built.

The hot path reads one module flag (``_slow``) for the debugging features
(``FLAGS_op_log``, ``FLAGS_check_nan_inf``, ``FLAGS_retain_grad_for_all``,
op observers) and one metrics branch, and imports nothing.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from . import place as place_mod
from .flags import get_flag, on_flag_change
from .tensor import Tensor
from ..observability import metrics as _met

# eager-dispatch telemetry: cached counters, one `_met._ENABLED` branch
_op_dispatches = _met.REGISTRY.counter("eager.op_dispatches")
_op_grad_recorded = _met.REGISTRY.counter("eager.grad_ops")

# AMP hook (the amp slice installs it): fn(op_name, arrays) -> arrays
_amp_hook: Optional[Callable] = None
# per-op observer hooks (profiler / nan check attach here)
_op_observers = []
# True when any per-op debugging feature is on; recomputed when one changes
_slow = False


def _refresh(_=None):
    global _slow
    _slow = bool(_op_observers) or any(
        get_flag(f) for f in ("FLAGS_op_log", "FLAGS_check_nan_inf",
                              "FLAGS_retain_grad_for_all"))


for _f in ("FLAGS_op_log", "FLAGS_check_nan_inf", "FLAGS_retain_grad_for_all"):
    on_flag_change(_f, _refresh)
_refresh()


def grad_enabled() -> bool:
    return torch.is_grad_enabled()


def set_grad_enabled(flag: bool) -> bool:
    prev = torch.is_grad_enabled()
    torch.set_grad_enabled(bool(flag))
    return prev


def set_amp_hook(hook):
    global _amp_hook
    _amp_hook = hook


def add_op_observer(cb):
    _op_observers.append(cb)
    _refresh()

    def remove():
        _op_observers.remove(cb)
        _refresh()
    return remove


def _check_nan_inf(name, arrays, in_arrays=()):
    level = get_flag("FLAGS_check_nan_inf_level")
    for a in arrays:
        if not _trainable(a) or bool(torch.isfinite(a).all()):
            continue
        msg = f"NaN/Inf detected in output of op '{name}'"
        dump_dir = get_flag("FLAGS_nan_inf_dump_dir")
        if dump_dir:
            # the offending op's operands, for post-mortem
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(dump_dir,
                                f"naninf_{name}_{int(time.time() * 1e3)}")
            np.savez(path,
                     **{f"in{i}": dtype_mod.to_numpy(x)
                        for i, x in enumerate(in_arrays)
                        if isinstance(x, torch.Tensor)},
                     **{f"out{i}": dtype_mod.to_numpy(x)
                        for i, x in enumerate(arrays)})
            msg += f" (operands dumped to {path}.npz)"
        if level >= 3:
            print("[check_nan_inf]", msg)
        else:
            raise FloatingPointError(msg)


def _trainable(a) -> bool:
    return a.is_floating_point() or a.is_complex()


def _sig(arrays):
    return ",".join(f"{dtype_mod.from_torch(a.dtype).name}{list(a.shape)}"
                    for a in arrays if isinstance(a, torch.Tensor))


def _as_array(x, device):
    """A non-Tensor input as a torch tensor on ``device`` (python floats
    land as the default dtype)."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, float):
        return torch.tensor(x, dtype=dtype_mod.get_default_dtype().torch,
                            device=device)
    arr = x if isinstance(x, np.ndarray) else np.asarray(x)
    if arr.dtype == np.float64:
        arr = arr.astype(dtype_mod.get_default_dtype().dtype)
    return dtype_mod.from_numpy(arr).to(device)


def run_op(name: str, fn: Callable, *inputs, amp=True,
           out_stop_gradient=None, differentiable=True):
    """Execute one eager op.

    fn takes torch tensors (one per input) and returns a tensor or a tuple
    of tensors. Tensor inputs are unwrapped; other inputs become tensors on
    the first Tensor input's device.
    """
    if _met._ENABLED:
        _op_dispatches.inc()
    arrays = []
    needs = False
    device = None
    convert = False
    for x in inputs:
        if isinstance(x, Tensor):
            a = x._data
            if device is None:
                device = a.device
            if not x._sg and a.requires_grad:
                needs = True
            arrays.append(a)
        else:
            convert = True
            arrays.append(x)
    if convert:
        if device is None:
            device = place_mod.default_device()
        arrays = [_as_array(a, device) for a in arrays]

    if amp and _amp_hook is not None:
        arrays = _amp_hook(name, arrays)

    record = needs and differentiable and torch.is_grad_enabled()
    try:
        if needs and not record and torch.is_grad_enabled():
            with torch.no_grad():
                out = fn(*arrays)
        else:
            out = fn(*arrays)
    except Exception as e:
        if get_flag("FLAGS_call_stack_level") >= 2:
            raise RuntimeError(
                f"op '{name}' failed (inputs: {_sig(arrays)}): "
                f"{type(e).__name__}: {e}") from e
        raise

    single = not isinstance(out, (tuple, list))
    outs = (out,) if single else tuple(out)

    if _slow:
        if get_flag("FLAGS_op_log"):
            filt = get_flag("FLAGS_op_log_filter")
            if not filt or filt in (name or ""):
                print(f"[op] {name}({_sig(arrays)}) -> {_sig(outs)}",
                      file=sys.stderr)
        if get_flag("FLAGS_check_nan_inf"):
            _check_nan_inf(name, outs, arrays)
        if record and get_flag("FLAGS_retain_grad_for_all"):
            for a in outs:
                if a.requires_grad:
                    a.retain_grad()
        for cb in _op_observers:
            cb(name, outs)

    sg = not record if out_stop_gradient is None else out_stop_gradient
    if record and _met._ENABLED:
        _op_grad_recorded.inc()
    if single:
        return Tensor._wrap(out, sg)
    return tuple(Tensor._wrap(a, sg) for a in outs)


def rebind_inplace(target: Tensor, res: Tensor) -> Tensor:
    """Rebind ``res``'s tensor and its place in the graph onto ``target``:
    the tail of every inplace op."""
    target._sg = res._sg and target._sg
    return target._assign_array(res._data)


def run_op_inplace(name: str, fn: Callable, target: Tensor, *extra_inputs,
                   **kw):
    """Inplace op: computes fn(target, *extra) out of place, then rebinds
    target to the result (ops.yaml ``inplace:`` semantics)."""
    out = run_op(name, fn, target, *extra_inputs, **kw)
    res = out[0] if isinstance(out, tuple) else out
    return rebind_inplace(target, res)
