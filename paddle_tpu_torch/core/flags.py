"""Runtime flag registry: the port of ``paddle_tpu/core/flags.py``
(``define_flag``, ``get_flag``, ``get_flags``, ``set_flags``,
``on_flag_change``, the ``FLAGS_*`` environment override at definition
time).

Only flags that something in the port reads are defined, each with the
reference's name, default and meaning: the seven that eager dispatch reads
(``core/dispatch.py``), the two print flags of ``Tensor.__repr__``, the six of the training
robustness modules (``training``, ``distributed.watchdog``, ``device``), the
three of ``jit`` (``FLAGS_print_jaxpr``, ``FLAGS_max_specializations``,
``FLAGS_max_shape_specializations``), and
``FLAGS_matmul_precision``/``FLAGS_deterministic``, which set torch's f32
matmul precision and cuDNN's f32 convolution precision at import and when
they change, as the reference sets jax's. A module
that reads a flag of its own defines it (``FLAGS_attn_autotune`` in
``ops/hopper/autotune.py``), so an unknown name is refused by ``set_flags``
rather than accepted and ignored.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, List


@dataclass
class _Flag:
    name: str
    default: Any
    value: Any
    help: str
    type: type


_REGISTRY: Dict[str, _Flag] = {}
_OBSERVERS: Dict[str, List[Callable[[Any], None]]] = {}


def _coerce(ty, raw):
    if ty is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return ty(raw)


def define_flag(name: str, default, help: str = ""):
    """Registers ``name``; the environment variable of the same name
    overrides the default."""
    ty = type(default)
    raw = os.environ.get(name)
    value = _coerce(ty, raw) if raw is not None else default
    _REGISTRY[name] = _Flag(name, default, value, help, ty)
    return value


def get_flags(names=None):
    if names is None:
        names = list(_REGISTRY)
    if isinstance(names, str):
        names = [names]
    return {n: _REGISTRY[n].value for n in names}


def get_flag(name: str):
    return _REGISTRY[name].value


def set_flags(flags: Dict[str, Any]):
    for name, v in flags.items():
        if name not in _REGISTRY:
            raise KeyError(f"unknown flag {name!r}")
        f = _REGISTRY[name]
        f.value = _coerce(f.type, v)
        for cb in _OBSERVERS.get(name, ()):
            cb(f.value)


def on_flag_change(name: str, cb: Callable[[Any], None]):
    """Adds ``cb`` to the observers that ``set_flags`` calls with the new
    value of ``name``; earlier observers stay."""
    _OBSERVERS.setdefault(name, []).append(cb)


define_flag("FLAGS_check_nan_inf", False,
            "scan every op output for NaN/Inf (flags.cc:72 equivalent)")
define_flag("FLAGS_check_nan_inf_level", 0,
            "0: raise on nan/inf; 3: log only")
define_flag("FLAGS_deterministic", False,
            "deterministic mode: f32 matmul and convolution precision "
            "pinned to 'highest'")
define_flag("FLAGS_matmul_precision", "",
            "'default'|'high'|'highest' -> torch's f32 matmul precision; "
            "cuDNN's f32 convolutions run in TF32 unless 'highest' "
            "(applied at import and on set)")
define_flag("FLAGS_op_log", False,
            "log every eager op dispatch with dtypes/shapes; see "
            "FLAGS_op_log_filter")
define_flag("FLAGS_op_log_filter", "",
            "substring filter for FLAGS_op_log (empty = all ops)")
define_flag("FLAGS_nan_inf_dump_dir", "",
            "when FLAGS_check_nan_inf trips, dump the offending op's "
            "inputs/outputs as npz here before raising")
define_flag("FLAGS_retain_grad_for_all", False,
            "keep .grad on non-leaf tensors after backward (debugging)")
define_flag("FLAGS_call_stack_level", 1,
            ">=2: eager op errors are wrapped with the op name and "
            "input dtypes/shapes")
define_flag("FLAGS_collective_debug", False,
            "print each eager collective (op, group, shape) to stderr")
define_flag("FLAGS_collective_matmul", False,
            "the sequence-parallel linears use the ring collective matmuls "
            "(all_gather@W / X@W->reduce_scatter, parallel/"
            "collective_matmul.py) instead of a collective then a matmul")
define_flag("FLAGS_collective_timeout_s", 600.0,
            "collective watchdog: seconds before a device probe counts "
            "as hung")
define_flag("FLAGS_watchdog_interval_s", 10.0,
            "collective watchdog probe interval")
define_flag("FLAGS_step_timeout_s", 1800.0,
            "train-step stall watchdog timeout (TrainStepWatchdog "
            "default): a step exceeding it is aborted with a "
            "straggler report instead of hanging silently")
define_flag("FLAGS_max_bad_steps", 5,
            "consecutive non-finite/skipped train steps before the "
            "StepGuard circuit breaker aborts the run")
define_flag("FLAGS_watchdog_store_root", "",
            "shared dir for cross-rank watchdog progress exchange; when "
            "set, a timeout dump names the straggler rank(s)")
define_flag("FLAGS_memory_stats_dump_path", "",
            "paddle.device.dump_memory_stats() target; also dumped by "
            "the watchdog on timeout when set")
define_flag("FLAGS_print_jaxpr", False,
            "print the traced FX graph to stderr when to_static builds a "
            "program (the reference's name; it prints the jaxpr)")
define_flag("FLAGS_max_specializations", 8,
            "cap on cached to_static specializations per signature "
            "before eager fallback")
define_flag("FLAGS_max_shape_specializations", 8,
            "cap on distinct dynamic-dim (InputSpec None) shapes a "
            "to_static fn compiles before new shapes run eagerly "
            "(the shape-dialect surface's executable budget)")
define_flag("FLAGS_tensor_print_precision", 6,
            "digits in Tensor repr (set_printoptions analog)")
define_flag("FLAGS_tensor_print_threshold", 1000,
            "summarize Tensor repr beyond this many elements")

# FLAGS_matmul_precision's values in torch's terms: "default" lets f32
# products run at reduced precision, as jax's default does.
_TORCH_PRECISION = {"": "highest", "highest": "highest", "high": "high",
                    "default": "medium"}


def _apply_precision(_value=None):
    """Observer of both flags: torch's f32 matmul precision and cuDNN's f32
    convolutions from their values, as jax_default_matmul_precision governs
    both dot_general and conv_general_dilated. Convolutions run in TF32
    exactly when the matmul precision is not "highest" (FLAGS_deterministic
    pins "highest"). cuDNN is set through ``allow_tf32`` alone, which sets
    its conv and rnn precisions together."""
    import torch
    precision = ("highest" if get_flag("FLAGS_deterministic")
                 else _TORCH_PRECISION[get_flag("FLAGS_matmul_precision")])
    torch.set_float32_matmul_precision(precision)
    torch.backends.cudnn.allow_tf32 = precision != "highest"


on_flag_change("FLAGS_matmul_precision", _apply_precision)
on_flag_change("FLAGS_deterministic", _apply_precision)

# the flags' values (defaults or FLAGS_* from the environment) apply at import
_apply_precision()
