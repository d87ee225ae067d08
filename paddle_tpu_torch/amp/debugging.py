"""paddle.amp.debugging: the port of ``paddle_tpu/amp/debugging.py``
(reference: python/paddle/amp/debugging.py — per-op NaN/Inf checking
config and operator stats collection).

Hooks into eager dispatch (``core/dispatch.py``'s ``run_op``): the NaN scan
is the FLAGS_check_nan_inf path; op stats count per-op dtype calls through
an op observer.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from enum import Enum
from typing import Optional

import torch

from ..core import dispatch as _dispatch
from ..core import dtype as dtype_mod
from ..core.flags import set_flags
from . import _LOW_PRECISION_OPS


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3
    CHECK_ALL_ABORT = 4
    CHECK_ALL_PRINT = 5
    DUMP_ALL = 6


class TensorCheckerConfig:
    """reference debugging.py TensorCheckerConfig."""

    def __init__(self, enable=False,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None,
                 stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list or []
        self.skipped_op_list = skipped_op_list or []
        self.debug_step = debug_step
        self.stack_height_limit = stack_height_limit


_checker_config: Optional[TensorCheckerConfig] = None


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    """Turn on per-op NaN/Inf checking (reference enable_tensor_checker)."""
    global _checker_config
    _checker_config = checker_config
    if checker_config.enable:
        set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    global _checker_config
    _checker_config = None
    set_flags({"FLAGS_check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Scan one tensor for NaN/Inf (reference check_numerics); returns
    (NaN count, Inf count)."""
    a = tensor._data if hasattr(tensor, "_data") else torch.as_tensor(tensor)
    n_nan, n_inf = int(torch.isnan(a).sum()), int(torch.isinf(a).sum())
    if n_nan or n_inf:
        msg = (f"[check_numerics] op={op_type} var={var_name}: "
               f"{n_nan} NaN, {n_inf} Inf")
        if debug_mode in (None, DebugMode.CHECK_NAN_INF_AND_ABORT):
            raise RuntimeError(msg)
        print(msg)
    return n_nan, n_inf


# ------------------------------------------------------ operator stats
_op_stats: Optional[Counter] = None
_remove_observer = None


def _stats_observer(name, arrays):
    if _op_stats is not None:
        dtypes = {dtype_mod.from_torch(a.dtype).name for a in arrays
                  if isinstance(a, torch.Tensor)} or {"-"}
        for dt in dtypes:
            _op_stats[f"{name}:{dt}"] += 1


def enable_operator_stats_collection():
    """Start counting per-op/dtype calls (reference
    enable_operator_stats_collection)."""
    global _op_stats, _remove_observer
    _op_stats = Counter()
    _remove_observer = _dispatch.add_op_observer(_stats_observer)


def disable_operator_stats_collection():
    """Stop and print the collected table."""
    global _op_stats, _remove_observer
    if _remove_observer is not None:
        _remove_observer()
        _remove_observer = None
    if _op_stats:
        print("<------------------------------ op list ------------------"
              "------------>")
        for key, count in sorted(_op_stats.items()):
            print(f"  {key}  called {count} times")
        print("<----------------------------------- op list -------------"
              "---------------->")
    _op_stats = None


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def get_low_precision_op_list():
    """Ops auto-cast to low precision by AMP since
    FLAGS_low_precision_op_list was enabled: {"op->dtype": count}."""
    return dict(_LOW_PRECISION_OPS)


def clear_low_precision_op_list():
    _LOW_PRECISION_OPS.clear()
