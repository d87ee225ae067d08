"""fleet.utils: the port of ``paddle_tpu/distributed/fleet/utils/__init__.py``
(reference python/paddle/distributed/fleet/utils/__init__.py: LocalFS,
HDFSClient, recompute, DistributedInfer and the helper submodules;
``sequence_parallel_utils`` and ``pp_parallel_adaptor`` live one level up
and are re-exported here)."""
from __future__ import annotations

from ..recompute import recompute  # noqa: F401
from . import (  # noqa: F401
    fs,
    hybrid_parallel_util,
    log_util,
    mix_precision_utils,
    ps_util,
    timer_helper,
)
from .fs import HDFSClient, LocalFS  # noqa: F401
from .ps_util import DistributedInfer  # noqa: F401
from .. import pp_parallel_adaptor, sequence_parallel_utils  # noqa: F401

__all__ = ["LocalFS", "recompute", "DistributedInfer", "HDFSClient"]
