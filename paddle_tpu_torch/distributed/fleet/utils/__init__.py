"""fleet.utils: the port of ``paddle_tpu/distributed/fleet/utils/__init__.py``
(reference python/paddle/distributed/fleet/utils/__init__.py: LocalFS,
HDFSClient, recompute, DistributedInfer and the helper submodules;
``sequence_parallel_utils`` lives one level up and is re-exported here).
``pp_parallel_adaptor`` comes with the pipeline slice (ROADMAP queue 1):
its name raises ``NotImplementedError`` naming it."""
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
from .. import sequence_parallel_utils  # noqa: F401

__all__ = ["LocalFS", "recompute", "DistributedInfer", "HDFSClient"]

_LATER = {"pp_parallel_adaptor": "the pipeline slice"}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.fleet.utils.{name} comes with "
            f"{_LATER[name]} (ROADMAP queue 1, item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
