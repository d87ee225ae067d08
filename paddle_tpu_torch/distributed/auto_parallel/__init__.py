"""paddle.distributed.auto_parallel (and fleet.auto): the port of
``paddle_tpu/distributed/auto_parallel/``.

The semi-auto API (``shard_tensor``, ``reshard``, ``to_static`` ->
``DistModel``; ``distributed/api.py``, over DTensor), the planner
(``distributed/planner.py``: a calibrated cost-model search), the
partitioner (``partitioner.annotate_tp`` for tensor parallelism over any
model's Linear and Embedding layers, ``PipelinePartition`` for a model's
homogeneous block chain) and the ``Engine`` that ties them into the
reference's fit/evaluate/predict/cost surface.
"""
from ..api import (DistAttr, DistModel, Strategy,  # noqa: F401
                   dtensor_from_fn, reshard, shard_dataloader, shard_layer,
                   shard_optimizer, shard_scaler, shard_tensor, to_static)
from ..mesh import (Partial, Placement, ProcessMesh,  # noqa: F401
                    Replicate, Shard)
from ..planner import ModelSpec, PlanCandidate, Planner  # noqa: F401
from . import partitioner  # noqa: F401
from .engine import Engine  # noqa: E402

__all__ = [
    "Engine", "Strategy", "DistModel", "DistAttr", "to_static",
    "shard_tensor", "shard_layer", "shard_optimizer", "shard_dataloader",
    "shard_scaler", "reshard", "dtensor_from_fn",
    "ProcessMesh", "Placement", "Shard", "Replicate", "Partial",
    "Planner", "ModelSpec", "PlanCandidate",
]
