"""paddle.distributed.auto_parallel: the port of
``paddle_tpu/distributed/auto_parallel/``, its pipeline part.

``partitioner.find_pipeline_blocks`` and ``partitioner.PipelinePartition``
(a model's homogeneous block run as pipeline stages, the rest as the
prologue and the epilogue; fleet's ``PipelineParallel`` runs on it) are
ported. The Engine, the semi-auto API (``shard_tensor``, ``reshard``,
``ProcessMesh`` placements), the planner and ``partitioner.annotate_tp``
come with the auto-parallel slice (ROADMAP queue 1, item 5e) and raise
``NotImplementedError`` naming it.
"""
from . import partitioner  # noqa: F401

_5E = ("Engine", "Strategy", "DistModel", "DistAttr", "to_static",
       "shard_tensor", "shard_layer", "shard_optimizer", "shard_dataloader",
       "shard_scaler", "reshard", "dtensor_from_fn", "ProcessMesh",
       "Placement", "Shard", "Replicate", "Partial", "Planner", "ModelSpec",
       "PlanCandidate", "engine")


def __getattr__(name):
    if name in _5E:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.auto_parallel.{name} comes with "
            "the auto-parallel slice (ROADMAP queue 1, item 5e)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
