"""Functional SPMD building blocks: the port of ``paddle_tpu/parallel``.

Ring attention and Ulysses attention over a sequence-parallel axis, the
ring collective matmuls of sequence parallelism, and the sequence-sharding
helpers, over ``torch.distributed`` (one process a GPU): functions of this
rank's tensors, differentiable, whose collectives are the group's that a
``ProcessMesh`` axis names (``distributed.collective.ops``). The pipeline
names (``pipeline_apply``, ``stack_stage_params`` and ``pp_schedule``'s)
come with the pipeline slice (ROADMAP queue 1, item 5c) and raise
``NotImplementedError`` naming it.
"""
from .ring_attention import ring_attention  # noqa: F401
from .ulysses import ulysses_attention, ulysses_attention_sharded  # noqa: F401
from .sequence import (  # noqa: F401
    gather_sequence, sequence_parallel_enabled, shard_sequence,
)

_PP = ("pipeline_apply", "stack_stage_params", "PipeOp", "Schedule",
       "run_schedule", "schedule_1f1b", "schedule_fthenb",
       "schedule_interleaved", "schedule_zbh1", "schedule_zbvpp", "pipeline",
       "pipeline_1f1b", "pp_schedule")


def __getattr__(name):
    if name in _PP:
        raise NotImplementedError(
            f"paddle_tpu_torch.parallel.{name} comes with the pipeline slice "
            "(ROADMAP queue 1, item 5c)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
