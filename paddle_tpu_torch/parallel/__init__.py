"""Functional SPMD building blocks: the port of ``paddle_tpu/parallel``.

Ring attention and Ulysses attention over a sequence-parallel axis, the
ring collective matmuls of sequence parallelism, GPipe over a pp group
(``pipeline_apply``), the pipeline schedules and their host executors
(``pp_schedule``; ``pipeline_1f1b``: 1F1B, interleaved, ZBH1 and ZB-V a
rank a stage), and the sequence-sharding helpers, over
``torch.distributed`` (one process a GPU): functions of this rank's
tensors, differentiable where the reference's are, whose collectives are
the group's that a ``ProcessMesh`` axis (or a Group) names.
"""
from .ring_attention import ring_attention  # noqa: F401
from .ulysses import ulysses_attention, ulysses_attention_sharded  # noqa: F401
from .pipeline import pipeline_apply, stack_stage_params  # noqa: F401
from .pp_schedule import (  # noqa: F401
    PipeOp, Schedule, run_schedule, schedule_1f1b, schedule_fthenb,
    schedule_interleaved, schedule_zbh1, schedule_zbvpp,
)
from .sequence import (  # noqa: F401
    gather_sequence, sequence_parallel_enabled, shard_sequence,
)
from . import pipeline, pipeline_1f1b, pp_schedule  # noqa: F401
