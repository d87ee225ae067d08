"""paddle.distributed: the part of ``paddle_tpu/distributed`` that the
training-robustness slice needs.

Ported: ``checkpoint`` (``save_state_dict``, ``load_state_dict`` and the
``_COMMITTED.json`` protocol), ``watchdog`` (the collective and train-step
watchdogs) and ``elastic`` (the KV stores, ``ElasticManager``,
``run_resilient``). The rest of the reference's surface — process groups
and collectives over ``torch.distributed``, meshes and distributed tensors,
fleet, sharding, the launcher, ``TCPStore`` — comes with ROADMAP queue 1,
item 5; those names raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from . import checkpoint  # noqa: F401
from .checkpoint import save_state_dict, load_state_dict  # noqa: F401
from . import watchdog  # noqa: F401
from . import elastic  # noqa: F401

#: the reference's other public names (paddle_tpu/distributed/__init__.py)
_LATER = frozenset({
    "Group", "ParallelEnv", "barrier", "destroy_process_group", "get_group",
    "get_rank", "get_world_size", "init_parallel_env", "is_initialized",
    "new_group", "P2POp", "ReduceOp", "all_gather", "all_gather_object",
    "all_reduce", "alltoall", "alltoall_single", "batch_isend_irecv",
    "broadcast", "broadcast_object_list", "irecv", "isend", "ops", "recv",
    "reduce", "reduce_scatter", "scatter", "send", "wait", "Partial",
    "Placement", "ProcessMesh", "ReduceType", "Replicate", "Shard",
    "auto_mesh", "get_mesh", "set_mesh", "ShardingStage1", "ShardingStage2",
    "ShardingStage3", "dtensor_from_fn", "dtensor_from_local", "reshard",
    "shard_layer", "shard_optimizer", "shard_tensor", "DataParallel",
    "TCPStore", "sharding", "DygraphShardingOptimizer", "GroupShardedScaler",
    "GroupShardedStage2", "GroupShardedStage3", "group_sharded_parallel",
    "save_group_sharded_model", "fleet", "recompute", "spawn",
    "get_backend", "launch", "rpc", "communication", "stream", "ps",
    "fleet_executor", "gather", "scatter_object_list", "shard_dataloader",
    "shard_scaler", "to_static", "unshard_dtensor", "Strategy", "DistModel",
    "DistAttr", "ParallelMode", "is_available", "split",
    "gloo_init_parallel_env", "gloo_barrier", "gloo_release",
    "QueueDataset", "InMemoryDataset", "ProbabilityEntry",
    "CountFilterEntry", "ShowClickEntry", "io", "mesh", "env", "collective",
    "api", "parallel", "planner", "auto_parallel", "auto_tuner", "utils",
})


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} comes with the port of "
            "distributed over torch.distributed (ROADMAP queue 1, item 5)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
