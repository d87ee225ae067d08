"""paddle.distributed: the port of ``paddle_tpu/distributed`` over
``torch.distributed`` (one process per GPU; NCCL on the card, gloo when the
caller asks for the CPU).

Ported: process groups (``env``), the eager collectives and the
differentiable mesh-axis ``ops`` (``collective``, ``communication``),
``ProcessMesh`` and the placements (``mesh``), ``DataParallel``
(``parallel``), the ZeRO stages (``sharding``), fleet's data-, tensor-,
sequence-parallel and sharding surface (``fleet``: the mp layers and the
sequence-parallel linears), ``split``, the launcher (``launch``),
``spawn``, ``checkpoint`` (with sharded entries), ``watchdog``,
``elastic``, the MoE exchange (``utils``: ``global_scatter``,
``global_gather``) and the semi-auto API over DTensor (``api``:
``shard_tensor``, ``reshard``, ``to_static`` -> ``DistModel`` and the rest),
with the ``planner`` and the ``auto_tuner``; the parameter server (``ps``,
fleet's PS mode, ``InMemoryDataset`` over the native MultiSlot parser),
``rpc``, ``fleet_executor`` and the native ``TCPStore``.
"""
from __future__ import annotations

import numpy as np

from . import checkpoint  # noqa: F401
from .checkpoint import save_state_dict, load_state_dict  # noqa: F401
from . import watchdog  # noqa: F401
from . import elastic  # noqa: F401
from . import env  # noqa: F401
from .env import (  # noqa: F401
    Group, ParallelEnv, barrier, destroy_process_group, get_backend,
    get_group, get_rank, get_world_size, init_parallel_env, is_initialized,
    new_group,
)
from . import collective  # noqa: F401
from .collective import (  # noqa: F401
    P2POp, ReduceOp, all_gather, all_gather_object, all_reduce, alltoall,
    alltoall_single, batch_isend_irecv, broadcast, broadcast_object_list,
    gather, irecv, isend, ops, recv, reduce, reduce_scatter, scatter,
    scatter_object_list, send, wait,
)
from . import mesh  # noqa: F401
from .mesh import (  # noqa: F401
    Partial, Placement, ProcessMesh, ReduceType, Replicate, Shard,
    auto_mesh, get_mesh, set_mesh,
)
from . import parallel  # noqa: F401
from .parallel import DataParallel  # noqa: F401
from . import sharding  # noqa: F401
from .sharding import (  # noqa: F401
    DygraphShardingOptimizer, GroupShardedScaler, GroupShardedStage2,
    GroupShardedStage3, group_sharded_parallel, save_group_sharded_model,
)
from . import fleet  # noqa: F401
from .fleet.recompute import recompute  # noqa: F401
from . import launch  # noqa: F401
from . import auto_parallel  # noqa: F401
from . import communication  # noqa: F401
from . import io  # noqa: F401
from .communication import stream  # noqa: F401
from . import utils  # noqa: F401
from . import api  # noqa: F401
from .api import (  # noqa: F401
    DistAttr, DistModel, ShardingStage1, ShardingStage2, ShardingStage3,
    Strategy, dtensor_from_fn, dtensor_from_local, reshard, shard_dataloader,
    shard_layer, shard_optimizer, shard_scaler, shard_tensor, to_static,
    unshard_dtensor,
)
from . import planner  # noqa: F401
from . import auto_tuner  # noqa: F401


def _spawn_entry(rank, func, args, nprocs, master, backend):
    import os
    os.environ.update({
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": master, "PADDLE_LOCAL_RANK": str(rank),
        "PADDLE_STORE_HOSTED": "1",
        "RANK": str(rank), "WORLD_SIZE": str(nprocs),
        "LOCAL_RANK": str(rank)})
    if backend == "gloo":
        from .._testing import force_cpu
        force_cpu()
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """reference paddle.distributed.spawn (spawn.py:463): start ``nprocs``
    processes (default: one per GPU) that each run ``func(*args)`` with the
    launcher's variables set, so ``init_parallel_env()`` joins them.
    ``backend="gloo"`` makes each process's default place the CPU. Returns
    torch's ProcessContext; with ``join`` it waits and raises if a process
    failed. This process hosts the job's rendezvous store (at
    ``master``'s port, or one the OS picks), which the processes join as
    clients; without ``join`` it lives as long as the returned context."""
    import torch
    import torch.multiprocessing as mp
    from .launch.main import _host_store
    if nprocs == -1:
        nprocs = torch.cuda.device_count()
    if nprocs < 1:
        raise RuntimeError("spawn: no GPU to start a process for; pass "
                           "nprocs and backend='gloo' for the CPU")
    host, port = (options.get("master") or "127.0.0.1:0").rsplit(":", 1)
    store, port = _host_store(host, port, nprocs)
    backend = options.get("backend")
    ctx = mp.start_processes(_spawn_entry,
                             args=(func, tuple(args), nprocs,
                                   f"{host}:{port}", backend),
                             nprocs=nprocs, join=join, daemon=daemon,
                             start_method="spawn")
    if ctx is not None:
        ctx._store = store
    return ctx


class ParallelMode:
    """reference base/topology.py ParallelMode constants."""
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


def is_available():
    """reference distributed.is_available: collective support present."""
    import torch.distributed as dist
    return dist.is_available()


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """reference gloo_init_parallel_env: a gloo group of ``rank_num`` CPU
    ranks at ``server_endpoint`` (host:port), for CPU barriers."""
    import datetime
    import torch.distributed as dist
    global _GLOO
    host, port = server_endpoint.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), rank_num, rank_id == 0,
                          timeout=datetime.timedelta(seconds=300))
    if is_initialized():
        raise RuntimeError("gloo_init_parallel_env: a default process group "
                           "exists already; use new_group(backend='gloo')")
    dist.init_process_group("gloo", store=store, rank=rank_id,
                            world_size=rank_num)
    _GLOO = True


_GLOO = False


def gloo_barrier():
    import torch.distributed as dist
    if not _GLOO:
        raise RuntimeError("gloo_barrier: call gloo_init_parallel_env first")
    dist.barrier()


def gloo_release():
    global _GLOO
    if _GLOO:
        destroy_process_group()
        _GLOO = False


#: layers built by split(), keyed by call site: calling split again with the
#: same key reuses the same parameters; an optimizer reaches them here.
_split_layers = {}


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """reference paddle.distributed.split (distributed/__init__.py:90): a
    row- or column-parallel linear, or a vocab-parallel embedding, over the
    model-parallel group (fleet's mp layers), applied to ``x``. The layer
    is cached by (name, operation, size, axis, num_partitions) so repeated
    calls share one set of parameters; collect them through
    ``_split_layers[key].parameters()``."""
    from .fleet.mp_layers import (ColumnParallelLinear, RowParallelLinear,
                                  VocabParallelEmbedding)
    key = (name, operation, tuple(size), axis, num_partitions)
    layer = _split_layers.get(key)
    if layer is None:
        if operation == "linear":
            if axis == 1:
                layer = ColumnParallelLinear(
                    size[0], size[1], weight_attr=weight_attr,
                    has_bias=bias_attr is not False,
                    gather_output=gather_out)
            else:
                layer = RowParallelLinear(
                    size[0], size[1], weight_attr=weight_attr,
                    has_bias=bias_attr is not False,
                    input_is_parallel=False)
        elif operation == "embedding":
            layer = VocabParallelEmbedding(size[0], size[1],
                                           weight_attr=weight_attr)
        else:
            raise ValueError(f"unknown split operation {operation!r}")
        _split_layers[key] = layer
    return layer(x)


# --- PS-style datasets (reference fluid DataFeed/Dataset shells over the C++
# MultiSlot feed) ---

class QueueDataset:
    def __init__(self):
        self._files = []
        self.proto_desc = type("D", (), {"pipe_command": "cat"})()

    def set_filelist(self, files):
        self._files = list(files)

    def set_use_var(self, vars_):
        self._vars = vars_

    def set_batch_size(self, bs):
        self._bs = bs


class InMemoryDataset(QueueDataset):
    """reference InMemoryDataset over the C++ MultiSlot DataFeed
    (fluid/framework/data_feed.cc): with slots set by ``set_use_var``,
    ``load_into_memory`` parses each file with the native threaded parser
    (``native.parse_multislot_file``; a slot is float32 where its var's
    dtype names a float, else int64) into a slot's (values, offsets) ragged
    arrays, the files' offsets merged end to end; without slots it keeps
    the raw lines."""

    def load_into_memory(self):
        slots = getattr(self, "_vars", None)
        self._data = []
        self._slot_data = []
        if not slots:
            for f in self._files:
                with open(f) as fh:
                    self._data += fh.readlines()
            return
        from .. import native
        is_float = ["float" in str(getattr(v, "dtype", "int64"))
                    for v in slots]
        merged = None
        for f in self._files:
            parsed = native.parse_multislot_file(f, is_float)
            if merged is None:
                merged = [[v, o] for v, o in parsed]
                continue
            for s, (v, o) in enumerate(parsed):
                mv, mo = merged[s]
                merged[s] = [np.concatenate([mv, v]),
                             np.concatenate([mo, o[1:] + mo[-1]])]
        self._slot_data = [(v, o) for v, o in (merged or [])]

    def get_memory_data_size(self):
        if getattr(self, "_slot_data", None):
            return int(self._slot_data[0][1].shape[0] - 1)
        return len(getattr(self, "_data", []))

    def slot_arrays(self):
        """A slot's (values, offsets) ragged arrays, the native layout."""
        return getattr(self, "_slot_data", [])

    def batch_generator(self, batch_size=None, pad_value=0):
        """Yield, a batch of rows at a time, one dense ``[b, max_len]``
        Tensor a slot (padded with ``pad_value``) on the default place: the
        feed the PS trainer consumes."""
        from ..core.tensor import Tensor
        bs = batch_size or getattr(self, "_bs", 32)
        data = getattr(self, "_slot_data", [])
        if not data:
            return
        rows = data[0][1].shape[0] - 1
        for start in range(0, rows, bs):
            stop = min(start + bs, rows)
            batch = []
            for vals, offs in data:
                lens = np.diff(offs[start:stop + 1])
                dense = np.full((stop - start, max(int(lens.max()), 1)),
                                pad_value, vals.dtype)
                cols = np.arange(dense.shape[1])
                dense[cols[None, :] < lens[:, None]] = \
                    vals[offs[start]:offs[stop]]
                batch.append(Tensor(dense))
            yield batch

    def local_shuffle(self):
        import random
        random.shuffle(getattr(self, "_data", []))

    def release_memory(self):
        self._data = []
        self._slot_data = []


class ProbabilityEntry:
    def __init__(self, probability):
        self.probability = probability


class CountFilterEntry:
    def __init__(self, count_filter):
        self.count_filter = count_filter


class ShowClickEntry:
    def __init__(self, show_name, click_name):
        self.show_name, self.click_name = show_name, click_name


from . import ps  # noqa: E402,F401
from . import rpc  # noqa: E402,F401
from . import fleet_executor  # noqa: E402,F401
from ..native import TCPStore  # noqa: E402,F401
