"""Process groups: the port of ``paddle_tpu/distributed/env.py``
(reference: init_parallel_env, python/paddle/distributed/parallel.py:978;
the ProcessGroup registry, parallel.py:1145).

One process per GPU, over ``torch.distributed``: the rank and world size
come from the launcher's variables (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER`` as host:port with
``MASTER_PORT`` as the port's fallback; torch's ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` too). The backend is NCCL on ``cuda:LOCAL_RANK`` unless the
caller asks for the CPU (``set_device("cpu")``, ``_testing.force_cpu()`` or
``backend="gloo"``); a missing card or NCCL raises and never turns into
gloo. With no launcher variables the process is world 1, and its group
behaves as the reference's: every collective over it is the identity.

The reference runs one controller per host (rank is ``jax.process_index()``)
and its collectives reduce nothing at world N (ROADMAP, deliberate
differences): here each rank holds its own tensors and the collectives
reduce across them.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist


class Group:
    """A communication group (reference Group): ``rank`` is this process's
    rank inside the group (-1 when it is not a member), ``ranks`` the global
    ranks of the members, ``process_group`` torch's group (None for a
    non-member, and for world 1 before ``init_parallel_env``)."""

    def __init__(self, rank: int, ranks: List[int], gid: int = 0,
                 name: Optional[str] = None, pg=None):
        self.ranks = list(ranks)
        self.rank = self.ranks.index(rank) if rank in self.ranks else -1
        self.nranks = len(self.ranks)
        self.id = gid
        self._name = name or f"group_{gid}"
        self._pg = pg

    @property
    def name(self):
        return self._name

    @property
    def world_size(self):
        return self.nranks

    @property
    def process_group(self):
        return self._pg

    def is_member(self):
        return self.rank >= 0

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def __repr__(self):
        return f"Group(id={self.id}, nranks={self.nranks}, " \
               f"ranks={self.ranks})"


_GROUPS = {}
_GLOBAL_GROUP: Optional[Group] = None
_NEXT_GID = 1


def _env_int(*names, default):
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return default


def _env_rank():
    return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)


def _env_world():
    return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)


def local_rank() -> int:
    return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=0)


def _master():
    """(host, port) of the rendezvous, or None when nothing names one."""
    coord = os.environ.get("PADDLE_MASTER")
    if coord:
        host, _, port = coord.rpartition(":") if ":" in coord \
            else (coord, "", "")
        return host, port or os.environ.get("MASTER_PORT", "8476")
    if os.environ.get("MASTER_ADDR"):
        return os.environ["MASTER_ADDR"], os.environ.get("MASTER_PORT",
                                                         "8476")
    return None


def _wants_cpu() -> bool:
    from ..core.place import _current_place
    return _current_place().device_type == "cpu"


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_parallel_env(backend: Optional[str] = None,
                      timeout_s: Optional[float] = None) -> Group:
    """Join the job's default process group (once; later calls return it).

    ``backend`` None picks NCCL on ``cuda:LOCAL_RANK``, or gloo when the
    current place is the CPU. NCCL without a card or without NCCL raises.
    The rendezvous is a TCP store at the master address: the launcher's
    own (``PADDLE_STORE_HOSTED``: every rank joins it as a client), or else
    one that rank 0 hosts; world 1 with no master address uses an
    in-process store."""
    global _GLOBAL_GROUP
    if is_initialized():
        if _GLOBAL_GROUP is None:
            _GLOBAL_GROUP = _world_group()
        return _GLOBAL_GROUP
    backend = backend or ("gloo" if _wants_cpu() else "nccl")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    rank, world = _env_rank(), _env_world()
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError(
                "init_parallel_env: the NCCL backend needs a CUDA device and "
                "torch built with NCCL; for the CPU call "
                "paddle_tpu_torch.set_device('cpu') or pass backend='gloo'")
        dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    master = _master()
    if master is None:
        if world != 1:
            raise RuntimeError(
                f"init_parallel_env: world size {world} needs a rendezvous "
                "address (PADDLE_MASTER=host:port, or MASTER_ADDR and "
                "MASTER_PORT); start the job with "
                "python -m paddle_tpu_torch.distributed.launch")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kwargs)
    elif os.environ.get("PADDLE_STORE_HOSTED") == "1":
        # the launcher hosts the store: every rank, 0 included, is a client
        host, port = master
        store = dist.TCPStore(host, int(port), world, is_master=False,
                              timeout=datetime.timedelta(
                                  seconds=timeout_s or 300))
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, **kwargs)
    else:
        host, port = master
        dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                                rank=rank, world_size=world, **kwargs)
    _GLOBAL_GROUP = _world_group()
    _GROUPS[0] = _GLOBAL_GROUP
    return _GLOBAL_GROUP


def _world_group():
    return Group(dist.get_rank(), list(range(dist.get_world_size())), gid=0,
                 name="global_group", pg=dist.group.WORLD)


def get_rank(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.rank
    return dist.get_rank() if is_initialized() else _env_rank()


def get_world_size(group: Optional[Group] = None) -> int:
    if group is not None:
        return group.nranks
    return dist.get_world_size() if is_initialized() else _env_world()


def get_backend(group: Optional[Group] = None) -> str:
    """The backend of ``group`` (default: the job's): "nccl" or "gloo";
    before ``init_parallel_env``, the one it would pick."""
    if is_initialized():
        pg = group.process_group if group is not None else None
        return dist.get_backend(pg)
    return "gloo" if _wants_cpu() else "nccl"


def new_group(ranks=None, backend=None, timeout=None) -> Group:
    """A group over ``ranks`` (global ranks; default all). Every rank of the
    job calls it, in the same order, as torch's ``new_group`` requires."""
    global _NEXT_GID
    world = get_world_size()
    ranks = list(range(world)) if ranks is None else sorted(int(r)
                                                            for r in ranks)
    pg = None
    if is_initialized():
        kw = {}
        if timeout is not None:
            kw["timeout"] = timeout if isinstance(
                timeout, datetime.timedelta) else datetime.timedelta(
                    seconds=float(timeout))
        pg = dist.new_group(ranks, backend=backend, **kw)
        if pg is dist.GroupMember.NON_GROUP_MEMBER:
            pg = None
    elif ranks != [0] or world != 1:
        raise RuntimeError("new_group over more than this process needs "
                           "init_parallel_env() first")
    g = Group(get_rank(), ranks, gid=_NEXT_GID, pg=pg)
    _GROUPS[_NEXT_GID] = g
    _NEXT_GID += 1
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0 and 0 not in _GROUPS and is_initialized():
        init_parallel_env()
    return _GROUPS.get(gid)


def destroy_process_group(group=None):
    """Tear down ``group``, or with None the job's default group and every
    group made from it."""
    global _GLOBAL_GROUP
    if group is None:
        if is_initialized():
            dist.destroy_process_group()
        _GROUPS.clear()
        _GLOBAL_GROUP = None
        from .mesh import set_mesh
        set_mesh(None)
        return
    if group.process_group is not None and is_initialized():
        dist.destroy_process_group(group.process_group)
    _GROUPS.pop(group.id, None)


def barrier(group: Optional[Group] = None):
    """Block until every rank of ``group`` reaches it; at world 1 before
    ``init_parallel_env``, a device synchronisation."""
    if is_initialized():
        pg = group.process_group if group is not None else None
        if group is not None and pg is None:
            return
        if dist.get_backend(pg) == "nccl":
            dist.barrier(group=pg, device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier(group=pg)
    elif torch.cuda.is_available() and not _wants_cpu():
        torch.cuda.synchronize()


class ParallelEnv:
    """reference paddle.distributed.ParallelEnv"""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    nranks = world_size
    local_rank = rank

    @property
    def device_id(self):
        return local_rank()

    dev_id = device_id

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
