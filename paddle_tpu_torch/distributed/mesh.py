"""Process meshes and placements: the port of
``paddle_tpu/distributed/mesh.py`` (reference: ProcessMesh,
python/paddle/distributed/auto_parallel/process_mesh.py:85; placements
Shard/Replicate/Partial; the hybrid axis order pp -> mp -> sep -> sharding
-> dp, fleet/base/topology.py:70).

A ``ProcessMesh`` is an N-d array of global ranks with a name per dim. Once
a process group exists it maps onto ``torch.distributed.device_mesh.
DeviceMesh`` (built on first use, by every rank in the same order, as
torch's ``new_group`` requires) and gives one ``Group`` per dim name: the
ranks that differ from this one along that dim only. Placements and the
spec conversions are plain data: a spec is a tuple with one entry per
tensor dim (None, a dim name, or a tuple of names). Distributed tensors
(``shard_tensor``, ``reshard``) are in ``api.py``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


# ---------------------------- placements -----------------------------------
class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim: int):
        self.dim = int(dim)

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def get_dim(self):
        return self.dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("S", self.dim))


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __repr__(self):
        return "Replicate()"

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("R")


class Partial(Placement):
    """A pending reduction over a mesh dim."""

    def __init__(self, reduce_type: str = "sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __repr__(self):
        return f"Partial({self.reduce_type})"

    def __eq__(self, other):
        return isinstance(other, Partial) and \
            other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("P", self.reduce_type))


class ReduceType:
    kRedSum = "sum"
    kRedMax = "max"
    kRedMin = "min"
    kRedProd = "prod"
    kRedAvg = "avg"


# ------------------------------- mesh --------------------------------------
_GLOBAL_MESH: Optional["ProcessMesh"] = None
_AXIS_ALIASES = {"tp": "mp", "mp": "tp"}


class ProcessMesh:
    """N-d logical mesh of global ranks (reference process_mesh.py:85)."""

    def __init__(self, mesh=None, dim_names: Optional[Sequence[str]] = None,
                 shape: Optional[Sequence[int]] = None,
                 process_ids: Optional[Sequence[int]] = None):
        if shape is None:
            arr = np.asarray(mesh, dtype=np.int64)
        else:
            n = int(np.prod(shape))
            ids = list(process_ids) if process_ids is not None \
                else list(range(n))
            if len(ids) != n:
                raise ValueError(f"mesh shape {list(shape)} needs {n} "
                                 f"process ids, got {len(ids)}")
            arr = np.asarray(ids, dtype=np.int64).reshape(list(shape))
        if dim_names is None:
            dim_names = [f"d{i}" for i in range(arr.ndim)]
        if len(dim_names) != arr.ndim:
            raise ValueError(f"{len(dim_names)} dim names for a "
                             f"{arr.ndim}-d mesh")
        self._ids = arr
        self._dim_names = list(dim_names)
        self._device_mesh = None
        self._groups = {}

    @property
    def shape(self):
        return list(self._ids.shape)

    @property
    def ndim(self):
        return self._ids.ndim

    @property
    def dim_names(self):
        return list(self._dim_names)

    @property
    def process_ids(self):
        return [int(i) for i in self._ids.ravel()]

    @property
    def mesh(self):
        return self._ids.copy()

    def get_dim_size(self, name):
        return self.shape[self._dim_names.index(name)]

    def get_mesh_with_dim(self, dim_name, index=None):
        """The mesh with ``dim_name`` moved first, or its slice at
        ``index`` along that dim (reference get_mesh_with_dim)."""
        axis = self._dim_names.index(dim_name)
        ids = np.moveaxis(self._ids, axis, 0)
        rest = [n for n in self._dim_names if n != dim_name]
        if index is not None:
            return ProcessMesh(ids[index], dim_names=rest)
        return ProcessMesh(ids, dim_names=[dim_name] + rest)

    @property
    def device_mesh(self):
        """torch's DeviceMesh over these ranks (on "cuda" under NCCL, "cpu"
        under gloo), built on first use; needs a process group."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh
            import torch
            from .env import get_backend, is_initialized
            if not is_initialized():
                raise RuntimeError("ProcessMesh.device_mesh needs "
                                   "init_parallel_env() first")
            kind = "cuda" if get_backend() == "nccl" else "cpu"
            self._device_mesh = DeviceMesh(
                kind, torch.as_tensor(self._ids),
                mesh_dim_names=tuple(self._dim_names))
        return self._device_mesh

    def get_group(self, dim_name) -> "Group":
        """The Group along ``dim_name`` that holds this rank. The tensor-
        parallel axis answers to "tp" and "mp" alike (gpt_hybrid's name and
        fleet's)."""
        from .env import Group, get_rank, is_initialized
        if dim_name not in self._dim_names:
            alias = _AXIS_ALIASES.get(dim_name)
            if alias not in self._dim_names:
                raise ValueError(f"{self} has no axis {dim_name!r}")
            dim_name = alias
        if dim_name not in self._groups:
            if not is_initialized():
                if self._ids.size != 1:
                    raise RuntimeError(
                        f"{self} spans {self._ids.size} ranks: its groups "
                        "need init_parallel_env() first")
                self._groups[dim_name] = Group(get_rank(), [get_rank()])
            else:
                import torch.distributed as dist
                pg = self.device_mesh.get_group(dim_name)
                self._groups[dim_name] = Group(
                    get_rank(), dist.get_process_group_ranks(pg), pg=pg)
        return self._groups[dim_name]

    def __eq__(self, other):
        return isinstance(other, ProcessMesh) and \
            self.shape == other.shape and \
            self._dim_names == other._dim_names and \
            self.process_ids == other.process_ids

    def __hash__(self):
        return hash((tuple(self.shape), tuple(self._dim_names),
                     tuple(self.process_ids)))

    def __enter__(self):
        global _GLOBAL_MESH
        self._prev = _GLOBAL_MESH
        _GLOBAL_MESH = self
        return self

    def __exit__(self, *exc):
        global _GLOBAL_MESH
        _GLOBAL_MESH = self._prev

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, " \
               f"dim_names={self._dim_names})"


def get_mesh() -> Optional[ProcessMesh]:
    return _GLOBAL_MESH


def set_mesh(mesh: Optional[ProcessMesh]):
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    return mesh


def auto_mesh(**axis_sizes) -> ProcessMesh:
    """A mesh over the job's ranks, e.g. auto_mesh(dp=2, mp=2)."""
    names = list(axis_sizes)
    return ProcessMesh(shape=[axis_sizes[n] for n in names],
                       dim_names=names)


def placements_to_spec(placements: Sequence[Placement],
                       mesh: ProcessMesh, ndim: int) -> tuple:
    """[Shard(0), Replicate()] over mesh dims -> one entry per tensor dim
    (None, a mesh dim name, or a tuple of names). placement[i] describes
    mesh dim i (the reference's convention)."""
    entries: List[Optional[List[str]]] = [None] * ndim
    for axis_idx, pl in enumerate(placements):
        if isinstance(pl, Shard):
            name = mesh.dim_names[axis_idx]
            if entries[pl.dim] is None:
                entries[pl.dim] = [name]
            else:
                entries[pl.dim].append(name)
    return tuple(tuple(e) if e and len(e) > 1 else (e[0] if e else None)
                 for e in entries)


def spec_to_placements(spec, mesh: ProcessMesh,
                       ndim: int) -> List[Placement]:
    placements: List[Placement] = [Replicate()
                                   for _ in range(len(mesh.dim_names))]
    for d, entry in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        for name in names:
            placements[mesh.dim_names.index(name)] = Shard(d)
    return placements
