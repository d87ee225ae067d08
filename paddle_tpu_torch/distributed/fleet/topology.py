"""Hybrid-parallel topology: the port of
``paddle_tpu/distributed/fleet/topology.py`` (reference:
CommunicateTopology, fleet/base/topology.py:70, and HybridCommunicateGroup,
:189 — the N-d rank mesh with axis order pp -> sep -> mp -> sharding -> dp
and a communication group per axis).

The groups are torch process groups (the pipe group carries the pipeline's
hops): ``HybridCommunicateGroup`` makes, for each axis, every group along it (all ranks make all of them, in the same
order, as torch's ``new_group`` requires) and keeps the one holding this
rank.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np

from ..env import Group, get_rank, get_world_size, new_group
from ..mesh import ProcessMesh

_ORDER = ["pp", "sep", "mp", "sharding", "dp"]  # outer -> inner


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._parallel_names = list(hybrid_group_names or _ORDER)
        self._dims = list(dims or [1] * len(self._parallel_names))
        self._world_size = int(np.prod(self._dims))

    def get_hybrid_group_names(self):
        return list(self._parallel_names)

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = [kwargs[n] for n in self._parallel_names]
        return int(np.ravel_multi_index(coord, self._dims))

    def get_coord(self, rank):
        return tuple(int(c) for c in np.unravel_index(rank, self._dims))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r in range(self._world_size)
                if self.get_coord(r)[axis] == index]

    def get_comm_list(self, axis_name):
        """Every group along ``axis_name``: ranks that differ on that axis
        only."""
        axis = self._parallel_names.index(axis_name)
        other_dims = [d for i, d in enumerate(self._dims) if i != axis]
        groups = []
        for other in itertools.product(*[range(d) for d in other_dims]):
            ranks = []
            for i in range(self._dims[axis]):
                coord = list(other)
                coord.insert(axis, i)
                ranks.append(int(np.ravel_multi_index(coord, self._dims)))
            groups.append(ranks)
        return groups

    def get_rank_from_stage(self, global_rank, **kwargs):
        coord = list(self.get_coord(global_rank))
        for k, v in kwargs.items():
            coord[self._parallel_names.index(k)] = v
        return int(np.ravel_multi_index(coord, self._dims))


class HybridCommunicateGroup:
    """reference topology.py:189: the mesh of the job's ranks and one
    Group per axis."""

    def __init__(self, topology: CommunicateTopology):
        self._topo = topology
        self.global_rank = get_rank()
        self.nranks = topology.world_size()
        if self.nranks != get_world_size():
            raise ValueError(
                f"the hybrid topology {dict(zip(topology.get_hybrid_group_names(), topology._dims))} "
                f"spans {self.nranks} ranks; the job has {get_world_size()}")
        self._dp_degree = topology.get_dim("dp")
        self._mp_degree = topology.get_dim("mp")
        self._pp_degree = topology.get_dim("pp")
        self._sharding_degree = topology.get_dim("sharding")
        names = topology.get_hybrid_group_names()
        self._sep_degree = topology.get_dim("sep") if "sep" in names else 1
        self.mesh = ProcessMesh(shape=[topology.get_dim(n) for n in names],
                                dim_names=names)
        self._coord = dict(zip(names, topology.get_coord(self.global_rank)))
        self._groups: Dict[str, Group] = {}
        for nm in names:
            for ranks in self._topo.get_comm_list(nm):
                g = new_group(ranks)
                if self.global_rank in ranks:
                    self._groups[nm] = g
        # the mesh's axes resolve to these groups (collective.ops over "mp",
        # "sep", ...) without building torch's DeviceMesh
        self.mesh._groups.update(self._groups)

    # --- degree queries (reference API) ---
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_data_parallel_rank(self):
        return self._coord.get("dp", 0)

    def get_model_parallel_rank(self):
        return self._coord.get("mp", 0)

    def get_stage_id(self):
        return self._coord.get("pp", 0)

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self._pp_degree - 1

    def get_sharding_parallel_rank(self):
        return self._coord.get("sharding", 0)

    def get_sep_parallel_rank(self):
        return self._coord.get("sep", 0)

    # --- group handles ---
    def get_data_parallel_group(self):
        return self._groups.get("dp")

    def get_model_parallel_group(self):
        return self._groups.get("mp")

    def get_pipe_parallel_group(self):
        return self._groups.get("pp")

    def get_sharding_parallel_group(self):
        return self._groups.get("sharding")

    def get_sep_parallel_group(self):
        return self._groups.get("sep")

    def get_check_parallel_group(self, *a, **k):
        return self._groups.get("mp")

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_p2p_groups(self):
        return None

    def topology(self):
        return self._topo

    @property
    def process_mesh(self) -> ProcessMesh:
        return self.mesh


_HCG: Optional[HybridCommunicateGroup] = None


def get_hybrid_communicate_group():
    return _HCG


def set_hybrid_communicate_group(hcg):
    global _HCG
    _HCG = hcg
    return hcg
