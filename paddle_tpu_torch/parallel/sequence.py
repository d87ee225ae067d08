"""Sequence-parallel helpers: the port of ``paddle_tpu/parallel/sequence.py``
(reference: fleet/utils/sequence_parallel_utils.py, the Scatter/AllGather
PyLayers :85-137).

The reference constrains a global array to a sequence-sharded layout and
back. Here each rank holds its tensor: ``shard_sequence`` takes this
rank's slice of the sequence of a tensor that every rank holds whole (its
gradient is all-gathered), ``gather_sequence`` all-gathers the slices back
into the whole on every rank (its gradient is this rank's slice). Without
a mesh that has the axis, both are the identity.
"""
from __future__ import annotations

from typing import Optional

from ..core.dispatch import run_op
from ..core.tensor import Tensor
from ..distributed import collective as C
from ..distributed.mesh import ProcessMesh, get_mesh

_SP_ENABLED = False


def enable_sequence_parallel(flag=True):
    global _SP_ENABLED
    _SP_ENABLED = flag


def sequence_parallel_enabled():
    return _SP_ENABLED


def _group(mesh, axis_name):
    mesh = mesh or get_mesh()
    if mesh is None or axis_name not in mesh.dim_names:
        return None
    return mesh.get_group(axis_name)


def _apply(name, fn, x):
    if isinstance(x, Tensor):
        return run_op(name, fn, x)
    return fn(x)


def shard_sequence(x, mesh: Optional[ProcessMesh] = None,
                   axis_name: str = "sp", seq_dim: int = 1):
    """This rank's [B, S / n, ...] slice of the sequence."""
    group = _group(mesh, axis_name)
    if group is None:
        return x
    return _apply("shard_sequence",
                  lambda a: C._Split.apply(a, group, seq_dim), x)


def gather_sequence(x, mesh: Optional[ProcessMesh] = None,
                    axis_name: str = "sp", seq_dim: int = 1):
    """The whole sequence from every rank's slice, on every rank."""
    group = _group(mesh, axis_name)
    if group is None:
        return x
    return _apply("gather_sequence",
                  lambda a: C._GatherInvariant.apply(a, group, seq_dim), x)
