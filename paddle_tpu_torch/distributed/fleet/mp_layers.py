"""Tensor-parallel (Megatron) layers: the port of
``paddle_tpu/distributed/fleet/mp_layers.py`` (reference:
fleet/layers/mpu/mp_layers.py — VocabParallelEmbedding :47,
ColumnParallelLinear :334, RowParallelLinear :541, ParallelCrossEntropy;
mp_ops.py; the RNG tracker, mpu/random.py:34).

The reference holds each weight as one global array sharded over the "mp"
mesh axis and lets GSPMD place the collectives. Here each rank is a process
and holds its shard as the layer's Parameter; the collectives are explicit
and differentiable (``collective.ops``): a column-parallel input is
``pvary``'d (Megatron's f), a row-parallel output ``psum``'d (its g), and
the vocab-parallel lookup is a masked local lookup and a ``psum``. Every
rank draws the global weight from the same generator and keeps its slice,
so the shards together are the weight a single process would draw. A
layer's ``in_features``/``out_features`` (``num_embeddings``) are global;
each sharded Parameter carries ``split_axis``, ``segments`` and
``global_shape``. ``set_global_params`` sets a layer's shards from global
arrays (the reference's) and ``gather_global_params`` gathers them back.

A fused projection (the GPT's q|k|v, ``ColumnParallelLinear(segments=3)``)
holds ``segments`` equal blocks along its split axis; a rank holds its chunk
of each block, concatenated, so that its shard carries its own heads' q, k
and v columns. Under GSPMD the reference's contiguous shard straddles q|k|v
and its global reshape mends that; here each rank computes on its shard.

The group is ``mp_group``, else the model-parallel group of fleet's
topology, else the "mp"/"tp" axis of the current ``ProcessMesh``; with none
of them a layer is its dense counterpart.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as tF

from ...core.dispatch import run_op
from ...core.tensor import Parameter, Tensor
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from .. import collective as C
from ..mesh import get_mesh
from .topology import get_hybrid_communicate_group


def _mp_group(mp_group=None):
    """The model-parallel Group, or None (one rank)."""
    if mp_group is not None:
        return mp_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_model_parallel_world_size() > 1:
        return hcg.get_model_parallel_group()
    mesh = get_mesh()
    if mesh is not None and ("mp" in mesh.dim_names
                             or "tp" in mesh.dim_names):
        return mesh.get_group("mp")
    return None


def _size_rank(group):
    return (1, 0) if group is None else (group.nranks, group.rank)


def _shard(v, axis, n, r, segments=1):
    """Rank ``r``'s slice along ``axis`` of a global array: its chunk of
    each of ``segments`` equal blocks, concatenated."""
    if segments == 1:
        return v.chunk(n, axis)[r]
    return torch.cat([blk.chunk(n, axis)[r]
                      for blk in v.chunk(segments, axis)], axis)


def gather_global(p, a):
    """The global array of sharded Parameter ``p`` from every rank's local
    array ``a`` (its value, or its gradient); ``a`` itself when ``p`` is
    not sharded."""
    axis = getattr(p, "split_axis", None)
    group = getattr(p, "mp_group", None)
    if axis is None or group is None or group.nranks == 1:
        return a
    segments = getattr(p, "segments", 1)
    if segments == 1:
        return C._gather_along(a, group, axis)
    blocks = C._gather_along(a.unflatten(axis, (segments, -1)), group,
                             axis + 1)
    return blocks.flatten(axis, axis + 1)


def _sharded_parameter(layer, shape, attr, split_axis, group, is_bias=False,
                       default_initializer=None, segments=1):
    """A Parameter holding this rank's slice along ``split_axis`` of a
    global parameter of ``shape`` (drawn whole, then sliced; ``_shard``),
    or the whole parameter with ``split_axis`` None."""
    p = layer.create_parameter(shape, attr, is_bias=is_bias,
                               default_initializer=default_initializer)
    if p is None:
        return None
    n, r = _size_rank(group)
    if split_axis is not None and n > 1:
        if shape[split_axis] % (n * segments):
            raise ValueError(f"dim {split_axis} of {list(shape)} is not "
                             f"divisible into {segments} block(s) over the "
                             f"{n} model-parallel ranks")
        shard = _shard(p._data.detach(), split_axis, n, r,
                       segments).contiguous()
        q = Parameter._wrap_param(shard, trainable=p.trainable, name=p.name)
        q.optimize_attr = p.optimize_attr
        q.regularizer, q.need_clip = p.regularizer, p.need_clip
        p = q
    p.is_distributed = split_axis is not None
    p.split_axis = split_axis
    p.segments = segments
    p.global_shape = tuple(int(s) for s in shape)
    p.mp_group = group
    return p


def set_global_params(layer, arrays):
    """Set ``layer``'s parameters from global arrays keyed by parameter name
    (``named_parameters``): a sharded one takes this rank's slice."""
    params = dict(layer.named_parameters())
    for name, value in arrays.items():
        p = params[name]
        v = value._data if isinstance(value, Tensor) else torch.as_tensor(
            value)
        axis = getattr(p, "split_axis", None)
        n, r = _size_rank(getattr(p, "mp_group", None))
        if axis is not None and n > 1:
            v = _shard(v, axis, n, r, getattr(p, "segments", 1))
        p.set_value(v.contiguous())
    return layer


def gather_global_params(layer):
    """{name: the global parameter as a torch tensor} on every rank."""
    return {name: gather_global(p, p._data.detach()).clone()
            for name, p in layer.named_parameters()}


class VocabParallelEmbedding(Layer):
    """The embedding with its rows (the vocab) sharded over the group: each
    rank looks up the ids in its range, zeroes the rest, and a psum adds
    the ranks' rows (reference mp_layers.py:47)."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self._group = _mp_group(mp_group)
        n, r = _size_rank(self._group)
        self.vocab_start_index = r * num_embeddings // n
        self.weight = _sharded_parameter(
            self, (num_embeddings, embedding_dim), weight_attr, 0,
            self._group, default_initializer=I.XavierNormal())
        self.weight.is_distributed = True

    def forward(self, x):
        group = self._group
        lo = self.vocab_start_index

        def f(ids, w):
            ids = ids.long()
            if group is None or group.nranks == 1:
                return tF.embedding(ids, w)
            local = ids - lo
            inside = (local >= 0) & (local < w.shape[0])
            out = tF.embedding(local.clamp(0, w.shape[0] - 1), w)
            out = out * inside[..., None].to(out.dtype)
            return C._Psum.apply(out, group)
        return run_op("vocab_parallel_embedding", f, x, self.weight)


class ColumnParallelLinear(Layer):
    """weight [in, out] sharded on out: a pvary'd input times this rank's
    columns (+ its bias), all-gathered on the feature dim when
    ``gather_output`` (reference mp_layers.py:334). Without it the output
    is this rank's [.., out / n] shard. ``segments`` (the port's: 3 for a
    fused q|k|v) shards each of that many equal blocks of the output
    features; a gathered output then holds the ranks' blocks interleaved,
    so it is refused."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, segments=1):
        super().__init__()
        if gather_output and segments != 1:
            raise ValueError("ColumnParallelLinear: segments need "
                             "gather_output=False")
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self._group = _mp_group(mp_group)
        self.weight = _sharded_parameter(
            self, (in_features, out_features), weight_attr, 1, self._group,
            default_initializer=I.XavierNormal(), segments=segments)
        self.weight.is_distributed = True
        self.bias = _sharded_parameter(
            self, (out_features,), None, 0, self._group,
            is_bias=True, segments=segments) if has_bias else None

    def forward(self, x):
        group, gather = self._group, self.gather_output

        def f(a, w, *b):
            if group is not None:
                a = C._Pvary.apply(a, group)
            out = torch.matmul(a, w)
            if b:
                out = out + b[0]
            if gather and group is not None:
                out = C._GatherInvariant.apply(out, group, out.dim() - 1)
            return out
        args = (x, self.weight) + ((self.bias,) if self.bias is not None
                                   else ())
        return run_op("column_parallel_linear", f, *args)


class RowParallelLinear(Layer):
    """weight [in, out] sharded on in: this rank's input features (its slice
    of a replicated input unless ``input_is_parallel``) times its rows, a
    psum, then the (replicated) bias (reference mp_layers.py:541)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.input_is_parallel = input_is_parallel
        self._group = _mp_group(mp_group)
        self.weight = _sharded_parameter(
            self, (in_features, out_features), weight_attr, 0, self._group,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True
        self.bias = _sharded_parameter(
            self, (out_features,), None, None, self._group,
            is_bias=True) if has_bias else None

    def forward(self, x):
        group, parallel = self._group, self.input_is_parallel

        def f(a, w, *b):
            if group is not None and not parallel:
                a = C._Split.apply(a, group, a.dim() - 1)
            out = torch.matmul(a, w)
            if group is not None:
                out = C._Psum.apply(out, group)
            if b:
                out = out + b[0]
            return out
        args = (x, self.weight) + ((self.bias,) if self.bias is not None
                                   else ())
        return run_op("row_parallel_linear", f, *args)


def parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-token cross entropy over logits whose class dim is sharded over
    ``group`` (this rank's [.., V / n] slice): the max and the sum of
    exponentials over the group, the picked logit from the rank that holds
    it. torch tensors; ``label`` holds global class ids."""
    n, r = _size_rank(group)
    vl = logits.shape[-1]
    lf = logits.float()
    mx = lf.detach().amax(-1)
    if n > 1:
        mx = C._sum_over(mx, group, C.ReduceOp.MAX)
    se = torch.exp(lf - mx[..., None]).sum(-1)
    loc = label.long() - r * vl
    inside = (loc >= 0) & (loc < vl)
    picked = lf.gather(-1, loc.clamp(0, vl - 1)[..., None])[..., 0]
    picked = torch.where(inside, picked, torch.zeros_like(picked))
    if n > 1:
        se = C._Psum.apply(se, group)
        picked = C._Psum.apply(picked, group)
    loss = torch.log(se) + mx - picked
    return torch.where(label.long() == ignore_index,
                       torch.zeros_like(loss), loss)


class ParallelCrossEntropy(Layer):
    """Cross entropy over logits sharded on the class dim over the group
    (reference mp_layers.py ParallelCrossEntropy; mp_ops
    _c_softmax_with_cross_entropy): per-token losses, 0 where the label is
    ``ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = _mp_group(mp_group)

    def forward(self, input, label):
        group, ignore = self._group, self.ignore_index

        def f(logits, lbl):
            if lbl.dim() == logits.dim():
                lbl = lbl.squeeze(-1)
            return parallel_cross_entropy(logits, lbl, group, ignore)
        return run_op("parallel_cross_entropy", f, input, label)


class RNGStatesTracker:
    """Named generators (reference mpu/random.py:34): ``rng_state(name)``
    makes the port's default generator the named one inside the block, so
    draws inside a tensor-parallel region (dropout) come from a stream of
    this rank's, while weights drawn outside share one stream."""

    def __init__(self):
        self._states = {}

    def add(self, name, seed):
        from ...core.generator import Generator
        if name in self._states:
            raise ValueError(f"state {name!r} already exists")
        self._states[name] = Generator(seed)

    def reset(self):
        self._states = {}

    def rng_state(self, name="global_seed"):
        @contextlib.contextmanager
        def guard():
            from ...core import generator as gen_mod
            if name in self._states:
                prev = gen_mod._DEFAULT
                gen_mod._DEFAULT = self._states[name]
                try:
                    yield
                finally:
                    gen_mod._DEFAULT = prev
            else:
                yield
        return guard()


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_TRACKER


def model_parallel_random_seed(seed: Optional[int] = None):
    """The tracker's "global_seed" stream is ``seed`` on every rank, its
    "local_seed" stream ``seed + 1024 + mp_rank`` (the reference's
    ``seed + 1024`` at mp rank 0): one stream a model-parallel rank."""
    import random as _r
    seed = seed if seed is not None else _r.randint(0, 2 ** 31 - 1)
    _, rank = _size_rank(_mp_group())
    _RNG_TRACKER.reset()
    _RNG_TRACKER.add("global_seed", seed)
    _RNG_TRACKER.add("local_seed", seed + 1024 + rank)
