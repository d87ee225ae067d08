"""Megatron-style sequence parallelism tied to tensor parallelism: the port
of ``paddle_tpu/distributed/fleet/sequence_parallel_utils.py`` (reference:
fleet/utils/sequence_parallel_utils.py — ScatterOp/GatherOp/AllGatherOp/
ReduceScatterOp :85-137, ColumnSequenceParallelLinear :427 with its
all-gather overlap :255, RowSequenceParallelLinear,
mark_as_sequence_parallel_parameter and
register_sequence_parallel_allreduce_hooks :192).

Between tensor-parallel blocks each rank holds its [B, S / n, ...] slice of
the sequence. The column linear all-gathers its input on the sequence dim
(the gradient is reduce-scattered back) before this rank's columns; the row
linear reduce-scatters its partial products onto the sequence dim (the
gradient is all-gathered). With ``FLAGS_collective_matmul`` both become
the ring collective matmuls of ``parallel/collective_matmul.py``.

The reference's hooks are a no-op (GSPMD reduces the gradients of
replicated parameters used on sharded activations). Here they are real:
a parameter used on this rank's slice of the sequence only (a LayerNorm's,
the row linear's bias) gets a gradient from that slice only, and
``register_sequence_parallel_allreduce_hooks`` sums the marked parameters'
gradients over the model-parallel group after they are accumulated.
"""
from __future__ import annotations

import torch

from ...core.dispatch import run_op
from ...nn import initializer as I
from ...nn.layer.layers import Layer
from .. import collective as C
from .mp_layers import _mp_group, _sharded_parameter


def _use_collective_matmul(group):
    """The ring is opt-in (``FLAGS_collective_matmul``)."""
    if group is None:
        return False
    from ...core.flags import get_flag
    return bool(get_flag("FLAGS_collective_matmul"))


def scatter(x, seq_dim: int = 1):
    """Replicated -> this rank's slice of the sequence (ScatterOp :85; the
    gradient is all-gathered)."""
    group = _mp_group()
    if group is None:
        return x
    return run_op("sp_scatter", lambda a: C._Split.apply(a, group, seq_dim),
                  x)


def all_gather(x, seq_dim: int = 1):
    """This rank's slice of the sequence -> the replicated whole (GatherOp;
    the gradient is this rank's slice)."""
    group = _mp_group()
    if group is None:
        return x
    return run_op("sp_all_gather",
                  lambda a: C._GatherInvariant.apply(a, group, seq_dim), x)


def all_gather_partial(x, seq_dim: int = 1):
    """This rank's slice -> the whole, used differently by each rank
    (AllGatherOp :107: the gradient is reduce-scattered)."""
    group = _mp_group()
    if group is None:
        return x
    return run_op("sp_all_gather_partial",
                  lambda a: C._AllGather.apply(a, group, seq_dim), x)


def reduce_scatter(x, seq_dim: int = 1):
    """Partial sums -> this rank's slice of their sum (ReduceScatterOp :127;
    the gradient is all-gathered)."""
    group = _mp_group()
    if group is None:
        return x
    return run_op("sp_reduce_scatter",
                  lambda a: C._ReduceScatter.apply(a, group, seq_dim), x)


def mark_as_sequence_parallel_parameter(param):
    """Reference :176: tag a parameter used on this rank's sequence slice
    only; ``register_sequence_parallel_allreduce_hooks`` sums its
    gradient over the model-parallel group."""
    param.sequence_parallel = True


def is_sequence_parallel_parameter(param):
    return getattr(param, "sequence_parallel", False)


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse_grad=False):
    """Reference :192. After every ``accumulation_steps``-th accumulation of
    a marked parameter's gradient, the gradient is summed over the
    model-parallel group (in place). ``fuse_grad`` is accepted: each
    parameter's sum is one collective."""
    group = _mp_group()
    if group is None or group.nranks == 1:
        return model
    steps = max(int(accumulation_steps), 1)
    for p in model.parameters():
        if not is_sequence_parallel_parameter(p) or p.stop_gradient:
            continue
        count = [0]

        def hook(param, count=count):
            count[0] += 1
            if count[0] % steps == 0:
                g = param._grad_holder().grad
                g.copy_(C._sum_over(g, group))
        p._register_backward_hook(hook)
    return model


class ColumnSequenceParallelLinear(Layer):
    """Input [B, S / n, in] (this rank's slice of the sequence), all-gathered
    on the sequence and hit with this rank's columns: [B, S, out / n]
    (reference :427); with ``gather_output`` the features are all-gathered
    too."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=False, mp_group=None,
                 name=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self._group = _mp_group(mp_group)
        self.weight = _sharded_parameter(
            self, (in_features, out_features), weight_attr, 1, self._group,
            default_initializer=I.XavierNormal())
        self.weight.is_distributed = True
        self.bias = _sharded_parameter(
            self, (out_features,), None, 0, self._group,
            is_bias=True) if has_bias else None

    def forward(self, x):
        group, gather = self._group, self.gather_output

        def f(a, w, *b):
            if group is None:
                out = torch.matmul(a, w)
            elif _use_collective_matmul(group) and a.dim() == 3:
                from ...parallel.collective_matmul import \
                    sp_column_matmul_local
                out = sp_column_matmul_local(a, w, group)
            else:
                out = torch.matmul(C._AllGather.apply(a, group, 1), w)
            if b:
                out = out + b[0]
            if gather and group is not None:
                out = C._GatherInvariant.apply(out, group, out.dim() - 1)
            return out
        args = (x, self.weight) + ((self.bias,) if self.bias is not None
                                   else ())
        return run_op("column_seq_parallel_linear", f, *args)


class RowSequenceParallelLinear(Layer):
    """Input [B, S, in / n] (this rank's features) times this rank's rows,
    the partial sums reduce-scattered onto the sequence: [B, S / n, out],
    plus the bias, which is marked sequence-parallel (reference
    RowSequenceParallelLinear)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=True, mp_group=None,
                 name=None):
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
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def forward(self, x):
        group, parallel = self._group, self.input_is_parallel

        def f(a, w, *b):
            if group is None:
                out = torch.matmul(a, w)
            else:
                if not parallel:
                    a = C._Split.apply(a, group, a.dim() - 1)
                if _use_collective_matmul(group) and a.dim() == 3:
                    from ...parallel.collective_matmul import \
                        sp_row_matmul_local
                    out = sp_row_matmul_local(a, w, group)
                else:
                    out = C._ReduceScatter.apply(torch.matmul(a, w), group,
                                                 1)
            if b:
                out = out + b[0]
            return out
        args = (x, self.weight) + ((self.bias,) if self.bias is not None
                                   else ())
        return run_op("row_seq_parallel_linear", f, *args)


GatherOp = all_gather
ScatterOp = scatter
AllGatherOp = all_gather_partial
ReduceScatterOp = reduce_scatter
