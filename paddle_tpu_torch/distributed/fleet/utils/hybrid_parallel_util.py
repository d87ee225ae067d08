"""Hybrid-parallel gradient and parameter sync: the port of
``paddle_tpu/distributed/fleet/utils/hybrid_parallel_util.py`` (reference
fleet/utils/hybrid_parallel_util.py).

``fused_allreduce_gradients`` makes every gradient the global mean over the
group: one AVG all-reduce a bucket of ``bucket_size`` bytes (one dtype and
device a bucket). It applies no further divide by the group's size (the
reference's rule: its gradients already are the global mean); an explicit
``scale`` still divides."""
from __future__ import annotations

import torch

from ....core.tensor import Tensor
from ... import collective as C


def obtain_optimizer_parameters_list(optimizer):
    inner = getattr(optimizer, "_inner_opt", None) or optimizer
    params = getattr(inner, "_parameter_list", None) or []
    if params and isinstance(params[0], dict):
        flat = []
        for group in params:
            flat.extend(group.get("params", []))
        return flat
    return list(params)


def unwrap_optimizer(optimizer, optimizer_instances=()):
    opt = optimizer
    while optimizer_instances and isinstance(opt, optimizer_instances):
        opt = opt._inner_opt
    return opt


def _buckets(params, bucket_size):
    out, cur, nbytes, key = [], [], 0, None
    for p in params:
        a = p._data
        k = (a.dtype, a.device)
        if cur and (k != key or nbytes >= bucket_size):
            out.append(cur)
            cur, nbytes = [], 0
        cur.append(p)
        key = k
        nbytes += a.numel() * a.element_size()
    if cur:
        out.append(cur)
    return out


def fused_allreduce_gradients_with_group(parameter_list, group,
                                         bucket_size=128 * 1024 * 1024,
                                         scale=None):
    """Make each present gradient the mean over ``group`` (then divide by
    ``scale`` when given)."""
    params = [p for p in parameter_list if not p.stop_gradient]

    @torch.no_grad()
    def sync():
        present = [p for p in params if p.grad is not None]
        for bucket in _buckets(present, bucket_size):
            grads = [p.grad._data for p in bucket]
            flat = torch.cat([g.reshape(-1) for g in grads])
            C.all_reduce_flat(flat, C.ReduceOp.AVG, group)
            if scale and scale != 1:
                flat.div_(scale)
            off = 0
            for g in grads:
                g.copy_(flat[off:off + g.numel()].view_as(g))
                off += g.numel()
    # keyed by the parameters: under no_sync one deferred sync re-reads the
    # accumulated gradients at the window's exit
    C.defer_or_run(("fused_allreduce", tuple(id(p) for p in params),
                    id(group)), sync)


def fused_allreduce_gradients(parameter_list, hcg):
    group = hcg.get_data_parallel_group() if hcg is not None else None
    fused_allreduce_gradients_with_group(parameter_list, group)


def _broadcast_params(model, group, fuse_params=True):
    src = group.ranks[0] if group is not None else 0
    for _, p in model.named_parameters():
        C.broadcast(p, src=src, group=group)
    for _, b in model.named_buffers():
        if isinstance(b, Tensor):
            C.broadcast(b, src=src, group=group)


def broadcast_mp_parameters(model, hcg, fuse_params=True):
    _broadcast_params(model, hcg.get_model_parallel_group(), fuse_params)


def broadcast_dp_parameters(model, hcg, fuse_params=True):
    _broadcast_params(model, hcg.get_data_parallel_group(), fuse_params)


def broadcast_sharding_parameters(model, hcg, fuse_params=True):
    _broadcast_params(model, hcg.get_sharding_parallel_group(),
                      fuse_params)


def broadcast_sep_parameters(model, hcg, fuse_params=True):
    _broadcast_params(model, hcg.get_sep_parallel_group(), fuse_params)


def broadcast_input_data(hcg, *inputs, **kwargs):
    """Broadcast the batch from the model-parallel group's first rank, so
    every rank of that group sees the same inputs (reference :168)."""
    group = hcg.get_model_parallel_group()
    src = group.ranks[0] if group is not None else 0
    for v in list(inputs) + list(kwargs.values()):
        if isinstance(v, Tensor):
            C.broadcast(v, src=src, group=group)
    return list(inputs), kwargs
