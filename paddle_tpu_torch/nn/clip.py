"""Gradient clipping: the port of ``paddle_tpu/nn/clip.py`` (reference:
python/paddle/nn/clip.py — ClipGradByGlobalNorm :622). Norms are taken in
float32; clipped gradients are new Tensors in each gradient's dtype."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)


def _clipped(params_grads, fn):
    """(p, fn(g)) for every gradient that is clipped, (p, g) otherwise."""
    out = []
    for p, g in params_grads:
        if g is None or not getattr(p, "need_clip", True):
            out.append((p, g))
        else:
            out.append((p, Tensor._wrap(fn(g._data), True)))
    return out


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def _dygraph_clip(self, params_grads):
        return _clipped(params_grads,
                        lambda g: torch.clamp(g, self.min, self.max))


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        def fn(g):
            gf = g.float()
            scale = torch.clamp_max(
                self.clip_norm / torch.linalg.vector_norm(gf).clamp_min(1e-12),
                1.0)
            return (gf * scale).to(g.dtype)
        return _clipped(params_grads, fn)


class ClipGradByGlobalNorm(ClipGradBase):
    """Global-norm clip over every clipped gradient."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def _dygraph_clip(self, params_grads):
        sq = [torch.sum(torch.square(g._data.float()))
              for p, g in params_grads
              if g is not None and getattr(p, "need_clip", True)]
        if not sq:
            return params_grads
        global_norm = torch.sqrt(torch.stack(sq).sum())
        scale = self.clip_norm / torch.clamp_min(global_norm, self.clip_norm)
        return _clipped(params_grads,
                        lambda g: (g.float() * scale).to(g.dtype))


def _grad_norm(grads, norm_type):
    if norm_type == float("inf"):
        return torch.stack([torch.amax(torch.abs(g._data)).float()
                            for g in grads]).amax()
    return torch.pow(
        torch.stack([torch.sum(torch.pow(torch.abs(g._data.float()),
                                         norm_type)) for g in grads]).sum(),
        1.0 / norm_type)


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    params = [parameters] if isinstance(parameters, Tensor) else \
        list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return Tensor(torch.zeros(()))
    total = _grad_norm(grads, norm_type)
    scale = torch.clamp_max(max_norm / torch.clamp_min(total, 1e-6), 1.0)
    for g in grads:
        g._assign_array((g._data.float() * scale).to(g._data.dtype))
    return Tensor._wrap(total)


def clip_grad_value_(parameters, clip_value):
    params = [parameters] if isinstance(parameters, Tensor) else \
        list(parameters)
    for p in params:
        if p.grad is not None:
            p.grad._assign_array(
                torch.clamp(p.grad._data, -clip_value, clip_value))
