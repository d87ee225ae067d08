"""paddle.nn.utils: the port of ``paddle_tpu/nn/utils`` (reference:
python/paddle/nn/utils — weight_norm/spectral_norm hooks, grad clipping,
param<->vector). The reparameterized weight is recomputed before every
forward and rebound onto the layer's parameter, as the reference does."""
from __future__ import annotations

import math

import numpy as np
import torch

from ...core.tensor import Parameter, Tensor
from ..clip import _grad_norm

__all__ = ['weight_norm', 'remove_weight_norm', 'spectral_norm',
           'clip_grad_norm_', 'clip_grad_value_',
           'parameters_to_vector', 'vector_to_parameters']


def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """In-place global-norm gradient clip (reference
    nn/utils/clip_grad_norm_.py): coef = min(max_norm / (total + 1e-6),
    1)."""
    params = [parameters] if isinstance(parameters, Tensor) \
        else list(parameters)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return Tensor(np.zeros((), np.float32))
    total = _grad_norm(grads, norm_type)
    if error_if_nonfinite and not bool(torch.isfinite(total)):
        raise RuntimeError(
            "The total norm for gradients is non-finite")
    coef = torch.clamp_max(max_norm / (total + 1e-6), 1.0)
    for g in grads:
        g._assign_array((g._data.float() * coef).to(g._data.dtype))
    return Tensor._wrap(total)


def clip_grad_value_(parameters, clip_value):
    """In-place element clip of gradients (reference
    clip_grad_value_.py)."""
    params = [parameters] if isinstance(parameters, Tensor) \
        else list(parameters)
    cv = float(clip_value)
    for p in params:
        if p.grad is not None:
            p.grad._assign_array(torch.clamp(p.grad._data, -cv, cv))


def parameters_to_vector(parameters, name=None):
    return Tensor._wrap(torch.cat(
        [p._data.detach().reshape(-1) for p in parameters]))


def vector_to_parameters(vec, parameters, name=None):
    off = 0
    data = vec._data.detach() if isinstance(vec, Tensor) \
        else torch.as_tensor(vec)
    for p in parameters:
        n = math.prod(p.shape)
        p._assign_array(data[off:off + n].reshape(p._data.shape)
                        .to(device=p._data.device, dtype=p._data.dtype))
        off += n


def weight_norm(layer, name='weight', dim=0):
    """Reparameterize layer.<name> as g * v/||v|| (reference
    nn/utils/weight_norm_hook.py). The decomposition recomputes the
    weight on every forward via a pre-forward hook."""
    w = getattr(layer, name)
    arr = w._data.detach()
    axes = tuple(i for i in range(arr.dim()) if i != dim)
    g = torch.sqrt(torch.sum(arr.float() ** 2, dim=axes, keepdim=True))
    v = arr.float() / torch.clamp_min(g, 1e-12)
    layer.add_parameter(name + "_g", Parameter(g))
    layer.add_parameter(name + "_v", Parameter(v))

    def _recompute(ly, inputs):
        gg = getattr(ly, name + "_g")._data.detach()
        vv = getattr(ly, name + "_v")._data.detach()
        norm = torch.sqrt(torch.sum(vv ** 2, dim=axes, keepdim=True))
        getattr(ly, name)._assign_array(
            (gg * vv / torch.clamp_min(norm, 1e-12)).to(arr.dtype))
        return None

    handle = layer.register_forward_pre_hook(_recompute)
    layer._weight_norm_hook = (handle, name)
    _recompute(layer, None)
    return layer


def remove_weight_norm(layer, name='weight'):
    hook = getattr(layer, "_weight_norm_hook", None)
    if hook is not None:
        hook[0].remove()
        del layer._weight_norm_hook
    return layer


def spectral_norm(layer, name='weight', n_power_iterations=1, eps=1e-12,
                  dim=None):
    """Reparameterize with spectral normalization via power iteration
    (reference nn/utils/spectral_norm_hook.py), in numpy float32 from a
    fixed start vector, as the reference."""
    w = getattr(layer, name)
    arr = w.numpy().astype(np.float32)
    if dim is None:
        dim = 0
    mat = np.moveaxis(arr, dim, 0).reshape(arr.shape[dim], -1)
    rs = np.random.RandomState(0)
    u = rs.randn(mat.shape[0]).astype(np.float32)
    u /= np.linalg.norm(u) + eps
    state = {"u": u}

    def _recompute(ly, inputs):
        a = getattr(ly, name + "_orig").numpy().astype(np.float32)
        m = np.moveaxis(a, dim, 0).reshape(a.shape[dim], -1)
        uu = state["u"]
        for _ in range(n_power_iterations):
            vv = m.T @ uu
            vv /= np.linalg.norm(vv) + eps
            uu = m @ vv
            uu /= np.linalg.norm(uu) + eps
        state["u"] = uu
        sigma = float(uu @ m @ vv)
        getattr(ly, name)._assign_array(
            torch.from_numpy(a / max(sigma, eps)).to(
                device=w._data.device, dtype=w._data.dtype))
        return None

    layer.add_parameter(name + "_orig", Parameter(arr))
    handle = layer.register_forward_pre_hook(_recompute)
    layer._spectral_norm_hook = (handle, name)
    _recompute(layer, None)
    return layer
