"""Main-grad mixed-precision wrappers: the port of
``paddle_tpu/distributed/fleet/utils/mix_precision_utils.py`` (reference
fleet/utils/mix_precision_utils.py: MixPrecisionLayer keeps an fp32
``main_grad`` per parameter accumulated from the low-precision gradients;
MixPrecisionOptimizer steps on the main grads; MixPrecisionScaler delegates
to the wrapped GradScaler)."""
from __future__ import annotations

import torch

from ....core.tensor import Tensor
from ....nn.layer.layers import Layer


class MixPrecisionLayer(Layer):
    def __init__(self, layers, dtype="bfloat16"):
        super().__init__()
        self._layers = layers
        self._dtype = dtype
        for _, param in layers.named_parameters():
            param.main_grad = None
            param.register_hook(self._make_accum_hook(param))

    @staticmethod
    def _make_accum_hook(param):
        @torch.no_grad()
        def hook(grad):
            if grad is None:
                return grad
            g32 = (grad._data if isinstance(grad, Tensor) else grad).float()
            if param.main_grad is None:
                param.main_grad = Tensor._wrap(g32.clone())
            else:
                param.main_grad._data.add_(g32)
            return grad
        return hook

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)


class MixPrecisionOptimizer:
    """Steps the inner optimizer on each parameter's fp32 ``main_grad``
    (reference mix_precision_utils.py:97): the main grad stands in for
    ``.grad`` during the step and is then cleared."""

    def __init__(self, optimizer):
        self.__dict__["_inner_opt"] = optimizer

    def __getattr__(self, name):
        return getattr(self._inner_opt, name)

    def _params(self):
        from .hybrid_parallel_util import obtain_optimizer_parameters_list
        return obtain_optimizer_parameters_list(self._inner_opt)

    def step(self):
        swapped = []
        for p in self._params():
            mg = getattr(p, "main_grad", None)
            if mg is not None:
                old = p.grad
                swapped.append((p, None if old is None else old._data))
                p.grad = Tensor._wrap(mg._data.to(p._data.dtype))
        self._inner_opt.step()
        for p, old in swapped:
            p.grad = None if old is None else Tensor._wrap(old)
            p.main_grad = None

    def clear_grad(self, set_to_zero=True):
        for p in self._params():
            p.main_grad = None
        self._inner_opt.clear_grad()

    clear_gradients = clear_grad


class MixPrecisionScaler:
    """Wraps a GradScaler for main-grad training (reference :244)."""

    def __init__(self, scaler):
        self.__dict__["_inner_scaler"] = scaler

    def __getattr__(self, name):
        return getattr(self._inner_scaler, name)
