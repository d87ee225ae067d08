"""paddle.regularizer (reference: python/paddle/regularizer.py): weight
decay attached through an optimizer's ``weight_decay``. The optimizer adds
the regularizer's function of the parameter to its gradient:
``coeff * param`` (L2) or ``coeff * sign(param)`` (L1).

Port of ``paddle_tpu/regularizer.py``. The reference's optimizer reads a
``_coeff`` attribute these classes do not have, so a regularizer there
raises ``TypeError`` in ``step()``; the port's optimizer calls the
regularizer itself (``Optimizer._decayed``), which is Paddle's meaning.
"""
from __future__ import annotations

import torch

from .core.dispatch import run_op
from .core.tensor import Tensor


def _on(param, name, fn):
    """``fn`` of a Tensor (through the op layer) or of a torch tensor."""
    if isinstance(param, Tensor):
        return run_op(name, fn, param)
    return fn(param)


class WeightDecayRegularizer:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)
        self._regularization_coeff = self.coeff

    def __call__(self, param):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param)."""

    def __call__(self, param):
        return _on(param, "l1_decay", lambda a: torch.sign(a) * self.coeff)


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param."""

    def __call__(self, param):
        return _on(param, "l2_decay", lambda a: a * self.coeff)


__all__ = ["L1Decay", "L2Decay"]
