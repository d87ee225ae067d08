"""incubate.nn.loss: the port of ``paddle_tpu/incubate/nn/loss.py``
(reference python/paddle/incubate/nn/loss.py)."""
from __future__ import annotations

import torch

from ...core.dispatch import run_op
from ...core.tensor import Tensor

_MODES = {"sum": 0, "mean": 1, "none": 2, 0: 0, 1: 1, 2: 2}


def identity_loss(x, reduction="none"):
    """Marks a tensor as the loss head and applies the reduction
    (reference incubate/nn/loss.py:36; 'sum'/'mean'/'none' or 0/1/2)."""
    if reduction not in _MODES:
        raise ValueError(f"reduction should be sum/mean/none, "
                         f"got {reduction!r}")
    mode = _MODES[reduction]
    t = x if isinstance(x, Tensor) else Tensor(x)
    if mode == 0:
        return run_op("identity_loss_sum", torch.sum, t)
    if mode == 1:
        return run_op("identity_loss_mean", torch.mean, t)
    return run_op("identity_loss", lambda a: a.clone(), t)
