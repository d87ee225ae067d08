"""paddle.incubate.asp on the port: the port of
``paddle_tpu/incubate/asp/__init__.py`` (reference incubate/asp/asp.py:
2:4 structured sparsity: ``prune_model``'s magnitude masks and an optimizer
wrapper that applies them again after each step).

The masks are computed on each weight's device in torch ops: of every 4
consecutive values of the flattened weight, the 2 largest ``|w|`` are kept.
Equal magnitudes keep the positions the reference keeps: its numpy
``argsort`` of 4 values is stable, so the lower index counts as the smaller
and goes first, as ``torch.sort(stable=True)`` orders them. A mask is a
bool tensor on its parameter (``p._asp_mask``); masking is in place, so
each parameter stays the same leaf. The masked weights stay dense (the
reference keeps them dense too). Where the optimizer keeps float32 master
weights (``multi_precision``), the decorated step masks the master weight
too: the reference masks the parameter alone, and its next step then
recomputes the pruned entries from the master (ROADMAP, deliberate
differences)."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

__all__ = ["calculate_density", "decorate", "prune_model",
           "set_excluded_layers", "reset_excluded_layers",
           "OptimizerWithSparsityGuarantee"]

_excluded: Dict[int, List[str]] = {}


def calculate_density(x) -> float:
    """The share of nonzero values (reference asp.py calculate_density),
    counted on the tensor's device."""
    a = getattr(x, "_data", x)
    if isinstance(a, torch.Tensor):
        return int(torch.count_nonzero(a)) / max(a.numel(), 1)
    a = np.asarray(a)
    return float(np.count_nonzero(a)) / max(a.size, 1)


def _mask_2_4(w: torch.Tensor) -> torch.Tensor:
    """Keep the 2 largest |w| of every 4 along the flattened weight (the
    n=2 m=4 pattern of the reference's get_mask_1d)."""
    flat = w.detach().reshape(-1).float()
    pad = (-flat.numel()) % 4
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    groups = flat.abs().reshape(-1, 4)
    order = torch.sort(groups, dim=1, stable=True).indices
    mask = torch.ones_like(groups, dtype=torch.bool)
    mask.scatter_(1, order[:, :2], False)
    mask = mask.reshape(-1)
    if pad:
        mask = mask[:-pad]
    return mask.reshape(w.shape)


def _master_of(optimizer, p):
    """The optimizer's float32 master weight of ``p``, or None."""
    master = getattr(optimizer, "_master_weight", None)
    return master(p) if master is not None else None


def _apply_mask(p, mask, optimizer=None):
    with torch.no_grad():
        p._data.mul_(mask)
        mw = _master_of(optimizer, p)
        if mw is not None:
            mw._data.mul_(mask)
    p._version += 1


def set_excluded_layers(param_names, main_program=None):
    _excluded.setdefault(0, []).extend(param_names)


def reset_excluded_layers(main_program=None):
    _excluded.clear()


def _prunable(layer, p):
    from ... import nn
    if p.name and any(p.name.startswith(e) or e in p.name
                      for e in _excluded.get(0, [])):
        return False
    return isinstance(layer, nn.Linear) and p.ndim == 2


def prune_model(model, n=2, m=4, mask_algo='mask_1d', with_mask=True):
    """Apply 2:4 magnitude masks to every prunable weight (reference
    asp.py:319): every ``nn.Linear`` weight not excluded. Returns
    {id(weight): mask}."""
    masks = {}
    for layer in model.sublayers(include_self=True):
        w = getattr(layer, "weight", None)
        if w is None or not _prunable(layer, w):
            continue
        mask = _mask_2_4(w._data)
        _apply_mask(w, mask)
        w._asp_mask = mask
        masks[id(w)] = mask
    return masks


class OptimizerWithSparsityGuarantee:
    """reference asp.py:233: after each optimizer step the masks are
    applied again, so pruned entries stay zero through training."""

    def __init__(self, optimizer):
        self._optimizer = optimizer

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def step(self, *args, **kwargs):
        out = self._optimizer.step(*args, **kwargs)
        for p in self._optimizer._parameter_list:
            mask = getattr(p, "_asp_mask", None)
            if mask is not None:
                _apply_mask(p, mask, self._optimizer)
        return out

    def clear_grad(self, *a, **k):
        return self._optimizer.clear_grad(*a, **k)


def decorate(optimizer) -> OptimizerWithSparsityGuarantee:
    return OptimizerWithSparsityGuarantee(optimizer)
