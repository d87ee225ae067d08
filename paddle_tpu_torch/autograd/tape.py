"""The backward walk: the port of ``paddle_tpu/autograd/tape.py``.

The reference walks its own tape of GradNodes (``RunBackward``,
eager/backward.cc:105). The port's graph is torch's, so the walk is
``torch.autograd.backward``: it accumulates into each leaf's ``.grad``
(which ``Tensor.grad`` reads), runs the hooks that ``Tensor.register_hook``
put on the torch tensors, and frees the graph unless ``retain_graph``, so a
second backward through a freed graph raises ``RuntimeError`` as in the
reference. There is no GradNode, Edge or second tape.
"""
from __future__ import annotations

import torch


def run_backward(tensors, grad_tensors=None, retain_graph=False):
    """Backward from ``tensors`` with matching initial gradients
    (``grad_tensors``; None = ones). A root that stops gradient, or that
    no differentiable input reaches, contributes nothing."""
    from ..core.tensor import Tensor

    if grad_tensors is None:
        grad_tensors = [None] * len(tensors)
    roots, grads = [], []
    for t, g in zip(tensors, grad_tensors):
        a = t._data
        if t._sg or not a.requires_grad:
            continue
        if g is None:
            g = torch.ones_like(a)
        elif isinstance(g, Tensor):
            g = g._data
        else:
            g = torch.as_tensor(g, dtype=a.dtype, device=a.device)
        roots.append(a)
        grads.append(g)
    if roots:
        torch.autograd.backward(roots, grads, retain_graph=retain_graph)
