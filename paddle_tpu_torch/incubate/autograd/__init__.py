"""paddle.incubate.autograd on the port: the port of
``paddle_tpu/incubate/autograd/__init__.py`` (reference incubate/autograd:
functional higher-order AD, ``jvp``/``vjp``/``Jacobian``/``Hessian``, and
the prim switches), over ``torch.func``: ``jvp`` and ``vjp`` as
``jax.jvp``/``jax.vjp`` compute them, ``Jacobian`` as ``jax.jacrev`` over
every input, ``Hessian`` as ``jax.hessian`` over the first. ``is_batched``
is taken and does not change the result, as in the reference."""
from __future__ import annotations

import torch

from ...core.tensor import Tensor

__all__ = ["jvp", "vjp", "Jacobian", "Hessian", "disable_prim",
           "enable_prim", "prim_enabled", "forward_grad", "grad"]

def _unwrap(xs):
    if isinstance(xs, (list, tuple)):
        return [x._data if isinstance(x, Tensor) else torch.as_tensor(x)
                for x in xs]
    return [xs._data if isinstance(xs, Tensor) else torch.as_tensor(xs)]


def _wrap_like(arrs, template):
    outs = [Tensor._wrap(a) for a in arrs]
    if isinstance(template, (list, tuple)) or len(outs) > 1:
        return outs
    return outs[0]


def _fn_on_arrays(func):
    # an input that torch.func tracks for reverse mode requires grad: it
    # is wrapped as a Tensor that does not stop gradient, so run_op keeps
    # it in the graph rather than detach it
    def f(*arrs):
        outs = func(*[Tensor._wrap(a, stop_gradient=not a.requires_grad)
                      for a in arrs])
        if isinstance(outs, (list, tuple)):
            return tuple(o._data for o in outs)
        return outs._data
    return f


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def jvp(func, xs, v=None):
    """Forward mode: (outputs, JVP) (reference
    incubate/autograd/functional.py jvp); tangents default to ones."""
    arrs = [a.detach() for a in _unwrap(xs)]
    tangents = _unwrap(v) if v is not None else \
        [torch.ones_like(a) for a in arrs]
    out, tangent_out = torch.func.jvp(_fn_on_arrays(func), tuple(arrs),
                                      tuple(tangents))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    touts = (tangent_out,) if single else tangent_out
    return _wrap_like(outs, xs), _wrap_like(touts, xs)


def vjp(func, xs, v=None):
    """Reverse mode: (outputs, VJP) (reference vjp); cotangents default
    to ones."""
    arrs = [a.detach() for a in _unwrap(xs)]
    out, vjp_fn = torch.func.vjp(_fn_on_arrays(func), *arrs)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    cotangents = _unwrap(v) if v is not None else \
        [torch.ones_like(o) for o in outs]
    grads = vjp_fn(cotangents[0] if single else tuple(cotangents))
    return _wrap_like(outs, xs), _wrap_like(list(grads), xs)


forward_grad = jvp


def grad(outputs, inputs, grad_outputs=None):
    from ...autograd import grad as _g
    return _g(outputs, inputs, grad_outputs)


class Jacobian:
    """Row/column-sliceable Jacobian (reference
    incubate/autograd/functional.py Jacobian): of the first output with
    respect to the first input where there are several."""

    def __init__(self, func, xs, is_batched=False):
        arrs = [a.detach() for a in _unwrap(xs)]
        jac = torch.func.jacrev(_fn_on_arrays(func),
                                argnums=tuple(range(len(arrs))))(*arrs)
        self._jac = _leaves(jac)[0]
        self._is_batched = is_batched

    def __getitem__(self, idx):
        return Tensor._wrap(self._jac[idx])

    @property
    def shape(self):
        return tuple(self._jac.shape)


class Hessian:
    """The Hessian of a scalar function with respect to its first input
    (reference Hessian)."""

    def __init__(self, func, xs, is_batched=False):
        arrs = [a.detach() for a in _unwrap(xs)]
        h = torch.func.hessian(_fn_on_arrays(func))(*arrs)
        self._h = _leaves(h)[0]
        self._is_batched = is_batched

    def __getitem__(self, idx):
        return Tensor._wrap(self._h[idx])

    @property
    def shape(self):
        return tuple(self._h.shape)


def enable_prim():
    from ...decomposition import enable_prim as ep
    ep(True)


def disable_prim():
    from ...decomposition import enable_prim as ep
    ep(False)


def prim_enabled():
    from ...decomposition import prim_enabled as pe
    return pe()
