"""Activation recomputation: the port of
``paddle_tpu/distributed/fleet/recompute.py`` (reference:
fleet/recompute/recompute.py — RecomputeFunction :124, recompute() :455).

``torch.utils.checkpoint`` (non-reentrant) over the function: the backward
runs it again instead of keeping its activations. The port's generator
state is taken before the forward and put back for the recomputation (then
restored), so a dropout inside draws the same mask both times, as the
reference's replayed key does.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from ...core import generator as gen_mod
from ...core.tensor import Tensor


def _wrap(a):
    return Tensor._wrap(a, stop_gradient=not a.requires_grad)


def recompute(function, *args, **kwargs):
    """recompute(fn_or_layer, *args) — the gradients recompute the forward
    instead of storing its activations."""
    kwargs.pop("use_reentrant", None)
    preserve_rng_state = kwargs.pop("preserve_rng_state", True)
    spec = [isinstance(a, Tensor) for a in args]
    arrays = [a._data for a, t in zip(args, spec) if t]
    gen = gen_mod.default_generator()
    state = gen.get_state() if preserve_rng_state else None
    calls = [0]

    def run(*arrs):
        it = iter(arrs)
        call_args = [_wrap(next(it)) if t else a for a, t in zip(args, spec)]
        calls[0] += 1
        if calls[0] == 1 or state is None:
            out = function(*call_args, **kwargs)
        else:
            saved = gen.get_state()
            gen.set_state(state)
            try:
                out = function(*call_args, **kwargs)
            finally:
                gen.set_state(saved)
        if isinstance(out, Tensor):
            return out._data
        return tuple(o._data if isinstance(o, Tensor) else o for o in out)

    out = checkpoint(run, *arrays, use_reentrant=False,
                     preserve_rng_state=preserve_rng_state)
    if isinstance(out, tuple):
        return tuple(_wrap(o) if hasattr(o, "requires_grad") else o
                     for o in out)
    return _wrap(out)


def recompute_sequential(ctx, functions, *args):
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    fns = list(functions)
    seg = max(1, len(fns) // max(segments, 1))
    out = args
    i = 0
    while i < len(fns):
        chunk = fns[i:i + seg]

        def seg_fn(*xs, _chunk=chunk):
            y = xs
            for f_ in _chunk:
                y = f_(*y) if isinstance(y, tuple) else f_(y)
                if not isinstance(y, tuple):
                    y = (y,)
            return y[0] if len(y) == 1 else y
        out = recompute(seg_fn, *(out if isinstance(out, tuple) else (out,)))
        if not isinstance(out, tuple):
            out = (out,)
        i += seg
    return out[0] if isinstance(out, tuple) and len(out) == 1 else out
