"""DataParallel: the port of ``paddle_tpu/distributed/parallel.py``
(reference: python/paddle/distributed/parallel.py:219 — the model wrapper
and EagerReducer's bucketed all-reduce, reducer.cc:794).

One process per GPU, each feeding its own rows of the batch: ``forward``
runs the wrapped Layer on this rank's inputs as given (the reference shards
one global batch over its mesh inside one program, which this port does
not have). The reducer groups the trainable parameters, last first (the
order their gradients arrive in a backward), into buckets of
``comm_buffer_size`` MB (the first of ``last_comm_buffer_size`` MB), one
dtype and device a bucket. A hook after each parameter's gradient
accumulation counts the bucket ready; a full bucket is flattened and
all-reduced (AVG over the group) and written back into the gradients. When
the backward ends, buckets that did not fill (parameters this backward did
not reach) are reduced too, their missing gradients as zeros.

Every bucket reduction goes through ``collective.defer_or_run``: under
``no_sync()`` it is recorded and runs once at the context's exit, on the
gradients accumulated by then. Parameters and buffers are broadcast from the
group's first rank at construction.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.tensor import Tensor
from ..nn.layer.layers import Layer
from . import collective as C
from .env import Group, get_rank, get_world_size, init_parallel_env  # noqa: F401

_MB = 1 << 20


def _trainable(params):
    return [p for p in params if not p.stop_gradient]


def _assign_buckets(params, first_bytes, bytes_cap):
    """Lists of parameters, each one dtype and device, closed once they hold
    at least the cap (the first bucket's cap is ``first_bytes``)."""
    buckets, open_ = [], {}
    for p in params:
        key = (p._data.dtype, p._data.device)
        cur = open_.setdefault(key, [[], 0])
        cur[0].append(p)
        cur[1] += p._data.numel() * p._data.element_size()
        cap = first_bytes if not buckets else bytes_cap
        if cur[1] >= cap:
            buckets.append(cur[0])
            del open_[key]
    buckets.extend(c[0] for c in open_.values())
    return buckets


class _Reducer:
    """The bucketed gradient all-reduce of one DataParallel."""

    def __init__(self, params, group, comm_buffer_size, last_comm_buffer_size):
        self._group = group
        order = list(reversed(_trainable(params)))
        self.buckets = _assign_buckets(order, last_comm_buffer_size * _MB,
                                       comm_buffer_size * _MB)
        self._where = {id(p): b for b, bucket in enumerate(self.buckets)
                       for p in bucket}
        self._ready = [0] * len(self.buckets)
        self._done = [False] * len(self.buckets)
        self._in_backward = False
        self.reductions = 0          # bucket all-reduces run
        for p in order:
            p._register_backward_hook(self._mark_ready)

    def _mark_ready(self, p):
        if not self._in_backward:
            self._in_backward = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._finish_backward)
        b = self._where[id(p)]
        self._ready[b] += 1
        if self._ready[b] == len(self.buckets[b]):
            self._launch(b)

    def _launch(self, b):
        self._done[b] = True
        C.defer_or_run(("dp_bucket", id(self), b),
                       lambda: self.reduce_bucket(b))

    def _finish_backward(self):
        for b in range(len(self.buckets)):
            if not self._done[b]:
                self._launch(b)
        self._ready = [0] * len(self.buckets)
        self._done = [False] * len(self.buckets)
        self._in_backward = False

    @torch.no_grad()
    def reduce_bucket(self, b):
        params = self.buckets[b]
        grads = [p.grad for p in params]
        flat = torch.cat([
            g._data.reshape(-1) if g is not None
            else torch.zeros(p._data.numel(), dtype=p._data.dtype,
                             device=p._data.device)
            for p, g in zip(params, grads)])
        C.all_reduce_flat(flat, C.ReduceOp.AVG, self._group)
        off = 0
        for p, g in zip(params, grads):
            n = p._data.numel()
            part = flat[off:off + n].view_as(p._data)
            if g is None:
                p.grad = Tensor._wrap(part.clone())
            else:
                g._data.copy_(part)
            off += n
        self.reductions += 1


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group: Optional[Group] = None):
        super().__init__()
        self._layers = layers
        self._group = group
        self.find_unused_parameters = find_unused_parameters
        self._sync_params_buffers()
        self._reducer = _Reducer(layers.parameters(), group,
                                 comm_buffer_size, last_comm_buffer_size)

    def _sync_params_buffers(self):
        src = self._group.ranks[0] if self._group is not None else 0
        for _, p in self._layers.named_parameters():
            C.broadcast(p, src=src, group=self._group)
        for _, b in self._layers.named_buffers():
            if isinstance(b, Tensor):
                C.broadcast(b, src=src, group=self._group)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The identity: the reducer averages the gradients."""
        return loss

    def no_sync(self):
        """Defer the gradient reduction until the context exits (reference
        DataParallel.no_sync): the buckets that fill inside it, and any
        other gradient-sync collective, are recorded, deduped and run once
        at exit on the accumulated gradients."""
        return C.defer_collectives()

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)
