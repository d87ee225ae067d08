"""paddle.incubate.optimizer on the port: the port of
``paddle_tpu/incubate/optimizer/__init__.py`` (reference
incubate/optimizer: the ``LookAhead`` and ``ModelAverage`` wrappers, and
``GradientMergeOptimizer``). Both wrap the port's ``paddle.optimizer``s;
the slow weights and the averages are tensors on the parameters' device,
and they are written into the parameters in place (each stays the same
leaf). Where the inner optimizer keeps float32 master weights
(``multi_precision``), LookAhead's fast weights are the masters and its
sync writes them too: the reference's sync writes the parameters alone,
and the next step recomputes them from the unsynced masters (ROADMAP,
deliberate differences). ModelAverage's ``apply``/``restore`` swap the
parameters only, for evaluation."""
from __future__ import annotations

import torch

from ...optimizer.gradient_merge import GradientMergeOptimizer  # noqa: F401

__all__ = ["LookAhead", "ModelAverage"]


def _write(p, value):
    with torch.no_grad():
        p._data.copy_(value)
    p._version += 1


class LookAhead:
    """reference incubate/optimizer/lookahead.py: the inner optimizer
    steps k times, then the slow weights move ``alpha`` of the way to the
    fast ones and the parameters take them. As in the reference, the slow
    weights start as the fast weights of the first sync."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5, name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = int(k)
        self._step = 0
        self._slow = {}

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def step(self):
        self.inner_optimizer.step()
        self._step += 1
        if self._step % self.k:
            return
        master = getattr(self.inner_optimizer, "_master_weight",
                         lambda p: None)
        with torch.no_grad():
            for p in self.inner_optimizer._parameter_list:
                mw = master(p)
                fast = (mw if mw is not None else p)._data
                slow = self._slow.get(id(p))
                if slow is None:
                    slow = fast.detach()
                slow = slow + self.alpha * (fast - slow)
                self._slow[id(p)] = slow
                if mw is not None:
                    _write(mw, slow)
                _write(p, slow)

    def clear_grad(self, *a, **k):
        self.inner_optimizer.clear_grad(*a, **k)

    def minimize(self, loss):
        loss.backward()
        self.step()
        self.clear_grad()

    def state_dict(self):
        sd = self.inner_optimizer.state_dict()
        sd["lookahead_step"] = self._step
        return sd


class ModelAverage:
    """reference incubate/optimizer/modelaverage.py: a running sum of the
    parameters; ``apply()`` puts their average in and ``restore()`` puts
    the parameters back."""

    def __init__(self, average_window_rate, parameters=None,
                 min_average_window=10000, max_average_window=10000,
                 name=None):
        self._params = list(parameters or [])
        self._rate = average_window_rate
        self._min_w = min_average_window
        self._max_w = max_average_window
        self._sum = {id(p): torch.zeros_like(p._data.detach())
                     for p in self._params}
        self._count = 0
        self._backup = None

    def step(self):
        with torch.no_grad():
            for p in self._params:
                self._sum[id(p)] += p._data
        self._count += 1

    def apply(self, executor=None, need_restore=True):
        if self._count == 0:
            return
        self._backup = {id(p): p._data.detach().clone()
                        for p in self._params}
        for p in self._params:
            _write(p, (self._sum[id(p)] / self._count).to(p._data.dtype))

    def restore(self, executor=None):
        if self._backup is None:
            return
        for p in self._params:
            _write(p, self._backup[id(p)])
        self._backup = None
