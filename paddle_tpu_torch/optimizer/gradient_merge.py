"""Gradient merge (k-step gradient accumulation): the port of
``paddle_tpu/optimizer/gradient_merge.py`` (reference: the gradient-merge
distributed pass, distributed/passes/auto_parallel_gradient_merge.py, and
DistributedStrategy's ``gradient_merge`` knob).

``GradientMergeOptimizer`` wraps any Optimizer: step() banks
``param.grad`` into an accumulator for k-1 calls and applies the inner
optimizer on the k-th with the averaged (or summed) gradient. The
reference's compiled form (``ParallelConfig.gradient_merge_steps`` in
gpt_hybrid) is not part of this port.
"""
from __future__ import annotations

from ..core.tensor import Tensor


class GradientMergeOptimizer:
    """Wraps an optimizer so updates happen every `k_steps` calls.

    With avg=True (default, matching the reference pass) the applied
    gradient is the mean over the k banked microbatch gradients, so a
    k-step run reproduces one step on the k-times-larger batch.
    """

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        if k_steps < 1:
            raise ValueError(f"k_steps must be >= 1, got {k_steps}")
        self._inner_opt = inner_optimizer
        self._k_steps = int(k_steps)
        self._avg = bool(avg)
        self._step_count = 0
        self._acc = {}                   # id(param) -> accumulated grad

    # reference GradientMergeOptimizer surface
    @property
    def inner_opt(self):
        return self._inner_opt

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def _params(self):
        return self._inner_opt._parameter_list

    def step(self):
        self._step_count += 1
        boundary = (self._step_count % self._k_steps) == 0
        if self._k_steps == 1:
            return self._inner_opt.step()
        for p in self._params():
            g = getattr(p, "grad", None)
            if g is None:
                continue
            prev = self._acc.get(id(p))
            self._acc[id(p)] = g._data if prev is None else prev + g._data
        if not boundary:
            # bank only: the inner optimizer must not see these grads
            for p in self._params():
                p.grad = None
            return
        scale = float(self._k_steps) if self._avg else 1.0
        for p in self._params():
            acc = self._acc.pop(id(p), None)
            if acc is None:
                continue
            p.grad = Tensor._wrap(acc / scale if scale != 1.0 else acc,
                                  True)
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)
