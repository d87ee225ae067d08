"""Optimizer base: the port of ``paddle_tpu/optimizer/optimizer.py``
(reference: python/paddle/optimizer/optimizer.py:127).

Design notes for the port:
- the update math is the reference's, in torch ops on each parameter's
  array, run under ``no_grad`` after the backward;
- updates are written IN PLACE: ``_write`` copies the new value into the
  parameter's own torch leaf (and into each accumulator's own tensor). So
  every ``Parameter`` stays the same object and the same leaf, its ``.grad``
  keeps accumulating into that leaf after a step, and no new parameter
  array is allocated a step. This writes into a tensor that autograd saved
  for the backward just run; that graph is freed by then (a graph kept
  with ``retain_graph=True`` is invalidated, as torch's own optimizers
  invalidate it). The reference rebinds new arrays instead;
- ``multi_precision`` keeps float32 master weights and float32
  accumulators for bfloat16/float16 parameters (the reference's
  ``optimizer.py:75-95``): the update is computed from the master weight
  and written to both;
- the learning rate is a Python float refreshed from the schedule at each
  step (the reference keeps a device scalar so that compiled steps need no
  retrace; the port runs eagerly).
Accumulators are keyed by ``id(param)``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from ..autograd import no_grad
from ..core import dtype as dtype_mod
from ..core.tensor import Tensor
from .lr import LRScheduler

_HALF = (torch.bfloat16, torch.float16)


def _in_dtype(x, dtype):
    """The Python float ``x`` rounded to ``dtype``: a constant the reference
    makes an array of the compute dtype (``jnp.asarray(beta1, cdt)``)."""
    return float(torch.tensor(x, dtype=dtype))


def _write(t, value):
    """Writes ``value`` into ``t``'s own array (the same torch tensor, a
    trainable leaf stays that leaf), cast to its dtype."""
    with torch.no_grad():
        t._data.copy_(value)
    t._version += 1


class Optimizer:
    def __init__(self, learning_rate=0.001, parameters=None, weight_decay=None,
                 grad_clip=None, multi_precision=False, name=None):
        if parameters is None:
            raise ValueError(
                "parameters is required in dygraph mode (pass "
                "model.parameters())")
        self._parameter_list = [p for p in parameters]
        self._param_groups = None
        if self._parameter_list and isinstance(self._parameter_list[0], dict):
            self._param_groups = self._parameter_list
            flat = []
            for g in self._param_groups:
                flat.extend(g["params"])
            self._parameter_list = flat
        self._learning_rate = learning_rate
        self._lr = float(learning_rate.get_lr() if isinstance(
            learning_rate, LRScheduler) else learning_rate)
        if isinstance(learning_rate, LRScheduler):
            learning_rate._bind_optimizer(self)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
        self.regularization = weight_decay
        self._weight_decay = weight_decay
        self._accumulators: Dict[str, Dict[int, Tensor]] = defaultdict(dict)
        self._master_weights: Dict[int, Tensor] = {}
        self._global_step = 0

    # ------------------------------------------------------------ lr API
    def set_lr(self, value):
        self._learning_rate = float(value)
        self._lr = float(value)

    def get_lr(self):
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate.get_lr()
        return float(self._learning_rate)

    def _sync_lr(self):
        """Refresh the learning rate from the schedule."""
        self._lr = self.get_lr()

    def _lr_for(self, p):
        mult = getattr(p, "optimize_attr", {}).get("learning_rate", 1.0)
        return self._lr * mult

    # ---------------------------------------------------- accumulators
    def _add_accumulator(self, name, p, fill=0.0, dtype=None,
                         shape=None):
        key = id(p)
        if key not in self._accumulators[name]:
            d = dtype_mod.torch_dtype(dtype) or (
                torch.float32 if self._multi_precision
                and p._data.dtype in _HALF else p._data.dtype)
            shp = tuple(shape) if shape is not None else p._data.shape
            self._accumulators[name][key] = Tensor._wrap(
                torch.full(shp, fill, dtype=d, device=p._data.device))
        return self._accumulators[name][key]

    def _get_accumulator(self, name, p):
        return self._accumulators[name][id(p)]

    def _master_weight(self, p):
        if p._data.dtype not in _HALF or not self._multi_precision:
            return None
        key = id(p)
        if key not in self._master_weights:
            self._master_weights[key] = Tensor._wrap(
                p._data.detach().float())
        return self._master_weights[key]

    # ----------------------------------------------------------- state
    def _state_tensors(self):
        """Every device tensor the optimizer mutates, which a compiled step
        threads through its program (``paddle_tpu_torch.jit``); the
        accumulators and master weights are made first. The learning rate
        is a Python float that a trace bakes in, as the reference's trace
        bakes ``get_lr()`` into its device scalar."""
        self._create_accumulators()
        for p in self._parameter_list:
            self._master_weight(p)
        out = []
        for d in self._accumulators.values():
            out.extend(d.values())
        out.extend(self._master_weights.values())
        return out

    def state_dict(self):
        sd = {}
        for name, d in self._accumulators.items():
            for key, t in d.items():
                sd[f"{name}_{self._key_index(key)}"] = t
        for key, t in self._master_weights.items():
            sd[f"master_{self._key_index(key)}"] = t
        if isinstance(self._learning_rate, LRScheduler):
            sd["LR_Scheduler"] = self._learning_rate.state_dict()
        sd["global_step"] = self._global_step
        return sd

    def _key_index(self, key):
        for i, p in enumerate(self._parameter_list):
            if id(p) == key:
                return i
        return key

    @staticmethod
    def _load(t, v):
        arr = v._data if isinstance(v, Tensor) else \
            dtype_mod.from_numpy(np.asarray(v))
        _write(t, arr.reshape(t._data.shape).to(t._data.device))

    def set_state_dict(self, state_dict):
        for name, d in self._accumulators.items():
            for key in list(d):
                k = f"{name}_{self._key_index(key)}"
                if k in state_dict:
                    self._load(d[key], state_dict[k])
        for key in list(self._master_weights):
            k = f"master_{self._key_index(key)}"
            if k in state_dict:
                self._load(self._master_weights[key], state_dict[k])
        if "LR_Scheduler" in state_dict and isinstance(
                self._learning_rate, LRScheduler):
            self._learning_rate.set_state_dict(state_dict["LR_Scheduler"])
        self._global_step = state_dict.get("global_step", self._global_step)

    # ------------------------------------------------------------ steps
    def _grads(self):
        pg = [(p, p.grad) for p in self._parameter_list
              if not p.stop_gradient and p.grad is not None]
        if self._grad_clip is not None:
            pg = self._grad_clip(pg)
        return pg

    @no_grad()
    def step(self):
        self._create_accumulators()
        self._sync_lr()
        for p, g in self._grads():
            self._append_optimize_op(p, g)
        self._global_step += 1

    def _create_accumulators(self):
        pass

    def _append_optimize_op(self, p, g):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=True):
        for p in self._parameter_list:
            p.clear_grad(set_to_zero=False)

    clear_gradients = clear_grad

    def _apply_update(self, p, new_value):
        """Writes the new value into the parameter's leaf, and into its
        master weight where it has one."""
        mw = self._master_weight(p)
        if mw is not None:
            _write(mw, new_value)
        _write(p, new_value)

    def _param_value(self, p):
        mw = self._master_weight(p)
        return mw._data if mw is not None else p._data.detach()

    def _decayed(self, p, val, g):
        """Weight decay folded into the gradient (reference regularization
        semantics): a float ``c`` adds ``c * param``; a regularizer
        (``paddle.regularizer.L1Decay``/``L2Decay``) adds its own function
        of the parameter. The reference reads a ``_coeff`` its regularizers
        lack, and raises for them."""
        wd = self._weight_decay
        if wd is None:
            return g
        if callable(wd):
            return g + wd(val).to(g.dtype)
        coef = getattr(wd, "_coeff", None)
        coef = float(coef) if coef is not None else float(wd)
        return g + coef * val.to(g.dtype)
