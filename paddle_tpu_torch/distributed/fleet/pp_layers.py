"""Pipeline-parallel layer descriptors: the port of
``paddle_tpu/distributed/fleet/pp_layers.py`` (reference: PipelineLayer,
fleet/meta_parallel/parallel_layers/pp_layers.py:257, LayerDesc :56,
SharedLayerDesc :76).

Every rank builds the whole layer chain: ``forward`` runs it all (the
eval and forward-only path on any rank), and the segmentation
(``get_stage_from_index``) says which stage each entry belongs to. Fleet's
``PipelineParallel`` trains it as pipeline stages, a rank each
(``meta_parallel.py``, over ``auto_parallel.partitioner``).
"""
from __future__ import annotations

import math
import re
from typing import Callable, List, Optional, Union

from ...nn.layer.layers import Layer, LayerList


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not issubclass(layer_cls, Layer):
            raise TypeError("LayerDesc expects a Layer subclass")

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """Weight shared across stages (e.g. embedding/output head,
    reference pp_layers.py:76)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform",
                 recompute_interval=0, recompute_ctx=None,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._layer_descs = list(layers)
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._seg_method = seg_method
        self._recompute_interval = recompute_interval
        self._shared = {}
        self.run_function = LayerList()
        self._build_all()
        self._stage_bounds = self._segment(len(self.run_function),
                                           self._num_stages)

    def _build_all(self):
        for i, desc in enumerate(self._layer_descs):
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name in self._shared:
                    layer = self._shared[desc.layer_name]
                else:
                    layer = desc.build_layer()
                    self._shared[desc.layer_name] = layer
                fwd = desc.forward_func
                if fwd is not None:
                    layer = _FnWrap(layer, fwd)
                self.run_function.append(layer)
            elif isinstance(desc, LayerDesc):
                self.run_function.append(desc.build_layer())
            elif isinstance(desc, Layer):
                self.run_function.append(desc)
            elif callable(desc):
                self.run_function.append(_Lambda(desc))
            else:
                raise TypeError(f"bad pipeline entry {desc!r}")

    @staticmethod
    def _segment(n, stages):
        per = [n // stages + (1 if i < n % stages else 0)
               for i in range(stages)]
        bounds = [0]
        for p in per:
            bounds.append(bounds[-1] + p)
        return bounds

    def get_stage_from_index(self, idx):
        for s in range(self._num_stages):
            if self._stage_bounds[s] <= idx < self._stage_bounds[s + 1]:
                return s
        return self._num_stages - 1

    def build_pipeline(self, hcg):
        """Keeps the hybrid group (the pp group its stages run over)."""
        self._hcg = hcg
        return self

    def forward(self, x, **kwargs):
        from .recompute import recompute
        out = x
        for i, layer in enumerate(self.run_function):
            if self._recompute_interval > 0 and \
                    i % self._recompute_interval == 0 and self.training:
                out = recompute(layer, *(out if isinstance(out, tuple)
                                         else (out,)))
            else:
                out = layer(*(out if isinstance(out, tuple) else (out,)))
        return out

    def loss(self, output, label):
        if self._loss_fn is None:
            raise RuntimeError("no loss_fn configured")
        return self._loss_fn(output, label)


class _Lambda(Layer):
    def __init__(self, fn):
        super().__init__()
        self._fn = fn

    def forward(self, *args):
        return self._fn(*args)


class _FnWrap(Layer):
    def __init__(self, layer, fn):
        super().__init__()
        self.inner = layer
        self._fn = fn

    def forward(self, *args):
        return self._fn(self.inner, *args)
