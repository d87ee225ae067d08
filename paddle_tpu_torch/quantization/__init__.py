"""paddle.quantization (reference: python/paddle/quantization — the
QuantConfig / quanter-factory / QAT / PTQ framework: config.py QuantConfig
with per-layer/name/type priority resolution, quanters/abs_max.py
factories, qat.py + ptq.py flows, quantize.py convert).

Port of ``paddle_tpu/quantization/__init__.py``. Fake quantization
(quantize-dequantize) is one elementwise torch expression with a
straight-through gradient. Two differences from the reference, both for
low-precision inputs and both logged in ROADMAP:

- ``quantize_dequantize`` computes in float32 and returns the input's
  dtype. The reference computes ``a / s`` in the promoted dtype and returns
  it, so a bfloat16 activation with a float32 scale comes back float32 and
  the rest of a bfloat16 model is promoted with it;
- ``FakeQuanterWithAbsMax``'s scale buffer stays float32 (the reference
  rebinds it to the activation's dtype on the first batch).

At float32 both are the reference's numbers. Observers and ``PTQ.convert``
take their abs-max on the tensor's device and read one scalar.
"""
from __future__ import annotations

import copy
import warnings
from typing import Dict, Optional, Type

import torch

from .. import nn
from ..core import place as place_mod
from ..core.dispatch import run_op
from ..core.tensor import Tensor
from ..nn import functional as F


def _qmax(bit_length):
    return 2 ** (bit_length - 1) - 1


def quantize_dequantize(x, scale, zero_point=0.0, bit_length=8,
                        channel_axis=None):
    """Fake-quant with STE gradient; scale may be scalar or per-channel
    (broadcast along channel_axis): round half to even, clip, then
    ``a + (deq - a).detach()``."""
    qmin, qmax = -(2 ** (bit_length - 1)), _qmax(bit_length)

    def f(a, s):
        if channel_axis is not None and s.ndim == 1:
            shape = [1] * a.ndim
            shape[channel_axis] = -1
            s = s.reshape(shape)
        a32 = a.float()
        s = torch.clamp_min(s.float(), 1e-8)
        q = torch.clamp(torch.round(a32 / s), qmin, qmax)
        deq = q * s
        # straight-through: gradient flows as identity within range
        return (a32 + (deq - a32).detach()).to(a.dtype)
    return run_op("fake_quant", f, x, scale)


def _absmax(x):
    """A Tensor's abs-max, taken on its device, read as one float."""
    return float(x._data.detach().abs().max())


# ---------------------------------------------------------------------
# Observers (reference quantization/observers)
# ---------------------------------------------------------------------
class BaseObserver:
    def observe(self, x: Tensor):
        raise NotImplementedError

    def scale(self):
        raise NotImplementedError


class AbsmaxObserver(BaseObserver):
    """Running abs-max (reference observers/abs_max.py)."""

    def __init__(self, bit_length=8):
        self.bit_length = bit_length
        self._absmax = 0.0

    def observe(self, x: Tensor):
        self._absmax = max(self._absmax, _absmax(x))

    def scale(self):
        return self._absmax / _qmax(self.bit_length) if self._absmax \
            else 1.0


class EMAObserver(BaseObserver):
    """Exponential-moving-average abs-max (smoother PTQ scales)."""

    def __init__(self, bit_length=8, moving_rate=0.9):
        self.bit_length = bit_length
        self.moving_rate = moving_rate
        self._val = None

    def observe(self, x: Tensor):
        cur = _absmax(x)
        self._val = cur if self._val is None else \
            self.moving_rate * self._val + (1 - self.moving_rate) * cur

    def scale(self):
        return (self._val or 1.0) / _qmax(self.bit_length)


class GroupWiseWeightObserver(BaseObserver):
    """Per-output-channel abs-max for weights (reference
    observers/groupwise.py, group_size=1 per channel)."""

    def __init__(self, bit_length=8, channel_axis=-1):
        self.bit_length = bit_length
        self.channel_axis = channel_axis
        self._scales = None

    def observe(self, w: Tensor):
        a = w._data.detach().abs().float()
        ax = self.channel_axis % a.ndim
        red = tuple(i for i in range(a.ndim) if i != ax)
        self._scales = (a.amax(dim=red) / _qmax(self.bit_length)) \
            .cpu().numpy()

    def scale(self):
        return self._scales


# ---------------------------------------------------------------------
# Quanters (reference quantization/quanters) + factory pattern
# ---------------------------------------------------------------------
class QuanterFactory:
    """Partial application of a quanter class (reference factory.py
    quanter(...)): config stores factories, instantiation happens once per
    wrapped layer."""

    def __init__(self, cls, **kwargs):
        self.cls = cls
        self.kwargs = kwargs

    def _instance(self):
        return self.cls(**self.kwargs)

    def __call__(self):
        return self._instance()


class FakeQuanterWithAbsMax(nn.Layer):
    """QAT activation quanter: learns a running abs-max scale (reference
    quanters/abs_max.py FakeQuanterWithAbsMaxObserver). The first batch
    sets the scale; later batches move it by EMA."""

    def __init__(self, bit_length=8, moving_rate=0.9):
        super().__init__()
        self.bit_length = bit_length
        self.moving_rate = moving_rate
        self.register_buffer("_scale", Tensor._wrap(torch.ones(
            [1], device=place_mod.default_device())))
        self._seen = False

    def forward(self, x):
        if self.training:
            with torch.no_grad():
                cur = x._data.detach().abs().max().float() \
                    / _qmax(self.bit_length)
                s = self._scale._data
                if not self._seen:
                    new_scale = cur       # direct init on first batch
                    self._seen = True
                else:
                    new_scale = self.moving_rate * s \
                        + (1 - self.moving_rate) * cur
                self._scale._assign_array(
                    new_scale.reshape(1).to(s.dtype))
        return quantize_dequantize(x, self._scale, 0.0, self.bit_length)


class FakeQuanterChannelWiseAbsMax(nn.Layer):
    """Per-output-channel weight quanter (reference channel-wise abs-max
    weight quantization)."""

    def __init__(self, bit_length=8, channel_axis=-1):
        super().__init__()
        self.bit_length = bit_length
        self.channel_axis = channel_axis

    def forward(self, w):
        ax = self.channel_axis % w.ndim
        red = [i for i in range(w.ndim) if i != ax]
        scale = Tensor._wrap(w._data.detach().abs().amax(dim=red)
                             / _qmax(self.bit_length))
        return quantize_dequantize(w, scale, 0.0, self.bit_length,
                                   channel_axis=ax)


# ---------------------------------------------------------------------
# Quanted layer wrappers (reference nn.qat.*)
# ---------------------------------------------------------------------
class QuantedLinear(nn.Layer):
    def __init__(self, linear: nn.Linear, bit_length=8,
                 act_quanter=None, weight_quanter=None):
        super().__init__()
        self.inner = linear
        self.act_quanter = act_quanter or FakeQuanterWithAbsMax(bit_length)
        self.weight_quanter = weight_quanter or \
            FakeQuanterWithAbsMax(bit_length)

    def forward(self, x):
        xq = self.act_quanter(x)
        wq = self.weight_quanter(self.inner.weight)
        return F.linear(xq, wq, self.inner.bias)


class QuantedConv2D(nn.Layer):
    def __init__(self, conv, bit_length=8, act_quanter=None,
                 weight_quanter=None):
        super().__init__()
        self.inner = conv
        self.act_quanter = act_quanter or FakeQuanterWithAbsMax(bit_length)
        self.weight_quanter = weight_quanter or \
            FakeQuanterWithAbsMax(bit_length)

    def forward(self, x):
        xq = self.act_quanter(x)
        wq = self.weight_quanter(self.inner.weight)
        c = self.inner
        return F.conv2d(xq, wq, c.bias, stride=c._stride,
                        padding=c._padding, dilation=c._dilation,
                        groups=c._groups, data_format=c._data_format)


_DEFAULT_QAT_MAPPING = {nn.Linear: QuantedLinear,
                        nn.Conv2D: QuantedConv2D}


# ---------------------------------------------------------------------
# QuantConfig with the reference's priority resolution
# ---------------------------------------------------------------------
class SingleLayerConfig:
    def __init__(self, activation=None, weight=None, bit_length=8):
        self.activation = activation
        self.weight = weight
        self.bit_length = bit_length


class QuantConfig:
    """Where and how to quantize (reference config.py QuantConfig):
    priority layer-instance > layer-name > layer-type > global default.
    activation/weight take QuanterFactory (or any zero-arg callable
    returning a quanter layer)."""

    def __init__(self, activation=None, weight=None, bit_length=8):
        self.default = SingleLayerConfig(activation, weight, bit_length)
        self._by_layer: Dict[int, SingleLayerConfig] = {}
        self._by_name: Dict[str, SingleLayerConfig] = {}
        self._by_type: Dict[type, SingleLayerConfig] = {}
        self.qat_mapping = dict(_DEFAULT_QAT_MAPPING)
        self._types = tuple(self.qat_mapping)   # back-compat surface

    def add_layer_config(self, layer, activation=None, weight=None,
                         bit_length=8):
        layers = layer if isinstance(layer, (list, tuple)) else [layer]
        for l in layers:
            self._by_layer[id(l)] = SingleLayerConfig(
                activation, weight, bit_length)

    def add_name_config(self, layer_name, activation=None, weight=None,
                        bit_length=8):
        names = layer_name if isinstance(layer_name, (list, tuple)) \
            else [layer_name]
        for n in names:
            self._by_name[n] = SingleLayerConfig(activation, weight,
                                                 bit_length)

    def add_type_config(self, layer_type, activation=None, weight=None,
                        bit_length=8):
        types = layer_type if isinstance(layer_type, (list, tuple)) \
            else [layer_type]
        for t in types:
            self._by_type[t] = SingleLayerConfig(activation, weight,
                                                 bit_length)
        self._types = tuple(set(self._types) | set(types))

    def add_qat_layer_mapping(self, source: Type[nn.Layer],
                              target: Type[nn.Layer]):
        """Custom quanted wrapper for a layer type (reference
        add_qat_layer_mapping)."""
        self.qat_mapping[source] = target

    # -- resolution ----------------------------------------------------
    def _config_for(self, layer, full_name) -> Optional[SingleLayerConfig]:
        if id(layer) in self._by_layer:
            return self._by_layer[id(layer)]
        if full_name in self._by_name:
            return self._by_name[full_name]
        matches = [t for t in self._by_type if isinstance(layer, t)]
        if matches:
            # most-derived type wins (a subclass config must beat its
            # base class regardless of registration order)
            best = max(matches, key=lambda t: len(t.__mro__))
            return self._by_type[best]
        if isinstance(layer, tuple(self.qat_mapping)) and (
                self.default.activation or self.default.weight
                or not (self._by_layer or self._by_name
                        or self._by_type)):
            return self.default
        return None

    def _make_quanted(self, child, cfg: SingleLayerConfig):
        matches = [t for t in self.qat_mapping if isinstance(child, t)]
        if not matches:
            return None
        wrapper = self.qat_mapping[
            max(matches, key=lambda t: len(t.__mro__))]
        return wrapper(
            child, cfg.bit_length,
            act_quanter=cfg.activation() if callable(cfg.activation)
            else None,
            weight_quanter=cfg.weight() if callable(cfg.weight)
            else None)


def _maybe_copy(model, inplace):
    return model if inplace else copy.deepcopy(model)


def _warn_if_root_quantizable(model, config):
    """Wrapping happens by swapping a child on its parent; the ROOT layer
    has no parent, so a bare quantizable model cannot be wrapped — tell the
    user instead of silently no-opping."""
    if config._config_for(model, "") is not None:
        warnings.warn(
            f"the model itself is a quantizable {type(model).__name__}; "
            "the root layer cannot be swapped in place — wrap it in a "
            "container (e.g. nn.Sequential(model)) to quantize it",
            stacklevel=3)


# ---------------------------------------------------------------------
# QAT / PTQ flows (reference qat.py / ptq.py)
# ---------------------------------------------------------------------
class QAT:
    """Quantization-aware training: walk the model, wrap every layer the
    config resolves, honoring the qat layer mapping."""

    def __init__(self, config: QuantConfig):
        self.config = config

    def quantize(self, model: nn.Layer, inplace=False):
        model = _maybe_copy(model, inplace)
        _warn_if_root_quantizable(model, self.config)
        quanted_types = tuple(self.config.qat_mapping.values())
        for name, layer in list(model.named_sublayers(include_self=True)):
            for cname, child in list(layer._sub_layers.items()):
                if isinstance(child, quanted_types):
                    continue
                full = f"{name}.{cname}" if name else cname
                cfg = self.config._config_for(child, full)
                if cfg is None:
                    continue
                q = self.config._make_quanted(child, cfg)
                if q is not None:
                    layer.add_sublayer(cname, q)
        return model

    def convert(self, model: nn.Layer, inplace=False):
        """Freeze a trained QAT model for inference: quanters stop updating
        and keep their learned scales (reference quantize.py convert)."""
        model = _maybe_copy(model, inplace)
        model.eval()
        return model


class PTQ:
    """Post-training quantization: observe activations, then freeze."""

    observer_cls = AbsmaxObserver

    def __init__(self, config: QuantConfig = None):
        self.config = config or QuantConfig()
        self._observers = {}

    def quantize(self, model: nn.Layer, inplace=False):
        model = _maybe_copy(model, inplace)
        _warn_if_root_quantizable(model, self.config)
        self._hooks = []
        for name, layer in model.named_sublayers(include_self=True):
            for cname, child in list(layer._sub_layers.items()):
                full = f"{name}.{cname}" if name else cname
                cfg = self.config._config_for(child, full)
                if cfg is None:
                    continue
                obs = self.observer_cls(cfg.bit_length)
                self._observers[id(child)] = obs

                def hook(l, inputs, _obs=obs):
                    _obs.observe(inputs[0])
                self._hooks.append(
                    child.register_forward_pre_hook(hook))
        return model

    def convert(self, model: nn.Layer, inplace=False):
        # convert must run on the same instance that was observed
        # (observers are keyed by layer identity); inplace=False returns
        # a converted deep copy while leaving `model` un-quantized.
        for h in getattr(self, "_hooks", []):
            h.remove()
        target = _maybe_copy(model, inplace)
        src_layers = dict(model.named_sublayers(include_self=True))
        for name, layer in list(target.named_sublayers(include_self=True)):
            for cname, child in list(layer._sub_layers.items()):
                src_parent = src_layers.get(name)
                src_child = src_parent._sub_layers.get(cname) \
                    if src_parent is not None else None
                obs = self._observers.get(id(src_child))
                if obs is None:
                    continue
                full = f"{name}.{cname}" if name else cname
                cfg = self.config._config_for(child, full) or \
                    self.config.default
                qmax = _qmax(cfg.bit_length)
                q = self.config._make_quanted(child, cfg)
                if q is None:
                    continue
                if hasattr(q.act_quanter, "_scale"):
                    q.act_quanter._scale._assign_array(torch.tensor(
                        [obs.scale()], dtype=torch.float32,
                        device=q.act_quanter._scale._data.device))
                if hasattr(q.weight_quanter, "_scale"):
                    # the weight's abs-max, taken on its device
                    wmax = _absmax(child.weight)
                    q.weight_quanter._scale._assign_array(torch.tensor(
                        [wmax / qmax], dtype=torch.float32,
                        device=q.weight_quanter._scale._data.device))
                q.eval()
                layer.add_sublayer(cname, q)
        return target


def quanter(cls=None, **kwargs):
    """Factory decorator/constructor (reference factory.quanter):
    quanter(FakeQuanterWithAbsMax, bit_length=4) -> QuanterFactory."""
    if cls is None:
        def deco(c):
            return QuanterFactory(c, **kwargs)
        return deco
    return QuanterFactory(cls, **kwargs)
