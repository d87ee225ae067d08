"""Layer base class: the port of ``paddle_tpu/nn/layer/layers.py``
(reference: python/paddle/nn/layer/layers.py:354 — parameters/buffers/
sublayers registries, hooks, state_dict, train/eval, dtype/device
movement).

``Layer`` is a plain class, as the reference's is, not a
``torch.nn.Module``: its parameters are the port's ``Parameter``s, whose
``_data`` are torch leaves, registered once, here. ``state_dict()`` keys are
the reference's structured names (``gpt.blocks.0.attn.qkv.weight``), so one
dict loads into either package (``set_state_dict`` takes Tensors or numpy
arrays, bfloat16 ones included). ``to``/``astype``/``bfloat16`` cast each
parameter's ``_data`` in place of the old leaf; the result is again a
trainable leaf, with its gradient cast along.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np
import torch

from ...core import dtype as dtype_mod
from ...core.tensor import Parameter, Tensor
from .. import initializer as init_mod


class ParamAttr:
    """paddle.ParamAttr equivalent: per-parameter config."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None or attr is True:
            return ParamAttr()
        if attr is False:
            return None
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, init_mod.Initializer):
            return ParamAttr(initializer=attr)
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        raise TypeError(f"cannot interpret param attr {attr!r}")


class _HookRemoveHelper:
    def __init__(self, hooks, hook_id):
        self._hooks = hooks
        self._id = hook_id

    def remove(self):
        self._hooks.pop(self._id, None)


def _as_array(value, like):
    """A state_dict value (Tensor, numpy array, bfloat16 numpy included) as
    a torch tensor of ``like``'s shape, dtype and device, with storage of its
    own: the optimizers write parameters in place, and a write must not
    reach the dict that was loaded (the reference's arrays are immutable)."""
    if isinstance(value, Tensor):
        arr = value._data.detach().clone()
    else:
        arr = dtype_mod.from_numpy(np.asarray(value))
    return arr.reshape(like.shape).to(device=like.device, dtype=like.dtype)


class Layer:
    def __init__(self, name_scope=None, dtype="float32"):
        self.training = True
        self._dtype = dtype_mod.torch_dtype(dtype)
        self._parameters: Dict[str, Parameter] = collections.OrderedDict()
        self._buffers: Dict[str, Tensor] = collections.OrderedDict()
        self._non_persistable_buffer_names = set()
        self._sub_layers: Dict[str, "Layer"] = collections.OrderedDict()
        self._forward_pre_hooks = collections.OrderedDict()
        self._forward_post_hooks = collections.OrderedDict()
        self._hook_id = 0
        self._name_scope = name_scope or self.__class__.__name__.lower()

    # ----------------------------------------------------------- registry
    def __setattr__(self, name, value):
        params = self.__dict__.get("_parameters")
        if isinstance(value, Parameter):
            if params is None:
                raise RuntimeError("call super().__init__() first")
            self._buffers.pop(name, None)
            self._sub_layers.pop(name, None)
            params[name] = value
            object.__setattr__(self, name, value)
            return
        layers = self.__dict__.get("_sub_layers")
        if isinstance(value, Layer):
            if layers is None:
                raise RuntimeError("call super().__init__() first")
            if params:
                self._parameters.pop(name, None)
            self._buffers.pop(name, None)
            layers[name] = value
            object.__setattr__(self, name, value)
            return
        bufs = self.__dict__.get("_buffers")
        if bufs is not None and name in bufs:
            if isinstance(value, Tensor) or value is None:
                bufs[name] = value
            object.__setattr__(self, name, value)
            return
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # only called when normal lookup fails
        for registry in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                return d[name]
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __delattr__(self, name):
        for registry in ("_parameters", "_buffers", "_sub_layers"):
            d = self.__dict__.get(registry)
            if d is not None and name in d:
                del d[name]
        if name in self.__dict__:
            object.__delattr__(self, name)

    def add_parameter(self, name, parameter):
        setattr(self, name, parameter)
        return parameter

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        object.__setattr__(self, name, sublayer)
        return sublayer

    def register_buffer(self, name, tensor, persistable=True):
        self._buffers[name] = tensor
        if not persistable:
            self._non_persistable_buffer_names.add(name)
        object.__setattr__(self, name, tensor)

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        dt = dtype_mod.torch_dtype(dtype) or self._dtype
        init = attr.initializer or default_initializer or (
            init_mod.Constant(0.0) if is_bias else init_mod._GLOBAL_DEFAULT)
        data = init(tuple(int(s) for s in shape), dt)
        p = Parameter._wrap_param(data, trainable=attr.trainable,
                                  name=attr.name)
        p.optimize_attr["learning_rate"] = attr.learning_rate
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def create_tensor(self, name=None, persistable=None, dtype=None):
        from ...core.place import default_device
        return Tensor._wrap(torch.zeros(
            (), dtype=dtype_mod.torch_dtype(dtype) or self._dtype,
            device=default_device()))

    # --------------------------------------------------------- iteration
    def parameters(self, include_sublayers=True) -> List[Parameter]:
        return [p for _, p in self.named_parameters(
            include_sublayers=include_sublayers)]

    def named_parameters(self, prefix="", include_sublayers=True,
                         include_self=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for pname, p in layer._parameters.items():
                if p is None or id(p) in seen:
                    continue
                seen.add(id(p))
                yield (f"{name}.{pname}" if name else pname), p
            if not include_sublayers:
                break

    def buffers(self, include_sublayers=True):
        return [b for _, b in self.named_buffers(
            include_sublayers=include_sublayers)]

    def named_buffers(self, prefix="", include_sublayers=True):
        seen = set()
        for name, layer in self.named_sublayers(prefix=prefix,
                                                include_self=True):
            for bname, b in layer._buffers.items():
                if b is None or id(b) in seen:
                    continue
                seen.add(id(b))
                yield (f"{name}.{bname}" if name else bname), b
            if not include_sublayers:
                break

    def sublayers(self, include_self=False):
        return [l for _, l in self.named_sublayers(include_self=include_self)]

    def named_sublayers(self, prefix="", include_self=False, layers_set=None):
        if layers_set is None:
            layers_set = set()
        if include_self or prefix == "":
            if id(self) not in layers_set:
                layers_set.add(id(self))
                yield prefix, self
        for name, layer in self._sub_layers.items():
            if layer is None or id(layer) in layers_set:
                continue
            sub_prefix = f"{prefix}.{name}" if prefix else name
            yield from layer.named_sublayers(prefix=sub_prefix,
                                             include_self=True,
                                             layers_set=layers_set)

    def named_children(self):
        yield from self._sub_layers.items()

    def children(self):
        yield from self._sub_layers.values()

    def apply(self, fn):
        for layer in self.sublayers(include_self=True):
            fn(layer)
        return self

    # -------------------------------------------------------------- mode
    def train(self):
        for layer in self.sublayers(include_self=True):
            layer.training = True
        return self

    def eval(self):
        for layer in self.sublayers(include_self=True):
            layer.training = False
        return self

    # ------------------------------------------------------------- hooks
    def register_forward_pre_hook(self, hook):
        self._hook_id += 1
        self._forward_pre_hooks[self._hook_id] = hook
        return _HookRemoveHelper(self._forward_pre_hooks, self._hook_id)

    def register_forward_post_hook(self, hook):
        self._hook_id += 1
        self._forward_post_hooks[self._hook_id] = hook
        return _HookRemoveHelper(self._forward_post_hooks, self._hook_id)

    # -------------------------------------------------------------- call
    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        for hook in self._forward_pre_hooks.values():
            out = hook(self, inputs)
            if out is not None:
                inputs = out if isinstance(out, tuple) else (out,)
        outputs = self.forward(*inputs, **kwargs)
        for hook in self._forward_post_hooks.values():
            out = hook(self, inputs, outputs)
            if out is not None:
                outputs = out
        return outputs

    # -------------------------------------------------------- state dict
    def state_dict(self, destination=None, include_sublayers=True,
                   structured_name_prefix="", use_hook=True):
        dest = destination if destination is not None else \
            collections.OrderedDict()
        for name, p in self.named_parameters():
            dest[structured_name_prefix + name] = p
        for name, b in self.named_buffers():
            # skip non-persistable buffers
            leaf = name.rsplit(".", 1)[-1]
            owner = self
            if "." in name:
                for part in name.split(".")[:-1]:
                    owner = owner._sub_layers.get(part, owner)
            if leaf in getattr(owner, "_non_persistable_buffer_names", ()):
                continue
            dest[structured_name_prefix + name] = b
        return dest

    def set_state_dict(self, state_dict, use_structured_name=True):
        own = self.state_dict()
        missing, unexpected = [], []
        for k, v in state_dict.items():
            if k not in own:
                unexpected.append(k)
                continue
            tgt = own[k]
            tgt._assign_array(_as_array(v, tgt._data))
        for k in own:
            if k not in state_dict:
                missing.append(k)
        return missing, unexpected

    load_dict = set_state_dict
    set_dict = set_state_dict

    # ----------------------------------------------------- dtype/device
    def _transform(self, fn):
        """Rebinds every parameter and buffer to fn(its detached array):
        a trainable parameter becomes a new trainable leaf (_assign_array),
        the same Parameter object."""
        for layer in self.sublayers(include_self=True):
            for t in list(layer._parameters.values()) + \
                    list(layer._buffers.values()):
                if t is not None:
                    t._assign_array(fn(t._data.detach()))
        return self

    def to(self, device=None, dtype=None, blocking=None):
        from ...core.place import _parse_place
        dt = dtype_mod.torch_dtype(dtype)
        dev = None if device is None else \
            _parse_place(device).torch_device()

        def fn(a):
            if dt is not None and a.is_floating_point():
                a = a.to(dt)
            if dev is not None:
                a = a.to(dev)
            return a
        if dt is not None:
            self._dtype = dt
        return self._transform(fn)

    def astype(self, dtype):
        d = dtype_mod.torch_dtype(dtype)
        self._dtype = d
        return self._transform(
            lambda a: a.to(d) if a.is_floating_point() else a)

    def float(self):
        return self.astype("float32")

    def half(self):
        return self.astype("float16")

    def bfloat16(self):
        return self.astype("bfloat16")

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_grad()

    def full_name(self):
        return self._name_scope

    def extra_repr(self):
        return ""

    def __repr__(self):
        extra = self.extra_repr()
        lines = [extra] if extra else []
        for name, layer in self._sub_layers.items():
            rep = repr(layer).split("\n")
            body = "\n  ".join(rep)
            lines.append(f"({name}): {body}")
        main = self.__class__.__name__
        if not lines:
            return f"{main}()"
        return main + "(\n  " + "\n  ".join(lines) + "\n)"


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        vals = list(self._sub_layers.values())
        if isinstance(idx, slice):
            return Sequential(*vals[idx])
        return vals[idx]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, layer in enumerate(sublayers):
                self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        return self._sub_layers[str(idx % len(self) if idx < 0 else idx)]

    def __setitem__(self, idx, layer):
        self.add_sublayer(str(idx), layer)

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self.add_sublayer(str(i), l)

    def extend(self, layers):
        for layer in layers:
            self.append(layer)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                setattr(self, str(i), p)

    def __getitem__(self, idx):
        return self._parameters[str(idx)]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        setattr(self, str(len(self)), parameter)
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def keys(self):
        return self._sub_layers.keys()

    def values(self):
        return self._sub_layers.values()

    def items(self):
        return self._sub_layers.items()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(sublayers, dict) else sublayers
        for k, v in items:
            self[k] = v
