"""Eager Tensor: the port of ``paddle_tpu/core/tensor.py``.

The storage is ``_data``, a ``torch.Tensor``, as the reference's is a
``jax.Array``; autograd is torch's own graph on ``_data``:

- ``stop_gradient`` is kept on the handle and, for floating tensors, in
  step with ``_data.requires_grad`` on leaves; setting it on a non-leaf
  detaches ``_data``;
- ``grad`` is the ``.grad`` of the torch leaf that accumulates this
  tensor's gradient (``_leaf``: ``_data`` itself on a leaf, or the leaf it
  was before an inplace op rebound it), wrapped once and written through,
  so that ``t.grad`` is the same handle each time and an inplace op on it
  changes the stored gradient;
- mutation (``inplace:`` ops in ops.yaml) computes out of place and rebinds
  ``_data`` with a version bump (``_assign_array``). No torch tensor that
  autograd saved is ever written, so backward computes what the reference
  computes where a real in-place write would make torch refuse. A trainable
  leaf rebound outside autograd (an optimizer's update) stays a trainable
  leaf and keeps its gradient.

Python control flow on a tensor's value surfaces as a scalarization
(``bool``, ``int``, ``float``, ``item``). These go through the
scalarization interceptor that ``jit`` installs (the reference's seam,
``paddle_tpu/core/tensor.py:28-34``); with none set, or none active, they
read the value as before. While ``jit`` traces a program, a host read of a
value (``numpy``, ``tolist``) raises ``TracedValueError``.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from . import dtype as dtype_mod
from . import place as place_mod
from .place import Place


# Scalarization interceptor (the guard-capture seam, installed by
# paddle_tpu_torch.jit): fn(kind, array) -> (handled, python_value).
_scalarize_interceptor = None
_TRACING = threading.local()


def set_scalarize_interceptor(fn):
    global _scalarize_interceptor
    prev = _scalarize_interceptor
    _scalarize_interceptor = fn
    return prev


def tracing() -> bool:
    """True while this thread traces a compiled program."""
    return getattr(_TRACING, "depth", 0) > 0


class TracedValueError(RuntimeError):
    """A tensor's value was read on the host while a program was traced."""


def _no_host_read(what):
    if tracing():
        raise TracedValueError(
            f"Tensor.{what}() reads a value on the host inside a traced "
            "program")


def _scalarize(kind, arr, plain):
    if _scalarize_interceptor is not None:
        handled, val = _scalarize_interceptor(kind, arr)
        if handled:
            return val
    return plain(arr.detach())


def _trainable(arr) -> bool:
    return arr.is_floating_point() or arr.is_complex()


def _as_torch(data, dt):
    """to_tensor's input as a torch tensor (of dtype ``dt`` when given)."""
    if isinstance(data, torch.Tensor):
        arr = data.detach()
    else:
        if isinstance(data, (float, int, bool, complex, list, tuple,
                             np.generic)):
            data = np.asarray(data)
        if not isinstance(data, np.ndarray):
            raise TypeError(f"cannot make a Tensor of {type(data).__name__}")
        if dt is None and data.dtype == np.float64:
            # as paddle.to_tensor: python floats land as the default dtype
            dt = dtype_mod.get_default_dtype()
        arr = dtype_mod.from_numpy(data)
    if dt is not None and arr.dtype != dt.torch:
        arr = arr.to(dt.torch)
    return arr


class Tensor:
    __slots__ = ("_data", "_sg", "_leaf", "_grad_t", "_grad_of", "name",
                 "persistable", "_version", "__weakref__", "__dict__")

    # make Tensor win over np.ndarray in mixed dunder dispatch
    __array_priority__ = 100

    def __init__(self, data=None, dtype=None, place=None, stop_gradient=True,
                 name=None):
        dt = dtype_mod.convert_dtype(dtype)
        if isinstance(data, Tensor):
            arr = data._data.detach()
            if dt is not None and arr.dtype != dt.torch:
                arr = arr.to(dt.torch)
            dev = arr.device
        elif data is None:
            arr = torch.zeros((), dtype=(dt or
                                         dtype_mod.get_default_dtype()).torch)
            dev = place_mod.default_device()
        else:
            arr = _as_torch(data, dt)
            dev = place_mod.default_device()
        if place is not None:
            dev = place_mod._parse_place(place).torch_device()
        if arr.device != dev:
            arr = arr.to(dev)
        self._init_from_array(arr, stop_gradient, name)

    def _init_from_array(self, arr, stop_gradient=True, name=None):
        self._data = arr
        self._sg = True
        self._leaf = None
        self._grad_t = None
        self._grad_of = None
        self.name = name
        self.persistable = False
        self._version = 0
        if arr.requires_grad:
            if stop_gradient:
                self._data = arr.detach()
            else:
                self._sg = False
                if arr.is_leaf:
                    self._leaf = arr
        elif not stop_gradient:
            self.stop_gradient = False

    @classmethod
    def _wrap(cls, arr, stop_gradient=True) -> "Tensor":
        t = cls.__new__(cls)
        t._init_from_array(arr, stop_gradient)
        return t

    # ------------------------------------------------------------ autograd
    @property
    def stop_gradient(self) -> bool:
        return self._sg

    @stop_gradient.setter
    def stop_gradient(self, value):
        value = bool(value)
        self._sg = value
        a = self._data
        if value:
            if a.requires_grad:
                self._data = a.detach()
                self._leaf = None
        elif not a.requires_grad and _trainable(a):
            a = a.detach().requires_grad_(True)
            self._data = self._leaf = a

    def _grad_holder(self):
        if self._leaf is not None:
            return self._leaf
        a = self._data
        return a if (a.is_leaf or a.retains_grad) else None

    @property
    def grad(self) -> Optional["Tensor"]:
        holder = self._grad_holder()
        g = None if holder is None else holder.grad
        if g is None:
            self._grad_t = None
            return None
        t = self._grad_t
        if t is None or t._data is not g:
            t = Tensor._wrap(g)
            t._grad_of = holder
            self._grad_t = t
        return t

    @grad.setter
    def grad(self, value):
        holder = self._grad_holder()
        if holder is None:
            holder = self._leaf = self._data
        if value is None:
            holder.grad = None
            self._grad_t = None
            return
        if not isinstance(value, Tensor):
            value = Tensor._wrap(torch.as_tensor(value, device=holder.device))
        holder.grad = value._data.detach()
        value._grad_of = holder
        self._grad_t = value

    @property
    def is_leaf(self):
        return self._data.grad_fn is None

    @property
    def grad_fn(self):
        return self._data.grad_fn

    def backward(self, grad_tensor=None, retain_graph=False):
        from ..autograd.tape import run_backward
        run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def register_hook(self, hook):
        """hook(grad Tensor) -> None or a replacement gradient, run when the
        gradient of this tensor is computed (on a leaf: before it is
        accumulated into ``grad``). Returns a handle with ``remove()``."""
        if not self._data.requires_grad:
            raise RuntimeError(
                "cannot register a hook on a tensor that stops gradient")

        def th(g):
            out = hook(Tensor._wrap(g, not g.requires_grad))
            if out is None:
                return None
            return out._data if isinstance(out, Tensor) else out
        return self._data.register_hook(th)

    def _register_grad_hook(self, hook):
        return self.register_hook(hook)

    def _register_backward_hook(self, hook):
        """Post-accumulation hook on a leaf: hook(self) after its gradient
        was accumulated into ``grad``."""
        leaf = self._grad_holder()
        if leaf is None or not leaf.requires_grad:
            raise RuntimeError("post-accumulation hooks need a trainable leaf")
        return leaf.register_post_accumulate_grad_hook(lambda _t: hook(self))

    def clear_grad(self, set_to_zero=False):
        g = self.grad
        if set_to_zero and g is not None:
            self.grad = Tensor._wrap(torch.zeros_like(g._data))
        else:
            self.grad = None

    def clear_gradient(self, set_to_zero=False):
        self.clear_grad(set_to_zero)

    def zero_grad(self):
        self.clear_grad()

    def detach(self) -> "Tensor":
        return Tensor._wrap(self._data.detach())

    def detach_(self) -> "Tensor":
        self.stop_gradient = True
        return self

    def clone(self) -> "Tensor":
        from .dispatch import run_op
        return run_op("clone", torch.clone, self)

    # ------------------------------------------------------------------ meta
    @property
    def shape(self):
        return list(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    dim = property(lambda self: self._data.dim())

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        return dtype_mod.from_torch(self._data.dtype)

    @property
    def place(self) -> Place:
        return place_mod.place_of(self._data.device)

    @property
    def T(self):
        from ..ops import manipulation
        return manipulation.transpose(self, list(range(self.ndim))[::-1])

    @property
    def mT(self):
        from ..ops import manipulation
        perm = list(range(self.ndim))
        perm[-2], perm[-1] = perm[-1], perm[-2]
        return manipulation.transpose(self, perm)

    @property
    def data(self):
        return self

    @data.setter
    def data(self, value):
        self.set_value(value)

    def inplace_version(self):
        return self._version

    # ------------------------------------------------------------- transfer
    def numpy(self) -> np.ndarray:
        """The values as numpy; bfloat16/float8 as float32 (core/dtype.py).
        A distributed array (``distributed.shard_tensor``) gives its global
        value, gathered on every rank."""
        _no_host_read("numpy")
        a = self._data
        if hasattr(a, "full_tensor"):
            a = a.full_tensor()
        return dtype_mod.to_numpy(a)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    def item(self, *args):
        if not args:
            return _scalarize("item", self._data, torch.Tensor.item)
        return self.numpy().item(*args)

    def tolist(self):
        return self.numpy().tolist()

    def to(self, *args, **kwargs):
        """to(dtype) / to(device) / to(device, dtype): a new leaf with this
        tensor's stop_gradient, as in the reference."""
        device = kwargs.get("device")
        dt = kwargs.get("dtype")
        for a in args:
            if isinstance(a, (str, Place, torch.device)):
                try:
                    dt = dtype_mod.convert_dtype(a)
                    continue
                except TypeError:
                    pass
                device = a
            else:
                dt = a
        arr = self._data.detach()
        if dt is not None:
            arr = arr.to(dtype_mod.torch_dtype(dt))
        if device is not None:
            arr = arr.to(place_mod._parse_place(device).torch_device())
        return Tensor._wrap(arr, self.stop_gradient)

    def cpu(self):
        return self.to(device="cpu")

    def cuda(self, device_id=0):
        return self.to(device=f"gpu:{device_id}")

    def pin_memory(self):
        return self

    # ------------------------------------------------------------ mutation
    def _assign_array(self, arr):
        """Inplace rebind (the ``inplace: (x -> out)`` discipline,
        ops.yaml:16). A trainable leaf given a value outside autograd stays
        a trainable leaf and keeps its gradient. A host array lands on this
        tensor's device."""
        if not isinstance(arr, torch.Tensor):
            arr = _as_torch(arr, None).to(self._data.device)
        if not self._sg and not arr.requires_grad and _trainable(arr):
            arr = arr.detach().requires_grad_(True)
            old = self._leaf
            if old is not None and old.grad is not None \
                    and old.grad.shape == arr.shape:
                arr.grad = old.grad.to(arr.dtype)
            self._leaf = arr
        self._data = arr
        self._version += 1
        if self._grad_of is not None:
            self._grad_of.grad = arr
        return self

    def set_value(self, value):
        a = self._data
        if isinstance(value, Tensor):
            v = value._data.detach()
        else:
            v = _as_torch(value, dtype_mod.from_torch(a.dtype))
        if tuple(v.shape) != tuple(a.shape):
            raise ValueError(
                f"set_value shape mismatch: {tuple(v.shape)} vs "
                f"{tuple(a.shape)}")
        return self._assign_array(v.to(device=a.device, dtype=a.dtype))

    def copy_(self, other):
        return self.set_value(other)

    # ------------------------------------------------------------- dunders
    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of a 0-d tensor")
        return self._data.shape[0]

    def __repr__(self):
        from .flags import get_flag
        body = np.array2string(
            self.numpy(),
            precision=get_flag("FLAGS_tensor_print_precision"),
            threshold=get_flag("FLAGS_tensor_print_threshold"),
            separator=", ")
        return (f"Tensor(shape={self.shape}, dtype={self.dtype.name}, "
                f"place={self.place.device_type}, "
                f"stop_gradient={self.stop_gradient},\n       {body})")

    def __bool__(self):
        return _scalarize("bool", self._data, bool)

    def __int__(self):
        return _scalarize("int", self._data, int)

    def __float__(self):
        return _scalarize("float", self._data, float)

    def __index__(self):
        return _scalarize("int", self._data, int)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __format__(self, spec):
        if self.ndim == 0:
            return format(self.item(), spec)
        return str(self)

    def __hash__(self):
        return id(self)

    def __dlpack__(self, *a, **k):
        return self._data.detach().__dlpack__(*a, **k)

    # arithmetic / comparison / indexing dunders are patched in by
    # paddle_tpu_torch.ops (ops/__init__.py: _patch_tensor_methods), so the
    # op layer stays in one place


class Parameter(Tensor):
    """Trainable tensor (reference: base.framework.Parameter)."""

    def __init__(self, data=None, dtype=None, stop_gradient=False,
                 trainable=True, name=None, **kw):
        super().__init__(data, dtype=dtype, stop_gradient=stop_gradient,
                         name=name)
        self._param_attrs(trainable)

    def _param_attrs(self, trainable):
        self.trainable = trainable
        self.persistable = True
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True
        self.is_distributed = False

    @classmethod
    def _wrap_param(cls, arr, trainable=True, name=None):
        p = cls.__new__(cls)
        p._init_from_array(arr, stop_gradient=not trainable, name=name)
        p._param_attrs(trainable)
        return p

    def __repr__(self):
        return "Parameter containing:\n" + super().__repr__()
