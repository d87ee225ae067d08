"""Dtype system: the port of ``paddle_tpu/core/dtype.py``.

The reference's dtypes are numpy dtypes, with ``ml_dtypes`` for bfloat16 and
the float8 types. The port's are ``DType`` objects, one per ``torch.dtype``,
that compare equal to the matching ``DType``, ``torch.dtype``, ``np.dtype``
and name string, so that code written against the reference
(``t.dtype == np.dtype(np.int64)``, ``t.dtype == paddle.bfloat16``,
``astype("bfloat16")``) runs unchanged, and nothing here needs ``ml_dtypes``.

Two decisions differ from the reference on purpose:

- the reference stores int64/float64 as int32/float32 while jax's x64 mode
  is off (``jax_dtype``); the port stores the width that was asked for, as
  Paddle does;
- ``to_numpy`` of a bfloat16 or float8 tensor gives float32 (a widening, so
  no value changes), since numpy has no such dtype without ``ml_dtypes``;
  the reference gives an ``ml_dtypes`` array. ``from_numpy`` reads an
  ``ml_dtypes`` array, where one is given, through its bits.
"""
from __future__ import annotations

import numpy as np
import torch


class DType:
    """One dtype of the port: a name and the ``torch.dtype`` that stores it."""

    __slots__ = ("name", "torch")

    def __init__(self, name: str, tdtype: torch.dtype):
        self.name = name
        self.torch = tdtype

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch == other.torch
        try:
            return self is convert_dtype(other)
        except (TypeError, ValueError):
            return False

    def __hash__(self):
        return hash(self.torch)

    def __repr__(self):
        return f"paddle.{self.name}"

    def __str__(self):
        return self.name

    @property
    def dtype(self):
        """The numpy dtype, so that ``np.dtype(d)`` and ``np.dtype == d``
        work; absent for bfloat16 and float8 without ``ml_dtypes``."""
        try:
            return np.dtype(self.name)
        except TypeError:
            pass
        try:
            import ml_dtypes
        except ImportError:
            raise AttributeError(f"numpy has no {self.name} without ml_dtypes")
        return np.dtype(getattr(ml_dtypes, self.name))


bool_ = DType("bool", torch.bool)
uint8 = DType("uint8", torch.uint8)
int8 = DType("int8", torch.int8)
int16 = DType("int16", torch.int16)
int32 = DType("int32", torch.int32)
int64 = DType("int64", torch.int64)
float16 = DType("float16", torch.float16)
bfloat16 = DType("bfloat16", torch.bfloat16)
float32 = DType("float32", torch.float32)
float64 = DType("float64", torch.float64)
complex64 = DType("complex64", torch.complex64)
complex128 = DType("complex128", torch.complex128)
float8_e4m3fn = DType("float8_e4m3fn", torch.float8_e4m3fn)
float8_e5m2 = DType("float8_e5m2", torch.float8_e5m2)

_ALL = (bool_, uint8, int8, int16, int32, int64, float16, bfloat16, float32,
        float64, complex64, complex128, float8_e4m3fn, float8_e5m2)
_BY_TORCH = {d.torch: d for d in _ALL}
_ALIASES = {d.name: d for d in _ALL}
_ALIASES.update({"bf16": bfloat16, "fp16": float16, "fp32": float32,
                 "bool_": bool_})
# dtypes numpy has no type for, read and written through their bits
_BITS = {torch.bfloat16: np.uint16, torch.float8_e4m3fn: np.uint8,
         torch.float8_e5m2: np.uint8}

_DEFAULT_DTYPE = float32


def convert_dtype(dtype):
    """Any dtype spec (DType, torch.dtype, np.dtype, type, name) -> DType."""
    if dtype is None or isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, torch.dtype):
        return _BY_TORCH[dtype]
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
        if key in _ALIASES:
            return _ALIASES[key]
    name = np.dtype(dtype).name
    if name not in _ALIASES:
        raise TypeError(f"paddle_tpu_torch has no dtype {name!r}")
    return _ALIASES[name]


def torch_dtype(dtype):
    """The torch.dtype of a dtype spec; None stays None."""
    return None if dtype is None else convert_dtype(dtype).torch


def from_torch(tdtype) -> DType:
    return _BY_TORCH[tdtype]


def set_default_dtype(dtype):
    global _DEFAULT_DTYPE
    d = convert_dtype(dtype)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(
            "set_default_dtype only supports float16/bfloat16/float32/"
            f"float64, got {d}")
    _DEFAULT_DTYPE = d


def get_default_dtype():
    return _DEFAULT_DTYPE


def is_floating_point(dtype):
    return convert_dtype(dtype).torch.is_floating_point


def is_integer(dtype):
    t = convert_dtype(dtype).torch
    return not (t.is_floating_point or t.is_complex)


def is_complex(dtype):
    return convert_dtype(dtype).torch.is_complex


def promote_types(a, b):
    """Binary dtype promotion (reference: phi/common/type_promotion.h:53),
    torch's lattice, which agrees with jax's for the types both have."""
    return _BY_TORCH[torch.promote_types(torch_dtype(a), torch_dtype(b))]


def finfo(dtype):
    return torch.finfo(torch_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(torch_dtype(dtype))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A torch tensor's values as numpy (bfloat16/float8 as float32)."""
    t = t.detach()
    if t.dtype in _BITS:
        t = t.float()
    return t.cpu().numpy()


def from_numpy(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU torch tensor of the same dtype; an ml_dtypes
    bfloat16/float8 array is read through its bits."""
    name = arr.dtype.name
    if name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        td = _ALIASES[name].torch
        bits = np.ascontiguousarray(arr).view(_BITS[td])
        return torch.from_numpy(bits.copy()).view(td)
    return torch.from_numpy(np.array(arr, copy=True))


def to_bits(t: torch.Tensor):
    """(numpy array, dtype name) that stores t exactly without ml_dtypes:
    bfloat16/float8 as their unsigned-integer bits."""
    t = t.detach().cpu()
    name = _BY_TORCH[t.dtype].name
    if t.dtype in _BITS:
        bits = getattr(torch, np.dtype(_BITS[t.dtype]).name)
        return t.view(bits).numpy(), name
    return t.numpy(), name


def from_bits(arr: np.ndarray, name: str) -> torch.Tensor:
    td = _ALIASES[name].torch
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.view(td) if td in _BITS else t
