"""StringTensor + string kernels: the port of
``paddle_tpu/core/string_tensor.py``, unchanged in substance (numpy only).

Reference being reproduced: phi::StringTensor
(paddle/phi/core/string_tensor.h) — a TensorBase-family
tensor of `pstring` values with its own kernel taxonomy
(paddle/phi/kernels/strings/: empty, copy, lower/upper
with unicode case tables) — plus the utf-8 machinery in
kernels/strings/unicode.h.

Design: string data is a HOST tensor stage whose job is to feed
tokenization into integer arrays that go to the device (the reference's
GPU string kernels exist for the same boundary role); only the ids reach
the card. Storage is a numpy object array of python str — python
str IS a correct unicode sequence, so case mapping delegates to the
language runtime instead of hand-rolled code-point tables.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


class StringTensor:
    """Host tensor of unicode strings (phi::StringTensor analog)."""

    def __init__(self, data=None, dims: Sequence[int] = None,
                 name: str = None):
        if data is None:
            shape = tuple(dims or (0,))
            self._data = np.full(shape, "", dtype=object)
        else:
            arr = np.array(data, dtype=object)
            if dims is not None:
                arr = arr.reshape(tuple(dims))
            self._data = arr
        self.name = name

    # ---- TensorBase-surface parity ----------------------------------
    @property
    def shape(self) -> List[int]:
        return list(self._data.shape)

    @property
    def dims(self) -> List[int]:
        return self.shape

    def numel(self) -> int:
        return int(self._data.size)

    @property
    def dtype(self) -> str:
        return "pstring"

    @property
    def place(self) -> str:
        return "cpu"          # strings are host-resident by design

    def numpy(self) -> np.ndarray:
        return self._data

    def tolist(self):
        return self._data.tolist()

    def __getitem__(self, idx):
        out = self._data[idx]
        if isinstance(out, np.ndarray):
            return StringTensor(out)
        return out

    def __len__(self):
        if self._data.ndim == 0:
            raise TypeError("len() of a 0-d StringTensor")
        return self._data.shape[0]

    def __repr__(self):
        return (f"StringTensor(shape={self.shape}, "
                f"{np.array2string(self._data, threshold=8)})")

    def __eq__(self, other):
        if isinstance(other, StringTensor):
            return bool((self._data == other._data).all())
        return NotImplemented

    def copy_(self, src: "StringTensor"):
        """strings_copy kernel."""
        self._data = src._data.copy()
        return self


# ---- the strings_* kernel surface -----------------------------------

def strings_empty(shape: Sequence[int]) -> StringTensor:
    """strings_empty_kernel: an empty-string tensor of `shape`."""
    return StringTensor(dims=shape)


def _map(fn, x: StringTensor) -> StringTensor:
    out = np.empty(x._data.shape, dtype=object)
    flat_in = x._data.reshape(-1)
    flat_out = out.reshape(-1)
    for i, s in enumerate(flat_in):
        flat_out[i] = fn(s)
    return StringTensor(out)


def strings_lower(x: StringTensor, use_utf8_encoding: bool = True
                  ) -> StringTensor:
    """strings_lower_upper_kernel (lower). use_utf8_encoding=False
    restricts to ASCII case mapping (the reference's non-utf8 path)."""
    if use_utf8_encoding:
        return _map(str.lower, x)
    return _map(lambda s: "".join(
        c.lower() if c.isascii() else c for c in s), x)


def strings_upper(x: StringTensor, use_utf8_encoding: bool = True
                  ) -> StringTensor:
    if use_utf8_encoding:
        return _map(str.upper, x)
    return _map(lambda s: "".join(
        c.upper() if c.isascii() else c for c in s), x)
