"""paddle.utils.dlpack (reference: utils/dlpack.py to_dlpack/from_dlpack
over the C++ DLPack bridge), over ``torch.utils.dlpack``: zero-copy on the
same device."""
from __future__ import annotations

import torch
from torch.utils import dlpack as _tdl

from ..core.tensor import Tensor

__all__ = ["to_dlpack", "from_dlpack"]


def to_dlpack(x):
    """Tensor -> DLPack capsule (a zero-copy view of its buffer)."""
    if not isinstance(x, Tensor):
        raise TypeError(
            f"to_dlpack expects a paddle Tensor, got {type(x)}")
    return _tdl.to_dlpack(x._data.detach())


def from_dlpack(dlpack):
    """A DLPack capsule, or anything with ``__dlpack__`` (a torch tensor, a
    numpy array, another framework's array) -> Tensor, sharing the
    buffer."""
    if not (hasattr(dlpack, "__dlpack__")
            or type(dlpack).__name__ == "PyCapsule"):
        raise TypeError(
            "from_dlpack needs a DLPack capsule or an object implementing "
            "the DLPack protocol (__dlpack__/__dlpack_device__)")
    return Tensor._wrap(torch.from_dlpack(dlpack))
