"""Tensor-array API: the port of ``paddle_tpu/ops/array.py``
(create_array / array_read / array_write / array_length).

Reference being re-designed: python/paddle/tensor/array.py:43 (length),
:110 (read), :206 (write), :308 (create), the LOD_TENSOR_ARRAY that the
reference's dy2static uses for while-loop-carried list state.

In eager mode the array is a plain Python list of Tensors (the
reference's dynamic mode). ``StaticTensorArray`` is the fixed-capacity
form: a stacked buffer [capacity, *element_shape] plus a length counter,
read and written at tensor indices with tensor ops, so that a traced
program (``jit.to_static``) keeps its reads and writes in the graph. It is
a registered torch pytree, as the reference's is a jax pytree, so it can
be loop state. A plain list still works inside a trace where the index is
a Python int; a tensor index on a list raises while a program is traced,
with a pointer to ``create_array(..., capacity=)``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.utils._pytree as pytree

from ..core import dtype as dtype_mod
from ..core.place import default_device
from ..core.tensor import Tensor, tracing

__all__ = ["create_array", "array_length", "array_read", "array_write",
           "StaticTensorArray"]


class StaticTensorArray:
    """Fixed-capacity tensor array: ``stack`` [capacity, *element_shape]
    + ``length`` (0-D int64, the count of written slots)."""

    def __init__(self, stack, length):
        self._stack = stack      # Tensor [capacity, ...]
        self._length = length    # Tensor 0-D int64

    @property
    def capacity(self):
        return int(self._stack.shape[0])

    def __repr__(self):
        return (f"StaticTensorArray(capacity={self.capacity}, "
                f"element_shape={tuple(self._stack.shape[1:])})")


pytree.register_pytree_node(
    StaticTensorArray,
    lambda a: ((a._stack, a._length), None),
    lambda children, aux: StaticTensorArray(*children))


def _index(i):
    """The reference's contract: i is a 0-D or shape-[1] integer Tensor,
    or a python int. Returns a 0-D torch tensor or an int."""
    if isinstance(i, Tensor):
        return i._data.reshape(())
    return int(i)


def create_array(dtype: Any = "float32",
                 initialized_list: Optional[Sequence] = None,
                 capacity: Optional[int] = None,
                 element_shape: Optional[Sequence[int]] = None):
    """Create a tensor array: a Python list without ``capacity`` (the
    reference's dynamic-mode contract, array.py:308), a
    ``StaticTensorArray`` with it."""
    init = list(initialized_list) if initialized_list is not None else []
    for v in init:
        if not isinstance(v, Tensor):
            raise TypeError(
                "All values in `initialized_list` should be Tensor, "
                f"but received {type(v)}.")
    if capacity is None:
        return init
    if element_shape is None:
        if not init:
            raise ValueError(
                "create_array(capacity=...) needs element_shape when "
                "initialized_list is empty")
        element_shape = tuple(init[0].shape)
    td = dtype_mod.torch_dtype(dtype)
    n = len(init)
    if n > capacity:
        raise ValueError(f"initialized_list ({n}) exceeds capacity "
                         f"({capacity})")
    dev = init[0]._data.device if init else default_device()
    stack = torch.zeros((int(capacity),) + tuple(int(s) for s in
                                                 element_shape),
                        dtype=td, device=dev)
    for j, v in enumerate(init):
        stack[j] = v._data.detach().to(td)
    return StaticTensorArray(
        Tensor._wrap(stack, True),
        Tensor._wrap(torch.tensor(n, dtype=torch.int64, device=dev), True))


def array_length(array):
    """Length of the array as a 0-D int64 Tensor (array.py:43)."""
    if isinstance(array, StaticTensorArray):
        return array._length
    return Tensor._wrap(torch.tensor(len(array), dtype=torch.int64,
                                     device=default_device()), True)


def _list_index(idx, what):
    if isinstance(idx, torch.Tensor):
        if tracing():
            raise TypeError(
                f"array_{what} with a traced index needs a fixed-capacity "
                "array: build it with create_array(dtype, capacity=N, "
                "element_shape=[...]) so that it stays in the program")
        return int(idx)
    return idx


def array_read(array, i):
    """Read the element at position ``i`` (array.py:110)."""
    idx = _index(i)
    if isinstance(array, StaticTensorArray):
        stack = array._stack._data
        if isinstance(idx, int):
            return Tensor._wrap(stack[idx], True)
        return Tensor._wrap(
            stack.index_select(0, idx.reshape(1).long())[0], True)
    return array[_list_index(idx, "read")]


def array_write(x, i, array=None):
    """Write ``x`` at position ``i``; returns the array (array.py:206).
    ``i == length`` appends (list mode grows; static mode advances the
    length counter); writing past the length or the capacity raises where
    the index is known on the host."""
    if not isinstance(x, Tensor):
        x = Tensor(x)
    idx = _index(i)
    if array is None:
        array = []
    if isinstance(array, StaticTensorArray):
        stack = array._stack._data
        length = array._length._data
        if not tracing():
            ii = int(idx)
            if ii >= array.capacity:
                raise IndexError(
                    f"array_write at {ii} exceeds capacity "
                    f"{array.capacity}")
            if ii > int(length):
                raise IndexError(
                    f"array_write index {ii} is greater than the array "
                    f"length {int(length)}")
        it = torch.as_tensor(idx, device=stack.device).reshape(1).long()
        new = stack.index_copy(0, it, x._data.detach().to(stack.dtype)[None])
        new_len = torch.maximum(length, it[0] + 1)
        return StaticTensorArray(Tensor._wrap(new, True),
                                 Tensor._wrap(new_len, True))
    ii = _list_index(idx, "write")
    if ii > len(array):
        raise IndexError(
            f"array_write index {ii} is greater than the array length "
            f"{len(array)}")
    if ii == len(array):
        array.append(x)
    else:
        array[ii] = x
    return array
