"""paddle.incubate.multiprocessing on the port: the port of
``paddle_tpu/incubate/multiprocessing/__init__.py`` (reference
incubate/multiprocessing: Python's multiprocessing with Tensors that
pickle). A Tensor pickles through ``copyreg`` as a host copy with its
``stop_gradient``, name and device, and comes back on that device: a CUDA
tensor crosses as a host copy (no CUDA IPC)."""
from multiprocessing import *  # noqa: F401,F403
from multiprocessing import Pipe, Process, Queue, get_context  # noqa: F401

import copyreg

import torch

_NO_NUMPY = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def _rebuild_tensor(bits, dtype, stop_gradient, name, device):
    from ...core.tensor import Tensor
    arr = torch.from_numpy(bits).view(getattr(torch, dtype))
    t = Tensor._wrap(arr.to(device))
    t.stop_gradient = stop_gradient
    t.name = name
    return t


def _reduce_tensor(t):
    """The tensor's host copy as numpy bits (a dtype numpy lacks, such as
    bfloat16, as integers of its width), its dtype's name, stop_gradient,
    name and device."""
    arr = t._data.detach().cpu().contiguous()
    bits = arr.view({1: torch.uint8, 2: torch.int16}[arr.element_size()]) \
        if arr.dtype in _NO_NUMPY else arr
    return (_rebuild_tensor, (bits.numpy(), str(arr.dtype).split(".")[-1],
                              t.stop_gradient, getattr(t, "name", None),
                              str(t._data.device)))


def _install():
    from ...core.tensor import Tensor
    copyreg.pickle(Tensor, _reduce_tensor)


_install()
