"""What every attention kernel wrapper of this package does around a launch:
refuse the tensors its kernel does not take, lay out outputs as the model's
activations are laid out, load the kernel's library with its C types, and
raise when a launch fails. Nothing here touches the card at import time."""
from __future__ import annotations

import ctypes

import torch

from . import _build

# dtype codes shared with the C entry points: 0 f32, 1 bf16, 2 f16.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128, 256)
TILE_ROWS = 64      # sequence lengths must be multiples of the kernels' tiles

VP, LL, INT, FLOAT = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
STRIDES = ctypes.POINTER(ctypes.c_longlong)


def aligned(t):
    """Unit-stride head dim and 16-byte aligned rows: the kernels' loads."""
    align = 16 // t.element_size()
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 \
        and all(st % align == 0 for st in t.stride()[:-1])


def check(kernel, what, specs):
    """Refuses what the kernels do not take, before any pointer is passed.
    ``specs``: (tensor, shape, dtype) of every tensor of the launch, the
    [B, H, S, D] operands first; an lse is [B, H, S] f32 contiguous."""
    first = specs[0][0]
    for t, shape, dtype in specs:
        if t.device.type != "cuda":
            raise ValueError(f"{kernel} {what}: expected CUDA tensors, got "
                             f"{t.device}")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel} {what}: expected {dtype} "
                             f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{kernel} {what}: tensors on {t.device} and "
                             f"{first.device}")
        if not aligned(t) or (t.dim() == 3 and not t.is_contiguous()):
            raise ValueError(
                f"{kernel} {what}: the head dim must be unit-stride and rows "
                f"16-byte aligned (an lse contiguous), got strides "
                f"{t.stride()}")
    if first.dtype not in DTYPE_CODE:
        raise ValueError(f"{kernel} {what}: dtype {first.dtype} not in "
                         f"{list(DTYPE_CODE)}")
    d = first.shape[-1]
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"{kernel}: head dim {d} has no Hopper kernel yet (built for "
            f"{HEAD_DIMS}; ROADMAP queue 2)")
    for t, _, _ in specs:
        if t.dim() == 4 and t.shape[2] % TILE_ROWS:
            raise ValueError(f"{kernel}: S={t.shape[2]} is not a multiple "
                             f"of {TILE_ROWS}")


def same_layout(kernel, what, tensors):
    """The C entry points that take one layout for several operands."""
    if any(t.stride() != tensors[0].stride() for t in tensors[1:]):
        raise ValueError(f"{kernel} {what}: q, k and v must share one layout")


def strides(t):
    """(batch, head, row) element strides of a [B, H, S, D] view."""
    return t.stride(0), t.stride(1), t.stride(2)


def layouts(*tensors):
    """The (batch, head, row) strides of each tensor as one C array."""
    flat = [st for t in tensors for st in strides(t)]
    return (ctypes.c_longlong * len(flat))(*flat)


def empty_bshd(b, h, s, d, like):
    """[B, H, S, D] view of a fresh [B, S, H, D] buffer: what the model's
    [B, S, H*D] activations reshape to without a copy."""
    return torch.empty(b, s, h, d, dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def empty_lse(b, h, s, like):
    return torch.empty(b, h, s, dtype=torch.float32, device=like.device)


_typed = {}


def library(name, prefix, signatures):
    """The library of ``csrc/<name>.cu``, built at first use, with every
    entry point's C types declared (each returns an int error code) and
    ``<prefix>_error_string`` beside them."""
    lib = _typed.get(name)
    if lib is None:
        lib = _build.library(name)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = INT
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes = [INT]
        err.restype = ctypes.c_char_p
        _typed[name] = lib
    return lib


def launch(lib, prefix, kernel, what, device, fn, *args):
    """Calls entry point ``fn`` on ``device``'s current stream (its last
    argument); raises when the launch failed."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err:
        msg = getattr(lib, f"{prefix}_error_string")(err).decode()
        raise RuntimeError(f"{kernel} {what} kernel failed to launch: {msg} "
                           f"({err})")
