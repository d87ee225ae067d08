"""Custom op extension (reference: paddle.utils.cpp_extension — JIT-builds
user C++ ops declared with PD_BUILD_OP, op_meta_info.h:1140, registered
into eager+static).

Port of ``paddle_tpu/utils/cpp_extension.py``, keeping its split:
- device compute is a torch function registered with ``register_op``
  (forward, and optionally backward, on torch tensors, bound through
  ``torch.autograd.Function``); a hand-written CUDA kernel belongs under
  ``paddle_tpu_torch/ops/hopper/`` (built by its ``_build``) and reaches
  the op through its wrapper;
- host-side native code (pre/post-processing, IO) is compiled here with
  ``g++`` and bound through ``ctypes``, pybind11-free, into
  ``utils/_build/<name>/`` unless ``build_directory`` says otherwise.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Callable, Dict, List

import torch

_REGISTRY: Dict[str, "CustomOp"] = {}
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")


class CustomOp:
    def __init__(self, name, forward, backward=None, infer_shape=None,
                 infer_dtype=None):
        self.name = name
        self.forward = forward
        self.backward = backward
        self.infer_shape = infer_shape
        self.infer_dtype = infer_dtype
        self._fn = None if backward is None else self._function()

    def _function(self):
        fwd, bwd = self.forward, self.backward

        class _Op(torch.autograd.Function):
            @staticmethod
            def forward(ctx, attrs, *xs):
                ctx.attrs = attrs
                ctx.save_for_backward(*xs)
                out = fwd(*xs, **attrs)
                return tuple(out) if isinstance(out, list) else out

            @staticmethod
            def backward(ctx, *gs):
                grads = bwd(*ctx.saved_tensors, *gs, **ctx.attrs)
                grads = grads if isinstance(grads, (tuple, list)) \
                    else [grads]
                return (None,) + tuple(grads)

        _Op.__name__ = self.name
        return _Op

    def __call__(self, *tensors, **attrs):
        from ..core.dispatch import run_op
        if self._fn is None:
            return run_op(self.name, lambda *a: self.forward(*a, **attrs),
                          *tensors)
        return run_op(self.name, lambda *a: self._fn.apply(attrs, *a),
                      *tensors)


def register_op(name: str, forward: Callable, backward: Callable = None,
                infer_shape=None, infer_dtype=None) -> CustomOp:
    """PD_BUILD_OP analog: register a custom op (forward / backward on
    torch tensors)."""
    op = CustomOp(name, forward, backward, infer_shape, infer_dtype)
    _REGISTRY[name] = op
    return op


def get_op(name: str) -> CustomOp:
    return _REGISTRY[name]


# ---------------------------------------------------------------------------
# native host-code JIT build (ctypes, no pybind11)
# ---------------------------------------------------------------------------
def load(name: str, sources: List[str], extra_cxx_cflags: List[str] = None,
         extra_ldflags: List[str] = None, build_directory: str = None,
         verbose: bool = False):
    """Compile C/C++ sources into a shared library and return the
    ctypes.CDLL handle (the user declares extern "C" entry points)."""
    build_dir = build_directory or os.path.join(BUILD_DIR, name)
    os.makedirs(build_dir, exist_ok=True)
    key = "".join(open(s).read() for s in sources) + \
        repr(extra_cxx_cflags) + repr(extra_ldflags)
    tag = hashlib.md5(key.encode()).hexdigest()[:12]
    so = os.path.join(build_dir, f"{name}_{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"] + \
            (extra_cxx_cflags or []) + list(sources) + ["-o", tmp] + \
            (extra_ldflags or [])
        if verbose:
            print("[cpp_extension]", " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=not verbose)
        if proc.returncode != 0:
            err = (proc.stderr or b"").decode(errors="replace") \
                if proc.stderr else "(see console output above)"
            raise RuntimeError(
                f"cpp_extension build of '{name}' failed "
                f"(exit {proc.returncode}):\n{err}")
        os.replace(tmp, so)
    return ctypes.CDLL(so)


class CppExtension:
    def __init__(self, sources, name=None, **kwargs):
        self.sources = sources
        self.name = name
        self.kwargs = kwargs


class CUDAExtension(CppExtension):
    def __init__(self, *a, **k):
        raise NotImplementedError(
            "CUDA extensions are not built through cpp_extension here; "
            "write the device kernel under paddle_tpu_torch/ops/hopper/ "
            "(csrc/ built by ops.hopper._build) and register the function "
            "that launches it with register_op()")


def setup(name=None, ext_modules=None, **kwargs):
    """paddle.utils.cpp_extension.setup analog: builds each CppExtension
    immediately (JIT) rather than via setuptools."""
    libs = {}
    exts = ext_modules if isinstance(ext_modules, (list, tuple)) \
        else [ext_modules]
    for i, ext in enumerate(exts):
        ext_name = ext.name or (name if len(exts) == 1
                                else f"{name}_{i}")
        libs[ext_name] = load(ext_name, ext.sources, **ext.kwargs)
    return libs
