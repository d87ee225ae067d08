"""paddle.sysconfig (reference: python/paddle/sysconfig.py).

Port of ``paddle_tpu/sysconfig.py``, which names the TPU package's native
sources. The port's answers are its own (a deliberate difference,
ROADMAP): the headers and sources of its Hopper kernels
(``ops/hopper/csrc``) and of its native library (``native/src``), and the
directories the builds write to."""
import os

_DIR = os.path.dirname(os.path.abspath(__file__))


def get_include():
    """Directory of the Hopper kernels' CUDA headers and sources, to build
    an extension against them (``ops/hopper/csrc``)."""
    return os.path.join(_DIR, "ops", "hopper", "csrc")


def get_include_dirs():
    """Every source directory: the kernels' and the native library's."""
    return [get_include(), os.path.join(_DIR, "native", "src")]


def get_lib():
    """Directory of the built native host library (``native/_build``)."""
    return os.path.join(_DIR, "native", "_build")


def get_lib_dirs():
    """Every build directory: the native library's and the kernels'
    (``ops/hopper/_build``)."""
    return [get_lib(), os.path.join(_DIR, "ops", "hopper", "_build")]


__all__ = ["get_include", "get_lib"]
