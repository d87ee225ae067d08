"""paddle.base.core: the port of ``paddle_tpu/framework/core.py``
(reference: the pybind ``libpaddle`` module, fluid/pybind/pybind.cc): the
places, the flags, the RNG generator, the native ``TCPStore`` and
``BlockingQueue``, ``VarDesc``.

``is_compiled_with_cuda``, ``is_compiled_with_custom_device`` and
``get_cuda_device_count`` answer for this build and this machine, as the
port's ``device`` module does, where the reference answers with the TPU's
constants (ROADMAP, deliberate differences)."""
from __future__ import annotations

from .. import device as _device
from ..core.flags import get_flags, set_flags  # noqa: F401
from ..core.generator import Generator, default_generator  # noqa: F401
from ..core.place import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, Place, TPUPlace,
    XPUPlace,
)
from ..native import BlockingQueue, TCPStore  # noqa: F401


def is_compiled_with_cuda():
    return _device.is_compiled_with_cuda()


def is_compiled_with_xpu():
    return False


def is_compiled_with_custom_device(name="tpu"):
    return _device.is_compiled_with_custom_device(name)


def get_cuda_device_count():
    return _device.device_count("gpu")


def _get_paddle_place(place):
    return place


class VarDesc:
    class VarType:
        FP32 = "float32"
        FP16 = "float16"
        BF16 = "bfloat16"
        FP64 = "float64"
        INT32 = "int32"
        INT64 = "int64"
        BOOL = "bool"
        UINT8 = "uint8"
        INT8 = "int8"
