"""paddle.framework.core: the port of ``paddle_tpu/framework/core.py``
(reference: the pybind ``libpaddle`` module), which the port keeps as
``base/core.py``; this module names the same objects."""
from ..base.core import (  # noqa: F401
    BlockingQueue, CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace,
    Generator, Place, TCPStore, TPUPlace, VarDesc, XPUPlace,
    _get_paddle_place, default_generator, get_cuda_device_count,
    get_flags, is_compiled_with_cuda, is_compiled_with_custom_device,
    is_compiled_with_xpu, set_flags,
)
