"""paddle.base on torch: the port of ``paddle_tpu/base/__init__.py``
(reference: python/paddle/base — the legacy fluid core). Re-exports the
modern equivalents so code doing ``paddle.base.framework`` or
``from paddle.base import Executor`` keeps working; ``base.core`` is the
port of ``paddle_tpu/framework/core.py``."""
from .. import framework  # noqa: F401
from . import core  # noqa: F401
from ..core.place import (  # noqa: F401
    CPUPlace, CUDAPinnedPlace, CUDAPlace, TPUPlace,
)
from ..core.tensor import Tensor  # noqa: F401
from ..nn.layer.layers import ParamAttr  # noqa: F401
from ..static import (  # noqa: F401
    Executor, Program, default_main_program, default_startup_program,
    global_scope, program_guard, scope_guard,
)


def in_dygraph_mode():
    return True


def in_pir_mode():
    return False
