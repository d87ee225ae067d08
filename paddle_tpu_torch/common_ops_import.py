"""paddle.common_ops_import (reference re-exports base helpers for op
modules): the port of ``paddle_tpu/common_ops_import.py``."""
from .core.tensor import Tensor  # noqa: F401
from .core.tensor import Tensor as Variable  # noqa: F401
from .core import dtype as core  # noqa: F401
from .framework import in_dynamic_mode  # noqa: F401


def in_dynamic_or_pir_mode():
    return in_dynamic_mode()


def check_type(input, input_name, expected_type, op_name):
    if not isinstance(input, expected_type):
        raise TypeError(
            f"The type of '{input_name}' in {op_name} must be "
            f"{expected_type}, but received {type(input)}.")


def check_variable_and_dtype(input, input_name, expected_dtype, op_name):
    check_type(input, input_name, (Tensor,), op_name)


def check_dtype(input_dtype, input_name, expected_dtype, op_name):
    pass


class LayerHelper:
    """Minimal stand-in for legacy LayerHelper (reference
    base/layer_helper.py) used by code written against the old static
    API; creates eager tensors directly."""

    def __init__(self, layer_type, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs
