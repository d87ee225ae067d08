"""paddle.amp.grad_scaler module path: the port of
``paddle_tpu/amp/grad_scaler.py`` (reference:
python/paddle/amp/grad_scaler.py)."""
from enum import Enum

from . import AmpScaler, GradScaler  # noqa: F401


class OptimizerState(Enum):
    INIT = 0
    UNSCALED = 1
    STEPPED = 2
