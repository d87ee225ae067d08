"""paddle.optimizer: the port of ``paddle_tpu/optimizer``."""
from . import lr  # noqa: F401
from .optimizer import Optimizer  # noqa: F401
from .optimizers import (  # noqa: F401
    SGD, ASGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, LBFGS,
    Momentum, NAdam, RAdam, RMSProp, Rprop,
)
from .gradient_merge import GradientMergeOptimizer  # noqa: F401
