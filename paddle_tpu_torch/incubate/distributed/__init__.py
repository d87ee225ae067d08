"""paddle.incubate.distributed on the port: the MoE models namespace."""
from . import models  # noqa: F401
