"""paddle.incubate.nn on the port: ``functional`` (masked MHA) only."""
from . import functional  # noqa: F401
