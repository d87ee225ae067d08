"""paddle.incubate on the port: ``nn.functional``'s
``masked_multihead_attention``, which the serving slice brings, and
``jit``'s ``inference`` decorator; the rest of the reference's
``incubate`` waits for a later slice (ROADMAP queue 1)."""
from . import jit  # noqa: F401
from . import nn  # noqa: F401
