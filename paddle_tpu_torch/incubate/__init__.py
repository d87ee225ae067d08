"""paddle.incubate on the port. Only ``nn.functional``'s
``masked_multihead_attention`` is here, which the serving slice brings;
the rest of the reference's ``incubate`` waits for a later slice (ROADMAP
queue 1, item 7)."""
from . import nn  # noqa: F401
