"""paddle.incubate.nn on the port: ``functional`` (the fused functions),
``loss`` and ``FusedLinear``."""
from . import functional  # noqa: F401
from . import loss  # noqa: F401


class FusedLinear:
    """reference incubate/nn FusedLinear: an ``nn.Linear``."""

    def __new__(cls, in_features, out_features, bias_attr=None, **kw):
        from ....nn import Linear
        return Linear(in_features, out_features, bias_attr=bias_attr)
