"""paddle.static.amp on torch: the port of ``paddle_tpu/static/amp.py``
(reference: python/paddle/static/amp — static-graph AMP decoration). The
jit/static path shares the dygraph AMP machinery, so this module re-exports
it."""
from ..amp import (  # noqa: F401
    AmpScaler, GradScaler, auto_cast, decorate,
)

# reference static.amp.decorate signature compatibility
amp_decorate = decorate


class CustomOpLists:
    """reference static/amp/fp16_lists.py AutoMixedPrecisionLists."""

    def __init__(self, custom_white_list=None, custom_black_list=None,
                 custom_black_varnames=None):
        from ..amp import BLACK_LIST, WHITE_LIST
        self.white_list = set(WHITE_LIST) | set(custom_white_list or [])
        self.black_list = set(BLACK_LIST) | set(custom_black_list or [])
        self.black_varnames = set(custom_black_varnames or [])


AutoMixedPrecisionLists = CustomOpLists
