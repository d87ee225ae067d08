"""paddle.incubate on the port: ``nn.functional``'s
``masked_multihead_attention`` (the serving slice), ``fused_rms_norm``,
``fused_layer_norm`` and ``swiglu``, ``jit``'s ``inference`` decorator, the
fused softmax-mask ops and the segment ops (``ops.extra``, ``geometric``)
and ``distributed.models.moe`` (the MoE layers and gates); the rest of the
reference's ``incubate`` waits for a later slice (ROADMAP queue 1)."""
from . import distributed  # noqa: F401
from . import jit  # noqa: F401
from . import nn  # noqa: F401
from ..ops.extra import (  # noqa: F401
    fused_softmax_mask as softmax_mask_fuse,
    fused_softmax_mask_upper_triangle as softmax_mask_fuse_upper_triangle,
)
from ..geometric import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_sum,
)
