"""paddle.incubate.distributed.models.moe: the port of
``paddle_tpu/incubate/distributed/models/moe`` (reference:
incubate/distributed/models/moe/moe_layer.py:263 MoELayer and its gates).
The layers are ``models/moe.py``'s; the expert-parallel exchange is
``distributed.utils``' ``global_scatter``/``global_gather``, and
gpt_hybrid's ep branch shards the experts over dp."""
from paddle_tpu_torch.models.moe import (  # noqa: F401
    ExpertFFN, MoELayer, MoETransformerBlock, TopKGate,
)
from paddle_tpu_torch.models.moe import TopKGate as GShardGate  # noqa: F401


class SwitchGate(TopKGate):
    """Switch routing is top-1 by definition (reference
    moe/gate/switch_gate.py)."""

    def __init__(self, hidden_size, num_experts, top_k=1,
                 capacity_factor=1.25):
        super().__init__(hidden_size, num_experts, 1, capacity_factor)
