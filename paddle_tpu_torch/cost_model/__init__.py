"""paddle.cost_model on the port (reference: python/paddle/cost_model —
CostModel.profile_measure and the op table behind the auto-parallel
planner): an analytic roofline over one card's published peaks (tensor-core
FLOP/s, HBM and NVLink bandwidth) for planning without the card, and
``profile_measure``, which times a callable on the card."""
from .cost_model import (  # noqa: F401
    CostModel, GPU_SPECS, OpCost, gpt_flops_per_token, mfu)

__all__ = ["CostModel", "GPU_SPECS", "OpCost", "gpt_flops_per_token",
           "mfu"]
