"""Analytic training cost of a GPT config, and MFU against one card's peak
(port of ``paddle_tpu/cost_model/cost_model.py:22-38``)."""
from __future__ import annotations

from typing import Dict

# Published per-card peaks: dense bf16 tensor-core FLOP/s and HBM bytes/s
# (NVIDIA H100 SXM data sheet).
GPU_SPECS: Dict[str, Dict[str, float]] = {
    "H100": {"flops": 989e12, "hbm_bw": 3.35e12},
}


def gpt_flops_per_token(cfg, seq_len: int) -> float:
    """Training FLOPs per token of a GPT-family config: 6*N for the
    parameter matmuls (fwd + bwd) + the 12*L*H*S attention term.
    `cfg` needs vocab_size/hidden_size/max_seq_len/num_layers."""
    n = (cfg.vocab_size * cfg.hidden_size
         + cfg.max_seq_len * cfg.hidden_size
         + cfg.num_layers * (12 * cfg.hidden_size * cfg.hidden_size
                             + 13 * cfg.hidden_size)
         + 2 * cfg.hidden_size)
    return float(6 * n + 12 * cfg.num_layers * cfg.hidden_size * seq_len)


def mfu(tokens_per_s: float, flops_per_token: float,
        chip: str = "H100") -> float:
    """Achieved model-flops utilization against one card's bf16 peak."""
    return tokens_per_s * flops_per_token / GPU_SPECS[chip]["flops"]
