"""Analytic and measured cost model: the port of
``paddle_tpu/cost_model/cost_model.py`` (reference:
python/paddle/cost_model/cost_model.py:33 and the planner's use of it in
distributed/auto_parallel/static/cost/).

The analytic path is a roofline over one card's published peaks (tensor-core
FLOP/s, HBM bytes/s) plus a ring model of the collectives over NVLink; the
measured path (``profile_measure``) times a callable on the card with CUDA
events, or on the CPU with ``perf_counter``."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Sequence

# Published per-card figures, NVIDIA H100 SXM5 data sheet: dense bf16
# tensor-core FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s a direction (900 GB/s
# bidirectional over its 18 links) and the HBM capacity.
GPU_SPECS: Dict[str, Dict[str, float]] = {
    "H100": {"flops": 989e12, "hbm_bw": 3.35e12, "nvlink_bw": 450e9,
             "hbm_bytes": 80e9},
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


@dataclass
class OpCost:
    """Cost estimate for one op (reference: auto_parallel cost items:
    comp_cost / comm_cost entries)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    comm_bytes: float = 0.0
    time_s: float = 0.0

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops,
                      self.bytes_accessed + other.bytes_accessed,
                      self.comm_bytes + other.comm_bytes,
                      self.time_s + other.time_s)


class CostModel:
    def __init__(self, chip: str = "H100"):
        if chip not in GPU_SPECS:
            raise ValueError(f"unknown chip {chip!r}; one of "
                             f"{sorted(GPU_SPECS)}")
        self.chip = chip
        self.spec = GPU_SPECS[chip]

    # ----------------------------------------------------- analytic path
    def matmul_cost(self, m: int, n: int, k: int, dtype_bytes: int = 2,
                    batch: int = 1) -> OpCost:
        flops = 2.0 * batch * m * n * k
        byts = dtype_bytes * batch * (m * k + k * n + m * n)
        return self._finish(OpCost(flops=flops, bytes_accessed=byts))

    def elementwise_cost(self, numel: int, n_operands: int = 2,
                         dtype_bytes: int = 2) -> OpCost:
        byts = dtype_bytes * numel * (n_operands + 1)
        return self._finish(OpCost(flops=numel, bytes_accessed=byts))

    def attention_cost(self, batch: int, heads: int, seq: int,
                       head_dim: int, dtype_bytes: int = 2,
                       flash: bool = True) -> OpCost:
        flops = 4.0 * batch * heads * seq * seq * head_dim
        io = dtype_bytes * batch * heads * seq * head_dim * 4
        if not flash:                       # materialized S/P matrices
            io += dtype_bytes * batch * heads * seq * seq * 2
        return self._finish(OpCost(flops=flops, bytes_accessed=io))

    def collective_cost(self, kind: str, bytes_per_rank: float,
                        n_ranks: int) -> OpCost:
        """Ring-model cost over NVLink: all_reduce moves 2(n-1)/n,
        all_gather / reduce_scatter / all_to_all (n-1)/n of the payload a
        link."""
        if n_ranks <= 1:
            return OpCost()
        factor = {"all_reduce": 2.0, "all_gather": 1.0,
                  "reduce_scatter": 1.0, "all_to_all": 1.0,
                  "ppermute": 1.0, "send_recv": 1.0}[kind]
        wire = factor * (n_ranks - 1) / n_ranks * bytes_per_rank
        c = OpCost(comm_bytes=wire)
        c.time_s = wire / self.spec["nvlink_bw"]
        return c

    def _finish(self, c: OpCost) -> OpCost:
        """Roofline: time = max(compute, memory) (+comm handled by
        collective_cost)."""
        c.time_s = max(c.flops / self.spec["flops"],
                       c.bytes_accessed / self.spec["hbm_bw"])
        return c

    def roofline_intensity(self) -> float:
        """FLOP/byte at the compute/memory ridge point."""
        return self.spec["flops"] / self.spec["hbm_bw"]

    # ----------------------------------------------------- measured path
    def profile_measure(self, fn, args: Sequence, steps: int = 10,
                        warmup: int = 3) -> float:
        """Seconds a call of ``fn(*args)`` (reference
        CostModel.profile_measure over a Program): CUDA events around the
        ``steps`` calls when an argument lives on the card, ``perf_counter``
        otherwise. ``fn`` runs as given, eagerly."""
        import torch

        def on_card(a):
            a = getattr(a, "_data", a)
            return isinstance(a, torch.Tensor) and a.is_cuda
        for _ in range(warmup):
            fn(*args)
        if any(on_card(a) for a in args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(steps):
                fn(*args)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3 / steps
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(*args)
        return (time.perf_counter() - t0) / steps

    # ------------------------------------------------ model-level helper
    @staticmethod
    def train_flops(n_params: float, layers: int, hidden: int, seq: int,
                    batch_tokens: float) -> float:
        """fwd+bwd transformer FLOPs: 6/param/token + the attention
        quadratic term (used by transformer_step_cost and the planner)."""
        return (6.0 * n_params + 12.0 * layers * hidden * seq) \
            * batch_tokens

    def transformer_step_cost(self, n_params: float, batch_tokens: float,
                              hidden: int, layers: int, seq: int,
                              n_chips: int = 1, dp: int = 1, tp: int = 1,
                              dtype_bytes: int = 2) -> OpCost:
        """End-to-end train-step estimate with DP grad all_reduce and TP
        activation collectives."""
        flops = self.train_flops(n_params, layers, hidden, seq,
                                 batch_tokens)
        cost = OpCost(flops=flops,
                      bytes_accessed=dtype_bytes * n_params * 3)
        cost = self._finish(cost)
        if dp > 1:
            cost = cost + self.collective_cost(
                "all_reduce", dtype_bytes * n_params / tp, dp)
        if tp > 1:
            per_layer = dtype_bytes * batch_tokens * hidden
            cost = cost + self.collective_cost(
                "all_reduce", 2 * layers * per_layer / dp, tp)
        return cost
