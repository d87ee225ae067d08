"""Mixture-of-Experts layers: the port of ``paddle_tpu/models/moe.py``
(BASELINE.json config 5; reference: incubate/distributed/models/moe —
MoELayer, moe_layer.py:263, with gshard/switch gates, gate/*.py).

The reference's GShard dense dispatch on one device: top-1 (switch) or
top-2 (gshard) gating, a one-hot dispatch [T, E] and its renormalised
combine, the experts as one stacked [E, ...] FFN, and the Switch
Transformer load-balancing aux loss. Each step is one eager op under the
reference's op name (``topk_gate``, ``expert_ffn``, ``moe_dispatch``,
``moe_combine``), so AMP casts and op stats see what the reference's do.
Expert parallelism (the expert dim sharded over dp, the all-to-alls) is
gpt_hybrid's ep branch (``gpt_manual_tp.moe_ffn_manual_ep``) and
``distributed.utils``' ``global_scatter``/``global_gather``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from paddle_tpu_torch import nn
from paddle_tpu_torch.core.dispatch import run_op
from paddle_tpu_torch.nn import initializer as I


class TopKGate(nn.Layer):
    """switch (k=1) / gshard (k=2) gate with the aux load-balancing loss."""

    def __init__(self, hidden_size, num_experts, top_k=2,
                 capacity_factor=1.25):
        super().__init__()
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.weight = self.create_parameter((hidden_size, num_experts),
                                            None)
        self._last_aux_loss = None

    def forward(self, x):
        """x: [T, H] -> (dispatch [T, E], combine [T, E], aux_loss)."""
        def f(tokens, w):
            logits = tokens.float() @ w.float()
            probs = torch.softmax(logits, -1)
            e = self.num_experts
            topi = torch.topk(probs, self.top_k, dim=-1).indices
            disp = torch.zeros_like(probs)
            for j in range(self.top_k):
                disp = disp + TF.one_hot(topi[:, j], e).to(probs.dtype)
            combine = probs * disp
            combine = combine / torch.clamp(
                combine.sum(-1, keepdim=True), min=1e-9)
            # load-balancing aux loss (Switch Transformer eq. 4)
            me = probs.mean(0)
            ce = disp.mean(0)
            aux = e * torch.sum(me * ce)
            return disp, combine, aux
        return run_op("topk_gate", f, x, self.weight)


class ExpertFFN(nn.Layer):
    """E parallel FFNs stored stacked [E, ...]."""

    def __init__(self, num_experts, hidden_size, intermediate_size,
                 activation="gelu"):
        super().__init__()
        self.w1 = self.create_parameter(
            (num_experts, hidden_size, intermediate_size), None,
            default_initializer=I.XavierNormal())
        self.b1 = self.create_parameter((num_experts, intermediate_size),
                                        None, is_bias=True)
        self.w2 = self.create_parameter(
            (num_experts, intermediate_size, hidden_size), None,
            default_initializer=I.XavierNormal())
        self.b2 = self.create_parameter((num_experts, hidden_size), None,
                                        is_bias=True)
        self.act = activation

    def forward(self, xin):
        """xin: [E, T, H] -> [E, T, H]"""
        def f(a, w1, b1, w2, b2):
            h = torch.einsum("eth,ehm->etm", a, w1) + b1[:, None]
            h = TF.gelu(h, approximate="tanh") if self.act == "gelu" \
                else torch.relu(h)
            return torch.einsum("etm,emh->eth", h, w2) + b2[:, None]
        return run_op("expert_ffn", f, xin, self.w1, self.b1, self.w2,
                      self.b2)


class MoELayer(nn.Layer):
    """reference moe_layer.py:263 equivalent."""

    def __init__(self, hidden_size, intermediate_size, num_experts,
                 top_k=2, capacity_factor=1.25, gate="gshard",
                 aux_loss_weight=0.01):
        super().__init__()
        k = 1 if gate == "switch" else top_k
        self.gate = TopKGate(hidden_size, num_experts, k, capacity_factor)
        self.experts = ExpertFFN(num_experts, hidden_size,
                                 intermediate_size)
        self.aux_loss_weight = aux_loss_weight
        self._aux_loss = None

    def forward(self, x):
        b, s, h = x.shape
        tokens = x.reshape([b * s, h])
        disp, combine, aux = self.gate(tokens)
        self._aux_loss = aux
        xin = run_op("moe_dispatch",
                     lambda t, d, c: torch.einsum("te,th->eth",
                                                  d.to(t.dtype), t),
                     tokens, disp, combine)
        expert_out = self.experts(xin)
        out = run_op("moe_combine",
                     lambda c, eo: torch.einsum("te,eth->th",
                                                c.to(eo.dtype), eo),
                     combine, expert_out)
        return out.reshape([b, s, h])

    @property
    def aux_loss(self):
        return self._aux_loss


class MoETransformerBlock(nn.Layer):
    def __init__(self, hidden_size, num_heads, intermediate_size,
                 num_experts, top_k=2):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden_size)
        self.attn = nn.MultiHeadAttention(hidden_size, num_heads)
        self.ln2 = nn.LayerNorm(hidden_size)
        self.moe = MoELayer(hidden_size, intermediate_size, num_experts,
                            top_k)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), attn_mask=mask)
        x = x + self.moe(self.ln2(x))
        return x
