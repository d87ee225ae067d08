"""Llama-family decoder LM: the port of ``paddle_tpu/models/llama.py``
(BASELINE.json config 4: Llama-2 7B), built from the port's ``nn`` layers.
Supports GQA (``num_kv_heads < num_heads``).

``LlamaConfig`` is the port's own copy (same fields, defaults and named
configurations). Three attention branches, as the reference's:

- no cache: RoPE, the kv heads ``repeat_interleave``d to the query heads,
  then ``F.scaled_dot_product_attention`` (causal), which takes the
  library tier's Hopper kernels on the card;
- the fixed-capacity ``inference.decode.StaticCache``: RoPE at the
  per-sequence cache lengths, then ``cache_attention``, which writes k/v
  into the preallocated cache in place and groups the query heads over the
  kv heads (head ``h`` reads kv head ``h // g``);
- the legacy growing ``(k, v)`` concat cache (``init_cache`` without
  ``max_length``).

The reference's tensor-parallel layers (``use_tensor_parallel``) wait for
the distributed slice of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.core.dispatch import run_op
from paddle_tpu_torch.nn import functional as F


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    use_tensor_parallel: bool = False

    @staticmethod
    def llama2_7b():
        return LlamaConfig()

    @staticmethod
    def tiny():
        return LlamaConfig(vocab_size=256, hidden_size=64,
                           intermediate_size=128, num_layers=2, num_heads=4,
                           num_kv_heads=2, max_seq_len=64)


def _no_tensor_parallel(cfg):
    if cfg.use_tensor_parallel:
        raise NotImplementedError(
            "Llama tensor parallelism waits for the distributed slice of "
            "the port (ROADMAP queue 1)")


def apply_rotary_pos_emb(x, position_offset=0, theta=10000.0):
    """RoPE on [B, S, H, D] (reference:
    incubate/nn/functional/fused_rotary_position_embedding.py), pairing
    the interleaved channels ``0::2`` with ``1::2``, in f32, cast back to
    x's dtype. position_offset may be a python int or a [B] int tensor (the
    decode path's per-sequence cache lengths)."""
    def f(a, off):
        b, s, h, d = a.shape
        pos = (off.reshape(-1, 1).float()
               + torch.arange(s, dtype=torch.float32,
                              device=a.device)[None, :])   # [B|1, S]
        inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=a.device) / d))
        freqs = pos[..., None] * inv                   # [B|1, S, D/2]
        cos = torch.cos(freqs)[:, :, None, :]
        sin = torch.sin(freqs)[:, :, None, :]
        x1 = a[..., 0::2].float()
        x2 = a[..., 1::2].float()
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        return torch.stack([o1, o2], dim=-1).reshape(a.shape).to(a.dtype)
    return run_op("rope", f, x, position_offset)


class LlamaAttention(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _no_tensor_parallel(cfg)
        self.cfg = cfg
        h = cfg.hidden_size
        d = h // cfg.num_heads
        kv_out = cfg.num_kv_heads * d
        self.q_proj = nn.Linear(h, h, bias_attr=False)
        self.k_proj = nn.Linear(h, kv_out, bias_attr=False)
        self.v_proj = nn.Linear(h, kv_out, bias_attr=False)
        self.o_proj = nn.Linear(h, h, bias_attr=False)

    def forward(self, x, position_offset=0, cache=None):
        from paddle_tpu_torch.inference.decode import (StaticCache,
                                                       cache_attention)
        cfg = self.cfg
        b, s, h = x.shape
        d = h // cfg.num_heads
        q = self.q_proj(x).reshape([b, s, cfg.num_heads, d])
        k = self.k_proj(x).reshape([b, s, cfg.num_kv_heads, d])
        v = self.v_proj(x).reshape([b, s, cfg.num_kv_heads, d])
        if isinstance(cache, StaticCache):
            # fixed-capacity decode path: RoPE offsets come from the
            # per-sequence cache lengths; k/v are written into the cache
            q = apply_rotary_pos_emb(q, cache.length, cfg.rope_theta)
            k = apply_rotary_pos_emb(k, cache.length, cfg.rope_theta)
            out, cache = cache_attention(q, k, v, cache)
            out = out.reshape([b, s, h])
            return self.o_proj(out), cache
        q = apply_rotary_pos_emb(q, position_offset, cfg.rope_theta)
        k = apply_rotary_pos_emb(k, position_offset, cfg.rope_theta)
        if cache is not None:
            pk, pv = cache
            k = paddle.concat([pk, k], axis=1)
            v = paddle.concat([pv, v], axis=1)
            cache = (k, v)
        if cfg.num_kv_heads != cfg.num_heads:
            rep = cfg.num_heads // cfg.num_kv_heads
            k = k.repeat_interleave(rep, axis=2)
            v = v.repeat_interleave(rep, axis=2)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                             training=self.training)
        out = out.reshape([b, s, h])
        out = self.o_proj(out)
        return out if cache is None else (out, cache)


class LlamaMLP(nn.Layer):
    """SwiGLU (reference incubate swiglu fused op)."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _no_tensor_parallel(cfg)
        h, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, m, bias_attr=False)
        self.up_proj = nn.Linear(h, m, bias_attr=False)
        self.down_proj = nn.Linear(m, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.input_layernorm = nn.RMSNorm(cfg.hidden_size,
                                          epsilon=cfg.rms_eps)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = nn.RMSNorm(cfg.hidden_size,
                                                   epsilon=cfg.rms_eps)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, position_offset=0, cache=None):
        attn_out = self.self_attn(self.input_layernorm(x),
                                  position_offset, cache)
        if cache is not None:
            attn_out, cache = attn_out
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x if cache is None else (x, cache)


class LlamaModel(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        _no_tensor_parallel(cfg)
        self.cfg = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.LayerList([LlamaBlock(cfg)
                                    for _ in range(cfg.num_layers)])
        self.norm = nn.RMSNorm(cfg.hidden_size, epsilon=cfg.rms_eps)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size,
                                 bias_attr=False)

    def forward(self, input_ids, position_offset=0, caches=None):
        x = self.embed_tokens(input_ids)
        new_caches = []
        for i, blk in enumerate(self.layers):
            if caches is None:
                x = blk(x, position_offset)
            else:
                x, c = blk(x, position_offset, caches[i])
                new_caches.append(c)
        x = self.norm(x)
        logits = self.lm_head(x)
        return logits if caches is None else (logits, new_caches)

    def init_cache(self, batch_size, max_length=None):
        """max_length=None: the legacy growing concat cache (a new shape
        every step). max_length=C: the fixed-capacity static cache of the
        serving path, k/v written in place."""
        d = self.cfg.hidden_size // self.cfg.num_heads
        if max_length is not None:
            from paddle_tpu_torch.inference.decode import init_static_cache
            return [init_static_cache(batch_size, max_length,
                                      self.cfg.num_kv_heads, d)
                    for _ in range(self.cfg.num_layers)]
        z = paddle.zeros([batch_size, 0, self.cfg.num_kv_heads, d])
        return [(z, z) for _ in range(self.cfg.num_layers)]


class LlamaForCausalLM(nn.Layer):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.llama = LlamaModel(cfg)
        self.loss_fn = nn.CrossEntropyLoss()

    def forward(self, input_ids, labels=None):
        logits = self.llama(input_ids)
        if labels is None:
            return logits
        return self.loss_fn(
            logits[:, :-1].reshape([-1, logits.shape[-1]]),
            labels[:, 1:].reshape([-1]))

    def init_cache(self, batch_size, max_length=None):
        return self.llama.init_cache(batch_size, max_length)

    def forward_with_cache(self, input_ids, caches):
        """DecodeSession contract: (ids, caches) -> (logits, caches)."""
        return self.llama(input_ids, 0, caches)

    @paddle.no_grad()
    def generate(self, input_ids, max_new_tokens=16, temperature=0.0,
                 top_p=None, seed=None, max_length=None,
                 decode_block=None):
        """Static-shape generation over the fixed-capacity KV cache
        (``inference.decode.cached_generate``): one decode step program
        reused for every token, the cache written in place."""
        from paddle_tpu_torch.inference.decode import cached_generate
        self.eval()
        return cached_generate(self, input_ids, max_new_tokens,
                               temperature=temperature, top_p=top_p,
                               seed=seed, max_length=max_length,
                               decode_block=decode_block,
                               seq_ceiling=self.llama.cfg.max_seq_len,
                               hard_limit=False)
