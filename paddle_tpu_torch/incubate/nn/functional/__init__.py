"""paddle.incubate.nn.functional on the port: the port of
``paddle_tpu/incubate/nn/functional/__init__.py`` (reference:
python/paddle/incubate/nn/functional/*), each function in torch ops on its
tensors' device through ``run_op`` or the port's ``nn.functional``.

``variable_length_memory_efficient_attention`` keeps the reference's two
layouts (ROADMAP, deliberate differences): with ``seq_lens`` it reads
``[B, H, S, D]`` and computes the masked attention in plain torch ops, as
the reference does; without them it passes its inputs to
``nn.functional.scaled_dot_product_attention``, which reads ``[B, S, H,
D]`` (and, on the card, launches the library tier's kernels). The three
functions the reference refuses (``fused_multi_head_attention``,
``block_multihead_attention``, ``fused_multi_transformer``) raise, naming
what the port offers instead.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ....core.dispatch import run_op
from ....core.tensor import Tensor
from ....nn import functional as F


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    """reference fused_rms_norm.py: (out, invvar), invvar None."""
    return F.rms_norm(x, norm_weight, norm_bias, epsilon,
                      begin_norm_axis), None


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, **kw):
    return F.layer_norm(x, x.shape[begin_norm_axis:], norm_weight,
                        norm_bias, epsilon), None


def _raw(t):
    return t._data if isinstance(t, Tensor) else torch.as_tensor(t)


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    theta=10000.0):
    """reference fused_rotary_position_embedding on [B, S, H, D]: the
    neox style (the default) rotates the interleaved pairs ``0::2`` and
    ``1::2``, as ``models/llama.py``'s RoPE does; the other style rotates
    the two halves. ``sin``/``cos``: tables [1, S, 1, D] or [S, D], else
    made from ``theta``; ``position_ids``: [B, S] absolute positions.
    Returns (q, k, v) with v passed through."""
    d = q.shape[-1]
    seq = q.shape[1]
    pid = None if position_ids is None else _raw(position_ids)
    if pid is not None:
        # the table covers the largest position (a decode step's positions
        # lie beyond q's own length)
        seq = max(seq, int(pid.max()) + 1)
    dev = q._data.device

    def tables():
        if sin is not None and cos is not None:
            s_t, c_t = _raw(sin).to(dev), _raw(cos).to(dev)
            if s_t.dim() == 2:                       # [S, D] -> [1, S, 1, D]
                s_t, c_t = s_t[None, :, None, :], c_t[None, :, None, :]
            return s_t, c_t
        inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                            device=dev) / d))
        freqs = torch.outer(torch.arange(seq, dtype=torch.float32,
                                         device=dev), inv)   # [S, D/2]
        full = torch.repeat_interleave(freqs, 2, -1) \
            if use_neox_rotary_style else torch.cat([freqs, freqs], -1)
        return torch.sin(full)[None, :, None, :], \
            torch.cos(full)[None, :, None, :]

    s_tab, c_tab = tables()
    if pid is not None:
        pid = pid.to(dev).long()
        s_tab = s_tab[0, :, 0, :][pid][:, :, None, :]       # [B, S, 1, D]
        c_tab = c_tab[0, :, 0, :][pid][:, :, None, :]

    def rope(a):
        af = a.float()
        st, ct = s_tab.float(), c_tab.float()
        if use_neox_rotary_style:
            x1, x2 = af[..., 0::2], af[..., 1::2]
            c_h, s_h = ct[..., 0::2], st[..., 0::2]
            out = torch.stack([x1 * c_h - x2 * s_h, x2 * c_h + x1 * s_h],
                              -1).reshape(a.shape)
        else:
            half = a.shape[-1] // 2
            x1, x2 = af[..., :half], af[..., half:]
            c_h, s_h = ct[..., :half], st[..., :half]
            out = torch.cat([x1 * c_h - x2 * s_h, x2 * c_h + x1 * s_h], -1)
        return out.to(a.dtype)

    return (run_op("fused_rope", rope, q),
            run_op("fused_rope", rope, k) if k is not None else None, v)


def swiglu(x, y=None, name=None):
    """reference swiglu fused op: silu(x) * y (or x split in half)."""
    from ....ops.extra import swiglu as _swiglu
    return _swiglu(x, y)


def fused_bias_act(x, bias=None, act_method="gelu", **kw):
    """(x + bias) through gelu (tanh form, as ``jax.nn.gelu``), silu/swish
    or relu."""
    def f(a, *b):
        if b:
            a = a + b[0]
        if act_method == "gelu":
            return tF.gelu(a, approximate="tanh")
        if act_method in ("silu", "swish"):
            return tF.silu(a)
        return torch.relu(a)
    args = (x,) if bias is None else (x, bias)
    return run_op("fused_bias_act", f, *args)


def fused_linear(x, weight, bias=None, transpose_weight=False, name=None):
    """x @ weight (+ bias): weight [in, out], or [out, in] with
    ``transpose_weight``."""
    def f(a, w, *b):
        out = torch.matmul(a, w.t() if transpose_weight else w)
        return out + b[0] if b else out
    args = (x, weight) if bias is None else (x, weight, bias)
    return run_op("fused_linear", f, *args)


def fused_linear_activation(x, weight, bias=None, activation="gelu",
                            **kw):
    return getattr(F, activation)(fused_linear(x, weight, bias))


def fused_dropout_add(x, y, p=0.5, training=True, mode="upscale_in_train",
                      name=None):
    return F.dropout(x, p, training=training, mode=mode) + y


def fused_moe(x, gate_weight, ffn1_weight, ffn1_bias, ffn2_weight,
              ffn2_bias, top_k=2, norm_topk_prob=True, **kw):
    """reference fused_moe.py: the dense-dispatch GShard MoE. The gate's
    softmax in f32, the top-k (normalised), then every expert's FFN
    (``gelu(x @ w1 + b1) @ w2 + b2``, gelu in its tanh form) over every
    token, masked by the dispatch, and the combine."""
    def f(a, gw, w1, b1, w2, b2):
        b, s, h = a.shape
        tokens = a.reshape(b * s, h)
        e = gw.shape[-1]
        probs = torch.softmax(tokens.float() @ gw.float(), -1)
        topv, topi = torch.topk(probs, top_k, -1)
        if norm_topk_prob:
            topv = topv / topv.sum(-1, keepdim=True)
        disp = torch.zeros_like(probs)
        comb = torch.zeros_like(probs)
        for j in range(top_k):
            oh = tF.one_hot(topi[:, j], e).to(probs.dtype)
            disp = disp + oh
            comb = comb + oh * topv[:, j:j + 1]
        xin = torch.einsum("te,th->eth", disp.to(a.dtype), tokens)
        hmid = tF.gelu(torch.bmm(xin, w1) + b1[:, None], approximate="tanh")
        hout = torch.bmm(hmid, w2) + b2[:, None]
        out = torch.einsum("te,eth->th", comb.to(a.dtype), hout)
        return out.reshape(b, s, h)
    return run_op("fused_moe", f, x, gate_weight, ffn1_weight, ffn1_bias,
                  ffn2_weight, ffn2_bias)


def masked_multihead_attention(x, cache_kv=None, src_mask=None,
                               sequence_lengths=None, rotary_tensor=None,
                               beam_cache_offset=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype='default', out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Reference masked_multihead_attention.py: the single-token decode
    attention, as the JAX package computes it: a write into the
    fixed-capacity cache (in place here) and length-masked attention; see
    inference/decode.py for the full serving path.

    x: [B, 3*H*D] fused qkv for the current step; cache_kv:
    [2, B, H, max_seq, D]; sequence_lengths: [B] int32 (current lengths;
    defaults to full cache if omitted is not supported — pass lengths).
    Returns (out [B, H*D], new_cache_kv) (+ beam offset passthrough).
    """
    from ....inference.decode import masked_multihead_attention_impl
    if cache_kv is None:
        raise ValueError("masked_multihead_attention requires cache_kv "
                         "[2, B, num_heads, max_seq_len, head_dim]")
    if sequence_lengths is None:
        raise ValueError(
            "pass sequence_lengths [B] int32: the cache is a "
            "fixed-capacity buffer, so valid lengths are explicit")
    if rotary_tensor is not None or use_neox_rotary_style:
        raise NotImplementedError(
            "custom rotary_tensor / neox-style rotary are not supported: "
            "only interleaved theta=1e4 RoPE (rotary_emb_dims>0) is "
            "implemented — apply custom rotary to x before the call")
    if src_mask is not None:
        raise NotImplementedError(
            "src_mask is not supported on the decode path: causality "
            "comes from the cache length mask (mask lengths via "
            "sequence_lengths instead)")
    if out_scale is not None and out_scale > 0:
        raise NotImplementedError(
            "quantized (int8) attention output (out_scale>0) is not "
            "implemented — serve with inference int8 weight-only "
            "quantization instead")
    if compute_dtype not in ("default", "fp32", "float32"):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: only fp32 compute is "
            "implemented (cast x/cache_kv for bf16 storage)")
    num_heads = cache_kv.shape[2]
    theta = None
    if rotary_emb_dims and rotary_emb_dims > 0:
        theta = 10000.0
    out, new_cache = masked_multihead_attention_impl(
        x, cache_kv, sequence_lengths, num_heads, rotary_theta=theta)
    if beam_cache_offset is not None:
        return out, new_cache, beam_cache_offset
    return out, new_cache


def variable_length_memory_efficient_attention(query, key, value,
                                               seq_lens=None,
                                               kv_seq_lens=None,
                                               mask=None, scale=None,
                                               causal=False):
    """Attention with per-sequence valid lengths (reference
    variable_length_memory_efficient_attention.py). With ``seq_lens``
    ([B]; ``kv_seq_lens`` defaults to them) q/k/v are [B, H, S, D], padded
    keys are masked out and padded query rows come back as zeros. Without
    them the call is ``nn.functional.scaled_dot_product_attention(query,
    key, value, mask, is_causal=causal)``, whose layout is [B, S, H, D]."""
    if seq_lens is None:
        return F.scaled_dot_product_attention(query, key, value, mask,
                                              is_causal=causal)
    if kv_seq_lens is None:
        kv_seq_lens = seq_lens

    def f(q, k, v, q_lens, k_lens, *rest):
        s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        logits = (torch.einsum("bhqd,bhkd->bhqk", q, k) * s).float()
        sq, sk = q.shape[2], k.shape[2]
        dev = q.device
        valid_k = torch.arange(sk, device=dev)[None, :] < k_lens[:, None]
        m = valid_k[:, None, None, :]
        if causal:
            m = m & (torch.arange(sq, device=dev)[:, None]
                     >= torch.arange(sk, device=dev)[None, :])[None, None]
        if rest:
            m = m & (rest[0] if rest[0].dtype == torch.bool else rest[0] > 0)
        logits = torch.where(m, logits, torch.full((), -1e30, device=dev))
        probs = torch.softmax(logits, -1).to(q.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
        valid_q = torch.arange(sq, device=dev)[None, :] < q_lens[:, None]
        return out * valid_q[:, None, :, None].to(out.dtype)

    args = [query, key, value, seq_lens, kv_seq_lens]
    if mask is not None:
        args.append(mask)
    return run_op("variable_length_attention", f, *args)


def fused_multi_head_attention(x, qkv_weight, linear_weight, **kw):
    raise NotImplementedError(
        "use paddle_tpu_torch.nn.MultiHeadAttention (its projections are "
        "one GEMM each; its attention the nn.functional "
        "scaled_dot_product_attention route)")


def fused_matmul_bias(x, y, bias=None, transpose_x=False,
                      transpose_y=False, name=None):
    """reference incubate fused_matmul_bias: x @ y (+ bias)."""
    def f(a, b, *rest):
        if transpose_x:
            a = a.transpose(-1, -2)
        if transpose_y:
            b = b.transpose(-1, -2)
        out = torch.matmul(a, b)
        return out + rest[0] if rest else out
    args = (x, y) + ((bias,) if bias is not None else ())
    return run_op("fused_matmul_bias", f, *args)


def fused_feedforward(x, linear1_weight, linear2_weight, linear1_bias=None,
                      linear2_bias=None, ln1_scale=None, ln1_bias=None,
                      ln2_scale=None, ln2_bias=None, dropout1_rate=0.5,
                      dropout2_rate=0.5, activation="relu",
                      ln1_epsilon=1e-5, ln2_epsilon=1e-5,
                      pre_layer_norm=False, training=True,
                      mode='upscale_in_train', ring_id=-1, name=None):
    """reference incubate fused_feedforward: the pre- or post-LN
    transformer FFN block."""
    from ....ops.linalg import matmul

    def ln(v, scale, bias, eps):
        return F.layer_norm(v, [v.shape[-1]], weight=scale, bias=bias,
                            epsilon=eps)

    residual = x
    if pre_layer_norm:
        x = ln(x, ln1_scale, ln1_bias, ln1_epsilon)
    h = matmul(x, linear1_weight)
    if linear1_bias is not None:
        h = h + linear1_bias
    h = getattr(F, activation)(h)
    h = F.dropout(h, p=dropout1_rate, training=training, mode=mode)
    h = matmul(h, linear2_weight)
    if linear2_bias is not None:
        h = h + linear2_bias
    h = F.dropout(h, p=dropout2_rate, training=training, mode=mode)
    out = residual + h
    if not pre_layer_norm:
        out = ln(out, ln2_scale, ln2_bias, ln2_epsilon)
    return out


def fused_bias_dropout_residual_layer_norm(
        x, residual, bias=None, ln_scale=None, ln_bias=None,
        dropout_rate=0.5, ln_epsilon=1e-5, training=True,
        mode='upscale_in_train', name=None):
    """reference incubate fused_bias_dropout_residual_layer_norm."""
    h = x if bias is None else x + bias
    h = F.dropout(h, p=dropout_rate, training=training, mode=mode)
    out = residual + h
    return F.layer_norm(out, [out.shape[-1]], weight=ln_scale,
                        bias=ln_bias, epsilon=ln_epsilon)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size,
                     name=None):
    """reference blha_get_max_len: the largest encoder and decoder
    lengths."""
    return run_op("blha_get_max_len",
                  lambda enc, dec: (torch.amax(enc), torch.amax(dec)),
                  seq_lens_encoder, seq_lens_decoder, differentiable=False)


def block_multihead_attention(qkv, key_cache, value_cache, seq_lens_encoder,
                              seq_lens_decoder, seq_lens_this_time,
                              padding_offsets=None, cum_offsets=None,
                              cu_seqlens_q=None, cu_seqlens_k=None,
                              block_tables=None, **kwargs):
    """reference incubate block_multihead_attention (paged-KV attention),
    which the reference refuses as the port does: its caches are dense."""
    raise NotImplementedError(
        "paged/block KV attention is not offered: use "
        "paddle_tpu_torch.nn.functional.scaled_dot_product_attention over "
        "dense KV caches, or paddle_tpu_torch.inference.DecodeSession")


def fused_multi_transformer(x, ln_scales, ln_biases, qkv_weights,
                            qkv_biases, *args, **kwargs):
    """reference incubate fused_multi_transformer (a single-kernel
    multi-layer inference transformer), which the reference refuses as the
    port does."""
    raise NotImplementedError(
        "compile the whole decode step with paddle_tpu_torch.jit.to_static "
        "instead, or serve with paddle_tpu_torch.inference.DecodeSession")


__all__ = [
    "fused_rms_norm", "fused_layer_norm", "fused_rotary_position_embedding",
    "swiglu", "fused_bias_act", "fused_linear", "fused_linear_activation",
    "fused_dropout_add", "fused_moe", "masked_multihead_attention",
    "variable_length_memory_efficient_attention",
    "fused_multi_head_attention", "fused_matmul_bias", "fused_feedforward",
    "fused_bias_dropout_residual_layer_norm", "blha_get_max_len",
    "block_multihead_attention", "fused_multi_transformer",
]
