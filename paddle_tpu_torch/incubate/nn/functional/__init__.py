"""paddle.incubate.nn.functional on the port: the port of
``paddle_tpu/incubate/nn/functional/__init__.py``'s
``masked_multihead_attention`` (:177), with its refusals, over
``inference.decode.masked_multihead_attention_impl``, and of
``fused_rms_norm``, ``fused_layer_norm`` and ``swiglu`` (:15, :22, :102).
The module's other names wait for a later slice (ROADMAP queue 1, item 7).
"""
from __future__ import annotations


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon=1e-6,
                   begin_norm_axis=-1, **kw):
    """reference fused_rms_norm.py: (out, invvar), invvar None."""
    from ....nn import functional as F
    return F.rms_norm(x, norm_weight, norm_bias, epsilon,
                      begin_norm_axis), None


def fused_layer_norm(x, norm_weight, norm_bias, epsilon=1e-5,
                     begin_norm_axis=-1, **kw):
    from ....nn import functional as F
    return F.layer_norm(x, x.shape[begin_norm_axis:], norm_weight,
                        norm_bias, epsilon), None


def swiglu(x, y=None, name=None):
    """reference swiglu fused op: silu(x) * y (or x split in half)."""
    from ....ops.extra import swiglu as _swiglu
    return _swiglu(x, y)


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
