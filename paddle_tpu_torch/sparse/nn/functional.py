"""paddle.sparse.nn.functional — functional forms of the sparse nn ops
(reference: python/paddle/sparse/nn/functional/{conv,pooling,activation,
transformer}.py over the phi sparse CUDA kernels).

Port of ``paddle_tpu/sparse/nn/functional.py``, keeping its design:
convolutions and pooling densify the block, run one dense op, and make the
result sparse again (submanifold rule: output support == input support,
applied as a gather at the input's active sites; otherwise every nonzero
of the output is stored). The ``_igemm`` variants are the same computation
(the suffix selects an implicit-gemm CUDA kernel in the reference).
Gradients flow through the values, the weights and the bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from ...core.tensor import Tensor
from .. import _arr

__all__ = [
    "conv2d", "conv3d", "subm_conv2d", "subm_conv2d_igemm",
    "subm_conv3d", "subm_conv3d_igemm", "max_pool3d",
    "relu", "relu6", "leaky_relu", "softmax", "attention",
]


def _sp():
    import paddle_tpu_torch.sparse as sp
    return sp


def _channels_dense(x):
    """``x`` with its trailing (channel) dim stored dense — the layout the
    reference keeps for NDHWC/NHWC sparse tensors (BCOO
    ``bcoo_update_layout(n_dense=1)`` of the coalesced tensor)."""
    sp = _sp()
    if x.n_dense >= 1:
        return x
    c = sp._coalesced(x)
    sites, inv = torch.unique_consecutive(c._idx[:-1], dim=1,
                                          return_inverse=True)
    val = torch.zeros((sites.shape[1], c._shape[-1]), dtype=c._val.dtype,
                      device=c._val.device)
    val = val.index_put((inv, c._idx[-1]), c._val)
    return sp.SparseCooTensor._wrap_coo(sites, val, c._shape, False, True)


def _norm_tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


def _conv_dense(x, weight, bias, stride, padding, dilation, groups,
                subm, ndim):
    """Shared dense-compute path: NHWC/NDHWC sparse in, dense out."""
    dense = x._data                           # [N, *spatial, C]
    # NC*spatial, laid out so: cuDNN's f32 3-D kernels over a
    # channels-last view took seconds at the KITTI grid
    lhs = torch.movedim(dense, -1, 1).contiguous()
    w = _arr(weight).to(dense.device)
    # weight layout [*k, C_in/groups, C_out] -> OI*spatial
    rhs = w.permute((ndim + 1, ndim) + tuple(range(ndim))).contiguous()
    st = _norm_tuple(stride, ndim)
    dl = _norm_tuple(dilation, ndim)
    if subm:
        # submanifold: output spatial size == input; SAME-style padding
        pads = [((k - 1) * d // 2, (k - 1) * d - (k - 1) * d // 2)
                for k, d in zip(rhs.shape[2:], dl)]
        st = (1,) * ndim
    elif isinstance(padding, int):
        pads = [(padding, padding)] * ndim
    else:
        pads = [(int(p), int(p)) if isinstance(p, int) else tuple(p)
                for p in padding]
    if all(lo == hi for lo, hi in pads):
        pad_arg = tuple(lo for lo, _ in pads)
    else:
        lhs = tF.pad(lhs, [v for lo, hi in reversed(pads) for v in (lo, hi)])
        pad_arg = 0
    conv = tF.conv3d if ndim == 3 else tF.conv2d
    out = conv(lhs, rhs, stride=st, padding=pad_arg, dilation=dl,
               groups=groups)
    out = torch.movedim(out, 1, -1)           # [N, *spatial, C_out]
    if bias is not None:
        out = out + _arr(bias)
    return out


def _conv(x, weight, bias, stride, padding, dilation, groups, subm,
          ndim):
    sp = _sp()
    out = _conv_dense(x, weight, bias, stride, padding, dilation,
                      groups, subm, ndim)
    if subm:
        # submanifold rule: keep exactly the input's active sites
        idx = _channels_dense(x)._idx         # [1+ndim, nnz]
        return sp.SparseCooTensor._wrap_coo(idx, out[tuple(idx)],
                                            out.shape, False, True)
    return sp.to_sparse_coo(Tensor._wrap(out, not out.requires_grad))


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NDHWC", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 subm=False, ndim=3)


def subm_conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NDHWC", key=None, name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 subm=True, ndim=3)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1, data_format="NHWC", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 subm=False, ndim=2)


def subm_conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
                groups=1, data_format="NHWC", key=None, name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 subm=True, ndim=2)


# the reference's *_igemm variants pick an implicit-gemm CUDA kernel for the
# same math; the dense convolution already is the gemm form
subm_conv2d_igemm = subm_conv2d
subm_conv3d_igemm = subm_conv3d


def max_pool3d(x, kernel_size, stride=None, padding=0,
               data_format="NDHWC", name=None):
    sp = _sp()
    dense = torch.movedim(x._data, -1, 1).contiguous()    # [N, C, D, H, W]
    ks = _norm_tuple(kernel_size, 3)
    st = ks if stride is None else _norm_tuple(stride, 3)
    pd = _norm_tuple(padding, 3)
    out = torch.movedim(tF.max_pool3d(dense, ks, st, pd), 1, -1)
    out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    return sp.to_sparse_coo(Tensor._wrap(out, not out.requires_grad))


# ------------------------------------------------------------ activations
# value-wise activations: delegate to the single _on_values implementations
# in paddle_tpu_torch.sparse (which also handle the dense-Tensor fallback)
def relu(x, name=None):
    return _sp().relu(x)


def relu6(x, name=None):
    return _sp().relu6(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _sp().leaky_relu(x, negative_slope)


def _pattern(x):
    """The dense boolean mask of ``x``'s stored entries."""
    sp = _sp()
    ones = torch.ones(x._val.shape, dtype=torch.int8, device=x._val.device)
    return sp._densify(x._idx, ones, x._shape) != 0


def softmax(x, axis=-1, name=None):
    """Softmax over the stored entries of each row (the reference kernel's
    semantics: missing entries are NOT treated as zeros)."""
    sp = _sp()
    if axis not in (-1, x.ndim - 1):
        raise ValueError("sparse softmax supports the last axis only")
    mask = _pattern(x)
    logits = torch.where(mask, x._data, float("-inf"))
    out = torch.softmax(logits, dim=-1)
    out = torch.where(mask, out, torch.zeros_like(out))
    idx, val = sp._fromdense(out)
    return sp.SparseCooTensor._wrap_coo(idx, val, x._shape, False, True)


def attention(query, key, value, sparse_mask, key_padding_mask=None,
              attn_mask=None, name=None):
    """Sparse-pattern attention (reference sparse/nn/functional/
    transformer.py:28): softmax(QK^T/sqrt(d)) restricted to the mask's
    sparsity pattern, then @V.

    q/k/v: dense [B, H, S, D]; sparse_mask: a sparse tensor (or dense
    Tensor) whose dense shape is [B*H, S, S] — only positions present in
    its pattern participate in the row softmax. key_padding_mask [B, S] and
    attn_mask [S, S] multiply additional positions out (the reference's
    semantics: a 0 masks, a 1 keeps). The pattern is a boolean mask on a
    dense masked softmax, as in the reference.
    """
    q, k, v = _arr(query), _arr(key), _arr(value)
    b, h, s, d = q.shape
    if hasattr(sparse_mask, "_idx"):
        pattern = _pattern(sparse_mask)
    else:
        pattern = _arr(sparse_mask) != 0
    keep = pattern.reshape(b, h, s, s).to(q.device)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(d)
    if key_padding_mask is not None:
        keep = keep & (_arr(key_padding_mask) != 0)[:, None, None, :]
    if attn_mask is not None:
        keep = keep & (_arr(attn_mask) != 0)[None, None, :, :]
    logits = torch.where(keep, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(keep, probs, torch.zeros_like(probs))  # all-masked
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return Tensor._wrap(out, not out.requires_grad)
