"""paddle.sparse (reference: phi sparse_coo/csr tensors + the paddle.sparse
API).

Port of ``paddle_tpu/sparse/__init__.py``, whose tensors are BCOO arrays.
Here a ``SparseCooTensor`` holds its indices ([n_sparse, nnz], int64) and
values ([nnz, *dense]), and ``_coo`` is the torch sparse COO tensor over
them. As in the reference:

- a hybrid tensor keeps its trailing dense (channel) dims in the values, as
  BCOO's ``n_dense`` does;
- the dense array is made only when a dense op reads ``_data``;
- duplicates stay stored until ``coalesce`` (or an op that coalesces), and
  ``nnz()`` counts the stored entries, as BCOO's ``nse`` does;
- an entry's order is BCOO's: ``to_sparse_coo`` lists nonzeros in row-major
  order, as ``BCOO.fromdense`` does.

Deliberate differences (ROADMAP): ``indices()`` are int64, torch's COO index
type (the reference's are int32); a coalesced tensor stores its distinct
entries only, where BCOO's ``sum_duplicates(nse=nse)`` pads back to the old
``nse`` with out-of-range indices (so ``coalesce``, ``transpose``,
``reshape``, ``slice`` and ``softmax`` can count fewer entries than the
reference); the ops record torch's autograd through the values and the
dense operands, where the reference's BCOO ops bypass its tape.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.tensor import Tensor

_SLOT = Tensor.__dict__["_data"]


def _arr(x, device=None):
    """A Tensor's torch array, or a host value as one on ``device``."""
    if isinstance(x, Tensor):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(dtype_mod.get_default_dtype().dtype)
    return dtype_mod.from_numpy(a).to(
        device if device is not None else place_mod.default_device())


def _densify(idx, val, shape):
    """BCOO.todense: scatter-add the stored entries (duplicates sum)."""
    out = torch.zeros(tuple(shape), dtype=val.dtype, device=val.device)
    if idx.shape[1] == 0:
        return out
    return out.index_put(tuple(idx), val, accumulate=True)


class _BCOOView:
    """The reference's BCOO layout of a SparseCooTensor: ``indices``
    [nse, n_sparse] and ``data`` [nse, *dense], read by code written
    against the reference's ``_bcoo``."""

    def __init__(self, t):
        self.indices = t._idx.T
        self.data = t._val
        self.shape = tuple(t._shape)
        self.nse = t._idx.shape[1]
        self.n_dense = t._val.dim() - 1
        self.ndim = len(self.shape)

    def todense(self):
        return _densify(self.indices.T, self.data, self.shape)


class SparseCooTensor(Tensor):
    """Tensor stored as COO indices and values. The dense array is made
    lazily, when a dense op reads ``_data``."""

    @classmethod
    def _wrap_coo(cls, idx, val, shape, stop_gradient=True,
                  coalesced=False):
        t = cls.__new__(cls)
        if stop_gradient and val.requires_grad:
            val = val.detach()
        _SLOT.__set__(t, None)
        t._sg = not val.requires_grad
        t._leaf = None
        t._grad_t = None
        t._grad_of = None
        t.name = None
        t.persistable = False
        t._version = 0
        t._idx = idx.to(torch.int64)
        t._val = val
        t._shape = tuple(int(s) for s in shape)
        t._coalesced = coalesced
        return t

    @property
    def _data(self):
        d = _SLOT.__get__(self)
        if d is None:
            d = _densify(self._idx, self._val, self._shape)
            _SLOT.__set__(self, d)
        return d

    @_data.setter
    def _data(self, value):
        _SLOT.__set__(self, value)

    @property
    def _coo(self):
        """The torch sparse COO tensor over the indices and values."""
        return torch.sparse_coo_tensor(
            self._idx, self._val, self._shape, is_coalesced=self._coalesced,
            check_invariants=False)

    @property
    def _bcoo(self):
        return _BCOOView(self)

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def dtype(self):
        return dtype_mod.from_torch(self._val.dtype)

    @property
    def place(self):
        return place_mod.place_of(self._val.device)

    @property
    def n_dense(self):
        return self._val.dim() - 1

    def indices(self):
        return Tensor._wrap(self._idx)

    def values(self):
        return Tensor._wrap(self._val, self._sg)

    def to_dense(self):
        return Tensor._wrap(_densify(self._idx, self._val, self._shape),
                            self._sg)

    def nnz(self):
        return int(self._idx.shape[1])

    @property
    def is_sparse_coo(self):
        return True

    def __repr__(self):
        return (f"SparseCooTensor(shape={self.shape}, nnz={self.nnz()}, "
                f"dtype={self.dtype.name}, place={self.place})")


def _like(x, val):
    """A SparseCooTensor of ``x``'s pattern holding ``val``."""
    return SparseCooTensor._wrap_coo(x._idx, val, x._shape, False,
                                     x._coalesced)


def sparse_coo_tensor(indices, values, shape=None, dtype=None,
                      place=None, stop_gradient=True):
    val = _arr(values, None if place is None else
               place_mod._parse_place(place).torch_device())
    if dtype is not None:
        val = val.to(dtype_mod.convert_dtype(dtype).torch)
    idx = _arr(indices, val.device).to(device=val.device,
                                       dtype=torch.int64)
    if shape is None:
        shape = tuple(int(i) + 1 for i in idx.amax(dim=1).tolist()) \
            + tuple(val.shape[1:])
    return SparseCooTensor._wrap_coo(idx, val, shape, stop_gradient)


def sparse_csr_tensor(crows, cols, values, shape, dtype=None, place=None,
                      stop_gradient=True):
    """CSR input, stored as COO (the reference converts the same way)."""
    crows_np = np.asarray(crows.numpy() if isinstance(crows, Tensor)
                          else crows)
    cols_np = np.asarray(cols.numpy() if isinstance(cols, Tensor)
                         else cols)
    rows = np.repeat(np.arange(len(crows_np) - 1), np.diff(crows_np))
    idx = np.stack([rows, cols_np])
    return sparse_coo_tensor(idx, values, shape, dtype, place,
                             stop_gradient)


def _fromdense(a, n_dense=0):
    """BCOO.fromdense: the nonzero sites in row-major order; a site of a
    hybrid tensor is stored when any of its dense entries is nonzero."""
    nz = a.detach() != 0
    if n_dense:
        nz = nz.flatten(a.dim() - n_dense).any(-1)
    idx = nz.nonzero().T
    return idx, a[tuple(idx)]


def to_sparse_coo(x: Tensor, sparse_dim=None):
    """Dense -> COO. sparse_dim keeps the trailing ndim-sparse_dim dims
    dense (the reference's NDHWC sparse layout stores channels dense)."""
    a = x._data
    n_dense = 0 if sparse_dim is None else a.dim() - int(sparse_dim)
    idx, val = _fromdense(a, n_dense)
    return SparseCooTensor._wrap_coo(idx, val, a.shape, x.stop_gradient,
                                     coalesced=True)


def to_dense(x):
    if isinstance(x, SparseCooTensor):
        return x.to_dense()
    return x


def _rows_cols(x):
    """A sparse tensor's [..., K] pattern as (row, col) of a 2-D matrix
    whose rows run over every dim but the last."""
    idx = x._idx
    if idx.shape[0] == 2:
        return idx[0], idx[1]
    lead = x._shape[:-1]
    row = torch.zeros_like(idx[0])
    for d, n in enumerate(lead):
        row = row * n + idx[d]
    return row, idx[-1]


def _spmm(x, ya):
    """x [..., K] sparse (no dense dims) times ya [K, ...] dense."""
    row, col = _rows_cols(x)
    m = int(np.prod(x._shape[:-1]))
    a = torch.sparse_coo_tensor(torch.stack([row, col]), x._val,
                                (m, x._shape[-1]), check_invariants=False)
    out = torch.sparse.mm(a, ya.reshape(ya.shape[0], -1))
    return out.reshape(tuple(x._shape[:-1]) + tuple(ya.shape[1:]))


def matmul(x, y, name=None):
    """Sparse x [..., K] times dense y [K, N] (reference
    ``bcoo_dot_general`` over the last dim of x): ``torch.sparse.mm``,
    differentiable in y and in x's values."""
    from .. import matmul as dense_matmul
    if not isinstance(x, SparseCooTensor):
        return dense_matmul(x, y)
    ya = _arr(y, x._val.device)
    out = torch.matmul(x._data, ya) if x.n_dense else _spmm(x, ya)
    return Tensor._wrap(out, not out.requires_grad)


def add(x, y, name=None):
    """Sparse + sparse as the reference computes it: the dense sum made
    sparse again (jax has no ``bcoo_add``)."""
    from .. import add as dense_add
    if isinstance(x, SparseCooTensor) and isinstance(y, SparseCooTensor):
        idx, val = _fromdense(x._data + y._data)
        return SparseCooTensor._wrap_coo(idx, val, x._shape, False, True)
    return dense_add(to_dense(x), to_dense(y))


def mask_as(x: Tensor, mask: SparseCooTensor):
    idx = mask._idx
    return SparseCooTensor._wrap_coo(idx, x._data[tuple(idx)], x.shape,
                                     x.stop_gradient, mask._coalesced)


# ---------------------------------------------------------------------------
# elementwise ops on the value array (all zero-preserving, so operating on
# the stored values alone is exact — reference: paddle/sparse/unary.py over
# phi sparse unary kernels)
# ---------------------------------------------------------------------------

def _on_values(name, f):
    def op(x, name=None):
        if isinstance(x, SparseCooTensor):
            return _like(x, f(x._val))
        import paddle_tpu_torch as paddle
        from ..core.dispatch import run_op
        dense = getattr(paddle, op.__name__.rstrip("_"), None)
        return dense(x) if dense is not None else run_op(op.__name__, f, x)
    op.__name__ = name
    return op


def _relu6(v):
    return torch.clamp(v, 0, 6)


sin = _on_values("sin", torch.sin)
tan = _on_values("tan", torch.tan)
asin = _on_values("asin", torch.asin)
atan = _on_values("atan", torch.atan)
sinh = _on_values("sinh", torch.sinh)
tanh = _on_values("tanh", torch.tanh)
asinh = _on_values("asinh", torch.asinh)
atanh = _on_values("atanh", torch.atanh)
sqrt = _on_values("sqrt", torch.sqrt)
square = _on_values("square", torch.square)
log1p = _on_values("log1p", torch.log1p)
abs = _on_values("abs", torch.abs)
expm1 = _on_values("expm1", torch.expm1)
neg = _on_values("neg", torch.neg)
deg2rad = _on_values("deg2rad", torch.deg2rad)
rad2deg = _on_values("rad2deg", torch.rad2deg)
relu = _on_values("relu", torch.relu)
relu6 = _on_values("relu6", _relu6)
isnan = _on_values("isnan", torch.isnan)


def leaky_relu(x, negative_slope=0.01, name=None):
    return _on_values("leaky_relu", lambda v: torch.where(
        v >= 0, v, negative_slope * v))(x)


def pow(x, factor, name=None):
    return _on_values("pow", lambda v: torch.pow(v, factor))(x)


def cast(x, index_dtype=None, value_dtype=None, name=None):
    """Casts the values (``value_dtype``); the indices stay int64, torch's
    COO index type, whatever ``index_dtype`` asks."""
    val = x._val if value_dtype is None else \
        x._val.to(dtype_mod.convert_dtype(value_dtype).torch)
    return _like(x, val)


# ---------------------------------------------------------------------------
# binary / matrix ops (reference: paddle/sparse/binary.py, multiary.py)
# ---------------------------------------------------------------------------

def _coalesced(x):
    """The tensor with duplicates summed, entries in row-major order."""
    if x._coalesced:
        return x
    c = x._coo.coalesce()
    return SparseCooTensor._wrap_coo(c.indices(), c.values(), x._shape,
                                     False, True)


def _ewise(name, f):
    """Elementwise sparse(+)sparse: same-index fast path on values, general
    path densify-merge-resparsify (reference requires same shape)."""
    def op(x, y, name=None):
        if isinstance(x, SparseCooTensor) and isinstance(y, SparseCooTensor):
            if x._idx.shape == y._idx.shape and \
                    bool(torch.equal(x._idx, y._idx)):
                return _like(x, f(x._val, y._val))
            idx, val = _fromdense(f(x._data, y._data))
            return SparseCooTensor._wrap_coo(idx, val, x._shape, False, True)
        out = f(to_dense(x)._data, to_dense(y)._data)
        return Tensor._wrap(out, not out.requires_grad)
    op.__name__ = name
    return op


subtract = _ewise("subtract", torch.subtract)
multiply = _ewise("multiply", torch.multiply)
divide = _ewise("divide", torch.true_divide)


def mv(x, vec, name=None):
    """Sparse matrix times dense vector (reference sparse mv kernel)."""
    out = _spmm(x, _arr(vec, x._val.device)[:, None])[:, 0]
    return Tensor._wrap(out, not out.requires_grad)


def masked_matmul(x, y, mask, name=None):
    """(x @ y) evaluated only at mask's nonzero coordinates (reference
    sparse masked_matmul — SDDMM): only nnz dot products are computed."""
    xa, ya = _arr(x), _arr(y)
    idx = mask._idx
    rows = xa[idx[0]]               # [nnz, K]
    cols = ya[:, idx[1]].T          # [nnz, K]
    vals = torch.sum(rows * cols, dim=-1)
    return SparseCooTensor._wrap_coo(
        idx, vals, (xa.shape[0], ya.shape[1]), False, mask._coalesced)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    """beta*input + alpha*(x@y) with sparse x (reference sparse addmm)."""
    prod = matmul(x, y)._data
    out = beta * _arr(to_dense(input), prod.device) + alpha * prod
    return Tensor._wrap(out, not out.requires_grad)


def transpose(x, perm, name=None):
    perm = [int(p) % x.ndim for p in perm]
    c = _coalesced(x)
    ns = c._idx.shape[0]
    if sorted(perm[:ns]) != list(range(ns)):
        raise ValueError("transpose cannot move a dense dim of a hybrid "
                         "sparse tensor")
    val = c._val.permute([0] + [p - ns + 1 for p in perm[ns:]]) \
        if x.n_dense else c._val
    return SparseCooTensor._wrap_coo(
        c._idx[perm[:ns]], val, [x._shape[p] for p in perm], False, False)


def sum(x, axis=None, dtype=None, keepdim=False, name=None):
    if axis is None:
        out = torch.sum(x._val)
        if keepdim:
            return to_sparse_coo(Tensor._wrap(out.reshape((1,) * x.ndim),
                                              not out.requires_grad))
        return Tensor._wrap(out, not out.requires_grad)
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(sorted(a % x.ndim for a in axes))
    if keepdim:
        dense = x._data.sum(dim=axes, keepdim=True)
        idx, val = _fromdense(dense)
        return SparseCooTensor._wrap_coo(idx, val, dense.shape, False, True)
    ns = x._idx.shape[0]
    keep = [d for d in range(ns) if d not in axes]
    dense_axes = tuple(a - ns + 1 for a in axes if a >= ns)
    val = x._val.sum(dim=dense_axes) if dense_axes else x._val
    shape = [n for d, n in enumerate(x._shape) if d not in axes]
    return SparseCooTensor._wrap_coo(x._idx[keep], val, shape, False,
                                     False)


def coalesce(x, name=None):
    return _coalesced(x)


def is_same_shape(x, y):
    return list(x.shape) == list(y.shape)


def reshape(x, shape, name=None):
    total = int(np.prod(x.shape))
    shape = [int(s) for s in shape]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape = [total // known if s == -1 else s for s in shape]
    c = _coalesced(x)
    nd = x.n_dense
    old_sp = x._shape[:len(x._shape) - nd]
    new_sp = shape[:len(shape) - nd]
    if tuple(shape[len(shape) - nd:]) != tuple(x._shape[len(x._shape) - nd:]):
        raise ValueError("reshape cannot change a hybrid tensor's dense dims")
    lin = torch.zeros_like(c._idx[0])
    for d, n in enumerate(old_sp):
        lin = lin * n + c._idx[d]
    rows = []
    for n in reversed(new_sp):
        rows.append(lin % n)
        lin = lin // n
    idx = torch.stack(rows[::-1]) if rows else c._idx[:0]
    return SparseCooTensor._wrap_coo(idx, c._val, shape, False, True)


def slice(x, axes, starts, ends, name=None):
    c = _coalesced(x)
    start = [0] * x.ndim
    sizes = list(x._shape)
    for a, s, e in zip(axes, starts, ends):
        a = int(a) % x.ndim
        n = x._shape[a]
        s = int(s) + (n if int(s) < 0 else 0)
        e = min(int(e) + (n if int(e) < 0 else 0), n)
        start[a], sizes[a] = s, e - s
    ns = c._idx.shape[0]
    keep = torch.ones(c._idx.shape[1], dtype=torch.bool,
                      device=c._idx.device)
    for d in range(ns):
        keep &= (c._idx[d] >= start[d]) & (c._idx[d] < start[d] + sizes[d])
    off = torch.tensor(start[:ns], device=c._idx.device)[:, None]
    val = c._val[keep]
    for d in range(ns, x.ndim):
        val = val.narrow(d - ns + 1, start[d], sizes[d])
    return SparseCooTensor._wrap_coo(c._idx[:, keep] - off, val, sizes,
                                     False, True)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomized PCA (Halko et al.) built on matmuls, with sparse or dense
    x (reference: paddle/sparse/__init__.py pca_lowrank). The test matrix
    comes from a generator seeded 0 on x's device, as the reference draws
    from a fixed key; its draws are torch's, not jax's."""
    dense = to_dense(x)._data
    m, n = dense.shape
    q = min(6, m, n) if q is None else int(q)
    if center:
        dense = dense - torch.mean(dense, dim=0, keepdim=True)
    gen = torch.Generator(device=dense.device).manual_seed(0)
    omega = torch.randn((n, q), generator=gen, dtype=dense.dtype,
                        device=dense.device)
    y = dense @ omega
    for _ in range(niter):
        y = dense @ (dense.T @ y)
    qmat, _ = torch.linalg.qr(y)
    b = qmat.T @ dense
    u_t, s, vt = torch.linalg.svd(b, full_matrices=False)
    u = qmat @ u_t
    sg = not u.requires_grad
    return (Tensor._wrap(u, sg), Tensor._wrap(s, sg), Tensor._wrap(vt.T, sg))


from . import nn  # noqa: E402,F401

__all__ = [
    "SparseCooTensor", "sparse_coo_tensor", "sparse_csr_tensor",
    "to_sparse_coo", "to_dense", "matmul", "add", "mask_as",
    "sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
    "sqrt", "square", "log1p", "abs", "pow", "pca_lowrank", "cast", "neg",
    "deg2rad", "rad2deg", "expm1", "mv", "masked_matmul", "addmm",
    "subtract", "transpose", "sum", "multiply", "divide", "coalesce",
    "is_same_shape", "reshape", "isnan", "slice", "nn",
]
