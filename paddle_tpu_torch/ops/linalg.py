"""Linear algebra ops: the port of ``paddle_tpu/ops/linalg.py`` (reference:
python/paddle/tensor/linalg.py), on ``torch.linalg``."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.tensor import Tensor


def promoted(*arrays):
    """The operands cast to their common dtype: jnp's products promote mixed
    dtypes (f32 x bf16 is f32), where torch's refuse them."""
    dt = arrays[0].dtype
    for a in arrays[1:]:
        dt = torch.promote_types(dt, a.dtype)
    return [a if a.dtype == dt else a.to(dt) for a in arrays]


def _matmul(a, b):
    return torch.matmul(*promoted(a, b))


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    def f(a, b):
        if transpose_x and a.dim() > 1:
            a = a.transpose(-1, -2)
        if transpose_y and b.dim() > 1:
            b = b.transpose(-1, -2)
        return _matmul(a, b)
    return run_op("matmul", f, x, y)


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return run_op("bmm", _matmul, x, y)


def mv(x, vec, name=None):
    return run_op("mv", _matmul, x, vec)


def dot(x, y, name=None):
    return run_op("dot", lambda a, b: torch.sum(a * b, dim=-1), x, y)


def cross(x, y, axis=9, name=None):
    def f(a, b):
        ax = next(i for i, s in enumerate(a.shape) if s == 3) if axis == 9 \
            else axis
        return torch.linalg.cross(a, b, dim=ax)
    return run_op("cross", f, x, y)


def multi_dot(x, name=None):
    return run_op("multi_dot", lambda *xs: torch.linalg.multi_dot(xs),
                  *list(x))


def _ax(axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def norm(x, p=None, axis=None, keepdim=False, name=None):
    def f(a):
        if p is None or p == "fro":
            if axis is None:
                return torch.sqrt(torch.sum(torch.square(a)))
            return torch.linalg.norm(a, dim=_ax(axis), keepdim=keepdim)
        if p == "nuc":
            return torch.linalg.matrix_norm(a, "nuc", dim=_ax(axis),
                                            keepdim=keepdim)
        if p in (np.inf, -np.inf) and axis is None:
            amax = torch.amax if p > 0 else torch.amin
            return amax(torch.abs(a))
        from .math import jax_abs       # math imports this module
        if axis is None:
            return torch.pow(torch.sum(torch.pow(jax_abs(a), p)), 1.0 / p)
        if p == 1:
            # jnp.linalg.norm's sum of abs: abs'(0) = 1, as jax's
            return torch.sum(jax_abs(a), dim=_ax(axis), keepdim=keepdim)
        return torch.linalg.norm(a, p, dim=_ax(axis), keepdim=keepdim)
    return run_op("norm", f, x)


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    return run_op("vector_norm",
                  lambda a: torch.linalg.vector_norm(a, p, dim=_ax(axis),
                                                     keepdim=keepdim), x)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    return run_op("matrix_norm",
                  lambda a: torch.linalg.matrix_norm(a, p, keepdim=keepdim),
                  x)


def dist(x, y, p=2, name=None):
    def f(a, b):
        d = (a - b).reshape(-1)
        if p == 1:
            from .math import jax_abs
            return torch.sum(jax_abs(d))
        return torch.linalg.vector_norm(d, p)
    return run_op("dist", f, x, y)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    def f(a, b):
        diff = a[..., :, None, :] - b[..., None, :, :]
        if p == 2.0:
            return torch.sqrt(torch.sum(diff * diff, -1) + 1e-30)
        return torch.pow(torch.sum(torch.pow(torch.abs(diff), p), -1),
                         1.0 / p)
    return run_op("cdist", f, x, y)


def t(x, name=None):
    if x.ndim > 2:
        raise ValueError("paddle.t only supports ndim <= 2")
    return run_op("t", lambda a: a.permute(*range(a.dim() - 1, -1, -1)), x)


def cholesky(x, upper=False, name=None):
    return run_op("cholesky",
                  lambda a: torch.linalg.cholesky(a, upper=upper), x)


def cholesky_solve(x, y, upper=False, name=None):
    return run_op("cholesky_solve",
                  lambda b, l: torch.cholesky_solve(b, l, upper=upper), x, y)


def cholesky_inverse(x, upper=False, name=None):
    return run_op("cholesky_inverse",
                  lambda l: torch.cholesky_inverse(l, upper=upper), x)


def inverse(x, name=None):
    return run_op("inverse", torch.linalg.inv, x)


inv = inverse


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return run_op("pinv",
                  lambda a: torch.linalg.pinv(a, rtol=rcond,
                                              hermitian=hermitian), x)


def solve(x, y, name=None):
    def f(a, b):
        if b.dim() == a.dim() - 1:
            return torch.linalg.solve(a, b[..., None])[..., 0]
        return torch.linalg.solve(a, b)
    return run_op("solve", f, x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    def f(a, b):
        if transpose:
            return torch.linalg.solve_triangular(
                a.mT, b, upper=not upper, unitriangular=unitriangular)
        return torch.linalg.solve_triangular(a, b, upper=upper,
                                             unitriangular=unitriangular)
    return run_op("triangular_solve", f, x, y)


def lstsq(x, y, rcond=None, driver=None, name=None):
    """(solution, residuals, rank, singular values) as the reference's
    jnp.linalg.lstsq gives them: the residuals are the squared norm of
    b - a x over the rows, whatever the rank (torch leaves them empty
    unless m > n and a has full rank, and on CUDA gives no rank or
    singular values)."""
    def f(a, b):
        sol = torch.linalg.lstsq(a, b, rcond=rcond, driver=driver).solution
        resid = torch.sum((b - a @ sol) ** 2, dim=0)
        return (sol, resid, torch.linalg.matrix_rank(a).to(torch.int32),
                torch.linalg.svdvals(a))
    return run_op("lstsq", f, x, y)


def qr(x, mode="reduced", name=None):
    if mode == "r":
        return run_op("qr_r", lambda a: torch.linalg.qr(a, mode="r").R, x)
    return run_op("qr", lambda a: tuple(torch.linalg.qr(a, mode=mode)), x)


def svd(x, full_matrices=False, name=None):
    return run_op("svd",
                  lambda a: tuple(torch.linalg.svd(
                      a, full_matrices=full_matrices)), x)


def _lowrank(a, k):
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    k = min(k, s.shape[-1])
    return u[..., :k], s[..., :k], vh[..., :k, :].transpose(-1, -2)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    return run_op("svd_lowrank", lambda a: _lowrank(a, q), x)


def eig(x, name=None):
    """General eig runs on the host, as in the reference."""
    w, v = np.linalg.eig(dtype_mod.to_numpy(x._data))
    dev = x._data.device
    return (Tensor._wrap(torch.from_numpy(w).to(dev)),
            Tensor._wrap(torch.from_numpy(v).to(dev)))


def eigvals(x, name=None):
    w = np.linalg.eigvals(dtype_mod.to_numpy(x._data))
    return Tensor._wrap(torch.from_numpy(w).to(x._data.device))


def eigh(x, UPLO="L", name=None):
    return run_op("eigh", lambda a: tuple(torch.linalg.eigh(a, UPLO=UPLO)), x)


def eigvalsh(x, UPLO="L", name=None):
    return run_op("eigvalsh", lambda a: torch.linalg.eigvalsh(a, UPLO=UPLO),
                  x)


def matrix_power(x, n, name=None):
    return run_op("matrix_power",
                  lambda a: torch.linalg.matrix_power(a, n), x)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return run_op("matrix_rank",
                  lambda a: torch.linalg.matrix_rank(a, rtol=tol,
                                                     hermitian=hermitian),
                  x, differentiable=False)


def det(x, name=None):
    return run_op("det", torch.linalg.det, x)


def slogdet(x, name=None):
    def f(a):
        sign, logdet = torch.linalg.slogdet(a)
        return torch.stack([sign, logdet], 0)
    return run_op("slogdet", f, x)


def lu(x, pivot=True, get_infos=False, name=None):
    # torch's pivots are already 1-based, as the reference makes them
    outs = run_op("lu", lambda a: tuple(torch.linalg.lu_factor(a)), x)
    if get_infos:
        info = Tensor._wrap(torch.zeros((), dtype=torch.int32,
                                        device=x._data.device))
        return outs[0], outs[1], info
    return outs


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    return run_op("lu_unpack",
                  lambda lu_, piv: tuple(torch.lu_unpack(lu_, piv)), x, y)


def cond(x, p=None, name=None):
    return run_op("cond", lambda a: torch.linalg.cond(a, p), x,
                  differentiable=False)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return run_op("cov",
                  lambda a: torch.cov(a if rowvar else a.T,
                                      correction=1 if ddof else 0), x)


def corrcoef(x, rowvar=True, name=None):
    return run_op("corrcoef",
                  lambda a: torch.corrcoef(a if rowvar else a.T), x)


def householder_product(x, tau, name=None):
    return run_op("householder_product", torch.linalg.householder_product,
                  x, tau)


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    def f(a):
        m, n = a.shape[-2:]
        k = q if q is not None else min(6, m, n)
        b = a - torch.mean(a, dim=-2, keepdim=True) if center else a
        return _lowrank(b, k)
    return run_op("pca_lowrank", f, x)


def einsum(equation, *operands):
    ops_list = list(operands[0]) if len(operands) == 1 and \
        isinstance(operands[0], (list, tuple)) else list(operands)
    return run_op("einsum",
                  lambda *xs: torch.einsum(equation, *promoted(*xs)),
                  *ops_list)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    return run_op("ormqr",
                  lambda a, t_, other: torch.ormqr(a, t_, other, left=left,
                                                   transpose=transpose),
                  x, tau, y)


def matrix_exp(x, name=None):
    return run_op("matrix_exp", torch.linalg.matrix_exp, x)


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", act="identity",
                            name=None):
    """FP8 x FP8 -> half GEMM (reference linalg.fp8_fp8_half_gemm_fused):
    both operands rounded to e4m3, multiplied with f32 sums."""
    out_dt = dtype_mod.torch_dtype(str(output_dtype).replace("paddle.", ""))

    def f(a, b, *rest):
        a8 = a.to(torch.float8_e4m3fn).float()
        b8 = b.to(torch.float8_e4m3fn).float()
        if transpose_x:
            a8 = a8.transpose(-1, -2)
        if transpose_y:
            b8 = b8.transpose(-1, -2)
        out = torch.matmul(a8, b8) * scale
        if rest:
            out = out + rest[0].float()
        if act == "gelu":
            out = torch.nn.functional.gelu(out)
        elif act == "relu":
            out = torch.relu(out)
        return out.to(out_dt)
    args = (x, y) + ((bias,) if bias is not None else ())
    return run_op("fp8_fp8_half_gemm_fused", f, *args)
