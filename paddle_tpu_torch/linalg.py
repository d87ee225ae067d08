"""paddle.linalg: the port of ``paddle_tpu/linalg.py`` (reference:
python/paddle/linalg.py re-exports)."""
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cholesky_inverse, cond, corrcoef, cov, det,
    eig, eigh, eigvals, eigvalsh, householder_product, inv, lstsq, lu,
    lu_unpack, matrix_norm, matrix_power, matrix_rank, multi_dot, norm,
    ormqr, pca_lowrank, pinv, qr, slogdet, solve, svd, svd_lowrank,
    triangular_solve, vector_norm,
)
from .ops.linalg import matmul  # noqa: F401
from .ops.linalg import (  # noqa: F401
    matrix_exp, fp8_fp8_half_gemm_fused,
)
