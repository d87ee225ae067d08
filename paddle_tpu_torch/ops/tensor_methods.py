"""The Tensor method surface and the generated inplace variants: the port of
``paddle_tpu/ops/tensor_methods.py`` (the reference's tensor_method_func
list and its patcher), with the ``<op>_`` builder of
``paddle_tpu/ops/compat.py`` (``_INPLACE_NAMES``, ``_inplacify``)."""
from __future__ import annotations

REFERENCE_TENSOR_METHODS = [
    "abs", "abs_", "acos", "acos_", "acosh",
    "acosh_", "add", "add_", "add_n", "addmm",
    "addmm_", "all", "allclose", "amax", "amin",
    "angle", "any", "argmax", "argmin", "argsort",
    "as_complex", "as_real", "as_strided", "asin", "asin_",
    "asinh", "asinh_", "atan", "atan2", "atan_",
    "atanh", "atanh_", "atleast_1d", "atleast_2d", "atleast_3d",
    "bernoulli_", "bincount", "bitwise_and", "bitwise_and_", "bitwise_left_shift",
    "bitwise_left_shift_", "bitwise_not", "bitwise_not_", "bitwise_or", "bitwise_or_",
    "bitwise_right_shift", "bitwise_right_shift_", "bitwise_xor", "bitwise_xor_", "block_diag",
    "bmm", "broadcast_shape", "broadcast_tensors", "broadcast_to", "bucketize",
    "cast", "cast_", "cauchy_", "cdist", "ceil",
    "ceil_", "cholesky", "cholesky_inverse", "cholesky_solve", "chunk",
    "clip", "clip_", "combinations", "concat", "cond",
    "conj", "copysign", "copysign_", "corrcoef", "cos",
    "cos_", "cosh", "cosh_", "count_nonzero", "cov",
    "create_parameter", "create_tensor", "cross", "cummax", "cummin",
    "cumprod", "cumprod_", "cumsum", "cumsum_", "cumulative_trapezoid",
    "deg2rad", "diag", "diag_embed", "diagflat", "diagonal",
    "diagonal_scatter", "diff", "digamma", "digamma_", "dist",
    "divide", "divide_", "dot", "dsplit", "eig",
    "eigvals", "eigvalsh", "equal", "equal_", "equal_all",
    "erf", "erfinv", "erfinv_", "exp", "exp_",
    "expand", "expand_as", "expm1", "exponential_", "flatten",
    "flatten_", "flip", "floor", "floor_", "floor_divide",
    "floor_divide_", "floor_mod", "floor_mod_", "fmax", "fmin",
    "frac", "frac_", "frexp", "gammainc", "gammainc_",
    "gammaincc", "gammaincc_", "gammaln", "gammaln_", "gather",
    "gather_nd", "gcd", "gcd_", "geometric_", "greater_equal",
    "greater_equal_", "greater_than", "greater_than_", "heaviside", "histogram",
    "histogram_bin_edges", "histogramdd", "householder_product", "hsplit", "hypot",
    "hypot_", "i0", "i0_", "i0e", "i1",
    "i1e", "imag", "increment", "index_add", "index_add_",
    "index_fill", "index_fill_", "index_put", "index_put_", "index_sample",
    "index_select", "inner", "inverse", "is_complex", "is_empty",
    "is_floating_point", "is_integer", "is_tensor", "isclose", "isfinite",
    "isin", "isinf", "isnan", "isneginf", "isposinf",
    "isreal", "istft", "kron", "kthvalue", "lcm",
    "lcm_", "ldexp", "ldexp_", "lerp", "lerp_",
    "less_equal", "less_equal_", "less_than", "less_than_", "lgamma",
    "lgamma_", "log", "log10", "log10_", "log1p",
    "log1p_", "log2", "log2_", "log_", "log_normal_",
    "logaddexp", "logcumsumexp", "logical_and", "logical_and_", "logical_not",
    "logical_not_", "logical_or", "logical_or_", "logical_xor", "logical_xor_",
    "logit", "logit_", "logsumexp", "lstsq", "lu",
    "lu_unpack", "masked_fill", "masked_fill_", "masked_scatter", "masked_scatter_",
    "masked_select", "matmul", "matrix_power", "max", "maximum",
    "mean", "median", "min", "minimum", "mm",
    "mod", "mod_", "mode", "moveaxis", "multi_dot",
    "multigammaln", "multigammaln_", "multinomial", "multiplex", "multiply",
    "multiply_", "mv", "nan_to_num", "nan_to_num_", "nanmean",
    "nanmedian", "nanquantile", "nansum", "neg", "neg_",
    "nextafter", "nonzero", "norm", "normal_", "not_equal",
    "not_equal_", "numel", "ormqr", "outer", "pca_lowrank",
    "pinv", "polar", "polygamma", "polygamma_", "pow",
    "pow_", "prod", "put_along_axis", "put_along_axis_", "qr",
    "quantile", "rad2deg", "rank", "real", "reciprocal",
    "reciprocal_", "reduce_as", "remainder", "remainder_", "renorm",
    "renorm_", "repeat_interleave", "reshape", "reshape_", "reverse",
    "roll", "rot90", "round", "round_", "rsqrt",
    "rsqrt_", "scale", "scale_", "scatter", "scatter_",
    "scatter_nd", "scatter_nd_add", "select_scatter", "sgn", "shape",
    "shard_index", "sigmoid", "sigmoid_", "sign", "signbit",
    "sin", "sin_", "sinc", "sinc_", "sinh",
    "sinh_", "slice", "slice_scatter", "solve", "sort",
    "split", "sqrt", "sqrt_", "square", "squeeze",
    "squeeze_", "stack", "stanh", "std", "stft",
    "strided_slice", "subtract", "subtract_", "sum", "svd_lowrank",
    "t", "t_", "take", "take_along_axis", "tan",
    "tan_", "tanh", "tanh_", "tensor_split", "tensordot",
    "tile", "top_p_sampling", "topk", "trace", "transpose",
    "transpose_", "trapezoid", "triangular_solve", "tril", "tril_",
    "triu", "triu_", "trunc", "trunc_", "unbind",
    "unflatten", "unfold", "uniform_", "unique", "unique_consecutive",
    "unsqueeze", "unsqueeze_", "unstack", "vander", "var",
    "view", "view_as", "vsplit", "where", "where_",
]



def patch_from_modules():
    """Bind every listed method that exists as a module-level callable of
    paddle_tpu_torch (then of its ops.linalg) onto Tensor, without
    overriding existing bindings."""
    import paddle_tpu_torch as P
    from ..core.tensor import Tensor
    from . import linalg

    patched = []
    for name in REFERENCE_TENSOR_METHODS:
        if hasattr(Tensor, name):
            continue
        for src in (P, linalg):
            fn = getattr(src, name, None)
            if callable(fn):
                setattr(Tensor, name, fn)
                patched.append(name)
                break
    return patched


def _inplacify(fn, name):
    """An out-of-place op as ``<op>_`` (ops.yaml inplace semantics): the
    result is rebound onto x with a version bump, and autograd follows it
    as for run_op_inplace."""
    from ..core.dispatch import rebind_inplace

    def op(x, *args, **kw):
        res = fn(x, *args, **kw)
        res = res[0] if isinstance(res, tuple) else res
        return rebind_inplace(x, res)
    op.__name__ = name
    op.__qualname__ = name
    op.__doc__ = f"Inplace variant of `{fn.__name__}`."
    return op


#: the out-of-place ops that get a generated ``<op>_``
INPLACE_NAMES = [
    # math unary
    "abs", "acos", "asin", "atan", "cos", "tan", "sin", "sinh", "cosh",
    "tanh", "asinh", "acosh", "atanh", "ceil", "floor", "round", "trunc",
    "frac", "expm1", "log", "log2", "log10", "log1p", "neg", "square",
    "lgamma", "digamma", "erf", "erfinv", "i0", "logit", "nan_to_num",
    "reciprocal", "rsqrt", "sigmoid",
    # math binary
    "floor_divide", "remainder", "mod", "floor_mod", "pow", "gcd", "lcm",
    "hypot", "copysign", "ldexp", "cumsum", "cumprod",
    # logic / bitwise
    "logical_and", "logical_or", "logical_not", "logical_xor",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal",
    # manipulation
    "tril", "triu", "index_add", "index_put", "index_fill",
    "masked_scatter", "t",
    # linalg / misc
    "addmm", "renorm", "polygamma", "multigammaln", "sinc",
    "gammainc", "gammaincc", "gammaln",
    "lerp", "put_along_axis", "transpose",
]


def build_inplace_variants(namespace):
    """``<name>_`` for every name of INPLACE_NAMES found in namespace, as a
    dict of the created functions."""
    return {n + "_": _inplacify(namespace[n], n + "_")
            for n in INPLACE_NAMES if callable(namespace.get(n))}
