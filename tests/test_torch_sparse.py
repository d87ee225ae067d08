"""paddle_tpu_torch.sparse against paddle_tpu's (BCOO), on the CPU.

The same seeded numpy inputs go through both packages. Values and dense
forms agree within 1e-5 relative (f32); patterns (indices, entry order and
``nnz``) agree exactly, but where the reference pads a coalesced tensor back
to its old ``nse`` (``sum_duplicates(nse=nse)``): there the port stores the
distinct entries only, a difference logged in ROADMAP, and the test checks
it. Gradients: the reference's sparse ops are outside its tape, so its
gradients are ``jax.grad`` of the same ops on the BCOO value array and the
dense operands; the port's come from ``backward()`` through the values
Tensor (torch's gradient of ``sparse.mm`` to a sparse operand is sparse;
the values' gradient is compared entry by entry).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import paddle_tpu as P
import paddle_tpu.sparse as PS
from paddle_tpu.core.tensor import Tensor as PTensor
import paddle_tpu_torch as T
import paddle_tpu_torch.sparse as TS
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()
TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _same(tx, rx, exact_pattern=True):
    """A port result against the reference's: dense values, and for sparse
    results the stored pattern."""
    if isinstance(rx, PS.SparseCooTensor):
        assert isinstance(tx, TS.SparseCooTensor)
        assert tx.shape == rx.shape
        if exact_pattern:
            np.testing.assert_array_equal(tx.indices().numpy(),
                                          np.asarray(rx.indices().numpy()))
            assert tx.nnz() == rx.nnz()
        assert _rel(tx.to_dense().numpy(), rx.to_dense().numpy()) <= TOL
    else:
        assert _rel(tx.numpy(), rx.numpy()) <= TOL


def _pattern(seed=0, shape=(5, 6), density=0.4, dup=0):
    """A row-major pattern of round(density * size) distinct entries (the
    same count at a shape, so the reference's compiled BCOO ops are
    reused from test to test), ``dup`` of them stored twice."""
    rs = np.random.RandomState(seed)
    size = int(np.prod(shape))
    lin = np.sort(rs.permutation(size)[:round(density * size)])
    idx = np.stack(np.unravel_index(lin, shape))
    if dup:
        idx = np.concatenate([idx, idx[:, :dup]], 1)
    vals = rs.randn(idx.shape[1]).astype(np.float32)
    return idx, vals


def _both(idx, vals, shape, **kw):
    return (PS.sparse_coo_tensor(idx, vals, list(shape), **kw),
            TS.sparse_coo_tensor(idx, vals, list(shape), **kw))


def test_constructors_and_views():
    idx, vals = _pattern(dup=3)
    r, t = _both(idx, vals, (5, 6))
    _same(t, r)
    assert t.nnz() == r.nnz() == idx.shape[1]          # duplicates stored
    assert t.indices().numpy().dtype == np.int64       # reference: int32
    np.testing.assert_array_equal(t.values().numpy(), r.values().numpy())
    rs, ts = (m.sparse_coo_tensor(idx, vals) for m in (PS, TS))
    assert ts.shape == rs.shape
    crows, cols = [0, 2, 3, 5], [0, 2, 1, 0, 3]
    v = np.arange(1, 6, dtype=np.float32)
    _same(TS.sparse_csr_tensor(crows, cols, v, [3, 4]),
          PS.sparse_csr_tensor(crows, cols, v, [3, 4]))
    dense = np.random.RandomState(1).randn(2, 3, 4, 3).astype(np.float32)
    dense[np.random.RandomState(2).rand(2, 3, 4) < 0.5] = 0
    for sparse_dim in (None, 3):
        rc = PS.to_sparse_coo(P.to_tensor(dense), sparse_dim)
        tc = TS.to_sparse_coo(T.to_tensor(dense), sparse_dim)
        _same(tc, rc)
        np.testing.assert_array_equal(tc.values().numpy(),
                                      np.asarray(rc.values().numpy()))
    assert TS.to_dense(T.ones([2])).shape == [2]


UNARY = ["sin", "tan", "asin", "atan", "sinh", "tanh", "asinh", "atanh",
         "sqrt", "square", "log1p", "abs", "expm1", "neg", "deg2rad",
         "rad2deg", "relu", "relu6", "isnan"]


@pytest.mark.parametrize("name", UNARY)
def test_value_wise_ops(name):
    idx, vals = _pattern(seed=3)
    vals = np.clip(vals, -0.9, 0.9) * 7 if name == "relu6" else \
        np.clip(vals, -0.9, 0.9)
    if name in ("sqrt", "log1p"):
        vals = np.abs(vals)
    r, t = _both(idx, vals.astype(np.float32), (5, 6))
    rv, tv = getattr(PS, name)(r), getattr(TS, name)(t)
    np.testing.assert_array_equal(tv.indices().numpy(),
                                  np.asarray(rv.indices().numpy()))
    got = tv.values().numpy()
    want = np.asarray(rv.values().numpy())
    if name == "isnan":
        np.testing.assert_array_equal(got, want)
    else:
        assert _rel(got, want) <= TOL


def test_parametrised_value_ops_and_cast():
    idx, vals = _pattern(seed=4)
    r, t = _both(idx, vals, (5, 6))
    _same(TS.leaky_relu(t, 0.2), PS.leaky_relu(r, 0.2))
    _same(TS.pow(TS.abs(t), 1.5), PS.pow(PS.abs(r), 1.5))
    tc, rc = TS.cast(t, value_dtype="float16"), PS.cast(r,
                                                       value_dtype="float16")
    assert tc.values().numpy().dtype == np.float16
    np.testing.assert_array_equal(tc.values().numpy(),
                                  np.asarray(rc.values().numpy()))
    # a dense input: the port runs the dense op; the reference's fallback
    # looks the op up by its ``name`` argument, which is None, and raises
    # (ROADMAP, found in the reference)
    d = np.random.RandomState(5).randn(3, 4).astype(np.float32)
    with pytest.raises(TypeError):
        PS.sin(P.to_tensor(d))
    assert _rel(TS.sin(T.to_tensor(d)).numpy(), np.sin(d)) <= TOL


def test_binary_ops_same_pattern_and_merged():
    idx, vals = _pattern(seed=6)
    idx2, vals2 = _pattern(seed=7)
    r1, t1 = _both(idx, vals, (5, 6))
    r2, t2 = _both(idx, vals * 2 + 1, (5, 6))
    r3, t3 = _both(idx2, vals2, (5, 6))
    for name in ("subtract", "multiply", "divide"):
        _same(getattr(TS, name)(t1, t2), getattr(PS, name)(r1, r2))
    for name in ("subtract", "multiply"):
        _same(getattr(TS, name)(t1, t3), getattr(PS, name)(r1, r3))
    _same(TS.add(t1, t3), PS.add(r1, r3))
    d = np.random.RandomState(8).randn(5, 6).astype(np.float32)
    _same(TS.add(t1, T.to_tensor(d)), PS.add(r1, P.to_tensor(d)))
    _same(TS.mask_as(T.to_tensor(d), t3), PS.mask_as(P.to_tensor(d), r3))
    assert TS.is_same_shape(t1, t3) and PS.is_same_shape(r1, r3)


def test_structure_ops():
    idx, vals = _pattern(seed=9, shape=(4, 5, 6), density=0.3)
    r, t = _both(idx, vals, (4, 5, 6))
    _same(TS.transpose(t, [2, 0, 1]), PS.transpose(r, [2, 0, 1]))
    _same(TS.sum(t), PS.sum(r))
    for axis in (0, 2, (0, 1)):
        _same(TS.sum(t, axis), PS.sum(r, axis))
    _same(TS.sum(t, 0, keepdim=True), PS.sum(r, 0, keepdim=True))
    _same(TS.reshape(t, [20, -1]), PS.reshape(r, [20, -1]))
    _same(TS.slice(t, [0, 2], [1, -4], [3, 6]),
          PS.slice(r, [0, 2], [1, -4], [3, 6]), exact_pattern=False)


def test_coalesce_sums_duplicates_and_keeps_the_distinct_entries():
    idx, vals = _pattern(seed=10, dup=4)
    r, t = _both(idx, vals, (5, 6))
    rc, tc = PS.coalesce(r), TS.coalesce(t)
    assert _rel(tc.to_dense().numpy(), rc.to_dense().numpy()) <= TOL
    # the reference pads back to the stored count; the port keeps the
    # distinct entries, in the reference's (row-major) order
    assert rc.nnz() == idx.shape[1]
    assert tc.nnz() == idx.shape[1] - 4
    ri = np.asarray(rc.indices().numpy())[:, :tc.nnz()]
    np.testing.assert_array_equal(tc.indices().numpy(), ri)


def _ref_sparse(vals, idx, shape):
    return PS.SparseCooTensor._wrap_bcoo(
        jsparse.BCOO((vals, jnp.asarray(idx.T, jnp.int32)), shape=shape))


def test_matmul_mv_and_their_gradients():
    idx, vals = _pattern(seed=11, shape=(6, 5), dup=2)
    rs = np.random.RandomState(12)
    y = rs.randn(5, 3).astype(np.float32)
    up = rs.randn(6, 3).astype(np.float32)

    def ref(v, ya):
        out = PS.matmul(_ref_sparse(v, idx, (6, 5)), PTensor._wrap(ya))
        return jnp.sum(out._data * up), out._data
    (_, r_out), (r_gv, r_gy) = jax.value_and_grad(
        ref, (0, 1), has_aux=True)(jnp.asarray(vals), jnp.asarray(y))
    tv = T.to_tensor(vals, stop_gradient=False)
    ty = T.to_tensor(y, stop_gradient=False)
    x = TS.sparse_coo_tensor(idx, tv, [6, 5], stop_gradient=False)
    out = TS.matmul(x, ty)
    (out * T.to_tensor(up)).sum().backward()
    assert _rel(out.numpy(), r_out) <= TOL
    assert _rel(tv.grad.numpy(), r_gv) <= TOL          # entry by entry
    assert _rel(ty.grad.numpy(), r_gy) <= TOL
    v = rs.randn(5).astype(np.float32)
    _same(TS.mv(x, T.to_tensor(v)), PS.mv(_ref_sparse(jnp.asarray(vals),
                                                      idx, (6, 5)),
                                          P.to_tensor(v)))
    # a batched sparse operand [B, M, K]
    idx3, vals3 = _pattern(seed=13, shape=(2, 6, 5))
    r3, t3 = _both(idx3, vals3, (2, 6, 5))
    _same(TS.matmul(t3, T.to_tensor(y)), PS.matmul(r3, P.to_tensor(y)))


def test_masked_matmul_and_addmm_gradients():
    rs = np.random.RandomState(14)
    xa = rs.randn(6, 4).astype(np.float32)
    ya = rs.randn(4, 5).astype(np.float32)
    inp = rs.randn(6, 5).astype(np.float32)
    idx, vals = _pattern(seed=15, shape=(6, 5))
    up_mm = rs.randn(idx.shape[1]).astype(np.float32)
    rmask = _ref_sparse(jnp.asarray(vals), idx, (6, 5))

    def ref_mm(a, b):
        out = PS.masked_matmul(PTensor._wrap(a), PTensor._wrap(b), rmask)
        return jnp.sum(out._bcoo.data * up_mm), out._bcoo.data
    (_, r_vals), r_g = jax.value_and_grad(ref_mm, (0, 1), has_aux=True)(
        jnp.asarray(xa), jnp.asarray(ya))
    tx = T.to_tensor(xa, stop_gradient=False)
    ty = T.to_tensor(ya, stop_gradient=False)
    out = TS.masked_matmul(tx, ty, TS.sparse_coo_tensor(idx, vals, [6, 5]))
    np.testing.assert_array_equal(out.indices().numpy(), idx)
    (out.values() * T.to_tensor(up_mm)).sum().backward()
    assert _rel(out.values().numpy(), r_vals) <= TOL
    assert _rel(tx.grad.numpy(), r_g[0]) <= TOL
    assert _rel(ty.grad.numpy(), r_g[1]) <= TOL

    w = rs.randn(5, 3).astype(np.float32)
    up = rs.randn(6, 3).astype(np.float32)
    inp3 = rs.randn(6, 3).astype(np.float32)

    def ref_addmm(i, v, b):
        out = PS.addmm(PTensor._wrap(i), _ref_sparse(v, idx, (6, 5)),
                       PTensor._wrap(b), beta=0.5, alpha=2.0)
        return jnp.sum(out._data * up), out._data
    (_, r_out), r_g = jax.value_and_grad(ref_addmm, (0, 1, 2),
                                         has_aux=True)(
        jnp.asarray(inp3), jnp.asarray(vals), jnp.asarray(w))
    ti = T.to_tensor(inp3, stop_gradient=False)
    tv = T.to_tensor(vals, stop_gradient=False)
    tw = T.to_tensor(w, stop_gradient=False)
    out = TS.addmm(ti, TS.sparse_coo_tensor(idx, tv, [6, 5],
                                            stop_gradient=False),
                   tw, beta=0.5, alpha=2.0)
    (out * T.to_tensor(up)).sum().backward()
    assert _rel(out.numpy(), r_out) <= TOL
    for got, want in zip((ti.grad, tv.grad, tw.grad), r_g):
        assert _rel(got.numpy(), want) <= TOL
    assert inp.shape == (6, 5)


def test_pca_lowrank_singular_values():
    rs = np.random.RandomState(16)
    a = (rs.randn(12, 3) @ rs.randn(3, 8) + 0.01 * rs.randn(12, 8)).astype(
        np.float32)
    want = np.linalg.svd(a - a.mean(0), compute_uv=False)[:3]
    _, rs_, _ = PS.pca_lowrank(P.to_tensor(a), q=3)
    u, s, v = TS.pca_lowrank(T.to_tensor(a), q=3)
    assert _rel(s.numpy(), np.asarray(rs_.numpy())) <= 1e-4
    assert _rel(s.numpy(), want) <= 1e-4
    assert u.shape == [12, 3] and v.shape == [8, 3]
    sp = TS.to_sparse_coo(T.to_tensor(a))
    assert _rel(TS.pca_lowrank(sp, q=3, center=False)[1].numpy(),
                np.linalg.svd(a, compute_uv=False)[:3]) <= 1e-4


def _ndhwc(shape, density, seed):
    rs = np.random.RandomState(seed)
    dense = rs.randn(*shape).astype(np.float32)
    dense *= (rs.rand(*shape[:-1]) < density)[..., None]
    return dense


@pytest.mark.parametrize("kind", ["subm3d", "conv3d", "subm2d", "conv2d"])
def test_sparse_conv_layers(kind):
    ndim = 3 if kind.endswith("3d") else 2
    shape = (2, 5, 6, 4, 3) if ndim == 3 else (2, 6, 7, 3)
    dense = _ndhwc(shape, 0.3, 17)
    got = []
    for pkg, S in ((P, PS), (T, TS)):
        x = S.to_sparse_coo(pkg.to_tensor(dense), sparse_dim=ndim + 1)
        cls = {"subm3d": S.nn.SubmConv3D, "conv3d": S.nn.Conv3D,
               "subm2d": S.nn.SubmConv2D, "conv2d": S.nn.Conv2D}[kind]
        kw = {} if kind.startswith("subm") else {"stride": 2,
                                                  "padding": 1}
        layer = cls(3, 4, 3, bias_attr=False, **kw)
        got.append(layer(x))
    rx, tx = got
    _same(tx, rx)


def test_batchnorm_relu_pool_softmax_layers():
    dense = _ndhwc((2, 4, 4, 4, 3), 0.4, 18)
    outs = []
    for pkg, S in ((P, PS), (T, TS)):
        x = S.to_sparse_coo(pkg.to_tensor(dense), sparse_dim=4)
        bn = S.nn.BatchNorm(3)
        y = bn(x)
        outs.append((y, bn._mean.numpy(), bn._variance.numpy(),
                     S.nn.ReLU()(y), S.nn.MaxPool3D(2)(x)))
        bn.eval()
        outs[-1] += (bn(x),)
    for tv, rv in zip(outs[1], outs[0]):
        if isinstance(rv, np.ndarray):
            assert _rel(tv, rv) <= TOL
        else:
            _same(tv, rv)
    idx, vals = _pattern(seed=19, shape=(4, 6), density=0.5)
    r, t = _both(idx, vals, (4, 6))
    _same(TS.nn.Softmax()(t), PS.nn.Softmax()(r))


def test_attention():
    rs = np.random.RandomState(20)
    b, h, s, d = 1, 2, 8, 4
    q, k, v = (rs.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    keep = rs.rand(b * h, s, s) < 0.5
    keep |= np.eye(s, dtype=bool)[None]
    idx = np.stack(np.nonzero(keep))
    ones = np.ones(idx.shape[1], np.float32)
    kp = np.ones((b, s), np.float32)
    kp[:, -1] = 0
    outs = []
    for pkg, S in ((P, PS), (T, TS)):
        mask = S.sparse_coo_tensor(idx, ones, list(keep.shape))
        outs.append(S.nn.functional.attention(
            *(pkg.to_tensor(a) for a in (q, k, v)), mask,
            key_padding_mask=pkg.to_tensor(kp)))
    _same(outs[1], outs[0])
