"""paddle_tpu_torch.distribution against paddle_tpu's, on the CPU.

Every family, transform and registered KL of the reference is built on the
same seeded float64 parameters in both packages (the reference under
``jax.enable_x64``). ``log_prob``, ``prob``, ``entropy``,
``mean``, ``variance`` and ``cdf`` (where the family has them), each
transform's ``forward``/``inverse``/``forward_log_det_jacobian`` and the
KLs with their gradients in the parameters agree within 1e-10 relative
(f64). Draws differ by design (the port draws from torch's generators):
a sample's shape is the sample shape, then the reference's batch and event
shapes, and the mean and variance of 2^15 draws
lie within 6 standard errors of the family's. The gamma family's
``rsample`` is differentiable: the mean of d(draw)/d(parameter) over 2^14
draws lies within 5 % of d(mean)/d(parameter), and ``log_prob``'s gradients
equal the reference's at fixed values.
"""
import numpy as np
import pytest

import jax

import paddle_tpu as P
import paddle_tpu.distribution as PD
import paddle_tpu_torch as T
import paddle_tpu_torch.distribution as TD
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()
TOL = 1e-10


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(7)
    with jax.enable_x64(True):
        yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - want[fin]).max()
                 / max(np.abs(want[fin]).max(), 1e-300))


RS = np.random.RandomState(0)
F8 = np.float64


def _pos(*shape):
    return (RS.rand(*shape) * 2 + 0.5).astype(F8)


def _unit(*shape):
    return (RS.rand(*shape) * 0.8 + 0.1).astype(F8)


def _chol(n, d):
    a = RS.randn(n, d, d)
    c = a @ a.transpose(0, 2, 1) + d * np.eye(d)
    return c, np.linalg.cholesky(c)


def _corr_chol(n, d):
    c, _ = _chol(n, d)
    s = np.sqrt(np.einsum("nii->ni", c))
    return np.linalg.cholesky(c / s[:, :, None] / s[:, None, :])


_COV, _TRIL = _chol(2, 3)
_P4 = np.full((4, 3), [0.2, 0.3, 0.5])
# name -> (params, build(D, t, params), value, methods)
CASES = {
    "Normal": ((RS.randn(4), _pos(4)),
               lambda D, t, p: D.Normal(t(p[0]), t(p[1])),
               RS.randn(3, 4), ("entropy", "mean", "variance")),
    "Uniform": ((-_pos(4), _pos(4)),
                lambda D, t, p: D.Uniform(t(p[0]), t(p[1])),
                np.array([-0.1, 0.2, 3.0, 0.0]), ("entropy",)),
    "Bernoulli": ((_unit(4),), lambda D, t, p: D.Bernoulli(t(p[0])),
                  np.array([0.0, 1.0, 1.0, 0.0]), ("entropy", "mean")),
    "Categorical": ((RS.randn(4, 5),),
                    lambda D, t, p: D.Categorical(logits=t(p[0])),
                    np.array([0, 4, 2, 1]), ("entropy",)),
    "Exponential": ((_pos(4),), lambda D, t, p: D.Exponential(t(p[0])),
                    _pos(4), ("entropy",)),
    "Gamma": ((_pos(4), _pos(4)),
              lambda D, t, p: D.Gamma(t(p[0]), t(p[1])), _pos(4), ()),
    "Beta": ((_pos(4), _pos(4)), lambda D, t, p: D.Beta(t(p[0]), t(p[1])),
             _unit(4), ()),
    "Dirichlet": ((_pos(4, 3),), lambda D, t, p: D.Dirichlet(t(p[0])),
                  _P4, ()),
    "Laplace": ((RS.randn(4), _pos(4)),
                lambda D, t, p: D.Laplace(t(p[0]), t(p[1])), RS.randn(4),
                ()),
    "Gumbel": ((RS.randn(4), _pos(4)),
               lambda D, t, p: D.Gumbel(t(p[0]), t(p[1])), RS.randn(4), ()),
    "LogNormal": ((RS.randn(4), _pos(4)),
                  lambda D, t, p: D.LogNormal(t(p[0]), t(p[1])), _pos(4),
                  ()),
    "Multinomial": ((_P4,), lambda D, t, p: D.Multinomial(5, t(p[0])),
                    np.array([[1., 2., 2.], [0., 0., 5.], [3., 1., 1.],
                              [2., 2., 1.]]), ()),
    "Geometric": ((_unit(4),), lambda D, t, p: D.Geometric(t(p[0])),
                  np.array([1., 2., 5., 3.]), ()),
    "Poisson": ((np.array([0.5, 3.0, 40.0, 150.0]),),
                lambda D, t, p: D.Poisson(t(p[0])),
                np.array([0., 2., 37., 160.]),
                ("entropy", "mean", "variance")),
    "Binomial": ((np.array([5., 10., 3., 8.]), _unit(4)),
                 lambda D, t, p: D.Binomial(t(p[0]), t(p[1])),
                 np.array([2., 7., 0., 8.]), ("mean", "variance")),
    "Cauchy": ((RS.randn(4), _pos(4)),
               lambda D, t, p: D.Cauchy(t(p[0]), t(p[1])), RS.randn(4),
               ("entropy", "cdf")),
    "Chi2": ((_pos(4) * 3,), lambda D, t, p: D.Chi2(t(p[0])), _pos(4), ()),
    "StudentT": ((_pos(4) * 3, RS.randn(4), _pos(4)),
                 lambda D, t, p: D.StudentT(t(p[0]), t(p[1]), t(p[2])),
                 RS.randn(4), ("mean", "variance")),
    "MultivariateNormal": ((RS.randn(2, 3), _TRIL),
                           lambda D, t, p: D.MultivariateNormal(
                               t(p[0]), scale_tril=t(p[1])),
                           RS.randn(2, 3),
                           ("entropy", "mean", "covariance_matrix")),
    "MultivariateNormalCov": ((RS.randn(2, 3), _COV),
                              lambda D, t, p: D.MultivariateNormal(
                                  t(p[0]), covariance_matrix=t(p[1])),
                              RS.randn(2, 3), ("entropy",)),
    # unbatched: the reference's precision path transposes with ``.T``,
    # which reverses a batched matrix's batch dims too, and raises
    "MultivariateNormalPrec": ((RS.randn(3), _COV[0]),
                               lambda D, t, p: D.MultivariateNormal(
                                   t(p[0]), precision_matrix=t(p[1])),
                               RS.randn(3), ("entropy",)),
    "ContinuousBernoulli": ((np.array([0.2, 0.4995, 0.5, 0.9]),),
                            lambda D, t, p: D.ContinuousBernoulli(t(p[0])),
                            _unit(4), ("mean",)),
    "Independent": ((RS.randn(3, 4), _pos(3, 4)),
                    lambda D, t, p: D.Independent(
                        D.Normal(t(p[0]), t(p[1])), 1),
                    RS.randn(3, 4), ("entropy", "mean", "variance")),
    "Transformed": ((RS.randn(4), _pos(4)),
                    lambda D, t, p: D.TransformedDistribution(
                        D.Normal(t(p[0]), t(p[1])),
                        [D.AffineTransform(t(np.array(0.5)),
                                           t(np.array(2.0))),
                         D.ExpTransform()]),
                    _pos(4), ()),
    "LKJCholesky": ((_pos(2),),
                    lambda D, t, p: D.LKJCholesky(3, t(p[0])),
                    _corr_chol(2, 3), ()),
}


def _t(pkg):
    return lambda a: pkg.to_tensor(np.asarray(a), dtype=str(
        np.asarray(a).dtype))


def _value(v):
    return v if v.dtype.kind in "iu" else v.astype(F8)


def _pair(name):
    params, build, value, methods = CASES[name]
    params = tuple(np.asarray(p, F8) for p in params)
    return (build(PD, _t(P), params), build(TD, _t(T), params),
            _value(np.asarray(value)), methods)


def _num(x):
    return x.numpy() if hasattr(x, "numpy") else np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_family_matches_the_reference(name):
    rd, td, value, methods = _pair(name)
    assert td.batch_shape == rd.batch_shape
    assert td.event_shape == rd.event_shape
    for meth in ("log_prob", "prob"):
        got = getattr(td, meth)(_t(T)(value)).numpy()
        want = getattr(rd, meth)(_t(P)(value)).numpy()
        assert got.dtype == np.float64
        assert _rel(got, want) <= TOL, meth
    for meth in methods:
        if meth == "cdf":
            got = td.cdf(_t(T)(value)).numpy()
            want = rd.cdf(_t(P)(value)).numpy()
        else:
            got, want = getattr(td, meth), getattr(rd, meth)
            got, want = (_num(got() if callable(got) else got),
                         _num(want() if callable(want) else want))
        assert _rel(got, want) <= TOL, meth


TRANSFORMS = {
    "Affine": lambda D, t: D.AffineTransform(t(np.array([0.5, -1.0])),
                                             t(np.array([2.0, -0.5]))),
    "Exp": lambda D, t: D.ExpTransform(),
    "Power": lambda D, t: D.PowerTransform(t(np.array(3.0))),
    "Sigmoid": lambda D, t: D.SigmoidTransform(),
    "Tanh": lambda D, t: D.TanhTransform(),
    "StickBreaking": lambda D, t: D.StickBreakingTransform(),
    "Chain": lambda D, t: D.ChainTransform(
        [D.AffineTransform(t(np.array(0.3)), t(np.array(1.5))),
         D.StickBreakingTransform()]),
    "Independent": lambda D, t: D.IndependentTransform(D.TanhTransform(),
                                                       1),
    "Reshape": lambda D, t: D.ReshapeTransform((2,), (2, 1)),
    "Stack": lambda D, t: D.StackTransform(
        [D.ExpTransform(), D.TanhTransform()], axis=1),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_the_reference(name):
    x = (np.random.RandomState(3).rand(3, 2) * 0.8 + 0.1).astype(F8)
    rt, tt = TRANSFORMS[name](PD, _t(P)), TRANSFORMS[name](TD, _t(T))
    ry, ty = rt.forward(_t(P)(x)), tt.forward(_t(T)(x))
    assert _rel(ty.numpy(), ry.numpy()) <= TOL
    assert _rel(tt.inverse(ty).numpy(), rt.inverse(ry).numpy()) <= TOL
    assert _rel(tt.inverse(ty).numpy(), x) <= 1e-9
    assert _rel(tt.forward_log_det_jacobian(_t(T)(x)).numpy(),
                rt.forward_log_det_jacobian(_t(P)(x)).numpy()) <= TOL
    assert tt.forward_shape((3, 2)) == rt.forward_shape((3, 2))
    assert tt.inverse_shape(tt.forward_shape((3, 2))) == \
        rt.inverse_shape(rt.forward_shape((3, 2)))
    assert (tt._domain_event_rank, tt._codomain_event_rank) == \
        (rt._domain_event_rank, rt._codomain_event_rank)


def test_surjections_abs_and_softmax():
    x = np.random.RandomState(4).randn(3, 4)
    for name in ("AbsTransform", "SoftmaxTransform"):
        rt, tt = getattr(PD, name)(), getattr(TD, name)()
        ry, ty = rt.forward(_t(P)(x)), tt.forward(_t(T)(x))
        assert _rel(ty.numpy(), ry.numpy()) <= TOL
        assert _rel(tt.inverse(ty).numpy(), rt.inverse(ry).numpy()) <= TOL
        with pytest.raises(NotImplementedError):
            tt.forward_log_det_jacobian(_t(T)(x))


KLS = {
    "Normal": ("Normal", "Normal"),
    "Categorical": ("Categorical", "Categorical"),
    "Bernoulli": ("Bernoulli", "Bernoulli"),
    "Uniform": ("Uniform", None),
    "Poisson": ("Poisson", "Poisson"),
    "Cauchy": ("Cauchy", "Cauchy"),
    "MultivariateNormal": ("MultivariateNormal", "MultivariateNormal"),
}


def _kl_params(name, seed):
    params, build, _, _ = CASES[name]
    rs = np.random.RandomState(seed)
    out = []
    for p in params:
        p = np.asarray(p, F8)
        if name == "MultivariateNormal" and p.ndim == 3:
            out.append(_chol(2, 3)[1])
        elif name == "Uniform":
            out.append(p * (1.5 if seed else 1.0))
        else:
            jit = rs.rand(*p.shape) * 0.2 + 0.9
            out.append(p * jit if (p > 0).all() else p + rs.randn(*p.shape))
    return tuple(out), build


@pytest.mark.parametrize("name", sorted(KLS))
def test_registered_kl_and_its_gradients(name):
    (pp, build), (qp, _) = _kl_params(name, 0), _kl_params(name, 1)
    got = []
    for pkg, D in ((P, PD), (T, TD)):
        leaves = [pkg.to_tensor(a, dtype="float64", stop_gradient=False)
                  for a in pp + qp]
        n = len(pp)
        p = build(D, lambda a, it=iter(leaves[:n]): next(it), pp)
        q = build(D, lambda a, it=iter(leaves[n:]): next(it), qp)
        kl = D.kl_divergence(p, q)
        kl.sum().backward()
        got.append((kl.numpy(), [x.grad.numpy() for x in leaves]))
    (rk, rg), (tk, tg) = got
    assert _rel(tk, rk) <= TOL
    for a, b in zip(tg, rg):
        assert _rel(a, b) <= 1e-9


MOMENTS = {  # name -> (mean, variance) of the CASES parameters, numpy
    "Normal": lambda p: (p[0], p[1] ** 2),
    "Uniform": lambda p: ((p[0] + p[1]) / 2, (p[1] - p[0]) ** 2 / 12),
    "Bernoulli": lambda p: (p[0], p[0] * (1 - p[0])),
    "Exponential": lambda p: (1 / p[0], 1 / p[0] ** 2),
    "Gamma": lambda p: (p[0] / p[1], p[0] / p[1] ** 2),
    "Beta": lambda p: (p[0] / (p[0] + p[1]), p[0] * p[1] / (
        (p[0] + p[1]) ** 2 * (p[0] + p[1] + 1))),
    "Laplace": lambda p: (p[0], 2 * p[1] ** 2),
    "Gumbel": lambda p: (p[0] + 0.5772156649015329 * p[1],
                         np.pi ** 2 / 6 * p[1] ** 2),
    "LogNormal": lambda p: (p[0], p[1] ** 2),      # of the draws' log
    "Geometric": lambda p: (1 / p[0], (1 - p[0]) / p[0] ** 2),
    "Poisson": lambda p: (p[0], p[0]),
    "Binomial": lambda p: (p[0] * p[1], p[0] * p[1] * (1 - p[1])),
    "Chi2": lambda p: (p[0], 2 * p[0]),
    "ContinuousBernoulli": None,
}


@pytest.mark.parametrize("name", sorted(k for k, v in MOMENTS.items()
                                        if v is not None))
def test_sample_shapes_and_moments(name):
    rd, td, _, _ = _pair(name)
    n = 1 << 15
    s = td.sample([n]).numpy()
    assert s.shape == (n,) + tuple(td.batch_shape)
    if name == "LogNormal":       # heavy-tailed: its log is the Normal
        s = np.log(s)
    params = tuple(np.asarray(p, F8) for p in CASES[name][0])
    mean, var = MOMENTS[name](params)
    se = np.sqrt(var / n)
    assert (np.abs(s.mean(0) - mean) <= 6 * se).all(), name
    # the sample variance's standard error needs the fourth moment; the
    # spread of per-block variances estimates it
    blocks = s.reshape(32, -1, *s.shape[1:]).var(1)
    se_v = blocks.std(0) / np.sqrt(32) + 1e-12
    assert (np.abs(s.var(0) - var) <= 6 * se_v + 1e-3 * var).all(), name


def test_other_sample_shapes():
    for name in ("Categorical", "Dirichlet", "Multinomial", "Cauchy",
                 "StudentT", "MultivariateNormal", "LKJCholesky",
                 "Independent", "Transformed"):
        rd, td, _, _ = _pair(name)
        assert td.sample([3]).shape == \
            [3, *rd.batch_shape, *rd.event_shape], name
    lkj = _pair("LKJCholesky")[1].sample([5]).numpy()
    np.testing.assert_allclose(np.einsum("...ij,...ij->...i", lkj, lkj), 1,
                               atol=1e-9)          # unit rows: correlations


@pytest.mark.parametrize("name", ["Gamma", "Chi2", "Beta", "StudentT"])
def test_gamma_family_rsample_is_differentiable(name):
    if name == "Gamma":
        a = T.to_tensor(np.full(4, 2.5), dtype="float64",
                        stop_gradient=False)
        d, dmean = TD.Gamma(a, T.to_tensor(np.full(4, 2.0),
                                           dtype="float64")), 0.5
    elif name == "Chi2":
        a = T.to_tensor(np.full(4, 3.0), dtype="float64",
                        stop_gradient=False)
        d, dmean = TD.Chi2(a), 1.0
    elif name == "Beta":
        a = T.to_tensor(np.full(4, 2.0), dtype="float64",
                        stop_gradient=False)
        d, dmean = TD.Beta(a, T.to_tensor(np.full(4, 3.0),
                                          dtype="float64")), 3.0 / 25.0
    else:
        a = T.to_tensor(np.zeros(4), dtype="float64", stop_gradient=False)
        d, dmean = TD.StudentT(T.to_tensor(np.full(4, 5.0),
                                           dtype="float64"), a), 1.0
    n = 1 << 14
    d.rsample([n]).sum().backward()
    g = a.grad.numpy() / n
    # the per-draw derivative's coefficient of variation is below 0.7 for
    # these parameters, so 5 % is over 10 standard errors of the mean
    assert np.isfinite(g).all()
    assert (np.abs(g - dmean) <= 0.05 * abs(dmean)).all(), (name, g)


def test_gamma_family_log_prob_gradients_match_the_reference():
    v = _pos(4)
    conc, rate = _pos(4), _pos(4)
    got = []
    for pkg, D in ((P, PD), (T, TD)):
        a = pkg.to_tensor(conc, dtype="float64", stop_gradient=False)
        r = pkg.to_tensor(rate, dtype="float64", stop_gradient=False)
        D.Gamma(a, r).log_prob(pkg.to_tensor(v, dtype="float64")) \
            .sum().backward()
        got.append((a.grad.numpy(), r.grad.numpy()))
    for x, y in zip(got[1], got[0]):
        assert _rel(x, y) <= 1e-9


def test_unregistered_kl_raises():
    with pytest.raises(NotImplementedError):
        TD.kl_divergence(TD.Normal(0.0, 1.0), TD.Cauchy(0.0, 1.0))
    with pytest.raises(NotImplementedError):
        TD.Gamma(1.0, 1.0).entropy()
