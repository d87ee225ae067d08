"""Additional distribution families completing the reference inventory
(python/paddle/distribution/: poisson, binomial, cauchy, chi2,
student_t, multivariate_normal, continuous_bernoulli,
exponential_family, independent, transformed_distribution,
lkj_cholesky).

Port of ``paddle_tpu/distribution/families.py``: the same idiom as
``__init__`` — draws from the port's generators, log_prob/entropy as ops
through ``run_op``.
"""
from __future__ import annotations

import math

import torch

import paddle_tpu_torch as paddle
from ..core.dispatch import run_op
from ..core.tensor import Tensor
from . import (  # noqa: E402
    Distribution, Gamma, _bshape, _clip_p, _gamma, _gen, _normal, _shape,
    _t, _uniform, register_kl,
)


class ExponentialFamily(Distribution):
    """Base for exponential-family distributions (reference
    exponential_family.py): entropy via the Bregman divergence of the
    log-normalizer, its gradient over the natural parameters taken with
    ``torch.autograd.grad``."""

    @property
    def _natural_parameters(self):
        raise NotImplementedError

    def _log_normalizer(self, *natural_params):
        raise NotImplementedError

    @property
    def _mean_carrier_measure(self):
        return 0.0

    def entropy(self):
        nat = [p.detach() if isinstance(p, Tensor) else _t(p)
               for p in self._natural_parameters]

        def f(*nat):
            with torch.enable_grad():
                leaves = [n.detach().requires_grad_(True) for n in nat]
                lg = self._log_normalizer(*leaves)
                grads = torch.autograd.grad(lg.sum(), leaves)
            ent = lg.detach() - self._mean_carrier_measure
            for n, g in zip(nat, grads):
                ent = ent - n * g
            return ent
        return run_op("expfam_entropy", f, *nat)


class Poisson(ExponentialFamily):
    def __init__(self, rate, name=None):
        self.rate = _t(rate)
        super().__init__(tuple(self.rate.shape))

    def sample(self, shape=()):
        gen = _gen(self.rate)
        shp = _shape(shape, self.batch_shape)
        return run_op(
            "poisson_sample",
            lambda r: torch.poisson(r.broadcast_to(shp).contiguous(),
                                    generator=gen),
            self.rate, differentiable=False)

    def log_prob(self, value):
        return run_op(
            "poisson_log_prob",
            lambda v, r: v * torch.log(r) - r - torch.lgamma(v + 1.0),
            _t(value), self.rate)

    @property
    def mean(self):
        return self.rate

    @property
    def variance(self):
        return self.rate

    @property
    def _natural_parameters(self):
        return [paddle.log(self.rate)]

    def _log_normalizer(self, eta):
        return torch.exp(eta)

    # The Bregman identity needs E[log k!] (the carrier mean), which has no
    # closed form for Poisson — sum the series directly for small rates;
    # the k<192 grid covers rate<96 (mass within 10 sigma), and the
    # Edgeworth asymptotic takes over beyond it.
    def entropy(self):
        def f(r):
            ks = torch.arange(0.0, 192.0, dtype=r.dtype, device=r.device)
            ks = ks.reshape((ks.shape[0],) + (1,) * r.dim())
            rs = torch.clamp_max(r, 96.0)
            logp = ks * torch.log(rs) - rs - torch.lgamma(ks + 1.0)
            p = torch.exp(logp)
            series = -torch.sum(torch.where(p > 0, p * logp,
                                            torch.zeros_like(p)), 0)
            asym = 0.5 * torch.log(2 * math.pi * math.e * r) \
                - 1.0 / (12 * r) - 1.0 / (24 * r * r) \
                - 19.0 / (360 * r ** 3)
            return torch.where(r < 96.0, series, asym)
        return run_op("poisson_entropy", f, self.rate)


class Binomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = _t(total_count)
        self.probs = _t(probs)
        super().__init__(_bshape(self.total_count, self.probs))

    def sample(self, shape=()):
        gen = _gen(self.probs)
        shp = _shape(shape, self.batch_shape)

        def f(n, p):
            return torch.binomial(
                n.to(p.dtype).broadcast_to(shp).contiguous(),
                p.broadcast_to(shp).contiguous(), generator=gen)
        return run_op("binomial_sample", f, self.total_count, self.probs,
                      differentiable=False)

    def log_prob(self, value):
        def f(v, n, p):
            p = _clip_p(p)
            logc = torch.lgamma(n + 1.0) - torch.lgamma(v + 1.0) \
                - torch.lgamma(n - v + 1.0)
            return logc + v * torch.log(p) + (n - v) * torch.log1p(-p)
        return run_op("binomial_log_prob", f, _t(value),
                      self.total_count, self.probs)

    @property
    def mean(self):
        return self.total_count * self.probs

    @property
    def variance(self):
        return self.total_count * self.probs * (1 - self.probs)


class Cauchy(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _t(loc)
        self.scale = _t(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def rsample(self, shape=()):
        gen = _gen(self.loc)
        shp = _shape(shape, self.batch_shape)

        def f(l, s):
            c = torch.empty(shp, dtype=l.dtype, device=l.device)
            return l + s * c.cauchy_(generator=gen)
        return run_op("cauchy_rsample", f, self.loc, self.scale)

    def log_prob(self, value):
        def f(v, l, s):
            z = (v - l) / s
            return -math.log(math.pi) - torch.log(s) - torch.log1p(z * z)
        return run_op("cauchy_log_prob", f, _t(value), self.loc, self.scale)

    def entropy(self):
        return run_op("cauchy_entropy",
                      lambda s: math.log(4 * math.pi) + torch.log(s),
                      self.scale)

    def cdf(self, value):
        def f(v, l, s):
            return torch.atan((v - l) / s) / math.pi + 0.5
        return run_op("cauchy_cdf", f, _t(value), self.loc, self.scale)


class Chi2(Gamma):
    """Chi-squared(df) == Gamma(df/2, 1/2) (reference chi2.py)."""

    def __init__(self, df, name=None):
        self.df = _t(df)
        super().__init__(self.df * 0.5, paddle.full_like(self.df, 0.5))


class StudentT(Distribution):
    def __init__(self, df, loc=0.0, scale=1.0, name=None):
        self.df = _t(df)
        self.loc = _t(loc)
        self.scale = _t(scale)
        super().__init__(_bshape(self.df, self.loc, self.scale))

    def rsample(self, shape=()):
        gen = _gen(self.loc)
        shp = _shape(shape, self.batch_shape)

        def f(df, l, s):
            # jax.random.t: z * sqrt((df / 2) / Gamma(df / 2))
            half = 0.5 * df.to(l.dtype)
            z = _normal(gen, shp, l)
            return l + s * z * torch.sqrt(half / _gamma(gen, half, shp))
        return run_op("studentt_rsample", f, self.df, self.loc, self.scale)

    def log_prob(self, value):
        def f(v, df, l, s):
            z = (v - l) / s
            # log B(1/2, df/2); lgamma(1/2) = 0.5 log(pi)
            lbeta = torch.lgamma(0.5 * df) + 0.5 * math.log(math.pi) \
                - torch.lgamma(0.5 * (df + 1.0))
            return -0.5 * (df + 1.0) * torch.log1p(z * z / df) \
                - 0.5 * torch.log(df) - lbeta - torch.log(s)
        return run_op("studentt_log_prob", f, _t(value), self.df,
                      self.loc, self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        def f(df, s):
            return torch.where(df > 2.0, s * s * df / (df - 2.0),
                               torch.full_like(df, float("inf")))
        return run_op("studentt_var", f, self.df, self.scale)


def _solve_lower(lt, b):
    return torch.linalg.solve_triangular(lt, b, upper=False)


def _half_logdet(lt):
    return torch.sum(torch.log(torch.diagonal(lt, dim1=-2, dim2=-1)), -1)


class MultivariateNormal(Distribution):
    """N(loc, Σ) with Σ given as covariance_matrix or scale_tril
    (reference multivariate_normal.py). Sampling and log_prob go through
    the Cholesky factor."""

    def __init__(self, loc, covariance_matrix=None, precision_matrix=None,
                 scale_tril=None, name=None):
        self.loc = _t(loc)
        if scale_tril is not None:
            self.scale_tril = _t(scale_tril)
        elif covariance_matrix is not None:
            self.scale_tril = run_op("mvn_chol", torch.linalg.cholesky,
                                     _t(covariance_matrix))
        elif precision_matrix is not None:
            def f(p):
                lp = torch.linalg.cholesky(p)
                eye = torch.eye(p.shape[-1], dtype=p.dtype, device=p.device)
                inv = _solve_lower(lp, eye)
                return torch.linalg.cholesky(inv.transpose(-1, -2) @ inv)
            self.scale_tril = run_op("mvn_prec_chol", f,
                                     _t(precision_matrix))
        else:
            raise ValueError("need covariance_matrix, precision_matrix or "
                             "scale_tril")
        d = self.loc.shape[-1]
        super().__init__(tuple(self.loc.shape[:-1]), (d,))

    @property
    def covariance_matrix(self):
        return run_op("mvn_cov", lambda lt: lt @ lt.transpose(-1, -2),
                      self.scale_tril)

    def rsample(self, shape=()):
        gen = _gen(self.loc)
        shp = _shape(shape, self.batch_shape) + self.event_shape

        def f(loc, lt):
            z = _normal(gen, shp, loc)
            return loc + torch.einsum("...ij,...j->...i", lt, z)
        return run_op("mvn_rsample", f, self.loc, self.scale_tril)

    def log_prob(self, value):
        def f(v, loc, lt):
            d = loc.shape[-1]
            dev = v - loc
            shp = torch.broadcast_shapes(dev.shape[:-1], lt.shape[:-2])
            m = _solve_lower(lt.expand(shp + lt.shape[-2:]),
                             dev.expand(shp + dev.shape[-1:])[..., None])
            m = m[..., 0]
            return -0.5 * torch.sum(m * m, -1) - _half_logdet(lt) \
                - 0.5 * d * math.log(2 * math.pi)
        return run_op("mvn_log_prob", f, _t(value), self.loc,
                      self.scale_tril)

    def entropy(self):
        def f(lt):
            d = lt.shape[-1]
            return 0.5 * d * (1.0 + math.log(2 * math.pi)) \
                + _half_logdet(lt)
        return run_op("mvn_entropy", f, self.scale_tril)

    @property
    def mean(self):
        return self.loc


class ContinuousBernoulli(Distribution):
    """CB(λ) (reference continuous_bernoulli.py): density
    C(λ) λ^x (1-λ)^(1-x) on [0,1]."""

    def __init__(self, probs, lims=(0.499, 0.501), name=None):
        self.probs = _t(probs)
        self._lims = lims
        super().__init__(tuple(self.probs.shape))

    def _near(self, p):
        return torch.abs(p - 0.5) < (self._lims[1] - self._lims[0]) / 2

    def _log_const(self, p):
        # log C(λ); Taylor expansion near 0.5 for stability
        near = self._near(p)
        psafe = torch.where(near, torch.full_like(p, 0.4), p)
        logc = torch.log(
            (2 * torch.atanh(1 - 2 * psafe)) / (1 - 2 * psafe))
        taylor = math.log(2.0) + 4.0 / 3.0 * (p - 0.5) ** 2
        return torch.where(near, taylor, logc)

    def log_prob(self, value):
        def f(v, p):
            p = _clip_p(p)
            return self._log_const(p) + v * torch.log(p) \
                + (1 - v) * torch.log1p(-p)
        return run_op("cb_log_prob", f, _t(value), self.probs)

    def rsample(self, shape=()):
        gen = _gen(self.probs)
        shp = _shape(shape, self.batch_shape)

        def f(p):
            eps = 1e-7
            p = _clip_p(p, eps)
            u = eps + (1 - 2 * eps) * _uniform(gen, shp, p)
            near = self._near(p)
            psafe = torch.where(near, torch.full_like(p, 0.4), p)
            # inverse CDF for λ != 0.5
            icdf = torch.log1p(u * (2 * psafe - 1) / (1 - psafe)) \
                / (torch.log(psafe) - torch.log1p(-psafe))
            return torch.where(near, u, icdf)
        return run_op("cb_rsample", f, self.probs)

    @property
    def mean(self):
        def f(p):
            near = self._near(p)
            psafe = torch.where(near, torch.full_like(p, 0.4), p)
            m = psafe / (2 * psafe - 1) + 1.0 / (
                2 * torch.atanh(1 - 2 * psafe))
            return torch.where(near, torch.full_like(p, 0.5), m)
        return run_op("cb_mean", f, self.probs)


def _sum_last(x, n, name):
    return run_op(name, lambda l: torch.sum(l, dim=tuple(range(-n, 0))), x)


class Independent(Distribution):
    """Reinterpret trailing batch dims as event dims (reference
    independent.py): log_prob sums over them."""

    def __init__(self, base, reinterpreted_batch_rank):
        self.base = base
        self.rank = int(reinterpreted_batch_rank)
        if self.rank > len(base.batch_shape):
            raise ValueError("reinterpreted_batch_rank exceeds batch rank")
        split = len(base.batch_shape) - self.rank
        super().__init__(base.batch_shape[:split],
                         base.batch_shape[split:] + base.event_shape)

    def sample(self, shape=()):
        return self.base.sample(shape)

    def rsample(self, shape=()):
        return self.base.rsample(shape)

    def log_prob(self, value):
        return _sum_last(self.base.log_prob(value), self.rank,
                         "independent_sum")

    def entropy(self):
        return _sum_last(self.base.entropy(), self.rank,
                         "independent_ent_sum")

    @property
    def mean(self):
        return self.base.mean

    @property
    def variance(self):
        return self.base.variance


class TransformedDistribution(Distribution):
    """Push a base distribution through transforms (reference
    transformed_distribution.py). Event-rank bookkeeping follows the
    reference/torch algorithm: walking the transforms in reverse, each
    log-det term and the base log_prob are summed down to batch shape."""

    def __init__(self, base, transforms):
        from .transform import ChainTransform, Transform
        if isinstance(transforms, Transform):
            transforms = [transforms]
        self.base = base
        self.transforms = list(transforms)
        self._chain = ChainTransform(self.transforms)
        base_event_rank = len(base.event_shape)
        self._out_event_rank = max(
            self._chain._codomain_event_rank,
            base_event_rank - self._chain._domain_event_rank
            + self._chain._codomain_event_rank)
        shape = tuple(base.batch_shape) + tuple(base.event_shape)
        out = tuple(self._chain.forward_shape(shape))
        split = len(out) - self._out_event_rank
        super().__init__(out[:split], out[split:])

    def sample(self, shape=()):
        return self._chain.forward(self.base.sample(shape))

    def rsample(self, shape=()):
        return self._chain.forward(self.base.rsample(shape))

    def log_prob(self, value):
        from .transform import sum_rightmost
        y = _t(value)
        event_rank = self._out_event_rank
        lp = None
        for t in reversed(self.transforms):
            x = t.inverse(y)
            ldj = sum_rightmost(
                t.forward_log_det_jacobian(x),
                event_rank - t._codomain_event_rank)
            lp = (-ldj) if lp is None else lp - ldj
            event_rank += t._domain_event_rank - t._codomain_event_rank
            y = x
        base_lp = sum_rightmost(self.base.log_prob(y),
                                event_rank - len(self.base.event_shape))
        return base_lp if lp is None else lp + base_lp


class LKJCholesky(Distribution):
    """LKJ prior over correlation-matrix Cholesky factors (reference
    lkj_cholesky.py), sampled with the onion method."""

    def __init__(self, dim, concentration=1.0, sample_method="onion",
                 name=None):
        if dim < 2:
            raise ValueError("dim must be >= 2")
        self.dim = int(dim)
        self.concentration = _t(concentration)
        self.sample_method = sample_method
        super().__init__(tuple(self.concentration.shape),
                         (self.dim, self.dim))

    def sample(self, shape=()):
        gen = _gen(self.concentration)
        d = self.dim
        shp = _shape(shape, self.batch_shape)

        def f(conc):
            # onion: row i built from a Beta-distributed radius and a
            # uniform direction on the sphere
            L = torch.zeros(shp + (d, d), dtype=conc.dtype,
                            device=conc.device)
            L[..., 0, 0] = 1.0
            for i in range(1, d):
                alpha = (conc + 0.5 * (d - 1 - i)).broadcast_to(shp)
                x = _gamma(gen, torch.full_like(alpha, i / 2.0), shp)
                beta_s = x / (x + _gamma(gen, alpha, shp))
                u = _normal(gen, shp + (i,), conc)
                u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
                L[..., i, :i] = torch.sqrt(beta_s)[..., None] * u
                L[..., i, i] = torch.sqrt(torch.clamp_min(1.0 - beta_s,
                                                          1e-12))
            return L
        return run_op("lkj_sample", f, self.concentration,
                      differentiable=False)

    def log_prob(self, value):
        def f(L, conc):
            d = self.dim
            diag = torch.diagonal(L, dim1=-2, dim2=-1)[..., 1:]
            order = torch.arange(2, d + 1, dtype=L.dtype, device=L.device)
            exponents = 2 * (conc[..., None] - 1.0) + d - order
            lp = torch.sum(exponents * torch.log(diag), -1)
            # normalizer (Stan reference form)
            ks = torch.arange(1, d, dtype=L.dtype, device=L.device)
            alpha = conc[..., None] + 0.5 * (d - ks - 1.0)
            logpi = 0.5 * ks * math.log(math.pi)
            lnorm = torch.sum(
                logpi + torch.lgamma(alpha)
                - torch.lgamma(alpha + 0.5 * ks), -1)
            return lp - lnorm
        return run_op("lkj_log_prob", f, _t(value), self.concentration)


@register_kl(Poisson, Poisson)
def _kl_poisson(p, q):
    return run_op(
        "kl_poisson",
        lambda rp, rq: rp * (torch.log(rp) - torch.log(rq)) - rp + rq,
        p.rate, q.rate)


@register_kl(Cauchy, Cauchy)
def _kl_cauchy(p, q):
    # closed form (Chyzak & Nielsen 2019)
    def f(lp, sp, lq, sq):
        return torch.log(((sp + sq) ** 2 + (lp - lq) ** 2) / (4 * sp * sq))
    return run_op("kl_cauchy", f, p.loc, p.scale, q.loc, q.scale)


@register_kl(MultivariateNormal, MultivariateNormal)
def _kl_mvn(p, q):
    def f(lp, ltp, lq, ltq):
        d = lp.shape[-1]
        m = _solve_lower(ltq, ltp)
        tr = torch.sum(m * m, (-2, -1))
        dev = _solve_lower(ltq, (lq - lp)[..., None])[..., 0]
        maha = torch.sum(dev * dev, -1)
        logdet = 2 * (_half_logdet(ltq) - _half_logdet(ltp))
        return 0.5 * (tr + maha - d + logdet)
    return run_op("kl_mvn", f, p.loc, p.scale_tril, q.loc, q.scale_tril)
