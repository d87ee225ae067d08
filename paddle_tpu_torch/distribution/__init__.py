"""paddle.distribution (reference: python/paddle/distribution/*).

Port of ``paddle_tpu/distribution/__init__.py``. ``log_prob``, ``prob``,
``entropy``, the moments and the KLs are the reference's functions in
torch ops through the op layer. Draws come from the port's generators
(``core/generator``), so a draw differs from the reference's for the same
seed while its distribution does not, as for every random op of the
port. ``rsample`` is differentiable where the reference's is: by
reparameterization, and through ``torch._standard_gamma``'s implicit
gradient for the gamma family (Gamma, Beta, Dirichlet, Chi2, StudentT), as
``jax.random.gamma``'s.
"""
from __future__ import annotations

import math

import numpy as np
import torch

import paddle_tpu_torch as paddle
from ..core.dispatch import run_op
from ..core.generator import generator_for
from ..core.tensor import Tensor

_TINY = {torch.float16: 6.1e-05, torch.bfloat16: 1.2e-38,
         torch.float32: 1.2e-38, torch.float64: 2.3e-308}


def _t(x):
    return x if isinstance(x, Tensor) else paddle.to_tensor(x)


def _shape(sample_shape, base_shape):
    return tuple(int(s) for s in sample_shape) + tuple(base_shape)


def _gen(t):
    """The generator that draws on ``t``'s device (one draw counted)."""
    return generator_for(t._data.device)


def _uniform(gen, shp, like, low=0.0):
    """U[low, 1) draws of ``like``'s dtype and device; ``low`` > 0 keeps a
    log of them finite."""
    u = torch.rand(shp, generator=gen, dtype=like.dtype, device=like.device)
    return u if low == 0.0 else u.clamp_min(low)


def _normal(gen, shp, like):
    return torch.randn(shp, generator=gen, dtype=like.dtype,
                       device=like.device)


def _gamma(gen, a, shp):
    """Gamma(a, 1) draws, differentiable in ``a`` (implicit gradient)."""
    return torch._standard_gamma(a.broadcast_to(shp), generator=gen)


def _gumbel(gen, shp, like):
    u = _uniform(gen, shp, like, _TINY[like.dtype])
    return -torch.log(-torch.log(u))


def _categorical(gen, logits, shp):
    """Categorical draws of shape ``shp`` (the Gumbel-max form of
    ``jax.random.categorical``: logits broadcast against ``shp``)."""
    g = _gumbel(gen, tuple(shp) + (logits.shape[-1],), logits)
    return torch.argmax(logits + g, dim=-1)


class Distribution:
    def __init__(self, batch_shape=(), event_shape=()):
        self._batch_shape = tuple(batch_shape)
        self._event_shape = tuple(event_shape)

    @property
    def batch_shape(self):
        return self._batch_shape

    @property
    def event_shape(self):
        return self._event_shape

    def sample(self, shape=()):
        with paddle.no_grad():
            return self.rsample(shape)

    def rsample(self, shape=()):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def prob(self, value):
        return paddle.exp(self.log_prob(value))

    def entropy(self):
        raise NotImplementedError

    def kl_divergence(self, other):
        return kl_divergence(self, other)


def _bshape(*ts):
    return tuple(np.broadcast_shapes(*[tuple(t.shape) for t in ts]))


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _t(loc)
        self.scale = _t(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def rsample(self, shape=()):
        gen = _gen(self.loc)
        shp = _shape(shape, self.batch_shape)

        def f(loc, scale):
            return loc + scale * _normal(gen, shp, loc)
        return run_op("normal_rsample", f, self.loc, self.scale)

    def log_prob(self, value):
        def f(v, loc, scale):
            var = scale * scale
            return -((v - loc) ** 2) / (2 * var) - torch.log(scale) \
                - 0.5 * math.log(2 * math.pi)
        return run_op("normal_log_prob", f, _t(value), self.loc, self.scale)

    def entropy(self):
        return run_op("normal_entropy",
                      lambda s: 0.5 + 0.5 * math.log(2 * math.pi)
                      + torch.log(s) + s.new_zeros(self.batch_shape),
                      self.scale)

    @property
    def mean(self):
        return self.loc

    @property
    def variance(self):
        return self.scale * self.scale


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _t(low)
        self.high = _t(high)
        super().__init__(_bshape(self.low, self.high))

    def rsample(self, shape=()):
        gen = _gen(self.low)
        shp = _shape(shape, self.batch_shape)

        def f(lo, hi):
            return lo + (hi - lo) * _uniform(gen, shp, lo)
        return run_op("uniform_rsample", f, self.low, self.high)

    sample = Distribution.sample

    def log_prob(self, value):
        def f(v, lo, hi):
            inside = (v >= lo) & (v < hi)
            return torch.where(inside, -torch.log(hi - lo),
                               torch.full_like(v, float("-inf")))
        return run_op("uniform_log_prob", f, _t(value), self.low, self.high)

    def entropy(self):
        return paddle.log(self.high - self.low)


def _clip_p(p, eps=1e-7):
    return torch.clamp(p, eps, 1 - eps)


class Bernoulli(Distribution):
    def __init__(self, probs=None, logits=None, name=None):
        if probs is None:
            self.logits = _t(logits)
            self.probs = paddle.sigmoid(self.logits)
        else:
            self.probs = _t(probs)
        super().__init__(tuple(self.probs.shape))

    def sample(self, shape=()):
        gen = _gen(self.probs)
        shp = _shape(shape, self.batch_shape)

        def f(p):
            return (_uniform(gen, shp, p) < p).to(p.dtype)
        return run_op("bernoulli_sample", f, self.probs,
                      differentiable=False)

    def log_prob(self, value):
        def f(v, p):
            p = _clip_p(p)
            return v * torch.log(p) + (1 - v) * torch.log1p(-p)
        return run_op("bernoulli_log_prob", f, _t(value), self.probs)

    def entropy(self):
        def f(p):
            p = _clip_p(p)
            return -(p * torch.log(p) + (1 - p) * torch.log1p(-p))
        return run_op("bernoulli_entropy", f, self.probs)

    @property
    def mean(self):
        return self.probs


class Categorical(Distribution):
    def __init__(self, logits=None, probs=None, name=None):
        if logits is not None:
            self.logits = _t(logits)
        else:
            self.logits = paddle.log(_t(probs))
        super().__init__(tuple(self.logits.shape[:-1]))

    @property
    def probs(self):
        from ..nn.functional import softmax
        return softmax(self.logits, axis=-1)

    def sample(self, shape=()):
        gen = _gen(self.logits)
        shp = _shape(shape, self.batch_shape)
        return run_op("categorical_sample",
                      lambda lg: _categorical(gen, lg, shp), self.logits,
                      differentiable=False)

    def log_prob(self, value):
        def f(v, lg):
            logp = torch.log_softmax(lg, -1)
            shp = torch.broadcast_shapes(v.shape, logp.shape[:-1])
            logp = logp.expand(shp + logp.shape[-1:])
            idx = v.to(torch.int64).expand(shp)[..., None]
            return torch.gather(logp, -1, idx)[..., 0]
        return run_op("categorical_log_prob", f, _t(value), self.logits)

    def entropy(self):
        def f(lg):
            logp = torch.log_softmax(lg, -1)
            return -torch.sum(torch.exp(logp) * logp, -1)
        return run_op("categorical_entropy", f, self.logits)


class Exponential(Distribution):
    def __init__(self, rate, name=None):
        self.rate = _t(rate)
        super().__init__(tuple(self.rate.shape))

    def rsample(self, shape=()):
        gen = _gen(self.rate)
        shp = _shape(shape, self.batch_shape)

        def f(r):
            e = torch.empty(shp, dtype=r.dtype, device=r.device)
            return e.exponential_(generator=gen) / r
        return run_op("exponential_rsample", f, self.rate)

    def log_prob(self, value):
        return run_op("exponential_log_prob",
                      lambda v, r: torch.log(r) - r * v, _t(value),
                      self.rate)

    def entropy(self):
        return 1.0 - paddle.log(self.rate)


class Gamma(Distribution):
    def __init__(self, concentration, rate, name=None):
        self.concentration = _t(concentration)
        self.rate = _t(rate)
        super().__init__(_bshape(self.concentration, self.rate))

    def rsample(self, shape=()):
        gen = _gen(self.concentration)
        shp = _shape(shape, self.batch_shape)
        return run_op("gamma_rsample",
                      lambda a, r: _gamma(gen, a, shp) / r,
                      self.concentration, self.rate)

    def log_prob(self, value):
        def f(v, a, r):
            return a * torch.log(r) + (a - 1) * torch.log(v) - r * v \
                - torch.lgamma(a)
        return run_op("gamma_log_prob", f, _t(value), self.concentration,
                      self.rate)


class Beta(Distribution):
    def __init__(self, alpha, beta, name=None):
        self.alpha = _t(alpha)
        self.beta = _t(beta)
        super().__init__(_bshape(self.alpha, self.beta))

    def rsample(self, shape=()):
        gen = _gen(self.alpha)
        shp = _shape(shape, self.batch_shape)

        def f(a, b):
            x = _gamma(gen, a, shp)
            return x / (x + _gamma(gen, b, shp))
        return run_op("beta_rsample", f, self.alpha, self.beta)

    def log_prob(self, value):
        def f(v, a, b):
            betaln = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
            return (a - 1) * torch.log(v) + (b - 1) * torch.log1p(-v) \
                - betaln
        return run_op("beta_log_prob", f, _t(value), self.alpha, self.beta)


class Dirichlet(Distribution):
    def __init__(self, concentration, name=None):
        self.concentration = _t(concentration)
        super().__init__(tuple(self.concentration.shape[:-1]),
                         tuple(self.concentration.shape[-1:]))

    def rsample(self, shape=()):
        gen = _gen(self.concentration)
        shp = _shape(shape, self.concentration.shape)

        def f(a):
            g = _gamma(gen, a, shp)
            return g / torch.sum(g, -1, keepdim=True)
        return run_op("dirichlet_rsample", f, self.concentration)

    def log_prob(self, value):
        def f(v, a):
            lnB = torch.sum(torch.lgamma(a), -1) \
                - torch.lgamma(torch.sum(a, -1))
            return torch.sum((a - 1) * torch.log(v), -1) - lnB
        return run_op("dirichlet_log_prob", f, _t(value),
                      self.concentration)


class Laplace(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _t(loc)
        self.scale = _t(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def rsample(self, shape=()):
        gen = _gen(self.loc)
        shp = _shape(shape, self.batch_shape)

        def f(loc, s):
            # jax.random.laplace: u ~ U(-1, 1), -sign(u) log1p(-|u|)
            u = 2 * _uniform(gen, shp, loc) - 1
            u = u.clamp_min(-1 + torch.finfo(loc.dtype).eps)
            return loc + s * (-torch.sign(u) * torch.log1p(-torch.abs(u)))
        return run_op("laplace_rsample", f, self.loc, self.scale)

    def log_prob(self, value):
        return run_op("laplace_log_prob",
                      lambda v, loc, s: -torch.abs(v - loc) / s
                      - torch.log(2 * s), _t(value), self.loc, self.scale)


class Gumbel(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _t(loc)
        self.scale = _t(scale)
        super().__init__(_bshape(self.loc, self.scale))

    def rsample(self, shape=()):
        gen = _gen(self.loc)
        shp = _shape(shape, self.batch_shape)
        return run_op("gumbel_rsample",
                      lambda loc, s: loc + s * _gumbel(gen, shp, loc),
                      self.loc, self.scale)

    def log_prob(self, value):
        def f(v, loc, s):
            z = (v - loc) / s
            return -(z + torch.exp(-z)) - torch.log(s)
        return run_op("gumbel_log_prob", f, _t(value), self.loc, self.scale)


class LogNormal(Distribution):
    def __init__(self, loc, scale, name=None):
        self._normal = Normal(loc, scale)
        self.loc = self._normal.loc
        self.scale = self._normal.scale
        super().__init__(self._normal.batch_shape)

    def rsample(self, shape=()):
        return paddle.exp(self._normal.rsample(shape))

    def log_prob(self, value):
        v = _t(value)
        return self._normal.log_prob(paddle.log(v)) - paddle.log(v)


class Multinomial(Distribution):
    def __init__(self, total_count, probs, name=None):
        self.total_count = int(total_count)
        self.probs = _t(probs)
        super().__init__(tuple(self.probs.shape[:-1]),
                         tuple(self.probs.shape[-1:]))

    def sample(self, shape=()):
        gen = _gen(self.probs)

        def f(p):
            logits = torch.log(torch.clamp_min(p, 1e-30))
            draws = _categorical(gen, logits, tuple(shape)
                                 + (self.total_count,)
                                 + tuple(self.probs.shape[:-1]))
            oh = torch.nn.functional.one_hot(draws, p.shape[-1]).to(p.dtype)
            return torch.sum(oh, dim=len(tuple(shape)))
        return run_op("multinomial_sample", f, self.probs,
                      differentiable=False)

    def log_prob(self, value):
        def f(v, p):
            logp = torch.log(torch.clamp_min(p, 1e-30))
            n1 = torch.tensor(self.total_count + 1.0, dtype=p.dtype,
                              device=p.device)
            return torch.lgamma(n1) - torch.sum(torch.lgamma(v + 1.0), -1) \
                + torch.sum(v * logp, -1)
        return run_op("multinomial_log_prob", f, _t(value), self.probs)


class Geometric(Distribution):
    def __init__(self, probs, name=None):
        self.probs = _t(probs)
        super().__init__(tuple(self.probs.shape))

    def sample(self, shape=()):
        gen = _gen(self.probs)
        shp = _shape(shape, self.batch_shape)

        def f(p):
            # jax.random.geometric: floor(log(u) / log1p(-p)) + 1
            u = _uniform(gen, shp, p, _TINY[p.dtype])
            return torch.floor(torch.log(u) / torch.log1p(-p)) + 1
        return run_op("geometric_sample", f, self.probs,
                      differentiable=False)

    def log_prob(self, value):
        return run_op("geometric_log_prob",
                      lambda v, p: (v - 1) * torch.log1p(-p) + torch.log(p),
                      _t(value), self.probs)


# ---------------------------- KL registry ----------------------------------
_KL = {}


def register_kl(cls_p, cls_q):
    def deco(fn):
        _KL[(cls_p, cls_q)] = fn
        return fn
    return deco


def kl_divergence(p, q):
    fn = _KL.get((type(p), type(q)))
    if fn is None:
        raise NotImplementedError(
            f"kl_divergence({type(p).__name__}, {type(q).__name__})")
    return fn(p, q)


@register_kl(Normal, Normal)
def _kl_normal(p, q):
    def f(lp, sp, lq, sq):
        var_ratio = (sp / sq) ** 2
        t1 = ((lp - lq) / sq) ** 2
        return 0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio))
    return run_op("kl_normal", f, p.loc, p.scale, q.loc, q.scale)


@register_kl(Categorical, Categorical)
def _kl_cat(p, q):
    def f(lp, lq):
        a = torch.log_softmax(lp, -1)
        b = torch.log_softmax(lq, -1)
        return torch.sum(torch.exp(a) * (a - b), -1)
    return run_op("kl_categorical", f, p.logits, q.logits)


@register_kl(Bernoulli, Bernoulli)
def _kl_bern(p, q):
    def f(pp, pq):
        pp, pq = _clip_p(pp), _clip_p(pq)
        return pp * (torch.log(pp) - torch.log(pq)) + \
            (1 - pp) * (torch.log1p(-pp) - torch.log1p(-pq))
    return run_op("kl_bernoulli", f, p.probs, q.probs)


@register_kl(Uniform, Uniform)
def _kl_uniform(p, q):
    def f(pl, ph, ql, qh):
        res = torch.log((qh - ql) / (ph - pl))
        return torch.where((ql <= pl) & (ph <= qh), res,
                           torch.full_like(res, float("inf")))
    return run_op("kl_uniform", f, p.low, p.high, q.low, q.high)


# --------------------------------------------------------------------------
# Extended families + transform library (separate modules, reference file
# layout: python/paddle/distribution/{poisson,binomial,...,transform}.py)
from .families import (  # noqa: E402,F401
    Binomial, Cauchy, Chi2, ContinuousBernoulli, ExponentialFamily,
    Independent, LKJCholesky, MultivariateNormal, Poisson, StudentT,
    TransformedDistribution,
)
from . import transform  # noqa: E402,F401
from .transform import (  # noqa: E402,F401
    AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform,
    SigmoidTransform, SoftmaxTransform, StackTransform,
    StickBreakingTransform, TanhTransform, Transform,
)
