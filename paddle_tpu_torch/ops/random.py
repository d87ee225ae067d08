"""Random sampling ops: the port of ``paddle_tpu/ops/random.py`` (reference:
python/paddle/tensor/random.py). Every op draws from the default
``Generator``'s torch generator for the device it fills (core/generator.py);
a nonzero ``seed`` argument draws from a generator of its own."""
from __future__ import annotations

import numpy as np
import torch

from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.generator import generator_for, no_traced_form, traced
from ..core.place import default_device
from ..core.tensor import Tensor
from .creation import _shape_tuple


def _dt(dtype):
    d = dtype_mod.convert_dtype(dtype) or dtype_mod.get_default_dtype()
    return d.torch


def _gen(device, seed=0):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return generator_for(device)


def _rand(shape, gen, dtype, device):
    if traced(gen):
        return gen.uniform(shape, device, dtype)
    return torch.rand(shape, generator=gen, dtype=dtype, device=device)


def _randn(shape, gen, dtype, device):
    if traced(gen):
        return gen.normal(shape, device, dtype)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def rand(shape, dtype=None, name=None):
    dev = default_device()
    return Tensor._wrap(_rand(_shape_tuple(shape), _gen(dev), _dt(dtype),
                              dev))


def randn(shape, dtype=None, name=None):
    dev = default_device()
    return Tensor._wrap(_randn(_shape_tuple(shape), _gen(dev), _dt(dtype),
                               dev))


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    dt = dtype_mod.get_default_dtype().torch
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        ref = mean if isinstance(mean, Tensor) else std
        dev = ref._data.device
        m = mean._data if isinstance(mean, Tensor) else mean
        s = std._data if isinstance(std, Tensor) else std
        shp = np.broadcast_shapes(tuple(getattr(m, "shape", ())),
                                  tuple(getattr(s, "shape", ())))
        z = _randn(shp, _gen(dev), dt, dev)
        return Tensor._wrap(m + s * z)
    dev = default_device()
    shp = _shape_tuple(shape) if shape is not None else ()
    z = _randn(shp, _gen(dev), dt, dev)
    return Tensor._wrap(mean + std * z)


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    dev = default_device()
    gen = _gen(dev, seed)
    if traced(gen):
        return Tensor._wrap(gen.uniform(_shape_tuple(shape), dev, _dt(dtype),
                                        min, max))
    out = torch.empty(_shape_tuple(shape), dtype=_dt(dtype), device=dev)
    return Tensor._wrap(out.uniform_(min, max, generator=gen))


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    dev = default_device()
    gen = _gen(dev)
    if traced(gen):
        return Tensor._wrap(gen.randint(int(low), int(high),
                                        _shape_tuple(shape), dev,
                                        dtype_mod.torch_dtype(dtype)))
    return Tensor._wrap(torch.randint(
        int(low), int(high), _shape_tuple(shape), generator=gen,
        dtype=dtype_mod.torch_dtype(dtype), device=dev))


def randint_like(x, low=0, high=None, dtype=None, name=None):
    if high is None:
        low, high = 0, low
    dev = x._data.device
    d = dtype_mod.torch_dtype(dtype) or x._data.dtype
    gen = _gen(dev)
    if traced(gen):
        return Tensor._wrap(gen.randint(int(low), int(high), tuple(x.shape),
                                        dev, d))
    out = torch.randint(int(low), int(high), tuple(x.shape),
                        generator=gen, dtype=torch.int64, device=dev)
    return Tensor._wrap(out.to(d))


def randperm(n, dtype="int64", name=None):
    dev = default_device()
    gen = _gen(dev)
    no_traced_form(gen, "randperm")
    return Tensor._wrap(torch.randperm(n, generator=gen,
                                       dtype=dtype_mod.torch_dtype(dtype),
                                       device=dev))


def bernoulli(x, name=None):
    gen = _gen(x._data.device)
    if traced(gen):
        return run_op("bernoulli", lambda a: (gen.uniform(
            a.shape, a.device) < a).to(a.dtype), x, differentiable=False)
    return run_op("bernoulli", lambda a: torch.bernoulli(a, generator=gen),
                  x, differentiable=False)


def bernoulli_(x, p=0.5, name=None):
    a = x._data
    gen = _gen(a.device)
    if traced(gen):
        x._assign_array((gen.uniform(a.shape, a.device) < p).to(a.dtype))
        return x
    x._assign_array(torch.bernoulli(torch.full_like(a.detach(), p),
                                    generator=gen))
    return x


def binomial(count, prob, name=None):
    gen = _gen(prob._data.device)
    no_traced_form(gen, "binomial")
    return run_op("binomial",
                  lambda n, p: torch.binomial(n.to(p.dtype), p,
                                              generator=gen).to(torch.int64),
                  count, prob, differentiable=False)


def poisson(x, name=None):
    gen = _gen(x._data.device)
    no_traced_form(gen, "poisson")
    return run_op("poisson", lambda lam: torch.poisson(lam, generator=gen),
                  x, differentiable=False)


def multinomial(x, num_samples=1, replacement=False, name=None):
    gen = _gen(x._data.device)
    no_traced_form(gen, "multinomial")
    return run_op("multinomial",
                  lambda p: torch.multinomial(p, num_samples, replacement,
                                              generator=gen),
                  x, differentiable=False)


def _fill(x, fill):
    a = x._data.detach()
    x._assign_array(fill(torch.empty_like(a), _gen(a.device)))
    return x


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):
    a = x._data.detach()
    gen = _gen(a.device, seed)
    if traced(gen):
        x._assign_array(gen.uniform(a.shape, a.device, a.dtype, min, max))
        return x
    x._assign_array(torch.empty_like(a).uniform_(min, max, generator=gen))
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    return _fill(x, lambda e, g: g.normal(e.shape, e.device, e.dtype, mean,
                                          std) if traced(g)
                 else e.normal_(mean, std, generator=g))


def exponential_(x, lam=1.0, name=None):
    def fill(e, g):
        no_traced_form(g, "exponential_")
        return e.exponential_(lam, generator=g)
    return _fill(x, fill)


def rand_like(x, dtype=None, name=None):
    dev = x._data.device
    d = dtype_mod.torch_dtype(dtype) or x._data.dtype
    return Tensor._wrap(_rand(tuple(x.shape), _gen(dev), d, dev))


def randn_like(x, dtype=None, name=None):
    dev = x._data.device
    d = dtype_mod.torch_dtype(dtype) or x._data.dtype
    return Tensor._wrap(_randn(tuple(x.shape), _gen(dev), d, dev))


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    dev = default_device()
    z = _randn(_shape_tuple(shape), _gen(dev, seed), _dt(dtype), dev)
    return Tensor._wrap(mean + std * z)


def laplace(loc=0.0, scale=1.0, shape=None, dtype=None, name=None):
    dev = default_device()
    shp = _shape_tuple(shape) if shape is not None else ()
    u = _rand(shp, _gen(dev), _dt(dtype), dev) - 0.5
    # loc and scale may be Tensors, which broadcast the draw (reference)
    z = Tensor._wrap(-torch.sign(u) * torch.log1p(-2 * torch.abs(u)))
    return loc + scale * z
