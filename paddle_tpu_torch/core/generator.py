"""RNG state: the port of ``paddle_tpu/core/generator.py``.

The reference keeps a seed and an offset and folds the offset into a jax
threefry key for every draw. The port keeps one ``torch.Generator`` per
device, each seeded with the seed when first used, and counts the draws in
``offset``. torch's draws differ from jax's for the same seed, so values
are reproducible under ``seed`` but never equal to the reference's.

A compiled program (``jit.to_static``) cannot draw from a
``torch.Generator``: the trace would bake the generator into the graph. The
reference threads a jax key through its compiled step instead
(``jit/__init__.py:815-824``); the port threads a seed. Each compiled call
takes ``Generator.next_seed()`` as an int64 graph input, and while the
program is traced ``generator_for`` hands out a ``TracedDraws`` that makes
every draw a counter-based hash of (seed, draw index, element index) in
tensor ops. So a compiled dropout mask differs call to call, repeats bit for
bit after ``seed(s)``, and is the same on the CPU and the card; it is not
the mask the eager path draws.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


class Generator:
    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._offset = 0
            self._gens = {}           # torch.device -> torch.Generator
        return self

    def seed(self):
        return self._seed

    def initial_seed(self):
        return self._seed

    def get_state(self):
        with self._lock:
            return {"seed": self._seed, "offset": self._offset,
                    "devices": {str(d): g.get_state()
                                for d, g in self._gens.items()}}

    def set_state(self, state):
        with self._lock:
            self._seed = int(state["seed"])
            self._offset = int(state["offset"])
            self._gens = {}
            for d, s in state.get("devices", {}).items():
                g = torch.Generator(device=d)
                g.set_state(s)
                self._gens[torch.device(d)] = g

    def next_seed(self) -> int:
        """The seed of one compiled call: a function of (seed, offset), and
        the offset advances."""
        with self._lock:
            self._offset += 1
            return (self._seed * 0x9E3779B1 + self._offset * 0x85EBCA77) \
                & 0x7FFFFFFF

    def _device_gen(self, device) -> torch.Generator:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        g = self._gens.get(device)
        if g is None:
            g = torch.Generator(device=device).manual_seed(self._seed)
            self._gens[device] = g
        return g

    def for_device(self, device) -> torch.Generator:
        """The torch.Generator that draws on ``device``; counts one draw."""
        with self._lock:
            self._offset += 1
            return self._device_gen(device)

    def device_state(self, device):
        """The state of the torch.Generator that draws on ``device``."""
        with self._lock:
            return self._device_gen(device).get_state()

    def set_device_state(self, device, state):
        with self._lock:
            self._device_gen(device).set_state(state)


_DEFAULT = Generator(seed=np.random.randint(0, 2**31 - 1))


def default_generator() -> Generator:
    return _DEFAULT


def seed(s: int) -> Generator:
    """paddle.seed: reseed the default generator."""
    _DEFAULT.manual_seed(s)
    return _DEFAULT


def generator_for(device):
    """The torch.Generator that draws on ``device``; while a compiled program
    is traced, the ``TracedDraws`` of that trace."""
    draws = getattr(_TRACE, "draws", None)
    if draws is not None:
        return draws
    return _DEFAULT.for_device(device)


# ---------------------------------------------------------------------------
# draws inside a traced program
# ---------------------------------------------------------------------------
_TRACE = threading.local()
_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) without overflowing
    int64: the constant is split in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) * 65536
    return (lo + hi) & _M32


def _hash32(x):
    """A 32-bit integer mix (``lowbias32``) in int64 tensor ops."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class TracedDraws:
    """The generator of one traced program: ``seed`` is the program's int64
    seed input; the n-th draw of the trace hashes (seed, n, element)."""

    def __init__(self, seed):
        self.seed = seed
        self.n = 0

    def _bits(self, numel, device):
        n = self.n
        self.n += 1
        k = _hash32((self.seed + n * 0x632BE5AB) & _M32)
        i = torch.arange(numel, device=device, dtype=torch.int64)
        return _hash32(_hash32(i ^ k) ^ ((k * 5 + 0x1B873593) & _M32))

    def uniform(self, shape, device, dtype=torch.float32, low=0.0,
                high=1.0):
        """U[low, high) of ``shape`` from the top 24 bits of each hash."""
        shape = tuple(shape)
        numel = 1
        for d in shape:
            numel *= int(d)
        u = (self._bits(numel, device) >> 8).to(torch.float32) \
            * (1.0 / (1 << 24))
        u = u.reshape(shape)
        if (low, high) != (0.0, 1.0):
            u = low + (high - low) * u
        return u.to(dtype)

    def normal(self, shape, device, dtype=torch.float32, mean=0.0, std=1.0):
        """N(mean, std) of ``shape`` by Box-Muller over two draws."""
        u1 = 1.0 - self.uniform(shape, device)          # in (0, 1]
        u2 = self.uniform(shape, device)
        z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(
            (2.0 * 3.141592653589793) * u2)
        return (mean + std * z).to(dtype)

    def randint(self, low, high, shape, device, dtype=torch.int64):
        u = self.uniform(shape, device, torch.float64)
        return (low + torch.floor(u * (high - low))).to(dtype)


def traced(gen) -> bool:
    """True when ``gen`` is the draws of a program being traced."""
    return isinstance(gen, TracedDraws)


def no_traced_form(gen, op):
    """Refuses an op whose draw has no traced form while a program is
    traced (the compiled call then runs eagerly, as untraceable)."""
    if isinstance(gen, TracedDraws):
        from .tensor import TracedValueError
        raise TracedValueError(
            f"{op} has no traced form: it draws from a torch.Generator")


class trace_draws:
    """Context of a trace: ``generator_for`` returns ``draws``."""

    def __init__(self, draws):
        self.draws = draws

    def __enter__(self):
        self.prev = getattr(_TRACE, "draws", None)
        _TRACE.draws = self.draws
        return self.draws

    def __exit__(self, *exc):
        _TRACE.draws = self.prev
        return False
