"""RNG state: the port of ``paddle_tpu/core/generator.py``.

The reference keeps a seed and an offset and folds the offset into a jax
threefry key for every draw. The port keeps one ``torch.Generator`` per
device, each seeded with the seed when first used, and counts the draws in
``offset``. torch's draws differ from jax's for the same seed, so values
are reproducible under ``seed`` but never equal to the reference's.
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

    def for_device(self, device) -> torch.Generator:
        """The torch.Generator that draws on ``device``; counts one draw."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        with self._lock:
            self._offset += 1
            g = self._gens.get(device)
            if g is None:
                g = torch.Generator(device=device).manual_seed(self._seed)
                self._gens[device] = g
            return g


_DEFAULT = Generator(seed=np.random.randint(0, 2**31 - 1))


def default_generator() -> Generator:
    return _DEFAULT


def seed(s: int) -> Generator:
    """paddle.seed: reseed the default generator."""
    _DEFAULT.manual_seed(s)
    return _DEFAULT


def generator_for(device) -> torch.Generator:
    return _DEFAULT.for_device(device)
