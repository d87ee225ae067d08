"""Parameter-server tables (reference:
paddle/fluid/distributed/ps/table/ — memory_dense_table.cc,
memory_sparse_table.cc, memory_sparse_geo_table.cc, accessor.h).

Tables live on the server's host memory as numpy arrays; the optimizer
runs server-side on push (the reference's accessor model). Sparse rows
are created on first access (the reference's on-demand embedding)."""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np


class _SGDRule:
    def __init__(self, lr=1.0):
        self.lr = lr

    def init_state(self, shape):
        return {}

    def update(self, param, grad, state):
        param -= self.lr * grad


class _AdagradRule:
    def __init__(self, lr=0.01, eps=1e-6):
        self.lr = lr
        self.eps = eps

    def init_state(self, shape):
        return {"g2": np.zeros(shape, np.float32)}

    def update(self, param, grad, state):
        state["g2"] += grad * grad
        param -= self.lr * grad / (np.sqrt(state["g2"]) + self.eps)


class _AdamRule:
    def __init__(self, lr=0.001, beta1=0.9, beta2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps

    def init_state(self, shape):
        return {"m": np.zeros(shape, np.float32),
                "v": np.zeros(shape, np.float32), "t": 0}

    def update(self, param, grad, state):
        state["t"] += 1
        state["m"] = self.b1 * state["m"] + (1 - self.b1) * grad
        state["v"] = self.b2 * state["v"] + (1 - self.b2) * grad * grad
        mh = state["m"] / (1 - self.b1 ** state["t"])
        vh = state["v"] / (1 - self.b2 ** state["t"])
        param -= self.lr * mh / (np.sqrt(vh) + self.eps)


class _SumRule:
    """Geo-SGD accumulation: pushes are deltas, applied directly."""

    def init_state(self, shape):
        return {}

    def update(self, param, grad, state):
        param += grad


_RULES = {"sgd": _SGDRule, "adagrad": _AdagradRule, "adam": _AdamRule,
          "sum": _SumRule}


def make_rule(name: str, **kw):
    return _RULES[name](**kw)


class DenseTable:
    """A contiguous fp32 parameter block (reference
    memory_dense_table.cc)."""

    def __init__(self, size: int, optimizer: str = "sgd", **opt_kw):
        self.data = np.zeros(size, np.float32)
        self._rule = make_rule(optimizer, **opt_kw)
        self._state = self._rule.init_state(size)
        self._lock = threading.Lock()

    def pull(self) -> np.ndarray:
        with self._lock:
            return self.data.copy()

    def push(self, grad: np.ndarray):
        with self._lock:
            self._rule.update(self.data, grad.astype(np.float32),
                              self._state)

    def set(self, values: np.ndarray):
        with self._lock:
            self.data[...] = values


class SparseTable:
    """id -> fp32[dim] rows, created on first pull (reference
    memory_sparse_table.cc; shard-per-server via the client's id
    routing)."""

    def __init__(self, dim: int, optimizer: str = "sgd",
                 initializer: str = "uniform", init_range: float = 0.05,
                 seed: int = 0, **opt_kw):
        self.dim = dim
        self._rule = make_rule(optimizer, **opt_kw)
        self._rows: Dict[int, np.ndarray] = {}
        self._states: Dict[int, dict] = {}
        self._initializer = initializer
        self._range = init_range
        self._rs = np.random.RandomState(seed)
        self._lock = threading.Lock()

    def _ensure(self, key: int) -> np.ndarray:
        row = self._rows.get(key)
        if row is None:
            if self._initializer == "zeros":
                row = np.zeros(self.dim, np.float32)
            else:
                row = self._rs.uniform(
                    -self._range, self._range, self.dim).astype(np.float32)
            self._rows[key] = row
            self._states[key] = self._rule.init_state(self.dim)
        return row

    def pull(self, keys: np.ndarray) -> np.ndarray:
        with self._lock:
            return np.stack([self._ensure(int(k)) for k in keys]) \
                if len(keys) else np.zeros((0, self.dim), np.float32)

    def push(self, keys: np.ndarray, grads: np.ndarray):
        """Apply the rule row by row, in order: an id that appears twice
        gets two sequential updates (its optimizer state steps twice), as
        the reference's table applies them; never summed first."""
        with self._lock:
            for k, g in zip(keys, grads):
                row = self._ensure(int(k))
                self._rule.update(row, g.astype(np.float32),
                                  self._states[int(k)])

    def size(self) -> int:
        with self._lock:
            return len(self._rows)


class SparseGeoTable(SparseTable):
    """Geo-SGD sparse table: workers train local replicas and push
    parameter DELTAS, applied additively (reference
    memory_sparse_geo_table.cc)."""

    def __init__(self, dim: int, **kw):
        kw.pop("optimizer", None)
        super().__init__(dim, optimizer="sum", **kw)
