"""PS worker client: routes dense blocks round-robin and sparse ids by
hash across servers (reference: brpc_ps_client.cc request routing +
fleet worker init)."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .rpc import RpcClient


class PsClient:
    def __init__(self, endpoints: Sequence[str]):
        self._clients: List[RpcClient] = [RpcClient(e) for e in endpoints]
        self._n = len(self._clients)

    # ------------------------------------------------------ dense path
    def create_dense_table(self, table_id, size, optimizer="sgd",
                           **opt_kw):
        """Dense block is partitioned contiguously across servers."""
        splits = self._dense_splits(size)
        for c, (lo, hi) in zip(self._clients, splits):
            c.call("create_dense_table", table_id=table_id, size=hi - lo,
                   optimizer=optimizer, **opt_kw)

    def _dense_splits(self, size):
        per = (size + self._n - 1) // self._n
        return [(i * per, min((i + 1) * per, size))
                for i in range(self._n)]

    def pull_dense(self, table_id, size) -> np.ndarray:
        parts = [c.call("pull_dense", table_id=table_id)
                 for c in self._clients]
        return np.concatenate(parts)[:size]

    def push_dense(self, table_id, grad: np.ndarray):
        for c, (lo, hi) in zip(self._clients,
                               self._dense_splits(len(grad))):
            c.call("push_dense", table_id=table_id, grad=grad[lo:hi])

    def set_dense(self, table_id, values: np.ndarray):
        for c, (lo, hi) in zip(self._clients,
                               self._dense_splits(len(values))):
            c.call("set_dense", table_id=table_id, values=values[lo:hi])

    # ----------------------------------------------------- sparse path
    def create_sparse_table(self, table_id, dim, optimizer="sgd",
                            geo=False, **opt_kw):
        for c in self._clients:
            c.call("create_sparse_table", table_id=table_id, dim=dim,
                   optimizer=optimizer, geo=geo, **opt_kw)

    def pull_sparse(self, table_id, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, np.int64).reshape(-1)
        shard = keys % self._n
        out = None
        for i, c in enumerate(self._clients):
            mask = shard == i
            if not mask.any():
                continue
            rows = c.call("pull_sparse", table_id=table_id,
                          keys=keys[mask])
            if out is None:
                out = np.zeros((len(keys), rows.shape[1]), np.float32)
            out[mask] = rows
        if out is None:
            raise ValueError("pull_sparse with empty keys")
        return out

    def push_sparse(self, table_id, keys: np.ndarray, grads: np.ndarray):
        keys = np.asarray(keys, np.int64).reshape(-1)
        shard = keys % self._n
        for i, c in enumerate(self._clients):
            mask = shard == i
            if mask.any():
                c.call("push_sparse", table_id=table_id, keys=keys[mask],
                       grads=grads[mask])

    def sparse_size(self, table_id) -> int:
        return sum(c.call("sparse_size", table_id=table_id)
                   for c in self._clients)

    # ----------------------------------------------------------- sync
    def barrier(self):
        for c in self._clients:
            c.call("barrier")

    def stop_servers(self):
        for c in self._clients:
            try:
                c.call("__stop__")
            except (RuntimeError, ConnectionError, EOFError):
                pass

    def close(self):
        for c in self._clients:
            c.close()
