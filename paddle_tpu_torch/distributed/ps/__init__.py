"""Parameter-server training runtime: the port of
``paddle_tpu/distributed/ps`` (reference: paddle/fluid/distributed/ps — brpc
PS with dense, sparse and geo tables — and python/paddle/distributed/fleet's
PS mode).

PS mode serves sparse-dominated workloads (recommender embeddings) whose
embedding table exceeds device memory. The tables are numpy on the server
hosts, as in the reference; the trainer pulls rows to the host, feeds them
to its step on the card as ordinary inputs, and pushes the gradients (or
Geo deltas) back. Role topology (server/worker), the tables' sharding by id
and the geo strategy mirror the reference.

Usage (the reference's fleet PS flow)::

    role = PaddleCloudRoleMaker()          # reads TRAINING_ROLE etc.
    if role.is_server():
        server = PsServer(num_workers=role.worker_num())
        server.run()                       # blocks
    else:
        client = PsClient(role.server_endpoints())
        ...pull/push...
"""
from __future__ import annotations

import os

import numpy as np

from .rpc import RpcClient, RpcServer  # noqa: F401
from .server import PsServer  # noqa: F401
from .table import (  # noqa: F401
    DenseTable, SparseGeoTable, SparseTable,
)
from .worker import PsClient  # noqa: F401


class PaddleCloudRoleMaker:
    """Role discovery from the environment (reference
    fleet/base/role_maker.py PaddleCloudRoleMaker): TRAINING_ROLE=TRAINER|
    PSERVER, PADDLE_PSERVERS_IP_PORT_LIST, PADDLE_TRAINERS_NUM,
    PADDLE_TRAINER_ID, PADDLE_PORT."""

    def __init__(self, is_collective=False, **kwargs):
        self._role = os.environ.get("TRAINING_ROLE", "TRAINER")
        self._servers = [e for e in os.environ.get(
            "PADDLE_PSERVERS_IP_PORT_LIST", "").split(",") if e]
        self._num_workers = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        self._worker_id = int(os.environ.get("PADDLE_TRAINER_ID", 0))
        self._port = int(os.environ.get("PADDLE_PORT", 0))

    def is_server(self):
        return self._role == "PSERVER"

    def is_worker(self):
        return self._role == "TRAINER"

    def is_first_worker(self):
        return self.is_worker() and self._worker_id == 0

    def worker_num(self):
        return self._num_workers

    def worker_index(self):
        return self._worker_id

    def server_num(self):
        return len(self._servers)

    def server_endpoints(self):
        return list(self._servers)

    def server_port(self):
        return self._port


class GeoWorker:
    """Geo-SGD asynchronous worker (reference GeoSGD): trains a local
    replica of the rows it touched, pushes the parameter deltas every
    ``push_interval`` steps and pulls the fresh global rows; the geo table
    adds the deltas."""

    def __init__(self, client: PsClient, table_id: int, dim: int,
                 push_interval: int = 10):
        self._client = client
        self._table_id = table_id
        self._dim = dim
        self._interval = push_interval
        self._step = 0
        self._local = {}       # id -> local row
        self._base = {}        # id -> row at the last sync

    def lookup(self, keys):
        """Pull the rows not seen yet; return the local replica's rows."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        missing = [k for k in keys.tolist() if k not in self._local]
        if missing:
            rows = self._client.pull_sparse(self._table_id,
                                            np.asarray(missing, np.int64))
            for k, r in zip(missing, rows):
                self._local[k] = r.copy()
                self._base[k] = r.copy()
        return np.stack([self._local[int(k)] for k in keys])

    def apply_grads(self, keys, grads, lr):
        keys = np.asarray(keys, np.int64).reshape(-1)
        for k, g in zip(keys.tolist(), grads):
            self._local[k] -= lr * g
        self._step += 1
        if self._step % self._interval == 0:
            self.sync()

    def sync(self):
        """Push the local deltas; the pushed state becomes the base."""
        if not self._local:
            return
        keys = np.asarray(list(self._local), np.int64)
        deltas = np.stack([self._local[int(k)] - self._base[int(k)]
                           for k in keys])
        self._client.push_sparse(self._table_id, keys, deltas)
        rows = self._client.pull_sparse(self._table_id, keys)
        for k, r in zip(keys.tolist(), rows):
            self._local[k] = r.copy()
            self._base[k] = r.copy()


__all__ = [
    "PsServer", "PsClient", "DenseTable", "SparseTable",
    "SparseGeoTable", "PaddleCloudRoleMaker", "GeoWorker", "RpcServer",
    "RpcClient",
]
