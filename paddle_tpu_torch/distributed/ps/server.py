"""PS server: owns tables, serves push/pull/barrier (reference:
paddle/fluid/distributed/ps/service/brpc_ps_server.cc +
ps_service/service.cc)."""
from __future__ import annotations

import threading

from .rpc import RpcServer
from .table import DenseTable, SparseGeoTable, SparseTable


class PsServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 num_workers: int = 1):
        self._tables = {}
        self._num_workers = num_workers
        self._barrier_lock = threading.Lock()
        self._barrier_cond = threading.Condition(self._barrier_lock)
        self._barrier_count = 0
        self._barrier_gen = 0
        self._rpc = RpcServer(host, port, self._handle)
        self.port = self._rpc.port

    # ------------------------------------------------------------ rpc
    def _handle(self, method, kw):
        return getattr(self, "_rpc_" + method)(**kw)

    def _rpc_create_dense_table(self, table_id, size, optimizer="sgd",
                                **opt_kw):
        if table_id not in self._tables:
            self._tables[table_id] = DenseTable(size, optimizer, **opt_kw)

    def _rpc_create_sparse_table(self, table_id, dim, optimizer="sgd",
                                 geo=False, **opt_kw):
        if table_id not in self._tables:
            cls = SparseGeoTable if geo else SparseTable
            kw = dict(opt_kw)
            if not geo:
                kw["optimizer"] = optimizer
            self._tables[table_id] = cls(dim, **kw)

    def _rpc_pull_dense(self, table_id):
        return self._tables[table_id].pull()

    def _rpc_push_dense(self, table_id, grad):
        self._tables[table_id].push(grad)

    def _rpc_set_dense(self, table_id, values):
        self._tables[table_id].set(values)

    def _rpc_pull_sparse(self, table_id, keys):
        return self._tables[table_id].pull(keys)

    def _rpc_push_sparse(self, table_id, keys, grads):
        self._tables[table_id].push(keys, grads)

    def _rpc_sparse_size(self, table_id):
        return self._tables[table_id].size()

    def _rpc_barrier(self):
        with self._barrier_cond:
            gen = self._barrier_gen
            self._barrier_count += 1
            if self._barrier_count >= self._num_workers:
                self._barrier_count = 0
                self._barrier_gen += 1
                self._barrier_cond.notify_all()
            else:
                while gen == self._barrier_gen:
                    self._barrier_cond.wait(timeout=60)

    def _rpc_ping(self):
        return "pong"

    # ------------------------------------------------------- lifecycle
    def start(self):
        self._rpc.start()
        return self

    def run(self):
        """Blocking serve (reference fleet.run_server)."""
        self._rpc.start()
        self._rpc.wait()

    def stop(self):
        self._rpc.stop()
