"""PS-mode inference helper: the port of
``paddle_tpu/distributed/fleet/utils/ps_util.py`` (reference
fleet/utils/ps_util.py DistributedInfer: serves sparse-embedding pulls from
the parameter-server tables).

The port has no parameter server yet (ROADMAP queue 1, item 5): the client
is never bound, and ``pull_sparse`` raises as the reference's does without
one."""
from __future__ import annotations


class DistributedInfer:
    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program
        self._startup = startup_program
        self._client = None

    def init_distributed_infer_env(self, exe=None, loss=None,
                                   role_maker=None, dirname=None):
        """Binds no client: the parameter-server slice brings one."""
        self._client = None
        return self

    def get_dist_infer_program(self):
        return self._main

    def pull_sparse(self, table_id, ids):
        if self._client is None:
            raise RuntimeError(
                "DistributedInfer: ps client not initialized; call "
                "init_distributed_infer_env() under fleet PS mode")
        return self._client.pull_sparse(table_id, ids)
