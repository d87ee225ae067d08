"""PS-mode inference helper: the port of
``paddle_tpu/distributed/fleet/utils/ps_util.py`` (reference
fleet/utils/ps_util.py DistributedInfer: serves sparse-embedding pulls from
the parameter-server tables through a ``distributed.ps.PsClient``)."""
from __future__ import annotations


class DistributedInfer:
    def __init__(self, main_program=None, startup_program=None):
        self._main = main_program
        self._startup = startup_program
        self._client = None

    def init_distributed_infer_env(self, exe=None, loss=None,
                                   role_maker=None, dirname=None):
        """Connects to the running ps servers (endpoints from the role
        maker, by default ``PaddleCloudRoleMaker`` over the environment);
        no endpoints, or a failure to connect, leave no client, as the
        reference's. Dense params are expected to be loaded already
        (dirname accepted for parity)."""
        try:
            from ...ps import PaddleCloudRoleMaker, PsClient
            role = role_maker or PaddleCloudRoleMaker()
            eps = role.server_endpoints()
            self._client = PsClient(eps) if eps else None
        except Exception:
            self._client = None
        return self

    def get_dist_infer_program(self):
        """No program rewrite (embedding pulls go through the ps client at
        call sites): the program unchanged, as the reference's."""
        return self._main

    def pull_sparse(self, table_id, ids):
        if self._client is None:
            raise RuntimeError(
                "DistributedInfer: ps client not initialized; call "
                "init_distributed_infer_env() under fleet PS mode")
        return self._client.pull_sparse(table_id, ids)
