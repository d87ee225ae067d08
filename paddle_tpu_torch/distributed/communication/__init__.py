"""paddle.distributed.communication: the port of
``paddle_tpu/distributed/communication/__init__.py`` (the group ops live in
``..collective``; this package adds the ``stream.*`` variants)."""
from ..collective import (  # noqa: F401
    all_gather, all_gather_object, all_reduce, alltoall, alltoall_single,
    batch_isend_irecv, broadcast, broadcast_object_list, gather, irecv,
    isend, P2POp, recv, reduce, reduce_scatter, ReduceOp, scatter,
    scatter_object_list, send, wait,
)
from . import stream  # noqa: F401
