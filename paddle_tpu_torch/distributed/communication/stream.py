"""paddle.distributed.communication.stream: the port of
``paddle_tpu/distributed/communication/stream.py`` (reference:
communication/stream/*.py — collectives on a communication stream that
return async Tasks).

torch.distributed runs each collective on its own stream and orders it after
the current stream's work, so ``use_calc_stream`` changes nothing here;
``sync_op`` is honoured (False returns a Task to ``wait()`` on)."""
from __future__ import annotations

from .. import collective as _c

__all__ = ["all_reduce", "all_gather", "alltoall", "alltoall_single",
           "broadcast", "reduce", "reduce_scatter", "scatter", "send",
           "recv"]


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_reduce(tensor, op, group, sync_op)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    return _c.all_gather(tensor_or_tensor_list, tensor, group, sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    # the reference's stream.alltoall takes (out, in)
    return _c.alltoall(in_tensor_list, out_tensor_list, group, sync_op)


def alltoall_single(out_tensor, in_tensor, out_split_sizes=None,
                    in_split_sizes=None, group=None, sync_op=True,
                    use_calc_stream=False):
    return _c.alltoall_single(in_tensor, out_tensor, in_split_sizes,
                              out_split_sizes, group, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _c.broadcast(tensor, src, group, sync_op)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _c.reduce(tensor, dst, op, group, sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    return _c.reduce_scatter(tensor, tensor_or_tensor_list, op, group,
                             sync_op)


def scatter(tensor, tensor_or_tensor_list=None, src=0, group=None,
            sync_op=True, use_calc_stream=False):
    return _c.scatter(tensor, tensor_or_tensor_list, src, group, sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.send(tensor, dst, group, sync_op)


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    return _c.recv(tensor, src, group, sync_op)
