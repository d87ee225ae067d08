"""paddle.distributed.rpc: the port of ``paddle_tpu/distributed/rpc.py``
(reference: python/paddle/distributed/rpc/rpc.py — init_rpc/rpc_sync/
rpc_async over the C++ brpc agent).

Host-side control-plane RPC between worker processes; rides the same
length-prefixed socket RPC as the parameter server
(distributed/ps/rpc.py). Functions are pickled by fully-qualified name
+ args, executed on the callee's process."""
from __future__ import annotations

import os
import pickle
import threading
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Optional

from .ps.rpc import RpcClient, RpcServer

__all__ = ["init_rpc", "rpc_sync", "rpc_async", "shutdown",
           "get_worker_info", "get_all_worker_infos", "WorkerInfo"]


@dataclass
class WorkerInfo:
    name: str
    rank: int
    ip: str
    port: int


_state = {"server": None, "workers": {}, "clients": {}, "me": None}
_lock = threading.Lock()


def _handle(method, kw):
    if method == "register":
        _state["workers"][kw["name"]] = WorkerInfo(**kw)
        return {n: vars(w) for n, w in _state["workers"].items()}
    if method == "workers":
        return {n: vars(w) for n, w in _state["workers"].items()}
    if method == "invoke":
        fn = pickle.loads(kw["fn"])
        args = pickle.loads(kw["args"])
        kwargs = pickle.loads(kw["kwargs"])
        return fn(*args, **kwargs)
    raise ValueError(f"unknown rpc method {method}")


def init_rpc(name: str, rank: Optional[int] = None,
             world_size: Optional[int] = None,
             master_endpoint: Optional[str] = None):
    """Start this process's RPC service and register with the master
    (rank 0 acts as the registry, the reference's barrier-store role)."""
    rank = rank if rank is not None else int(
        os.environ.get("PADDLE_TRAINER_ID", 0))
    world_size = world_size if world_size is not None else int(
        os.environ.get("PADDLE_TRAINERS_NUM", 1))
    master = master_endpoint or os.environ.get(
        "PADDLE_MASTER_ENDPOINT", "127.0.0.1:29400")
    host, mport = master.rsplit(":", 1)
    with _lock:
        if rank == 0:
            _state["server"] = RpcServer("0.0.0.0", int(mport),
                                         _handle).start()
            me = WorkerInfo(name, rank, host, int(mport))
            _state["workers"][name] = me
        else:
            _state["server"] = RpcServer("0.0.0.0", 0, _handle).start()
            me = WorkerInfo(name, rank, "127.0.0.1",
                            _state["server"].port)
            c = RpcClient(master)
            infos = c.call("register", **vars(me))
            _state["workers"] = {n: WorkerInfo(**w)
                                 for n, w in infos.items()}
            _state["clients"][master] = c
        _state["me"] = me


def _client_for(to: str) -> RpcClient:
    w = _state["workers"].get(to)
    if w is None:
        # refresh registry from master
        for c in _state["clients"].values():
            infos = c.call("workers")
            _state["workers"] = {n: WorkerInfo(**x)
                                 for n, x in infos.items()}
        w = _state["workers"].get(to)
        if w is None:
            raise ValueError(f"unknown rpc worker {to!r}")
    ep = f"{w.ip}:{w.port}"
    if ep not in _state["clients"]:
        _state["clients"][ep] = RpcClient(ep)
    return _state["clients"][ep]


def rpc_sync(to: str, fn, args=None, kwargs=None, timeout=None):
    """Run fn(*args, **kwargs) on worker `to`, return its result
    (reference rpc.py:160)."""
    if _state["me"] is not None and to == _state["me"].name:
        return fn(*(args or ()), **(kwargs or {}))
    c = _client_for(to)
    return c.call("invoke", fn=pickle.dumps(fn),
                  args=pickle.dumps(tuple(args or ())),
                  kwargs=pickle.dumps(dict(kwargs or {})))


def rpc_async(to: str, fn, args=None, kwargs=None, timeout=None):
    """Async variant returning a Future (reference rpc.py:206; the
    reference returns a FutureWrapper with .wait())."""
    fut: Future = Future()

    def run():
        try:
            fut.set_result(rpc_sync(to, fn, args, kwargs, timeout))
        except Exception as e:
            fut.set_exception(e)

    threading.Thread(target=run, daemon=True).start()
    fut.wait = fut.result   # reference API: fut.wait()
    return fut


def get_worker_info(name: str) -> WorkerInfo:
    return _state["workers"][name]


def get_all_worker_infos():
    return list(_state["workers"].values())


def shutdown():
    with _lock:
        for c in _state["clients"].values():
            c.close()
        _state["clients"].clear()
        if _state["server"] is not None:
            _state["server"].stop()
            _state["server"] = None
        _state["workers"].clear()
        _state["me"] = None
