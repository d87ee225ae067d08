"""Fleet executor: the port of ``paddle_tpu/distributed/fleet_executor.py``,
an actor-style task runtime (reference: paddle/fluid/distributed/
fleet_executor — Carrier carrier.h:50, Interceptor interceptor.h:51 message
loops, TaskNode task graph, brpc MessageBus, interceptor_message.proto
message types).

The reference drives pipeline stages with it as message-passing loops over
micro-batches; here it runs host-side orchestration (data pumps,
heterogeneous stages, inference DAGs such as a model split into stages)
with the same Carrier/Interceptor/TaskNode surface, threads as actors, and
the credit-based DATA_IS_READY / DATA_IS_USELESS flow control of the
reference's compute_interceptor.cc. Interceptors are threads of one
process: a program that issues CUDA work from them issues it on the
process's current device, in the order the flow control runs them."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Optional

# message types (reference interceptor_message.proto:20)
STOP = "STOP"
DATA_IS_READY = "DATA_IS_READY"
DATA_IS_USELESS = "DATA_IS_USELESS"
ERR = "ERR"
RESET = "RESET"
START = "START"


class InterceptorMessage:
    __slots__ = ("src_id", "dst_id", "message_type", "scope_idx",
                 "payload")

    def __init__(self, src_id=0, dst_id=0, message_type=RESET,
                 scope_idx=0, payload=None):
        self.src_id = src_id
        self.dst_id = dst_id
        self.message_type = message_type
        self.scope_idx = scope_idx
        self.payload = payload


class TaskNode:
    """A schedulable unit: runs `program` max_run_times times (one per
    micro-batch) with bounded buffers to up/downstream (reference
    task_node.h)."""

    def __init__(self, rank: int = 0, task_id: int = 0,
                 max_run_times: int = 1, program: Optional[Callable] = None,
                 node_type: str = "Compute"):
        self.rank = rank
        self.task_id = task_id
        self.max_run_times = max_run_times
        self.program = program
        self.node_type = node_type
        self.upstream: Dict[int, int] = {}     # id -> buffer credit
        self.downstream: Dict[int, int] = {}

    def add_upstream_task(self, task_id: int, buffer_size: int = 2):
        self.upstream[task_id] = buffer_size

    def add_downstream_task(self, task_id: int, buffer_size: int = 2):
        self.downstream[task_id] = buffer_size


class Interceptor(threading.Thread):
    """Actor: one thread + one mailbox; subclasses react to messages
    (reference interceptor.h:51 RegisterMsgHandle/LoopOnce)."""

    def __init__(self, interceptor_id: int, node: TaskNode,
                 carrier: "Carrier"):
        super().__init__(daemon=True)
        self.interceptor_id = interceptor_id
        self.node = node
        self.carrier = carrier
        self.mailbox: "queue.Queue[InterceptorMessage]" = queue.Queue()
        self._stopped = False

    def send(self, dst_id: int, msg_type: str, scope_idx=0, payload=None):
        self.carrier.send(InterceptorMessage(
            src_id=self.interceptor_id, dst_id=dst_id,
            message_type=msg_type, scope_idx=scope_idx, payload=payload))

    def enqueue(self, msg: InterceptorMessage):
        self.mailbox.put(msg)

    def run(self):
        while not self._stopped:
            msg = self.mailbox.get()
            if msg.message_type == STOP:
                self._stopped = True
                self.handle_stop(msg)
                break
            try:
                self.handle(msg)
            except Exception as e:  # ERR propagation to carrier
                self.carrier.record_error(self.interceptor_id, e)
                break

    def handle(self, msg: InterceptorMessage):
        raise NotImplementedError

    def handle_stop(self, msg: InterceptorMessage):
        pass


class ComputeInterceptor(Interceptor):
    """Credit-based compute actor (reference compute_interceptor.cc):
    runs when every upstream has data ready and every downstream has
    buffer credit; emits DATA_IS_READY downstream and DATA_IS_USELESS
    upstream after each run."""

    def __init__(self, interceptor_id, node, carrier):
        super().__init__(interceptor_id, node, carrier)
        self._ready: Dict[int, int] = {u: 0 for u in node.upstream}
        self._credit: Dict[int, int] = dict(node.downstream)
        self._pending: Dict[int, List] = {u: [] for u in node.upstream}
        self._run_count = 0

    def _can_run(self):
        ups_ok = all(n > 0 for n in self._ready.values())
        down_ok = all(c > 0 for c in self._credit.values())
        return ups_ok and down_ok and \
            self._run_count < self.node.max_run_times

    def _try_run(self):
        while self._can_run():
            inputs = {u: self._pending[u].pop(0)
                      for u in self._pending if self._pending[u]}
            for u in self._ready:
                self._ready[u] -= 1
            out = None
            if self.node.program is not None:
                out = self.node.program(self._run_count, inputs)
            self._run_count += 1
            for d in self._credit:
                self._credit[d] -= 1
                self.send(d, DATA_IS_READY, scope_idx=self._run_count - 1,
                          payload=out)
            for u in self.node.upstream:
                self.send(u, DATA_IS_USELESS)
            if self._run_count >= self.node.max_run_times:
                self.carrier.notify_done(self.interceptor_id)

    def handle(self, msg: InterceptorMessage):
        if msg.message_type == START:
            self._try_run()
        elif msg.message_type == DATA_IS_READY:
            self._ready[msg.src_id] += 1
            self._pending[msg.src_id].append(msg.payload)
            self._try_run()
        elif msg.message_type == DATA_IS_USELESS:
            self._credit[msg.src_id] += 1
            self._try_run()


class SourceInterceptor(ComputeInterceptor):
    """Head of the DAG: has no upstream; runs on START until its
    micro-batches are exhausted (reference source_interceptor.cc)."""


class SinkInterceptor(ComputeInterceptor):
    """Tail of the DAG (reference sink_interceptor.cc): signals carrier
    completion after the final micro-batch."""


_BY_TYPE = {"Source": SourceInterceptor, "Compute": ComputeInterceptor,
            "Sink": SinkInterceptor}


class Carrier:
    """Owns the interceptors of one rank; routes messages; intra-process
    delivery is direct enqueue, cross-carrier via MessageBus (reference
    carrier.h:50)."""

    def __init__(self, rank: int = 0, message_bus: "MessageBus" = None):
        self.rank = rank
        self._interceptors: Dict[int, Interceptor] = {}
        self._bus = message_bus
        self._done = threading.Event()
        self._sinks: List[int] = []
        self._done_count = 0
        self._lock = threading.Lock()
        self._error: Optional[Exception] = None
        if message_bus is not None:
            message_bus.register_carrier(rank, self)

    def set_interceptor(self, interceptor_id: int, icpt: Interceptor):
        self._interceptors[interceptor_id] = icpt

    def add_task_node(self, node: TaskNode, cls=None) -> Interceptor:
        """An interceptor for ``node``: ``cls``, or the class its
        ``node_type`` names (Source, Compute or Sink)."""
        cls = cls or _BY_TYPE[node.node_type]
        icpt = cls(node.task_id, node, self)
        self.set_interceptor(node.task_id, icpt)
        self._sinks.append(node.task_id)   # done = ALL local actors done
        return icpt

    def send(self, msg: InterceptorMessage) -> bool:
        icpt = self._interceptors.get(msg.dst_id)
        if icpt is not None:
            icpt.enqueue(msg)
            return True
        if self._bus is not None:
            return self._bus.send(msg)
        raise KeyError(f"no interceptor {msg.dst_id} and no message bus")

    def enqueue_interceptor_message(self, msg: InterceptorMessage) -> bool:
        return self.send(msg)

    def record_error(self, interceptor_id: int, err: Exception):
        self._error = err
        self._done.set()

    def notify_done(self, interceptor_id: int):
        with self._lock:
            self._done_count += 1
            if self._done_count >= len(self._sinks):
                self._done.set()

    def start(self, timeout: float = 120.0):
        """Kick every interceptor, START the sources, block until all
        sinks finish the final micro-batch (reference Carrier::Start)."""
        self._done.clear()
        self._done_count = 0
        for icpt in self._interceptors.values():
            if not icpt.is_alive():
                icpt.start()
        for icpt in self._interceptors.values():
            if not icpt.node.upstream:
                icpt.enqueue(InterceptorMessage(dst_id=icpt.interceptor_id,
                                                message_type=START))
        if not self._done.wait(timeout):
            raise TimeoutError("fleet executor did not finish")
        if self._error is not None:
            raise self._error

    def stop(self):
        for icpt in self._interceptors.values():
            icpt.enqueue(InterceptorMessage(message_type=STOP))


class MessageBus:
    """Routes messages between carriers (ranks) of one process, an
    in-process registry; the reference's brpc bus also spans hosts."""

    def __init__(self):
        self._carriers: Dict[int, Carrier] = {}
        self._routes: Dict[int, int] = {}   # interceptor -> rank

    def register_carrier(self, rank: int, carrier: Carrier):
        self._carriers[rank] = carrier

    def register_route(self, interceptor_id: int, rank: int):
        self._routes[interceptor_id] = rank

    def send(self, msg: InterceptorMessage) -> bool:
        rank = self._routes.get(msg.dst_id)
        if rank is None or rank not in self._carriers:
            return False
        carrier = self._carriers[rank]
        icpt = carrier._interceptors.get(msg.dst_id)
        if icpt is None:
            return False
        icpt.enqueue(msg)
        return True


class FleetExecutor:
    """Top-level driver (reference fleet_executor.h): builds one carrier
    per rank from task nodes and runs the DAG."""

    def __init__(self, exe_desc=None):
        self._bus = MessageBus()
        self._carriers: Dict[int, Carrier] = {}

    def carrier(self, rank: int = 0) -> Carrier:
        if rank not in self._carriers:
            self._carriers[rank] = Carrier(rank, self._bus)
        return self._carriers[rank]

    def init(self, rank: int, task_nodes: List[TaskNode]):
        car = self.carrier(rank)
        for node in task_nodes:
            self._bus.register_route(node.task_id, rank)
            car.add_task_node(node)
        return car

    def run(self, timeout: float = 120.0):
        """Start every carrier and wait for all of them: an interceptor's
        error is raised here, and so is a carrier that did not finish
        within ``timeout`` (the reference's run returns then)."""
        errors = []

        def start(car):
            try:
                car.start(timeout=timeout)
            except Exception as e:     # raised in the caller's thread below
                errors.append(e)

        threads = [threading.Thread(target=start, args=(car,))
                   for car in self._carriers.values()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def stop(self):
        for car in self._carriers.values():
            car.stop()
