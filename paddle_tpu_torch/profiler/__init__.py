"""paddle.profiler: the port of ``paddle_tpu/profiler`` (reference:
python/paddle/profiler/profiler.py:358 — scheduler windows, chrome-tracing
export, statistics tables — over the C++ HostTracer and CUPTI CudaTracer,
fluid/platform/profiler/).

Host spans: ``RecordEvent`` spans and one ``op::<name>`` span an eager op
(``core.dispatch.add_op_observer``) go to the native tracer
(``native/src/tracer.cc``). Device timeline: where the targets include the
GPU and a card is there, ``torch.profiler`` records the CUDA activity (CUPTI)
while the profiler records, and its kernel rows are merged into the
exported chrome trace beside the host spans (``pid`` 1), on the host
clock.

The scheduler's states gate the recording (the reference's port records
from ``start`` to ``stop`` whatever the state): spans, op spans and kernel
rows are taken only in steps whose state is ``RECORD`` or
``RECORD_AND_RETURN``; without a scheduler every step records. A ``READY``
step starts the device tracer, so that its start (some ms; seconds the
first time in a process) falls outside the recorded steps, and so do the
first kernel launches of the tracer's window: late in a long-running
process some of the launches of a window's first ms (torch's and the
port's alike) lack their device rows, whatever time the tracer has run
before. A recording that no READY step precedes (no scheduler, or
``ready=0``) starts its tracer with a warm-up instead: a burst of small
kernel launches (and one of the port's attention kernels where its
library is loaded, counted as its launches are) before the recording's
marker, as a READY step's launches precede it. A launch of the recording
without its row is still counted (``device_launches_unrecorded``, with
the host op that made it) and warned of. A kernel
belongs to the recording when the runtime call that launched it
(``cudaLaunchKernel`` and the like, matched by CUPTI's correlation id) comes
after a marker the recording opens in the tracer's own clock; device
timestamps decide nothing, since a kernel queued in a ``READY`` step may
run after that marker. The op observer is removed whenever the profiler
stops recording, since ``run_op`` takes its slow path while any observer
is present.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import time
import warnings
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional

from .. import native as _native
from ..core import dispatch as _dispatch


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    CUSTOM_DEVICE = 2


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)


@dataclass
class _TraceEvent:
    """One event of a device tracer's window, in µs from its start."""
    name: str
    cuda: bool
    cid: int            # CUPTI's correlation id: a launch and its kernel
    start_us: float
    end_us: float
    device: int = 0
    tid: int = 0


@dataclass
class _Span:
    name: str
    start_us: float
    end_us: float = 0.0
    tid: int = 0
    pid: int = 0


def _now_us():
    # CLOCK_MONOTONIC, the clock of the native tracer's steady_clock
    return time.perf_counter_ns() / 1e3


class RecordEvent:
    """A host span (reference platform::RecordEvent), recorded by the native
    tracer while a profiler records."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._open = False

    def begin(self):
        if _ACTIVE.recording:
            _native.tracer_begin(self.name)
            self._open = True

    def end(self):
        if self._open:
            # pop the native span stack once begin() pushed, even if the
            # recording stopped in between: an unmatched entry would shift
            # every later span of this thread
            _native.tracer_end()
            self._open = False

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


class _Active:
    """Whether some profiler records now (RecordEvent reads it)."""
    recording = False


_ACTIVE = _Active()


def make_scheduler(closed=0, ready=0, record=1, repeat=0, skip_first=0):
    """The reference's make_scheduler window state machine."""
    total = closed + ready + record

    def scheduler(step: int):
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * total:
            return ProfilerState.CLOSED
        pos = s % total
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == total - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def export_chrome_tracing(dir_name: str, worker_name: str = None):
    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        path = os.path.join(
            dir_name, f"{worker_name or 'worker'}_{int(time.time())}.json")
        prof._export_chrome(path)
        print(f"[profiler] chrome trace written to {path}")
    return handler


_ALIGN = "paddle_profiler::align"
_RECORD = "paddle_profiler::record"
# the CUDA runtime and driver calls that launch or enqueue device work
_RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]\w*$")
# a window without a READY step: its warm-up's launches and seconds
WARM_LAUNCHES, WARM_S = 4000, 0.05


class _DeviceTracer:
    """One ``torch.profiler`` window of CUDA activity; ``stop`` returns the
    kernel rows launched after ``mark_record`` as spans on the host clock.
    The clocks' offset comes from an align marker opened between two reads
    of the host clock."""

    def __init__(self):
        import torch
        self._torch = torch
        self._prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        self._marked = False
        self.unrecorded = []

    def start(self):
        self._prof.__enter__()
        t0 = _now_us()
        with self._torch.profiler.record_function(_ALIGN):
            pass
        self._t0 = (t0 + _now_us()) / 2

    def warm_up(self):
        """A READY step's part for a window opened without one: at least
        WARM_LAUNCHES small kernel launches over WARM_S seconds
        (elementwise, reduction, GEMM) and, where the port's attention
        kernels are loaded, one library forward at a small shape, all
        finished before the marker."""
        torch = self._torch
        x = torch.ones(64, 64, device="cuda")
        launches, t_end = 0, time.perf_counter() + WARM_S
        while launches < WARM_LAUNCHES or time.perf_counter() < t_end:
            x = torch.addmm(x, x, x, beta=0.5, alpha=1e-3).clamp_(-1, 1)
            x = x + torch.arange(64, device=x.device).mul(1e-3).sum()
            launches += 5
        from ..ops.hopper import _build
        if "blocked_flash" in _build._loaded:
            from ..ops.hopper import flash_attention
            q = torch.zeros(1, 1, 128, 64, dtype=torch.bfloat16,
                            device=x.device)
            flash_attention.library_flash_fwd_cuda(q, q, q, 0.125, True)
        torch.cuda.synchronize()

    def mark_record(self):
        """Kernels launched from here on are the recording's."""
        with self._torch.profiler.record_function(_RECORD):
            pass
        self._marked = True

    def _events(self) -> List[_TraceEvent]:
        """The window's events off torch.profiler's raw (kineto) results,
        which it never parses into its own event tree here."""
        results = self._prof.profiler.kineto_results
        base = results.trace_start_ns()
        cuda = self._torch.autograd.DeviceType.CUDA
        out = []
        for e in results.events():
            start = (e.start_ns() - base) / 1e3
            out.append(_TraceEvent(e.name(), e.device_type() == cuda,
                                   e.correlation_id(), start,
                                   start + e.duration_ns() / 1e3,
                                   e.device_index(), e.start_thread_id()))
        return out

    def stop(self) -> List[_Span]:
        """The recording's kernel rows; raises if a marker is missing from
        the tracer's events (no offset, or no recording start, to go by)."""
        self._torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        if not self._marked:
            return []
        events = self._events()
        marks, launched, kernel_launches, ops = {}, {}, {}, []
        for e in events:
            if e.cuda:
                continue
            if e.name in (_ALIGN, _RECORD):
                marks.setdefault(e.name, e.start_us)
            elif _RUNTIME_CALL.match(e.name):
                launched[e.cid] = e.start_us
                if "Launch" in e.name:
                    kernel_launches[e.cid] = e
            else:
                ops.append(e)
        missing = [m for m in (_ALIGN, _RECORD) if m not in marks]
        if missing:
            raise RuntimeError(f"profiler: the device trace lacks its "
                               f"marker(s) {missing}; its kernel rows "
                               "cannot be placed")
        offset = self._t0 - marks[_ALIGN]
        # launches of the recording that CUPTI gave no device row: (the
        # call, its correlation id, its µs after the recording's marker,
        # the op that made it)
        rows = {e.cid for e in events if e.cuda}
        lost = sorted((e for cid, e in kernel_launches.items()
                       if e.start_us >= marks[_RECORD] and cid not in rows),
                      key=lambda e: e.start_us)
        op_of = _enclosing_ops(ops, lost)
        self.unrecorded = [(e.name, e.cid, e.start_us - marks[_RECORD],
                            op_of[e.cid]) for e in lost]
        # a kernel cannot start before its launch: one with no launch
        # call in the trace goes by its own start
        return [_Span(e.name, e.start_us + offset, e.end_us + offset,
                      e.device, pid=1)
                for e in events if e.cuda
                and launched.get(e.cid, e.start_us) >= marks[_RECORD]]


def _enclosing_ops(ops, launches) -> Dict[int, str]:
    """{correlation id: name of the innermost host op (on the launch's
    thread) whose span holds the launch, or ""} for each of ``launches``:
    one sweep a thread in time order, with the spans that are open (on one
    thread they nest) on a stack."""
    spans: Dict[int, List[_TraceEvent]] = {}
    for o in sorted(ops, key=lambda o: o.start_us):
        spans.setdefault(o.tid, []).append(o)
    nxt: Dict[int, int] = {}
    stacks: Dict[int, List[_TraceEvent]] = {}
    out = {}
    for e in sorted(launches, key=lambda e: e.start_us):
        mine, stack = spans.get(e.tid, []), stacks.setdefault(e.tid, [])
        i = nxt.get(e.tid, 0)
        while i < len(mine) and mine[i].start_us <= e.start_us:
            while stack and stack[-1].end_us < mine[i].start_us:
                stack.pop()
            stack.append(mine[i])
            i += 1
        nxt[e.tid] = i
        while stack and stack[-1].end_us < e.start_us:
            stack.pop()
        out[e.cid] = stack[-1].name if stack else ""
    return out


class Profiler:
    """The reference profiler.py:358 surface."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 timer_only=False, record_shapes=False, profile_memory=False,
                 with_flops=False):
        if callable(scheduler):
            self.scheduler = scheduler
        elif isinstance(scheduler, (tuple, list)):
            self.scheduler = make_scheduler(
                record=scheduler[1] - scheduler[0], closed=scheduler[0])
        else:
            self.scheduler = None
        self.targets = list(targets) if targets is not None else [
            ProfilerTarget.CPU, ProfilerTarget.GPU]
        self.on_trace_ready = on_trace_ready
        self.timer_only = timer_only
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._recording = False
        self._op_unhook = None
        self._device = None
        self._host_spans: List[_Span] = []
        self._device_spans: List[_Span] = []
        # kernel launches of the recorded steps with no device row: (the
        # call, its correlation id, µs after its window's recording began,
        # the host op that made it)
        self.device_launches_unrecorded: List[tuple] = []
        self._step_info = _StepInfo()

    # ---- lifecycle ----
    def _wants_device(self):
        if ProfilerTarget.GPU not in self.targets:
            return False
        import torch
        return torch.cuda.is_available()

    def _start_device(self):
        if self._device is None and not self.timer_only \
                and self._wants_device():
            self._device = _DeviceTracer()
            self._device.start()

    def _begin_recording(self):
        if self._recording or self.timer_only:
            return
        if self._device is None:
            # no READY step started the tracer: its warm-up stands in
            self._start_device()
            if self._device is not None:
                self._device.warm_up()
        _native.tracer_enable(True)
        self._op_unhook = _dispatch.add_op_observer(self._op_span)
        if self._device is not None:
            self._device.mark_record()
        self._recording = True
        _ACTIVE.recording = True

    def _end_recording(self):
        if self._device is not None:
            device, self._device = self._device, None
            self._device_spans += device.stop()
            self.device_launches_unrecorded += device.unrecorded
            if device.unrecorded:
                warnings.warn(f"profiler: {len(device.unrecorded)} kernel "
                              "launches of the recording have no device "
                              "row (the first: "
                              f"{device.unrecorded[:3]})")
        if not self._recording:
            return
        self._recording = False
        _ACTIVE.recording = False
        if self._op_unhook is not None:
            self._op_unhook()
            self._op_unhook = None
        _native.tracer_enable(False)
        # the native tracer is one buffer a process: the spans move here,
        # where the next window or another profiler's start cannot clear
        # them
        self._host_spans += self._native_spans()
        _native.tracer_clear()

    def _set_state(self, state):
        self.current_state = state
        if state in _RECORDING:
            self._begin_recording()
        elif state == ProfilerState.READY:
            self._end_recording()
            self._start_device()      # its start cost outside the record
        else:
            self._end_recording()

    def start(self):
        _native.tracer_clear()
        self._host_spans = []
        self._device_spans = []
        self.device_launches_unrecorded = []
        self._set_state(ProfilerState.RECORD if self.scheduler is None
                        else self.scheduler(self.step_num))
        self._step_t0 = time.perf_counter()

    def stop(self):
        self._end_recording()
        self.current_state = ProfilerState.CLOSED
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        self._step_info.add(now - self._step_t0, num_samples)
        self._step_t0 = now
        self.step_num += 1
        if self.scheduler is not None:
            self._set_state(self.scheduler(self.step_num))

    def step_info(self, unit=None):
        return self._step_info.summary()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # ---- op-level spans ----
    @staticmethod
    def _op_span(name, outs):
        _native.tracer_record(f"op::{name}", _now_us(), 1.0)

    # ---- export / stats ----
    @staticmethod
    def _native_spans():
        return [_Span(name, start, start + dur, tid)
                for name, start, dur, tid in _native.tracer_spans()]

    def _all_spans(self):
        """The host spans (the native tracer's, those of a window still
        recording too) and the device's kernel rows."""
        live = self._native_spans() if self._recording else []
        return self._host_spans + live + self._device_spans

    def _export_chrome(self, path):
        events = [{"name": s.name, "ph": "X", "ts": s.start_us,
                   "dur": max(s.end_us - s.start_us, 0.001),
                   "pid": s.pid, "tid": s.tid,
                   "cat": "kernel" if s.pid else "host"}
                  for s in self._all_spans()]
        events.append({"name": "process_name", "ph": "M", "pid": 1,
                       "args": {"name": "gpu"}})
        events.extend(self._metric_counter_events())
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)

    @staticmethod
    def _metric_counter_events():
        """The observability registry's snapshot as chrome-tracing counter
        ('ph': 'C') events, in the same trace as the spans."""
        from ..observability import metrics as _met
        events = []
        ts = _now_us()
        for d in _met.REGISTRY.snapshot():
            name = d["name"]
            if d["labels"]:
                lab = ",".join(f"{k}={v}"
                               for k, v in sorted(d["labels"].items()))
                name = f"{name}{{{lab}}}"
            if d["type"] == "histogram":
                args = {"count": d["count"], "sum": d["sum"]}
                if "p50" in d:
                    args["p50"] = d["p50"]
                    args["p99"] = d["p99"]
            else:
                args = {"value": d["value"]}
            events.append({"name": f"metric::{name}", "ph": "C",
                           "ts": ts, "pid": 0, "args": args})
        return events

    def export(self, path, format="json"):
        self._export_chrome(path)

    def summary(self, sorted_by=None, op_detail=True, thread_sep=False,
                time_unit="ms"):
        """Calls and total µs by name, host spans and kernels in two
        tables (the 40 largest of each); printed and returned."""
        tables = []
        for title, pid in (("host", 0), ("device", 1)):
            agg: Dict[str, List[float]] = {}
            for s in self._all_spans():
                if s.pid == pid:
                    agg.setdefault(s.name, []).append(s.end_us - s.start_us)
            if pid and not agg:
                continue
            lines = [f"{title + ' name':<60}{'calls':>8}{'total(us)':>14}"]
            for name, durs in sorted(agg.items(),
                                     key=lambda kv: -sum(kv[1]))[:40]:
                lines.append(f"{name[:59]:<60}{len(durs):>8}"
                             f"{sum(durs):>14.1f}")
            tables.append("\n".join(lines))
        table = "\n\n".join(tables)
        print(table)
        return table


class _StepInfo:
    def __init__(self):
        self.times = []
        self.samples = []

    def add(self, dt, n):
        self.times.append(dt)
        if n:
            self.samples.append(n)

    def summary(self):
        if not self.times:
            return ""
        avg = sum(self.times) / len(self.times)
        ips = (sum(self.samples) / len(self.samples) / avg) \
            if self.samples else 0
        return f"avg_step {avg * 1e3:.2f} ms, ips {ips:.1f} samples/s"


@contextlib.contextmanager
def profile(*args, **kwargs):
    p = Profiler(*args, **kwargs)
    p.start()
    try:
        yield p
    finally:
        p.stop()


def load_profiler_result(path):
    with open(path) as f:
        return json.load(f)


__all__ = ["ProfilerTarget", "ProfilerState", "RecordEvent",
           "make_scheduler", "export_chrome_tracing", "Profiler", "profile",
           "load_profiler_result"]
