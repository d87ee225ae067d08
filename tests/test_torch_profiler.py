"""The port's profiler (``paddle_tpu_torch.profiler``) on the CPU.

Restated from ``tests/test_checkpoint_profiler.py``, whose module imports
jax at the top level and so cannot be bound: ``test_profiler_spans_and_
export`` and ``test_profiler_scheduler`` (the latter against the
reference's own scheduler too). Beside them: the scheduler's states gate
what is recorded, the op observer is removed whenever recording stops (so
``run_op`` leaves its slow path), spans nest on the native tracer, and
``summary`` and ``load_profiler_result`` read what was recorded. The
device tracer's placement of kernel rows (by their launch, against the
recording's marker) runs here over stand-in events; its timeline on the card
(``torch.profiler``'s kernel rows) is checked by
``chip_smoke.py`` phase 20f.
"""
import json
import os

import pytest

import paddle_tpu.profiler as P_profiler
import paddle_tpu_torch as paddle
import paddle_tpu_torch.profiler as profiler
from paddle_tpu_torch._testing import share_the_cores_fixture
from paddle_tpu_torch.core import dispatch

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    paddle.set_device("cpu")


def test_profiler_spans_and_export(tmp_path):
    p = profiler.Profiler(
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path)))
    p.start()
    with profiler.RecordEvent("my_region"):
        x = paddle.randn([32, 32])
        (x @ x).sum().numpy()
    p.step(num_samples=32)
    p.stop()
    files = os.listdir(tmp_path)
    assert any(f.endswith(".json") for f in files)
    with open(tmp_path / [f for f in files if f.endswith(".json")][0]) as f:
        trace = json.load(f)
    names = {e["name"] for e in trace["traceEvents"]}
    assert "my_region" in names
    assert any(n.startswith("op::") for n in names)
    assert "avg_step" in p.step_info()


def test_profiler_scheduler():
    for mod in (P_profiler, profiler):
        sched = mod.make_scheduler(closed=1, ready=1, record=2, repeat=1)
        states = [sched(i) for i in range(5)]
        assert [s.name for s in states] == [
            "CLOSED", "READY", "RECORD", "RECORD_AND_RETURN", "CLOSED"]


def test_scheduler_gates_recording_and_the_op_observer(tmp_path):
    """closed=1, ready=1, record=2 over 4 steps: only steps 2 and 3 leave
    spans, and the op observer is there only while they run."""
    p = profiler.Profiler(scheduler=profiler.make_scheduler(
        closed=1, ready=1, record=2))
    p.start()
    observing = []
    for step in range(4):
        observing.append(bool(dispatch._op_observers))
        with profiler.RecordEvent(f"step{step}"):
            x = paddle.ones([4, 4])
            (x + x).sum()
        p.step()
    p.stop()
    assert observing == [False, False, True, True]
    assert not dispatch._op_observers and not dispatch._slow
    names = [s.name for s in p._all_spans()]
    assert [n for n in names if n.startswith("step")] == ["step2", "step3"]
    assert names.count("op::add") == 2
    path = tmp_path / "t.json"
    p.export(str(path))
    events = profiler.load_profiler_result(str(path))["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert {e["name"] for e in spans} >= {"step2", "step3", "op::add"}
    assert all(e["pid"] == 0 and e["dur"] > 0 for e in spans)
    table = p.summary()
    assert "step2" in table and "op::add" in table


def test_windows_keep_their_spans_past_another_profilers_start():
    """Two recorded windows (``repeat=2``) keep the spans of both, and a
    second profiler's start, which clears the native tracer, takes none of
    them away."""
    p = profiler.Profiler(scheduler=profiler.make_scheduler(
        closed=1, record=1, repeat=2))
    p.start()
    for i in range(4):
        with profiler.RecordEvent(f"step{i}"):
            pass
        p.step()
    p.stop()
    with profiler.Profiler() as q:
        with profiler.RecordEvent("other"):
            pass
    assert [s.name for s in p._all_spans()] == ["step1", "step3"]
    assert [s.name for s in q._all_spans()] == ["other"]


def test_nested_spans_and_a_span_left_open():
    with profiler.Profiler() as p:
        with profiler.RecordEvent("outer"):
            with profiler.RecordEvent("inner"):
                pass
        open_ = profiler.RecordEvent("late")
        open_.begin()
    open_.end()                 # after stop: pops the span it pushed
    spans = {s.name: s for s in p._all_spans()}
    assert spans["outer"].start_us <= spans["inner"].start_us
    assert spans["inner"].end_us <= spans["outer"].end_us
    assert spans["inner"].tid == spans["outer"].tid
    assert all(s.pid == 0 for s in p._all_spans())     # no card here
    # nothing records outside a profiler
    with profiler.RecordEvent("outside"):
        pass
    assert "outside" not in {s.name for s in p._all_spans()}


def test_timer_only_records_no_spans():
    with profiler.Profiler(timer_only=True) as p:
        with profiler.RecordEvent("x"):
            pass
        p.step(num_samples=8)
    assert p._all_spans() == [] and "ips" in p.step_info()


def _event(name, start, end=None, cid=0, cuda=False):
    return profiler._TraceEvent(name, cuda, cid, start,
                                start + 1.0 if end is None else end)


def _tracer_over(events, t0=1000.0):
    """A device tracer whose torch.profiler window holds ``events``."""
    import types
    tracer = object.__new__(profiler._DeviceTracer)
    tracer._torch = types.SimpleNamespace(
        cuda=types.SimpleNamespace(synchronize=lambda: None))
    tracer._prof = types.SimpleNamespace(__exit__=lambda *a: None)
    tracer._events = lambda: events
    tracer._t0, tracer._marked = t0, True
    return tracer


def test_device_rows_belong_to_the_recording_by_their_launch():
    """A kernel launched before the recording's marker but run after it
    (queued in the READY step) is left out; one launched after it is kept
    even where its device time reads earlier than the marker's; kernels
    with no launch call in the trace go by their own start. Rows land on
    the host clock through the align marker."""
    events = [
        _event("paddle_profiler::align", 10.0),
        _event("cudaLaunchKernel", 20.0, cid=1),
        _event("paddle_profiler::record", 30.0),
        _event("cudaLaunchKernel", 40.0, cid=2),
        _event("aten::mm", 41.0, cid=3),          # an op's id, not a launch
        _event("queued_in_ready", 35.0, 36.0, cid=1, cuda=True),
        _event("launched_in_record", 29.0, 33.0, cid=2, cuda=True),
        _event("no_launch_before", 25.0, cid=7, cuda=True),
        _event("no_launch_after", 50.0, cid=3, cuda=True),
    ]
    tracer = _tracer_over(events + [_event("aten::add", 58.0, 62.0),
                                    _event("aten::mul", 59.0, 59.5),
                                    _event("cudaLaunchKernel", 60.0,
                                           cid=9)])
    rows = tracer.stop()
    assert [r.name for r in rows] == ["launched_in_record", "no_launch_after"]
    assert (rows[0].start_us, rows[0].end_us, rows[0].pid) == (1019.0,
                                                               1023.0, 1)
    # no row; the innermost op around the launch made it
    assert tracer.unrecorded == [("cudaLaunchKernel", 9, 30.0, "aten::add")]


@pytest.mark.parametrize("missing", ["paddle_profiler::align",
                                     "paddle_profiler::record"])
def test_device_trace_without_its_markers_raises(missing):
    events = [e for e in (_event("paddle_profiler::align", 10.0),
                          _event("paddle_profiler::record", 30.0),
                          _event("cudaLaunchKernel", 40.0, cid=2),
                          _event("k", 45.0, cid=2, cuda=True))
              if e.name != missing]
    with pytest.raises(RuntimeError, match="marker"):
        _tracer_over(events).stop()


def test_an_unmarked_device_window_has_no_rows():
    """A READY window the profiler stops in before any recorded step."""
    tracer = _tracer_over([_event("k", 45.0, cid=2, cuda=True)])
    tracer._marked = False
    assert tracer.stop() == []


def test_the_profiler_drives_its_device_tracer_in_order(monkeypatch):
    """Without a scheduler the device tracer starts with the recording,
    warms up and then marks it; a launch without its row is kept and
    warned of; with a READY step the tracer starts a step ahead and marks
    the recording without a warm-up."""
    calls = []

    class Tracer:
        def __init__(self):
            self.unrecorded = []

        def start(self):
            calls.append("start")

        def warm_up(self):
            calls.append("warm")

        def mark_record(self):
            calls.append("mark")

        def stop(self):
            calls.append("stop")
            self.unrecorded = [("cuLaunchKernel", 5, 12.0, "op")]
            return [profiler._Span("k", 1.0, 2.0, pid=1)]

    monkeypatch.setattr(profiler, "_DeviceTracer", Tracer)
    monkeypatch.setattr(profiler.Profiler, "_wants_device", lambda self: True)
    p = profiler.Profiler()
    p.start()
    p.step()
    with pytest.warns(UserWarning, match="1 kernel launches"):
        p.stop()
    assert calls == ["start", "warm", "mark", "stop"]
    assert p.device_launches_unrecorded == [("cuLaunchKernel", 5, 12.0,
                                            "op")]
    assert [s.name for s in p._all_spans() if s.pid == 1] == ["k"]
    calls.clear()
    p = profiler.Profiler(scheduler=profiler.make_scheduler(ready=1,
                                                            record=1))
    p.start()
    assert calls == ["start"]
    p.step()
    assert calls == ["start", "mark"]
    with pytest.warns(UserWarning):
        p.stop()
