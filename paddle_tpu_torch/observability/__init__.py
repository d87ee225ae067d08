"""paddle_tpu_torch.observability: the port of ``paddle_tpu/observability``,
the unified telemetry layer.

A process-global metrics registry that the port's layers record into
(eager op dispatches, attention dispatch, serving queue depth, tokens/s
and latencies), with JSON-lines and Prometheus-text exporters, a one-call
``dump()`` snapshot, the read side (``take_snapshot``, ``delta``,
``window``) and the scrape endpoint that serving sessions start
(``server``)::

    import paddle_tpu_torch.observability as obs
    ... run serving ...
    snap = obs.dump()                       # list of metric dicts
    print(obs.to_prometheus())              # scrape format

Off switch: ``PADDLE_TPU_METRICS=off`` (env) or ``obs.disable()``.

``training`` holds the train loop's funnel (``record_step``, ``configure``:
step time, samples/s, tokens/s and MFU against one H100's peak).

Not here yet: the compile tracker (``count_compiles``, ``count_traces``,
``compile_report``), which comes with ``jit/``. Those names raise
``NotImplementedError``.
"""
from __future__ import annotations

import json as _json
import time as _time

from . import catalog  # noqa: F401
from . import server  # noqa: F401
from . import training  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, Registry,
    enable, disable, enabled,
)
from .server import MetricsServer  # noqa: F401
from .snapshots import (  # noqa: F401
    Snapshot, SnapshotDelta, delta, window,
)

_LATER = {
    "compile_tracker": "jit/", "count_compiles": "jit/",
    "count_traces": "jit/", "compile_report": "jit/",
}


def __getattr__(name):
    if name in _LATER:
        raise NotImplementedError(
            f"paddle_tpu_torch.observability.{name} comes with "
            f"{_LATER[name]} of the port (ROADMAP queue 1)")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


def take_snapshot() -> Snapshot:
    """Indexed read-side view of the live registry (snapshots.py)."""
    return Snapshot.take()


def counter(name, **labels):
    return REGISTRY.counter(name, **labels)


def gauge(name, **labels):
    return REGISTRY.gauge(name, **labels)


def histogram(name, **labels):
    return REGISTRY.histogram(name, **labels)


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()


def to_jsonl() -> str:
    return REGISTRY.to_jsonl()


def reset() -> None:
    REGISTRY.reset()


def dump(path=None, format: str = "json"):
    """Snapshot the registry. Returns the snapshot list; when `path`
    is given also writes it there — format 'json' (one document),
    'jsonl' (one line per metric) or 'prom' (Prometheus text)."""
    snap = REGISTRY.snapshot()
    if path is not None:
        if format == "prom":
            text = to_prometheus()
        elif format == "jsonl":
            text = to_jsonl()
        else:
            text = _json.dumps({"ts": _time.time(), "metrics": snap},
                               indent=1, sort_keys=True)
        with open(path, "w") as f:
            f.write(text)
    return snap
