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

``compile_tracker`` counts the jit's backend compiles and traces
(``count_compiles``, ``count_traces``, the ``jit.xla_compiles`` counter),
and ``compile_report`` gives each ``to_static`` function's cache state,
which a collector publishes as the ``jit.*`` gauges at snapshot time.
"""
from __future__ import annotations

import json as _json
import time as _time

from . import catalog  # noqa: F401
from . import compile_tracker  # noqa: F401
from . import server  # noqa: F401
from . import training  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY, Counter, Gauge, Histogram, Registry,
    enable, disable, enabled,
)
from .compile_tracker import count_compiles, count_traces  # noqa: F401
from .server import MetricsServer  # noqa: F401
from .snapshots import (  # noqa: F401
    Snapshot, SnapshotDelta, delta, window,
)

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


def compile_report():
    """Per-StaticFunction jit-cache stats: calls, probes, graph breaks,
    specializations, compiled graphs (the reference's sot introspection,
    quantified; ``xla_executables`` keeps the reference's key)."""
    out = []
    from .. import jit as _jit
    for sf in list(_jit._static_functions):
        calls = probes = breaks = specs = execs = 0
        fallbacks = 0
        for e in sf._cache.values():
            probes += e["probes"]
            breaks += e["breaks"]
            specs += len(e["specs"])
            fallbacks += 1 if e["fallback"] else 0
            for s in e["specs"]:
                calls += s.hits
                if s.jitted is not None:
                    execs += s.jitted._cache_size()
        out.append({"function": sf._name, "cache_hits": calls,
                    "eager_probes": probes, "graph_breaks": breaks,
                    "specializations": specs, "xla_executables": execs,
                    "eager_fallbacks": fallbacks})
    return out


def _jit_collector(reg):
    """Publish aggregate jit-cache state as gauges at snapshot time."""
    import sys
    if "paddle_tpu_torch.jit" not in sys.modules:
        rep = []                  # no to_static function yet
    else:
        rep = compile_report()
    reg.gauge("jit.static_functions").set(len(rep))
    reg.gauge("jit.specializations").set(
        sum(r["specializations"] for r in rep))
    reg.gauge("jit.xla_executables").set(
        sum(r["xla_executables"] for r in rep))
    reg.gauge("jit.graph_breaks").set(
        sum(r["graph_breaks"] for r in rep))


REGISTRY.register_collector(_jit_collector)
