"""Process-global metrics registry: Counter / Gauge / Histogram.

The port's own copy of ``paddle_tpu/observability/metrics.py`` (pure
Python), because eager dispatch reads it: the same classes, registry,
label-cardinality cap and ``PADDLE_TPU_METRICS=off|on`` switch, with
``enabled()`` / ``enable()`` / ``disable()``, ``Registry.snapshot()`` and
the JSON-lines and Prometheus-text exporters (``to_jsonl``,
``to_prometheus``, which the scrape endpoint of ``server.py`` serves).

Every mutate method opens with one branch on the module-global
``_ENABLED``, and hot paths guard with the same branch, so the disabled
cost is one attribute load.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: module-global fast-path switch; hot paths read this directly
#: (`if _met._ENABLED:`) so the disabled cost is one attribute load +
#: branch. Mutate only through enable()/disable().
_ENABLED: bool = os.environ.get(
    "PADDLE_TPU_METRICS", "on").lower() not in ("off", "0", "false", "no")


def enabled() -> bool:
    return _ENABLED


def enable() -> None:
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


_RESERVOIR_CAP = 512

#: default cap on DISTINCT label-sets per metric name. A call site
#: that (mistakenly) labels a metric with a per-request value — rid,
#: prompt hash, timestamp — would otherwise grow the registry without
#: bound over a long-lived serving session; past the cap, new
#: label-sets get an unregistered throwaway metric and the
#: ``metrics.dropped_series`` counter ticks instead.
_MAX_SERIES_PER_NAME = 256

#: overflow counter name (exempt from the cap; see catalog.py)
_DROPPED_SERIES = "metrics.dropped_series"


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "labels", "_value", "_lock")

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _snapshot(self) -> dict:
        return {"value": self._value}

    def _reset(self) -> None:
        self._value = 0.0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "labels", "_value", "_lock")

    kind = "gauge"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        if not _ENABLED:
            return
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not _ENABLED:
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def _snapshot(self) -> dict:
        return {"value": self._value}

    def _reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Exact count/sum/min/max + a bounded reservoir for percentiles.

    The reservoir is classic Algorithm-R sampling (uniform over all
    observations) with a deterministic LCG instead of the `random`
    module — metric observation must never perturb user-visible RNG
    state or need seeding discipline."""

    __slots__ = ("name", "labels", "_count", "_sum", "_min", "_max",
                 "_reservoir", "_rng", "_lock")

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._reservoir: List[float] = []
        self._rng = 0x2545F4914F6CDD1D
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        if not _ENABLED:
            return
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._reservoir) < _RESERVOIR_CAP:
                self._reservoir.append(v)
            else:
                # 64-bit LCG step; uniform slot in [0, count)
                self._rng = (self._rng * 6364136223846793005
                             + 1442695040888963407) & (2**64 - 1)
                j = self._rng % self._count
                if j < _RESERVOIR_CAP:
                    self._reservoir[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1] from the reservoir; None when empty. Out-of-range
        q clamps to the observed min/max (q<=0 -> min, q>=1 -> max)."""
        with self._lock:
            if not self._reservoir:
                return None
            s = sorted(self._reservoir)
        idx = min(max(int(q * len(s)), 0), len(s) - 1)
        return s[idx]

    def _snapshot(self) -> dict:
        with self._lock:
            count, total = self._count, self._sum
            if not count:
                return {"count": 0, "sum": 0.0}
            s = sorted(self._reservoir)
            mn, mx = self._min, self._max
        out = {"count": count, "sum": total, "min": mn, "max": mx,
               "mean": total / count}
        if s:
            # count >= 1 implies a non-empty reservoir today, but the
            # percentile keys stay OPTIONAL in the export contract
            # (to_prometheus / consumers already guard on presence)
            def pct(q):
                return s[min(max(int(q * len(s)), 0), len(s) - 1)]
            out.update(p50=pct(0.50), p90=pct(0.90), p99=pct(0.99))
        return out

    def _reset(self) -> None:
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._reservoir = []


class Registry:
    """Process-global metric registry keyed by (name, sorted labels)."""

    def __init__(self):
        self._metrics: Dict[tuple, object] = {}
        self._collectors: List[Callable[["Registry"], None]] = []
        self._lock = threading.RLock()
        self._series_per_name: Dict[str, int] = {}
        #: one shared detached sink per (name, kind) for over-cap
        #: lookups — overflow stays O(1) memory AND allocation-free on
        #: repeat lookups
        self._overflow_sinks: Dict[tuple, object] = {}
        #: distinct label-sets allowed per metric name; overflow is
        #: dropped-and-counted (``metrics.dropped_series``) so a
        #: per-request label can never OOM a long-lived session
        self.max_series_per_name = _MAX_SERIES_PER_NAME

    # -- creation/lookup (cheap enough for warm paths; the hottest
    #    sites cache the returned object) ------------------------------
    def _get(self, cls, name: str, labels: dict):
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lab)
        m = self._metrics.get(key)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{dict(lab)} already registered as "
                    f"{m.kind}, requested {cls.kind}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                if (name != _DROPPED_SERIES
                        and self._series_per_name.get(name, 0)
                        >= self.max_series_per_name):
                    # cardinality overflow: hand back a shared DETACHED
                    # sink (call site keeps working, nothing new is
                    # retained) and count the dropped lookup — bounded
                    # memory by design
                    self._dropped_counter().inc()
                    sink = self._overflow_sinks.get((name, cls.kind))
                    if sink is None:
                        sink = self._overflow_sinks[(name, cls.kind)] \
                            = cls(name, lab)
                    return sink
                m = self._metrics[key] = cls(name, lab)
                self._series_per_name[name] = \
                    self._series_per_name.get(name, 0) + 1
            elif not isinstance(m, cls):
                # a racing creator of another kind won: same contract
                # as the fast path above
                raise TypeError(
                    f"metric {name!r}{dict(lab)} already registered as "
                    f"{m.kind}, requested {cls.kind}")
            return m

    def _dropped_counter(self) -> "Counter":
        # direct registration, bypassing the cap check (call sites hold
        # self._lock — it is an RLock)
        key = (_DROPPED_SERIES, ())
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = Counter(_DROPPED_SERIES, ())
            self._series_per_name[_DROPPED_SERIES] = 1
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def register_collector(self, fn: Callable[["Registry"], None]):
        """fn(registry) runs at every snapshot(); use it to publish
        state that lives elsewhere (jit caches, session queues) as
        gauges without per-event hooks. Returns an unregister fn."""
        with self._lock:
            self._collectors.append(fn)
        return lambda: self._collectors.remove(fn)

    # -- export --------------------------------------------------------
    def snapshot(self) -> List[dict]:
        """[{name, type, labels, ...values}] — collectors run first."""
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:
                pass  # a broken collector must not take down export
        out = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for (name, lab), m in metrics:
            d = {"name": name, "type": m.kind, "labels": dict(lab)}
            d.update(m._snapshot())
            out.append(d)
        return out

    def to_jsonl(self) -> str:
        """One JSON object per line, one line per metric."""
        ts = time.time()
        return "\n".join(
            json.dumps({"ts": ts, **d}, sort_keys=True)
            for d in self.snapshot())

    def to_prometheus(self) -> str:
        """Prometheus text exposition; histograms as summaries."""
        lines = []
        seen_type = set()
        for d in self.snapshot():
            pname = _prom_name(d["name"])
            if pname not in seen_type:
                kind = {"counter": "counter", "gauge": "gauge",
                        "histogram": "summary"}[d["type"]]
                lines.append(f"# TYPE {pname} {kind}")
                seen_type.add(pname)
            if d["type"] == "histogram":
                lines.append(
                    f"{pname}_count{_prom_labels(d['labels'])} "
                    f"{d['count']}")
                lines.append(
                    f"{pname}_sum{_prom_labels(d['labels'])} "
                    f"{_prom_num(d['sum'])}")
                for q in ("p50", "p90", "p99"):
                    if q in d:
                        lab = dict(d["labels"])
                        lab["quantile"] = f"0.{q[1:]}"
                        lines.append(
                            f"{pname}{_prom_labels(lab)} "
                            f"{_prom_num(d[q])}")
            else:
                lines.append(
                    f"{pname}{_prom_labels(d['labels'])} "
                    f"{_prom_num(d['value'])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Zero every metric (tests); registrations survive."""
        with self._lock:
            for m in self._metrics.values():
                m._reset()


def _prom_name(name: str) -> str:
    out = "".join(c if (c.isalnum() or c == "_") else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return "paddle_tpu_" + out


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    def esc(v):
        return str(v).replace("\\", "\\\\").replace('"', '\\"')
    inner = ",".join(f'{k}="{esc(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _prom_num(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


#: the process-global registry every framework layer records into
REGISTRY = Registry()
