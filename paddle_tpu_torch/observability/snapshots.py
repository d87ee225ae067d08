"""Structured read side of the metrics registry: the port's own copy of
``paddle_tpu/observability/snapshots.py`` (pure Python).

  * ``Snapshot`` — an indexed, immutable view of one ``REGISTRY`` export
    (or of a persisted snapshot list);
  * ``delta(before, after)`` — counter/histogram movement between two
    snapshots plus the gauge end-state, with derived per-second rates;
  * ``window()`` — a context manager bracketing a block of work with two
    snapshots and handing back the delta.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from . import metrics as _met

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: dict) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Snapshot:
    """Immutable, (name, labels)-indexed view of one registry export."""

    __slots__ = ("ts", "metrics", "_index")

    def __init__(self, metrics: List[dict], ts: Optional[float] = None):
        self.ts = float(ts) if ts is not None else time.time()
        self.metrics = list(metrics)
        self._index: Dict[Tuple[str, LabelKey], dict] = {
            (d["name"], _label_key(d.get("labels") or {})): d
            for d in self.metrics}

    @classmethod
    def take(cls) -> "Snapshot":
        """Snapshot the live process-global registry."""
        return cls(_met.REGISTRY.snapshot())

    @classmethod
    def from_metrics(cls, metrics: List[dict],
                     ts: Optional[float] = None) -> "Snapshot":
        """Rebuild a Snapshot from a persisted snapshot list (a
        ``dump()`` written by another process)."""
        return cls(metrics, ts=ts if ts is not None else 0.0)

    # ------------------------------------------------------- lookups
    def get(self, name: str, **labels) -> Optional[dict]:
        return self._index.get((name, _label_key(labels)))

    def value(self, name: str, default=None, **labels):
        """Counter/gauge value (histograms: the observation count)."""
        d = self.get(name, **labels)
        if d is None:
            return default
        return d.get("value", d.get("count", default))

    def series(self, name: str) -> List[dict]:
        """Every label-set of one metric name."""
        return [d for d in self.metrics if d["name"] == name]

    def names(self) -> set:
        return {d["name"] for d in self.metrics}

    def __contains__(self, name: str) -> bool:
        return any(d["name"] == name for d in self.metrics)

    def __repr__(self):
        return f"<Snapshot ts={self.ts:.3f} metrics={len(self.metrics)}>"


class SnapshotDelta:
    """Movement between two Snapshots.

    Per series:
      * counters  -> value difference (a reset between the snapshots
        shows up as a negative delta — surfaced, not hidden);
      * histograms -> {count, sum, mean} over the window;
      * gauges    -> the *after* value (instantaneous state).

    ``rate(name)`` divides a counter delta by the wall-time between
    the snapshots; ``per(name, den_name)`` divides one delta by
    another — e.g. tokens per step-time-second — which needs **no
    wall clock at all** and is what the auto-tuner scores with.
    """

    __slots__ = ("before", "after", "dt")

    def __init__(self, before: Snapshot, after: Snapshot):
        self.before = before
        self.after = after
        self.dt = max(0.0, after.ts - before.ts)

    # ------------------------------------------------------- scalars
    def value(self, name: str, default=None, **labels):
        """Counter delta / gauge end-state for one series."""
        a = self.after.get(name, **labels)
        if a is None:
            return default
        if a["type"] == "gauge":
            return a.get("value", default)
        if a["type"] == "histogram":
            return self.hist(name, **labels)["count"]
        b = self.before.get(name, **labels)
        return a.get("value", 0.0) - (b.get("value", 0.0) if b else 0.0)

    def hist(self, name: str, **labels) -> dict:
        """Histogram window: {count, sum, mean} of observations made
        between the two snapshots (mean is None when count == 0)."""
        a = self.after.get(name, **labels)
        b = self.before.get(name, **labels)
        ac, asum = ((a.get("count", 0), a.get("sum", 0.0))
                    if a else (0, 0.0))
        bc, bsum = ((b.get("count", 0), b.get("sum", 0.0))
                    if b else (0, 0.0))
        count, total = ac - bc, asum - bsum
        return {"count": count, "sum": total,
                "mean": (total / count) if count > 0 else None}

    def rate(self, name: str, default=None, **labels):
        """Counter delta per wall-second between the snapshots."""
        v = self.value(name, default=None, **labels)
        if v is None or self.dt <= 0:
            return default
        return v / self.dt

    def per(self, name: str, den_name: str, default=None,
            labels: Optional[dict] = None,
            den_labels: Optional[dict] = None):
        """delta(name) / delta(den_name) — a within-window ratio that
        involves no wall clock. den may be a histogram (its summed
        observation time is the denominator), which is how
        tokens-per-step-second is derived purely from the registry."""
        num = self.value(name, default=None, **(labels or {}))
        den_d = self.after.get(den_name, **(den_labels or {}))
        if den_d is not None and den_d["type"] == "histogram":
            den = self.hist(den_name, **(den_labels or {}))["sum"]
        else:
            den = self.value(den_name, default=None, **(den_labels or {}))
        if num is None or not den:
            return default
        return num / den

    def changed(self) -> List[dict]:
        """Series that moved in the window (counter/histogram deltas
        != 0, gauges that changed value) — compact debugging view."""
        out = []
        for d in self.after.metrics:
            name, labels = d["name"], d.get("labels") or {}
            if d["type"] == "histogram":
                h = self.hist(name, **labels)
                if h["count"]:
                    out.append({"name": name, "labels": labels,
                                "type": "histogram", **h})
            elif d["type"] == "gauge":
                b = self.before.get(name, **labels)
                if b is None or b.get("value") != d.get("value"):
                    out.append({"name": name, "labels": labels,
                                "type": "gauge",
                                "value": d.get("value")})
            else:
                v = self.value(name, **labels)
                if v:
                    out.append({"name": name, "labels": labels,
                                "type": "counter", "value": v})
        return out


def delta(before: Snapshot, after: Snapshot) -> SnapshotDelta:
    return SnapshotDelta(before, after)


class Window:
    """Handle yielded by ``window()``: ``.before``/``.after``
    snapshots and, once the block exits, ``.delta`` (accessors on the
    window delegate to it)."""

    __slots__ = ("before", "after", "_delta")

    def __init__(self):
        self.before: Optional[Snapshot] = None
        self.after: Optional[Snapshot] = None
        self._delta: Optional[SnapshotDelta] = None

    @property
    def delta(self) -> SnapshotDelta:
        if self._delta is None:
            if self.after is None:
                raise RuntimeError(
                    "window delta read before the block exited")
            self._delta = SnapshotDelta(self.before, self.after)
        return self._delta

    def value(self, name, default=None, **labels):
        return self.delta.value(name, default=default, **labels)

    def hist(self, name, **labels):
        return self.delta.hist(name, **labels)

    def rate(self, name, default=None, **labels):
        return self.delta.rate(name, default=default, **labels)

    def per(self, name, den_name, default=None, labels=None,
            den_labels=None):
        return self.delta.per(name, den_name, default=default,
                              labels=labels, den_labels=den_labels)


@contextmanager
def window():
    """Bracket a block of work with two registry snapshots::

        with obs.window() as w:
            run_candidate()
        toks_per_step_s = w.per("train.tokens", "train.step_time_s")
    """
    w = Window()
    w.before = Snapshot.take()
    try:
        yield w
    finally:
        w.after = Snapshot.take()
