"""Compile tracking over the port's jit: the port of
``paddle_tpu/observability/compile_tracker.py``.

The reference wraps jax's compilation and tracing internals. The port's
compiled programs are all made by ``paddle_tpu_torch.jit``, which reports
each event here: every backend compile (a ``torch.compile`` backend call,
through the counting wrapper of ``StaticFunction``) and every ``make_fx``
trace. Two services, as in the reference:

1. the persistent ``jit.xla_compiles`` counter of the metrics registry
   (the reference's name, kept), ticked by every backend compile;
2. ``count_compiles()`` / ``count_traces()`` context managers yielding a
   CALLABLE count (``with count_compiles() as c: ...; assert c() == 0``).

Per-FUNCTION accounting lives in ``paddle_tpu_torch.jit.StaticFunction``
and is published into the registry at snapshot time by the collector in
``observability``.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

from . import metrics as _met

_lock = threading.Lock()
_compile_counters = []
_trace_counters = []
_compiles = _met.REGISTRY.counter("jit.xla_compiles")


class _Count:
    """Callable current count."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0

    def __call__(self) -> int:
        return self.n


def note_compile() -> None:
    """One backend compile (called by the jit)."""
    if _met._ENABLED:
        _compiles.inc()
    with _lock:
        for c in _compile_counters:
            c.n += 1


def note_trace() -> None:
    """One ``make_fx`` trace (called by the jit)."""
    with _lock:
        for c in _trace_counters:
            c.n += 1


@contextmanager
def _counting(registry):
    count = _Count()
    with _lock:
        registry.append(count)
    try:
        yield count
    finally:
        with _lock:
            registry.remove(count)


def count_compiles():
    """Count backend compiles within the context; yields a callable
    returning the count."""
    return _counting(_compile_counters)


def count_traces():
    """Count program traces within the context; yields a callable
    returning the count."""
    return _counting(_trace_counters)
