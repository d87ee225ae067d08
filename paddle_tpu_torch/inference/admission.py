"""Admission control and the request lifecycle of the serving sessions:
the port's own copy of ``paddle_tpu/inference/admission.py`` (numpy only).

Reference capability: serving atop block_multihead_attention pairs
continuous batching with request timeouts and queue limits, and the
Orca/vLLM scheduler lineage gives every request an explicit lifecycle
state. This module is the host-side policy half; the device half (slot
eviction, step retry, bisection quarantine) lives in
``inference/decode.py``.

  * :class:`RequestState` — ``QUEUED -> PREFILLING -> DECODING -> {DONE,
    TIMED_OUT, CANCELLED, REJECTED, FAILED}``;
  * :class:`AdmissionController` — a bounded-queue policy that sheds load
    with fast rejections (:class:`AdmissionRejected`) under overload.
    Policies: ``reject_newest`` (default) and ``priority`` (a
    higher-priority arrival evicts the newest lowest-priority queued
    request);
  * :class:`RequestResult` — terminal state, full token ids (prompt +
    whatever was generated) and the error string for FAILED;
  * :class:`ServingStepError` — a persistent device-step failure that
    cannot be attributed to a single poison request.
"""
from __future__ import annotations

import enum
from typing import Deque, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    DECODING = "DECODING"
    DONE = "DONE"
    TIMED_OUT = "TIMED_OUT"
    CANCELLED = "CANCELLED"
    REJECTED = "REJECTED"
    FAILED = "FAILED"

    @property
    def terminal(self) -> bool:
        return self in _TERMINAL


_TERMINAL = {RequestState.DONE, RequestState.TIMED_OUT,
             RequestState.CANCELLED, RequestState.REJECTED,
             RequestState.FAILED}


class AdmissionRejected(RuntimeError):
    """Fast rejection: the bounded queue is full and the shedding
    policy chose not to admit this request. Load balancers map this to
    429/503 and route away — the request never waits."""


class ServingStepError(RuntimeError):
    """The device step keeps failing and bisection could not isolate a
    single poison request (both probe halves fail — the failure is
    step-wide, not request-borne)."""


class RequestResult:
    """Terminal outcome of one request."""

    __slots__ = ("state", "ids", "error")

    def __init__(self, state: RequestState, ids: np.ndarray,
                 error: Optional[str] = None):
        self.state = state
        self.ids = ids
        self.error = error

    @property
    def ok(self) -> bool:
        return self.state is RequestState.DONE

    def __repr__(self):
        return (f"RequestResult(state={self.state.name}, "
                f"len={len(self.ids)}"
                + (f", error={self.error!r}" if self.error else "")
                + ")")


POLICIES = ("reject_newest", "priority")


class AdmissionController:
    """Bounded-queue shedding policy over the session's deque.

    ``max_queue=None`` disables the bound (legacy behavior — the
    session accepts everything). With a bound, :meth:`admit` either
    admits (possibly evicting a queued victim under the ``priority``
    policy) or raises :class:`AdmissionRejected`.
    """

    def __init__(self, max_queue: Optional[int] = None,
                 policy: str = "reject_newest",
                 degraded_queue_frac: float = 0.8):
        if policy not in POLICIES:
            raise ValueError(
                f"shed policy {policy!r} not in {POLICIES}")
        if max_queue is not None and int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1 (or None)")
        self.max_queue = int(max_queue) if max_queue is not None else None
        self.policy = policy
        #: queue-depth fraction past which readiness reports degraded
        self.degraded_queue_frac = float(degraded_queue_frac)

    def admit(self, queue: Deque, req, free_slots: int = 0
              ) -> Optional[object]:
        """Decide admission for ``req`` against the current queue.

        The bound applies to requests WAITING beyond free slot
        capacity: a request the next step can admit straight into a
        slot is never shed. Returns the evicted victim request
        (priority policy) or None; the CALLER appends ``req`` and
        retires the victim. Raises :class:`AdmissionRejected` when
        the request is shed."""
        if self.max_queue is None or \
                len(queue) - free_slots < self.max_queue:
            return None
        if self.policy == "priority":
            # evict the NEWEST among the strictly-lower-priority queued
            # requests (newest first: it has waited least, so shedding
            # it wastes the least sunk queue time)
            victim_i = None
            for i in range(len(queue) - 1, -1, -1):
                if queue[i].priority < req.priority:
                    victim_i = i
                    break
            if victim_i is not None:
                victim = queue[victim_i]
                del queue[victim_i]
                return victim
        raise AdmissionRejected(
            f"queue full ({self.max_queue}): request shed by "
            f"{self.policy} policy")

    def degraded_reasons(self, queue_len: int, free_slots: int) -> list:
        """Readiness probe: non-empty list of reasons when the session
        should report degraded (503 on /healthz) so load balancers
        route away before the shedding policy has to fire."""
        reasons = []
        if (self.max_queue is not None
                and queue_len - free_slots
                >= self.degraded_queue_frac * self.max_queue):
            reasons.append(
                f"queue_pressure:{queue_len - free_slots}"
                f"/{self.max_queue}")
        if free_slots == 0 and queue_len > 0:
            reasons.append(f"slot_pressure:backlog={queue_len}")
        return reasons
