"""Collective and train-step watchdogs: the port of
``paddle_tpu/distributed/watchdog.py`` (reference: phi/core/distributed/
comm_task_manager.cc + nccl_comm_task.cc — records start/end of
collectives, detects hangs, dumps per-rank state).

The collective watchdog monitors *device progress*: a heartbeat thread
issues a tiny probe every interval; if the device fails to complete it
within FLAGS_collective_timeout_s, the watchdog dumps state and invokes
the timeout callback. On the card the probe never blocks the monitor
thread: it enqueues the tiny op and a ``torch.cuda.Event`` on a side
stream and polls ``event.query()`` until the deadline (a wedged card
leaves the event pending; ``torch.cuda.synchronize`` would hang the
monitor with it). On the CPU the probe is the tiny op itself.

The train-step watchdog, its abort through SIGINT to the main thread and
``consume_abort`` keep the reference's semantics.
"""
from __future__ import annotations

import threading
import time
import traceback
from typing import Callable, Optional

from ..core.flags import get_flag
from ..io import _world
from ..observability import metrics as _met


class TrainHangError(RuntimeError):
    """A train step stalled past the watchdog timeout and the loop was
    aborted with a straggler report — the alternative was a silent
    hang. ``stragglers`` carries the ranks the cross-rank progress
    exchange named (None when no store was configured)."""

    def __init__(self, msg, stragglers=None):
        super().__init__(msg)
        self.stragglers = stragglers


def _record_trip(stragglers):
    """Cataloged metrics for a watchdog trip: dashboards and the
    elastic supervisor must see hang aborts without parsing stdout."""
    if _met._ENABLED:
        _met.REGISTRY.counter("train.hang_aborts").inc()
        _met.REGISTRY.gauge("train.straggler_ranks").set(
            len(stragglers or ()))


class CollectiveWatchdog:
    """Device-progress watchdog with cross-rank attribution.

    When `store` (or FLAGS_watchdog_store_root) is set, every rank
    publishes its progress — wall time of the last successful probe and
    an op counter from the dispatch layer — under
    ``watchdog/{job}/{rank}``. On a local timeout the dump reads every
    rank's published progress and names the straggler(s): ranks whose
    last heartbeat is older than the timeout (or missing entirely) —
    the role of the reference's comm_task_manager per-collective
    start/end records (comm_task_manager.cc), re-based on progress
    heartbeats: a hung collective shows as a rank that stops
    publishing."""

    def __init__(self, timeout_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 on_timeout: Optional[Callable] = None,
                 store=None, job_id: str = "default",
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        self.timeout_s = timeout_s if timeout_s is not None else \
            get_flag("FLAGS_collective_timeout_s")
        self.interval_s = interval_s if interval_s is not None else \
            get_flag("FLAGS_watchdog_interval_s")
        self.on_timeout = on_timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_ok = time.monotonic()
        self.tripped = False
        self.stragglers: Optional[list] = None
        self.job_id = job_id
        # rank/world resolved lazily, from torch.distributed's group (one
        # process outside one)
        self._rank = rank
        self._world_size = world_size
        if store is None:
            root = get_flag("FLAGS_watchdog_store_root")
            if root:
                from .elastic import FileKVStore
                store = FileKVStore(root)
        self.store = store
        self._probe_stream = None
        self._op_count = 0
        self._unobserve = None
        if self.store is not None:
            from ..core import dispatch as _dispatch

            def _count(name, outs):
                self._op_count += 1
            self._unobserve = _dispatch.add_op_observer(_count)

    @property
    def rank(self):
        if self._rank is None:
            self._rank = _world()[1]
        return self._rank

    @property
    def world_size(self):
        if self._world_size is None:
            self._world_size = _world()[0]
        return self._world_size

    def _publish(self):
        if self.store is None:
            return
        import json
        self.store.put(
            f"watchdog/{self.job_id}/{self.rank}",
            json.dumps({"ts": time.time(), "ops": self._op_count}))

    def _read_peers(self):
        if self.store is None:
            return {}
        import json
        out = {}
        for k, v in self.store.get_prefix(
                f"watchdog/{self.job_id}/").items():
            try:
                out[int(k.rsplit("/", 1)[-1])] = json.loads(v)
            except (ValueError, TypeError):
                pass
        return out

    def find_stragglers(self):
        """Ranks whose last published heartbeat is older than the
        timeout relative to the freshest rank, PLUS ranks that never
        published at all (expected via world_size — a peer that died
        before its first heartbeat must still be named)."""
        peers = self._read_peers()
        if not peers:
            return None
        newest = max(p["ts"] for p in peers.values())
        stale = [r for r, p in peers.items()
                 if newest - p["ts"] > min(self.timeout_s,
                                           2 * self.interval_s + 1.0)]
        missing = []
        if self.world_size:
            missing = [r for r in range(self.world_size)
                       if r not in peers]
        return sorted(set(stale) | set(missing))

    def _print_peer_report(self, empty_msg=None):
        """Per-rank progress block shared by every trip dump (one
        format for log scrapers to key on). ``empty_msg`` overrides
        the no-straggler verdict line (the step watchdog distinguishes
        all-ranks-stalled from all-ranks-fresh)."""
        if self.stragglers is None:
            return
        peers = self._read_peers()
        now = time.time()
        print("per-rank progress (published heartbeats):")
        for r in sorted(peers):
            p = peers[r]
            tag = "  <-- STRAGGLER" if r in self.stragglers else ""
            print(f"  rank {r}: ops={p.get('ops')} "
                  f"last_heartbeat={now - p['ts']:.1f}s ago{tag}")
        missing = [r for r in self.stragglers if r not in peers]
        if missing:
            print(f"  never published: rank(s) {missing}")
        if self.stragglers:
            print(f"suspected straggler rank(s): {self.stragglers}")
        else:
            print(empty_msg or
                  "all ranks show fresh heartbeats — suspect the "
                  "local device/runtime, not a peer")

    def _probe_once(self) -> bool:
        """True when a tiny op on the device completes within
        ``timeout_s``. On the card: the op and an event on a side stream,
        the event polled; nothing here waits on the device."""
        import torch
        deadline = time.monotonic() + self.timeout_s
        if not torch.cuda.is_available():
            torch.zeros(()) + 1
            return True
        if self._probe_stream is None:
            self._probe_stream = torch.cuda.Stream()
        ev = torch.cuda.Event()
        with torch.cuda.stream(self._probe_stream):
            torch.zeros((), device="cuda") + 1
            ev.record(self._probe_stream)
        while not ev.query():
            if time.monotonic() > deadline or self._stop.wait(
                    min(0.005, self.interval_s)):
                return False
        return True

    def _loop(self):
        try:
            self._publish()
            while not self._stop.wait(self.interval_s):
                if self._probe_once():
                    self.last_ok = time.monotonic()
                    self._publish()
                else:
                    self.tripped = True
                    self._dump()
                    _record_trip(self.stragglers)
                    if self.on_timeout is not None:
                        self.on_timeout(self)
                    return
        finally:
            # allow a later start() to re-arm monitoring after a trip
            self._thread = None

    def _dump(self):
        print("=" * 60)
        print("[collective watchdog] device probe timed out after "
              f"{self.timeout_s}s — possible hung collective / dead "
              "coordination service")
        try:
            import torch
            print("rank:", self.rank, "device_count:",
                  torch.cuda.device_count())
        except Exception:
            pass
        self.stragglers = self.find_stragglers()
        self._print_peer_report()
        dump_path = get_flag("FLAGS_memory_stats_dump_path")
        if dump_path:
            try:
                from .. import device as _device
                _device.dump_memory_stats(dump_path)
                print(f"memory stats dumped to {dump_path}")
            except Exception:
                pass
        print("live python threads:")
        for tid, frame in sys_frames():
            print(f"  thread {tid}:")
            print("   " + "   ".join(traceback.format_stack(frame)[-3:]))
        print("=" * 60)

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None
        if self._unobserve is not None:
            self._unobserve()
            self._unobserve = None


class TrainStepWatchdog(CollectiveWatchdog):
    """Per-step stall watchdog for the train loop.

    The collective watchdog above monitors *device* progress; a train
    step can also stall with a healthy device — a hung host collective
    rendezvous, a wedged data pipeline, a peer stuck pre-dispatch.
    This variant is armed per step (``step_begin``/``step_end``, or
    the ``step()`` context manager): a monitor thread trips when the
    armed step exceeds ``timeout_s`` (default
    ``FLAGS_step_timeout_s``), publishes/reads cross-rank progress to
    name the straggler(s), ticks ``train.hang_aborts`` /
    ``train.straggler_ranks``, and ABORTS — by ``on_timeout`` when
    given, else by interrupting the main thread, which the hapi/fleet
    train loops translate into :class:`TrainHangError` carrying the
    straggler report. A step that never ends is never a silent hang.

    Lifecycle: the watchdog is caller-owned (one instance can span
    many fits). The monitor thread hibernates after ~_IDLE_EXIT_TICKS
    disarmed intervals and restarts on the next arm; ``stop()``
    releases it immediately and unregisters the store-mode dispatch
    observer.
    """

    def __init__(self, timeout_s: Optional[float] = None,
                 interval_s: Optional[float] = None,
                 on_timeout: Optional[Callable] = None, **kw):
        if timeout_s is None:
            timeout_s = get_flag("FLAGS_step_timeout_s")
        if interval_s is None:
            interval_s = max(0.01, min(
                get_flag("FLAGS_watchdog_interval_s"), timeout_s / 4.0))
        super().__init__(timeout_s=timeout_s, interval_s=interval_s,
                         on_timeout=on_timeout, **kw)
        self._armed_at: Optional[float] = None
        self._armed_step = None
        self._last_publish = 0.0
        #: serializes arm/spawn against the monitor's idle-exit: an
        #: armed step must NEVER be left unmonitored by a hibernation
        #: racing a re-arm
        self._monitor_lock = threading.Lock()
        #: the abort token: set when the monitor SENDS the interrupt,
        #: consumed exactly once by the train loop's translation —
        #: keyed on the abort itself, not on trip state, so a
        #: late-landing SIGINT is still translated and a genuine
        #: ctrl-C never is
        self._abort_error: Optional[TrainHangError] = None
        self._abort_sent_at = 0.0
        #: trip-time classification: True when every rank's progress
        #: stalled at the same step (a wedged collective), False when
        #: peers look fresh (suspect the local step)
        self.collective_suspect = False

    # ------------------------------------------------------ arm / disarm
    def step_begin(self, step=None):
        if self.on_timeout is None and threading.current_thread() \
                is not threading.main_thread():
            # CPython delivers KeyboardInterrupt only in the MAIN
            # thread: the default abort can neither interrupt a
            # worker-thread step (silent hang persists) nor avoid
            # killing unrelated main-thread work — refuse up front
            raise RuntimeError(
                "TrainStepWatchdog's default abort interrupts the "
                "main thread; arming from a worker thread requires "
                "on_timeout= (e.g. lambda wd: os._exit(17), or a "
                "custom abort channel)")
        self._armed_step = step
        # a new arm clears the previous trip's REPORT state (the abort
        # token above is what the loops translate on, so clearing here
        # cannot rebrand or drop an in-flight abort)
        self.tripped = False
        self.stragglers = None
        self.collective_suspect = False
        with self._monitor_lock:
            self._armed_at = time.monotonic()
            self.start()        # monitor auto-starts on first arm
        self._publish_throttled()
        return self

    def step_end(self):
        self._armed_at = None
        self.last_ok = time.monotonic()
        self._publish_throttled()

    def _publish_throttled(self):
        """At most one store publish per interval_s: step boundaries
        fire every few ms on fast steps, and two blocking shared-fs
        writes per step per rank would tax the hot path for freshness
        the straggler heuristic (threshold ~2*interval_s) can't even
        observe."""
        if self.store is None:
            return
        now = time.monotonic()
        if now - self._last_publish >= self.interval_s:
            self._last_publish = now
            self._publish()

    def step(self, step=None):
        """Context manager arming the watchdog around one step."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            self.step_begin(step)
            try:
                yield self
            finally:
                self.step_end()
        return _cm()

    def hang_error(self) -> TrainHangError:
        msg = (f"train step {self._armed_step} stalled for more than "
               f"{self.timeout_s}s — aborted by the step watchdog "
               "instead of hanging silently")
        if self.stragglers:
            msg += f"; suspected straggler rank(s): {self.stragglers}"
        elif self.collective_suspect:
            # heartbeats refresh at STEP boundaries here; when every
            # rank's last beat predates this step's arm and none lags
            # the rest, the whole job blocked at the same step —
            # blaming "the local pipeline" would misdirect the
            # operator in the flagship multi-rank-hang scenario
            msg += ("; every rank's progress stalled at the same "
                    "step — suspect a wedged collective/coordination "
                    "service, not a single peer or the local data "
                    "pipeline")
        elif self.stragglers is not None:
            msg += ("; peer ranks show fresh progress — suspect "
                    "the local step (data pipeline / host code), not "
                    "a peer")
        return TrainHangError(msg, self.stragglers)

    def consume_abort(self) -> Optional[TrainHangError]:
        """The abort token, exactly once. The train loops call this
        from their ``except KeyboardInterrupt`` to decide whether the
        interrupt is the watchdog's (translate to the stored
        TrainHangError) or the operator's (propagate). Tokens expire
        after 30s so an abort swallowed by foreign code can never
        rebrand a much-later genuine ctrl-C."""
        err, self._abort_error = self._abort_error, None
        if err is not None and \
                time.monotonic() - self._abort_sent_at < 30.0:
            return err
        return None

    # ---------------------------------------------------------- monitor
    #: disarmed ticks before the monitor thread hibernates (the next
    #: step_begin restarts it) — a finished training run must not leak
    #: a polling thread for the process lifetime
    _IDLE_EXIT_TICKS = 25

    def _loop(self):
        idle = 0
        try:
            self._publish_throttled()
            while not self._stop.wait(self.interval_s):
                t0 = self._armed_at
                if t0 is None:
                    idle += 1
                    if idle >= self._IDLE_EXIT_TICKS:
                        # hibernate — but the exit decision and the
                        # thread-slot release must be ATOMIC against a
                        # concurrent step_begin, or its start() no-ops
                        # on our dying thread and the armed step runs
                        # unmonitored
                        with self._monitor_lock:
                            if self._armed_at is not None:
                                idle = 0
                                continue
                            self._thread = None
                            return
                    continue
                idle = 0
                if time.monotonic() - t0 <= self.timeout_s:
                    continue
                # evidence-gathering (store reads) and the report dump
                # are slow; the step may complete meanwhile. Re-check
                # that THIS arm (!= catches a completed step whose
                # successor re-armed during the dump) is still active
                # before declaring a trip or firing the abort —
                # on_timeout is documented as os._exit territory and
                # must never kill a run whose step just finished.
                stragglers = self.find_stragglers()
                if self._armed_at != t0:
                    continue
                peers = self._read_peers()
                now = time.time()
                armed_for = time.monotonic() - t0
                self.collective_suspect = (
                    len(peers) > 1 and not stragglers and all(
                        now - p["ts"] >= armed_for - 2 * self.interval_s
                        for p in peers.values()))
                self.stragglers = stragglers
                self._dump_step()
                if self._armed_at != t0:
                    continue      # completed during the dump: report
                                  # printed, healthy loop NOT aborted
                self.tripped = True
                _record_trip(stragglers)
                # release the thread slot BEFORE firing the abort: a
                # supervised restart may re-arm immediately, and its
                # start() must spawn a fresh monitor instead of
                # no-opping on this dying one
                with self._monitor_lock:
                    self._thread = None
                if self.on_timeout is not None:
                    self.on_timeout(self)
                else:
                    # A SIGINT directed at the main thread (not just
                    # interrupt_main's flag) breaks a blocking sleep /
                    # syscall promptly; the train loops translate it
                    # back via the consume_abort() token. A step
                    # wedged inside non-interruptible C code needs
                    # on_timeout=lambda wd: os._exit(...) instead.
                    self._abort_error = self.hang_error()
                    self._abort_sent_at = time.monotonic()
                    try:
                        import signal as _signal
                        _signal.pthread_kill(
                            threading.main_thread().ident,
                            _signal.SIGINT)
                    except Exception:
                        import _thread
                        _thread.interrupt_main()
                return
        finally:
            # release only OUR slot: a re-arm may already have spawned
            # a fresh monitor into self._thread, which an unconditional
            # clear would orphan (two pollers after the next arm)
            with self._monitor_lock:
                if self._thread is threading.current_thread():
                    self._thread = None

    def _dump_step(self):
        print("=" * 60)
        print(f"[step watchdog] train step {self._armed_step} exceeded "
              f"{self.timeout_s}s")
        self._print_peer_report(
            empty_msg=("every rank's progress stalled at the same "
                       "step — suspect a wedged collective, not a "
                       "single peer") if self.collective_suspect
            else None)
        print("=" * 60)


def sys_frames():
    import sys
    return list(sys._current_frames().items())


_GLOBAL: Optional[CollectiveWatchdog] = None


def start_watchdog(timeout_s=None, interval_s=None, on_timeout=None):
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = CollectiveWatchdog(timeout_s, interval_s, on_timeout)
        _GLOBAL.start()
    return _GLOBAL


def stop_watchdog():
    global _GLOBAL
    if _GLOBAL is not None:
        _GLOBAL.stop()
        _GLOBAL = None
