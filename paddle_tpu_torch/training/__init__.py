"""Fault-tolerant training primitives: the port of
``paddle_tpu/training/__init__.py`` (reference posture:
``distributed/fleet/elastic/`` auto-restart plus the
``incubate/distributed/fleet/utils`` NaN/hang guards). Four pieces,
each usable standalone or wired through the hapi trainer / fleet
``train_batch``:

* :class:`StepGuard` — cheap device-side finite-check on loss (and
  optionally grads) with skip-step semantics, AMP loss-scaler
  awareness, and a consecutive-bad-step circuit breaker that raises
  :class:`NonFiniteStepError` with a diagnostic instead of training on
  garbage. Ticks ``train.nan_steps`` / ``train.skipped_steps``.
* :class:`PreemptionHandler` — SIGTERM/preemption notice capture:
  the handler only sets a flag; the train loop finishes the current
  step, flushes a COMMITTED checkpoint, and stops cleanly.
* :func:`save_train_checkpoint` / :func:`load_train_checkpoint` —
  per-step committed checkpoint dirs (``_COMMITTED.json`` protocol,
  distributed/checkpoint) that capture model + optimizer state PLUS
  the dataloader position and the default ``Generator`` RNG state, so
  a resume replays the exact data order, bit for bit.
* hang detection and supervised restart live next to their substrates:
  ``distributed.watchdog.TrainStepWatchdog`` (per-step stall watchdog
  with straggler attribution) and ``distributed.elastic.run_resilient``
  (bounded-retry restart-from-latest-committed supervisor).

Chaos hook sites driving the end-to-end drills (``_chaos``):
``train.step``, ``train.data_fetch``, ``train.checkpoint_save``,
``train.preempt``.

What the port does differently:

- the finite check is one ``torch._foreach_norm(..., inf)`` over the loss
  and the gradients (each tensor's largest magnitude, NaN propagating) and
  one ``isfinite().all()`` over those values: one bool crosses to the host;
- the generator's state carries each device's ``torch.Generator`` state
  (a byte tensor), which is not JSON: the checkpoint keeps it base64-coded
  as ``train.rng_devices``, beside the reference's ``train.rng`` of seed and
  offset, so a resume restores the dropout draws on the card exactly; a
  reference checkpoint, which has no ``rng_devices``, loads as well;
- the load creates the optimizer's master weights as well as its
  accumulators before it builds the template: a fresh
  ``multi_precision`` optimizer would otherwise rebuild its f32 masters from
  the bf16 parameters at its first step and lose the saved ones.
"""
from __future__ import annotations

import base64
import os
import signal as _signal
import threading
from typing import Optional

import numpy as np
import torch

from ..core import generator as gen_mod
from ..core.flags import get_flag
from ..observability import metrics as _met

#: per-step checkpoint directory layout under a checkpoint root
STEP_DIR_FMT = "step_%08d"


class NonFiniteStepError(RuntimeError):
    """Circuit-breaker abort: too many consecutive non-finite/skipped
    steps — the run is training on garbage (bad data shard, diverged
    LR, poisoned collective) and must stop with a diagnostic, not
    silently continue."""


class StepGuard:
    """Finite-check + skip-step + circuit breaker for train loops.

    Three entry points, matched to how much control the caller has
    over the optimizer update:

    * ``pre_step(loss, optimizer)`` — BEFORE the update (hapi / user
      eager loops): device-side finite check on the loss (and, with
      ``check_grads=True``, every parameter grad); only one bool
      crosses to the host. Returns False when the step must be
      SKIPPED (caller clears grads and does not apply the update).
    * ``observe_loss(loss_val)`` — AFTER a fused update (fleet
      ``train_batch``, where forward+backward+update is one compiled
      program and the update cannot be un-applied): detects and
      circuit-breaks, but cannot skip — the breaker is the protection.
    * ``observe_scaler(scaler)`` — AMP: a ``GradScaler`` that skipped
      its ``step()`` on non-finite grads already implements skip-step
      semantics; the guard counts it (``train.skipped_steps``, not
      ``train.nan_steps`` — the scaler's backoff handles the scale)
      and feeds the same circuit breaker.

    Every consecutive-bad run is reset by the first good step.
    """

    def __init__(self, max_consecutive_bad: Optional[int] = None,
                 check_grads: bool = False):
        if max_consecutive_bad is None:
            max_consecutive_bad = int(get_flag("FLAGS_max_bad_steps"))
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        self.max_consecutive_bad = max_consecutive_bad
        self.check_grads = check_grads
        self.nan_steps = 0
        self.skipped_steps = 0
        self.consecutive_bad = 0
        self.last_bad_loss = None
        self.last_bad_step = None

    # ------------------------------------------------------------ checks
    @staticmethod
    def _finite_all(arrays) -> bool:
        """One device-side check; a single bool crosses the host boundary
        (the cheap check the reference's check_nan_inf kernels do per-op,
        done once per step here): each tensor's largest magnitude, then
        isfinite-all over those."""
        ts = [a.detach() for a in arrays
              if isinstance(a, torch.Tensor) and a.is_floating_point()]
        if not ts:
            return True
        peaks = torch._foreach_norm(ts, float("inf"), dtype=torch.float32)
        return bool(torch.isfinite(torch.stack(peaks)).all())

    def pre_step(self, loss, optimizer=None, step=None) -> bool:
        """True: apply the optimizer update. False: skip this step
        (non-finite loss/grads); raises NonFiniteStepError once the
        consecutive-bad limit is hit."""
        arrays = [getattr(loss, "_data", loss)]
        if self.check_grads and optimizer is not None:
            arrays += [p.grad._data
                       for p in optimizer._parameter_list
                       if p.grad is not None]
        if self._finite_all(arrays):
            self.record_good()
            return True
        self._bad(nan=True, skipped=True, loss=loss, step=step)
        return False

    def observe_loss(self, loss_val, step=None) -> bool:
        """Post-hoc check for fused train steps (update already
        applied): counts + circuit-breaks on a non-finite loss."""
        import math
        try:
            finite = math.isfinite(float(loss_val))
        except (TypeError, ValueError):
            finite = False
        if finite:
            self.record_good()
            return True
        self._bad(nan=True, skipped=False, loss=loss_val, step=step)
        return False

    def observe_scaler(self, scaler, step=None) -> bool:
        """AMP: count a scaler-skipped step toward the breaker."""
        if scaler is None or not scaler.last_step_skipped():
            self.record_good()
            return True
        self._bad(nan=False, skipped=True, loss=None, step=step)
        return False

    # ---------------------------------------------------------- counters
    def record_good(self):
        self.consecutive_bad = 0

    def _bad(self, nan, skipped, loss, step):
        self.consecutive_bad += 1
        self.last_bad_step = step
        try:
            self.last_bad_loss = float(loss) if loss is not None else None
        except (TypeError, ValueError):
            self.last_bad_loss = None
        if nan:
            self.nan_steps += 1
        if skipped:
            self.skipped_steps += 1
        if _met._ENABLED:
            if nan:
                _met.REGISTRY.counter("train.nan_steps").inc()
            if skipped:
                _met.REGISTRY.counter("train.skipped_steps").inc()
        if self.consecutive_bad >= self.max_consecutive_bad:
            raise NonFiniteStepError(
                f"step guard circuit breaker: {self.consecutive_bad} "
                f"consecutive bad train steps (limit "
                f"{self.max_consecutive_bad}; totals: "
                f"{self.nan_steps} non-finite, {self.skipped_steps} "
                f"skipped; last bad step={self.last_bad_step}, "
                f"loss={self.last_bad_loss}) — refusing to keep "
                "training on garbage. Check the input shard for "
                "corrupt records, lower the learning rate, or raise "
                "FLAGS_max_bad_steps if transient spikes are expected.")


class PreemptionHandler:
    """Capture SIGTERM (the shape of a preemption notice) as a flag.

    The handler does NOTHING but set ``triggered`` — the train loop
    polls it at step boundaries, flushes a committed checkpoint, and
    exits cleanly; an async save inside a signal handler could tear
    its own checkpoint. ``install()`` degrades to a no-op off the main
    thread (signal.signal would raise) so worker threads can share
    loop code; ``triggered`` can also be set programmatically / by the
    ``train.preempt`` chaos site for drills without a real signal."""

    def __init__(self, signals=(_signal.SIGTERM,)):
        self.signals = tuple(signals)
        self.triggered = False
        self.installed = False
        self._old = {}

    def _on_signal(self, signum, frame):
        self.triggered = True

    def install(self):
        if threading.current_thread() is not threading.main_thread():
            return self
        for s in self.signals:
            self._old[s] = _signal.signal(s, self._on_signal)
        self.installed = True
        return self

    def restore(self):
        for s, h in self._old.items():
            try:
                _signal.signal(s, h)
            except (ValueError, OSError):
                pass
        self._old.clear()
        self.installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.restore()
        return False


# -------------------------------------------------------- train state I/O
def _scaler_state(scaler) -> dict:
    """GradScaler state as pure-python values (the checkpoint metadata
    is JSON; numpy arrays don't serialize)."""
    sd = scaler.state_dict()
    return {"scale": float(sd["scale"]),
            "incr_count": int(sd["incr_count"]),
            "decr_count": int(sd["decr_count"])}


def _rng_devices(state) -> list:
    """The generator's per-device ``torch.Generator`` states as JSON:
    ``[[device, base64 of the state bytes], ...]``."""
    return [[d, base64.b64encode(s.numpy().tobytes()).decode("ascii")]
            for d, s in sorted(state.get("devices", {}).items())]


def _set_rng(rng, devices):
    state = {"seed": rng["seed"], "offset": rng["offset"], "devices": {
        d: torch.from_numpy(np.frombuffer(base64.b64decode(b),
                                          np.uint8).copy())
        for d, b in devices}}
    gen_mod.default_generator().set_state(state)


def save_train_checkpoint(root: str, step: int, network,
                          optimizer=None, dataloader=None, scaler=None,
                          epoch: int = 0,
                          extra: Optional[dict] = None) -> str:
    """One committed per-step checkpoint under ``root``: model (+
    optimizer) tensors plus the python-valued train state — step
    counter, default-Generator RNG (seed, offset), dataloader
    position, scaler scale — everything a resume needs to replay the
    run exactly. Returns the step directory path. The write rides the
    ``_COMMITTED.json`` protocol: a save killed mid-write is simply
    never committed and :func:`load_train_checkpoint` skips it."""
    from ..distributed import checkpoint as dc

    state = {"model": network.state_dict()}
    if optimizer is not None:
        state["optimizer"] = optimizer.state_dict()
    rng = gen_mod.default_generator().get_state()
    train = {"step": int(step), "epoch": int(epoch),
             "rng": {"seed": rng["seed"], "offset": rng["offset"]},
             "rng_devices": _rng_devices(rng)}
    if dataloader is not None and hasattr(dataloader, "state_dict"):
        train["loader"] = dataloader.state_dict()
    if scaler is not None:
        train["scaler"] = _scaler_state(scaler)
    if extra:
        train["extra"] = dict(extra)
    state["train"] = train
    path = os.path.join(root, STEP_DIR_FMT % int(step))
    dc.save_state_dict(state, path)
    if _met._ENABLED:
        _met.REGISTRY.counter("train.checkpoint_saves").inc()
    return path


def load_train_checkpoint(root: str, network, optimizer=None,
                          dataloader=None, scaler=None):
    """Resume from the newest COMMITTED checkpoint under ``root``:
    fills the model/optimizer tensors in place, restores the default
    Generator, the dataloader position (so the next epoch pass
    fast-forwards to the exact batch after the save), and the scaler.
    Returns the restored train-state dict (``{"step": ..., "path":
    ...}``) or None when no committed checkpoint exists.

    Optimizer accumulators (Adam moments, velocities, ...) are
    normally created lazily on the first ``step()``; the load forces
    their creation first so a FRESH optimizer's template exposes them
    and the saved moments restore instead of silently dropping —
    stateful-optimizer resumes are bitwise too. Master weights are
    created the same way."""
    from ..distributed import checkpoint as dc

    path = dc.latest_committed(root)
    if path is None:
        return None
    state = {"model": network.state_dict()}
    if optimizer is not None:
        # accumulators (Adam moments, velocities, ...) are created
        # lazily on the first step(); create them NOW so the state
        # template exposes them and a fresh optimizer resumes its
        # moments instead of silently dropping them (the hook is
        # idempotent and parameter-list-driven)
        create = getattr(optimizer, "_create_accumulators", None)
        if callable(create):
            create()
        master = getattr(optimizer, "_master_weight", None)
        if callable(master):
            for p in optimizer._parameter_list:
                master(p)
        state["optimizer"] = optimizer.state_dict()
    train = {"step": -1, "epoch": 0, "rng": {"seed": 0, "offset": 0},
             "rng_devices": []}
    if dataloader is not None and hasattr(dataloader, "state_dict"):
        train["loader"] = dataloader.state_dict()
    if scaler is not None:
        train["scaler"] = _scaler_state(scaler)
    state["train"] = train
    dc.load_state_dict(state, path)
    if optimizer is not None:
        # tensor accumulators were filled IN PLACE (live references),
        # but the python leaves — LR-scheduler state, global_step —
        # were only written back into the template dict: hand them to
        # the optimizer or a scheduled-LR resume silently restarts its
        # schedule (re-assigning the tensors is idempotent)
        optimizer.set_state_dict(state["optimizer"])
    t = state["train"]
    _set_rng(t["rng"], t.pop("rng_devices"))
    if dataloader is not None and "loader" in t and \
            hasattr(dataloader, "set_state_dict"):
        dataloader.set_state_dict(t["loader"])
    if scaler is not None and "scaler" in t:
        scaler.load_state_dict({
            "scale": np.asarray(t["scaler"]["scale"], np.float32),
            "incr_count": t["scaler"]["incr_count"],
            "decr_count": t["scaler"]["decr_count"]})
    out = dict(t)
    out["path"] = path
    return out
