"""Fault-injection hook points: the port's own copy of
``paddle_tpu/_chaos.py`` (pure Python).

The serving stack calls :func:`hit` at named sites:
``serving.cache_alloc`` (``inference.decode.init_static_cache``),
``serving.admit_step`` and ``serving.decode_step`` (the continuous-batching
session's device calls, inside its retry envelope) and ``serving.drain``
(its token fetch). The training loop calls the training sites:
``train.step`` (``hapi.Model.train_batch``), ``train.data_fetch`` (each
batch of ``Model.fit``), ``train.checkpoint_save`` (the write of
``distributed.checkpoint.save_state_dict``) and ``train.preempt``
(``hapi.FaultTolerantCheckpoint`` at each step boundary).

When the ``PADDLE_TPU_CHAOS`` env var is unset (the production default)
``hit`` is a single env check and nothing else runs. With it set,
installed rules can inject

  * ``error``  — raise :class:`ChaosError` (a step exception),
  * ``alloc``  — raise :class:`ChaosAllocError` (an allocation failure,
    message shaped like an out-of-memory RESOURCE_EXHAUSTED),
  * ``slow``   — sleep ``seconds`` (a slow step), then continue,

either a bounded number of ``times`` (transient fault) or forever
(persistent fault). Rules may carry a ``match(ctx)`` predicate over the
site's context kwargs (fail the decode step only while a poison request's
slot is in the active set), which is what lets the recovery tests prove
that bisection finds the request, not just the step.

Two ways to install rules:

  * programmatic (tests): ``install("serving.decode_step",
    kind="error", times=2)`` / ``clear()``; rules fire only while
    ``PADDLE_TPU_CHAOS`` is set (any non-empty value, e.g. ``on``), so a
    stray import can never inject faults into production;
  * env spec (no code): ``PADDLE_TPU_CHAOS=
    "serving.decode_step:error:3;serving.drain:slow:0.2"``; each clause is
    ``site:kind[:arg]`` where ``arg`` is ``times`` for error/alloc and
    ``seconds`` for slow.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

ENV = "PADDLE_TPU_CHAOS"

KINDS = ("error", "slow", "alloc")


class ChaosError(RuntimeError):
    """Injected step exception."""


class ChaosAllocError(ChaosError):
    """Injected allocation failure."""


class Rule:
    """One injection rule; ``times=None`` means persistent."""

    __slots__ = ("site", "kind", "times", "seconds", "match", "fired",
                 "from_env")

    def __init__(self, site: str, kind: str = "error",
                 times: Optional[int] = None, seconds: float = 0.05,
                 match: Optional[Callable[[dict], bool]] = None,
                 from_env: bool = False):
        if kind not in KINDS:
            raise ValueError(f"chaos kind {kind!r} not in {KINDS}")
        self.site = site
        self.kind = kind
        self.times = times
        self.seconds = float(seconds)
        self.match = match
        self.fired = 0
        #: parsed from the env spec (replaced wholesale on re-parse)
        self.from_env = from_env

    def _applies(self, site: str, ctx: dict) -> bool:
        if site != self.site:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if self.match is not None and not self.match(ctx):
            return False
        return True

    def _fire(self, site: str):
        self.fired += 1
        if self.kind == "slow":
            time.sleep(self.seconds)
            return
        if self.kind == "alloc":
            raise ChaosAllocError(
                f"RESOURCE_EXHAUSTED: chaos allocation failure injected "
                f"at {site} (fire #{self.fired})")
        raise ChaosError(
            f"chaos error injected at {site} (fire #{self.fired})")


_rules: List[Rule] = []
#: env spec string already parsed into _rules (parse once per value)
_parsed_env: Optional[str] = None


def active() -> bool:
    """Chaos is armed only while the env var is non-empty."""
    return bool(os.environ.get(ENV, "").strip())


def install(site: str, kind: str = "error", times: Optional[int] = None,
            seconds: float = 0.05,
            match: Optional[Callable[[dict], bool]] = None) -> Rule:
    """Install one programmatic rule (tests). The rule only ever fires
    while ``PADDLE_TPU_CHAOS`` is set."""
    rule = Rule(site, kind, times, seconds, match)
    _rules.append(rule)
    return rule


def clear() -> None:
    """Drop every installed rule and forget the parsed env spec."""
    global _parsed_env
    _rules.clear()
    _parsed_env = None


def _parse_env(spec: str) -> None:
    """Parse ``site:kind[:arg]`` clauses; bare enable values ("on",
    "1") install nothing. Malformed clauses are skipped — chaos config
    must never crash the serving process it is trying to harden. A
    CHANGED spec replaces the previous spec's rules wholesale
    (programmatic rules are untouched) — an operator switching
    experiments must not keep the old faults firing."""
    global _parsed_env
    _parsed_env = spec
    _rules[:] = [r for r in _rules if not r.from_env]
    for clause in spec.split(";"):
        parts = clause.strip().split(":")
        if len(parts) < 2 or parts[1] not in KINDS:
            continue
        site, kind = parts[0], parts[1]
        try:
            arg = float(parts[2]) if len(parts) > 2 else None
        except ValueError:
            continue
        if kind == "slow":
            _rules.append(Rule(site, kind, seconds=arg or 0.05,
                               from_env=True))
        else:
            _rules.append(Rule(
                site, kind, times=int(arg) if arg is not None else None,
                from_env=True))


def hit(site: str, **ctx) -> None:
    """Chaos hook point: no-op unless ``PADDLE_TPU_CHAOS`` is set AND
    a matching rule has budget left. Call sites pass whatever context
    a predicate might key on (``slots=...``, ``rid=...``)."""
    global _parsed_env
    spec = os.environ.get(ENV, "").strip()
    if not spec:
        return
    if spec != _parsed_env:
        if spec.lower() in ("1", "on", "true"):
            # bare arming value: drop any previous env-spec rules,
            # keep programmatic ones
            _parsed_env = spec
            _rules[:] = [r for r in _rules if not r.from_env]
        else:
            _parse_env(spec)
    for rule in _rules:
        if rule._applies(site, ctx):
            rule._fire(site)
