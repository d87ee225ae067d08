"""Parallel-config auto-tuner: the port of
``paddle_tpu/distributed/auto_tuner.py`` (reference: distributed/
auto_tuner/{prune,utils}.py — grid search with pruning over dp/mp/pp/
micro-batch configs, paired with the elastic manager that acts on live
readings).

Candidates are (dp, pp, tp, microbatch) factorizations of the job's
cards; pruning uses memory/divisibility constraints AND the analytic
planner (``prune_by_planner`` — configs the planner already refuses are
never measured); measurement runs the candidate and scores it **from the
metrics registry**: achieved MFU, registry tokens-per-step-second,
steady-state recompiles, bubble fraction and fetch-wait are read as a
snapshot *delta* around the run — no caller wall clock. Each measured candidate is appended to a JSONL trial log,
so a re-run (same trials_path) warm-starts: completed trials are
skipped and their recorded scores reused.

Legacy mode kept: a ``run_fn`` that returns seconds-per-step is scored
as 1/time (``source="wallclock"``); ``source="auto"`` (default) picks
per candidate based on what run_fn returns.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class Candidate:
    dp: int
    pp: int
    tp: int
    microbatches: int = 1
    sp: bool = False
    zero: int = 0
    remat: bool = True
    time_s: Optional[float] = None
    error: Optional[str] = None
    plan: Optional[object] = None   # full PlanCandidate when planner-guided
    score: Optional[float] = None   # higher is better (tune() fills)
    measurements: Dict[str, object] = field(default_factory=dict)

    @property
    def key(self) -> str:
        """Stable identity for the trial log / warm-start lookup."""
        return (f"dp{self.dp}_pp{self.pp}_tp{self.tp}"
                f"_mb{self.microbatches}_sp{int(self.sp)}"
                f"_z{self.zero}_r{int(self.remat)}")


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def generate_candidates(num_devices: int, num_layers: int,
                        global_batch: int, num_heads: int = 0,
                        max_mp: Optional[int] = None) -> List[Candidate]:
    out = []
    for tp in _divisors(num_devices):
        if max_mp and tp > max_mp:
            continue
        if num_heads and num_heads % tp != 0:
            continue
        rest = num_devices // tp
        for pp in _divisors(rest):
            dp = rest // pp
            if num_layers % pp != 0:
                continue  # prune: uneven stage split
            if global_batch % dp != 0:
                continue  # prune: uneven batch shard
            mbs = [m for m in _divisors(global_batch // dp)
                   if pp == 1 or m >= pp] or [1]
            for m in (mbs if pp > 1 else [1]):
                out.append(Candidate(dp=dp, pp=pp, tp=tp, microbatches=m))
    return out


def prune_by_memory(cands: List[Candidate], param_bytes: int,
                    hbm_bytes: int, optimizer_mult: float = 4.0
                    ) -> List[Candidate]:
    """Drop configs whose per-chip weight+opt state can't fit."""
    out = []
    for c in cands:
        shards = c.tp * c.pp
        per_chip = param_bytes * optimizer_mult / shards
        if per_chip <= hbm_bytes * 0.9:
            out.append(c)
    return out


def prune_by_planner(cands: List[Candidate], model_spec, n_chips: int,
                     global_batch: int, chip: str = "H100"
                     ) -> List[Candidate]:
    """Drop candidates the analytic planner (distributed/planner.py)
    already REFUSES — structurally illegal for the model (heads/hidden
    not divisible by tp, layers by pp, batch by dp) or
    memory-infeasible under the planner's estimate — so tune() never
    spends a measurement on them. Refused candidates get
    ``error="planner_refused: <reason>"`` and a ``autotuner.pruned``
    counter tick per reason; survivors carry their PlanCandidate in
    ``.plan`` (estimate attached) for downstream inspection."""
    from .planner import Planner, PlanCandidate

    pl = Planner(chip)
    kept = []
    for c in cands:
        # structural legality answered by the planner itself — one
        # rule set, no drift (Planner.refusal_reason)
        reason = pl.refusal_reason(
            model_spec, n_chips, global_batch, dp=c.dp, tp=c.tp,
            pp=c.pp, microbatches=c.microbatches, zero=c.zero)
        if reason is None:
            p = PlanCandidate(dp=c.dp, tp=c.tp, pp=c.pp, sp=c.sp,
                              zero=c.zero, remat=c.remat,
                              microbatches=c.microbatches)
            pl.estimate(p, model_spec, global_batch)
            if p.est_mem_bytes > pl.hbm_feasible_frac * pl.hbm:
                reason = "planner_mem"
            else:
                c.plan = p
        if reason is None:
            kept.append(c)
        else:
            c.error = f"planner_refused: {reason}"
            _count("autotuner.pruned", reason=reason)
    return kept


class _ModeMixError(RuntimeError):
    """run_fn switched scoring modes mid-sweep — aborts tune()."""


# ------------------------------------------------------------- scoring
def default_score(meas: Dict[str, object]) -> float:
    """Registry-derived candidate score, higher is better.

    Primary signal ladder (first available wins): achieved MFU (the
    ``train.mfu`` gauge — normalized, comparable across configs) ->
    registry tokens-per-step-second (counter delta over step-time
    histogram delta; involves no wall clock) -> 1/mean-step-time.
    Steady-state recompiles beyond a 2-executable allowance divide the
    score — a config that recompiles every step is worthless at any
    throughput."""
    base = meas.get("mfu") or meas.get("tokens_per_s") or 0.0
    if not base:
        mean = meas.get("mean_step_s")
        base = (1.0 / mean) if mean else 0.0
    excess = max(0.0, float(meas.get("compiles") or 0) - 2.0)
    return base / (1.0 + excess)


def _measure_window(delta) -> Dict[str, object]:
    """Distill a snapshot delta (observability.snapshots) into the
    flat measurement dict default_score consumes."""
    step = delta.hist("train.step_time_s")
    # the mfu GAUGE holds whatever the last step wrote — only trust it
    # when this candidate's window recorded steps AND the gauge moved
    # (a run without training.configure() never touches it; a stale
    # reading from the previous candidate must not leak into the
    # score). Identical-MFU candidates fall to the tokens/s signal —
    # a consistent ranking either way.
    mfu = None
    if step["count"]:
        a = delta.after.get("train.mfu")
        b = delta.before.get("train.mfu")
        if a is not None and (b is None
                              or b.get("value") != a.get("value")):
            mfu = a.get("value")
    meas: Dict[str, object] = {
        "steps": step["count"],
        "mean_step_s": step["mean"],
        "tokens": delta.value("train.tokens", default=0.0),
        # tokens per summed step-second — pure registry math
        "tokens_per_s": delta.per("train.tokens", "train.step_time_s"),
        "mfu": mfu,
        "compiles": delta.value("jit.xla_compiles", default=0.0),
        "fetch_wait_s": delta.hist("dataloader.fetch_wait_s")["sum"],
    }
    # bubble fraction: only meaningful when a schedule traced inside
    # the window; report the worst schedule that did
    bubbles = []
    for d in delta.after.series("pipeline.bubble_fraction"):
        lab = d.get("labels") or {}
        if delta.value("pipeline.traces", default=0.0, **lab):
            bubbles.append(d.get("value", 0.0))
    meas["bubble_fraction"] = max(bubbles) if bubbles else None
    return meas


def _count(name, **labels):
    try:
        from .. import observability as obs
        if obs.enabled():
            obs.counter(name, **labels).inc()
    except Exception:
        pass


# ----------------------------------------------------------- trial log
def default_trials_path() -> str:
    """Conventional warm-start trial log location, same cache root as
    the attention autotuner's winner table:
    ``$PADDLE_TPU_CACHE_DIR/auto_tuner_trials.jsonl`` (default cache
    root: ``paddle_tpu_torch/.cache/``)."""
    base = os.environ.get("PADDLE_TPU_CACHE_DIR")
    if not base:
        base = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".cache")
    return os.path.join(base, "auto_tuner_trials.jsonl")


def _load_trials(path: Optional[str]) -> Dict[str, dict]:
    """{candidate key: trial record} from a JSONL trial log; missing
    file -> empty, corrupt lines skipped (a half-written tail from a
    killed run must not poison the warm start)."""
    if not path or not os.path.exists(path):
        return {}
    out: Dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                out[rec["key"]] = rec
            except (ValueError, KeyError, TypeError):
                continue
    return out


def _append_trial(path: Optional[str], rec: dict) -> None:
    if not path:
        return
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    except OSError as e:
        # losing the warm-start log must not abort a sweep that just
        # spent real measurement time — same never-break-the-job
        # stance as _count
        import sys
        print(f"[auto_tuner] trial log write failed ({e}); "
              "continuing without persistence", file=sys.stderr)


# ---------------------------------------------------------------- tune
def tune(run_fn: Callable[[Candidate], Optional[float]],
         candidates: List[Candidate], warmup: int = 1, iters: int = 3,
         verbose: bool = True, source: str = "auto",
         trials_path: Optional[str] = None,
         score_fn: Callable[[Dict[str, object]], float] = default_score,
         planner_spec: Optional[tuple] = None,
         workload: Optional[str] = None) -> Candidate:
    """Run each candidate and return the best by score.

    run_fn(candidate) executes the candidate's training/serving slice
    (raises on OOM/compile failure). Scoring:

      * run_fn returns seconds-per-step -> legacy WALLCLOCK scoring
        (score = 1/seconds), unchanged contract;
      * run_fn returns None -> TELEMETRY scoring: the run is bracketed
        with registry snapshots and scored by ``score_fn`` over the
        delta (achieved MFU / tokens-per-step-second / recompile
        penalty — see default_score). No wall clock is consulted.
        After the sweep, telemetry candidates are RESCORED on a
        uniform signal — any signal missing for one of them is
        dropped for all, so no candidate is ranked on a different
        scale than its competitors.

    ``source`` pins the mode ("wallclock" | "telemetry"); the default
    "auto" decides per candidate from run_fn's return value (a run_fn
    should be consistent — mixing modes in one sweep makes the scores
    incomparable).

    ``trials_path`` names a JSONL trial log: every finished candidate
    (including failures) is appended, and a warm-started re-run skips
    any candidate whose key is already logged — telemetry trials
    re-enter the uniform rescoring from their logged measurements,
    wallclock/score-only trials keep their recorded score. Pass
    ``workload`` (any stable string naming the model/batch/workload)
    when one trial file serves more than one tuning target: it is
    folded into the lookup key, so trials from a different workload
    are never reused.

    ``planner_spec=(model_spec, n_chips, global_batch[, chip])``
    applies :func:`prune_by_planner` before measuring anything.
    """
    from ..observability import snapshots as _snap

    if planner_spec is not None:
        candidates = prune_by_planner(candidates, *planner_spec)
    prior = _load_trials(trials_path)

    def _k(c: Candidate) -> str:
        return f"{workload}::{c.key}" if workload else c.key

    #: telemetry-measured candidates, rescored uniformly after the loop
    tele: List[Candidate] = []
    #: what "auto" resolved to on the first measured candidate — lets
    #: the rest of a wallclock sweep skip the snapshot bracketing
    resolved: Optional[str] = None

    if source != "auto":
        resolved = source

    for c in candidates:
        rec = prior.get(_k(c))
        # one sweep = ONE scoring mode: wallclock scores (1/s) and
        # telemetry scores (mfu 0..1 / tokens/s) are incomparable
        # scales. The first reused trial or measured candidate pins
        # the sweep's mode; trials recorded under the other mode are
        # never reused (legacy source-less records pass through).
        if (rec is not None and resolved is not None
                and rec.get("source") not in (resolved, None)):
            rec = None
        if rec is not None:
            # warm start: trust the log, skip the measurement
            c.score = rec.get("score")
            c.time_s = rec.get("time_s")
            c.error = rec.get("error")
            c.measurements = rec.get("measurements") or {}
            if c.error is None:
                resolved = resolved or rec.get("source")
            _count("autotuner.trials_skipped")
            if (c.error is None and c.measurements
                    and "time_s" not in c.measurements):
                tele.append(c)
            if verbose:
                print(f"[auto_tuner] {c.key}: warm-start "
                      f"(score={c.score})")
            continue
        mode = source
        try:
            # wallclock sweeps skip the snapshot bracketing — the
            # delta would be computed only to be discarded
            before = (None if resolved == "wallclock"
                      else _snap.Snapshot.take())
            ret = run_fn(c)
            if mode == "auto":
                mode = ("wallclock" if isinstance(ret, (int, float))
                        and not isinstance(ret, bool) else "telemetry")
            if resolved is not None and mode != resolved:
                # run_fn switched modes mid-sweep (either direction):
                # the scores would not be comparable. This is a caller
                # bug, not an infeasible candidate — ABORT the sweep
                # (no trial is logged for it; see the re-raise below)
                raise _ModeMixError(
                    f"run_fn produced a {mode!r}-mode result in a "
                    f"sweep already resolved to {resolved!r} — a "
                    "sweep must not mix scoring modes (did you "
                    "warm-start from a trial log recorded under the "
                    "other mode? pin `source=` or change "
                    "`workload`/`trials_path`)")
            resolved = mode
            if mode == "wallclock":
                c.time_s = float(ret)
                c.score = 1.0 / c.time_s if c.time_s > 0 else 0.0
                c.measurements = {"time_s": c.time_s}
                if verbose:
                    print(f"[auto_tuner] dp={c.dp} pp={c.pp} tp={c.tp} "
                          f"mb={c.microbatches}: "
                          f"{c.time_s * 1e3:.1f} ms/step")
            else:
                c.measurements = _measure_window(
                    _snap.SnapshotDelta(before, _snap.Snapshot.take()))
                # provisional (log/verbose); final ranking rescored
                # uniformly below
                c.score = float(score_fn(c.measurements))
                tele.append(c)
                if c.measurements.get("mean_step_s"):
                    c.time_s = c.measurements["mean_step_s"]
                if verbose:
                    m = c.measurements
                    print(f"[auto_tuner] dp={c.dp} pp={c.pp} tp={c.tp} "
                          f"mb={c.microbatches}: score={c.score:.4g} "
                          f"(mfu={m.get('mfu')}, "
                          f"tok/s={m.get('tokens_per_s')}, "
                          f"compiles={m.get('compiles')})")
            _count("autotuner.trials", source=mode)
        except _ModeMixError:
            raise        # caller bug — never downgraded to a trial
        except Exception as e:  # infeasible candidate
            c.error = f"{type(e).__name__}: {e}"
            if verbose:
                print(f"[auto_tuner] dp={c.dp} pp={c.pp} tp={c.tp} "
                      f"pruned: {c.error[:80]}")
        rec = {
            "key": _k(c), "dp": c.dp, "pp": c.pp, "tp": c.tp,
            "microbatches": c.microbatches, "sp": c.sp,
            "zero": c.zero, "remat": c.remat, "score": c.score,
            "time_s": c.time_s, "error": c.error,
            "measurements": c.measurements,
            # an exception before the mode resolved leaves "auto" —
            # record None so the reuse filter treats it as wildcard
            "source": mode if mode != "auto" else None,
            "workload": workload, "ts": time.time()}
        # a duplicate candidate later in THIS run warm-starts too
        prior[_k(c)] = rec
        _append_trial(trials_path, rec)

    # ---- uniform-signal rescoring: default_score's ladder (mfu ->
    # tokens/s -> 1/step) must pick the SAME rung for every telemetry
    # candidate, or a candidate falling back to tokens/s (thousands)
    # would always beat one scored on mfu (0..1)
    if tele:
        drop_mfu = not all(c.measurements.get("mfu") for c in tele)
        drop_tps = not all(c.measurements.get("tokens_per_s")
                           for c in tele)
        for c in tele:
            meas = dict(c.measurements)
            if drop_mfu:
                meas["mfu"] = None
            if drop_tps:
                meas["tokens_per_s"] = None
            c.score = float(score_fn(meas))

    best: Optional[Candidate] = None
    for c in candidates:
        if c.score is not None and (best is None or c.score > best.score):
            best = c
    if best is None:
        raise RuntimeError("auto_tuner: no feasible candidate")
    try:
        from .. import observability as obs
        obs.gauge("autotuner.best_score").set(best.score)
    except Exception:
        pass
    return best


def planner_guided_candidates(model_spec, n_chips: int,
                              global_batch: int, chip: str = "H100",
                              top_k: int = 8) -> List[Candidate]:
    """Analytic-first search (the reference planner_v2 -> auto-tuner
    handoff): rank the full (dp, tp, pp, sp, zero, remat, microbatch)
    space with the calibrated cost model (distributed/planner.py), then
    hand only the top_k to `tune` for real measurement — replacing the
    blind grid with a model-pruned shortlist."""
    from .planner import Planner

    plans = Planner(chip).plan(model_spec, n_chips, global_batch,
                               top_k=top_k)
    return [Candidate(dp=p.dp, pp=p.pp, tp=p.tp,
                      microbatches=p.microbatches, sp=p.sp,
                      zero=p.zero, remat=p.remat, plan=p)
            for p in plans]
