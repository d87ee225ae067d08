"""Canonical metric-name catalog: the port's own copy of
``paddle_tpu/observability/catalog.py``, with the two names the port adds:
``nn.sdpa`` (the route ``scaled_dot_product_attention`` took on the card)
and ``serving.time_to_first_token_s`` (a continuous-batching request's
submit-to-first-token time).

Every ``REGISTRY.counter/gauge/histogram`` call site of
``paddle_tpu_torch/`` uses a name declared here, so dashboards and the
scrape endpoint cannot drift from what the code emits. Each entry:
``kind`` (counter|gauge|histogram), ``help`` (one line), ``labels`` (the
label keys a site may attach). Entries with ``internal=True`` are
registered by the observability layer itself. Names of slices not ported
yet (``jit.*``, ``pipeline.*``, ...) are kept with the reference's
meaning.
"""
from __future__ import annotations


def _m(kind, help, labels=(), internal=False):  # noqa: A002 (help)
    return {"kind": kind, "help": help, "labels": tuple(labels),
            "internal": internal}


CATALOG = {
    # ------------------------------------------------------- training
    "train.steps": _m("counter", "optimizer steps completed"),
    "train.step_time_s": _m("histogram", "wall time per optimizer step"),
    "train.samples": _m("counter", "training samples consumed"),
    "train.samples_per_s": _m("gauge", "samples/s of the last step"),
    "train.tokens": _m("counter", "training tokens consumed"),
    "train.tokens_per_s": _m("gauge", "tokens/s of the last step"),
    "train.mfu": _m("gauge",
                    "achieved model-flops utilization of the last step"),
    # ------------------------------------------- training robustness
    "train.nan_steps": _m(
        "counter", "train steps whose loss/grads were non-finite "
        "(step guard detections)"),
    "train.skipped_steps": _m(
        "counter", "optimizer updates skipped by the step guard or "
        "the AMP loss scaler"),
    "train.hang_aborts": _m(
        "counter", "train steps aborted by the stall/collective "
        "watchdog instead of hanging"),
    "train.straggler_ranks": _m(
        "gauge", "straggler ranks named by the last hang report"),
    "train.preemptions": _m(
        "counter", "preemption notices honored with a committed "
        "checkpoint flush before exit"),
    "train.checkpoint_saves": _m(
        "counter", "committed train-state checkpoints written"),
    "train.restarts": _m(
        "counter", "supervised in-process restarts (run_resilient)"),
    # ------------------------------------------------- jit / compiles
    "jit.xla_compiles": _m("counter",
                           "compiled executable builds process-wide"),
    "jit.fn_calls": _m("counter", "StaticFunction calls", ("fn",)),
    "jit.fn_cache_hits": _m("counter",
                            "StaticFunction spec-cache hits", ("fn",)),
    "jit.fn_probes": _m("counter",
                        "StaticFunction eager probe runs", ("fn",)),
    "jit.fn_builds": _m("counter",
                        "StaticFunction specialization builds", ("fn",)),
    "jit.fn_graph_breaks": _m("counter",
                              "StaticFunction graph breaks", ("fn",)),
    "jit.static_functions": _m("gauge",
                               "live StaticFunction count (collector)"),
    "jit.specializations": _m("gauge",
                              "total jit specializations (collector)"),
    "jit.xla_executables": _m("gauge",
                              "total cached executables (collector)"),
    "jit.graph_breaks": _m("gauge",
                           "total graph breaks (collector)"),
    # ------------------------------------------------------ pipelines
    "pipeline.bubble_fraction": _m(
        "gauge", "analytic bubble fraction at trace time", ("schedule",)),
    "pipeline.makespan_ticks": _m(
        "gauge", "schedule makespan in ticks", ("schedule",)),
    "pipeline.stages": _m("gauge", "pipeline stages", ("schedule",)),
    "pipeline.microbatches": _m(
        "gauge", "pipeline microbatches", ("schedule",)),
    "pipeline.traces": _m(
        "counter", "schedule trace events", ("schedule",)),
    # -------------------------------------------------------- serving
    "serving.generate_calls": _m("counter", "DecodeSession.generate calls"),
    "serving.prefill_tokens": _m("counter", "prompt tokens prefilled"),
    "serving.decode_tokens": _m("counter", "tokens decoded"),
    "serving.generate_latency_s": _m(
        "histogram", "end-to-end generate() latency"),
    "serving.request_latency_s": _m(
        "histogram", "submit-to-retire latency per request"),
    "serving.time_to_first_token_s": _m(
        "histogram", "submit to first token delivered to the host, per "
        "continuous-batching request"),
    "serving.decode_tokens_per_s": _m(
        "gauge", "decode throughput of the last drain"),
    "serving.prefill_tokens_per_s": _m(
        "gauge", "prefill throughput of the last admit"),
    "serving.requests_submitted": _m("counter", "requests submitted"),
    "serving.requests_completed": _m("counter", "requests retired"),
    "serving.admits": _m("counter", "slot admissions"),
    "serving.steps": _m("counter", "continuous-batching steps"),
    "serving.queue_depth": _m("gauge", "requests waiting for a slot"),
    "serving.slots_active": _m("gauge", "slots currently decoding"),
    "serving.slot_utilization": _m("gauge", "active slots / max slots"),
    "serving.inflight_requests": _m(
        "gauge", "submitted-but-undelivered requests"),
    # -------------------------------------------- serving robustness
    "serving.rejected": _m(
        "counter", "requests shed by admission control (fast "
        "rejections + priority-lane evictions)"),
    "serving.timed_out": _m(
        "counter", "requests evicted at a TTFT/total deadline"),
    "serving.cancelled": _m(
        "counter", "requests cancelled by the caller or session close"),
    "serving.step_retries": _m(
        "counter", "device-step retries inside the backoff envelope"),
    "serving.quarantined": _m(
        "counter", "poison requests failed+isolated by step-failure "
        "recovery (admit-time or bisection)"),
    "serving.degraded": _m(
        "gauge", "1 while readiness reports degraded "
        "(queue/slot pressure past thresholds)"),
    # ----------------------------------------------------- dataloader
    "dataloader.fetch_wait_s": _m(
        "histogram", "time the consumer waited on the loader"),
    "dataloader.batches": _m("counter", "batches produced"),
    # ---------------------------------------------------- collectives
    "collective.calls": _m("counter", "collective op launches", ("op",)),
    "collective.bytes": _m("counter", "bytes moved by collectives",
                           ("op",)),
    "collective.host_staged": _m(
        "counter", "collectives of CUDA tensors run on a host copy (under "
        "gloo, all but the all-reduce and the broadcast)",
        ("op",)),
    # -------------------------------------------------- eager dispatch
    "eager.op_dispatches": _m("counter", "eager op dispatches"),
    "eager.grad_ops": _m("counter", "ops recorded on the eager tape"),
    # ------------------------------------------------------ attention
    "attn.dispatch": _m("counter",
                        "attention kernel dispatches (flash_attention_maybe)",
                        ("kernel",)),
    "attn.dispatch_fallback": _m(
        "counter", "shape-gate rejections falling back to plain attention",
        ("reason",)),
    "nn.sdpa": _m(
        "counter", "scaled_dot_product_attention calls on the card by the "
        "route taken (library_flash | plain)", ("route",)),
    # ------------------------------------------------------ autotuner
    "autotuner.trials": _m("counter",
                           "auto-tuner candidates measured", ("source",)),
    "autotuner.trials_skipped": _m(
        "counter", "candidates satisfied from the warm-start trial log"),
    "autotuner.pruned": _m("counter",
                           "candidates refused before measurement",
                           ("reason",)),
    "autotuner.best_score": _m("gauge",
                               "score of the best candidate so far"),
    # -------------------------------------------------- observability
    "metrics.scrapes": _m("counter", "/metrics HTTP scrapes served"),
    "metrics.dropped_series": _m(
        "counter",
        "metric lookups dropped by the per-name cardinality cap",
        internal=True),
}


def names() -> set:
    return set(CATALOG)


def internal_names() -> set:
    """Names registered by the observability layer itself (no
    walker-visible literal call site required)."""
    return {n for n, d in CATALOG.items() if d["internal"]}


def check(name: str) -> None:
    """Raise KeyError with a pointed message for an uncataloged name
    (used by tests; production emission never pays this check)."""
    if name not in CATALOG:
        raise KeyError(
            f"metric {name!r} is not in observability/catalog.py — add "
            "it there (one canonical home) before emitting it")
