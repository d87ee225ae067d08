"""Training-loop instrumentation helpers: the port of
``paddle_tpu/observability/training.py``.

One funnel — ``record_step(dt_s, samples=, tokens=)`` — shared by the
hapi trainer and user loops: it feeds the step-time histogram, the
samples/s / tokens/s gauges, and (when the model's arithmetic cost is
configured) the achieved-MFU gauge, using the same flops math as the
port's ``cost_model.gpt_flops_per_token``.

The default peak is one H100's dense bf16 rate
(``cost_model.GPU_SPECS["H100"]["flops"]``), where the reference divides by
one v5e chip's: the port's MFU is a share of the card it runs on.
"""
from __future__ import annotations

from typing import Optional

from . import metrics as _met
from ..cost_model.cost_model import GPU_SPECS as _GPU_SPECS

#: bf16 dense peak FLOP/s of one H100 SXM — the MFU denominator
DEFAULT_PEAK_FLOPS = _GPU_SPECS["H100"]["flops"]

_flops_per_token: Optional[float] = None
_peak_flops: float = DEFAULT_PEAK_FLOPS


def configure(flops_per_token: Optional[float] = None,
              peak_flops: Optional[float] = None) -> None:
    """Declare the model's cost so record_step can derive MFU.
    flops_per_token: e.g. cost_model.gpt_flops_per_token(cfg, seq);
    peak_flops: accelerator peak (default: one H100's bf16)."""
    global _flops_per_token, _peak_flops
    if flops_per_token is not None:
        _flops_per_token = float(flops_per_token)
    if peak_flops is not None:
        _peak_flops = float(peak_flops)


def record_step(dt_s: float, samples: Optional[int] = None,
                tokens: Optional[int] = None) -> None:
    """Record one optimizer step: wall time, throughput, MFU."""
    if not _met._ENABLED:
        return
    r = _met.REGISTRY
    r.counter("train.steps").inc()
    r.histogram("train.step_time_s").observe(dt_s)
    if samples:
        r.counter("train.samples").inc(samples)
        if dt_s > 0:
            r.gauge("train.samples_per_s").set(samples / dt_s)
    if tokens:
        r.counter("train.tokens").inc(tokens)
        if dt_s > 0:
            r.gauge("train.tokens_per_s").set(tokens / dt_s)
            if _flops_per_token:
                r.gauge("train.mfu").set(
                    (tokens / dt_s) * _flops_per_token / _peak_flops)
