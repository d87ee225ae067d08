"""Pipeline-parallel checkpoint layout converter: the port of
``paddle_tpu/distributed/fleet/pp_parallel_adaptor.py`` (pure Python,
copied so that the port imports nothing of the reference package).

Reference: fleet/utils/pp_parallel_adaptor.py (PipeLineModelAdaptor) —
converts per-stage PipelineLayer checkpoints saved under one pipeline
configuration (pp degree, virtual-pp degree) into another, by renaming
the per-stage-local layer indices through the global layer order and
re-splitting into the destination stages.

A checkpoint here is a plain dict per stage mapping
parameter names like "layers.<local_idx>.<param>" (the PipelineLayer
naming), plus shared/non-layer entries replicated to the stages that
reference them. The converter is functional — dicts in, dicts out — so
it composes with paddle_tpu_torch.framework.io.save/load and the sharded
distributed.checkpoint path.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, List, Sequence

__all__ = ["ParallelConfig", "PipeLineModelAdaptor",
           "convert_pp_state_dicts"]

_LAYER_RE = re.compile(r"^layers\.(\d+)\.(.+)$")


def _values_equal(a, b) -> bool:
    import numpy as np
    try:
        a, b = np.asarray(a), np.asarray(b)
    except Exception:
        return a is b
    try:
        # NaN-containing replicas are still replicas
        return bool(np.array_equal(a, b, equal_nan=True))
    except TypeError:   # equal_nan unsupported for this dtype
        return bool(np.array_equal(a, b))


class ParallelConfig:
    """Pipeline layout description (reference pp_parallel_adaptor.py
    ParallelConfig, reduced to the axes the conversion needs)."""

    def __init__(self, pp: int, vpp: int = 1):
        if pp < 1 or vpp < 1:
            raise ValueError("pp and vpp must be >= 1")
        self.pp = pp
        self.vpp = vpp

    def stage_chunks(self, num_layers: int) -> List[List[int]]:
        """Global layer ids held by each stage, in local order.

        With vpp > 1 a stage holds vpp interleaved chunks (reference
        VPP assignment: chunk c of stage s covers layers
        [(c*pp + s) * L/(pp*vpp), ...))."""
        total_chunks = self.pp * self.vpp
        if num_layers % total_chunks != 0:
            raise ValueError(
                f"{num_layers} layers not divisible by pp*vpp="
                f"{total_chunks}")
        per = num_layers // total_chunks
        out = []
        for s in range(self.pp):
            mine: List[int] = []
            for c in range(self.vpp):
                start = (c * self.pp + s) * per
                mine.extend(range(start, start + per))
            out.append(mine)
        return out


def _split_stage_dict(stage_dict: Dict, layer_ids: Sequence[int]):
    """(per-global-layer params, passthrough non-layer params)."""
    by_layer: Dict[int, Dict[str, object]] = {g: {} for g in layer_ids}
    passthrough: Dict[str, object] = {}
    for name, value in stage_dict.items():
        m = _LAYER_RE.match(name)
        if m is None:
            passthrough[name] = value
            continue
        local = int(m.group(1))
        if local >= len(layer_ids):
            raise KeyError(
                f"param {name}: local layer {local} out of range for a "
                f"stage holding {len(layer_ids)} layers")
        by_layer[layer_ids[local]][m.group(2)] = value
    return by_layer, passthrough


def convert_pp_state_dicts(stage_dicts: Sequence[Dict],
                           src: ParallelConfig,
                           dst: ParallelConfig) -> List[Dict]:
    """Re-partition per-stage state dicts from layout src to dst.

    Layer params are renamed through global layer ids; non-layer
    entries (shared embeddings, final norm, ...) are replicated to
    EVERY destination stage — a stage model that does not reference an
    entry simply ignores it, while tied-embedding stages (first/last)
    always find their copy. Same-named entries held by several source
    stages are treated as replicas (first seen wins); a warning is
    emitted if the replicas are not numerically identical."""
    if len(stage_dicts) != src.pp:
        raise ValueError(f"expected {src.pp} stage dicts, "
                         f"got {len(stage_dicts)}")
    num_layers = sum(
        len({int(m.group(1)) for m in map(_LAYER_RE.match, d)
             if m is not None}) for d in stage_dicts)
    src_chunks = src.stage_chunks(num_layers)
    dst_chunks = dst.stage_chunks(num_layers)

    global_params: Dict[int, Dict[str, object]] = {}
    passthrough: Dict[str, object] = {}
    for stage_dict, layer_ids in zip(stage_dicts, src_chunks):
        by_layer, extra = _split_stage_dict(stage_dict, layer_ids)
        global_params.update(by_layer)
        for k, v in extra.items():
            if k in passthrough:
                if not _values_equal(passthrough[k], v):
                    warnings.warn(
                        f"non-layer checkpoint entry {k!r} appears in "
                        "multiple source stages with different values; "
                        "keeping the first-seen copy")
            else:
                passthrough[k] = v

    out: List[Dict] = []
    for layer_ids in dst_chunks:
        d: Dict[str, object] = {}
        for local, g in enumerate(layer_ids):
            for pname, value in global_params[g].items():
                d[f"layers.{local}.{pname}"] = value
        d.update(passthrough)
        out.append(d)
    return out


class PipeLineModelAdaptor:
    """Reference-shaped driver (fleet/utils/pp_parallel_adaptor.py):
    holds the two layouts and converts checkpoint dicts between them."""

    def __init__(self, src_parallel_config: ParallelConfig,
                 dst_parallel_config: ParallelConfig):
        self._src = src_parallel_config
        self._dst = dst_parallel_config

    def apply(self, stage_dicts: Sequence[Dict]) -> List[Dict]:
        return convert_pp_state_dicts(stage_dicts, self._src, self._dst)

    def peek_model(self, stage_dicts: Sequence[Dict]) -> List[str]:
        """List the converted parameter names per stage (reference
        peek utility for checkpoint inspection)."""
        return ["; ".join(sorted(d)) for d in self.apply(stage_dicts)]
