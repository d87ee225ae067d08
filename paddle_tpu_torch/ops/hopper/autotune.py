"""Runtime attention-kernel autotune: measure-and-cache dispatch.

Port of ``paddle_tpu/ops/pallas/autotune.py``: the same candidates under the
same names and in the same order (``simple``, ``causal_skip``, ``qblock``,
``blocked_bq{X}_bkv{Y}``, ``library_flash``, ``xla``), the same table
schema, merge-then-replace persistence and schema validation, and the same
precedence in ``flash_attention_maybe``. A measurement times forward and
backward (a ones cotangent) of each candidate with CUDA events: one warm-up
call, then 5 windows of 3 reps, of which the median counts. Winners are
cached per (device name, B, H, S, Skv, D, dtype, causal) in memory and
persisted as JSON under ``$PADDLE_TPU_CACHE_DIR/attn_autotune_torch.json``
(default ``paddle_tpu_torch/.cache/``, where the reference keeps
``paddle_tpu/.cache/attn_autotune.json``), so later processes on the same
card skip the measurement.

Where it differs from the reference, and why:

- **Only ``measure`` measures.** ``decide`` answers from the table alone; a
  shape with no entry takes the static chain until a caller runs
  ``measure`` for it. The reference measures on the first eager call per
  shape on a TPU; the port's train step is eager, and a measurement in the
  middle of a forward would time the candidates inside a checkpointed
  block.
- **The winner is a Hopper kernel.** ``xla`` (plain attention, its
  products in cuBLAS) is timed as the yardstick beside the kernels and kept
  in ``timings_ms``, but the winner is the fastest kernel, and a table entry
  that names ``xla`` is read as no entry: dispatch on the card never hands
  attention to plain PyTorch.
- **Only ``NotImplementedError`` loses the race quietly.** It marks a tier
  with no Hopper kernel (``library_flash``); ``_time_candidate`` turns it
  into ``inf``. Every other error propagates, so a broken kernel fails the
  run; the reference times any failure as ``inf``.
- **No ``FLAGS_deterministic``.** With measurement explicit, the table is
  the only input to the choice; ``FLAGS_attn_autotune`` off restores the
  static chain.
- **The blocked variants launch one kernel.** Every ``blocked_bq*_bkv*``
  candidate runs the same Hopper kernels, which tile by their own 64 rows;
  the blocks set only the plain version's kv loop. They are timed one by
  one all the same, as the reference times its variants.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
from typing import Dict, List, Optional, Tuple

import torch

from ...core.flags import define_flag, get_flag
from ...device import resolve_device
from . import blocked_flash as bf
from . import causal_attention as ca
from . import simple_attention as sa
from . import simple_attention2 as sa2

define_flag("FLAGS_attn_autotune", True,
            "dispatch attention to the kernel that autotune.measure found "
            "fastest for the shape, where the table has one")

#: candidate name -> runner(q, k, v, causal, scale) in [B,S,H,D] layout;
#: populated lazily (the library tier lives in flash_attention, which
#: imports this module)
_RUNNERS = None

_table: Optional[Dict[str, dict]] = None

# The yardstick: timed beside the kernels, never a winner.
PLAIN = "xla"


def _bhsd(run):
    """[B,S,H,D] entry -> [B,H,S,D] kernel-layout runner."""
    def wrapped(q, k, v, causal, scale):
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        return run(qt, kt, vt, causal, scale).transpose(1, 2)
    return wrapped


def _cache_path() -> str:
    base = os.environ.get("PADDLE_TPU_CACHE_DIR")
    if base is None:
        base = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".cache")
    return os.path.join(base, "attn_autotune_torch.json")


def _read_disk_table(path: str) -> Dict[str, dict]:
    """Best-effort read; a corrupted / partially written / wrong-schema
    file degrades to {} (the static chain) instead of raising."""
    try:
        with open(path) as f:
            tab = json.load(f)
    except (OSError, ValueError):
        return {}
    return tab if isinstance(tab, dict) else {}


def _load_table() -> Dict[str, dict]:
    global _table
    if _table is None:
        _table = _read_disk_table(_cache_path())
    return _table


def _save_table() -> None:
    global _table
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # merge-then-replace: re-read the file so winners measured by a
        # concurrent process since our load are kept (our entries win
        # on key collision), and write via temp file + os.replace so a
        # concurrent reader can never observe a partial write
        merged = _read_disk_table(path)
        merged.update(_table)
        _table = merged
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass                        # read-only FS: in-memory cache only


def _device_kind() -> str:
    if not torch.cuda.is_available():
        return "unknown"
    return torch.cuda.get_device_name().replace(" ", "_")


def _key(bshd: Tuple[int, int, int, int], skv: int, dtype,
         causal: bool) -> str:
    b, s, h, d = bshd
    return (f"{_device_kind()}|B{b}S{s}H{h}D{d}Skv{skv}|"
            f"{str(dtype).split('.')[-1]}|causal={bool(causal)}")


def _xla(q, k, v, causal, scale):
    """Plain attention (the reference's "xla" candidate), bottom-right
    causal mask as there; its two products go to cuBLAS."""
    d = q.shape[-1]
    sm = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * sm
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = logits.masked_fill(~mask, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _runners():
    global _RUNNERS
    if _RUNNERS is not None:
        return _RUNNERS
    from . import flash_attention as fa

    _RUNNERS = {
        "simple": _bhsd(lambda q, k, v, c, s: sa.attention_bhsd(
            q, k, v, causal=c, scale=s)),
        "causal_skip": _bhsd(lambda q, k, v, c, s: ca.attention_bhsd(
            q, k, v, causal=c, scale=s)),
        "qblock": _bhsd(lambda q, k, v, c, s: sa2.attention_bhsd(
            q, k, v, causal=c, scale=s)),
        "library_flash": fa.flash_attention,
        PLAIN: _xla,
    }
    return _RUNNERS


_BLOCKED_RE = re.compile(r"^blocked_bq(\d+)_bkv(\d+)$")


def blocked_name(bq: int, bkv: int) -> str:
    return f"blocked_bq{bq}_bkv{bkv}"


def _resolve(name: str):
    """Runner for a candidate name; blocked variants carry their block
    sizes in the name so the winner cache pins (kernel, bq, bkv)."""
    m = _BLOCKED_RE.match(name)
    if m is None:
        return _runners()[name]
    bq, bkv = int(m.group(1)), int(m.group(2))
    return _bhsd(lambda q, k, v, c, s: bf.attention_bhsd(
        q, k, v, causal=c, scale=s, block_q=bq, block_kv=bkv))


def candidates(bshd, skv, dtype, causal) -> List[str]:
    """Kernels whose shape gates accept this problem ([B,S,H,D])."""
    from . import flash_attention as fa
    b, s, h, d = bshd
    bhsd = (b, h, s, d)
    out = []
    if s == skv:
        if sa.supported(bhsd, dtype):
            out.append("simple")
        if causal and ca.supported(bhsd, dtype):
            out.append("causal_skip")
        if sa2.supported(bhsd, dtype):
            out.append("qblock")
    if bf.supported(bhsd, skv, dtype, causal):
        out.extend(blocked_name(bq, bkv)
                   for bq, bkv in bf.block_candidates(s, skv))
    if fa.supported_shape(bshd, skv, dtype):
        out.append("library_flash")
    out.append(PLAIN)
    return out


def _time_candidate(name: str, q, k, v, causal, scale, reps: int = 3,
                    windows: int = 5) -> List[float]:
    """Forward+backward seconds per rep in each of ``windows`` windows
    (CUDA events around ``reps`` calls, after one warm-up call); [inf] when
    the candidate's tier has no Hopper kernel. Any other error propagates."""
    run = _resolve(name)

    def fb():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        with torch.enable_grad():
            out = run(*leaves, causal, scale)
            return torch.autograd.grad(out, leaves, torch.ones_like(out))

    try:
        fb()
    except NotImplementedError:
        return [float("inf")]
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fb()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / 1e3 / reps)
    return out


def _ms(t):
    return None if not math.isfinite(t) else round(t * 1e3, 4)


def measure(bshd, skv, dtype, causal, scale=None, device=None) -> str:
    """Benchmark all shape-feasible candidates on random data from a seeded
    generator on ``device`` (the card unless the caller says otherwise),
    record the fastest kernel in the (persisted) table, return its name.
    The entry keeps every candidate's median ms (``timings_ms``, ``xla``
    too) and the spread of its windows (``spread_ms``, max - min)."""
    tab = _load_table()
    key = _key(bshd, skv, dtype, causal)
    hit = lookup(bshd, skv, dtype, causal)   # schema-validated; a
    if hit is not None:                      # wrong-schema entry gets
        return hit                           # re-measured + rewritten
    dev = resolve_device(device)
    b, s, h, d = bshd
    names = candidates(bshd, skv, dtype, causal)
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        gen = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, n, h, d, generator=gen, device=dev)
                   .to(dtype) for n in (s, skv, skv))
        windows = {name: _time_candidate(name, q, k, v, causal, scale)
                   for name in names}
    times = {n: statistics.median(w) for n, w in windows.items()}
    kernels = {n: t for n, t in times.items()
               if n != PLAIN and math.isfinite(t)}
    if not kernels:
        raise NotImplementedError(
            f"autotune: no Hopper kernel takes q {tuple(bshd)}, kv length "
            f"{skv}, {dtype}, causal={causal}")
    winner = min(kernels, key=kernels.get)
    tab[key] = {"winner": winner,
                "timings_ms": {n: _ms(t) for n, t in times.items()},
                "spread_ms": {n: _ms(max(w) - min(w))
                              for n, w in windows.items()}}
    _save_table()
    return winner


def lookup(bshd, skv, dtype, causal) -> Optional[str]:
    ent = _load_table().get(_key(bshd, skv, dtype, causal))
    # schema-validate: a hand-edited or partially merged entry must
    # degrade to the static chain, not crash dispatch; so does a winner
    # that is plain attention rather than a kernel
    if not isinstance(ent, dict) or not isinstance(
            ent.get("winner"), str) or ent["winner"] == PLAIN:
        return None
    return ent["winner"]


def decide(q, k, causal) -> Optional[str]:
    """Dispatch decision for q/k ([B,S,H,D]): with autotune enabled, the
    table's winner. None means "use the static chain": also the escape
    hatch, since disabling the flag bypasses the table entirely."""
    if not get_flag("FLAGS_attn_autotune"):
        return None
    return lookup(tuple(q.shape), k.shape[1], q.dtype, causal)


def run(name: str, q, k, v, causal, scale):
    return _resolve(name)(q, k, v, causal, scale)
