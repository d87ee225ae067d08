"""Decode and serving on the fixed-capacity KV cache: the port of
``paddle_tpu/inference/decode.py``.

Reference roles reproduced (as the JAX package reproduces them):
masked_multihead_attention's single-token decode kernel,
block_multihead_attention's paged-KV serving attention, and the serving
role of AnalysisPredictor.

The cache is the reference's: a dense fixed-capacity ``[B, C, Hkv, D]``
k/v pair per layer plus a per-sequence length counter. Attention masks
the columns at and past each length, so capacity padding never leaks.
Where the reference traces the model into pure functions and donates the
cache buffers to ``jax.jit``, the port runs the Layer eagerly under
``torch.no_grad()`` and writes the new k/v into the preallocated cache
tensors in place (``_write_kv``): nothing of the cache is reallocated per
token, so serving holds one cache. Its semantics are the reference's:

  * the write offset is ``min(max(len, 0), C - s)``, as
    ``lax.dynamic_update_slice`` clamps its start: a write near the
    capacity overwrites the newest slots and never indexes past ``C``;
  * the eager capacity check (``_check_capacity``) runs for eager
    ``cache_attention`` and ``masked_multihead_attention_impl`` calls, and
    is skipped inside a session, where the reference's lengths are tracers;
  * ``_cache_attention`` and ``_sample`` are plain torch, as the reference
    computes them outside any Pallas kernel. Sampling draws from a
    ``torch.Generator`` (jax's PRNG cannot be replayed), so only greedy
    output equals the reference's token for token.

``DecodeSession`` runs one static-shape program per prefill bucket and one
decode step program (or one block program) for every token;
``executable_counts()`` counts the distinct static-shape step programs the
session has run, the quantity the reference's compile caches count.
``ContinuousBatchingSession`` admits requests into the slots of one
[slots, C] cache and retires them mid-flight, with the reference's
admission control, deadlines, cancellation, retry envelope and poison
bisection. Both run on the device of the model's parameters.
"""
from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
import weakref
from typing import List, Optional

import numpy as np
import torch

from .. import _chaos
from ..core import place as place_mod
from ..core.dispatch import run_op
from ..core.flags import define_flag, get_flag
from ..core.generator import generator_for
from ..core.tensor import Tensor
from ..observability import metrics as _met
from ..observability import server as _obs_server
from . import admission as _adm
from .admission import (AdmissionRejected,  # noqa: F401
                        RequestResult, RequestState, ServingStepError)

define_flag("FLAGS_kv_capacity_check", True,
            "eager KV-cache overflow guard in the decode path (one tiny "
            "device sync per eager step; serving sessions skip it)")

# Per-layer fixed-capacity cache. k/v: [B, C, num_kv_heads, head_dim];
# length: [B] int32, the number of valid positions per sequence.
StaticCache = collections.namedtuple("StaticCache", ["k", "v", "length"])


def init_static_cache(batch_size, capacity, num_kv_heads, head_dim,
                      dtype="float32"):
    """Allocate one layer's fixed-capacity KV cache on the default place."""
    _chaos.hit("serving.cache_alloc", batch=batch_size,
               capacity=capacity)
    from ..ops.creation import zeros
    k = zeros([batch_size, capacity, num_kv_heads, head_dim], dtype=dtype)
    v = zeros([batch_size, capacity, num_kv_heads, head_dim], dtype=dtype)
    length = zeros([batch_size], dtype="int32")
    return StaticCache(k, v, length)


def _write_kv(buf, new, lens):
    """Write new [B, s, H, D] into buf [B, C, H, D] in place, sequence i at
    offset min(max(lens[i], 0), C - s): the start that
    ``lax.dynamic_update_slice`` clamps to, so no index passes C."""
    b, s = new.shape[:2]
    start = lens.clamp(0, buf.shape[1] - s).long()
    cols = start[:, None] + torch.arange(s, device=buf.device)[None, :]
    rows = torch.arange(b, device=buf.device)[:, None]
    buf[rows, cols] = new
    return buf


def _cache_attention(q, kn, vn, kbuf, vbuf, lens):
    """Write-then-attend against a fixed-capacity cache.

    q: [B, s, H, D] new queries; kn/vn: [B, s, Hkv, D] new keys/values;
    kbuf/vbuf: [B, C, Hkv, D], written in place; lens: [B] valid lengths
    BEFORE this call. Returns (out [B, s, H, D], lens + s). GQA groups the
    query heads as [b, s, hkv, g, d] (head h reads kv head h // g); the
    cache is never materialized at H heads. f32 logits and softmax, masked
    with -1e30, cast back to q's dtype.
    """
    b, s, h, d = q.shape
    c, hkv = kbuf.shape[1], kbuf.shape[2]
    _write_kv(kbuf, kn.to(kbuf.dtype), lens)
    _write_kv(vbuf, vn.to(vbuf.dtype), lens)
    g = h // hkv
    qg = q.reshape(b, s, hkv, g, d).float()
    logits = torch.einsum("bskgd,bckd->bkgsc", qg,
                          kbuf.float()) * (1.0 / math.sqrt(d))
    col = torch.arange(c, device=q.device)[None, None, None, None, :]
    row = torch.arange(s, device=q.device)[None, None, None, :, None]
    valid = col < (lens[:, None, None, None, None] + row + 1)
    logits = logits.masked_fill(~valid, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgsc,bckd->bskgd", probs, vbuf.float())
    return out.reshape(b, s, h, d).to(q.dtype), lens + s


# Serving sessions run the model with the eager capacity check off, where
# the reference's trace makes it a no-op (its lengths are tracers there).
_serving_state = threading.local()


def _in_session() -> bool:
    return getattr(_serving_state, "depth", 0) > 0


@contextlib.contextmanager
def _session_scope(device):
    """The scope of a session's model run: ``device`` is the default place
    (caches and position tensors land beside the parameters) and
    ``cache_attention`` skips the eager capacity check."""
    _serving_state.depth = getattr(_serving_state, "depth", 0) + 1
    try:
        with place_mod.device_guard(device), torch.no_grad():
            yield
    finally:
        _serving_state.depth -= 1


def _check_capacity(length, s_new, capacity):
    """Eager misuse guard: writing past capacity would clamp (the
    dynamic_update_slice semantics of ``_write_kv``) and overwrite the
    newest cache slot. Costs one tiny device sync per call; disable with
    FLAGS_kv_capacity_check=false when an eager loop is latency-bound and
    externally guarded. Sessions never call it."""
    if not get_flag("FLAGS_kv_capacity_check"):
        return
    arr = length._data if isinstance(length, Tensor) else \
        torch.as_tensor(np.asarray(length))
    top = int(arr.max()) + s_new
    if top > capacity:
        raise ValueError(
            f"KV cache overflow: writing {s_new} token(s) at length "
            f"{top - s_new} exceeds capacity {capacity}")


def cache_attention(q, k_new, v_new, cache: StaticCache):
    """Eager-op wrapper: attend q against (cache ++ new kv), writing the new
    k/v into the cache's tensors in place. Returns (out, new_cache): the
    same k/v tensors and the advanced lengths. Not differentiable (serving
    path)."""
    if not _in_session():
        _check_capacity(cache.length, q.shape[1], cache.k.shape[1])
    out, lens = run_op(
        "masked_cache_attention", _cache_attention, q, k_new, v_new,
        cache.k, cache.v, cache.length, differentiable=False)
    return out, StaticCache(cache.k, cache.v, lens)


def masked_multihead_attention_impl(x, cache_kv, seq_lens, num_heads,
                                    rotary_theta: Optional[float] = None):
    """Reference masked_multihead_attention semantics on the static cache.

    x: [B, 3*H*D] fused qkv for ONE decode step; cache_kv: [2, B, H, C, D]
    (the reference's cache layout), written in place; seq_lens: [B] int32
    lengths before this step. Returns (out [B, H*D], cache_kv).
    """
    _check_capacity(seq_lens, 1, cache_kv.shape[3])

    def f(xa, ck, lens):
        b = xa.shape[0]
        h = num_heads
        d = xa.shape[1] // (3 * h)
        qkv = xa.reshape(b, 3, h, d)
        q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]     # [B, H, D]
        if rotary_theta is not None:
            pos = lens.float()                        # [B]
            inv = 1.0 / (rotary_theta ** (torch.arange(
                0, d, 2, dtype=torch.float32, device=xa.device) / d))
            freqs = pos[:, None] * inv[None, :]       # [B, D/2]
            cos = torch.cos(freqs)[:, None, :]
            sin = torch.sin(freqs)[:, None, :]

            def rot(a):
                a1, a2 = a[..., 0::2], a[..., 1::2]
                o1 = a1 * cos - a2 * sin
                o2 = a2 * cos + a1 * sin
                return torch.stack([o1, o2], -1).reshape(a.shape)
            q, k = rot(q), rot(k)
        # the cache layout [2, B, H, C, D] seen as our [B, C, H, D]: the
        # writes land in ck itself
        out, _ = _cache_attention(q[:, None], k[:, None], v[:, None],
                                  ck[0].transpose(1, 2),
                                  ck[1].transpose(1, 2), lens)
        return out.reshape(b, h * d), ck
    return run_op("masked_multihead_attention", f, x, cache_kv, seq_lens,
                  differentiable=False)


def _sample(logits, gen, temperature, top_p, top_k=None):
    """Sampling on the device: greedy / temperature / top-k / nucleus.
    logits [B, V] -> int32 [B]; draws from ``gen`` (a torch.Generator)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    if top_k is not None and top_k > 0:
        # clamp so over-large configs degrade to no-op filtering; ties at
        # the k-th value are kept
        kth = torch.topk(logits, int(min(top_k, logits.shape[-1])),
                         dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -math.inf)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    if top_p is not None and top_p < 1.0:
        sorted_p = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(sorted_p, dim=-1)
        # smallest set whose mass exceeds top_p: keep p >= threshold
        k = (cum - sorted_p < top_p).sum(dim=-1, keepdim=True)
        thresh = torch.gather(sorted_p, -1, k - 1)
        probs = torch.where(probs >= thresh, probs, 0.0)
        probs = probs / probs.sum(dim=-1, keepdim=True)
    # a categorical draw by the exponential race: argmax p_i / E_i with
    # E_i ~ Exp(1) picks i with probability p_i (no host sync)
    race = torch.empty_like(probs).exponential_(1.0, generator=gen)
    return (probs / race).argmax(dim=-1).to(torch.int32)


def _model_device(model) -> torch.device:
    for p in model.parameters():
        return p._data.device
    return place_mod.default_device()


def _run_model(model, ids, caches):
    """The model's cached forward on torch ids (inside ``_session_scope``):
    (logits as a torch tensor, the new caches)."""
    logits, caches = model.forward_with_cache(Tensor._wrap(ids), caches)
    return logits._data, caches


def _default_buckets(max_length):
    b, out = 16, []
    while b < max_length:
        out.append(b)
        b *= 2
    out.append(max_length)
    return out


class _SessionLifecycle:
    """Shared close()/context-manager/finalizer protocol for serving
    sessions: one refcount on the PADDLE_TPU_METRICS_PORT scrape
    endpoint, taken in __init__ (session_started) and released exactly
    once here — the last session closing shuts the server down and
    frees the port."""

    def close(self):
        """Release session-held resources. Idempotent; also runs via
        the context-manager exit and the finalizer."""
        if getattr(self, "_closed", False):
            return
        self._closed = True
        if getattr(self, "_metrics_server", None) is not None:
            self._metrics_server = None
            _obs_server.session_finished()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DecodeSession(_SessionLifecycle):
    """Serving session over a causal-LM Layer.

    The model must implement ``init_cache(batch_size, max_length=C)`` ->
    list[StaticCache] and ``forward_with_cache(ids, caches)`` ->
    (logits, caches); `LlamaForCausalLM` / `GPTForCausalLM` do.

    One static-shape prefill program per prompt bucket and one decode step
    (or block) program, reused for every token: the cache is allocated once
    per ``generate`` and written in place.
    """

    def __init__(self, model, max_length, prefill_buckets=None,
                 temperature=0.0, top_p=None, top_k=None,
                 eos_token_id=None, decode_block=None):
        model.eval()
        self._model = model
        self._device = _model_device(model)
        self._max_length = int(max_length)
        self._buckets = sorted(prefill_buckets or
                               _default_buckets(self._max_length))
        self._temperature = float(temperature)
        self._top_p = top_p
        self._top_k = top_k
        self._eos = eos_token_id
        self._buckets = [min(b, self._max_length) for b in self._buckets]
        # decode_block > 1: up to decode_block decode steps per block with
        # no host sync inside it; a [B, decode_block] token block comes
        # out of each (the reference's single while_loop program)
        self._decode_block = int(decode_block) if decode_block else None
        # the static shapes of the step programs this session has run
        self._programs = {"prefill": set(), "decode": set(), "block": set()}
        # pull-based scrape endpoint (PADDLE_TPU_METRICS_PORT): hold
        # one ref for this session's lifetime; close() releases it
        self._metrics_server = _obs_server.session_started()
        self._closed = False

    # -- the step programs ----------------------------------------------
    def _sample(self, logits, gen):
        return _sample(logits, gen, self._temperature, self._top_p,
                       self._top_k)

    def _prefill(self, ids, lens, gen, caches):
        self._programs["prefill"].add(tuple(ids.shape))
        logits, caches = _run_model(self._model, ids, caches)
        # last VALID position's logits, per sequence
        b = ids.shape[0]
        last = logits[torch.arange(b, device=ids.device), lens.long() - 1]
        nxt = self._sample(last, gen)
        # prefill wrote the full padded block: reset lengths to the true
        # prompt lengths (padding slots get overwritten by decode steps)
        length = Tensor._wrap(lens)
        return nxt, [StaticCache(c.k, c.v, length) for c in caches]

    def _decode(self, token, gen, caches):
        self._programs["decode"].add(token.shape[0])
        logits, caches = _run_model(self._model, token[:, None], caches)
        return self._sample(logits[:, -1], gen), caches

    def _decode_block_run(self, token, gen, finished, m, caches):
        """Up to ``decode_block`` decode steps with no host sync: ``m``
        steps run (the reference's while_loop also stops once every
        sequence has emitted eos; running on gives the same eos-pinned
        tokens). Returns (block [B, decode_block], token, finished,
        caches)."""
        self._programs["block"].add(token.shape[0])
        eos = self._eos
        fill = eos if eos is not None else 0
        out = torch.full((token.shape[0], self._decode_block), fill,
                         dtype=torch.int32, device=token.device)
        for i in range(m):
            logits, caches = _run_model(self._model, token[:, None], caches)
            nxt = self._sample(logits[:, -1], gen)
            if eos is not None:
                nxt = torch.where(finished, eos, nxt).to(torch.int32)
                finished = finished | (nxt == eos)
            out[:, i] = nxt
            token = nxt
        return out, token, finished, caches

    # -- public API -----------------------------------------------------
    def generate(self, input_ids, max_new_tokens=16, seed=None):
        """Generate tokens; returns [B, prompt + n_generated] ids.

        seed=None (default) draws from the framework's global generator, so
        successive calls produce different samples; pass an int for
        reproducibility. Sequences that emit eos_token_id are pinned to eos
        for the rest of the batch; the loop exits early once every sequence
        has finished (checked every 8 steps, so that the device pipeline is
        not serialized by per-token host syncs)."""
        t0 = time.perf_counter()
        ids = input_ids._data if isinstance(input_ids, Tensor) else \
            torch.as_tensor(np.asarray(input_ids))
        ids = ids.to(self._device, torch.int32)
        b, s = ids.shape
        # every generated token except the last is written into the
        # cache, so occupancy reaches s + max_new_tokens - 1
        if s + max_new_tokens - 1 > self._max_length:
            raise ValueError(
                f"prompt ({s}) + {max_new_tokens} new tokens exceeds the "
                f"cache capacity max_length={self._max_length}")
        bucket = next((k for k in self._buckets if k >= s),
                      self._max_length)
        padded = torch.nn.functional.pad(ids, (0, bucket - s))
        lens = torch.full((b,), s, dtype=torch.int32, device=self._device)
        gen = (generator_for(self._device) if seed is None else
               torch.Generator(device=self._device).manual_seed(int(seed)))
        with _session_scope(self._device):
            caches = self._model.init_cache(b, max_length=self._max_length)
            token, caches = self._prefill(padded, lens, gen, caches)
            finished = (token == self._eos) if self._eos is not None \
                else None
            if self._decode_block:
                gen_ids = self._generate_blocks(token, gen, finished, caches,
                                                b, max_new_tokens - 1)
            else:
                outs = [token]
                for i in range(max_new_tokens - 1):
                    token, caches = self._decode(token, gen, caches)
                    if finished is not None:
                        # pin finished sequences to eos
                        token = torch.where(finished, self._eos,
                                            token).to(torch.int32)
                        finished = finished | (token == self._eos)
                    outs.append(token)
                    # early exit probed only every 8 steps
                    if finished is not None and i % 8 == 7 and \
                            bool(finished.all()):
                        break
                gen_ids = torch.stack(outs, dim=1)
        if _met._ENABLED and gen_ids.is_cuda:
            # close the timing window on completion, not on dispatch
            torch.cuda.synchronize(gen_ids.device)
        self._record_generate(t0, b, s, int(gen_ids.shape[1]))
        return Tensor._wrap(torch.cat([ids, gen_ids], dim=1))

    @staticmethod
    def _record_generate(t0, batch, prompt_len, n_new):
        if not _met._ENABLED:
            return
        dt = time.perf_counter() - t0
        r = _met.REGISTRY
        r.counter("serving.generate_calls").inc()
        r.counter("serving.prefill_tokens").inc(batch * prompt_len)
        r.counter("serving.decode_tokens").inc(batch * n_new)
        r.histogram("serving.generate_latency_s").observe(dt)
        if dt > 0:
            r.gauge("serving.decode_tokens_per_s").set(
                batch * n_new / dt)

    def _generate_blocks(self, token, gen, finished, caches, b, m_total):
        """One block per ``decode_block`` tokens; a finished batch stops
        between blocks and back-fills eos, which matches the per-step
        path's eos pinning token for token."""
        blk = self._decode_block
        if finished is None:
            finished = torch.zeros((b,), dtype=torch.bool,
                                   device=token.device)
        outs = [token[:, None]]
        done = 0
        while done < m_total:
            m = min(blk, m_total - done)
            toks, token, finished, caches = self._decode_block_run(
                token, gen, finished, m, caches)
            outs.append(toks[:, :m])
            done += m
            if self._eos is not None and done < m_total and \
                    bool(finished.all()):
                outs.append(torch.full((b, m_total - done), self._eos,
                                       dtype=torch.int32,
                                       device=token.device))
                break
        return torch.cat(outs, dim=1)

    def executable_counts(self):
        """(n_prefill_programs, n_decode_programs): the distinct static
        shapes of the prefill and decode step programs this session has
        run. The decode count stays 1 however many tokens are generated;
        in block mode the block program is THE decode program."""
        return (len(self._programs["prefill"]),
                len(self._programs["decode"]) + len(self._programs["block"]))


class _Request:
    __slots__ = ("rid", "ids", "plen", "budget", "tokens", "slot",
                 "t_submit", "state", "priority", "deadline",
                 "ttft_deadline", "error")

    def __init__(self, rid, ids, plen, budget, priority=0,
                 deadline_s=None, ttft_deadline_s=None):
        self.rid, self.ids, self.plen = rid, ids, plen
        self.budget = budget
        self.tokens: List[int] = []
        self.slot = None
        self.t_submit = time.perf_counter()
        self.state = RequestState.QUEUED
        self.priority = int(priority)
        # deadlines are absolute perf_counter instants; None = no bound
        self.deadline = (self.t_submit + deadline_s
                         if deadline_s is not None else None)
        self.ttft_deadline = (self.t_submit + ttft_deadline_s
                              if ttft_deadline_s is not None else None)
        self.error = None

    def deadline_hit(self, now):
        """Total deadline always applies; the TTFT deadline only until
        the first token has been DELIVERED (drained to the host)."""
        if self.deadline is not None and now > self.deadline:
            return True
        return (self.ttft_deadline is not None and not self.tokens
                and now > self.ttft_deadline)


class ContinuousBatchingSession(_SessionLifecycle):
    """Continuous batching over the dense fixed-capacity cache: requests
    are admitted into free SLOTS and retired mid-flight while decode
    keeps running for the other slots.

    Reference role: block_multihead_attention's paged KV cache serves
    variable-length multi-request batches with dynamic insertion; here, as
    in the reference, the paged indirection is replaced by the static
    [slots, capacity] cache plus per-slot lengths, and the dynamic part is
    slot management:

      * admit: one program per prompt bucket; a b=1 prefill on the padded
        prompt runs on the slot's rows of the cache (a view, so its writes
        land in the batch cache), then the slot's length is set and the
        first sampled token is deposited into the batched token vector;
      * decode: one program, always the full slot batch; retired or empty
        slots are masked (their length is pinned so their valid region
        never moves, and their token is passed through);
      * retire: host-side; eos or budget exhaustion frees the slot, and the
        next queued request is admitted into it on the next step.

    The program count is bounded by 1 + #prefill_buckets however many
    requests flow through. Sampling uses one torch.Generator; with
    temperature=0 (default) outputs equal isolated DecodeSession runs.
    """

    def __init__(self, model, max_slots, max_length,
                 prefill_buckets=None, temperature=0.0, top_p=None,
                 top_k=None, eos_token_id=None, seed=0,
                 sync_every=1, decode_block=None,
                 max_queue=None, shed_policy="reject_newest",
                 default_deadline_s=None, default_ttft_s=None,
                 step_retries=2, step_backoff_s=0.02,
                 degraded_queue_frac=0.8):
        model.eval()
        self._model = model
        self._device = _model_device(model)
        self._slots = int(max_slots)
        self._max_length = int(max_length)
        self._buckets = sorted(
            min(b, self._max_length)
            for b in (prefill_buckets
                      or _default_buckets(self._max_length)))
        self._temperature = float(temperature)
        self._top_p = top_p
        self._top_k = top_k
        self._eos = eos_token_id

        with _session_scope(self._device):
            self._caches = model.init_cache(self._slots,
                                            max_length=self._max_length)
        self._tokens = torch.zeros((self._slots,), dtype=torch.int32,
                                   device=self._device)
        self._gen = torch.Generator(device=self._device).manual_seed(
            int(seed))
        # the static shapes of the admit and decode programs run so far
        self._programs = {"admit": set(), "decode": set()}

        self._free = list(range(self._slots))
        self._queue: collections.deque = collections.deque()
        self._running: dict = {}          # slot -> _Request
        self._done: dict = {}             # rid -> _Request (undelivered)
        self._next_rid = 0
        self._used_rids: set = set()
        # sync_every=k batches the host-side retirement check: token
        # vectors stay on the device for k decode steps and are fetched
        # in one drain. Retirement then lags up to k-1 steps (the freed
        # slot's extra decodes are discarded; its cache is reset by the
        # next admission), trading a little wasted compute for fewer
        # host syncs.
        self._sync_every = max(1, int(sync_every))
        self._pending: List = []
        self._t_last_drain = None
        # decode_block=k runs k decode steps per dispatch and emits a
        # [slots, k] token block. sync_every counts DISPATCHES in either
        # mode, so block mode drains every sync_every blocks.
        self._decode_block = int(decode_block) if decode_block else None
        # robustness knobs: bounded-queue admission control with a
        # pluggable shedding policy, per-request deadline defaults, and
        # the device-step retry envelope
        self._admission = _adm.AdmissionController(
            max_queue=max_queue, policy=shed_policy,
            degraded_queue_frac=degraded_queue_frac)
        self._default_deadline_s = default_deadline_s
        self._default_ttft_s = default_ttft_s
        self._step_retries = max(0, int(step_retries))
        self._step_backoff_s = float(step_backoff_s)
        # readiness: /healthz flips to 503 `degraded` while this session
        # reports queue/slot pressure. Registered through a weakref so
        # the module-global provider list never pins an abandoned
        # session alive.
        wself = weakref.ref(self)

        def _provider():
            s = wself()
            return s._health_report() if s is not None else None
        self._health_unreg = _obs_server.register_health_provider(
            _provider)
        # pull-based scrape endpoint (PADDLE_TPU_METRICS_PORT): hold
        # one ref for this session's lifetime; close() releases it
        self._metrics_server = _obs_server.session_started()
        self._closed = False

    # ---------------- the step programs --------------------------------
    def _sample(self, logits):
        return _sample(logits, self._gen, self._temperature, self._top_p,
                       self._top_k)

    def _admit(self, ids, plen, slot):
        """Prefill ``ids`` [1, bucket] into ``slot``: returns the new token
        vector and caches (the k/v written in place, the slot's length set
        to ``plen``)."""
        self._programs["admit"].add(ids.shape[1])
        fresh = Tensor._wrap(torch.zeros((1,), dtype=torch.int32,
                                         device=self._device))
        rows = [StaticCache(Tensor._wrap(c.k._data[slot:slot + 1]),
                            Tensor._wrap(c.v._data[slot:slot + 1]), fresh)
                for c in self._caches]
        with _session_scope(self._device):
            logits, _ = _run_model(self._model, ids, rows)
            nxt = self._sample(logits[0, plen - 1][None])
        tokens = self._tokens.clone()
        tokens[slot] = nxt[0]
        caches = []
        for c in self._caches:
            length = c.length._data.clone()
            length[slot] = plen
            caches.append(StaticCache(c.k, c.v, Tensor._wrap(length)))
        return tokens, caches

    def _masked_step(self, tok, active, caches):
        """ONE masked decode step, shared by the per-step and block modes:
        inactive slots pass their token through and keep their cache
        length pinned (the k/v the step wrote at that position are dead:
        the next admission's prefill, or the slot's own next step,
        overwrites them before they are read)."""
        with _session_scope(self._device):
            logits, new = _run_model(self._model, tok[:, None], caches)
            nxt = torch.where(active, self._sample(logits[:, -1]), tok)
        fixed = [StaticCache(n.k, n.v, Tensor._wrap(torch.where(
                     active, n.length._data, o.length._data)))
                 for n, o in zip(new, caches)]
        return nxt, fixed

    def _decode(self, active):
        self._programs["decode"].add("step")
        return self._masked_step(self._tokens, active, self._caches)

    def _decode_blocks(self, active):
        """``decode_block`` masked steps: ([slots, k] block, tokens,
        caches)."""
        self._programs["decode"].add("block")
        tok, caches = self._tokens, self._caches
        cols = []
        for _ in range(self._decode_block):
            tok, caches = self._masked_step(tok, active, caches)
            cols.append(tok)
        return torch.stack(cols, dim=1), tok, caches

    # ---------------- host-side slot management ----------------------
    def submit(self, input_ids, max_new_tokens, request_id=None,
               priority=0, deadline_s=None, ttft_deadline_s=None):
        """Queue one request (1D token list/array). Returns its id.

        deadline_s / ttft_deadline_s bound the request's TOTAL and
        time-to-first-token wall time (defaults from the session);
        expiry evicts the request with state TIMED_OUT. With a bounded
        queue (``max_queue``) an overloaded session sheds load: the
        configured policy either raises :class:`AdmissionRejected` here
        or, under the ``priority`` policy, evicts a lower-priority queued
        request (delivered as REJECTED)."""
        ids = np.asarray(
            input_ids.numpy() if isinstance(input_ids, Tensor)
            else input_ids).reshape(-1).astype(np.int32)
        if ids.size + max_new_tokens - 1 > self._max_length:
            raise ValueError(
                f"prompt ({ids.size}) + {max_new_tokens} new tokens "
                f"exceeds the cache capacity {self._max_length}")
        if request_id is not None:
            if request_id in self._used_rids:
                raise ValueError(
                    f"request_id {request_id!r} is already in use")
            rid = request_id
        else:
            while self._next_rid in self._used_rids:
                self._next_rid += 1
            rid = self._next_rid
            self._next_rid += 1
        req = _Request(
            rid, ids, ids.size, max_new_tokens, priority=priority,
            deadline_s=(deadline_s if deadline_s is not None
                        else self._default_deadline_s),
            ttft_deadline_s=(ttft_deadline_s if ttft_deadline_s
                             is not None else self._default_ttft_s))
        try:
            victim = self._admission.admit(self._queue, req,
                                           free_slots=len(self._free))
        except AdmissionRejected:
            # shed-not-collapse: the rejection is the fast path; no rid
            # is consumed, nothing is retained
            if _met._ENABLED:
                _met.REGISTRY.counter("serving.rejected").inc()
            raise
        self._used_rids.add(rid)
        if victim is not None:
            self._finish(victim, RequestState.REJECTED)
        self._queue.append(req)
        if _met._ENABLED:
            r = _met.REGISTRY
            r.counter("serving.requests_submitted").inc()
            r.gauge("serving.queue_depth").set(len(self._queue))
            r.gauge("serving.inflight_requests").set(
                len(self._used_rids))
        return rid

    def cancel(self, request_id):
        """Cancel a queued or running request: it transitions to
        CANCELLED, its slot (if any) is freed for the next admission,
        and its partial output is delivered with the next drain.
        Returns True if the request was found in a non-terminal state."""
        for req in self._queue:
            if req.rid == request_id:
                self._queue.remove(req)
                self._finish(req, RequestState.CANCELLED)
                return True
        for req in list(self._running.values()):
            if req.rid == request_id:
                self._finish(req, RequestState.CANCELLED)
                return True
        return False

    def status(self, request_id):
        """RequestState of an in-flight or undelivered request; None
        for unknown (or already-delivered) ids."""
        for req in self._queue:
            if req.rid == request_id:
                return req.state
        for req in self._running.values():
            if req.rid == request_id:
                return req.state
        req = self._done.get(request_id)
        return req.state if req is not None else None

    # -------- lifecycle internals (state machine + recovery) ---------
    def _finish(self, req, state, error=None):
        """The single terminal transition: free the slot, record the
        state, park the request for delivery, tick the outcome counter.
        Every exit path (retire, timeout, cancel, shed, quarantine)
        funnels through here."""
        if req.slot is not None:
            self._running.pop(req.slot, None)
            self._free.append(req.slot)
            req.slot = None
        req.state = state
        req.error = error
        self._done[req.rid] = req
        if _met._ENABLED:
            r = _met.REGISTRY
            if state is RequestState.DONE:
                r.counter("serving.requests_completed").inc()
                r.histogram("serving.request_latency_s").observe(
                    time.perf_counter() - req.t_submit)
            elif state is RequestState.TIMED_OUT:
                r.counter("serving.timed_out").inc()
            elif state is RequestState.CANCELLED:
                r.counter("serving.cancelled").inc()
            elif state is RequestState.REJECTED:
                r.counter("serving.rejected").inc()
            elif state is RequestState.FAILED:
                r.counter("serving.quarantined").inc()

    def _expire_deadlines(self):
        """Evict deadline-exceeded requests (queued and running): runs at
        the top of every step, so expiry is honored within one step of
        the deadline instant."""
        if not (self._queue or self._running):
            return
        now = time.perf_counter()
        for req in [r for r in self._queue if r.deadline_hit(now)]:
            self._queue.remove(req)
            self._finish(req, RequestState.TIMED_OUT)
        for req in list(self._running.values()):
            if req.deadline_hit(now):
                self._finish(req, RequestState.TIMED_OUT)

    def _health_report(self):
        """Readiness provider for the /healthz endpoint: a non-empty
        reason list means degraded (503)."""
        if getattr(self, "_closed", False):
            return None
        return self._admission.degraded_reasons(
            len(self._queue), len(self._free))

    def _device_call(self, site, ctx, fn, retries=None):
        """Retry-with-backoff envelope around one device step. The chaos
        hook sits INSIDE the try so injected faults exercise the same
        recovery as real ones. Retrying is safe: a step commits the
        session's tokens and lengths only when it returns, and a retried
        step rewrites the same cache positions."""
        retries = self._step_retries if retries is None else retries
        delay = self._step_backoff_s
        attempt = 0
        while True:
            try:
                _chaos.hit(site, **ctx)
                return fn()
            except Exception:
                if attempt >= retries:
                    raise
                attempt += 1
                if _met._ENABLED:
                    _met.REGISTRY.counter("serving.step_retries").inc()
                if delay > 0:
                    time.sleep(delay)
                    delay *= 2

    def _dispatch_once(self, slots, retries=None):
        """One decode dispatch for the given active-slot subset; on
        success the sampled tokens are committed to pending tagged
        with exactly that subset (drains credit only those slots)."""
        mask = np.zeros((self._slots,), bool)
        mask[list(slots)] = True
        active = torch.from_numpy(mask).to(self._device)

        def call():
            if self._decode_block:
                return self._decode_blocks(active)
            return self._decode(active)

        out = self._device_call("serving.decode_step",
                                {"slots": slots}, call, retries)
        if self._decode_block:
            blk_out, self._tokens, self._caches = out
            self._pending.append(("block", slots, blk_out))
        else:
            self._tokens, self._caches = out
            self._pending.append(("step", slots, self._tokens))

    def _probe_slots(self, subset):
        """Single-attempt step over a slot subset. A SUCCESSFUL probe
        is a real step (its tokens are committed and delivered), so
        bisection never wastes device work or skips tokens. Returns
        True when the subset still fails."""
        try:
            self._dispatch_once(tuple(subset), retries=0)
            return False
        except Exception:
            return True

    def _bisect_poison(self, slots, exc):
        """Find the single poison slot by probing halves. Returns the
        slot, or None when every probe succeeded (the fault cleared).
        Raises ServingStepError when DISJOINT subsets fail: that is a
        step-wide fault, not a poison request."""
        while len(slots) > 1:
            mid = len(slots) // 2
            left, right = slots[:mid], slots[mid:]
            lf = self._probe_slots(left)
            rf = self._probe_slots(right)
            if lf and rf:
                raise ServingStepError(
                    "decode step fails for disjoint slot subsets "
                    f"{tuple(left)} and {tuple(right)} — failure is "
                    "step-wide, not attributable to one poison "
                    "request") from exc
            if lf:
                slots = left
            elif rf:
                slots = right
            else:
                return None
        return slots[0]

    def _recover_decode(self, slots, exc):
        """Persistent step failure (retry budget exhausted): isolate the
        poison request by bisection and fail ONLY it; the session and
        every other in-flight request stay alive."""
        if len(slots) == 1:
            poison = slots[0]
        else:
            poison = self._bisect_poison(list(slots), exc)
            if poison is None:
                return
        req = self._running.get(poison)
        if req is not None:
            self._finish(req, RequestState.FAILED,
                         error=f"{type(exc).__name__}: {exc}")

    def _admit_ready(self):
        t_admit = time.perf_counter()
        while self._free and self._queue:
            req = self._queue.popleft()
            slot = self._free.pop()
            req.state = RequestState.PREFILLING
            bucket = next((b for b in self._buckets
                           if b >= req.plen), self._max_length)
            padded = torch.from_numpy(
                np.pad(req.ids, (0, bucket - req.plen))[None]).to(
                self._device)

            def call():
                return self._admit(padded, req.plen, slot)

            try:
                self._tokens, self._caches = self._device_call(
                    "serving.admit_step", {"rid": req.rid, "slot": slot},
                    call)
            except Exception as e:  # noqa: BLE001
                # the failing request is identified directly here (the
                # admit is b=1): quarantine it, keep admitting others
                self._free.append(slot)
                self._finish(req, RequestState.FAILED,
                             error=f"{type(e).__name__}: {e}")
                continue
            req.slot = slot
            req.state = RequestState.DECODING
            self._running[slot] = req
            if _met._ENABLED:
                r = _met.REGISTRY
                r.counter("serving.admits").inc()
                r.counter("serving.prefill_tokens").inc(req.plen)
                dt = time.perf_counter() - t_admit
                if dt > 0:
                    # dispatch-side rate: the prefill runs asynchronously
                    # on the card, so this tracks admission throughput
                    r.gauge("serving.prefill_tokens_per_s").set(
                        req.plen / dt)
                t_admit = time.perf_counter()
            # the admit's sampled token is the request's first output; it
            # stays on the device and is fetched with the next drain. The
            # tagged entry applies to THIS slot only.
            self._pending.append(("admit", slot, self._tokens))

    def _maybe_retire(self, req):
        if (len(req.tokens) >= req.budget
                or (self._eos is not None
                    and req.tokens
                    and req.tokens[-1] == self._eos)):
            self._finish(req, RequestState.DONE)

    def _deliver(self, req, token, now):
        if not req.tokens and _met._ENABLED:
            _met.REGISTRY.histogram("serving.time_to_first_token_s").observe(
                now - req.t_submit)
        req.tokens.append(token)
        self._maybe_retire(req)

    def _drain_pending(self):
        if not self._pending:
            return
        entries = self._pending
        self._pending = []
        _chaos.hit("serving.drain", n=len(entries))
        fetched = [t.cpu().numpy() for (_k, _s, t) in entries]
        now = time.perf_counter()
        delivered = 0
        for (kind, ainfo, _t), row in zip(entries, fetched):
            # ainfo: the admitted slot ("admit") or the tuple of slots
            # active AT DISPATCH ("step"/"block"); slots evicted between
            # dispatch and drain are skipped
            if kind == "admit":
                req = self._running.get(ainfo)
                if req is not None:
                    self._deliver(req, int(row[ainfo]), now)
                    delivered += 1
                continue
            cols = [row[:, c] for c in range(row.shape[1])] \
                if kind == "block" else [row]
            for col in cols:
                for slot in ainfo:
                    req = self._running.get(slot)
                    if req is not None:
                        self._deliver(req, int(col[slot]), now)
                        delivered += 1
        if _met._ENABLED and delivered:
            r = _met.REGISTRY
            r.counter("serving.decode_tokens").inc(delivered)
            if self._t_last_drain is not None and now > self._t_last_drain:
                r.gauge("serving.decode_tokens_per_s").set(
                    delivered / (now - self._t_last_drain))
            self._t_last_drain = now

    def step(self):
        """Expire deadlines, admit whatever fits (on sync boundaries),
        run ONE batched decode step under the retry/recovery envelope,
        and, every `sync_every` steps, fetch the pending tokens and
        retire finished requests. Returns the list of request ids that
        reached a terminal state during this step."""
        before = set(self._done)
        self._expire_deadlines()
        if not self._pending:
            self._admit_ready()
        if _met._ENABLED:
            r = _met.REGISTRY
            r.counter("serving.steps").inc()
            r.gauge("serving.queue_depth").set(len(self._queue))
            r.gauge("serving.slots_active").set(len(self._running))
            r.gauge("serving.slot_utilization").set(
                len(self._running) / self._slots)
            r.gauge("serving.degraded").set(
                1.0 if self._health_report() else 0.0)
        if self._running:
            slots = tuple(sorted(self._running))
            try:
                self._dispatch_once(slots)
            except ServingStepError:
                raise
            except Exception as e:  # noqa: BLE001
                self._recover_decode(slots, e)
        if len(self._pending) >= self._sync_every or (
                self._pending and not self._running):
            # the second arm flushes a PARTIAL sync window when no slot
            # is decoding anymore (every running request was cancelled,
            # timed out or quarantined mid-window): admission waits for
            # an empty pending list, so waiting out the quantum would
            # deadlock step()/results() with work still queued
            self._drain_pending()
        return [r for r in self._done if r not in before]

    def results(self):
        """Drive the session until every submitted request reaches a
        terminal state, then deliver {rid: RequestResult}: terminal
        state, prompt + generated ids (partial for TIMED_OUT /
        CANCELLED / FAILED), and the error string for FAILED.
        Delivered results are released exactly like :meth:`run`."""
        while self._queue or self._running or self._pending:
            self.step()
        out = {rid: RequestResult(
                   req.state,
                   np.concatenate([req.ids,
                                   np.asarray(req.tokens, np.int32)]),
                   req.error)
               for rid, req in self._done.items()}
        self._done = {}
        # delivered ids leave the in-flight set: a serving loop calling
        # submit()/run() forever must not accumulate every rid ever seen
        self._used_rids.difference_update(out)
        if _met._ENABLED:
            _met.REGISTRY.gauge("serving.inflight_requests").set(
                len(self._used_rids))
        return out

    def run(self):
        """Drain queue + running slots; returns {rid: full token ids}
        (prompt + generated, eos included when emitted) for requests
        completed by THIS drain (or still undelivered from step()
        calls). Requests that ended TIMED_OUT / CANCELLED / FAILED /
        REJECTED deliver their partial ids here; use :meth:`results`
        for the terminal states. Delivered results are released: a
        later run() never re-delivers them and their request_ids become
        reusable."""
        return {rid: res.ids for rid, res in self.results().items()}

    def close(self):
        """Cancel in-flight work, then release shared resources.
        Queued and running requests transition to CANCELLED (their
        pending tokens are dropped, so close never waits on the device),
        undelivered results are discarded, and ``_used_rids`` ends
        empty. Idempotent; also runs via the context-manager exit and
        the finalizer."""
        if getattr(self, "_closed", False):
            return
        for req in list(getattr(self, "_queue", ())):
            self._finish(req, RequestState.CANCELLED)
        if getattr(self, "_queue", None) is not None:
            self._queue.clear()
        for req in list(getattr(self, "_running", {}).values()):
            self._finish(req, RequestState.CANCELLED)
        self._pending = []
        self._done = {}
        if getattr(self, "_used_rids", None) is not None:
            self._used_rids.clear()
        if getattr(self, "_health_unreg", None) is not None:
            self._health_unreg()
            self._health_unreg = None
        super().close()

    def executable_counts(self):
        """(n_admit_programs, n_decode_programs): admit is bounded by the
        bucket count, decode stays 1 however many requests flow through
        (in block mode the block program is THE decode program)."""
        return (len(self._programs["admit"]),
                len(self._programs["decode"]))


def cached_generate(model, input_ids, max_new_tokens=16, temperature=0.0,
                    top_p=None, seed=None, max_length=None, seq_ceiling=None,
                    hard_limit=False, decode_block=None):
    """Shared model.generate() implementation: pick a cache capacity
    (next power of two covering prompt+new, floored at 64), cache one
    DecodeSession per (capacity, sampling config) on the model, and
    generate.

    seq_ceiling: the model's positional limit. With hard_limit=True
    (learned position tables: GPT's wpe) requests past the ceiling
    raise; with hard_limit=False (RoPE: llama) the ceiling is only a
    sizing hint and longer requests are allowed.
    """
    need = input_ids.shape[1] + max_new_tokens
    if hard_limit and seq_ceiling is not None and need > seq_ceiling:
        raise ValueError(
            f"prompt + max_new_tokens = {need} exceeds the model's "
            f"positional table ({seq_ceiling})")
    ceil_eff = seq_ceiling if (hard_limit and seq_ceiling) else \
        max(seq_ceiling or 0, need)
    cap = max_length or min(max(64, 1 << (need - 1).bit_length()),
                            ceil_eff)
    key = (cap, float(temperature), top_p, decode_block)
    sessions = model.__dict__.setdefault("_decode_sessions", {})
    if key not in sessions:
        sessions[key] = DecodeSession(model, cap, temperature=temperature,
                                      top_p=top_p,
                                      decode_block=decode_block)
    return sessions[key].generate(input_ids, max_new_tokens, seed=seed)
