"""The serving slice on the CPU: the port's ``inference/decode.py``,
``models/llama.py`` and the GPT's cache path against the reference's.

The same inputs, made from a seed with numpy, go through the reference's
function and the port's, all in f32:

- ``_cache_attention`` and ``_write_kv`` at GQA, s = 1 and s = 5, including
  the writes that clamp at len = C - 1 and len = C, within 1e-6 of scale
  (the written caches exactly);
- RoPE with an int and with a [B] offset, and the masked MHA
  (``masked_multihead_attention_impl``), within 1e-6 of scale;
- tiny Llama (GQA) and tiny GPT loaded from the reference's ``state_dict``:
  the full forward's logits within 1e-5 of scale, and the greedy token ids
  of ``generate``, ``DecodeSession`` and ``ContinuousBatchingSession``
  equal to the reference's.

Sampling cannot replay jax's PRNG, so ``_sample`` is held to its own
claims: determinism under one seed, the top-k and top-p supports, and the
moments of a temperature-1 draw.
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest keeps it on the CPU)
import jax.numpy as jnp

import paddle_tpu as P
from paddle_tpu.inference import decode as jdec
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
from paddle_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import \
    apply_rotary_pos_emb as jax_rope
import paddle_tpu_torch as T
from paddle_tpu_torch.inference import decode as tdec
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           apply_rotary_pos_emb)
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(*shape, seed=0):
    return _rs(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------- cache primitives
C = 16


@pytest.mark.parametrize("s,lens", [
    (1, (3, 9)), (5, (0, 7)),
    (1, (C - 1, C)),          # clamped: the write at C lands on C - 1
    (5, (C - 1, C)),          # clamped to C - 5 for both
])
def test_cache_attention_and_write_kv_match_the_reference(s, lens):
    b, h, hkv, d = 2, 4, 2, 8
    q = _f32(b, s, h, d, seed=1)
    kn, vn = _f32(b, s, hkv, d, seed=2), _f32(b, s, hkv, d, seed=3)
    kbuf, vbuf = _f32(b, C, hkv, d, seed=4), _f32(b, C, hkv, d, seed=5)
    lens = np.asarray(lens, np.int32)
    want = jdec._cache_attention(*map(jnp.asarray, (q, kn, vn, kbuf, vbuf,
                                                   lens)))
    tk, tv = torch.from_numpy(kbuf.copy()), torch.from_numpy(vbuf.copy())
    out, new_lens = tdec._cache_attention(
        *map(torch.from_numpy, (q, kn, vn)), tk, tv, torch.from_numpy(lens))
    assert _rel(out.numpy(), want[0]) <= 1e-6
    # the writes: in place, equal to the reference's dynamic_update_slice
    np.testing.assert_array_equal(tk.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(new_lens.numpy(), np.asarray(want[3]))
    assert new_lens.dtype == torch.int32


def test_write_kv_clamps_its_start_as_dynamic_update_slice():
    buf = torch.zeros(3, C, 1, 1)
    new = torch.arange(1, 7, dtype=torch.float32).reshape(3, 2, 1, 1)
    tdec._write_kv(buf, new, torch.tensor([C - 1, C, -3], dtype=torch.int32))
    got = buf[..., 0, 0]
    assert got[0, C - 2:].tolist() == [1.0, 2.0]      # start C - 2, not C - 1
    assert got[1, C - 2:].tolist() == [3.0, 4.0]
    assert got[2, :2].tolist() == [5.0, 6.0]          # negative starts at 0
    assert int((got != 0).sum()) == 6


@pytest.mark.parametrize("offset", ["int", "lengths"])
def test_rope_matches_the_reference(offset):
    x = _f32(2, 5, 4, 8, seed=6)
    off = 7 if offset == "int" else np.asarray([3, 11], np.int32)
    want = jax_rope(P.to_tensor(x), off if offset == "int"
                    else P.to_tensor(off), 10000.0).numpy()
    got = apply_rotary_pos_emb(T.to_tensor(x), off if offset == "int"
                               else T.to_tensor(off), 10000.0).numpy()
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("rotary", [None, 10000.0])
def test_masked_multihead_attention_impl_matches_the_reference(rotary):
    b, h, d = 2, 4, 8
    x = _f32(b, 3 * h * d, seed=7)
    cache = _f32(2, b, h, C, d, seed=8)
    lens = np.asarray([5, 12], np.int32)
    want_out, want_cache = jdec.masked_multihead_attention_impl(
        P.to_tensor(x), P.to_tensor(cache), P.to_tensor(lens), h,
        rotary_theta=rotary)
    t_cache = T.to_tensor(cache)
    got_out, got_cache = tdec.masked_multihead_attention_impl(
        T.to_tensor(x), t_cache, T.to_tensor(lens), h, rotary_theta=rotary)
    assert _rel(got_out.numpy(), want_out.numpy()) <= 1e-6
    assert _rel(got_cache.numpy(), want_cache.numpy()) <= 1e-6
    assert got_cache._data is t_cache._data        # written in place


def test_cache_overflow_raises_eagerly():
    """test_decode.py::test_cache_overflow_raises_eagerly, without jnp: the
    eager check refuses a write at the capacity."""
    cache = tdec.init_static_cache(1, 4, 2, 8)
    cache = cache._replace(length=T.to_tensor(np.array([4], np.int32)))
    q = T.randn([1, 1, 2, 8])
    with pytest.raises(ValueError, match="overflow"):
        tdec.cache_attention(q, q, q, cache)


def test_sessions_do_not_call_the_capacity_check(monkeypatch):
    """The reference's check is a no-op under a trace; the port's sessions
    run the Layer eagerly and never call it (it would sync the host once a
    layer a token), while eager cache_attention still does."""
    calls = []
    monkeypatch.setattr(tdec, "_check_capacity",
                        lambda *a: calls.append(a))
    T.seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny())
    ids = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    tdec.DecodeSession(m, 32).generate(ids, max_new_tokens=4)
    sess = tdec.ContinuousBatchingSession(m, max_slots=2, max_length=32)
    sess.submit(ids[0], 3)
    sess.run()
    assert calls == []
    with T.no_grad():
        m.forward_with_cache(T.to_tensor(ids), m.init_cache(1, 32))
    assert len(calls) == LlamaConfig.tiny().num_layers


def test_decode_writes_into_one_preallocated_cache():
    """Every step writes k/v into the tensors that init_cache allocated:
    the cache is never reallocated during generation."""
    T.seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny())
    seen = []
    real = m.forward_with_cache

    def spy(ids, caches):
        seen.append({c.k._data.data_ptr() for c in caches}
                    | {c.v._data.data_ptr() for c in caches})
        return real(ids, caches)
    m.forward_with_cache = spy
    tdec.DecodeSession(m, 32).generate(np.ones((2, 5), np.int32),
                                       max_new_tokens=6)
    assert len(seen) == 6 and all(s == seen[0] for s in seen)
    assert len(seen[0]) == 2 * LlamaConfig.tiny().num_layers


# ------------------------------------------------------------- sampling
def _logits(b=4, v=50, seed=9):
    return torch.from_numpy(_f32(b, v, seed=seed) * 2.0)


def test_sample_is_deterministic_under_a_seed():
    lg = _logits()
    draw = [tdec._sample(lg, torch.Generator().manual_seed(s), 0.9, 0.8, 7)
            for s in (5, 5, 6)]
    assert torch.equal(draw[0], draw[1]) and draw[0].dtype == torch.int32
    many = [tdec._sample(lg, torch.Generator().manual_seed(s), 1.0, None)
            for s in range(8)]
    assert len({tuple(d.tolist()) for d in many}) > 1
    assert torch.equal(tdec._sample(lg, None, 0.0, None),
                       lg.argmax(-1).to(torch.int32))


def test_sample_top_k_keeps_ties_and_clamps_to_the_vocab():
    lg = _logits(b=2, v=10)
    lg[0, :3] = 5.0                     # a three-way tie at the top
    gen = torch.Generator().manual_seed(0)
    picks = torch.stack([tdec._sample(lg, gen, 1.0, None, top_k=2)
                         for _ in range(300)])
    assert set(picks[:, 0].tolist()) == {0, 1, 2}   # ties kept
    top2 = set(torch.topk(lg[1], 2).indices.tolist())
    assert set(picks[:, 1].tolist()) <= top2
    big = tdec._sample(lg, gen, 1.0, None, top_k=10 ** 6)
    assert big.shape == (2,)


def test_sample_top_p_support_is_the_references_threshold():
    probs = np.asarray([0.5, 0.3, 0.15, 0.05], np.float64)
    lg = torch.from_numpy(np.log(probs).astype(np.float32))[None]
    gen = torch.Generator().manual_seed(1)
    # cum - p < 0.7 holds for the first two: keep {0, 1}
    picks = {int(tdec._sample(lg, gen, 1.0, 0.7)[0]) for _ in range(300)}
    assert picks == {0, 1}
    picks = {int(tdec._sample(lg, gen, 1.0, 0.81)[0]) for _ in range(300)}
    assert picks == {0, 1, 2}


def test_sample_moments_at_temperature_one():
    """Counts of 40000 draws against softmax(logits): every frequency
    within 4.5 binomial standard deviations, and the mean index within 4.5
    standard errors."""
    n = 40000
    lg = _logits(b=1, v=12, seed=10)
    p = torch.softmax(lg[0].double(), -1).numpy()
    draws = tdec._sample(lg.expand(n, -1).contiguous(),
                         torch.Generator().manual_seed(3), 1.0, None)
    freq = np.bincount(draws.numpy(), minlength=12) / n
    sd = np.sqrt(p * (1 - p) / n)
    assert (np.abs(freq - p) <= 4.5 * sd + 1e-12).all()
    idx = np.arange(12)
    mean, var = (p * idx).sum(), (p * idx ** 2).sum() - (p * idx).sum() ** 2
    assert abs(draws.double().mean().item() - mean) <= 4.5 * np.sqrt(var / n)


# --------------------------------------------------- models and sessions
def _llama_pair(seed=0):
    P.seed(seed)
    ref = JaxLlama(JaxLlamaConfig.tiny())
    port = LlamaForCausalLM(LlamaConfig.tiny())
    missing, unexpected = port.set_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    assert not missing and not unexpected
    return ref, port


def _gpt_pair(seed=0):
    P.seed(seed)
    ref = JaxGPT(JaxGPTConfig.tiny())
    port = GPTForCausalLM(GPTConfig.tiny())
    missing, unexpected = port.set_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    assert not missing and not unexpected
    return ref, port


@pytest.fixture(scope="module")
def llama_pair():
    T.set_device("cpu")
    return _llama_pair()


@pytest.fixture(scope="module")
def gpt_pair():
    T.set_device("cpu")
    return _gpt_pair()


def _ids(b, s, seed):
    return _rs(seed).randint(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_full_forward_logits_match_the_reference(model, llama_pair,
                                                 gpt_pair):
    ref, port = llama_pair if model == "llama" else gpt_pair
    ref.eval()
    port.eval()
    ids = _ids(2, 24, seed=11)
    want = ref(P.to_tensor(ids)).numpy()
    got = port(T.to_tensor(ids)).numpy()
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_cached_forward_matches_the_reference(model, llama_pair, gpt_pair):
    """The static-cache forward (prefill of 9, then one token) against the
    reference's: logits within 1e-5 of scale, the caches' k/v too."""
    ref, port = llama_pair if model == "llama" else gpt_pair
    ids, nxt = _ids(2, 9, seed=12), _ids(2, 1, seed=13)
    out = {}
    for pkg, m in ((P, ref), (T, port)):
        with pkg.no_grad():
            caches = m.init_cache(2, max_length=16)
            l1, caches = m.forward_with_cache(pkg.to_tensor(ids), caches)
            l2, caches = m.forward_with_cache(pkg.to_tensor(nxt), caches)
        out[pkg] = (l1.numpy(), l2.numpy(), caches[-1].k.numpy(),
                    caches[-1].length.numpy())
    for got, want in zip(out[T][:3], out[P][:3]):
        assert _rel(got, want) <= 1e-5
    np.testing.assert_array_equal(out[T][3], out[P][3])


@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_greedy_generate_equals_the_reference(model, llama_pair, gpt_pair):
    ref, port = llama_pair if model == "llama" else gpt_pair
    ids = _ids(2, 7, seed=14)
    want = ref.generate(P.to_tensor(ids), max_new_tokens=9).numpy()
    got = port.generate(T.to_tensor(ids), max_new_tokens=9).numpy()
    np.testing.assert_array_equal(got, want)
    blk = port.generate(T.to_tensor(ids), max_new_tokens=9,
                        decode_block=4).numpy()
    np.testing.assert_array_equal(blk, want)


def test_decode_session_with_eos_equals_the_reference(llama_pair):
    ref, port = llama_pair
    ids = _ids(2, 6, seed=15)
    probe = jdec.DecodeSession(ref, 32).generate(
        P.to_tensor(ids), max_new_tokens=6).numpy()
    eos = int(probe[0, 8])
    want = jdec.DecodeSession(ref, 32, eos_token_id=eos).generate(
        P.to_tensor(ids), max_new_tokens=12).numpy()
    for block in (None, 4):
        got = tdec.DecodeSession(port, 32, eos_token_id=eos,
                                 decode_block=block).generate(
            T.to_tensor(ids), max_new_tokens=12).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("model", ["llama", "gpt"])
def test_continuous_batching_equals_the_reference(model, llama_pair,
                                                  gpt_pair):
    """Five requests with overlapping lifetimes through two slots: the
    port's outputs equal the reference session's, request by request,
    and the program counts are the reference's executable counts."""
    ref, port = llama_pair if model == "llama" else gpt_pair
    rng = _rs(16)
    reqs = [(rng.randint(0, 256, (n,)).astype(np.int32), budget)
            for n, budget in ((5, 7), (3, 3), (9, 5), (12, 2), (2, 6))]
    out = {}
    for mod, m in ((jdec, ref), (tdec, port)):
        sess = mod.ContinuousBatchingSession(m, max_slots=2, max_length=32)
        rids = [sess.submit(p, b) for p, b in reqs]
        res = sess.run()
        out[mod] = ([res[r] for r in rids], sess.executable_counts())
        sess.close()
    for got, want in zip(out[tdec][0], out[jdec][0]):
        np.testing.assert_array_equal(got, want)
    assert out[tdec][1] == out[jdec][1]


def test_a_gpt_slot_at_the_capacity_does_not_poison_the_batch():
    """A GPT request fills its slot to the capacity, which equals the
    position table (64); after it retires its slot is still stepped,
    masked, at that length. The port keeps that row's position inside the
    table, so the request beside it and the one admitted into the slot next
    equal their isolated runs (the reference's gather reads NaN there and
    its dead k/v reach the next request)."""
    T.seed(0)
    m = GPTForCausalLM(GPTConfig.tiny())
    reqs = [(np.arange(60) % 256, 5), (np.arange(5) % 256, 30),
            (np.arange(7) % 256, 10)]
    sess = tdec.ContinuousBatchingSession(m, max_slots=2, max_length=64)
    rids = [sess.submit(p, b) for p, b in reqs]
    res = sess.results()
    for rid, (p, b) in zip(rids, reqs):
        iso = tdec.DecodeSession(m, 64).generate(
            p[None].astype(np.int32), max_new_tokens=b).numpy()[0]
        assert res[rid].ok
        np.testing.assert_array_equal(res[rid].ids, iso)
    sess.close()


def test_total_deadline_evicts_a_decoding_request():
    """test_serving_robustness.py::test_total_deadline_times_out_within_a_
    step, with the deadline passing while the request decodes, whatever
    the speed: a running request past its total deadline is evicted at the
    next step with its partial output, the other request finishes, the
    counter ticks once and the freed slot serves a new request."""
    import time
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.inference.admission import RequestState
    T.seed(13)
    m = LlamaForCausalLM(LlamaConfig.tiny())
    obs.enable()
    obs.REGISTRY.reset()
    rng = _rs(1)
    sess = tdec.ContinuousBatchingSession(m, max_slots=2, max_length=64)
    slow = sess.submit(rng.randint(0, 256, (3,)), 60, deadline_s=0.05)
    ok = sess.submit(rng.randint(0, 256, (3,)), 3)
    sess.step()
    assert sess.status(slow) is RequestState.DECODING
    time.sleep(0.06)
    res = sess.results()
    assert res[ok].ok
    assert res[slow].state is RequestState.TIMED_OUT
    assert 3 < len(res[slow].ids) < 3 + 60
    assert obs.counter("serving.timed_out").value == 1
    r3 = sess.submit(rng.randint(0, 256, (3,)), 3)
    assert sess.results()[r3].ok
    sess.close()


# ------------------------------------------------------------ the surface
def test_later_names_raise_a_clear_error():
    """The predictor and the compile tracker, which waited for the jit
    slice, are there now; a name neither package has raises
    AttributeError."""
    import paddle_tpu_torch.inference as inference
    import paddle_tpu_torch.observability as obs
    from paddle_tpu_torch.observability import compile_tracker
    for name in ("Config", "create_predictor", "save_int8_model"):
        assert callable(getattr(inference, name))
    assert obs.count_compiles is compile_tracker.count_compiles
    assert isinstance(obs.compile_report(), list)
    with pytest.raises(AttributeError):
        obs.no_such_name  # noqa: B018
    with pytest.raises(AttributeError):
        inference.no_such_name  # noqa: B018


def test_every_emitted_metric_is_in_the_catalog():
    """Every literal name the port passes to REGISTRY.counter / gauge /
    histogram is declared in observability/catalog.py, as the reference's
    test_metric_catalog.py holds for its package."""
    import ast
    import os
    from paddle_tpu_torch.observability import catalog
    root = os.path.dirname(os.path.abspath(T.__file__))
    emitted = set()
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr in ("counter", "gauge",
                                               "histogram")
                        and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)):
                    emitted.add(node.args[0].value)
    assert "serving.decode_tokens" in emitted
    assert emitted <= catalog.names(), emitted - catalog.names()
    from paddle_tpu_torch.ops.hopper import flash_attention as tfa
    assert set(tfa.DISPATCH_LABELS) <= catalog.names()
