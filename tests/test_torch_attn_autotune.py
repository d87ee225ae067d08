"""The port's attention autotune (paddle_tpu_torch.ops.hopper.autotune),
test for test with tests/test_attn_autotune.py, and against the reference's
candidate lists.

Measurement itself needs the card; here the timing hook is stubbed and the
choice logic, shape gating, persistence, the table-only decision and
dispatch precedence are checked on the CPU (tests/test_torch_cuda.py
measures on the card).
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import autotune as jat
from paddle_tpu.ops.pallas import simple_attention as jsa
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.ops.hopper import autotune
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _fresh_table(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(autotune, "_table", None)
    yield


def _measure(*args):
    # the inputs are made on the CPU; the stubbed timing never runs them
    return autotune.measure(*args, device="cpu")


def _stub_timing(monkeypatch, seconds):
    """_time_candidate answers one window of ``seconds(name)``."""
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda name, *a, **k: [seconds(name)])


def _on_card(shape, dtype=torch.float32):
    """What decide() reads of a CUDA tensor: shape, dtype and device."""
    return SimpleNamespace(shape=shape, dtype=dtype,
                           device=torch.device("cuda"))


def test_candidates_shape_gating():
    # S=512, D=128: whole-slice simple kernel feasible
    c = autotune.candidates((2, 512, 8, 128), 512, torch.bfloat16, True)
    assert c[0] == "simple" and "xla" in c and "library_flash" in c
    # S=2048 bf16: whole [S,S] f32 scores no longer fit the budget
    c = autotune.candidates((2, 2048, 8, 128), 2048, torch.bfloat16, True)
    assert "simple" not in c
    assert "causal_skip" in c or "qblock" in c
    # S=4096: every monolithic gate rejects at D=128; only the streaming
    # kernels remain
    c = autotune.candidates((2, 4096, 8, 128), 4096, torch.bfloat16, True)
    assert not {"simple", "causal_skip", "qblock"} & set(c)
    assert "blocked_bq512_bkv512" in c and "blocked_bq256_bkv512" in c
    assert c.index("blocked_bq512_bkv512") < c.index("library_flash")
    # ... and at D=64 (GPT-3 Medium's heads) qblock takes it first
    c = autotune.candidates((2, 4096, 16, 64), 4096, torch.bfloat16, True)
    assert c[0] == "qblock" and "causal_skip" not in c
    # non-causal drops the causal-skip kernel
    c = autotune.candidates((2, 2048, 8, 128), 2048, torch.bfloat16, False)
    assert "causal_skip" not in c
    # cross attention (S != Skv): streaming kernels only
    c = autotune.candidates((2, 512, 8, 128), 1024, torch.bfloat16, False)
    assert not {"simple", "causal_skip", "qblock"} & set(c)
    assert "blocked_bq512_bkv512" in c
    c = autotune.candidates((2, 512, 8, 128), 1024, torch.bfloat16, True)
    assert not any(n.startswith("blocked") for n in c)
    # odd head dim: xla only
    c = autotune.candidates((2, 512, 8, 80), 512, torch.float32, True)
    assert c == ["xla"]


_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
        torch.float16: jnp.float16}


@pytest.mark.parametrize("dtype", list(_JDT))
def test_candidates_match_reference(dtype):
    lens = (128, 384, 512, 1024, 2048, 3072, 4096)
    for b, h in ((1, 2), (4, 16)):
        for s in lens:
            for skv in lens:
                for d in (64, 80, 128, 192, 256):
                    for causal in (True, False):
                        bshd = (b, s, h, d)
                        assert autotune.candidates(bshd, skv, dtype,
                                                   causal) == \
                            jat.candidates(bshd, skv, _JDT[dtype], causal), \
                            (bshd, skv, dtype, causal)


def test_key_matches_reference_format(monkeypatch):
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    monkeypatch.setattr(jat, "_device_kind", lambda: "testchip")
    for dt in _JDT:
        assert autotune._key((2, 4096, 16, 64), 4096, dt, True) == \
            jat._key((2, 4096, 16, 64), 4096, _JDT[dt], True)


def test_measure_picks_fastest_and_persists(monkeypatch):
    fake = {"simple": 2.0, "causal_skip": 0.5, "qblock": 1.0,
            "library_flash": 3.0, "xla": 9.0}
    # blocked_bq*_bkv* variants and any future candidate: slower
    _stub_timing(monkeypatch, lambda name: fake.get(name, 7.0))
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    win = _measure((2, 2048, 8, 128), 2048, torch.bfloat16, True)
    assert win == "causal_skip"
    # persisted, under the port's own file name
    assert os.path.basename(autotune._cache_path()) == \
        "attn_autotune_torch.json"
    with open(autotune._cache_path()) as f:
        tab = json.load(f)
    (key,) = tab.keys()
    assert key.startswith("testchip|") and "causal=True" in key
    assert "|bfloat16|" in key
    assert tab[key]["winner"] == "causal_skip"
    assert tab[key]["timings_ms"]["xla"] == 9000.0
    assert tab[key]["spread_ms"]["xla"] == 0.0
    # second measure: answered from the table, no re-timing
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda *a, **k: pytest.fail("re-timed"))
    assert _measure((2, 2048, 8, 128), 2048,
                    torch.bfloat16, True) == "causal_skip"


def test_measure_takes_the_median_window(monkeypatch):
    """One fast window (a quiet moment on the host) does not win: each
    candidate counts at the median of its windows."""
    windows = {"simple": [0.5, 9.0, 9.0], "qblock": [2.0, 2.1, 2.2]}
    monkeypatch.setattr(autotune, "_time_candidate",
                        lambda name, *a, **k: windows.get(name, [5.0]))
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    assert _measure((1, 512, 4, 64), 512, torch.bfloat16, True) == "qblock"
    ent = autotune._table[autotune._key((1, 512, 4, 64), 512,
                                        torch.bfloat16, True)]
    assert ent["timings_ms"]["simple"] == 9000.0
    assert ent["timings_ms"]["qblock"] == 2100.0
    assert ent["spread_ms"]["simple"] == 8500.0
    assert ent["spread_ms"]["qblock"] == pytest.approx(200.0)


def test_plain_attention_is_timed_but_never_the_winner(monkeypatch):
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    _stub_timing(monkeypatch, lambda name: {"xla": 1.0,
                                            "qblock": 3.0}.get(name, 4.0))
    shape = (2, 4096, 16, 64)
    assert _measure(shape, 4096, torch.bfloat16, True) == "qblock"
    key = autotune._key(shape, 4096, torch.bfloat16, True)
    assert autotune._table[key]["timings_ms"]["xla"] == 1000.0
    # a table entry that names plain attention (written by hand, or by the
    # reference's rule) reads as no entry; measure rewrites it
    autotune._table[key]["winner"] = "xla"
    assert autotune.lookup(shape, 4096, torch.bfloat16, True) is None
    q = _on_card(shape, torch.bfloat16)
    assert autotune.decide(q, q, True) is None
    assert _measure(shape, 4096, torch.bfloat16, True) == "qblock"
    # a shape no Hopper kernel takes has no winner to record: D=80 is
    # outside {64, 128, 256}, so not even the library tier is a candidate
    with pytest.raises(NotImplementedError, match="no Hopper kernel"):
        _measure((2, 512, 8, 80), 512, torch.float32, True)


def test_lookup_reloads_from_disk(monkeypatch):
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    _stub_timing(monkeypatch, lambda name: 1.0 if name == "qblock" else 5.0)
    _measure((1, 1024, 4, 128), 1024, torch.float32, True)
    autotune._table = None          # fresh process simulation
    assert autotune.lookup((1, 1024, 4, 128), 1024,
                           torch.float32, True) == "qblock"


def test_decide_is_table_only(monkeypatch):
    """decide never measures: a card tensor with no entry takes the static
    chain, and a seeded entry answers (the reference's traced step)."""
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: pytest.fail("measured"))
    q = _on_card((2, 512, 8, 128))
    assert autotune.decide(q, q, True) is None
    autotune._load_table()["testchip|B2S512H8D128Skv512|float32|"
                          "causal=True"] = {"winner": "qblock"}
    assert autotune.decide(q, q, True) == "qblock"
    assert autotune.decide(_on_card((4, 512, 8, 128)), q, True) is None


def test_decide_cpu_tensors_never_measure(monkeypatch):
    calls = []
    monkeypatch.setattr(autotune, "measure",
                        lambda *a, **k: calls.append(a) or "simple")
    for dev in ("cpu", "meta"):
        q = torch.zeros((2, 512, 8, 128), device=dev)
        assert autotune.decide(q, q, True) is None
    assert not calls


@pytest.mark.parametrize("flag,entry", [
    (False, {"winner": "qblock"}), (True, {"winner": "xla"}),
    (True, {"timings_ms": {"qblock": 1.0}})])
def test_decide_switches_off(monkeypatch, flag, entry):
    """The flag off (which bypasses the table), a winner that is plain
    attention, or an entry with no winner: the static chain."""
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    monkeypatch.setattr(flags._REGISTRY["FLAGS_attn_autotune"], "value",
                        flag)
    assert flags.get_flag("FLAGS_attn_autotune") is flag
    autotune._load_table()["testchip|B2S512H8D128Skv512|float32|"
                          "causal=True"] = entry
    q = _on_card((2, 512, 8, 128))
    assert autotune.decide(q, q, True) is None


def test_flags_env_override_and_set_flags(monkeypatch):
    monkeypatch.setattr(flags, "_REGISTRY", dict(flags._REGISTRY))
    monkeypatch.setenv("FLAGS_test_switch", "off")
    assert flags.define_flag("FLAGS_test_switch", True, "a test") is False
    assert flags.get_flag("FLAGS_test_switch") is False
    flags.set_flags({"FLAGS_test_switch": "yes"})
    assert flags.get_flag("FLAGS_test_switch") is True
    with pytest.raises(KeyError, match="FLAGS_no_such"):
        flags.set_flags({"FLAGS_no_such": 1})


def test_time_candidate_loses_only_for_unported_tiers(monkeypatch):
    q = torch.zeros(1, 128, 2, 64)

    def unported(*a):
        raise NotImplementedError("no Hopper kernel")

    def broken(*a):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(autotune, "_resolve", lambda name: unported)
    assert autotune._time_candidate("library_flash", q, q, q, True,
                                    None) == [float("inf")]
    monkeypatch.setattr(autotune, "_resolve", lambda name: broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        autotune._time_candidate("simple", q, q, q, True, None)
    # the library tier's runner is the dispatch's own: it runs the
    # library op (here on the CPU, its plain version), and raises only
    # where JAX's library kernel refuses the shape (S=640: its 512-row
    # blocks do not divide it), which times as a loss
    monkeypatch.undo()
    out = autotune._resolve("library_flash")(q, q, q, True, None)
    assert out.shape == q.shape and out.dtype == q.dtype
    refused = torch.zeros(1, 640, 2, 64)
    with pytest.raises(NotImplementedError, match="library_flash"):
        autotune._resolve("library_flash")(refused, refused, refused, True,
                                           None)
    assert autotune._time_candidate("library_flash", refused, refused,
                                    refused, True, None) == [float("inf")]


def test_blocked_candidate_name_roundtrip():
    # the winner cache pins (kernel, bq, bkv) through the name alone
    assert autotune.blocked_name(512, 1024) == "blocked_bq512_bkv1024"
    assert callable(autotune._resolve("blocked_bq128_bkv256"))
    with pytest.raises(KeyError):
        autotune._resolve("blocked_bq128")      # malformed: not a
    with pytest.raises(KeyError):               # known static runner
        autotune._resolve("no_such_kernel")


def test_corrupted_cache_falls_back_to_static_chain(monkeypatch):
    path = autotune._cache_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    # a partial/interleaved write: invalid JSON
    with open(path, "w") as f:
        f.write('{"NVIDIA_H100|B2S4096H8D128Skv4096|bfloat16|causal=Tr')
    assert autotune._load_table() == {}
    assert autotune.lookup((2, 4096, 8, 128), 4096,
                           torch.bfloat16, True) is None
    # decide() on the corrupted table: None -> static chain
    q = torch.zeros((2, 512, 8, 128))
    assert autotune.decide(q, q, True) is None
    # valid JSON, wrong schema (hand-edited / foreign tool): each bad
    # entry degrades to the static chain instead of crashing dispatch
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    key = autotune._key((1, 512, 4, 128), 512, torch.float32, True)
    autotune._table = None
    with open(path, "w") as f:
        json.dump({key: "qblock", "other": {"no_winner": 1}}, f)
    assert autotune.lookup((1, 512, 4, 128), 512,
                           torch.float32, True) is None
    _stub_timing(monkeypatch, lambda name: 1.0 if name == "simple" else 5.0)
    # measure() over a wrong-schema entry re-measures and rewrites it
    assert _measure((1, 512, 4, 128), 512, torch.float32, True) == "simple"
    # measure() over the top of a corrupted file rewrites it valid
    autotune._table = None
    with open(path, "w") as f:
        f.write("not json at all")
    assert _measure((1, 512, 4, 128), 512, torch.float32, True) == "simple"
    with open(path) as f:
        assert json.load(f)[key]["winner"] == "simple"


def test_concurrent_writers_merge_not_clobber(monkeypatch):
    """Two processes measuring different shapes on one host: each save
    is atomic (temp + os.replace, no partial interleave) and re-merges
    the file, so neither winner is lost whatever the write order."""
    monkeypatch.setattr(autotune, "_device_kind", lambda: "testchip")
    _stub_timing(monkeypatch, lambda name: 1.0 if name == "simple" else 5.0)
    key_a = autotune._key((1, 512, 4, 128), 512, torch.float32, True)
    key_b = autotune._key((2, 512, 4, 128), 512, torch.float32, True)
    # process A measures shape A and persists
    _measure((1, 512, 4, 128), 512, torch.float32, True)
    # process B loaded BEFORE A's write (empty table), measures shape
    # B, then persists; without merge-on-save this would clobber A
    autotune._table = {}
    _measure((2, 512, 4, 128), 512, torch.float32, True)
    with open(autotune._cache_path()) as f:
        tab = json.load(f)              # file is valid JSON throughout
    assert tab[key_a]["winner"] == "simple"
    assert tab[key_b]["winner"] == "simple"
    # a reader process (fresh table) sees both winners
    autotune._table = None
    assert autotune.lookup((1, 512, 4, 128), 512,
                           torch.float32, True) == "simple"
    assert autotune.lookup((2, 512, 4, 128), 512,
                           torch.float32, True) == "simple"


def test_runner_numerics_xla_vs_simple_interpret():
    """The xla candidate (the baseline every kernel is timed against)
    must agree with the interpreted simple kernel."""
    rng = np.random.RandomState(0)
    b, s, h, d = 1, 128, 2, 128
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))
    xla = autotune._runners()["xla"](*(torch.from_numpy(x)
                                       for x in (q, k, v)), True, None)
    qt, kt, vt = (jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v))
    ref = jnp.swapaxes(
        jsa.attention_bhsd(qt, kt, vt, causal=True, interpret=True), 1, 2)
    np.testing.assert_allclose(xla.numpy(), np.asarray(ref),
                               rtol=2e-4, atol=2e-4)


# Bottom-right alignment, as the reference's runner: with Sq < Skv the last
# query sees every key.
def test_xla_runner_matches_reference_runner_on_cross_attention():
    rng = np.random.RandomState(1)
    q = rng.randn(1, 128, 2, 64).astype(np.float32)
    k, v = (rng.randn(1, 256, 2, 64).astype(np.float32) for _ in range(2))
    got = autotune._runners()["xla"](*(torch.from_numpy(x)
                                       for x in (q, k, v)), True, 0.1)
    want = jat._runners()["xla"](*(jnp.asarray(x) for x in (q, k, v)),
                                 True, 0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
