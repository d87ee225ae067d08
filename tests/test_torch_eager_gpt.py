"""The eager slice as a whole, against the reference on the CPU.

- ``flash_attn``: on CPU tensors both packages take the plain attention of
  ``paddle_tpu/ops/extra.py:348-359``; values and gradients agree, causal
  and not, at head dims the Hopper kernels take and at 192, which none does.
- the eager GPT of ``chip_smoke.eager_gpt_loss`` (the function phase 7 runs
  at the 1.3B width on the card) at a tiny width and 2 layers in f32, on the
  reference's own parameters carried across: the loss agrees with the
  reference's eager API at rtol 1e-5 and with the port's gpt_hybrid (plain
  CE, remat off) at rtol 1e-5, and every gradient within 1e-4 of its leaf's
  scale.
- ``save``/``load`` round-trip f32, int and bf16 tensors, and a file loads
  where ``ml_dtypes`` cannot be imported.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import paddle_tpu as P
from paddle_tpu.models import gpt_hybrid as GH
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
import paddle_tpu_torch as T
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.ops.hopper import autotune as tat
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _port_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(tat, "_table", None)
    T.set_device("cpu")
    T.seed(2024)
    yield


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


# -------------------------------------------------------------- flash_attn
@pytest.mark.parametrize("q_shape,kv_len,causal,dtype,tol", [
    ((2, 64, 2, 64), 64, True, "float32", 1e-5),
    ((2, 64, 2, 64), 64, False, "float32", 1e-5),
    ((1, 128, 2, 128), 128, True, "float32", 1e-5),
    ((1, 128, 2, 192), 128, True, "float32", 1e-5),
    ((1, 128, 2, 192), 128, False, "float32", 1e-5),
    ((1, 64, 2, 64), 128, True, "float32", 1e-5),
    ((1, 64, 2, 64), 128, False, "float32", 1e-5),
    ((2, 64, 2, 64), 64, True, "bfloat16", 2e-2),
], ids=["d64_causal", "d64", "d128_causal", "d192_causal", "d192",
        "sq_lt_skv_causal", "sq_lt_skv", "bf16_causal"])
def test_flash_attn_matches_reference(q_shape, kv_len, causal, dtype, tol):
    r = np.random.RandomState(3)
    kv_shape = (q_shape[0], kv_len) + q_shape[2:]
    arrays = [r.randn(*q_shape).astype(np.float32),
              r.randn(*kv_shape).astype(np.float32),
              r.randn(*kv_shape).astype(np.float32)]
    do = r.randn(*q_shape).astype(np.float32)
    got = {}
    for pd in (P, T):
        xs = [pd.to_tensor(a).astype(dtype) for a in arrays]
        for x in xs:
            x.stop_gradient = False
        out = pd.ops.extra.flash_attn(*xs, causal=causal)
        (out.astype("float32") * pd.to_tensor(do)).sum().backward()
        got[pd] = [t.astype("float32").numpy()
                   for t in [out] + [x.grad for x in xs]]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got[T], got[P]):
        assert g.shape == w.shape
        assert _rel(g, w) <= tol, (name, _rel(g, w))


# ------------------------------------------------------------ the slice
SIZE = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=64)
B, S = 2, 64


def _leaf_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_items(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


def test_eager_gpt_matches_reference_and_gpt_hybrid():
    cs = _chip_smoke()
    jcfg, tcfg = JaxGPTConfig(**SIZE), GPTConfig(**SIZE)
    jp = GH.ParallelConfig(param_dtype=np.float32, compute_dtype=np.float32)
    np_params = jax.tree_util.tree_map(
        np.asarray, GH.init_params(jcfg, jp, jax.random.PRNGKey(0)))
    ids = np.random.RandomState(0).randint(0, SIZE["vocab_size"],
                                           (B, S)).astype(np.int64)

    ref_params = jax.tree_util.tree_map(
        lambda a: P.to_tensor(a, stop_gradient=False), np_params)
    ref_loss = cs.eager_gpt_loss(P, ref_params, P.to_tensor(ids), jcfg)
    ref_loss.backward()

    # the reference's eager Tensors carried across
    params = TH.eager_params_from_jax(ref_params, device="cpu")
    assert all(not t.stop_gradient for _, t in _leaf_items(params))
    loss = cs.eager_gpt_loss(T, params, T.to_tensor(ids), tcfg)
    loss.backward()

    assert abs(float(loss) - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref_grads = dict(_leaf_items(ref_params))
    for name, t in _leaf_items(params):
        want = ref_grads[name].grad.numpy()
        err = float(np.max(np.abs(t.grad.numpy() - want)))
        assert err <= 1e-4 * float(np.max(np.abs(want))), (name, err)

    tpcfg = TH.ParallelConfig(remat=False, fused_ce=False,
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    ids_t = torch.from_numpy(ids)
    hybrid = TH.loss_fn(TH.params_from_jax(np_params, device="cpu"),
                        (ids_t, ids_t), tcfg, tpcfg)
    assert abs(float(loss) - float(hybrid)) <= 1e-5 * abs(float(hybrid))


def test_eager_params_from_jax_carries_stop_gradient_and_dtype():
    import ml_dtypes
    tree = {"w": np.ones((2, 3), np.float32),
            "b": np.zeros(3, ml_dtypes.bfloat16),
            "frozen": P.to_tensor(np.arange(4, dtype=np.float32)),
            "trained": P.to_tensor(np.ones(2, np.float32),
                                   stop_gradient=False),
            "shared": torch.ones(3)}
    out = TH.eager_params_from_jax(tree, device="cpu")
    # a torch leaf on the device is wrapped, not copied (phase 7b's case)
    assert out["shared"]._data.data_ptr() == tree["shared"].data_ptr()
    assert not out["shared"].stop_gradient
    assert not out["w"].stop_gradient and not out["b"].stop_gradient
    assert out["frozen"].stop_gradient and not out["trained"].stop_gradient
    assert out["b"].dtype == T.bfloat16 and out["w"].dtype == T.float32
    np.testing.assert_array_equal(out["frozen"].numpy(), np.arange(4))
    assert out["w"].place == T.CPUPlace()


# -------------------------------------------------------------- save/load
def test_save_load_round_trip(tmp_path):
    r = np.random.RandomState(0)
    state = {"w": T.to_tensor(r.randn(3, 4).astype(np.float32),
                              stop_gradient=False),
             "ids": T.to_tensor(np.arange(5)),
             "h": T.to_tensor(r.randn(4).astype(np.float32)).astype(
                 "bfloat16"),
             "nested": [T.to_tensor([True, False]), 7]}
    path = str(tmp_path / "ckpt.pdparams")
    T.save(state, path)
    out = T.load(path)
    assert out["nested"][1] == 7
    for key in ("w", "ids", "h"):
        assert out[key].dtype == state[key].dtype
        assert out[key].stop_gradient == state[key].stop_gradient
        np.testing.assert_array_equal(out[key].numpy(), state[key].numpy())
    np.testing.assert_array_equal(out["nested"][0].numpy(), [True, False])
    arrays = T.load(path, return_numpy=True)
    np.testing.assert_array_equal(arrays["h"], state["h"].numpy())

    # the card's machine has no ml_dtypes: the file must not need it
    probe = ("import sys; sys.modules['ml_dtypes'] = None\n"
             "import paddle_tpu_torch as paddle\n"
             "paddle.set_device('cpu')\n"
             f"h = paddle.load({path!r})['h']\n"
             "print(h.dtype, h.astype('float32').numpy().tolist())\n")
    res = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    name, values = res.stdout.split(" ", 1)
    assert name == "bfloat16"
    np.testing.assert_array_equal(np.array(eval(values), np.float32),
                                  state["h"].numpy())


def test_chip_smoke_import_runs_nothing():
    cs = _chip_smoke()
    assert callable(cs.main) and callable(cs.eager_gpt_loss)
    assert "paddle_tpu_torch" not in cs.__dict__
