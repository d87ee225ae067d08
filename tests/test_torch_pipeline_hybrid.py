"""gpt_hybrid's pipeline-parallel step on four gloo ranks (pp = 4 1F1B with
8 microbatches, dp2 x pp2 1F1B with ZeRO-1, pp2 x tp2 with sp under 1F1B,
and pp2 x tp2 ZBH1 through ``gpt_manual_tp.train_grads_zb_manual_tp``)
against the reference's ``setup(cfg, ParallelConfig(...))`` on the CPU.

The reference runs one program over dp x pp x tp of the 8 virtual devices.
The port runs a process a (dp, pp, tp) place, tp innermost
(``params_from_jax(..., tp_rank, tp, pp_rank, pp)``); one worker group of
four ranks runs every configuration
(``_testing.gpt_hybrid_worker``) while the reference computes, and writes
rank 0's losses and the parameters and moments gathered back into the
reference's stacked layout. Both sides start from the reference's
parameters. The tiny GPT (vocab 64, h32, 4 layers, 4 heads, S16, B8, f32);
tolerances: losses rtol 2e-5, atol 2e-5 (``tests/test_gpt_hybrid.py:51``);
parameters and moments within 1e-5 of each leaf's scale, with Adam's
allowance for rounding noise in a gradient that is zero in exact
arithmetic (0.1 lr a step on the parameters, as in
test_torch_gpt_hybrid_tp.py).
"""
import json
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt_hybrid as GH
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

SIZE = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
            max_seq_len=16)
B, S, STEPS = 8, 16, 3
LR = 3e-4
ADAM_NOISE = 0.1 * LR
WORLD = 4
# (name, ParallelConfig fields)
CONFIGS = (
    ("pp4_1f1b_m8", dict(pp=4, microbatches=8, pp_schedule="1f1b")),
    ("dp2_pp2_1f1b_zero1", dict(dp=2, pp=2, microbatches=2,
                                pp_schedule="1f1b", zero1=True)),
    ("pp2_tp2_sp_1f1b", dict(pp=2, tp=2, sp=True, microbatches=4,
                             pp_schedule="1f1b")),
    ("pp2_tp2_zbh1", dict(pp=2, tp=2, microbatches=4, pp_schedule="zbh1")),
)
WORKER = ("from paddle_tpu_torch._testing import gpt_hybrid_worker\n"
          "import json, sys\n"
          "gpt_hybrid_worker(sys.argv[1], json.loads(sys.argv[2]), "
          "*map(int, sys.argv[3:6]))\n")


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, prefix + k + ".") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v, np.float32)})
    return out


def _jpcfg(**fields):
    return GH.ParallelConfig(**{"remat": False, "fused_ce": True,
                                "param_dtype": jnp.float32,
                                "compute_dtype": jnp.float32, **fields})


def _ids(i):
    x = np.random.RandomState(i).randint(0, SIZE["vocab_size"], (B, S))
    return jnp.asarray(x), jnp.asarray(x)


def _setup(fields):
    jp = _jpcfg(**fields)
    return jp, GH.setup(JaxGPTConfig(**SIZE), jp, seed=0,
                        devices=jax.devices()[:jp.dp * jp.pp * jp.tp])


def _layers(blocks, jp):
    """The reference's eval relayout (models/gpt_hybrid.py:420-450) of its
    stage-stacked block leaves, to the flat [L, ...] layer order."""
    L, pp = SIZE["num_layers"], jp.pp
    out = {}
    for k, v in blocks.items():
        v = np.asarray(v)
        lead = 2                                  # [pp, L/pp, ...]
        if jp.pp_schedule == "zbvpp":             # [pp, 2, Lc] -> [2pp, Lc]
            ds = np.concatenate([np.arange(pp), np.arange(pp - 1, -1, -1)])
            ls = np.concatenate([np.zeros(pp, int), np.ones(pp, int)])
            v = v[ds, ls]
        elif jp.vpp_chunks > 1:                   # [pp, v, Lc] -> [v, pp, Lc]
            v, lead = v.swapaxes(0, 1), 3
        out[k] = v.reshape((L,) + v.shape[lead:])
    return out


_EVAL = []


def _eval_loss(params, jp):
    """The reference's loss_fn at pp = 1 (one program for every
    configuration) on its parameters relaid out to [L, ...]."""
    if not _EVAL:
        j1 = _jpcfg()
        _EVAL.append(jax.jit(lambda p, b: GH.loss_fn(
            p, b, JaxGPTConfig(**SIZE), j1, None)))
    flat = dict(jax.device_get(params))
    flat["blocks"] = _layers(flat["blocks"], jp)
    return float(_EVAL[0](flat, _ids(0)))


def _reference(jp, mesh, params, opt, step):
    """(losses, eval loss, {"p."/"m."/"v." + leaf: array}, step) of STEPS
    reference steps."""
    losses = []
    with mesh:
        for i in range(STEPS):
            params, opt, loss = step(params, opt, _ids(i))
            losses.append(float(loss))
    ev = _eval_loss(params, jp)
    out = {f"p.{k}": v for k, v in _flat(jax.device_get(params)).items()}
    for kind in ("m", "v"):
        out.update({f"{kind}.{k}": v
                    for k, v in _flat(jax.device_get(opt[kind])).items()})
    return losses, ev, out, int(opt["step"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worker group (every configuration) and, while it runs,
    the reference's steps from the same parameters."""
    out = tmp_path_factory.mktemp("pp4")
    setups = {}
    for name, fields in CONFIGS:
        setups[name] = _setup(fields)
        np.savez(out / f"start.{name}.npz",
                 **_flat(jax.device_get(setups[name][1][1])))
    script = out / "worker.py"
    script.write_text(WORKER)
    configs = [(n, SIZE, f) for n, f in CONFIGS]
    res = {}

    def launch():
        res["port"] = run_workers(script, WORLD, [out, json.dumps(configs),
                                                  B, S, STEPS], timeout=150)
    th = threading.Thread(target=launch)
    th.start()
    ref = {n: _reference(jp, *rest) for n, (jp, rest) in setups.items()}
    th.join()
    assert res["port"].returncode == 0, res["port"].stderr[-3000:]
    return out, ref


def _port(out, name, rank=0):
    with np.load(out / f"{name}.{WORLD}.{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def _assert_close(got, want, what, atol=0.0):
    assert set(k for k in got if k[:2] in ("p.", "m.", "v.")) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        err = float(np.max(np.abs(got[k] - w)))
        scale = float(np.max(np.abs(w))) or 1.0
        tol = 1e-5 * scale + (atol if k.startswith("p.") else 0.0)
        assert err <= tol, f"{what} {k}: {err} > {tol}"


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS])
def test_pp_step_matches_reference(runs, name):
    """Three steps: the losses, and the parameters and moments gathered
    into the reference's stage-stacked layout, equal the reference's;
    every rank gathers the same state."""
    out, ref = runs
    want_l, _, want, want_step = ref[name]
    got = _port(out, name)
    np.testing.assert_allclose(got["loss"], want_l, rtol=2e-5, atol=2e-5)
    assert int(got["step"]) == want_step == STEPS
    _assert_close(got, want, name, atol=STEPS * ADAM_NOISE)
    last = _port(out, name, WORLD - 1)
    for k in got:
        if k[:2] in ("p.", "m.", "v."):
            np.testing.assert_array_equal(got[k], last[k])


def test_hybrid_eval_matches_reference(runs):
    """``loss_fn`` at pp > 1 on every rank of each grid equals the
    reference's eval loss after the steps."""
    out, ref = runs
    for name, _ in CONFIGS:
        for r in range(WORLD):
            np.testing.assert_allclose(
                float(_port(out, name, r)["eval_loss"]), ref[name][1],
                rtol=2e-5, atol=2e-5)
