"""gpt_hybrid's pipeline-parallel step at pp = 2 (GPipe, 1F1B, interleaved
1F1B, ZBH1, ZB-V) over gloo ranks against the reference's
``setup(cfg, ParallelConfig(pp=2, ...))`` on the CPU, its eval relayout and
the reference's schedule refusals; and ``parallel.pipeline_apply`` over the
same ranks against the reference's.

The reference runs one program over pp of the 8 virtual devices, the
stages stacked on a leading axis. The port runs a process a stage
(``params_from_jax(..., pp_rank, pp)`` keeps the rank's entry of the stacked
leaves); one worker group of two ranks runs every configuration
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
import torch

from paddle_tpu.models import gpt_hybrid as GH
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

SIZE = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
            max_seq_len=16)
B, S, STEPS = 8, 16, 3
LR = 3e-4
ADAM_NOISE = 0.1 * LR
WORLD = 2
# (name, ParallelConfig fields)
CONFIGS = (
    ("pp2_gpipe_m4", dict(pp=2, microbatches=4, pp_schedule="gpipe")),
    ("pp2_1f1b_m4", dict(pp=2, microbatches=4, pp_schedule="1f1b")),
    ("pp2_1f1b_vpp2", dict(pp=2, microbatches=4, pp_schedule="1f1b",
                           vpp_chunks=2)),
    ("pp2_zbh1", dict(pp=2, microbatches=4, pp_schedule="zbh1")),
    ("pp2_zbvpp", dict(pp=2, microbatches=4, pp_schedule="zbvpp")),
)
WORKER = ("from paddle_tpu_torch._testing import (gpt_hybrid_worker,\n"
          "                                       pipeline_apply_probe)\n"
          "import json, sys\n"
          "pipeline_apply_probe(sys.argv[1])\n"
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


def _papply_inputs(out):
    """pipeline_apply's probe: two stages tanh(x @ w), 4 microbatches."""
    rng = np.random.RandomState(0)
    w = (rng.randn(WORLD, 4, 4) * 0.3).astype(np.float32)
    x = rng.randn(4, 2, 4).astype(np.float32)
    np.savez(out / "papply.npz", w=w, x=x)
    return w, x


def _papply_reference(w, x):
    """The reference's pipeline_apply over pp of the virtual devices: its
    outputs and the gradients of sum(out ** 2) (stacked weights, input)."""
    from functools import partial
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.parallel import pipeline_apply
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("pp",))
    pipe = shard_map(
        partial(pipeline_apply, lambda p, h: jnp.tanh(h @ p["w"]),
                axis_name="pp"),
        mesh=mesh, in_specs=({"w": P("pp", None, None)}, P(None)),
        out_specs=P(None))
    def loss(p, xs):
        out = pipe(p, xs)
        return jnp.sum(out ** 2), out
    (_, out), (gw, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))({"w": jnp.asarray(w)},
                                             jnp.asarray(x))
    return np.asarray(out), np.asarray(gw["w"]), np.asarray(gx)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worker group (pipeline_apply's probe, then every
    configuration) and, while it runs, the reference's from the same
    inputs and parameters."""
    out = tmp_path_factory.mktemp("pp")
    papply = _papply_inputs(out)
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
    ref["papply"] = _papply_reference(*papply)
    th.join()
    assert res["port"].returncode == 0, res["port"].stderr[-3000:]
    return out, ref


def _port(out, name, rank=0, world=True):
    path = f"{name}.{WORLD}.{rank}.npz" if world else f"{name}.{rank}.npz"
    with np.load(out / path) as f:
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
    both ranks gather the same state."""
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


def test_pipeline_apply_matches_reference(runs):
    """``parallel.pipeline_apply`` over two gloo ranks (the hops through
    torch.distributed) against the reference's on two virtual devices:
    every rank's outputs (rtol and atol 1e-5), each rank's stage-weight
    gradient of sum(out ** 2) and the input gradients summed over the
    ranks (rtol 1e-4, atol 1e-5: the reference's test's tolerances)."""
    out, ref = runs
    want_out, want_gw, want_gx = ref["papply"]
    got = [_port(out, "papply", r, world=False) for r in range(WORLD)]
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["out"], want_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g["gw"], want_gw[r], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(sum(g["gx"] for g in got), want_gx,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["pp2_1f1b_vpp2", "pp2_zbvpp",
                                  "pp2_1f1b_m4"])
def test_eval_relayout_matches_reference(runs, name):
    """``loss_fn`` at pp > 1 (the GPipe forward, the interleaved and ZB-V
    stages relaid out to the plain layout across the ranks) equals the
    reference's eval loss after the steps, on every rank."""
    out, ref = runs
    for r in range(WORLD):
        np.testing.assert_allclose(float(_port(out, name, r)["eval_loss"]),
                                   ref[name][1], rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["pp2_1f1b_m4", "pp2_1f1b_vpp2",
                                  "pp2_zbvpp"])
def test_stage_layouts_match_reference(runs, name):
    """Each rank's stage of the flat [L] leaves (``pp_stage``) is its entry
    of the reference's ``shard_params`` stacking (the start parameters its
    setup made): [pp, L/pp], interleaved [pp, v, Lc] and the ZB-V
    placement [pp, 2, Lc]; ``params_from_jax`` takes the same entry."""
    out, _ = runs
    jp = _jpcfg(**dict(CONFIGS)[name])
    with np.load(out / f"start.{name}.npz") as f:
        stacked = {k[7:]: f[k] for k in f.files if k.startswith("blocks.")}
        rest = {k: f[k] for k in f.files if not k.startswith("blocks.")}
    flat = {**{k: torch.from_numpy(v) for k, v in rest.items()},
            "blocks": {k: torch.from_numpy(v)
                       for k, v in _layers(stacked, jp).items()}}
    tc = TH.ParallelConfig(**dict(CONFIGS)[name])
    for r in range(jp.pp):
        got = TH.pp_stage(flat, TH.GPTConfig(**SIZE), tc, r)["blocks"]
        back = TH.params_from_jax({**rest, "blocks": stacked}, device="cpu",
                                  pp_rank=r, pp=jp.pp)["blocks"]
        for k, v in stacked.items():
            np.testing.assert_array_equal(got[k].numpy(), v[r])
            np.testing.assert_array_equal(back[k].numpy(), v[r])


@pytest.mark.parametrize("fields,match", [
    (dict(pp=2, pp_schedule="bogus"), "pp_schedule must be"),
    (dict(pp=2, pp_schedule="zbh1", vpp_chunks=2), "vpp_chunks > 1"),
    (dict(pp=1, pp_schedule="zbvpp"), "requires pp > 1"),
    (dict(pp=2, tp=2, pp_schedule="zbh1", collective_matmul=True, sp=True),
     "collective_matmul does not compose"),
    (dict(pp=2, tp=2, pp_schedule="zbvpp", num_experts=2),
     "BOTH tp>1 and"),
])
def test_validate_pp_schedule_refusals(fields, match):
    """The reference's ``_validate_pp_schedule`` refusals, with its
    messages, on both sides."""
    with pytest.raises(ValueError, match=match):
        GH._validate_pp_schedule(_jpcfg(**fields))
    with pytest.raises(ValueError, match=match):
        TH._validate_pp_schedule(TH.ParallelConfig(**fields))


def test_unroutable_collective_matmul_warns_as_reference():
    """collective_matmul at pp > 1 off the manual-tp 1F1B route warns, in
    the reference's words, that it runs without the ring."""
    fields = dict(pp=2, tp=2, sp=True, pp_schedule="1f1b",
                  collective_matmul=True, fused_ce=True)
    with pytest.warns(UserWarning, match="not routable at pp>1"):
        GH._validate_pp_schedule(_jpcfg(**fields))
    with pytest.warns(UserWarning, match="not routable at pp>1"):
        TH._validate_pp_schedule(TH.ParallelConfig(**fields))


def test_pp_needs_its_ranks():
    """pp > 1 without a process group of dp x pp x tp ranks raises, naming
    the launcher; microbatches must divide the batch, as in the
    reference's pipeline_microbatch."""
    from paddle_tpu.parallel.pipeline import pipeline_microbatch as ref_mb
    from paddle_tpu_torch.parallel.pipeline import pipeline_microbatch
    with pytest.raises(RuntimeError, match="launch"):
        TH.setup(TH.GPTConfig(**SIZE), TH.ParallelConfig(pp=2), device="cpu")
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        ref_mb(jnp.zeros((2, 3)), 4)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        pipeline_microbatch(torch.zeros(2, 3), 4)
    assert tuple(pipeline_microbatch(torch.zeros(8, 3), 4).shape) == \
        (4, 2, 3)
