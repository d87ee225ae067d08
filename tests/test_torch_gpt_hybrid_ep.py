"""gpt_hybrid's expert-parallel branch on gloo ranks against the reference's
``setup(cfg, ParallelConfig(num_experts=4, ...))`` on as many virtual CPU
devices: dp = 2 (two ranks, with and without ZeRO-1), and on four ranks
dp2 x tp2, and dp2 x pp2 under 1F1B and under ZBH1 (the manual-ep
zero-bubble route, ``gpt_manual_tp.train_grads_zb_manual_ep``); in process,
the branch at world 1 against the single-device step, and the reference's
refusals.

The reference shards the expert dim of the MoE leaves over dp (GSPMD emits
the all-to-alls); the port's dp rank holds E / dp experts
(``params_from_jax(..., dp_rank=, dp=)``) and exchanges tokens with two
all-to-alls a layer. One worker group a world size runs every configuration
(``_testing.gpt_hybrid_worker``) while the reference computes; it writes
rank 0's losses and the parameters and moments gathered back into the
reference's layout. The tiny GPT (vocab 64, h32, 4 layers, 4 heads, S16,
B8, f32); tolerances: losses rtol 1e-5 (atol 2e-5 for the losses near 0);
parameters and moments within 1e-4 of each leaf's scale, with Adam's
allowance for rounding noise in a gradient that is zero in exact arithmetic
(as in test_torch_pipeline_hybrid.py).
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
E = 4
EP = ("fc1_w", "fc1_b", "fc2_w", "fc2_b")
# world size -> (name, ParallelConfig fields)
CONFIGS = {
    2: (("dp2_zero1", dict(dp=2, zero1=True)),
        ("dp2_merge2", dict(dp=2, zero1=False, gradient_merge_steps=2))),
    4: (("dp2_tp2", dict(dp=2, tp=2)),
        ("dp2_pp2_1f1b", dict(dp=2, pp=2, microbatches=2,
                              pp_schedule="1f1b")),
        ("dp2_pp2_zbh1", dict(dp=2, pp=2, microbatches=2,
                              pp_schedule="zbh1"))),
}
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
                                "num_experts": E,
                                "param_dtype": jnp.float32,
                                "compute_dtype": jnp.float32, **fields})


def _ids(i):
    x = np.random.RandomState(i).randint(0, SIZE["vocab_size"], (B, S))
    return jnp.asarray(x), jnp.asarray(x)


def _reference(mesh, params, opt, step):
    """(losses, {"p."/"m."/"v." + leaf: array}, step) of STEPS steps."""
    losses = []
    with mesh:
        for i in range(STEPS):
            params, opt, loss = step(params, opt, _ids(i))
            losses.append(float(loss))
    out = {f"p.{k}": v for k, v in _flat(jax.device_get(params)).items()}
    for kind in ("m", "v"):
        out.update({f"{kind}.{k}": v
                    for k, v in _flat(jax.device_get(opt[kind])).items()})
    return losses, out, int(opt["step"])


def _run(tmp_path_factory, world):
    out = tmp_path_factory.mktemp(f"ep{world}")
    setups = {}
    for name, fields in CONFIGS[world]:
        jp = _jpcfg(**fields)
        setups[name] = GH.setup(JaxGPTConfig(**SIZE), jp, seed=0,
                                devices=jax.devices()[:world])
        np.savez(out / f"start.{name}.npz",
                 **_flat(jax.device_get(setups[name][1])))
    script = out / "worker.py"
    script.write_text(WORKER)
    configs = [(n, SIZE, dict(f, num_experts=E)) for n, f in CONFIGS[world]]
    res = {}

    def launch():
        res["port"] = run_workers(script, world, [out, json.dumps(configs),
                                                  B, S, STEPS], timeout=150)
    th = threading.Thread(target=launch)
    th.start()
    ref = {n: _reference(*s) for n, s in setups.items()}
    th.join()
    assert res["port"].returncode == 0, res["port"].stderr[-3000:]
    return out, ref


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run(tmp_path_factory, 4)


def _port(out, name, world, rank=0):
    with np.load(out / f"{name}.{world}.{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def _assert_close(got, want, what, keys=None):
    for k in keys or want:
        w = want[k]
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        err = float(np.max(np.abs(got[k] - w)))
        scale = float(np.max(np.abs(w))) or 1.0
        tol = 1e-4 * scale + (STEPS * ADAM_NOISE if k.startswith("p.")
                              else 0.0)
        assert err <= tol, f"{what} {k}: {err} > {tol}"


def _check(runs, world, name):
    out, ref = runs
    want_l, want, want_step = ref[name]
    got = _port(out, name, world)
    np.testing.assert_allclose(got["loss"], want_l, rtol=1e-5, atol=2e-5)
    assert int(got["step"]) == want_step == STEPS
    assert {k for k in got if k[:2] in ("p.", "m.", "v.")} == set(want)
    _assert_close(got, want, name)
    last = _port(out, name, world, world - 1)
    for k in want:
        np.testing.assert_array_equal(got[k], last[k])


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS[2]])
def test_ep_step_matches_reference_two_ranks(two, name):
    """dp = 2, E = 4: three steps' losses, and the parameters and moments
    gathered into the reference's layout (experts concatenated back over
    dp), equal the reference's; both ranks gather the same state."""
    _check(two, 2, name)


@pytest.mark.parametrize("name", [c[0] for c in CONFIGS[4]])
def test_ep_step_matches_reference_four_ranks(four, name):
    """dp2 x tp2 (experts' inner dim over tp), dp2 x pp2 under 1F1B and
    under ZBH1 (the manual-ep route), E = 4."""
    _check(four, 4, name)


def test_expert_gradients_are_the_global_means(two):
    """Each expert leaf's first moment after the steps, a fixed linear
    combination of its gradients, equals the reference's: the gradient that
    the backward all-to-all sums over the dp ranks' local means is divided
    by dp (without it the moments are twice the reference's)."""
    out, ref = two
    got = _port(out, "dp2_zero1", 2)
    want = ref["dp2_zero1"][1]
    _assert_close(got, want, "experts", [f"m.blocks.{k}" for k in EP])
    for k in EP:
        np.testing.assert_allclose(
            np.abs(got[f"v.blocks.{k}"]).sum(),
            np.abs(want[f"v.blocks.{k}"]).sum(), rtol=1e-4)


def test_expert_leaves_stay_out_of_zero1_buckets():
    """The expert leaves live in buckets of their own ("<dtype>.ep"), whole
    on each rank, with whole moments; the dense leaves' bucket is padded and
    split over dp as before."""
    import torch
    from paddle_tpu_torch.models import gpt_hybrid as TH
    from paddle_tpu_torch.models.gpt import GPTConfig
    cfg = GPTConfig(**SIZE)
    pcfg = TH.ParallelConfig(num_experts=E, dp=2, zero1=True,
                             param_dtype=torch.float32)
    params = TH.ep_shard(TH.init_params(
        cfg, pcfg, torch.Generator().manual_seed(0), "cpu"), 1, 2)
    buckets = {b.key: b for b in TH._bind_flat(params, 2)}
    assert set(buckets) == {"float32", "float32.ep"}
    ep = buckets["float32.ep"]
    assert ep.local and ep.span == 1 and ep.flat.numel() == ep.numel
    assert {k for _, k in ep.refs} == set(EP)
    assert all(params["blocks"][k].shape[-3 if k.endswith("_w") else -2]
               == E // 2 for k in EP)
    assert ep.owned(ep.flat, 1) is ep.flat
    dense = buckets["float32"]
    assert not dense.local and dense.span == 2
    assert not {k for _, k in dense.refs} & set(EP)


def test_expert_alltoalls_per_step(two, four):
    """Two all-to-alls a layer forward and two backward, each between two
    checkpointed runs (none re-issued by a recompute): 4 L a step at pp = 1
    (with gradient merge, 4 L a chunk). On a pipeline stage of L / 2
    layers, a microbatch's forward cell issues 2 a layer; 1F1B's fused B
    recomputes the stage and back-propagates (4 more); ZBH1's B recomputes
    it and back-propagates for the input gradient (4 more) and its W
    back-propagates through the same graph again (2 more)."""
    L = SIZE["num_layers"]
    want = {"dp2_zero1": 4 * L * STEPS, "dp2_merge2": 8 * L * STEPS,
            "dp2_tp2": 4 * L * STEPS,
            "dp2_pp2_1f1b": 6 * (L // 2) * 2 * STEPS,
            "dp2_pp2_zbh1": 8 * (L // 2) * 2 * STEPS}
    for world, runs in ((2, two), (4, four)):
        for name, _ in CONFIGS[world]:
            for r in range(world):
                got = int(_port(runs[0], name, world, r)["alltoall_calls"])
                assert got == want[name], (name, r, got, want[name])


def test_world_1_branch_equals_single_device_step():
    """At world 1 the ep branch (experts over a dp group of one, the
    all-to-alls over the job's group) gives the single-device step's losses
    and parameters: three steps of E = 2, remat "names", fused CE, f32."""
    import torch
    from paddle_tpu_torch._testing import force_cpu
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.models import gpt_hybrid as TH
    from paddle_tpu_torch.models.gpt import GPTConfig
    force_cpu()
    cfg = GPTConfig(**SIZE)
    pcfg = TH.ParallelConfig(num_experts=2, remat=True, remat_policy="names",
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)

    def run():
        params, opt, step = TH.setup(cfg, pcfg, device="cpu")
        losses = []
        for i in range(STEPS):
            ids = torch.from_numpy(np.array(_ids(i)[0]))
            losses.append(float(step(params, opt, (ids, ids))[2]))
        return losses, params
    want, p1 = run()
    dist.init_parallel_env()
    try:
        assert TH._ep(pcfg)
        got, p2 = run()
        p2 = TH.gather_params(p2, cfg, pcfg)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k in p1["blocks"]:
        np.testing.assert_allclose(p2["blocks"][k], p1["blocks"][k],
                                   atol=1e-5)


@pytest.mark.parametrize("fields", [
    dict(pp=2, tp=2, dp=1, pp_schedule="zbh1", microbatches=2),
    dict(pp=2, tp=2, dp=1, pp_schedule="zbvpp", microbatches=2),
    dict(pp=2, dp=2, pp_schedule="zbh1", microbatches=2, num_experts=3),
    dict(dp=2, num_experts=3),
])
def test_refusals_are_the_references(fields):
    """What the reference refuses with experts (zero-bubble with tp > 1, an
    expert dim dp does not divide) the port refuses with a ValueError,
    before any process group is needed; the zero-bubble messages are the
    reference's own."""
    import torch
    from paddle_tpu_torch.models import gpt_hybrid as TH
    fields = {"num_experts": E, **fields}
    with pytest.raises(ValueError) as want:
        jp = _jpcfg(**fields)
        GH._validate_pp_schedule(jp)
        GH.setup(JaxGPTConfig(**SIZE), jp, seed=0,
                 devices=jax.devices()[:jp.dp * jp.pp * jp.tp])
    with pytest.raises(ValueError) as got:
        TH._validate(TH.ParallelConfig(**fields,
                                       param_dtype=torch.float32))
    if "zb x MoE" in str(want.value) or "BOTH" in str(want.value):
        assert str(got.value) == str(want.value)
    else:
        assert "divisible by 2" in str(want.value)
        assert "must divide by dp 2" in str(got.value)
