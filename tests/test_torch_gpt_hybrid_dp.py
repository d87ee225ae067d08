"""gpt_hybrid's data-parallel step (dp = N ranks over gloo, with and without
ZeRO-1, with gradient merge, and the split accumulation engine) against the
reference's ``setup(cfg, ParallelConfig(dp=N, ...))`` on the CPU.

The reference runs one process on N of the 8 virtual devices (GSPMD: the
batch sharded over dp, XLA's psum, ZeRO-1 as a sharding of the moments).
The port runs N processes, each on its B/N rows of the same global batch,
started by the port's own launcher; one worker group a world size runs
every configuration and writes rank 0's losses, parameters and moments
(gathered into the reference's layout), and each rank's moment sizes.
Both sides start from the reference's parameters. f32; tolerances: losses
rtol 2e-5, atol 2e-6 (the reference's own group-sharded bound);
parameters and moments within 1e-5 of each leaf's scale, where Adam's
first steps may turn rounding noise in a gradient that is zero in exact
arithmetic (the key bias) into up to 0.1 lr a step (as in
test_torch_gpt_train.py).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt_hybrid as GH
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

SIZE = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
            max_seq_len=16)
B, S, STEPS = 8, 16, 3
LR = 3e-4
ADAM_NOISE = 0.1 * LR
# (name, world, ParallelConfig fields)
CONFIGS = (
    ("zero1", 2, dict(zero1=True)),
    ("replicated", 2, dict(zero1=False)),
    ("merge2", 2, dict(zero1=True, gradient_merge_steps=2)),
    ("zero1", 4, dict(zero1=True)),
    ("replicated", 4, dict(zero1=False)),
    ("merge2", 4, dict(zero1=True, gradient_merge_steps=2)),
)
ACCUM_K = 2          # build_accum_steps at dp=2: two chunks a step

WORKER = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig

out, size, configs, B, S, STEPS, K = sys.argv[1], *map(json.loads, sys.argv[2:4]), *map(int, sys.argv[4:8])
dist.init_parallel_env()
rank, world = dist.get_rank(), dist.get_world_size()
cfg = GPTConfig(**size)
start = dict(np.load(os.path.join(out, "start.npz")))

def tree():
    flat = {}
    for k, v in start.items():
        d = flat
        parts = k.split(".")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return TH.params_from_jax(flat, device="cpu")

def ids(i):
    x = np.random.RandomState(i).randint(0, size["vocab_size"], (B, S))
    t = torch.from_numpy(x).long()
    return t, t

def flat_leaves(t, prefix=""):
    out = {}
    for k in sorted(t):
        v = t[k]
        out.update(flat_leaves(v, prefix + k + ".") if isinstance(v, dict)
                   else {prefix + k: v.detach().float().numpy()})
    return out

def record(name, losses, params, opt_state, pcfg):
    full = TH.gather_opt_state(params, opt_state, pcfg)
    sizes = {k: int(v.numel()) for k, v in opt_state["m"].items()}
    res = {"loss": np.asarray(losses), "step": np.asarray(full["step"]),
           "msize": np.asarray(sizes["float32"])}
    for kind, t in (("p", params), ("m", full["m"]), ("v", full["v"])):
        res.update({f"{kind}.{k}": v for k, v in flat_leaves(t).items()})
    np.savez(os.path.join(out, f"{name}.{world}.{rank}.npz"), **res)

base = dict(remat=False, fused_ce=True,
            param_dtype=torch.float32, compute_dtype=torch.float32)
for name, fields in configs:
    pcfg = TH.ParallelConfig(dp=world, **base, **fields)
    params = tree()
    opt = TH.dp_adamw_init(params, pcfg)
    step = TH.build_train_step(cfg, pcfg)
    losses = [float(step(params, opt, ids(i))[2]) for i in range(STEPS)]
    record(name, losses, params, opt, pcfg)
if K:
    pcfg = TH.ParallelConfig(dp=world, **base, zero1=True)
    params = tree()
    opt = TH.dp_adamw_init(params, pcfg)
    grad_step, apply_step = TH.build_accum_steps(cfg, pcfg)
    acc = TH.init_grad_accum(params)
    losses = []
    for i in range(STEPS):
        for c in range(K):
            acc, loss = grad_step(params, acc, tuple(
                x[c * B // K:(c + 1) * B // K] for x in ids(i)))
            losses.append(float(loss))
        params, opt, acc = apply_step(params, opt, acc, K)
    record("accum", losses, params, opt, pcfg)
'''


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, prefix + k + ".") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v, np.float32)})
    return out


def _jpcfg(dp, **fields):
    return GH.ParallelConfig(dp=dp, remat=False, fused_ce=True,
                             param_dtype=jnp.float32,
                             compute_dtype=jnp.float32, **fields)


def _ids(i):
    x = np.random.RandomState(i).randint(0, SIZE["vocab_size"], (B, S))
    return jnp.asarray(x), jnp.asarray(x)


def _reference(dp, **fields):
    """(losses, {"p."/"m."/"v." + leaf: array}, step) of the reference's
    dp step, STEPS steps."""
    jp = _jpcfg(dp, **fields)
    mesh, params, opt, step = GH.setup(JaxGPTConfig(**SIZE), jp, seed=0,
                                       devices=jax.devices()[:dp])
    losses = []
    with mesh:
        for i in range(STEPS):
            params, opt, loss = step(params, opt, _ids(i))
            losses.append(float(loss))
    out = {f"p.{k}": v for k, v in _flat(_np_tree(params)).items()}
    for kind in ("m", "v"):
        out.update({f"{kind}.{k}": v
                    for k, v in _flat(_np_tree(opt[kind])).items()})
    return losses, out, int(opt["step"])


def _reference_accum(dp):
    jp = _jpcfg(dp, zero1=True)
    jcfg = JaxGPTConfig(**SIZE)
    mesh, params, opt, _ = GH.setup(jcfg, jp, seed=0,
                                    devices=jax.devices()[:dp])
    grad_step, apply_step = GH.build_accum_steps(jcfg, jp, mesh)
    acc = GH.init_grad_accum(params)
    losses = []
    with mesh:
        for i in range(STEPS):
            ids = _ids(i)
            for c in range(ACCUM_K):
                chunk = tuple(x[c * B // ACCUM_K:(c + 1) * B // ACCUM_K]
                              for x in ids)
                acc, loss = grad_step(params, acc, chunk)
                losses.append(float(loss))
            params, opt, acc = apply_step(params, opt, acc, ACCUM_K)
    out = {f"p.{k}": v for k, v in _flat(_np_tree(params)).items()}
    for kind in ("m", "v"):
        out.update({f"{kind}.{k}": v
                    for k, v in _flat(_np_tree(opt[kind])).items()})
    return losses, out, int(opt["step"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worker groups at world 2 and 4 (all configurations) from
    the reference's parameters, both at once, and the reference's steps of
    every configuration, computed while the groups run."""
    import json
    out = tmp_path_factory.mktemp("dp")
    mesh, params, _, _ = GH.setup(JaxGPTConfig(**SIZE), _jpcfg(1), seed=0,
                                  devices=jax.devices()[:1])
    np.savez(out / "start.npz", **_flat(_np_tree(params)))
    script = out / "worker.py"
    script.write_text(WORKER)

    def launch(world):
        configs = [(n, f) for n, w, f in CONFIGS if w == world]
        return run_workers(script, world, [
            out, json.dumps(SIZE), json.dumps(configs), B, S, STEPS,
            ACCUM_K if world == 2 else 0], timeout=150)
    with ThreadPoolExecutor(2) as pool:
        jobs = pool.map(launch, (2, 4))
        ref = {(name, world): _reference(world, **fields)
               for name, world, fields in CONFIGS}
        ref["accum"] = _reference_accum(2)
        for res in jobs:
            assert res.returncode == 0, res.stderr[-3000:]
    return out, ref


def _port(runs, name, world, rank=0):
    with np.load(runs / f"{name}.{world}.{rank}.npz") as f:
        return {k: f[k] for k in f.files}


def _assert_close(got, want, what, atol=0.0):
    assert set(k for k in got if k[:2] in ("p.", "m.", "v.")) == set(want)
    for k, w in want.items():
        err = float(np.max(np.abs(got[k] - w)))
        scale = float(np.max(np.abs(w))) or 1.0
        tol = 1e-5 * scale + (atol if k.startswith("p.") else 0.0)
        assert err <= tol, f"{what} {k}: {err} > {tol}"


@pytest.mark.parametrize("name,world,fields", CONFIGS,
                         ids=[f"{n}-dp{w}" for n, w, _ in CONFIGS])
def test_dp_step_matches_reference(runs, name, world, fields):
    out, ref = runs
    want_l, want, want_step = ref[name, world]
    got = _port(out, name, world)
    np.testing.assert_allclose(got["loss"], want_l, rtol=2e-5, atol=2e-6)
    assert int(got["step"]) == want_step == STEPS
    assert got["loss"][-1] < got["loss"][0]
    _assert_close(got, want, f"{name} dp{world}", atol=STEPS * ADAM_NOISE)


def test_accum_steps_match_reference_at_dp2(runs):
    out, ref = runs
    want_l, want, want_step = ref["accum"]
    got = _port(out, "accum", 2)
    np.testing.assert_allclose(got["loss"], want_l, rtol=2e-5, atol=2e-6)
    assert int(got["step"]) == want_step == STEPS
    _assert_close(got, want, "accum dp2", atol=STEPS * ADAM_NOISE)


@pytest.mark.parametrize("world", [2, 4])
def test_zero1_ranks_hold_one_nth_of_the_moments(runs, world):
    """ZeRO-1: each rank's moment bucket is ceil(n / world) elements, n the
    parameter count; without it every rank holds all n (padded)."""
    runs = runs[0]
    n = sum(v.size for k, v in _port(runs, "zero1", world).items()
            if k.startswith("p."))
    chunk = -(-n // world)
    for r in range(world):
        assert int(_port(runs, "zero1", world, r)["msize"]) == chunk
        assert int(_port(runs, "replicated", world, r)["msize"]) == \
            chunk * world
    # every rank gathers the same whole state
    a, b = _port(runs, "zero1", world, 0), _port(runs, "zero1", world,
                                                 world - 1)
    for k in a:
        if k[:2] in ("p.", "m.", "v."):
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bad,slice_", [
    pytest.param(dict(tp=2, pp=2, num_experts=2), "init_parallel_env",
                 id="bad0-expert-parallel"),
    pytest.param(dict(pp=2, num_experts=2), "init_parallel_env",
                 id="bad1-expert-parallel"),
    pytest.param(dict(sp=True, num_experts=2), None,
                 id="bad2-expert-parallel"),
    pytest.param(dict(collective_matmul=True, num_experts=2), None,
                 id="bad3-expert-parallel"),
    pytest.param(dict(dp=2, num_experts=2), "init_parallel_env",
                 id="bad4-expert-parallel"),
])
def test_validate_refuses_later_slices_naming_them(bad, slice_):
    """Experts beside dp, pp, tp, sp or collective_matmul, which the
    expert-parallel slice brought: no longer refused. Without a process
    group the multi-rank ones ask for one, as every multi-rank config
    does, and the one-rank ones build."""
    pcfg = TH.ParallelConfig(**bad)
    for build in (TH.build_train_step, TH.build_accum_steps):
        if slice_ is None:
            assert build(GPTConfig(**SIZE), pcfg) is not None
            continue
        with pytest.raises(RuntimeError, match=slice_):
            build(GPTConfig(**SIZE), pcfg)


def test_dp_needs_a_process_group_of_dp_ranks():
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        TH.setup(GPTConfig(**SIZE), TH.ParallelConfig(dp=2), device="cpu")
