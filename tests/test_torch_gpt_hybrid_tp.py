"""gpt_hybrid's tensor- and sequence-parallel step (tp over gloo ranks, with
sp, with collective_matmul, with dp x tp and ZeRO-1, with remat "names",
and with a vocab that tp does not divide) against the reference's
``setup(cfg, ParallelConfig(dp=..., tp=..., sp=...))`` on the CPU.

The reference runs one GSPMD program over dp x tp of the 8 virtual devices
(the weights sharded by param_specs, the activations sequence-sharded
between blocks under sp). The port runs dp x tp processes in a grid with tp
innermost, each holding its tp shards (``params_from_jax(..., tp_rank,
tp)``) and running the manual-tp block over its tp group; one worker group
a world size (the port's launcher) runs every configuration of that size
and writes rank 0's losses and the parameters and moments gathered into
the reference's layout. Both sides start from the reference's parameters.
f32; tolerances: losses rtol 2e-5, atol 2e-5 (``tests/test_gpt_hybrid.py
:51``); parameters and moments within 1e-5 of each leaf's scale, with
Adam's allowance for rounding noise in a gradient that is zero in exact
arithmetic (0.1 lr a step on the parameters, as in
test_torch_gpt_hybrid_dp.py).
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
from paddle_tpu_torch.models import gpt_manual_tp as TMT
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

SIZE = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
            max_seq_len=16)
ODD = dict(SIZE, vocab_size=65)       # tp = 2 does not divide it
B, S, STEPS = 8, 16, 3
LR = 3e-4
ADAM_NOISE = 0.1 * LR
# (name, world, size, ParallelConfig fields)
CONFIGS = (
    ("tp2", 2, SIZE, dict(tp=2)),
    ("tp2_sp", 2, SIZE, dict(tp=2, sp=True)),
    ("tp2_sp_cm", 2, SIZE, dict(tp=2, sp=True, collective_matmul=True)),
    ("tp2_sp_remat", 2, SIZE, dict(tp=2, sp=True, remat=True,
                                   remat_policy="names")),
    ("tp2_sp_odd_vocab", 2, ODD, dict(tp=2, sp=True)),
    ("tp4_sp", 4, SIZE, dict(tp=4, sp=True)),
    ("dp2_tp2_sp_zero1", 4, SIZE, dict(dp=2, tp=2, sp=True, zero1=True)),
)

WORKER = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import torch
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig

out, configs, B, S, STEPS = sys.argv[1], json.loads(sys.argv[2]), *map(int, sys.argv[3:6])
dist.init_parallel_env()
rank, world = dist.get_rank(), dist.get_world_size()

def tree(path):
    start = dict(np.load(path))
    t = {"blocks": {}}
    for k, v in start.items():
        if k.startswith("blocks."):
            t["blocks"][k[7:]] = v
        else:
            t[k] = v
    return t

def flat_leaves(t, prefix=""):
    o = {}
    for k in sorted(t):
        v = t[k]
        o.update(flat_leaves(v, prefix + k + ".") if isinstance(v, dict)
                 else {prefix + k: v.detach().float().numpy()})
    return o

for name, size, fields in configs:
    cfg = GPTConfig(**size)
    pcfg = TH.ParallelConfig(**{"remat": False, "fused_ce": True,
                                "param_dtype": torch.float32,
                                "compute_dtype": torch.float32, **fields})
    tp = pcfg.tp
    params = TH.params_from_jax(
        tree(os.path.join(out, f"start.{size['vocab_size']}.npz")),
        device="cpu", tp_rank=rank % tp, tp=tp)
    opt = TH.dp_adamw_init(params, pcfg)
    step = TH.build_train_step(cfg, pcfg)
    losses = []
    for i in range(STEPS):
        x = np.random.RandomState(i).randint(0, size["vocab_size"], (B, S))
        ids = torch.from_numpy(x).long()
        losses.append(float(step(params, opt, (ids, ids))[2]))
    full = TH.gather_opt_state(params, opt, pcfg, cfg)
    res = {"loss": np.asarray(losses), "step": np.asarray(full["step"])}
    for kind, t in (("p", TH.gather_params(params, cfg, pcfg)),
                    ("m", full["m"]), ("v", full["v"])):
        res.update({f"{kind}.{k}": v for k, v in flat_leaves(t).items()})
    res["local.qkv_w"] = np.asarray(params["blocks"]["qkv_w"].shape)
    np.savez(os.path.join(out, f"{name}.{world}.{rank}.npz"), **res)
'''


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


def _ids(i, vocab):
    x = np.random.RandomState(i).randint(0, vocab, (B, S))
    return jnp.asarray(x), jnp.asarray(x)


def _reference(size, **fields):
    """(losses, {"p."/"m."/"v." + leaf: array}, step) of the reference's
    step on dp x tp devices, STEPS steps."""
    jp = _jpcfg(**fields)
    mesh, params, opt, step = GH.setup(JaxGPTConfig(**size), jp, seed=0,
                                       devices=jax.devices()[:jp.dp * jp.tp])
    losses = []
    with mesh:
        for i in range(STEPS):
            params, opt, loss = step(params, opt,
                                     _ids(i, size["vocab_size"]))
            losses.append(float(loss))
    out = {f"p.{k}": v for k, v in _flat(jax.device_get(params)).items()}
    for kind in ("m", "v"):
        out.update({f"{kind}.{k}": v
                    for k, v in _flat(jax.device_get(opt[kind])).items()})
    return losses, out, int(opt["step"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worker groups at world 2 and 4 (all configurations) from
    the reference's parameters, and the reference's steps of every
    configuration, computed while the groups run."""
    import json
    out = tmp_path_factory.mktemp("tp")
    for size in (SIZE, ODD):
        params = GH.init_params(JaxGPTConfig(**size), _jpcfg(),
                                jax.random.PRNGKey(0))
        np.savez(out / f"start.{size['vocab_size']}.npz",
                 **_flat(jax.device_get(params)))
    script = out / "worker.py"
    script.write_text(WORKER)
    def launch(world):
        configs = [(n, s, f) for n, w, s, f in CONFIGS if w == world]
        return run_workers(script, world, [out, json.dumps(configs), B, S,
                                           STEPS], timeout=150)
    # the two worker groups run at once (each waits on its own imports),
    # and the reference computes every configuration meanwhile
    with ThreadPoolExecutor(2) as pool:
        jobs = pool.map(launch, (2, 4))
        ref = {name: _reference(size, **fields)
               for name, _, size, fields in CONFIGS}
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


@pytest.mark.parametrize("name,world,size,fields", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_tp_step_matches_reference(runs, name, world, size, fields):
    """Three steps: the losses, and the parameters and moments gathered
    from the ranks' shards, equal the reference's; every rank gathers the
    same state."""
    out, ref = runs
    want_l, want, want_step = ref[name]
    got = _port(out, name, world)
    np.testing.assert_allclose(got["loss"], want_l, rtol=2e-5, atol=2e-5)
    assert int(got["step"]) == want_step == STEPS
    _assert_close(got, want, name, atol=STEPS * ADAM_NOISE)
    last = _port(out, name, world, world - 1)
    for k in got:
        if k[:2] in ("p.", "m.", "v."):
            np.testing.assert_array_equal(got[k], last[k])


@pytest.mark.parametrize("name,world,tp", [("tp2", 2, 2), ("tp4_sp", 4, 4),
                                           ("dp2_tp2_sp_zero1", 4, 2)])
def test_ranks_hold_their_qkv_shard(runs, name, world, tp):
    """Each rank holds [L, h, 3 h / tp] of qkv_w: its columns of each of q,
    k and v."""
    L, h = SIZE["num_layers"], SIZE["hidden_size"]
    for r in range(world):
        assert _port(runs[0], name, world, r)["local.qkv_w"].tolist() == \
            [L, h, 3 * h // tp]


def test_params_from_jax_shards_qkv_per_matrix():
    """tp_shard takes each rank's slice of each of q, k and v (the flat 3h
    dim straddles q|k|v), and the tp ranks' shards rebuild the whole."""
    rng = np.random.RandomState(0)
    L, h, m, V = 2, 8, 32, 10
    tree = {"wte": rng.randn(V, h), "wpe": rng.randn(4, h),
            "lnf_g": rng.randn(h), "lnf_b": rng.randn(h),
            "blocks": {"qkv_w": rng.randn(L, h, 3 * h),
                       "qkv_b": rng.randn(L, 3 * h),
                       "proj_w": rng.randn(L, h, h), "proj_b": rng.randn(L, h),
                       "fc1_w": rng.randn(L, h, m), "fc1_b": rng.randn(L, m),
                       "fc2_w": rng.randn(L, m, h), "fc2_b": rng.randn(L, h),
                       "ln1_g": rng.randn(L, h), "ln1_b": rng.randn(L, h),
                       "ln2_g": rng.randn(L, h), "ln2_b": rng.randn(L, h)}}
    shards = [TH.params_from_jax(tree, device="cpu", tp_rank=r, tp=2)
              for r in range(2)]
    q = tree["blocks"]["qkv_w"].reshape(L, h, 3, h)
    for r, sh in enumerate(shards):
        got = sh["blocks"]["qkv_w"].numpy().reshape(L, h, 3, h // 2)
        np.testing.assert_array_equal(got, q[..., r * 4:(r + 1) * 4])
        np.testing.assert_array_equal(sh["wte"].numpy(),
                                      tree["wte"][r * 5:(r + 1) * 5])
        np.testing.assert_array_equal(
            sh["blocks"]["proj_w"].numpy(),
            tree["blocks"]["proj_w"][:, r * 4:(r + 1) * 4])
    back = TMT._reshape_qkv({k: v.numpy().reshape(v.shape)
                             for k, v in shards[0]["blocks"].items()})
    assert back["qkv_w"].shape == (L, h, 3, h // 2)
    assert TMT._unreshape_qkv_grads(
        back, {k: v.numpy() for k, v in shards[0]["blocks"].items()}
    )["qkv_w"].shape == (L, h, 3 * h // 2)


@pytest.mark.parametrize("bad,where", [
    pytest.param(dict(tp=2, pp=2, pp_schedule="1f1b", num_experts=2),
                 "init_parallel_env", id="bad0-expert-parallel"),
    pytest.param(dict(tp=2, num_experts=2), "init_parallel_env",
                 id="bad1-expert-parallel"),
    pytest.param(dict(sp=True, num_experts=2), None,
                 id="bad2-expert-parallel"),
])
def test_later_slices_are_refused_naming_them(bad, where):
    """Experts beside tp or sp, which the expert-parallel slice brought:
    no longer refused; without a process group tp = 2 asks for one and sp
    at one rank builds (tests/test_torch_gpt_hybrid_ep.py runs them)."""
    pcfg = TH.ParallelConfig(**bad)
    for build in (TH.build_train_step, TH.build_accum_steps):
        if where is None:
            assert build(GPTConfig(**SIZE), pcfg) is not None
            continue
        with pytest.raises(RuntimeError, match=where):
            build(GPTConfig(**SIZE), pcfg)


def test_zero_bubble_and_manual_ep_entries_name_their_slices():
    """The zero-bubble manual-tp and manual-ep entries are ported and check
    their shapes as the reference does; the manual-ep FFN over a group of
    one is the one-device FFN."""
    import torch
    from paddle_tpu_torch.distributed.env import Group
    with pytest.raises(ValueError, match="num_heads 4 % tp 3"):
        TMT.train_grads_zb_manual_tp(
            {}, (np.zeros((2, 6)),) * 2, GPTConfig(**SIZE),
            TH.ParallelConfig(tp=3, pp=2, pp_schedule="zbh1"))
    with pytest.raises(ValueError, match="num_experts 3 % dp 2"):
        TMT.train_grads_zb_manual_ep(
            {}, (np.zeros((2, 6)),) * 2, GPTConfig(**SIZE),
            TH.ParallelConfig(dp=2, pp=2, num_experts=3,
                              pp_schedule="zbh1"))
    g = torch.Generator().manual_seed(0)
    lp = {"gate_w": torch.randn(8, 2, generator=g),
          "fc1_w": torch.randn(2, 8, 16, generator=g),
          "fc1_b": torch.randn(2, 16, generator=g),
          "fc2_w": torch.randn(2, 16, 8, generator=g),
          "fc2_b": torch.randn(2, 8, generator=g)}
    x = torch.randn(2, 3, 8, generator=g)
    pcfg = TH.ParallelConfig(num_experts=2, remat=False)
    torch.testing.assert_close(
        TMT.moe_ffn_manual_ep(x, lp, 2, Group(0, [0]), pcfg),
        TH._moe_ffn(x, lp, pcfg))


def test_tp_needs_a_process_group_of_dp_x_tp_ranks():
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        TH.setup(GPTConfig(**SIZE), TH.ParallelConfig(tp=2), device="cpu")
