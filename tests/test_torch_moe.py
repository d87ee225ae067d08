"""The port's MoE (paddle_tpu_torch.models.moe, and gpt_hybrid with
num_experts > 0 and its split gradient accumulation) against the JAX
reference on the CPU.

Both sides get the reference's own parameters (through numpy) and the same
seeded numpy inputs. Everything runs in f32, where the two frameworks do
the same arithmetic in another order: outputs, losses and gradients are
held to a few f32 roundings of each tensor's scale, stated per test.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.models import gpt_hybrid as GH
from paddle_tpu.models import moe as jmoe
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models import moe as tmoe
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch._testing import numpy_initializers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

JCFG, TCFG = JaxGPTConfig.tiny(), GPTConfig.tiny()
B, S, E = 4, 32, 2
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port.set_device("cpu")


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


# ------------------------------------------------------------- MoELayer
def _moe_pair(gate, top_k):
    ref.seed(0)
    with numpy_initializers(jax):
        jl = jmoe.MoELayer(32, 64, num_experts=4, top_k=top_k, gate=gate)
    tl = tmoe.MoELayer(32, 64, num_experts=4, top_k=top_k, gate=gate)
    tl.set_state_dict({k: v.numpy() for k, v in jl.state_dict().items()})
    return jl, tl


# f32, the same arithmetic in another order: 1e-5 of each tensor's scale.
@pytest.mark.parametrize("gate,top_k", [("gshard", 2), ("switch", 1)])
def test_moe_layer_matches_reference(gate, top_k):
    jl, tl = _moe_pair(gate, top_k)
    assert tl.gate.top_k == jl.gate.top_k == (1 if gate == "switch" else 2)
    # 21 tokens over 4 experts: the experts' token shares cannot all be
    # equal, so the aux loss gives the gate a gradient under switch, whose
    # renormalised combine is exactly 1 and gives it none
    x = np.random.RandomState(1).randn(3, 7, 32).astype(np.float32)
    w = np.random.RandomState(2).randn(3, 7, 32).astype(np.float32)
    jx = ref.to_tensor(x, stop_gradient=False)
    tx = port.to_tensor(x, stop_gradient=False)
    jo, to = jl(jx), tl(tx)
    assert _rel(to.numpy(), jo.numpy()) < 1e-5
    assert abs(float(tl.aux_loss) - float(jl.aux_loss)) < \
        1e-6 * abs(float(jl.aux_loss))
    ((jo * ref.to_tensor(w)).sum() + jl.aux_loss).backward()
    ((to * port.to_tensor(w)).sum() + tl.aux_loss).backward()
    assert _rel(tx.grad.numpy(), jx.grad.numpy()) < 1e-5
    jp, tp = dict(jl.named_parameters()), dict(tl.named_parameters())
    assert sorted(jp) == sorted(tp)
    for name in jp:
        assert _rel(tp[name].grad.numpy(), jp[name].grad.numpy()) < 1e-5, \
            name


def test_topk_gate_dispatch_and_combine_match_reference():
    jl, tl = _moe_pair("gshard", 2)
    x = np.random.RandomState(3).randn(16, 32).astype(np.float32)
    jd, jc, ja = jl.gate(ref.to_tensor(x))
    td, tc, ta = tl.gate(port.to_tensor(x))
    np.testing.assert_array_equal(td.numpy(), jd.numpy())
    assert td.numpy().sum(-1).tolist() == [2.0] * 16
    np.testing.assert_allclose(tc.numpy(), jc.numpy(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tc.numpy().sum(-1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_moe_transformer_block_matches_reference():
    ref.seed(0)
    with numpy_initializers(jax):
        jb = jmoe.MoETransformerBlock(32, 4, 64, num_experts=2)
    tb = tmoe.MoETransformerBlock(32, 4, 64, num_experts=2)
    tb.set_state_dict({k: v.numpy() for k, v in jb.state_dict().items()})
    x = np.random.RandomState(4).randn(2, 8, 32).astype(np.float32)
    assert _rel(tb(port.to_tensor(x)).numpy(),
                jb(ref.to_tensor(x)).numpy()) < 1e-5


# ------------------------------------------------ gpt_hybrid with experts
def _pcfgs(**kw):
    kw.setdefault("num_experts", E)
    kw.setdefault("param_dtype", torch.float32)
    kw.setdefault("compute_dtype", torch.float32)
    jkw = {k: _JDT.get(v, v) if k.endswith("dtype") else v
           for k, v in kw.items()}
    return GH.ParallelConfig(**jkw), TH.ParallelConfig(**kw)


def _ids(seed=0, b=B):
    return np.random.RandomState(seed).randint(
        0, JCFG.vocab_size, (b, S)).astype(np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    """(name, numpy f32) leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       prefix + k + ".")]
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().float().numpy()
    return [(prefix[:-1], np.asarray(tree, np.float32))]


def _assert_trees_close(got, want, rel, what, atol=0.0):
    """max |got - want| <= rel * max |want| + atol, leaf by leaf."""
    g, w = _flat(got), _flat(want)
    assert [n for n, _ in g] == [n for n, _ in w]
    for (name, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (what, name)
        err = float(np.abs(a - b).max())
        scale = float(np.abs(b).max()) or 1.0
        assert err <= rel * scale + atol, \
            f"{what} {name}: {err} > {rel} * {scale} + {atol}"


def test_moe_params_have_the_reference_leaves():
    jp, tp = _pcfgs()
    want = GH.init_params(JCFG, jp, jax.random.PRNGKey(0))
    got = TH.init_params(TCFG, tp, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in
            _np_tree(want)["blocks"].items()} == \
        {k: (tuple(v.shape), np.float32) for k, v in got["blocks"].items()}
    assert got["blocks"]["fc1_w"].shape == (2, E, 64, 256)
    # the reference's distributions: std 0.02, fc2 scaled by 1/sqrt(2L)
    for k, std in (("gate_w", 0.02), ("fc1_w", 0.02),
                   ("fc2_w", 0.02 / np.sqrt(4))):
        assert abs(float(got["blocks"][k].std()) - std) < 0.15 * std, k
    assert float(got["blocks"]["fc1_b"].abs().max()) == 0.0
    # the new leaves cross over with the others
    moved = TH.params_from_jax(_np_tree(want), device="cpu")
    eager = TH.eager_params_from_jax(_np_tree(want), device="cpu")
    for k in ("gate_w", "fc1_w", "fc1_b", "fc2_w", "fc2_b"):
        np.testing.assert_array_equal(moved["blocks"][k].numpy(),
                                      np.asarray(want["blocks"][k]))
        np.testing.assert_array_equal(eager["blocks"][k].numpy(),
                                      np.asarray(want["blocks"][k]))


def _jax_value_and_grad(jpcfg, params, ids):
    """The reference's loss and gradients, compiled as one program (run op
    by op it compiles a kernel an op shape)."""
    mesh = GH.build_mesh(jpcfg, jax.devices()[:1])
    batch = (jnp.asarray(ids), jnp.asarray(ids))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: GH.loss_fn(p, batch, JCFG, jpcfg, mesh)))(params)
    return float(loss), _np_tree(grads)


def _unflatten(like, leaves):
    it = iter(leaves)

    def fill(src):
        return {k: fill(src[k]) if isinstance(src[k], dict) else next(it)
                for k in sorted(src)}
    return fill(like)


def _torch_value_and_grad(tpcfg, np_params, ids):
    params = TH.params_from_jax(np_params, device="cpu")
    ids_t = torch.from_numpy(ids).long()
    loss, grads = TH._value_and_grad(params, (ids_t, ids_t), TCFG, tpcfg)
    return float(loss), _unflatten(params, grads)


# f32 on both sides: 2e-5 of each gradient leaf's scale, as the dense
# step's test holds.
@pytest.mark.parametrize("fused_ce", [True, False])
@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "names"), (True, "dots")])
def test_moe_step0_loss_and_grads_match_reference(fused_ce, remat, policy):
    jp, tp = _pcfgs(fused_ce=fused_ce, remat=remat, remat_policy=policy)
    params = _np_tree(GH.init_params(JCFG, jp, jax.random.PRNGKey(0)))
    ids = _ids()
    jloss, jgrads = _jax_value_and_grad(jp, params, ids)
    tloss, tgrads = _torch_value_and_grad(tp, params, ids)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_trees_close(tgrads, jgrads, 2e-5, "grad")
    # every expert got tokens, so every MoE leaf has a gradient
    for k in ("gate_w", "fc1_w", "fc2_w"):
        assert float(np.abs(tgrads["blocks"][k].numpy()).max()) > 0, k


@pytest.mark.parametrize("policy,saved", [
    ("names", {"qkv"}), ("dots", None)])
def test_names_policy_saves_no_moe_product(policy, saved):
    """Under "names" the MoE block's addmm calls are qkv and proj only:
    nothing of the MoE FFN is named, so nothing of it is saved; under
    "dots" every product is."""
    from torch.utils.checkpoint import CheckpointPolicy
    _, tp = _pcfgs(remat=True, remat_policy=policy)
    policy_fn = TH._policy(tp)

    class _Ctx:
        is_recompute = False
    addmm = torch.ops.aten.addmm.default
    got = [policy_fn(_Ctx(), addmm) for _ in range(2)]
    want = [CheckpointPolicy.MUST_SAVE if saved is None or name in saved
            else CheckpointPolicy.PREFER_RECOMPUTE
            for name in ("qkv", "proj")]
    assert got == want
    for op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        assert policy_fn(_Ctx(), op) == (
            CheckpointPolicy.MUST_SAVE if saved is None
            else CheckpointPolicy.PREFER_RECOMPUTE)


# Adam turns rounding noise in an exactly-zero gradient into a step of up
# to 0.1 lr (tests/test_torch_gpt_train.py says why): params are held to
# that beside 1e-4 of each leaf's scale.
LR = 3e-4
ADAM_NOISE = 0.1 * LR


def test_moe_three_step_trajectory_matches_reference():
    jp, tp = _pcfgs(remat=True, remat_policy="names")
    mesh, jparams, jopt, jstep = GH.setup(JCFG, jp, seed=0,
                                          devices=jax.devices()[:1])
    tparams = TH.params_from_jax(_np_tree(jparams), device="cpu")
    topt = TH.adamw_init(tparams, tp)
    tstep = TH.build_train_step(TCFG, tp)
    jl, tl = [], []
    with mesh:
        ids = _ids()            # one batch, three times: the loss falls
        for _ in range(3):
            jparams, jopt, loss = jstep(jparams, jopt, (jnp.asarray(ids),
                                                        jnp.asarray(ids)))
            jl.append(float(loss))
            ids_t = torch.from_numpy(ids).long()
            tparams, topt, loss = tstep(tparams, topt, (ids_t, ids_t))
            tl.append(float(loss))
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _assert_trees_close(tparams, _np_tree(jparams), 1e-4, "params",
                        atol=3 * ADAM_NOISE)
    _assert_trees_close(topt["m"], _np_tree(jopt["m"]), 1e-4, "m")
    _assert_trees_close(topt["v"], _np_tree(jopt["v"]), 1e-4, "v")


def test_build_accum_steps_matches_reference():
    """k=2 chunks into the accumulator, then one apply: the accumulator,
    the chunks' losses and the updated params and moments agree, and the
    port's accumulator is the same tensors, zeroed, after the apply."""
    jp, tp = _pcfgs(remat=False)
    mesh, jparams, jopt, _ = GH.setup(JCFG, jp, seed=0,
                                      devices=jax.devices()[:1])
    tparams = TH.params_from_jax(_np_tree(jparams), device="cpu")
    topt = TH.adamw_init(tparams, tp)
    jgrad, japply = GH.build_accum_steps(JCFG, jp, mesh)
    tgrad, tapply = TH.build_accum_steps(TCFG, tp)
    jacc, tacc = GH.init_grad_accum(jparams), TH.init_grad_accum(tparams)
    acc_ids = [id(t) for _, t in _flat_tensors(tacc)]
    with mesh:
        for i in range(2):
            ids = _ids(seed=10 + i, b=2)
            jacc, jloss = jgrad(jparams, jacc, (jnp.asarray(ids),
                                                jnp.asarray(ids)))
            ids_t = torch.from_numpy(ids).long()
            tacc, tloss = tgrad(tparams, tacc, (ids_t, ids_t))
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=1e-5)
        _assert_trees_close(tacc, _np_tree(jacc), 2e-5, "acc")
        jparams, jopt, jacc = japply(jparams, jopt, jacc, 2)
    tparams, topt, tacc = tapply(tparams, topt, tacc, 2)
    _assert_trees_close(tparams, _np_tree(jparams), 1e-4, "params",
                        atol=ADAM_NOISE)
    _assert_trees_close(topt["m"], _np_tree(jopt["m"]), 1e-4, "m")
    assert topt["step"] == int(jopt["step"]) == 1
    assert [id(t) for _, t in _flat_tensors(tacc)] == acc_ids
    assert all(float(t.abs().max()) == 0.0 for _, t in _flat_tensors(tacc))
    assert all(float(np.abs(a).max()) == 0.0 for _, a in _flat(jacc))


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flat_tensors(tree[k], prefix + k + ".")]
    return [(prefix[:-1], tree)]


def test_accumulator_adds_in_its_own_dtype():
    """A bf16 accumulator over f32 params sums the gradients rounded to
    bf16, as the reference's a + g.astype(a.dtype)."""
    _, tp = _pcfgs(remat=False)
    params = TH.init_params(TCFG, tp, torch.Generator().manual_seed(0),
                            "cpu")
    acc = {k: ({kk: torch.zeros_like(vv, dtype=torch.bfloat16)
                for kk, vv in v.items()} if isinstance(v, dict)
               else torch.zeros_like(v, dtype=torch.bfloat16))
           for k, v in params.items()}
    grad_step, _ = TH.build_accum_steps(TCFG, tp)
    ids_t = torch.from_numpy(_ids(b=2)).long()
    acc, _ = grad_step(params, acc, (ids_t, ids_t))
    _, grads = TH._value_and_grad(params, (ids_t, ids_t), TCFG, tp)
    for (_, a), g in zip(_flat_tensors(acc), grads):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, g.to(torch.bfloat16))


@pytest.mark.parametrize("bad", [dict(dp=2), dict(tp=2), dict(pp=2),
                                 dict(sp=True),
                                 dict(collective_matmul=True)])
def test_moe_beside_a_multi_device_option_is_refused(bad):
    """The expert-parallel slice admits experts beside each option: without
    a process group the multi-rank ones ask for one and the one-rank ones
    build (tests/test_torch_gpt_hybrid_ep.py runs them on gloo ranks)."""
    _, tp = _pcfgs(**bad)
    for build in (TH.build_accum_steps, TH.build_train_step):
        if tp.dp * tp.pp * tp.tp == 1:
            assert build(TCFG, tp) is not None
            continue
        with pytest.raises(RuntimeError, match="init_parallel_env"):
            build(TCFG, tp)


def test_moe_setup_on_cpu_runs_and_learns():
    _, tp = _pcfgs(remat=True, remat_policy="names")
    params, opt, step = TH.setup(TCFG, tp, seed=0, device="cpu")
    ids = torch.from_numpy(_ids()).long()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert abs(losses[0] - np.log(TCFG.vocab_size)) < 0.5
