"""The PyTorch port's GPT training step (paddle_tpu_torch.models.gpt_hybrid)
against the JAX reference (paddle_tpu.models.gpt_hybrid) on the CPU: step-0
loss and every gradient leaf, a three-step trajectory, gradient merge, a
bf16 run, remat, the slice's attention kernels inside the step, and the
attention dispatch counters.

Both sides get the reference's own parameters (jax draws, brought over by
params_from_jax) and the same numpy token ids. The tiny config has h=128
with 2 heads, so D=64, a head size the Hopper gate admits on the card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt_hybrid as GH
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.ops.pallas import blocked_flash as jbf
from paddle_tpu.ops.pallas import causal_attention as jca
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.ops.hopper import blocked_flash as tbf
from paddle_tpu_torch.ops.hopper import causal_attention as tca
from paddle_tpu_torch.ops.hopper import flash_attention as tfa
from paddle_tpu_torch.ops.hopper import simple_attention as tsa

SIZE = dict(vocab_size=256, hidden_size=128, num_layers=2, num_heads=2,
            max_seq_len=64)
JCFG, TCFG = JaxGPTConfig(**SIZE), GPTConfig(**SIZE)
B, S = 4, 64
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pcfgs(**kw):
    """The same ParallelConfig for both sides (torch and jax dtypes)."""
    kw.setdefault("param_dtype", torch.float32)
    kw.setdefault("compute_dtype", torch.float32)
    jkw = {k: _JDT.get(v, v) if k.endswith("dtype") else v
           for k, v in kw.items()}
    return GH.ParallelConfig(**jkw), TH.ParallelConfig(**kw)


def _ids(seed=0, b=B, s=S):
    return np.random.RandomState(seed).randint(0, SIZE["vocab_size"],
                                               (b, s)).astype(np.int32)


# The slice's tiers in the tiny model: at D=64, S=256 takes
# causal_attention's kernel (nq=2) and S=384 blocked_flash's (blocks of 128).
SLICE_S = {"simple": S, "causal_skip": 256, "blocked": 384}


def _cfgs(tier):
    """The tiny config (jax, torch) at the tier's sequence length."""
    size = dict(SIZE, max_seq_len=SLICE_S[tier])
    return JaxGPTConfig(**size), GPTConfig(**size)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x), tree)


def _flat(tree):
    """Leaves as numpy f32 in the port's _leaves order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().float().numpy()]
    return [np.asarray(tree, dtype=np.float32)]


def _names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], prefix + k + ".")]
    return [prefix[:-1]]


def _assert_leaves_close(got, want, rel, what, atol=0.0):
    """max |got - want| <= rel * max |want| + atol per leaf (a leaf-scale
    tolerance: near-zero elements carry no meaning of their own)."""
    for name, g, w in zip(_names(want), _flat(got), _flat(want)):
        assert g.shape == w.shape, (what, name)
        err = float(np.max(np.abs(g - w)))
        scale = float(np.max(np.abs(w))) or 1.0
        assert err <= rel * scale + atol, \
            f"{what} {name}: {err} > {rel} * {scale} + {atol}"


def _jax_value_and_grad(jpcfg, params, ids, jcfg=JCFG):
    mesh = GH.build_mesh(jpcfg, jax.devices()[:1])
    batch = (jnp.asarray(ids), jnp.asarray(ids))
    loss, grads = jax.value_and_grad(
        lambda p: GH.loss_fn(p, batch, jcfg, jpcfg, mesh))(params)
    return float(loss), _np_tree(grads)


def _torch_value_and_grad(tpcfg, np_params, ids, tcfg=TCFG):
    params = TH.params_from_jax(np_params, device="cpu")
    leaves = TH._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ids_t = torch.from_numpy(ids).long()
    loss = TH.loss_fn(params, (ids_t, ids_t), tcfg, tpcfg)
    grads = torch.autograd.grad(loss, leaves)
    tree, it = {}, iter(grads)

    def fill(src, dst):
        for k in sorted(src):
            if isinstance(src[k], dict):
                dst[k] = {}
                fill(src[k], dst[k])
            else:
                dst[k] = next(it)
    fill(params, tree)
    return float(loss.detach()), tree


# f32 on both sides: the sums run in another order, so gradients agree to
# rounding level; 2e-5 of each leaf's scale leaves room for that and for
# nothing more.
@pytest.mark.parametrize("fused_ce", [True, False])
@pytest.mark.parametrize("remat,policy", [(False, "full"), (True, "full"),
                                          (True, "names"), (True, "dots")])
def test_step0_loss_and_grads_match_reference(fused_ce, remat, policy):
    jp, tp = _pcfgs(fused_ce=fused_ce, remat=remat, remat_policy=policy)
    params = _np_tree(GH.init_params(JCFG, jp, jax.random.PRNGKey(0)))
    ids = _ids()
    jloss, jgrads = _jax_value_and_grad(jp, params, ids)
    tloss, tgrads = _torch_value_and_grad(tp, params, ids)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_leaves_close(tgrads, jgrads, 2e-5, "grad")


def test_forward_logits_match_reference():
    jp, tp = _pcfgs(remat=False)
    params = _np_tree(GH.init_params(JCFG, jp, jax.random.PRNGKey(1)))
    ids = _ids(seed=5)
    mesh = GH.build_mesh(jp, jax.devices()[:1])
    want = np.asarray(GH.forward(params, jnp.asarray(ids), JCFG, jp, mesh))
    got = TH.forward(TH.params_from_jax(params, device="cpu"),
                     torch.from_numpy(ids).long(), TCFG, tp)
    assert got.shape == want.shape == (B, S, SIZE["vocab_size"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _trajectory(jp, tp, steps, b=B):
    """Runs both setups' steps from the reference's params; returns the
    losses and the final (params, moments) of each side."""
    mesh, jparams, jopt, jstep = GH.setup(JCFG, jp, seed=0,
                                          devices=jax.devices()[:1])
    start = _np_tree(jparams)
    tparams = TH.params_from_jax(start, device="cpu")
    topt = TH.adamw_init(tparams, tp)
    tstep = TH.build_train_step(TCFG, tp)
    jl, tl = [], []
    with mesh:
        for i in range(steps):
            ids = _ids(seed=i, b=b)
            jparams, jopt, loss = jstep(jparams, jopt,
                                        (jnp.asarray(ids), jnp.asarray(ids)))
            jl.append(float(loss))
            ids_t = torch.from_numpy(ids).long()
            tparams, topt, loss = tstep(tparams, topt, (ids_t, ids_t))
            tl.append(float(loss))
    assert topt["step"] == int(jopt["step"]) == steps
    return jl, tl, (_np_tree(jparams), _np_tree(jopt["m"]),
                    _np_tree(jopt["v"])), (tparams, topt["m"], topt["v"])


# Adam's step is lr * m / (sqrt(v) + eps). Where a gradient is zero in
# exact arithmetic (the key bias: softmax ignores a shift shared by all
# keys), both sides hold rounding noise |g| < 1e-9 and Adam turns it into
# a step of up to lr * |g| / eps < 0.1 lr, different on each side; params
# are held to that (ADAM_NOISE) beside 1e-4 of each leaf's scale.
LR = 3e-4
ADAM_NOISE = 0.1 * LR


def test_three_step_trajectory_matches_reference():
    jp, tp = _pcfgs(remat=True, remat_policy="names", fused_ce=True)
    jl, tl, (jp_, jm, jv), (tp_, tm, tv) = _trajectory(jp, tp, steps=3)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    _assert_leaves_close(tp_, jp_, 1e-4, "params", atol=3 * ADAM_NOISE)
    _assert_leaves_close(tm, jm, 1e-4, "m")
    _assert_leaves_close(tv, jv, 1e-4, "v")


def test_gradient_merge_matches_reference():
    jp, tp = _pcfgs(remat=False, gradient_merge_steps=2)
    jl, tl, (jp_, jm, _), (tp_, tm, _) = _trajectory(jp, tp, steps=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_leaves_close(tp_, jp_, 1e-4, "params", atol=2 * ADAM_NOISE)
    _assert_leaves_close(tm, jm, 1e-4, "m")


# bf16 params and compute: the frameworks round at other places (XLA fuses
# elementwise chains and may skip intermediate bf16 roundings), so the
# loss is held to 1% and to having moved the same way after two steps.
def test_bf16_step_loss_close_to_reference():
    jp, tp = _pcfgs(remat=True, remat_policy="names", fused_ce=True,
                    param_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16)
    jl, tl, _, (tparams, tm, _) = _trajectory(jp, tp, steps=2)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert all(np.isfinite(tl))
    assert tparams["wte"].dtype == torch.bfloat16
    assert tm["wte"].dtype == torch.bfloat16     # moment_dtype=None inherits


def test_setup_on_cpu_runs_and_learns():
    _, tp = _pcfgs(remat=True, remat_policy="names")
    params, opt, step = TH.setup(TCFG, tp, seed=0, device="cpu")
    ids = torch.from_numpy(_ids()).long()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert losses[-1] < losses[0]
    assert abs(losses[0] - np.log(SIZE["vocab_size"])) < 0.5


@pytest.mark.parametrize("bad", [dict(dp=2), dict(tp=2), dict(pp=2),
                                 dict(sp=True), dict(num_experts=4),
                                 dict(collective_matmul=True)])
def test_multi_device_configs_raise(bad):
    _, tp = _pcfgs(**bad)
    with pytest.raises(NotImplementedError):
        TH.build_train_step(TCFG, tp)


_TIER_MODULES = {"simple": (tsa, "simple_attention_reference"),
                 "causal_skip": (tca, "causal_attention_reference"),
                 "blocked": (tbf, "blocked_flash_reference")}


def _count_plain_attention(monkeypatch, tier="simple"):
    """Routes the CPU attention through the tier's registered Hopper op
    (whose CPU body is the plain version) and counts the plain forward's
    calls."""
    mod, plain_name = _TIER_MODULES[tier]
    calls = {"fwd": 0}
    plain = getattr(mod, plain_name)

    def counted(*a, **kw):
        calls["fwd"] += 1
        return plain(*a, **kw)

    def through_op(q, k, v, causal=False, scale=None):
        out = mod.attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 scale=scale)
        return out.transpose(1, 2)

    monkeypatch.setattr(mod, plain_name, counted)
    monkeypatch.setattr(TH, "flash_attention_maybe", through_op)
    return calls


# "names" keeps the attention op's outputs (o, and lse for the new tiers),
# so a forward + backward runs the attention forward once per layer; "full"
# and "dots" run it again in the recompute.
_POLICIES = (("names", 1), ("full", 2), ("dots", 2))


@pytest.mark.parametrize("policy,per_layer,tier", [
    *(pytest.param(p, n, "simple", id=f"{p}-{n}") for p, n in _POLICIES),
    *(pytest.param(p, n, t, id=f"{p}-{n}-{t}")
      for t in ("causal_skip", "blocked") for p, n in _POLICIES)])
def test_remat_policy_decides_attention_recompute(monkeypatch, policy,
                                                  per_layer, tier):
    calls = _count_plain_attention(monkeypatch, tier)
    jcfg, tcfg = _cfgs(tier)
    jp, tp = _pcfgs(remat=True, remat_policy=policy)
    params = _np_tree(GH.init_params(jcfg, jp, jax.random.PRNGKey(0)))
    ids = _ids(b=2, s=SLICE_S[tier])
    tloss, tgrads = _torch_value_and_grad(tp, params, ids, tcfg)
    assert calls["fwd"] == per_layer * SIZE["num_layers"]
    # the op's plain path is the reference's attention: values unchanged
    jloss, jgrads = _jax_value_and_grad(jp, params, ids, jcfg)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_leaves_close(tgrads, jgrads, 2e-5, "grad")


def _route_jax_attention(monkeypatch, tier):
    """Sends the reference's attention through the tier's Pallas kernel in
    interpret mode (it returns None off a TPU); no file of it changes."""
    kernel = {"causal_skip": jca, "blocked": jbf}[tier]

    def through_kernel(q, k, v, causal=False, scale=None):
        out = kernel.attention_bhsd(
            *(jnp.swapaxes(x, 1, 2) for x in (q, k, v)), causal=causal,
            scale=scale, interpret=True)
        return jnp.swapaxes(out, 1, 2)

    monkeypatch.setattr(jfa, "flash_attention_maybe", through_kernel)


# The slice as a whole: both steps' attention runs the tier's kernel (the
# reference's in interpret mode, the port's op on its CPU body), under the
# rungs' remat "names"; the f32 tolerances of the step-0 test above.
@pytest.mark.parametrize("tier", ["causal_skip", "blocked"])
def test_slice_step0_loss_and_grads_through_the_rung_kernels(monkeypatch,
                                                             tier):
    _route_jax_attention(monkeypatch, tier)
    calls = _count_plain_attention(monkeypatch, tier)
    jcfg, tcfg = _cfgs(tier)
    jp, tp = _pcfgs(remat=True, remat_policy="names", fused_ce=True)
    params = _np_tree(GH.init_params(jcfg, jp, jax.random.PRNGKey(3)))
    ids = _ids(seed=7, b=2, s=SLICE_S[tier])
    jloss, jgrads = _jax_value_and_grad(jp, params, ids, jcfg)
    tloss, tgrads = _torch_value_and_grad(tp, params, ids, tcfg)
    assert calls["fwd"] == SIZE["num_layers"]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_leaves_close(tgrads, jgrads, 2e-5, "grad")


def test_dispatch_on_cpu_returns_none_and_counts_nothing():
    tfa.reset_dispatch_counts()
    q = torch.zeros(1, 128, 2, 64)
    assert tfa.flash_attention_maybe(q, q, q, causal=True) is None
    assert not tfa.DISPATCH_COUNTS


@pytest.mark.parametrize("shape,dtype,reason", [
    ((1, 128, 2, 48), torch.bfloat16, "head_dim"),
    ((1, 96, 2, 64), torch.bfloat16, "seq_len"),
    ((1, 128, 2, 64), torch.float16, "dtype"),
])
def test_dispatch_gate_rejects_count_fallback(shape, dtype, reason):
    # meta tensors stand for device tensors: dispatch reads only shapes
    tfa.reset_dispatch_counts()
    q = torch.empty(shape, dtype=dtype, device="meta")
    assert tfa._dispatch(q, q, q, True, None) is None
    assert tfa.DISPATCH_COUNTS == {("attn.dispatch_fallback", reason): 1}


def test_dispatch_picks_simple_and_never_falls_back():
    tfa.reset_dispatch_counts()
    q = torch.empty(1, 1024, 2, 128, dtype=torch.bfloat16, device="meta")
    out = tfa._dispatch(q, q, q, True, None)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert tfa.DISPATCH_COUNTS == {("attn.dispatch", "simple"): 1}


@pytest.mark.parametrize("s,causal,tier", [(2048, False, "qblock")])
def test_dispatch_raises_for_unported_tiers(s, causal, tier):
    q = torch.empty(1, s, 2, 128, dtype=torch.bfloat16, device="meta")
    with pytest.raises(NotImplementedError, match=tier):
        tfa._dispatch(q, q, q, causal, None)


# The rungs' attention shapes, [B, S, H, D]: train_s2048 and train_s4096.
@pytest.mark.parametrize("shape,tier", [((4, 2048, 8, 128), "causal_skip"),
                                        ((2, 4096, 8, 128), "blocked")])
def test_dispatch_sends_the_rungs_to_their_kernels(shape, tier):
    tfa.reset_dispatch_counts()
    q = torch.empty(shape, dtype=torch.bfloat16, device="meta")
    out = tfa._dispatch(q, q, q, True, None)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert tfa.DISPATCH_COUNTS == {("attn.dispatch", tier): 1}


# What the reference sends to JAX's own library kernel: a head dim that
# blocked_flash's gate refuses, and causal attention with Sq != Skv.
@pytest.mark.parametrize("q_shape,kv_len", [((1, 4096, 2, 192), 4096),
                                            ((1, 2048, 2, 128), 4096)])
def test_dispatch_raises_where_no_hopper_kernel_takes_the_shape(q_shape,
                                                                kv_len):
    tfa.reset_dispatch_counts()
    q = torch.empty(q_shape, dtype=torch.bfloat16, device="meta")
    k = torch.empty(q_shape[0], kv_len, *q_shape[2:], dtype=torch.bfloat16,
                    device="meta")
    with pytest.raises(NotImplementedError, match="library_flash"):
        tfa._dispatch(q, k, k, True, None)
    assert not tfa.DISPATCH_COUNTS
