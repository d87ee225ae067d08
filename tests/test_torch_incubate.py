"""paddle_tpu_torch.incubate against paddle_tpu.incubate, on the CPU.

The same inputs from a numpy seed, at a few tokens and narrow widths, in
f32, through the reference's and the port's:

- the fused functions of ``incubate.nn.functional`` (within 1e-5 of each
  output's largest value): ``fused_rotary_position_embedding`` in both
  styles, from ``theta``, from tables and at ``position_ids`` (and its
  default style equal to ``models/llama.py``'s RoPE), ``fused_bias_act``,
  ``fused_linear`` and ``fused_linear_activation``, ``fused_dropout_add``
  and the dropout-carrying blocks with dropout off, ``fused_moe``, both
  branches of ``variable_length_memory_efficient_attention`` (``[B, H, S,
  D]`` with lengths, causal and masked; ``[B, S, H, D]`` without),
  ``fused_matmul_bias``, ``fused_feedforward`` pre- and post-LN,
  ``fused_bias_dropout_residual_layer_norm``, ``blha_get_max_len``; the
  three the reference refuses raise;
- ``asp``: the 2:4 masks equal the reference's numpy masks, ties
  included, ``prune_model`` and the decorated optimizer keep them;
- ``autograd``: jvp, vjp, Jacobian (batched too) and Hessian;
- ``LookAhead`` and ``ModelAverage`` over steps of SGD;
- the graph ``operators``, ``identity_loss``, and a Tensor through a
  ``multiprocessing`` Queue to a child process and back.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.core.tensor import Tensor as PTensor
from paddle_tpu_torch._testing import share_the_cores_fixture

TOL = 1e-5
PF = P.incubate.nn.functional
TF = T.incubate.nn.functional

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(out):
    if isinstance(out, (list, tuple)):
        return [None if o is None else _np(o) for o in out]
    return np.asarray(out.numpy())


def _jitted(fn, *arrays):
    """The reference's function compiled whole (``jax.jit``), as numpy."""
    def raw(*a):
        out = fn(*(PTensor._wrap(x) for x in a))
        if isinstance(out, tuple):
            return tuple(None if o is None else o._data for o in out)
        return out._data
    out = jax.jit(raw)(*(jnp.asarray(a) for a in arrays))
    if isinstance(out, tuple):
        return [None if o is None else np.asarray(o) for o in out]
    return np.asarray(out)


def _port(fn, *arrays):
    return _np(fn(*(T.to_tensor(a) for a in arrays)))


def _check(ref_fn, port_fn, *arrays, tol=TOL):
    want, got = _jitted(ref_fn, *arrays), _port(port_fn, *arrays)
    if isinstance(want, list):
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert _rel(g, w) <= tol
    else:
        assert _rel(got, want) <= tol


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


# ------------------------------------------------------ fused functions

@pytest.mark.parametrize("neox", [True, False])
@pytest.mark.parametrize("tables", ["theta", "sin_cos", "position_ids"])
def test_fused_rotary_position_embedding(neox, tables):
    q, k, v = (_rand(2, 6, 3, 8, seed=s) for s in (1, 2, 3))
    if tables == "sin_cos":
        ang = _rand(6, 8, seed=4)
        sin, cos = np.sin(ang), np.cos(ang)

        def call(mod, a, b, c, s_, c_):
            return mod.fused_rotary_position_embedding(
                a, b, c, sin=s_, cos=c_, use_neox_rotary_style=neox)
        _check(lambda *t: call(PF, *t), lambda *t: call(TF, *t), q, k, v,
               sin, cos)
        return
    pids = np.asarray([[0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 9]], np.int64)

    def call(mod, a, b, c, p=None):
        return mod.fused_rotary_position_embedding(
            a, b, c, position_ids=p, use_neox_rotary_style=neox,
            theta=500.0)
    if tables == "theta":
        _check(lambda *t: call(PF, *t), lambda *t: call(TF, *t), q, k, v)
    else:
        # the reference reads the positions' largest value on the host:
        # run it eagerly
        want = call(PF, *(P.to_tensor(a) for a in (q, k, v, pids)))
        got = call(TF, *(T.to_tensor(a) for a in (q, k, v, pids)))
        for g, w in zip(_np(got), _np(want)):
            assert _rel(g, w) <= TOL


def test_rope_default_style_is_the_llama_models():
    from paddle_tpu_torch.models.llama import apply_rotary_pos_emb
    q = T.to_tensor(_rand(2, 5, 4, 16, seed=5))
    fused, _, _ = TF.fused_rotary_position_embedding(q)
    np.testing.assert_allclose(fused.numpy(),
                               apply_rotary_pos_emb(q).numpy(), rtol=0,
                               atol=1e-6)


def test_fused_bias_act_linear_and_matmul_bias():
    x, w, b = _rand(3, 4, 8, seed=6), _rand(8, 5, seed=7), _rand(5, seed=8)
    xb = _rand(3, 4, 5, seed=9)
    for act in ("gelu", "silu", "relu"):
        _check(lambda a, c: PF.fused_bias_act(a, c, act_method=act),
               lambda a, c: TF.fused_bias_act(a, c, act_method=act), xb, b)
    _check(lambda a: PF.fused_bias_act(a), lambda a: TF.fused_bias_act(a),
           xb)
    _check(PF.fused_linear, TF.fused_linear, x, w, b)
    _check(lambda a, c: PF.fused_linear(a, c, transpose_weight=True),
           lambda a, c: TF.fused_linear(a, c, transpose_weight=True),
           x, np.ascontiguousarray(w.T))
    _check(lambda a, c, d: PF.fused_linear_activation(a, c, d, "silu"),
           lambda a, c, d: TF.fused_linear_activation(a, c, d, "silu"),
           x, w, b)
    y = _rand(3, 5, 8, seed=10)
    _check(lambda a, c, d: PF.fused_matmul_bias(a, c, d, transpose_y=True),
           lambda a, c, d: TF.fused_matmul_bias(a, c, d, transpose_y=True),
           x, y, np.zeros(5, np.float32) + b)
    _check(lambda a, c: PF.fused_matmul_bias(a, c, transpose_x=True),
           lambda a, c: TF.fused_matmul_bias(a, c, transpose_x=True),
           np.ascontiguousarray(x.transpose(0, 2, 1)), w)


def test_fused_dropout_blocks_with_dropout_off():
    x, y = _rand(2, 3, 8, seed=11), _rand(2, 3, 8, seed=12)
    _check(lambda a, c: PF.fused_dropout_add(a, c, 0.3, training=False),
           lambda a, c: TF.fused_dropout_add(a, c, 0.3, training=False),
           x, y)
    _check(lambda a, c: PF.fused_dropout_add(a, c, 0.0),
           lambda a, c: TF.fused_dropout_add(a, c, 0.0), x, y)
    w1, w2 = _rand(8, 16, seed=13), _rand(16, 8, seed=14)
    b1, b2 = _rand(16, seed=15), _rand(8, seed=16)
    s1, s2 = _rand(8, seed=17) + 1, _rand(8, seed=18) + 1
    for pre in (True, False):
        def ffn(mod, a, *p):
            return mod.fused_feedforward(
                a, p[0], p[1], p[2], p[3], p[4], p[5], p[4], p[5],
                activation="gelu", pre_layer_norm=pre, training=False)
        _check(lambda *t: ffn(PF, *t), lambda *t: ffn(TF, *t), x, w1, w2,
               b1, b2, s1, s2)

    def bdr(mod, a, c, bb, s, bt):
        return mod.fused_bias_dropout_residual_layer_norm(
            a, c, bb, s, bt, dropout_rate=0.2, training=False)
    _check(lambda *t: bdr(PF, *t), lambda *t: bdr(TF, *t), x, y, b2, s1, b2)


def test_fused_moe():
    rs = np.random.RandomState(19)
    e, h, m = 4, 8, 16
    args = [rs.randn(2, 5, h).astype(np.float32),
            rs.randn(h, e).astype(np.float32),
            (rs.randn(e, h, m) * 0.3).astype(np.float32),
            rs.randn(e, m).astype(np.float32) * 0.1,
            (rs.randn(e, m, h) * 0.3).astype(np.float32),
            rs.randn(e, h).astype(np.float32) * 0.1]
    for top_k, norm in ((2, True), (1, False)):
        _check(lambda *t: PF.fused_moe(*t, top_k=top_k,
                                       norm_topk_prob=norm),
               lambda *t: TF.fused_moe(*t, top_k=top_k,
                                       norm_topk_prob=norm), *args)


@pytest.mark.parametrize("case", ["lengths", "lengths_causal",
                                  "lengths_mask", "no_lengths"])
def test_variable_length_memory_efficient_attention(case):
    q, k, v = (_rand(2, 3, 8, 16, seed=s) for s in (20, 21, 22))
    lens = np.asarray([5, 8], np.int32)
    if case == "no_lengths":
        # the branch without lengths reads [B, S, H, D]
        q, k, v = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                   for a in (q, k, v))
        _check(lambda a, b, c: PF.variable_length_memory_efficient_attention(
                   a, b, c, causal=True),
               lambda a, b, c: TF.variable_length_memory_efficient_attention(
                   a, b, c, causal=True), q, k, v)
        return
    causal = case == "lengths_causal"
    if case == "lengths_mask":
        mask = np.random.RandomState(23).rand(2, 1, 8, 8) > 0.3
        mask[..., 0] = True

        def call(mod, a, b, c, ln, mk):
            return mod.variable_length_memory_efficient_attention(
                a, b, c, ln, ln, mask=mk, scale=0.3)
        _check(lambda *t: call(PF, *t), lambda *t: call(TF, *t), q, k, v,
               lens, mask)
    else:
        def call(mod, a, b, c, ln):
            return mod.variable_length_memory_efficient_attention(
                a, b, c, ln, causal=causal)
        _check(lambda *t: call(PF, *t), lambda *t: call(TF, *t), q, k, v,
               lens)
        got = _port(lambda *t: call(TF, *t), q, k, v, lens)
        assert not got[0, :, 5:].any()          # padded query rows are 0


def test_blha_get_max_len_and_the_refusals():
    enc = np.asarray([3, 9, 4], np.int32)
    dec = np.asarray([0, 2, 7], np.int32)
    _check(lambda a, b: PF.blha_get_max_len(a, b, 3),
           lambda a, b: TF.blha_get_max_len(a, b, 3), enc, dec)
    with pytest.raises(NotImplementedError, match="MultiHeadAttention"):
        TF.fused_multi_head_attention(None, None, None)
    with pytest.raises(NotImplementedError,
                       match="scaled_dot_product_attention"):
        TF.block_multihead_attention(*([None] * 6))
    with pytest.raises(NotImplementedError, match="to_static"):
        TF.fused_multi_transformer(None, None, None, None, None)
    names = {n for n in dir(PF) if not n.startswith("_")
             and callable(getattr(PF, n)) and getattr(
                 getattr(PF, n), "__module__", "") == PF.__name__}
    assert names <= set(TF.__all__), names - set(TF.__all__)


# ------------------------------------------------------------------ asp

def test_asp_masks_are_the_references_ties_included():
    from paddle_tpu.incubate.asp import _mask_2_4 as ref_mask
    from paddle_tpu_torch.incubate.asp import _mask_2_4 as port_mask
    rs = np.random.RandomState(24)
    # values on a coarse grid: many equal magnitudes in a group of 4
    w = (rs.randint(-3, 4, (16, 10)) * 0.25).astype(np.float32)
    w[0, :4] = [0.5, -0.5, 0.5, 0.5]
    w[1, :4] = 0.0
    for shape in ((16, 10), (5, 7)):
        a = np.ascontiguousarray(w[:shape[0], :shape[1]])
        np.testing.assert_array_equal(
            port_mask(T.to_tensor(a)._data).numpy(), ref_mask(a))
        np.testing.assert_array_equal(
            port_mask(T.to_tensor(a, dtype="bfloat16")._data).numpy(),
            ref_mask(a))


def test_asp_prune_model_and_decorate():
    import paddle_tpu.incubate.asp as pasp
    import paddle_tpu_torch.incubate.asp as tasp
    rs = np.random.RandomState(25)
    ws = {"0.weight": rs.randn(8, 12).astype(np.float32),
          "0.bias": rs.randn(12).astype(np.float32),
          "2.weight": rs.randn(12, 4).astype(np.float32),
          "2.bias": rs.randn(4).astype(np.float32)}
    ref = P.nn.Sequential(P.nn.Linear(8, 12), P.nn.ReLU(),
                          P.nn.Linear(12, 4))
    port = T.nn.Sequential(T.nn.Linear(8, 12), T.nn.ReLU(),
                           T.nn.Linear(12, 4))
    ref.set_state_dict({k: P.to_tensor(v) for k, v in ws.items()})
    port.set_state_dict({k: T.to_tensor(v) for k, v in ws.items()})
    pm, tm = pasp.prune_model(ref), tasp.prune_model(port)
    assert len(pm) == len(tm) == 2
    for name in ("0.weight", "2.weight"):
        got = port.state_dict()[name].numpy()
        np.testing.assert_array_equal(got, ref.state_dict()[name].numpy())
        assert tasp.calculate_density(port.state_dict()[name]) == 0.5
    x = rs.randn(6, 8).astype(np.float32)
    opt = tasp.decorate(T.optimizer.SGD(0.1, parameters=port.parameters()))
    ropt = pasp.decorate(P.optimizer.SGD(0.1, parameters=ref.parameters()))
    for _ in range(2):
        for model, o, mod in ((port, opt, T), (ref, ropt, P)):
            loss = (model(mod.to_tensor(x)) ** 2).mean()
            o.clear_grad()
            loss.backward()
            o.step()
    for name in ("0.weight", "2.weight"):
        got = port.state_dict()[name].numpy()
        assert _rel(got, ref.state_dict()[name].numpy()) <= TOL
        assert (got[ref.state_dict()[name].numpy() == 0] == 0).all()


# ------------------------------------------------------------- autograd

def test_autograd_jvp_vjp_jacobian_hessian():
    """The reference's transforms compiled whole (they trace the function
    through jax.jvp/vjp/jacrev/hessian either way)."""
    import paddle_tpu.incubate.autograd as pag
    import paddle_tpu_torch.incubate.autograd as tag
    x, y = _rand(3, seed=26), _rand(3, seed=27)
    v = [_rand(3, seed=28), _rand(3, seed=29)]
    xb = _rand(2, 3, seed=30)

    def f(mod):
        return lambda a, b: (mod.tanh(a) * b, (a * a).sum() + b)

    def g(mod):
        return lambda a: mod.tanh(a) * a.sum()

    def h(mod):
        return lambda a: (mod.tanh(a) * a).sum()

    def run(ag, mod, xa, ya, v0, v1, xba):
        outs = []
        for part in (ag.jvp(f(mod), [xa, ya]) + ag.vjp(f(mod), [xa, ya])
                     + ag.vjp(f(mod), [xa, ya], [v0, v1])):
            outs += part
        for batched in (False, True):
            jac = ag.Jacobian(g(mod), [xba], is_batched=batched)
            outs += [jac[:], jac[1]]
        hess = ag.Hessian(h(mod), [xa])
        assert tuple(jac.shape) == (2, 3, 2, 3)
        assert tuple(hess.shape) == (3, 3)
        return tuple(outs + [hess[:]])

    want = _jitted(lambda *a: run(pag, P, *a), x, y, *v, xb)
    got = _np(run(tag, T, *(T.to_tensor(a) for a in (x, y, *v, xb))))
    assert len(got) == len(want) == 17
    for gt, wt in zip(got, want):
        assert _rel(gt, wt) <= TOL
    tag.enable_prim()
    assert tag.prim_enabled()
    tag.disable_prim()
    assert not tag.prim_enabled()
    assert tag.forward_grad is tag.jvp


# ---------------------------------------------------------- optimizers

def test_lookahead_and_model_average_over_steps():
    rs = np.random.RandomState(31)
    w0, b0 = rs.randn(4, 3).astype(np.float32), rs.randn(3).astype(
        np.float32)
    x = rs.randn(5, 4).astype(np.float32)
    out = {}
    for mod in (P, T):
        lin = mod.nn.Linear(4, 3)
        lin.set_state_dict({"weight": mod.to_tensor(w0),
                            "bias": mod.to_tensor(b0)})
        la = mod.incubate.LookAhead(mod.optimizer.SGD(
            learning_rate=0.1, parameters=lin.parameters()), alpha=0.5, k=2)
        ma = mod.incubate.ModelAverage(0.15, parameters=lin.parameters())
        for _ in range(5):
            loss = (lin(mod.to_tensor(x)) ** 2).mean()
            la.clear_grad()
            loss.backward()
            la.step()
            ma.step()
        trained = lin.weight.numpy().copy()
        ma.apply()
        averaged = lin.weight.numpy().copy()
        ma.restore()
        out[mod] = (trained, averaged, lin.weight.numpy().copy())
    for got, want in zip(out[T], out[P]):
        assert _rel(got, want) <= TOL
    np.testing.assert_array_equal(out[T][2], out[T][0])


# ------------------------------------------------- operators and the rest

def test_graph_operators():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    src = np.asarray([0, 1, 2, 3, 5, 5])
    dst = np.asarray([1, 2, 1, 4, 0, 4])
    for pool in ("sum", "mean", "max"):
        want = P.incubate.graph_send_recv(P.to_tensor(x), P.to_tensor(src),
                                          P.to_tensor(dst), pool_type=pool)
        got = T.incubate.graph_send_recv(T.to_tensor(x), T.to_tensor(src),
                                         T.to_tensor(dst), pool_type=pool)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    # a graph in CSC: row holds the sources, sorted by destination
    row = np.asarray([1, 2, 0, 3, 0, 1, 3, 2])
    colptr = np.asarray([0, 2, 4, 7, 8])
    nodes = np.asarray([2, 3])
    ref = P.incubate.graph_sample_neighbors(
        P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes))
    port = T.incubate.graph_sample_neighbors(
        T.to_tensor(row), T.to_tensor(colptr), T.to_tensor(nodes))
    for g, w in zip(port, ref):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    ref = P.incubate.graph_reindex(P.to_tensor(nodes), *ref)
    port = T.incubate.graph_reindex(T.to_tensor(nodes), *port)
    for g, w in zip(port, ref):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    ref = P.incubate.graph_khop_sampler(
        P.to_tensor(row), P.to_tensor(colptr), P.to_tensor(nodes), [-1, -1])
    port = T.incubate.graph_khop_sampler(
        T.to_tensor(row), T.to_tensor(colptr), T.to_tensor(nodes), [-1, -1])
    for g, w in zip(port, ref):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", 0, 1, 2])
def test_identity_loss(reduction):
    x = _rand(3, 4, seed=32)
    want = P.incubate.identity_loss(P.to_tensor(x), reduction)
    t = T.to_tensor(x, stop_gradient=False)
    got = T.incubate.identity_loss(t * 2, reduction)
    assert _rel(got.numpy(), 2 * want.numpy()) <= TOL
    got.sum().backward()
    np.testing.assert_allclose(
        t.grad.numpy(),
        np.full_like(x, 2.0 / x.size if reduction in ("mean", 1) else 2.0))
    with pytest.raises(ValueError):
        T.incubate.identity_loss(t, "bad")


def test_multiprocessing_sends_a_tensor_to_a_child_and_back():
    """A Tensor (f32, and bfloat16, which numpy lacks) through a Queue to a
    spawned process and back, with its stop_gradient and name."""
    import paddle_tpu_torch.incubate.multiprocessing as tmp
    from paddle_tpu_torch._testing import tensor_queue_child
    ctx = tmp.get_context("spawn")
    q_in, q_out = ctx.Queue(), ctx.Queue()
    t = T.to_tensor(_rand(2, 3, seed=33), stop_gradient=False)
    t.name = "w"
    half = T.to_tensor(_rand(4, seed=34), dtype="bfloat16")
    proc = ctx.Process(target=tensor_queue_child, args=(q_in, q_out))
    proc.start()
    q_in.put(t)
    q_in.put(half)
    back, sg, name, place, half_back = q_out.get(timeout=120)
    proc.join(timeout=60)
    assert not proc.is_alive() and proc.exitcode == 0
    assert isinstance(back, T.Tensor) and (sg, name) == (False, "w")
    assert "cpu" in place.lower()
    np.testing.assert_array_equal(back.numpy(), t.numpy() * 2)
    assert half_back.dtype == T.bfloat16
    np.testing.assert_array_equal(half_back.numpy(), half.numpy())


def test_lookahead_and_asp_write_through_master_weights():
    """Under multi_precision the port's LookAhead syncs, and ASP masks, the
    float32 master weights as well as the parameters (the reference's
    touch the parameters alone, and the next step recomputes them from the
    masters)."""
    import paddle_tpu_torch.incubate.asp as tasp
    T.seed(0)
    lin = T.nn.Linear(8, 8)
    lin.bfloat16()
    mask = tasp.prune_model(lin)[id(lin.weight)]
    la = T.incubate.LookAhead(T.optimizer.AdamW(
        1e-2, parameters=lin.parameters(), multi_precision=True),
        alpha=0.5, k=2)
    opt = tasp.decorate(la)
    x = T.to_tensor(_rand(4, 8, seed=35), dtype="bfloat16")
    for step in range(4):
        lin(x).astype("float32").square().mean().backward()
        opt.step()
        opt.clear_grad()
        master = la.inner_optimizer._master_weight(lin.weight)._data
        assert not bool((master[~mask] != 0).any()), step
        assert not bool((lin.weight._data[~mask] != 0).any()), step
        if step in (1, 3):                    # the syncs: k = 2
            slow = la._slow[id(lin.weight)] * mask
            np.testing.assert_array_equal(master.numpy(), slow.numpy())
            np.testing.assert_array_equal(
                lin.weight.numpy(), slow.to(torch.bfloat16).float().numpy())
