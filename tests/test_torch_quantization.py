"""paddle_tpu_torch.quantization against paddle_tpu's, on the CPU.

Each test puts the same seeded numpy inputs (and, for models, one
``state_dict``) through both packages:

- ``quantize_dequantize``: values at 4 and 8 bits, per tensor and per
  channel, within 1e-5 relative (f32); the straight-through gradient is the
  upstream gradient, exactly;
- the observers: the same scales within 1e-6 relative;
- QAT on the 2-layer GPT (``GPTConfig.tiny()``) with a channel-wise weight
  quanter and an abs-max activation quanter on every Linear: three SGD
  steps give the same losses (1e-5 relative), the same gradients at step 0
  (1e-5 of each leaf's largest) and the same learned activation scales
  (1e-5 relative); ``convert`` freezes them;
- PTQ on an MLP: the observed activation scales, the weight scales and the
  converted output (1e-5 relative).
"""
import numpy as np
import pytest

import jax  # (the conftest keeps it on the CPU)

import paddle_tpu as P
import paddle_tpu.quantization as PQ
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as T
import paddle_tpu_torch.quantization as TQ
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch._testing import numpy_initializers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_dequantize_values_and_ste_gradient(bits, per_channel):
    rs = np.random.RandomState(bits)
    x = rs.randn(16, 8).astype(np.float32)
    up = rs.randn(16, 8).astype(np.float32)
    qmax = 2 ** (bits - 1) - 1
    if per_channel:
        s = (np.abs(x).max(0) / qmax * 0.8).astype(np.float32)
        ax = 1
    else:
        s = np.asarray([np.abs(x).max() / qmax * 0.8], np.float32)
        ax = None
    outs = []
    for pkg, Q in ((P, PQ), (T, TQ)):
        xt = pkg.to_tensor(x, stop_gradient=False)
        out = Q.quantize_dequantize(xt, pkg.to_tensor(s), 0.0, bits, ax)
        (out * pkg.to_tensor(up)).sum().backward()
        outs.append((out.numpy(), xt.grad.numpy()))
    (rv, rg), (tv, tg) = outs
    assert _rel(tv, rv) <= 1e-5
    np.testing.assert_array_equal(tg, rg)
    np.testing.assert_array_equal(tg, up)
    # the clip binds: 0.8 of the abs-max leaves values beyond the range
    q = np.rint(tv / np.broadcast_to(s, tv.shape))
    assert q.min() >= -(qmax + 1) and q.max() <= qmax
    assert q.min() == -(qmax + 1) or q.max() == qmax


def test_observers_give_the_references_scales():
    rs = np.random.RandomState(3)
    xs = [rs.randn(4, 6).astype(np.float32) * (i + 1) for i in range(3)]
    w = rs.randn(6, 5).astype(np.float32)
    for name, kw in (("AbsmaxObserver", {}), ("EMAObserver",
                                              {"moving_rate": 0.7})):
        ro, to = getattr(PQ, name)(**kw), getattr(TQ, name)(**kw)
        for x in xs:
            ro.observe(P.to_tensor(x))
            to.observe(T.to_tensor(x))
        assert abs(to.scale() - ro.scale()) <= 1e-6 * ro.scale()
    rg = PQ.GroupWiseWeightObserver(bit_length=4)
    tg = TQ.GroupWiseWeightObserver(bit_length=4)
    rg.observe(P.to_tensor(w))
    tg.observe(T.to_tensor(w))
    assert _rel(tg.scale(), rg.scale()) <= 1e-6


def _qat_config(Q):
    return Q.QuantConfig(
        activation=Q.quanter(Q.FakeQuanterWithAbsMax, moving_rate=0.9),
        weight=Q.quanter(Q.FakeQuanterChannelWiseAbsMax))


def _gpt_pair():
    P.seed(0)
    with numpy_initializers(jax):
        ref = JaxGPT(JaxGPTConfig.tiny())
    # the embeddings at GPT's 0.02 scale (numpy_initializers draws them
    # at 1), so that the tied head's logits are those of a trained model
    state = {k: v.numpy() * (0.02 if k.endswith(("wte.weight",
                                                 "wpe.weight")) else 1.0)
             for k, v in ref.state_dict().items()}
    ref.set_state_dict(state)
    T.seed(0)
    port = GPTForCausalLM(GPTConfig.tiny())
    missing, unexpected = port.set_state_dict(state)
    assert not missing and not unexpected
    return ref, port


def _scales(model):
    return {n: float(l.act_quanter._scale.numpy()[0])
            for n, l in model.named_sublayers()
            if hasattr(l, "act_quanter")}


def test_qat_gpt_losses_gradients_and_scales_match_the_reference():
    ref, port = _gpt_pair()
    ref = PQ.QAT(_qat_config(PQ)).quantize(ref, inplace=True)
    port = TQ.QAT(_qat_config(TQ)).quantize(port, inplace=True)
    n_quanted = sum(isinstance(l, TQ.QuantedLinear)
                    for _, l in port.named_sublayers())
    assert n_quanted == 2 * 4
    ids = np.random.RandomState(1).randint(0, 256, (2, 64))
    ropt = P.optimizer.SGD(0.5, parameters=ref.parameters())
    topt = T.optimizer.SGD(0.5, parameters=port.parameters())
    for step in range(3):
        losses = []
        for pkg, model, opt in ((P, ref, ropt), (T, port, topt)):
            t = pkg.to_tensor(ids)
            loss = model(t, t)
            loss.backward()
            losses.append(float(loss))
            if step == 0:
                grads = {n: p.grad.numpy()
                         for n, p in model.named_parameters()}
                if pkg is P:
                    rgrads = grads
            opt.step()
            opt.clear_grad()
        assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0]), step
        if step == 0:
            assert set(grads) == set(rgrads)
            assert "gpt.blocks.0.attn.qkv.inner.weight" in grads
            for n in rgrads:
                assert _rel(grads[n], rgrads[n]) <= 1e-5, n
    rs, ts = _scales(ref), _scales(port)
    assert set(rs) == set(ts) and len(ts) == n_quanted
    for n in rs:
        assert abs(ts[n] - rs[n]) <= 1e-5 * rs[n], n
    frozen = TQ.QAT(_qat_config(TQ)).convert(port, inplace=True)
    t = T.to_tensor(ids)
    frozen(t, t)
    assert _scales(frozen) == ts          # eval: the scales no longer move


def test_ptq_scales_and_converted_output_match_the_reference():
    rs = np.random.RandomState(4)
    w1 = rs.randn(8, 16).astype(np.float32) * 0.3
    w2 = rs.randn(16, 4).astype(np.float32) * 0.3
    b1 = rs.randn(16).astype(np.float32) * 0.1
    calib = [rs.randn(32, 8).astype(np.float32) for _ in range(3)]
    x = rs.randn(32, 8).astype(np.float32)
    got = []
    for pkg, Q in ((P, PQ), (T, TQ)):
        m = pkg.nn.Sequential(pkg.nn.Linear(8, 16), pkg.nn.ReLU(),
                              pkg.nn.Linear(16, 4))
        m.set_state_dict({"0.weight": w1, "0.bias": b1, "2.weight": w2,
                          "2.bias": np.zeros(4, np.float32)})
        ptq = Q.PTQ(Q.QuantConfig())
        ptq.quantize(m, inplace=True)
        for c in calib:
            m(pkg.to_tensor(c))
        conv = ptq.convert(m, inplace=False)
        assert isinstance(conv[0], Q.QuantedLinear)
        assert not isinstance(m[0], Q.QuantedLinear)
        got.append(([float(conv[i].act_quanter._scale.numpy()[0])
                     for i in (0, 2)],
                    [float(conv[i].weight_quanter._scale.numpy()[0])
                     for i in (0, 2)],
                    conv(pkg.to_tensor(x)).numpy()))
    (ra, rw, ro), (ta, tw, to) = got
    assert _rel(ta, ra) <= 1e-5 and _rel(tw, rw) <= 1e-5
    assert _rel(to, ro) <= 1e-5
