"""The port's BERT (paddle_tpu_torch.models.bert) against the JAX reference
(paddle_tpu.models.bert) on the CPU.

Both sides hold the reference's weights (its state_dict through numpy) and
take the same seeded numpy ids. With dropout 0 the logits, the loss and
every gradient must agree: in f32 to 1e-4 of each tensor's scale (the same
arithmetic in another order, through 2 layers), and under AMP O2 in bf16 to
the bf16 tolerance stated below. Dropout's draws differ between the
frameworks, so training with dropout is held to determinism under
``paddle.seed`` instead.
"""
import numpy as np
import pytest

import jax
import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch._testing import numpy_initializers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

B, S = 3, 16


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port.set_device("cpu")


def _cfg(mod, dropout=0.0):
    return mod.BertConfig(**dict(vars(mod.BertConfig.tiny()),
                                 dropout=dropout))


def _pair(head):
    ref.seed(0)
    with numpy_initializers(jax):
        jm = getattr(jbert, head)(_cfg(jbert))
    tm = getattr(tbert, head)(_cfg(tbert))
    tm.set_state_dict({k: v.numpy() for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, 256, (B, S))
    types = rs.randint(0, 2, (B, S))
    mask = np.ones((B, S), np.int64)
    mask[0, 11:] = 0
    mask[2, 5:] = 0
    return ids, types, mask


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def _run(pd, model, head, masked, amp):
    ids, types, mask = _batch()
    labels = ids if head == "BertForMaskedLM" else ids[:, 0] % 2
    kw = dict(token_type_ids=pd.to_tensor(types),
              attention_mask=pd.to_tensor(mask) if masked else None)
    with pd.amp.auto_cast(enable=amp, level="O2"):
        logits = model(pd.to_tensor(ids), **kw)
        loss = model(pd.to_tensor(ids), labels=pd.to_tensor(labels), **kw)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return (logits.astype("float32").numpy(), float(loss),
            {n: None if g is None else g.astype("float32").numpy()
             for n, g in grads.items()})


# f32: 1e-4 of each tensor's scale. bf16 (O2: bf16 params, bf16 products,
# f32 layer norms, softmax and loss): the frameworks round at other points
# (XLA fuses elementwise chains), so logits and loss are held to 3 bf16
# steps (2^-8) of their scale and gradients to 5 % of each leaf's scale.
@pytest.mark.parametrize("amp,tol,grad_tol", [(False, 1e-4, 1e-4),
                                              (True, 3 * 2 ** -8, 5e-2)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head", ["BertForMaskedLM",
                                  "BertForSequenceClassification"])
def test_matches_reference(head, masked, amp, tol, grad_tol):
    jm, tm = _pair(head)
    if amp:
        for pd, m in ((ref, jm), (port, tm)):
            pd.amp.decorate(m, level="O2", dtype="bfloat16")
            assert all(p.dtype == pd.bfloat16 for p in m.parameters())
    jl, jloss, jg = _run(ref, jm, head, masked, amp)
    tl, tloss, tg = _run(port, tm, head, masked, amp)
    assert _rel(tl, jl) < tol
    assert abs(tloss - jloss) < tol * abs(jloss)
    assert sorted(tg) == sorted(jg)
    scale = max(float(np.abs(g).max()) for g in jg.values() if g is not None)
    for name in jg:
        assert (tg[name] is None) == (jg[name] is None), name
        if jg[name] is None:
            continue
        if name.endswith("k_proj.bias"):
            # exactly zero in exact arithmetic (softmax ignores a shift
            # shared by all keys): both sides hold rounding noise, held
            # against the largest gradient of the model
            for g in (tg[name], jg[name]):
                assert float(np.abs(g).max()) < grad_tol * scale, name
            continue
        assert _rel(tg[name], jg[name]) < grad_tol, name


def test_attention_mask_is_additive_and_masks_the_padding():
    """The padded positions change no unpadded output: the mask is
    (1 - m) * -1e4 over [B, 1, 1, S], in both packages."""
    ids, types, mask = _batch()
    _, tm = _pair("BertForMaskedLM")
    tm.eval()
    other = ids.copy()
    other[0, 11:] = (other[0, 11:] + 7) % 256
    a = tm(port.to_tensor(ids), attention_mask=port.to_tensor(mask))
    b = tm(port.to_tensor(other), attention_mask=port.to_tensor(mask))
    np.testing.assert_allclose(a.numpy()[0, :11], b.numpy()[0, :11],
                               rtol=1e-5, atol=1e-5)
    assert not np.allclose(a.numpy()[0, 11:], b.numpy()[0, 11:])


def test_configs_and_embedding_scale_as_the_reference():
    assert vars(tbert.BertConfig.base()) == vars(jbert.BertConfig.base())
    assert vars(tbert.BertConfig.tiny()) == vars(jbert.BertConfig.tiny())
    ref.seed(0)
    port.seed(0)
    jm = jbert.BertForMaskedLM(jbert.BertConfig.tiny())
    tm = tbert.BertForMaskedLM(tbert.BertConfig.tiny())
    want = {k: v.shape for k, v in jm.state_dict().items()}
    assert {k: v.shape for k, v in tm.state_dict().items()} == want
    # the 0.02 scale of the embeddings: the same distribution, other draws
    for name in ("word_embeddings", "position_embeddings"):
        js = float(getattr(jm.bert.embeddings, name).weight.numpy().std())
        ts = float(getattr(tm.bert.embeddings, name).weight.numpy().std())
        assert abs(ts - js) < 0.1 * js, name
        assert not getattr(tm.bert.embeddings, name).weight.stop_gradient
    assert float(np.abs(tm.decoder_bias.numpy()).max()) == 0.0


def _dropout_losses(seed):
    port.seed(seed)
    model = tbert.BertForMaskedLM(tbert.BertConfig.tiny())
    opt = port.optimizer.AdamW(1e-3, parameters=model.parameters())
    ids, _, _ = _batch()
    losses = []
    for _ in range(3):
        loss = model(port.to_tensor(ids), labels=port.to_tensor(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    model.eval()
    eval_a = model(port.to_tensor(ids)).numpy()
    eval_b = model(port.to_tensor(ids)).numpy()
    return losses, eval_a, eval_b


def test_dropout_training_is_deterministic_under_seed():
    a, ea, ea2 = _dropout_losses(7)
    b, eb, _ = _dropout_losses(7)
    c, _, _ = _dropout_losses(8)
    assert a == b
    np.testing.assert_array_equal(ea, eb)
    np.testing.assert_array_equal(ea, ea2)      # eval: no dropout
    assert a != c
    assert all(np.isfinite(a))
