"""The slice as a whole, on the CPU: the Layer GPT (``models/gpt.py``) and
``paddle.optimizer`` of the port against the reference's.

The reference's ``GPTForCausalLM(GPTConfig.tiny())`` and the port's load one
``state_dict`` (the reference's, after ``.numpy()``); the step-0 loss and
every gradient agree in f32 (1e-5 of the leaf's scale), and so does a
3-step AdamW trajectory. The reference's own claim of
``test_models.py::test_gpt_tiny_trains`` holds for the port: the loss falls
over 8 AdamW steps.
"""
import numpy as np
import pytest

import jax  # (the conftest keeps it on the CPU)

import paddle_tpu as P
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as T
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch._testing import numpy_initializers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _pair(seed=0):
    P.seed(seed)
    with numpy_initializers(jax):
        ref = JaxGPT(JaxGPTConfig.tiny())
    port = GPTForCausalLM(GPTConfig.tiny())
    state = {k: v.numpy() for k, v in ref.state_dict().items()}
    missing, unexpected = port.set_state_dict(state)
    assert not missing and not unexpected
    return ref, port


def _ids(b=2, s=64, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, s))


def _loss(pkg, model, ids):
    t = pkg.to_tensor(ids)
    loss = model(t, t)
    loss.backward()
    return float(loss)


def test_state_dict_keys_are_the_references():
    ref, port = _pair()
    assert list(port.state_dict()) == list(ref.state_dict())
    assert "gpt.blocks.0.attn.qkv.weight" in port.state_dict()


def test_step0_loss_and_every_gradient_match_the_reference():
    ref, port = _pair()
    ids = _ids()
    lr, lp = _loss(P, ref, ids), _loss(T, port, ids)
    assert abs(lp - lr) <= 1e-5 * abs(lr)
    rp, tp = dict(ref.named_parameters()), dict(port.named_parameters())
    assert set(rp) == set(tp)
    for name in rp:
        assert _rel(tp[name].grad.numpy(), rp[name].grad.numpy()) <= 1e-5, \
            name


EPS = 1e-8     # AdamW's default epsilon


def test_adamw_trajectory_matches_the_reference():
    """Three steps of AdamW on both: the losses along the way within 1e-5,
    and every parameter within 1e-5 of its scale, except the elements
    whose two gradients differed in sign or were under 100 eps at some step,
    which are held to Adam's largest step instead. There Adam's update,
    lr m / (sqrt(v) + eps), turns round-off in a gradient into a step of up
    to lr: the k bias's gradient is zero in exact arithmetic (softmax is
    blind to a shift of a row's scores), and the tied embedding's rows of
    tokens absent from the batch get only the softmax's tail, 1e-8 and
    below at this model's logit spread."""
    ref, port = _pair()
    ids = _ids(seed=1)
    ropt = P.optimizer.AdamW(learning_rate=1e-3, epsilon=EPS,
                             parameters=ref.parameters())
    topt = T.optimizer.AdamW(learning_rate=1e-3, epsilon=EPS,
                             parameters=port.parameters())
    rp, tp = dict(ref.named_parameters()), dict(port.named_parameters())
    shaky = {n: np.zeros(p.shape, bool) for n, p in rp.items()}
    for _ in range(3):
        lr, lp = _loss(P, ref, ids), _loss(T, port, ids)
        assert abs(lp - lr) <= 1e-5 * abs(lr)
        for n, p in rp.items():
            g, h = p.grad.numpy(), tp[n].grad.numpy()
            shaky[n] |= (np.sign(g) != np.sign(h)) | (np.abs(g) < 100 * EPS)
        ropt.step()
        topt.step()
        ropt.clear_grad()
        topt.clear_grad()
    for n in rp:
        want, got = rp[n].numpy(), tp[n].numpy()
        err = np.abs(got - want)
        assert err[~shaky[n]].max() <= 1e-5 * np.abs(want).max(), n
        # an Adam step moves an element by at most ~lr: 3 steps on two sides
        assert err.max() <= 2 * 3 * 1e-3 * 1.01, n


def test_gpt_tiny_trains():
    """test_models.py::test_gpt_tiny_trains, on the port."""
    T.seed(0)
    m = GPTForCausalLM(GPTConfig.tiny())
    ids = T.randint(0, 256, [4, 32])
    opt = T.optimizer.AdamW(1e-2, parameters=m.parameters())
    losses = []
    for _ in range(8):
        loss = m(ids, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_the_optimizer_keeps_each_parameter_and_its_leaf():
    """AdamW writes into each parameter's own torch leaf: the Parameter
    objects, their arrays and the leaves .grad accumulates into stay the
    same across steps."""
    _, port = _pair()
    params = port.parameters()
    arrays = [p._data for p in params]
    opt = T.optimizer.AdamW(learning_rate=1e-3, parameters=params)
    before = [a.clone() for a in arrays]
    ids = _ids()
    for _ in range(2):
        _loss(T, port, ids)
        opt.step()
        opt.clear_grad()
    assert all(p._data is a and a.is_leaf and a.requires_grad
               for p, a in zip(port.parameters(), arrays))
    assert any((a != b).any() for a, b in zip(arrays, before))
    _loss(T, port, ids)
    assert all(p.grad is not None and p.grad._data is a.grad
               for p, a in zip(port.parameters(), arrays))


def test_multi_precision_adamw_on_bf16_matches_the_reference():
    """bf16 parameters with f32 master weights and moments (the
    reference's multi_precision): one step from the same gradients. The
    master weights agree to f32 accuracy, the bf16 parameters to a step of
    bf16."""
    ref, port = _pair()
    ref.bfloat16()
    port.bfloat16()
    ids = _ids()
    _loss(P, ref, ids)
    rp, tp = dict(ref.named_parameters()), dict(port.named_parameters())
    for n, p in tp.items():
        p.grad = T.to_tensor(rp[n].grad.numpy()).astype("bfloat16")
    ropt = P.optimizer.AdamW(learning_rate=1e-3, parameters=ref.parameters(),
                             multi_precision=True)
    topt = T.optimizer.AdamW(learning_rate=1e-3,
                             parameters=port.parameters(),
                             multi_precision=True)
    ropt.step()
    topt.step()
    for i, n in enumerate(rp):
        assert tp[n]._data.dtype == T.bfloat16.torch
        want_master = ropt._master_weights[id(rp[n])].numpy()
        got_master = topt._master_weights[id(tp[n])].numpy()
        assert _rel(got_master, want_master) <= 1e-6, n
        assert _rel(tp[n].numpy(), rp[n].numpy()) <= 2 ** -8, n
        m1 = topt._accumulators["moment1"][id(tp[n])]
        assert m1._data.dtype == T.float32.torch
