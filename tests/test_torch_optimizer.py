"""paddle.optimizer of the port against the reference's, on the CPU.

Every optimizer takes 3 steps on the parameters of a small ``Linear`` and
``LayerNorm`` carried across from the reference, with the same gradients
given to both (numpy, from a seed), so that the update rules are compared
and nothing else: f32 within 1e-5 of each parameter's scale. LBFGS, whose
step takes a closure, computes its gradients in each package from one
quadratic loss. Also: every lr schedule's values, gradient clipping,
``GradientMergeOptimizer``, AdamW's multi_precision on bf16 parameters, and
``state_dict``/``set_state_dict`` round trips.
"""
import numpy as np
import pytest

import jax  # noqa: F401  (the conftest keeps it on the CPU)

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _layers(pkg):
    return pkg.nn.Linear(8, 4), pkg.nn.LayerNorm(4)


def _pair(dtype=None):
    """The reference's Linear + LayerNorm and the port's, one state."""
    P.seed(3)
    ref, port = _layers(P), _layers(T)
    for r, t in zip(ref, port):
        t.set_state_dict({k: v.numpy() for k, v in r.state_dict().items()})
        if dtype:
            r.astype(dtype)
            t.astype(dtype)
    rp = [p for layer in ref for p in layer.parameters()]
    tp = [p for layer in port for p in layer.parameters()]
    return rp, tp


def _grads(params, step):
    rs = np.random.RandomState(100 + step)
    return [rs.randn(*p.shape).astype(np.float32) for p in params]


def _set_grads(pkg, params, grads, dtype=None):
    for p, g in zip(params, grads):
        p.clear_grad()
        t = pkg.to_tensor(g)
        p.grad = t.astype(dtype) if dtype else t


OPTIMIZERS = {
    "SGD": dict(learning_rate=0.1, weight_decay=0.01),
    "Momentum": dict(learning_rate=0.1, momentum=0.9, use_nesterov=True),
    "Adam": dict(learning_rate=0.01, amsgrad=True),
    "AdamW": dict(learning_rate=0.01, weight_decay=0.1),
    "Adagrad": dict(learning_rate=0.1),
    "RMSProp": dict(learning_rate=0.01, centered=True, momentum=0.5),
    "Adadelta": dict(learning_rate=1.0),
    "Adamax": dict(learning_rate=0.01),
    "Lamb": dict(learning_rate=0.01),
    "ASGD": dict(learning_rate=0.1, batch_num=2),
    "Rprop": dict(learning_rate=0.01),
    "RAdam": dict(learning_rate=0.01),
    "NAdam": dict(learning_rate=0.01),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_the_reference(name):
    rp, tp = _pair()
    ropt = getattr(P.optimizer, name)(parameters=rp, **OPTIMIZERS[name])
    topt = getattr(T.optimizer, name)(parameters=tp, **OPTIMIZERS[name])
    for step in range(3):
        grads = _grads(rp, step)
        _set_grads(P, rp, grads)
        _set_grads(T, tp, grads)
        ropt.step()
        topt.step()
    for r, t in zip(rp, tp):
        assert _rel(t.numpy(), r.numpy()) <= 1e-5, name


def test_lbfgs_matches_the_reference():
    rp, tp = _pair()
    rs = np.random.RandomState(7)
    x = rs.randn(16, 8).astype(np.float32)
    y = rs.randn(16, 4).astype(np.float32)

    def closure(pkg, params, opt):
        def run():
            opt.clear_grad()
            w, b = params[0], params[1]
            out = pkg.matmul(pkg.to_tensor(x), w) + b
            loss = ((out - pkg.to_tensor(y)) ** 2).mean()
            loss.backward()
            return loss
        return run

    ropt = P.optimizer.LBFGS(learning_rate=0.5, parameters=rp[:2])
    topt = T.optimizer.LBFGS(learning_rate=0.5, parameters=tp[:2])
    for _ in range(3):
        lr = float(ropt.step(closure(P, rp, ropt)))
        lt = float(topt.step(closure(T, tp, topt)))
        assert abs(lt - lr) <= 1e-5 * abs(lr)
    for r, t in zip(rp[:2], tp[:2]):
        assert _rel(t.numpy(), r.numpy()) <= 1e-5


def test_adamw_multi_precision_on_bf16_parameters():
    """bf16 parameters, f32 master weights and moments: the master weights
    within f32 accuracy of the reference's, the bf16 parameters within a
    step of bf16."""
    rp, tp = _pair("bfloat16")
    kw = dict(learning_rate=0.01, multi_precision=True)
    ropt = P.optimizer.AdamW(parameters=rp, **kw)
    topt = T.optimizer.AdamW(parameters=tp, **kw)
    for step in range(3):
        grads = _grads(rp, step)
        _set_grads(P, rp, grads, "bfloat16")
        _set_grads(T, tp, grads, "bfloat16")
        ropt.step()
        topt.step()
    for r, t in zip(rp, tp):
        assert t.dtype == T.bfloat16
        assert _rel(topt._master_weights[id(t)].numpy(),
                    ropt._master_weights[id(r)].numpy()) <= 1e-5
        assert _rel(t.numpy(), r.numpy()) <= 2 ** -8
        for acc in ("moment1", "moment2"):
            assert topt._accumulators[acc][id(t)].dtype == T.float32


def _schedules(pkg):
    lr = pkg.optimizer.lr
    return {
        "NoamDecay": lr.NoamDecay(d_model=64, warmup_steps=4),
        "PiecewiseDecay": lr.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
        "NaturalExpDecay": lr.NaturalExpDecay(0.1, gamma=0.3),
        "InverseTimeDecay": lr.InverseTimeDecay(0.1, gamma=0.5),
        "PolynomialDecay": lr.PolynomialDecay(0.1, decay_steps=4,
                                              cycle=True),
        "LinearWarmup": lr.LinearWarmup(lr.StepDecay(0.1, step_size=2),
                                        warmup_steps=3, start_lr=0.0,
                                        end_lr=0.1),
        "ExponentialDecay": lr.ExponentialDecay(0.1, gamma=0.8),
        "MultiStepDecay": lr.MultiStepDecay(0.1, milestones=[2, 5]),
        "StepDecay": lr.StepDecay(0.1, step_size=3),
        "LambdaDecay": lr.LambdaDecay(0.1, lambda e: 0.9 ** e),
        "MultiplicativeDecay": lr.MultiplicativeDecay(0.1, lambda e: 0.95),
        "CosineAnnealingDecay": lr.CosineAnnealingDecay(0.1, T_max=5),
        "CosineAnnealingWarmRestarts": lr.CosineAnnealingWarmRestarts(
            0.1, T_0=3, T_mult=2),
        "OneCycleLR": lr.OneCycleLR(0.1, total_steps=10),
        "CyclicLR": lr.CyclicLR(0.01, 0.1, step_size_up=3,
                                mode="triangular2"),
        "ConstantLR": lr.ConstantLR(0.1, total_steps=4),
        "LinearLR": lr.LinearLR(0.1, total_steps=6),
    }


@pytest.mark.parametrize("name", sorted(_schedules(P)))
def test_lr_schedule_values_match_the_reference(name):
    ref, port = _schedules(P)[name], _schedules(T)[name]
    got, want = [], []
    for _ in range(12):
        want.append(ref.get_lr())
        got.append(port.get_lr())
        ref.step()
        port.step()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_reduce_on_plateau_and_the_optimizer_follow_the_schedule():
    metrics = [1.0, 0.9, 0.9, 0.9, 0.9, 0.8, 0.8, 0.8, 0.8]
    ref = P.optimizer.lr.ReduceOnPlateau(0.1, patience=1, factor=0.5)
    port = T.optimizer.lr.ReduceOnPlateau(0.1, patience=1, factor=0.5)
    _, tp = _pair()
    opt = T.optimizer.SGD(learning_rate=port, parameters=tp)
    for m in metrics:
        ref.step(m)
        port.step(T.to_tensor(m))
        assert port.last_lr == ref.last_lr
        assert opt.get_lr() == port.last_lr and opt._lr == port.last_lr


@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_grad_clip_in_the_optimizer_matches_the_reference(clip):
    arg = {"ClipGradByValue": 0.5}.get(clip, 1.0)
    rp, tp = _pair()
    ropt = P.optimizer.SGD(0.1, parameters=rp,
                           grad_clip=getattr(P.nn, clip)(arg))
    topt = T.optimizer.SGD(0.1, parameters=tp,
                           grad_clip=getattr(T.nn, clip)(arg))
    for step in range(2):
        grads = _grads(rp, step)
        _set_grads(P, rp, grads)
        _set_grads(T, tp, grads)
        ropt.step()
        topt.step()
    for r, t in zip(rp, tp):
        assert _rel(t.numpy(), r.numpy()) <= 1e-6


@pytest.mark.parametrize("fn,arg", [("clip_grad_norm_", 0.5),
                                    ("clip_grad_value_", 0.3)])
def test_clip_functions_match_the_reference(fn, arg):
    rp, tp = _pair()
    grads = _grads(rp, 0)
    _set_grads(P, rp, grads)
    _set_grads(T, tp, grads)
    rtot = getattr(P.nn, fn)(rp, arg)
    ttot = getattr(T.nn, fn)(tp, arg)
    if fn == "clip_grad_norm_":
        assert _rel(ttot.numpy(), rtot.numpy()) <= 1e-6
    for r, t in zip(rp, tp):
        assert _rel(t.grad.numpy(), r.grad.numpy()) <= 1e-6


@pytest.mark.parametrize("avg", [True, False])
def test_gradient_merge_matches_the_reference(avg):
    rp, tp = _pair()
    ropt = P.optimizer.GradientMergeOptimizer(
        P.optimizer.Momentum(0.1, parameters=rp), k_steps=2, avg=avg)
    topt = T.optimizer.GradientMergeOptimizer(
        T.optimizer.Momentum(0.1, parameters=tp), k_steps=2, avg=avg)
    for step in range(4):
        grads = _grads(rp, step)
        _set_grads(P, rp, grads)
        _set_grads(T, tp, grads)
        ropt.step()
        topt.step()
        if step % 2 == 0:        # banked: the parameters did not move yet
            assert all(t.grad is None for t in tp)
    for r, t in zip(rp, tp):
        assert _rel(t.numpy(), r.numpy()) <= 1e-6


def test_optimizer_state_dict_round_trip():
    """A fresh optimizer loaded from another's state_dict (here through
    numpy) continues exactly as the first would."""
    _, tp = _pair()
    _, tp2 = _pair()
    a = T.optimizer.Adam(0.01, parameters=tp)
    for step in range(2):
        _set_grads(T, tp, _grads(tp, step))
        a.step()
    for p, q in zip(tp, tp2):
        q.set_value(p.numpy())
    b = T.optimizer.Adam(0.01, parameters=tp2)
    _set_grads(T, tp2, _grads(tp2, 9))
    b.step()                      # creates the accumulators, then reload
    for p, q in zip(tp, tp2):
        q.set_value(p.numpy())
    state = {k: (v.numpy() if hasattr(v, "numpy") else v)
             for k, v in a.state_dict().items()}
    b.set_state_dict(state)
    assert b._global_step == a._global_step == 2
    grads = _grads(tp, 5)
    _set_grads(T, tp, grads)
    _set_grads(T, tp2, grads)
    a.step()
    b.step()
    for p, q in zip(tp, tp2):
        np.testing.assert_array_equal(q.numpy(), p.numpy())


def test_layer_state_dict_round_trip_and_keys():
    """The port's Layer state_dict loads into the reference and back."""
    P.seed(1)
    ref = P.nn.Sequential(P.nn.Linear(8, 4), P.nn.LayerNorm(4))
    port = T.nn.Sequential(T.nn.Linear(8, 4), T.nn.LayerNorm(4))
    assert list(port.state_dict()) == list(ref.state_dict())
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    back = P.nn.Sequential(P.nn.Linear(8, 4), P.nn.LayerNorm(4))
    back.set_state_dict({k: v.numpy() for k, v in port.state_dict().items()})
    for (k, r), (_, b) in zip(ref.state_dict().items(),
                              back.state_dict().items()):
        np.testing.assert_array_equal(b.numpy(), r.numpy(), err_msg=k)
