"""jit on the CPU: the port's ``to_static``, ``save``/``load``, ``report()``
and ``static`` against the reference's on the same inputs, f32, the port
on the ``aot_eager`` backend (``force_cpu``).

- A tiny Layer GPT's compiled AdamW step, 3 steps from one state_dict:
  the losses within 1e-5 relative, the parameters within 1e-5 of their
  leaf's scale plus 1e-5 of Adam's largest total step (3 lr: a
  zero-initialised bias is the sum of its steps, and each carries the
  gradients' round-off relative to m/sqrt(v)), except elements whose
  gradients differ in sign or are under 100 eps on the two sides, which
  Adam turns into whole steps and which are held to Adam's largest step
  (as ``test_torch_training.py``'s ``_assert_adam_close``).
- ``report()`` field by field for the same call sequence: decisions, hits,
  probes, breaks, fallback.
- A small ResNet's compiled Momentum step, BatchNorm buffers included,
  within 1e-4 of each leaf's scale; its second call, from the cache,
  equal to an eager step of the port.
- ``jit.save``/``jit.load`` with a ``-1`` batch at batches 1, 3 and 17:
  within 1e-5 of the reference's loaded program.
- A compiled step under ``GradScaler`` with one non-finite step, which it
  skips: every parameter, the scale and ``found_inf`` equal to the port's
  eager step, and the parameters within 1e-6 of the reference's.
- ``static.Executor`` over a recorded Program equal to the reference's.
- The port alone: compiled dropout, the untraceable fallback and the
  errors that raise, ``cond``/``while_loop`` under a trace.

Restated here: ``test_observability.py::test_compile_counter_on_toy_jit_fn``
counts the compiles of a ``jax.jit`` function (and fails on the reference);
here it counts those of a ``to_static`` function.
"""
import contextlib
import warnings

import numpy as np
import pytest

import jax  # (the conftest keeps it on the CPU)

import paddle_tpu as P
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as T
import paddle_tpu_torch.observability as obs
from paddle_tpu_torch._testing import force_cpu
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch._testing import numpy_initializers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

EPS = 1e-8     # AdamW's default epsilon
LR = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    force_cpu()
    T.seed(2024)


def _t(pkg, a):
    return pkg.to_tensor(np.asarray(a))


def _params(net):
    # copies: the port's numpy() of a CPU tensor shares its memory, and the
    # optimizer writes in place
    return [np.array(p.numpy()) for p in net.parameters()]


# ------------------------------------------------------- the GPT step
def _gpt_pair(seed):
    P.seed(seed)
    with numpy_initializers(jax):
        ref = JaxGPT(JaxGPTConfig.tiny())
    port = GPTForCausalLM(GPTConfig.tiny())
    missing, unexpected = port.set_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    assert not missing and not unexpected
    return ref, port


def _gpt_run(pkg, net, ids, compiled, grads=None):
    opt = pkg.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                              parameters=net.parameters())

    def step(x):
        loss = net(x, x)
        loss.backward()
        if grads is not None:
            grads.append([p.grad.numpy().copy() for p in net.parameters()])
        opt.step()
        opt.clear_grad()
        return loss
    fn = pkg.jit.to_static(step, objs=[net, opt]) if compiled else step
    x = _t(pkg, ids)
    return [float(fn(x)) for _ in range(3)], fn


def _assert_adam_close(got, want, shaky, steps=3):
    err = np.abs(got - want)
    scale = np.abs(want).max()
    if (~shaky).any():
        assert err[~shaky].max() <= 1e-5 * (scale + steps * LR)
    assert err.max() <= 2 * steps * LR * 1.01


def test_compiled_gpt_adamw_steps_match_the_reference():
    ids = np.random.RandomState(0).randint(0, 256, (2, 32)).astype("int64")
    # the gradients of eager runs mark the elements Adam cannot hold
    rgrads, tgrads = [], []
    ref, port = _gpt_pair(3)
    _gpt_run(P, ref, ids, False, rgrads)
    _gpt_run(T, port, ids, False, tgrads)
    shaky = [np.zeros(g.shape, bool) for g in rgrads[0]]
    for rs, ts in zip(rgrads, tgrads):
        for i, (g, h) in enumerate(zip(rs, ts)):
            shaky[i] |= (np.sign(g) != np.sign(h)) | (np.abs(g) < 100 * EPS)
    ref, port = _gpt_pair(3)
    rl, rfn = _gpt_run(P, ref, ids, True)
    tl, tfn = _gpt_run(T, port, ids, True)
    np.testing.assert_allclose(tl, rl, rtol=1e-5)
    for got, want, sh in zip(_params(port), _params(ref), shaky):
        _assert_adam_close(got, want, sh)
    for fn in (rfn, tfn):
        sig = fn.report()["signatures"][0]
        assert sig["fallback"] is None
        assert [s["hits"] for s in sig["specializations"]] == [3]


# ------------------------------------------------------------ report()
def _branchy(pkg):
    @pkg.jit.to_static
    def f(x):
        if (x.mean() > 0):
            return x * 2.0
        return (x - 1.0, x.sum())
    return f


def _volatile(pkg):
    @pkg.jit.to_static
    def f(x):
        return x + float(x.sum())
    return f


def _fields(rep):
    return [(s["specializations"], s["graph_breaks"], s["eager_probes"],
             s["fallback"]) for s in rep["signatures"]]


@pytest.mark.parametrize("make,values", [
    (_branchy, (1.0, 1.0, -1.0, -1.0, 1.0, 3.0, -2.0)),
    (_volatile, (1.0, 2.0, 3.0, 4.0)),
])
def test_report_equals_the_references(make, values):
    reps, outs = [], []
    for pkg in (P, T):
        f = make(pkg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = [f(_t(pkg, np.full(2, v, np.float32))) for v in values]
        outs.append([[o.numpy() for o in (r if isinstance(r, tuple)
                                          else (r,))] for r in res])
        reps.append(f.report())
    assert _fields(reps[1]) == _fields(reps[0])
    for a, b in zip(outs[0], outs[1]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-6)


# ------------------------------------------------ ResNet with BatchNorm
def _resnet_run(pkg, state=None):
    """resnet18 at test_torch_vision.py's well-conditioned shape (B8 32x32
    N(0, 1) images), Momentum(0.1, 0.9, wd 5e-4), one compiled step; the
    state after it and the loss."""
    pkg.seed(1)
    # the reference's weights come from ``state``: built with numpy draws
    with numpy_initializers(jax) if pkg is P else contextlib.nullcontext():
        net = pkg.vision.models.resnet18(num_classes=10)
    if state is not None:
        net.set_state_dict(state)
    opt = pkg.optimizer.Momentum(learning_rate=0.1, momentum=0.9,
                                 parameters=net.parameters(),
                                 weight_decay=5e-4)
    lossf = pkg.nn.CrossEntropyLoss()

    def train_step(xb, yb):
        loss = lossf(net(xb), yb)
        opt.clear_grad()
        loss.backward()
        opt.step()
        return loss
    step = pkg.jit.to_static(train_step, objs=[net, opt])
    rng = np.random.RandomState(4)
    batches = [(_t(pkg, rng.randn(8, 3, 32, 32).astype("f4")),
                _t(pkg, rng.randint(0, 10, (8,)).astype("int64")))
               for _ in range(2)]
    loss = float(step(*batches[0]))
    return net, loss, step, train_step, batches


def _state(net):
    return {k: np.array(v.numpy()) for k, v in net.state_dict().items()}


def test_compiled_resnet_momentum_step_with_batchnorm_buffers():
    """One compiled step against the reference's compiled step, every
    parameter and BatchNorm buffer within 1e-4 of its leaf's scale (a
    second step at lr 0.1 is chaotic in f32 on either side); then the
    port's second compiled call, from the cache, equals an eager second
    step from the same state exactly."""
    P.seed(1)
    with numpy_initializers(jax):
        init = {k: v.numpy() for k, v in
                P.vision.models.resnet18(num_classes=10).state_dict().items()}
    ref, rl, _, _, _ = _resnet_run(P, init)
    port, tl, step, eager_step, batches = _resnet_run(T, init)
    np.testing.assert_allclose(tl, rl, rtol=1e-4)
    rsd, tsd = _state(ref), _state(port)
    assert set(rsd) == set(tsd)
    for k in rsd:
        assert np.abs(tsd[k] - rsd[k]).max() <= 1e-4 * max(
            np.abs(rsd[k]).max(), 1e-30), k
    twin, _, _, twin_eager, _ = _resnet_run(T, init)
    second = float(step(*batches[1]))
    assert float(twin_eager(*batches[1])) == second
    for k, v in _state(twin).items():
        np.testing.assert_array_equal(_state(port)[k], v)


# ------------------------------------------------------ save / load
def test_save_load_serves_every_batch_like_the_reference(tmp_path):
    P.seed(5)
    ref = P.nn.Sequential(P.nn.Linear(8, 16), P.nn.ReLU(),
                          P.nn.Linear(16, 4))
    port = T.nn.Sequential(T.nn.Linear(8, 16), T.nn.ReLU(),
                           T.nn.Linear(16, 4))
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    P.jit.save(ref, str(tmp_path / "ref"),
               input_spec=[P.jit.InputSpec([-1, 8], "float32")])
    T.jit.save(port, str(tmp_path / "port"),
               input_spec=[T.jit.InputSpec([-1, 8], "float32")])
    assert (tmp_path / "port.graph.txt").read_text()
    rtl, ttl = P.jit.load(str(tmp_path / "ref")), \
        T.jit.load(str(tmp_path / "port"))
    assert isinstance(ttl, T.jit.TranslatedLayer)
    assert set(ttl.state_dict()) == set(rtl.state_dict())
    for b in (1, 3, 17):
        x = np.random.RandomState(b).randn(b, 8).astype(np.float32)
        np.testing.assert_allclose(ttl(_t(T, x)).numpy(),
                                   rtl(_t(P, x)).numpy(), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------- GradScaler
def _scaled_run(pkg, state, compiled):
    net = pkg.nn.Linear(4, 3)
    net.set_state_dict(state)
    opt = pkg.optimizer.SGD(learning_rate=0.1, parameters=net.parameters())
    scaler = pkg.amp.GradScaler(init_loss_scaling=2.0 ** 10,
                                incr_every_n_steps=2)
    lossf = pkg.nn.MSELoss()

    def step(x, y):
        loss = lossf(net(x), y)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return loss
    fn = pkg.jit.to_static(step, objs=[net, opt, scaler]) if compiled \
        else step
    rng = np.random.RandomState(6)
    rows = []
    for i in range(5):
        x = rng.randn(8, 4).astype("f4")
        if i == 2:
            x[0, 0] = np.inf               # this step is skipped
        y = rng.randn(8, 3).astype("f4")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn(_t(pkg, x), _t(pkg, y))
        rows.append((bool(scaler.found_inf),
                     float(scaler.get_loss_scaling()), _params(net)))
    return rows


def test_compiled_grad_scaler_skips_the_nonfinite_step_as_eager_does():
    P.seed(7)
    state = {k: v.numpy() for k, v in P.nn.Linear(4, 3).state_dict()
             .items()}
    ref = _scaled_run(P, state, False)
    eager = _scaled_run(T, state, False)
    compiled = _scaled_run(T, state, True)
    assert [r[:2] for r in compiled] == [r[:2] for r in eager] \
        == [r[:2] for r in ref]
    assert [r[0] for r in compiled] == [False, False, True, False, False]
    for c, e, r in zip(compiled, eager, ref):
        for a, b, w in zip(c[2], e[2], r[2]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------- static
def test_static_executor_equals_the_references():
    outs = []
    for pkg in (P, T):
        prog = pkg.static.Program()
        with pkg.static.program_guard(prog):
            x = pkg.static.data("x", [4, 3], "float32")
            got = prog.record(lambda: {"y": (x * 2.0).sum(axis=1),
                                       "z": x.mean()})
        exe = pkg.static.Executor()
        rows = []
        for seed in (0, 1):
            feed = np.random.RandomState(seed).randn(4, 3).astype("f4")
            rows.append(exe.run(prog, feed={"x": feed},
                                fetch_list=[got["y"], got["z"]]))
        outs.append(rows)
    for a, b in zip(outs[0], outs[1]):
        for x, y in zip(a, b):
            np.testing.assert_allclose(y, x, rtol=1e-6)


# ------------------------------------------------------- the port alone
def test_compile_counter_on_toy_jit_fn():
    f = T.jit.to_static(lambda x: x * 2 + 1)
    with obs.count_compiles() as compiles, obs.count_traces() as traces:
        f(T.ones([3]))
    assert compiles() >= 1 and traces() >= 1
    # steady state: cache hit, zero events
    with obs.count_compiles() as c2, obs.count_traces() as t2:
        f(T.ones([3]))
    assert c2() == 0 and t2() == 0
    # liveness: a new shape must be SEEN
    with obs.count_compiles() as c3:
        f(T.ones([4]))
    assert c3() >= 1


def test_compiled_dropout_new_mask_each_call_same_after_seed():
    f = T.jit.to_static(lambda x: T.nn.functional.dropout(x, 0.5))
    x = T.ones([64, 64])
    T.seed(3)
    a, b = f(x).numpy(), f(x).numpy()
    T.seed(3)
    a2, b2 = f(x).numpy(), f(x).numpy()
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(b, b2)
    assert set(np.unique(a)) <= {0.0, 2.0}
    assert 0.4 < (a != 0).mean() < 0.6


@pytest.mark.parametrize("read", ["numpy", "torch_item"])
def test_a_value_read_in_the_trace_runs_eagerly_with_a_warning(read):
    def fn(x):
        v = x.sum().numpy() if read == "numpy" else x._data.sum().item()
        return x * float(v)
    f = T.jit.to_static(fn)
    x = T.to_tensor(np.ones(3, np.float32))
    with pytest.warns(UserWarning, match="falling back to eager"):
        out = f(x)
    np.testing.assert_allclose(out.numpy(), 3.0)
    assert f.report()["signatures"][0]["fallback"]


def test_a_backend_error_raises_and_never_runs_eagerly():
    def broken(gm, example_inputs):
        raise RuntimeError("backend refused the graph")
    f = T.jit.to_static(lambda x: x + 1, backend=broken)
    with pytest.raises(Exception, match="backend refused"):
        f(T.ones([2]))
    assert f.report()["signatures"][0]["fallback"] is None


def test_cond_selects_and_while_loop_goes_eager_under_a_trace():
    @T.jit.to_static
    def f(x):
        return T.static.nn.cond(x.sum() > 0, lambda: x * 2.0,
                                lambda: x - 1.0)

    for v, want in ((1.0, 2.0), (-1.0, -2.0)):
        np.testing.assert_allclose(
            f(T.to_tensor(np.full(2, v, np.float32))).numpy(), want)
    assert f.report()["signatures"][0]["fallback"] is None

    @T.jit.to_static
    def g(x):
        return T.static.nn.while_loop(lambda v: v.sum() < 10.0,
                                      lambda v: v * 2.0, [x])[0]
    with pytest.warns(UserWarning, match="falling back to eager"):
        out = g(T.to_tensor(np.ones(2, np.float32)))
    np.testing.assert_allclose(out.numpy(), 8.0)
