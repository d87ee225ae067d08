"""The port's AMP (paddle_tpu_torch.amp: auto_cast, the op lists, decorate,
GradScaler, debugging) against the JAX reference (paddle_tpu.amp) on the
CPU, on the same seeded numpy inputs.

Dtypes, op lists, scaler state and printed tables must be equal. Values are
held to what the dtype allows, stated per test.
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as port
from paddle_tpu.amp import debugging as ref_dbg
from paddle_tpu.core import dispatch as ref_dispatch
from paddle_tpu.core import flags as ref_flags
from paddle_tpu_torch.amp import debugging as port_dbg
from paddle_tpu_torch.amp import grad_scaler as port_grad_scaler
from paddle_tpu_torch.core import dispatch as port_dispatch
from paddle_tpu_torch.core import flags as port_flags
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

PAIRS = ((ref, ref_dispatch, ref_dbg, ref_flags),
         (port, port_dispatch, port_dbg, port_flags))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    port.set_device("cpu")
    saved = [{n: f.value for n, f in fl._REGISTRY.items()}
             for fl in (ref_flags, port_flags)]
    yield
    for fl, vals in zip((ref_flags, port_flags), saved):
        for n, v in vals.items():
            fl._REGISTRY[n].value = v


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return ([rs.randn(4, 8).astype(np.float32),
             rs.randn(8, 8).astype(np.float32),
             rs.randn(8).astype(np.float32),
             rs.randn(8).astype(np.float32)],
            rs.randint(0, 8, (4,)))


def _forward(pd, x, w, b, g, labels):
    """linear, layer_norm, matmul, softmax, elementwise ops, gelu, exp and
    cross_entropy."""
    F = pd.nn.functional
    h = F.linear(x, w, b)
    h = F.layer_norm(h, [8], weight=g)
    a = pd.matmul(h, h, transpose_y=True)
    p = F.softmax(a, -1)
    h2 = F.gelu(pd.matmul(p, h) * 0.5 + h)
    logits = pd.exp(h2) - 1.0
    return F.cross_entropy(logits, labels)


def _dtype_name(a):
    return str(getattr(a.dtype, "name", a.dtype)).replace("torch.", "")


def _traced(pd, disp, **amp_kw):
    """(every op's name and output dtypes, the loss) of one forward under
    auto_cast(**amp_kw)."""
    arrays, labels = _inputs()
    log = []
    remove = disp.add_op_observer(
        lambda name, outs: log.append((name, [_dtype_name(o)
                                              for o in outs])))
    try:
        with pd.amp.auto_cast(**amp_kw):
            loss = _forward(pd, *[pd.to_tensor(a) for a in arrays],
                            pd.to_tensor(labels))
    finally:
        remove()
    return log, float(loss)


# bf16/f16 compute: the two frameworks round at other points; the loss is
# held to 2 % (a few bf16 steps of 2^-8), f32 to 1e-5.
@pytest.mark.parametrize("amp_kw,rtol", [
    (dict(level="O1"), 2e-2),
    (dict(level="O2"), 2e-2),
    (dict(level="O1", custom_white_list={"softmax", "gelu"},
          custom_black_list={"matmul"}), 2e-2),
    (dict(level="O2", custom_black_list={"gelu", "linear"},
          dtype="float16"), 2e-2),
    (dict(enable=False), 1e-5),
])
def test_every_op_casts_as_the_reference(amp_kw, rtol):
    want, want_loss = _traced(ref, ref_dispatch, **amp_kw)
    got, got_loss = _traced(port, port_dispatch, **amp_kw)
    assert got == want
    assert len(got) >= 10
    np.testing.assert_allclose(got_loss, want_loss, rtol=rtol)


def test_auto_cast_state_and_nesting():
    for pd, *_ in PAIRS:
        assert not pd.amp.is_auto_cast_enabled()
        with pd.amp.auto_cast(level="O2", dtype="float16"):
            assert pd.amp.is_auto_cast_enabled()
            assert pd.amp.get_amp_dtype() == "float16"
            with pd.amp.amp_guard(enable=False):
                assert not pd.amp.is_auto_cast_enabled()
            assert pd.amp.get_amp_dtype() == "float16"
        assert not pd.amp.is_auto_cast_enabled()
        assert pd.amp.get_amp_dtype() == "bfloat16"
    assert port.amp.WHITE_LIST == ref.amp.WHITE_LIST
    assert port.amp.BLACK_LIST == ref.amp.BLACK_LIST


def test_low_precision_op_list_is_the_reference():
    lists = []
    for pd, disp, dbg, fl in PAIRS:
        fl.set_flags({"FLAGS_low_precision_op_list": True})
        dbg.clear_low_precision_op_list()
        arrays, labels = _inputs()
        for level in ("O1", "O2"):
            with pd.amp.auto_cast(level=level):
                _forward(pd, *[pd.to_tensor(a) for a in arrays],
                         pd.to_tensor(labels))
        lists.append(dbg.get_low_precision_op_list())
        fl.set_flags({"FLAGS_low_precision_op_list": False})
        dbg.clear_low_precision_op_list()
        with pd.amp.auto_cast(level="O2"):
            _forward(pd, *[pd.to_tensor(a) for a in arrays],
                     pd.to_tensor(labels))
        assert dbg.get_low_precision_op_list() == {}
    assert lists[1] == lists[0]
    assert lists[0]["matmul->bfloat16"] == 4


def _small_model(pd):
    pd.seed(0)
    return pd.nn.Sequential(pd.nn.Linear(8, 16), pd.nn.GELU(),
                            pd.nn.LayerNorm(16), pd.nn.Linear(16, 4))


def test_decorate_o2_after_the_optimizer_exists():
    """The workload's order: AdamW(multi_precision=True) first, decorate
    after. The optimizer keeps the same (now bf16) parameters, and each
    master weight is made at the first step from the bf16 value, as the
    reference's: one step on the same gradients gives the same bf16
    params and f32 master weights."""
    ref_model = _small_model(ref)
    state = {k: v.numpy() for k, v in ref_model.state_dict().items()}
    port_model = _small_model(port)
    port_model.set_state_dict(state)
    x = np.random.RandomState(1).randn(5, 8).astype(np.float32)
    results = []
    for pd, model in ((ref, ref_model), (port, port_model)):
        opt = pd.optimizer.AdamW(1e-2, parameters=model.parameters())
        before = model.parameters()
        model2, opt2 = pd.amp.decorate(model, opt, level="O2",
                                       dtype="bfloat16")
        assert model2 is model and opt2 is opt
        assert opt._multi_precision is True
        assert all(a is b for a, b in zip(opt._parameter_list, before))
        assert all(p.dtype == pd.bfloat16 for p in model.parameters())
        with pd.amp.auto_cast(level="O2"):
            loss = model(pd.to_tensor(x)).astype("float32").square().mean()
        loss.backward()
        opt.step()
        masters = [opt._master_weights[id(p)] for p in model.parameters()]
        assert all(m.dtype == pd.float32 for m in masters)
        assert all(p.dtype == pd.bfloat16 for p in model.parameters())
        results.append(([p.astype("float32").numpy()
                         for p in model.parameters()],
                        [m.numpy() for m in masters]))
    # at lr 0 each master weight is the bf16 value it was made from (not
    # the f32 value before decorate), in both packages
    for pd in (ref, port):
        model = _small_model(pd)
        f32 = [p.numpy().copy() for p in model.parameters()]
        opt = pd.optimizer.AdamW(0.0, parameters=model.parameters())
        assert not opt._master_weights
        pd.amp.decorate(model, opt, level="O2", dtype="bfloat16")
        with pd.amp.auto_cast(level="O2"):
            loss = model(pd.to_tensor(x)).astype("float32").sum()
        loss.backward()
        opt.step()
        for p, before in zip(model.parameters(), f32):
            master = opt._master_weights[id(p)].numpy()
            np.testing.assert_array_equal(master,
                                          p.astype("float32").numpy())
            if before.ndim == 2:       # the weights (biases start at 0)
                assert not np.array_equal(master, before)
    # bf16 forward and backward: gradients agree to a few bf16 steps, and
    # Adam's first step is lr * sign(g) wherever |g| >> eps, so params and
    # masters agree to one bf16 step of each value, and a few lr where a
    # gradient's sign is rounding noise
    for got, want in zip(results[1][0] + results[1][1],
                         results[0][0] + results[0][1]):
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2.5e-2)


def test_decorate_o1_leaves_params_and_accepts_no_optimizer():
    for pd, *_ in PAIRS:
        model = _small_model(pd)
        assert pd.amp.decorate(model, level="O1") is model
        assert all(p.dtype == pd.float32 for p in model.parameters())
        m2 = pd.amp.decorate(model, level="O2", dtype="float16")
        assert m2 is model
        assert all(p.dtype == pd.float16 for p in model.parameters())


def _scaler_run(pd, steps, **kw):
    """GradScaler over one parameter: each step's loss is (p * c).sum(),
    c infinite on the bad steps. Returns per-step (scale before, found_inf,
    skipped, the unscaled gradient, p after) and the final state_dict."""
    p = pd.to_tensor(np.linspace(-1, 1, 6).astype(np.float32),
                     stop_gradient=False)
    opt = pd.optimizer.SGD(0.1, parameters=[p])
    scaler = pd.amp.GradScaler(**kw)
    out = []
    for i, bad in enumerate(steps):
        c = np.full(6, 0.5 + i, np.float32)
        if bad:
            c[2] = np.inf
        scale = float(scaler.get_loss_scaling())
        scaler.scale((p * pd.to_tensor(c)).sum()).backward()
        scaler.unscale_(opt)
        grad = p.grad.numpy().copy()
        scaler.step(opt)
        scaler.update()
        out.append((scale, scaler.found_inf, scaler.last_step_skipped(),
                    grad, p.numpy().copy()))
        opt.clear_grad()
    return out, scaler.state_dict()


SCRIPT = (False, False, False, True, False, True, True, False, False,
          False, False, False)


@pytest.mark.parametrize("kw", [
    dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2),
    dict(init_loss_scaling=4.0, incr_ratio=3.0, decr_ratio=0.25,
         incr_every_n_steps=3, decr_every_n_nan_or_inf=2),
    dict(init_loss_scaling=8.0, use_dynamic_loss_scaling=False),
])
def test_grad_scaler_follows_the_reference(kw):
    want, want_sd = _scaler_run(ref, SCRIPT, **kw)
    got, got_sd = _scaler_run(port, SCRIPT, **kw)
    for i, ((gs, gf, gk, gg, gp), (ws, wf, wk, wg, wp)) in enumerate(
            zip(got, want)):
        assert (gs, gf, gk) == (ws, wf, wk), i
        # unscaling by a power of two is exact in f32; inf stays inf
        np.testing.assert_array_equal(gg, wg)
        np.testing.assert_allclose(gp, wp, rtol=1e-6)
    assert [w[1] for w in want] == list(SCRIPT)
    assert [w[2] for w in want] == list(SCRIPT)
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        np.testing.assert_array_equal(np.asarray(got_sd[k]),
                                      np.asarray(want_sd[k]))


def test_grad_scaler_state_dict_round_trips():
    _, sd = _scaler_run(port, (False, True, False),
                        init_loss_scaling=64.0, incr_every_n_steps=5)
    fresh = port.amp.GradScaler(init_loss_scaling=1.0)
    fresh.load_state_dict(sd)
    assert fresh.state_dict()["scale"] == sd["scale"] == 32.0
    assert (fresh._good_steps, fresh._bad_steps) == (1, 0)
    # the reference's own state loads into the port's scaler
    _, ref_sd = _scaler_run(ref, (True, False), init_loss_scaling=64.0)
    fresh.load_state_dict(ref_sd)
    assert float(fresh.get_loss_scaling()) == float(ref_sd["scale"])


def test_grad_scaler_disabled_and_module_path():
    for pd, *_ in PAIRS:
        scaler = pd.amp.GradScaler(enable=False)
        loss = pd.to_tensor(3.0)
        assert scaler.scale(loss) is loss
        assert not scaler.is_enable()
        assert not scaler.last_step_skipped()
    assert port.amp.AmpScaler is port.amp.GradScaler
    assert port_grad_scaler.GradScaler is port.amp.GradScaler
    assert [s.name for s in port_grad_scaler.OptimizerState] == \
        ["INIT", "UNSCALED", "STEPPED"]


def test_supported_dtypes_on_the_cpu():
    assert port.amp.is_bfloat16_supported() == ref.amp.is_bfloat16_supported()
    assert port.amp.is_float16_supported() == ref.amp.is_float16_supported() \
        is False


def test_check_numerics_as_the_reference(capsys):
    bad = np.array([1.0, np.nan, np.inf, -np.inf], np.float32)
    for pd, _, dbg, _ in PAIRS:
        assert dbg.check_numerics(pd.to_tensor(np.ones(3, np.float32)),
                                  "op", "v") == (0, 0)
        with pytest.raises(RuntimeError, match="1 NaN, 2 Inf"):
            dbg.check_numerics(pd.to_tensor(bad), "op", "v")
        assert dbg.check_numerics(pd.to_tensor(bad), "op", "v",
                                  dbg.DebugMode.CHECK_NAN_INF) == (1, 2)
    out = capsys.readouterr().out.splitlines()
    assert out == ["[check_numerics] op=op var=v: 1 NaN, 2 Inf"] * 2


def test_tensor_checker_as_the_reference():
    for pd, _, dbg, fl in PAIRS:
        x = pd.to_tensor(np.array([1.0, 0.0], np.float32))
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
        assert fl.get_flag("FLAGS_check_nan_inf")
        with pytest.raises(FloatingPointError, match="'log'"):
            pd.log(x - 1.0)
        dbg.disable_tensor_checker()
        assert not fl.get_flag("FLAGS_check_nan_inf")
        pd.log(x - 1.0)
        dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=False))
        assert not fl.get_flag("FLAGS_check_nan_inf")


def test_operator_stats_as_the_reference(capsys):
    tables = []
    for pd, _, dbg, _ in PAIRS:
        with dbg.collect_operator_stats():
            x = pd.to_tensor(np.ones((2, 3), np.float32))
            y = pd.matmul(x, x, transpose_y=True) + 1.0
            with pd.amp.auto_cast(level="O2"):
                pd.matmul(y, y)
            pd.cast(y, "int32")
        tables.append(capsys.readouterr().out)
        dbg.enable_operator_stats_collection()
        dbg.disable_operator_stats_collection()     # nothing: no table
        assert capsys.readouterr().out == ""
    assert tables[1] == tables[0]
    assert "matmul:bfloat16  called 1 times" in tables[0]
    assert "op list" in tables[0] and "float32" in tables[0]
