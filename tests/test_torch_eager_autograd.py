"""The port's autograd (paddle_tpu_torch.autograd on torch.autograd) and its
eager dispatch, against the reference on the CPU.

Each test runs the same program through ``paddle_tpu`` and
``paddle_tpu_torch`` and compares the values and gradients (f32, rtol 1e-5
plus 1e-5 of the scale): PyLayer (first and second order), hooks, ``grad``
with ``create_graph``, ``jacobian``/``hessian``, ``no_grad``,
``saved_tensors_hooks``, and inplace ops on tensors that autograd saved,
where the reference's rebind semantics hold and torch's "modified by an
inplace operation" error must not appear. The dispatch features
(``FLAGS_check_nan_inf``, ``FLAGS_op_log``, ``FLAGS_call_stack_level``,
``FLAGS_retain_grad_for_all``, the eager counters) are checked on the port.
"""
import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _both(program):
    """program(paddle) -> list of numpy arrays, run on both packages."""
    want, got = program(P), program(T)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


X = np.array([[0.5, -1.2, 2.0], [1.5, 0.3, -0.7]], np.float32)
W = np.array([[0.2, -0.4], [1.1, 0.6], [-0.3, 0.9]], np.float32)


def _cube_layer(paddle):
    class Cube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, scale):
            ctx.save_for_backward(x)
            ctx.scale = scale
            return x * x * x * scale

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor
            return dy * 3.0 * x * x * ctx.scale
    return Cube


def test_pylayer_first_order():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        y = _cube_layer(paddle).apply(x, 2.0)
        (y * paddle.to_tensor(X)).sum().backward()
        return [y.numpy(), x.grad.numpy()]
    _both(program)


def test_pylayer_second_order_through_its_backward():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        y = _cube_layer(paddle).apply(x, 0.5)
        (g,) = paddle.grad(y.sum(), x, create_graph=True)
        (g2,) = paddle.grad((g * g).sum(), x)
        return [g.numpy(), g2.numpy()]
    _both(program)


def test_pylayer_multiple_outputs_and_non_differentiable():
    def program(paddle):
        class SplitScale(paddle.autograd.PyLayer):
            @staticmethod
            def forward(ctx, x, w):
                ctx.save_for_backward(x, w)
                idx = paddle.argmax(x, axis=1)
                ctx.mark_non_differentiable(idx)
                return paddle.matmul(x, w), x * 2.0, idx

            @staticmethod
            def backward(ctx, g_mm, g_twice, g_idx):
                x, w = ctx.saved_tensor
                return (paddle.matmul(g_mm, w, transpose_y=True)
                        + g_twice * 2.0,
                        paddle.matmul(x, g_mm, transpose_x=True))
        x = paddle.to_tensor(X, stop_gradient=False)
        w = paddle.to_tensor(W, stop_gradient=False)
        mm, twice, idx = SplitScale.apply(x, w)
        assert idx.stop_gradient
        (mm.sum() * 3.0 + (twice * twice).sum()).backward()
        return [mm.numpy(), twice.numpy(), idx.numpy(), x.grad.numpy(),
                w.grad.numpy()]
    _both(program)


def test_saved_tensors_hooks_pack_and_unpack():
    def program(paddle):
        seen = []

        def pack(t):
            seen.append("pack")
            return t.numpy()

        def unpack(a):
            seen.append("unpack")
            return paddle.to_tensor(a)
        x = paddle.to_tensor(X, stop_gradient=False)
        with paddle.autograd.saved_tensors_hooks(pack, unpack):
            y = _cube_layer(paddle).apply(x, 1.0)
        y.sum().backward()
        assert seen == ["pack", "unpack"]
        return [x.grad.numpy()]
    _both(program)


def test_hooks_on_leaf_and_intermediate():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        seen = []
        x.register_hook(lambda g: seen.append(g.numpy()))
        h = paddle.tanh(x)
        handle = h.register_hook(lambda g: g * 3.0)
        (h * h).sum().backward()
        first = x.grad.numpy().copy()
        handle.remove()
        x.clear_grad()
        (paddle.tanh(x) * 2.0).sum().backward()
        return [first, seen[0], x.grad.numpy()]
    _both(program)


def test_grad_second_derivative_and_allow_unused():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        z = paddle.to_tensor(X * 2, stop_gradient=False)
        y = (paddle.sin(x) * x).sum()
        (g,) = paddle.grad(y, x, create_graph=True)
        assert not g.stop_gradient
        (g2,) = paddle.grad(g.sum(), x)
        assert x.grad is None
        with pytest.raises(RuntimeError):
            paddle.grad((x * 2).sum(), [x, z])
        gx, gz = paddle.grad((x * 2).sum(), [x, z], allow_unused=True)
        assert gz is None
        return [g.numpy(), g2.numpy(), gx.numpy()]
    _both(program)


def test_jacobian_and_hessian():
    def program(paddle):
        x = paddle.to_tensor(X[0])
        w = paddle.to_tensor(W)
        jac = paddle.autograd.jacobian(
            lambda t: paddle.tanh(paddle.matmul(t, w)), x)
        hes = paddle.autograd.hessian(lambda t: (paddle.exp(t) * t).sum(), x)
        jx, jw = paddle.autograd.jacobian(
            lambda a, b: paddle.matmul(a, b), [x, w])
        return [jac.numpy(), hes.numpy(), jx.numpy(), jw.numpy()]
    _both(program)


def test_no_grad_enable_grad_and_set_grad_enabled():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        with paddle.no_grad():
            a = x * 2
            with paddle.enable_grad():
                b = x * 3
        assert a.stop_gradient and not b.stop_gradient
        assert paddle.is_grad_enabled()

        @paddle.no_grad()
        def frozen(t):
            return t * 4
        assert frozen(x).stop_gradient
        with paddle.set_grad_enabled(False):
            assert not paddle.is_grad_enabled()
        b.sum().backward()
        return [a.numpy(), x.grad.numpy()]
    _both(program)


def test_inplace_on_a_saved_tensor_keeps_the_reference_semantics():
    """y is saved by y * y, then rebound by an inplace op: backward uses the
    value y had when it was saved (torch would refuse a real in-place
    write)."""
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        y = x * 1.5
        z = y * y
        y.add_(paddle.to_tensor(np.ones_like(X)))
        y.scale_(2.0)
        y[0, 1] = 5.0
        (z.sum() + (y * y).sum()).backward()
        return [z.numpy(), y.numpy(), x.grad.numpy()]
    _both(program)


def test_inplace_on_a_trainable_leaf():
    """An inplace op on a leaf that requires grad: the leaf's gradient
    collects the uses before and after the rebind."""
    def program(paddle):
        w = paddle.to_tensor(X, stop_gradient=False)
        before = w * 2.0
        w.scale_(3.0)
        w.exp_()
        (before.sum() + w.sum()).backward()
        assert w.inplace_version() == 2
        return [w.numpy(), w.grad.numpy()]
    _both(program)


def test_update_under_no_grad_keeps_leaf_and_grad():
    """An optimizer-style update: the parameter stays a trainable leaf, its
    gradient survives the update and accumulates on the next backward."""
    def program(paddle):
        w = paddle.to_tensor(X, stop_gradient=False)
        (w * w).sum().backward()
        with paddle.no_grad():
            w.set_value(w - 0.1 * w.grad)
            w.subtract_(paddle.to_tensor(np.full_like(X, 0.01)))
        g1 = w.grad.numpy().copy()
        assert w.is_leaf and not w.stop_gradient
        (w * 3.0).sum().backward()
        out = [w.numpy(), g1, w.grad.numpy()]
        w.clear_grad()
        assert w.grad is None
        return out
    _both(program)


def test_inplace_on_a_grad_changes_the_stored_grad():
    """grad is one handle, written through: an inplace op on it (as an
    optimizer's gradient clipping does) changes what the next backward
    accumulates onto."""
    def program(paddle):
        w = paddle.to_tensor(X, stop_gradient=False)
        (w * w).sum().backward()
        g = w.grad
        assert w.grad is g or paddle is P
        g.scale_(0.5)
        first = w.grad.numpy().copy()
        (w * 3.0).sum().backward()
        return [first, w.grad.numpy()]
    _both(program)


def test_stop_gradient_and_detach():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        y = x * 2.0
        y.stop_gradient = True
        z = x * 3.0
        d = z.detach()
        assert d.stop_gradient and not z.stop_gradient
        (y * x + d * x).sum().backward()
        return [x.grad.numpy()]
    _both(program)


def test_multi_root_backward_with_grad_tensors():
    def program(paddle):
        x = paddle.to_tensor(X, stop_gradient=False)
        a, b_ = paddle.sin(x), paddle.cos(x)
        paddle.autograd.backward(
            [a, b_], [paddle.to_tensor(X), paddle.to_tensor(np.ones_like(X))])
        return [x.grad.numpy()]
    _both(program)


# ------------------------------------------------------- dispatch features
def test_check_nan_inf_raises_and_dumps(tmp_path):
    x = T.to_tensor([0.0, 1.0])
    T.set_flags({"FLAGS_check_nan_inf": True,
                 "FLAGS_nan_inf_dump_dir": str(tmp_path)})
    try:
        with pytest.raises(FloatingPointError, match="'log'"):
            T.log(x)
        assert any(p.name.startswith("naninf_log") for p in tmp_path.iterdir())
        T.exp(x)
    finally:
        T.set_flags({"FLAGS_check_nan_inf": False,
                     "FLAGS_nan_inf_dump_dir": ""})
    T.log(x)


def test_op_log_and_call_stack_level(capsys):
    x = T.to_tensor(X)
    T.set_flags({"FLAGS_op_log": True, "FLAGS_op_log_filter": "tanh"})
    try:
        T.tanh(x)
        T.exp(x)
    finally:
        T.set_flags({"FLAGS_op_log": False, "FLAGS_op_log_filter": ""})
    err = capsys.readouterr().err
    assert "[op] tanh(float32[2, 3]) -> float32[2, 3]" in err
    assert "exp" not in err
    T.set_flags({"FLAGS_call_stack_level": 2})
    try:
        with pytest.raises(RuntimeError, match="op 'matmul' failed"):
            T.matmul(x, x)
    finally:
        T.set_flags({"FLAGS_call_stack_level": 1})


def test_retain_grad_for_all_and_observers():
    seen = []
    remove = T.core.dispatch.add_op_observer(lambda n, outs: seen.append(n))
    T.set_flags({"FLAGS_retain_grad_for_all": True})
    try:
        x = T.to_tensor(X, stop_gradient=False)
        h = T.tanh(x)
        (h * 2.0).sum().backward()
    finally:
        T.set_flags({"FLAGS_retain_grad_for_all": False})
        remove()
    np.testing.assert_allclose(h.grad.numpy(), np.full_like(X, 2.0))
    assert seen[:2] == ["tanh", "multiply"]


def test_eager_counters_tick():
    from paddle_tpu_torch.observability import metrics as met
    ops = met.REGISTRY.counter("eager.op_dispatches")
    recorded = met.REGISTRY.counter("eager.grad_ops")
    was = met.enabled()
    met.enable()
    try:
        n0, g0 = ops.value, recorded.value
        x = T.to_tensor(X, stop_gradient=False)
        T.tanh(x)
        T.tanh(T.to_tensor(X))
        assert (ops.value - n0, recorded.value - g0) == (2, 1)
    finally:
        if not was:
            met.disable()


def test_flags_registry_is_the_references():
    """Every flag the port defines is one of the reference's, with its
    default; a flag nothing in the port reads is refused, not ignored."""
    import paddle_tpu.ops.pallas.autotune  # noqa: F401  (defines its flag)
    import paddle_tpu_torch.ops.hopper.autotune  # noqa: F401
    import paddle_tpu_torch.inference.decode  # noqa: F401  (defines its flag)
    import paddle_tpu_torch.amp  # noqa: F401  (defines its flag)
    from paddle_tpu.core import flags as jflags
    from paddle_tpu_torch.core import flags as tflags
    port = {n: f.default for n, f in tflags._REGISTRY.items()
            if not n.startswith("FLAGS_test_")}
    # the 11 eager ones, FLAGS_attn_autotune, FLAGS_kv_capacity_check,
    # FLAGS_low_precision_op_list, the 6 of training robustness
    # (FLAGS_max_bad_steps, FLAGS_step_timeout_s, FLAGS_watchdog_interval_s,
    # FLAGS_watchdog_store_root, FLAGS_memory_stats_dump_path,
    # FLAGS_collective_timeout_s), the 3 of jit (FLAGS_print_jaxpr,
    # FLAGS_max_specializations, FLAGS_max_shape_specializations) and
    # the collectives' FLAGS_collective_debug and FLAGS_collective_matmul
    assert len(port) == 25
    assert port == {n: jflags._REGISTRY[n].default for n in port}
    assert set(tflags.get_flags()) >= set(port)
    with pytest.raises(KeyError, match="FLAGS_benchmark"):
        tflags.set_flags({"FLAGS_benchmark": True})


def test_second_flag_observer_keeps_dispatch_in_step():
    """A later observer on a flag dispatch watches must not displace
    dispatch's own: FLAGS_check_nan_inf still takes effect."""
    from paddle_tpu_torch.core import flags as tflags
    seen = []
    tflags.on_flag_change("FLAGS_check_nan_inf", seen.append)
    try:
        T.set_flags({"FLAGS_check_nan_inf": True})
        with pytest.raises(FloatingPointError, match="'log'"):
            T.log(T.to_tensor([0.0, 1.0]))
    finally:
        T.set_flags({"FLAGS_check_nan_inf": False})
        tflags._OBSERVERS["FLAGS_check_nan_inf"].remove(seen.append)
    assert seen == [True, False]


# ---- gradients at kinks and ties (the reference's conventions) -------------
def _F(paddle):
    return paddle.nn.functional


def _const(paddle, values):
    return paddle.to_tensor(np.asarray(values, np.float32))


# op -> (program over the inputs, the inputs): each row at the kink or tie
# that ROADMAP's queue 3 logged, where torch's own subgradient differed
KINKS = {
    "clip": (lambda p, x: p.clip(x, 1.0, 2.0), [[1, 1.5, 2]]),
    "abs": (lambda p, x: p.abs(x), [[0, -1, 1]]),
    "hardtanh": (lambda p, x: _F(p).hardtanh(x), [[-1, 1, 0]]),
    "leaky_relu": (lambda p, x: _F(p).leaky_relu(x, 0.1), [[0, -1, 1]]),
    "rrelu_eval": (lambda p, x: _F(p).rrelu(x, training=False),
                   [[0, -1, 1]]),
    "hardsigmoid": (lambda p, x: _F(p).hardsigmoid(x), [[-3, 3, 0]]),
    "hardswish": (lambda p, x: _F(p).hardswish(x), [[-3, 3, 0]]),
    "l1_loss": (lambda p, x: _F(p).l1_loss(x, _const(p, [0, 1, 1])),
                [[0, 1, 2]]),
    "margin_ranking_loss": (
        lambda p, x: _F(p).margin_ranking_loss(
            x, p.zeros([3]), p.ones([3]), margin=1.0), [[1, -1, 0.5]]),
    "hinge_embedding_loss": (
        lambda p, x: _F(p).hinge_embedding_loss(
            x, _const(p, [-1, -1, 1]), margin=1.0), [[1, -1, 0.5]]),
    "fmax": (lambda p, x: p.fmax(x, p.ones([3])), [[1, 0, 2]]),
    "fmin": (lambda p, x: p.fmin(x, p.ones([3])), [[1, 2, 0]]),
    "cummax": (lambda p, x: p.cummax(x, axis=0)[0], [[1, 3, 2, 3]]),
    "cummin": (lambda p, x: p.cummin(x, axis=0)[0], [[3, 1, 2, 1]]),
    "cummax_odd_2d": (lambda p, x: p.cummax(x, axis=1)[0],
                      [[[2, 2, 1, 2, 2], [0, 1, 1, 1, 0]]]),
    "norm_p1": (lambda p, x: p.norm(x, p=1), [[0, -2, 3]]),
    "norm_p1_axis": (lambda p, x: p.norm(x, p=1, axis=0), [[0, -2, 3]]),
    "dist_p1": (lambda p, x: p.dist(x, p.zeros([3]), p=1), [[0, -2, 3]]),
    "normalize_p1": (lambda p, x: _F(p).normalize(x, p=1, axis=0)[1],
                     [[0, -2, 3]]),
    # off the origin only: there the reference's gradient is NaN and the
    # port keeps torch's 0 (a deliberate difference, ROADMAP)
    "atan2": (lambda p, x, y: p.atan2(x, y), [[0, 1], [1, -1]]),
}


def _grads(paddle, program, inputs):
    ts = [paddle.to_tensor(np.asarray(x, np.float32), stop_gradient=False)
          for x in inputs]
    out = program(paddle, *ts)
    (out.sum() if out.ndim else out).backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("name", sorted(KINKS))
def test_gradients_at_kinks_and_ties_are_the_references(name):
    program, inputs = KINKS[name]
    for got, want in zip(_grads(T, program, inputs),
                         _grads(P, program, inputs)):
        np.testing.assert_array_equal(got, want)


def test_atan2_at_the_origin_keeps_torchs_zero():
    gx, gy = _grads(T, lambda p, x, y: p.atan2(x, y), [[0.0], [0.0]])
    assert gx.tolist() == [0.0] and gy.tolist() == [0.0]
    assert np.isnan(_grads(P, lambda p, x, y: p.atan2(x, y),
                           [[0.0], [0.0]])[0]).all()


def test_heaviside_gradients_are_jnp_heavisides():
    x = [0.0, 1.0, -1.0, 0.0]
    y = [0.5, 0.5, 0.5, 2.0]

    def program(p, xt, yt):
        return p.heaviside(xt, yt) * xt + p.heaviside(xt, yt) * yt

    got, want = _grads(T, program, [x, y]), _grads(P, program, [x, y])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # with a scalar y, as ROADMAP's input: x.grad = [0.5, 1, 0]
    gx = _grads(T, lambda p, xt: p.heaviside(
        xt, p.to_tensor(np.float32(0.5))) * xt, [[0.0, 1.0, -1.0]])[0]
    np.testing.assert_array_equal(gx, [0.5, 1.0, 0.0])
