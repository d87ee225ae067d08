"""``distributed.utils.global_scatter``/``global_gather`` (the MoE exchange)
against the reference.

Without a process group the reference's eager functions sort the rows by
expert id, which the counted row blocks already are in: the identity on
``x`` (checked here against the reference's code, not assumed), which the
port's exchange with itself gives when the counts cover x's rows. At two
gloo ranks of two experts each the port is held to the reference's
documented multi-rank semantics (distributed/utils/moe_utils.py, restated
in numpy below: the row blocks go to their experts' ranks and arrive
expert-major), to the round trip gather(scatter(x)) == x, and to the
gradients: each one's backward is the other. Values exact (the exchange
moves rows)."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
from paddle_tpu.distributed.utils import (global_gather as jgather,
                                          global_scatter as jscatter)
from paddle_tpu_torch._testing import (MOE_LOCAL_COUNTS, moe_exchange_rows,
                                       run_workers, share_the_cores_fixture)

_share_the_cores = share_the_cores_fixture()

WORKER = ("from paddle_tpu_torch._testing import moe_exchange_worker\n"
          "import sys\n"
          "moe_exchange_worker(sys.argv[1])\n")


def _port():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.utils import global_gather, \
        global_scatter
    paddle.set_device("cpu")
    return paddle, global_scatter, global_gather


@pytest.mark.parametrize("counts", [[2, 1, 3], [0, 4, 2], [6]])
def test_world_1_equals_reference(counts):
    """Counts covering x's rows: the reference's scatter and gather are the
    identity on x, and so are the port's."""
    paddle, scatter, gather = _port()
    x = np.random.RandomState(0).randn(6, 4).astype(np.float32)
    c = np.asarray(counts)
    js = jscatter(jpaddle.to_tensor(x), jpaddle.to_tensor(c),
                  jpaddle.to_tensor(c)).numpy()
    np.testing.assert_array_equal(js, x)
    np.testing.assert_array_equal(
        jgather(jpaddle.to_tensor(js), jpaddle.to_tensor(c),
                jpaddle.to_tensor(c)).numpy(), x)
    s = scatter(paddle.to_tensor(x), paddle.to_tensor(c),
                paddle.to_tensor(c))
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(gather(s, c, c).numpy(), x)


def test_world_1_uncounted_rows():
    """Counts short of x's rows: the reference's eager form keeps every row
    (it only sorts them); the port sends the counted rows, as the
    reference's NCCL op does, and gives uncounted rows a zero gradient."""
    paddle, scatter, _ = _port()
    x = np.random.RandomState(1).randn(5, 2).astype(np.float32)
    c = np.asarray([1, 2])
    js = jscatter(jpaddle.to_tensor(x), jpaddle.to_tensor(c),
                  jpaddle.to_tensor(c)).numpy()
    np.testing.assert_array_equal(js, x)
    xt = paddle.to_tensor(x, stop_gradient=False)
    s = scatter(xt, c, c)
    np.testing.assert_array_equal(s.numpy(), x[:3])
    s.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy()[:3], 1.0)
    np.testing.assert_array_equal(xt.grad.numpy()[3:], 0.0)


def _reference_exchange():
    """The reference's semantics in numpy: {rank: (scatter output, the
    gradient of sum(w * scatter(x)) with respect to x)}."""
    n, ne = 2, 2
    xs = {r: moe_exchange_rows(r)[0] for r in range(n)}
    ws = {r: moe_exchange_rows(r)[1] for r in range(n)}

    def blocks(r):          # rank r's x rows for global expert j * ne + i
        lc = MOE_LOCAL_COUNTS[r]
        off = np.concatenate([[0], np.cumsum(lc)])
        return {k: (off[k], off[k + 1]) for k in range(n * ne)}
    out, grads = {}, {}
    for r in range(n):
        rows, where = [], []
        for i in range(ne):             # expert-major
            for j in range(n):          # then source rank
                lo, hi = blocks(j)[r * ne + i]
                rows.append(xs[j][lo:hi])
                where.append((j, lo, hi))
        out[r] = np.concatenate(rows)
        grads[r] = where
    g = {r: np.zeros_like(xs[r]) for r in range(n)}
    for r in range(n):
        off = 0
        for j, lo, hi in grads[r]:
            g[j][lo:hi] += ws[r][off:off + hi - lo]
            off += hi - lo
    return out, g


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe2")
    script = out / "worker.py"
    script.write_text(WORKER)
    res = run_workers(script, 2, [out], timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = []
    for r in range(2):
        with np.load(out / f"moe.{r}.npz") as f:
            got.append({k: f[k] for k in f.files})
    return got


def test_two_ranks_follow_the_reference_semantics(two):
    want, grads = _reference_exchange()
    for r, res in enumerate(two):
        np.testing.assert_array_equal(res["scatter"], want[r])
        np.testing.assert_array_equal(res["grad"], grads[r])


def test_two_ranks_round_trip(two):
    """gather(scatter(x)) == x on every rank, and its gradient with respect
    to x of sum(x * gather(scatter(x))) is 2 x."""
    for r, res in enumerate(two):
        x = moe_exchange_rows(r)[0][:sum(MOE_LOCAL_COUNTS[r])]
        np.testing.assert_array_equal(res["back"], x)
        np.testing.assert_array_equal(res["back_grad"], 2 * x)
