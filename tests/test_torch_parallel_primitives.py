"""The differentiable collectives, ring and Ulysses attention, the
sequence-parallel linears and the sequence-sharding helpers of the port
(``distributed.collective.ops``, ``paddle_tpu_torch.parallel``,
``fleet.sequence_parallel_utils``) against the reference's
(``paddle_tpu.parallel`` and lax's collectives under ``shard_map`` on the
virtual CPU devices, ``tests/test_parallel_primitives.py``).

The port runs one process a rank: one worker group of 2 and one of 4 gloo
ranks (started by the port's launcher) run every case and write each
rank's outputs and gradients; the reference runs the same inputs, made from
numpy seeds, over a mesh of as many devices. Each collective's gradient is
held against jax's transpose: ``jax.grad`` of sum(out * c) through
``shard_map``, against each rank's gradient of its own sum(out_r * c_r)
(the global loss is the sum over ranks for a sharded output, the one value
for a replicated one). f32; tolerances: the collectives and the
sequence-sharding helpers move values exactly, so 1e-6; attention as the
reference's own tests (2e-4 outputs; gradients 3e-4 ring, 2e-3 rtol and
2e-4 atol Ulysses), outputs and gradients from one input at the
reference's output shape; the sp linears 1e-5 of each value's scale.

The reference's two pipeline tests of that file are restated in
``tests/test_torch_pp_schedule.py`` (``pipeline_apply``), and
``tests/test_torch_pipeline.py`` holds ``pipeline_apply`` over gloo ranks
against the reference's.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

WORLDS = (2, 4)

WORKER = r'''
import os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import torch
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.fleet import (ColumnSequenceParallelLinear,
                                                RowSequenceParallelLinear)
from paddle_tpu_torch.distributed.fleet import mp_layers
from paddle_tpu_torch.distributed.fleet.sequence_parallel_utils import (
    all_gather, register_sequence_parallel_allreduce_hooks, scatter)
from paddle_tpu_torch.distributed.mesh import ProcessMesh, set_mesh
from paddle_tpu_torch.parallel import (gather_sequence, shard_sequence,
                                       ulysses_attention)
from paddle_tpu_torch.parallel.ring_attention import ring_attention_sharded
from paddle_tpu_torch.parallel.ulysses import ulysses_attention_sharded

out = sys.argv[1]
dist.init_parallel_env()
n, r = dist.get_world_size(), dist.get_rank()
res = {}
sp = ProcessMesh(shape=[n], dim_names=["sp"])
set_mesh(sp)

def arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)

def t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)

def block(a, i, k):
    return a[i * k:(i + 1) * k]

# --- each collective's forward and its gradient (jax's transpose)
cases = {
    # op: (local input, local cotangent, fn)
    "psum": (block(arr(1, 4 * n, 3), r, 4), arr(2, 4, 3),
             lambda x: C.ops.psum(x, "sp")),
    "pmean": (block(arr(1, 4 * n, 3), r, 4), arr(2, 4, 3),
              lambda x: C.ops.pmean(x, "sp")),
    "pvary": (arr(3, 4, 3), block(arr(4, 4 * n, 3), r, 4),
              lambda x: C.ops.pvary(x, "sp") * t(block(arr(5, 4 * n, 3),
                                                       r, 4))),
    "all_gather": (block(arr(6, 2 * n, 3), r, 2),
                   block(arr(7, 2 * n * n, 3), r, 2 * n),
                   lambda x: C.ops.all_gather(x, "sp", axis=0, tiled=True)),
    "all_gather_axis1": (block(arr(6, 2 * n, 3), r, 2),
                         block(arr(8, 2 * n, 3 * n), r, 2),
                         lambda x: C.ops.all_gather(x, "sp", axis=1,
                                                    tiled=True)),
    "psum_scatter": (block(arr(9, 4 * n, 3), r, 4),
                     block(arr(10, 4, 3), r, 4 // n),
                     lambda x: C.ops.psum_scatter(x, "sp",
                                                  scatter_dimension=0,
                                                  tiled=True)),
    "all_to_all": (block(arr(11, 2 * n * n, 3), r, 2 * n),
                   block(arr(12, 2 * n, 3 * n), r, 2),
                   lambda x: C.ops.all_to_all(x, "sp", 0, 1, tiled=True)),
    "ppermute": (block(arr(13, 2 * n, 3), r, 2), block(arr(14, 2 * n, 3),
                                                       r, 2),
                 lambda x: C.ops.ppermute(
                     x, "sp", [(i, (i + 1) % n) for i in range(n)])),
}
for name, (x, c, fn) in cases.items():
    xt = t(x, True)
    y = fn(xt)
    (y * t(c)).sum().backward()
    res[f"coll.{name}.out"] = y.detach().numpy()
    res[f"coll.{name}.grad"] = xt.grad.numpy()
res["coll.axis"] = np.asarray([C.ops.axis_index("sp"), C.ops.axis_size("sp")])

# --- ring and Ulysses attention, global form, causal and not
for fname, fn in (("ring", ring_attention_sharded),
                  ("ulysses", ulysses_attention_sharded)):
    for causal in (False, True):
        qkv = [t(arr(20 + i, 2, 32, 4, 16), True) for i in range(3)]
        o = fn(*qkv, sp, "sp", causal=causal)
        (o ** 2).sum().backward()
        res[f"{fname}.{causal}.out"] = o.detach().numpy()
        for i, a in enumerate(qkv):
            res[f"{fname}.{causal}.grad{i}"] = a.grad.numpy()
q = t(arr(40, 1, 16, 3, 8))
try:
    ulysses_attention_sharded(q, q, q, sp, "sp")
    res["ulysses.indivisible"] = np.asarray(0)
except ValueError as e:
    res["ulysses.indivisible"] = np.asarray(int("heads" in str(e)))
try:
    ulysses_attention(q[:, :16 // n], q[:, :16 // n], q[:, :16 // n], "sp")
    res["ulysses.indivisible_local"] = np.asarray(0)
except ValueError as e:
    res["ulysses.indivisible_local"] = np.asarray(int("heads" in str(e)))

# --- shard_sequence / gather_sequence
x = t(arr(50, 2, 8, 4), True)
xs = shard_sequence(x, sp, "sp")
res["seq.shard"] = xs.detach().numpy()
back = gather_sequence(xs, sp, "sp")
(back * t(arr(51, 2, 8, 4))).sum().backward()
res["seq.gather"] = back.detach().numpy()
res["seq.grad"] = x.grad.numpy()
px = paddle.to_tensor(arr(50, 2, 8, 4))
res["seq.tensor"] = gather_sequence(shard_sequence(px, sp, "sp"), sp,
                                    "sp").numpy()

# --- the sequence-parallel linears (reference :189) over an "mp" mesh
set_mesh(ProcessMesh(shape=[n], dim_names=["mp"]))
paddle.seed(7)
col = ColumnSequenceParallelLinear(16, 32, gather_output=False)
row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
for layer, base in ((col, 60), (row, 62)):
    mp_layers.set_global_params(layer, {
        k: arr(base + i, *p.global_shape)
        for i, (k, p) in enumerate(sorted(layer.named_parameters()))})
class Pair(paddle.nn.Layer):
    def __init__(self):
        super().__init__()
        self.col, self.row = col, row
register_sequence_parallel_allreduce_hooks(Pair())
x = paddle.to_tensor(arr(0, 2, 8, 16))
y = all_gather(row(col(scatter(x))))
res["sp.out"] = y.numpy()
paddle.mean(y ** 2).backward()
for layer, tag in ((col, "col"), (row, "row")):
    for k, p in layer.named_parameters():
        g = p.grad._data
        if getattr(p, "split_axis", None) is not None:
            g = C._gather_along(g, p.mp_group, p.split_axis)
        res[f"sp.{tag}.{k}.grad"] = g.numpy()
np.savez(os.path.join(out, f"prim.{n}.{r}.npz"), **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("prim")
    script = out / "worker.py"
    script.write_text(WORKER)
    # the two worker groups run at once (each waits on its own imports)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for res in pool.map(lambda n: run_workers(script, n, [out],
                                                  timeout=120), WORLDS):
            assert res.returncode == 0, res.stderr[-3000:]
    return out


def _port(runs, n, r):
    with np.load(runs / f"prim.{n}.{r}.npz") as f:
        return {k: f[k] for k in f.files}


def _arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mesh(n, name="sp"):
    return Mesh(np.asarray(jax.devices()[:n]), (name,))


def _smap(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)


def _jax_collective(name, n):
    """(global output, gradient of the global input) of the reference's lax
    collective under shard_map; the port's rank r holds block r of each
    sharded one and the whole of a replicated one."""
    mesh = _mesh(n)
    perm = [(i, (i + 1) % n) for i in range(n)]
    w = jnp.asarray(_arr(5, 4 * n, 3))
    table = {
        "psum": (_arr(1, 4 * n, 3), _arr(2, 4, 3),
                 lambda x: lax.psum(x, "sp"), P("sp"), P()),
        "pmean": (_arr(1, 4 * n, 3), _arr(2, 4, 3),
                  lambda x: lax.pmean(x, "sp"), P("sp"), P()),
        "pvary": (_arr(3, 4, 3), _arr(4, 4 * n, 3), None, P(), P("sp")),
        "all_gather": (_arr(6, 2 * n, 3), _arr(7, 2 * n * n, 3),
                       lambda x: lax.all_gather(x, "sp", axis=0, tiled=True),
                       P("sp"), P("sp")),
        "all_gather_axis1": (_arr(6, 2 * n, 3), _arr(8, 2 * n, 3 * n),
                             lambda x: lax.all_gather(x, "sp", axis=1,
                                                      tiled=True),
                             P("sp"), P("sp")),
        "psum_scatter": (_arr(9, 4 * n, 3), _arr(10, 4, 3),
                         lambda x: lax.psum_scatter(
                             x, "sp", scatter_dimension=0, tiled=True),
                         P("sp"), P("sp")),
        "all_to_all": (_arr(11, 2 * n * n, 3), _arr(12, 2 * n, 3 * n),
                       lambda x: lax.all_to_all(x, "sp", 0, 1, tiled=True),
                       P("sp"), P("sp")),
        "ppermute": (_arr(13, 2 * n, 3), _arr(14, 2 * n, 3),
                     lambda x: lax.ppermute(x, "sp", perm), P("sp"),
                     P("sp")),
    }
    x, c, fn, ins, outs = table[name]
    if name == "pvary":
        def f(xx):
            return _smap(lambda a, b: lax.pcast(a, ("sp",), to="varying")
                         * b, mesh, (P(), P("sp")), P("sp"))(xx, w)
    else:
        f = _smap(fn, mesh, ins, outs)

    def loss(xx):
        return jnp.sum(f(xx) * c)
    return np.asarray(f(jnp.asarray(x))), \
        np.asarray(jax.grad(loss)(jnp.asarray(x))), ins, outs


def _block(a, r, n):
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


COLLECTIVES = ("psum", "pmean", "pvary", "all_gather", "all_gather_axis1",
               "psum_scatter", "all_to_all", "ppermute")


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_and_its_gradient_match_lax(runs, name, n):
    out, grad, ins, outs = _jax_collective(name, n)
    for r in range(n):
        got = _port(runs, n, r)
        want_out = out if outs == P() else _block(out, r, n)
        want_grad = grad if ins == P() else _block(grad, r, n)
        np.testing.assert_allclose(got[f"coll.{name}.out"], want_out,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[f"coll.{name}.grad"], want_grad,
                                   rtol=1e-6, atol=1e-6)
        assert got["coll.axis"].tolist() == [r, n]


def _ref_attention(name, n, causal, q, k, v):
    from paddle_tpu.parallel import ulysses_attention_sharded
    from paddle_tpu.parallel.ring_attention import ring_attention_sharded
    fn = ring_attention_sharded if name == "ring" \
        else ulysses_attention_sharded
    return fn(q, k, v, _mesh(n), "sp", causal=causal)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", ["ring", "ulysses"])
def test_sequence_attention_matches_reference(runs, name, causal, n):
    """test_ring_attention_matches_dense, _grads_match_dense and the
    Ulysses pair, restated: the port's global form on every rank against
    the reference's on n devices, outputs and q/k/v gradients of
    sum(out ** 2), at the reference's output shape (B2 S32 H4 D16)."""
    qkv = [jnp.asarray(_arr(20 + i, 2, 32, 4, 16)) for i in range(3)]

    def loss(q, k, v):
        o = _ref_attention(name, n, causal, q, k, v)
        return jnp.sum(o ** 2), o
    (_, want), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(*qkv)
    want = np.asarray(want)
    gtol = dict(rtol=3e-4, atol=3e-4) if name == "ring" \
        else dict(rtol=2e-3, atol=2e-4)
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_allclose(got[f"{name}.{causal}.out"], want,
                                   rtol=2e-4, atol=2e-4)
        for i, g in enumerate(grads):
            np.testing.assert_allclose(got[f"{name}.{causal}.grad{i}"],
                                       np.asarray(g), **gtol)


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_rejects_indivisible_heads(runs, n):
    """3 heads over 2 or 4 ranks: the reference's ValueError, in the global
    and the local form; the reference raises too."""
    from paddle_tpu.parallel import ulysses_attention_sharded
    q = jnp.asarray(_arr(40, 1, 16, 3, 8))
    with pytest.raises(ValueError, match="heads"):
        ulysses_attention_sharded(q, q, q, _mesh(n), "sp")
    for r in range(n):
        got = _port(runs, n, r)
        assert int(got["ulysses.indivisible"]) == 1
        assert int(got["ulysses.indivisible_local"]) == 1


@pytest.mark.parametrize("n", WORLDS)
def test_shard_and_gather_sequence(runs, n):
    """shard_sequence gives this rank's slice of the sequence, and
    gather_sequence the whole back on every rank, with the gradient of the
    round trip the cotangent itself (the reference's layout constraints are
    the identity in value)."""
    x = _arr(50, 2, 8, 4)
    for r in range(n):
        got = _port(runs, n, r)
        s = 8 // n
        np.testing.assert_array_equal(got["seq.shard"],
                                      x[:, r * s:(r + 1) * s])
        np.testing.assert_array_equal(got["seq.gather"], x)
        np.testing.assert_array_equal(got["seq.tensor"], x)
        np.testing.assert_allclose(got["seq.grad"], _arr(51, 2, 8, 4),
                                   rtol=1e-6)


def _ref_sp_linears(n):
    """The reference's sequence-parallel pair over an n-device "mp" mesh,
    with the port's global weights: its output and weight gradients."""
    import paddle_tpu as paddle
    from paddle_tpu.distributed.fleet import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear)
    from paddle_tpu.distributed.fleet.sequence_parallel_utils import (
        all_gather, scatter)
    from paddle_tpu.distributed.mesh import ProcessMesh, set_mesh
    set_mesh(ProcessMesh(shape=[n], dim_names=["mp"]))
    try:
        col = ColumnSequenceParallelLinear(16, 32, gather_output=False)
        row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
        for layer, base in ((col, 60), (row, 62)):
            for i, (k, p) in enumerate(sorted(layer.named_parameters())):
                p.set_value(paddle.to_tensor(_arr(base + i, *p.shape)))
        x = paddle.to_tensor(_arr(0, 2, 8, 16))
        y = all_gather(row(col(scatter(x))))
        paddle.mean(y ** 2).backward()
        grads = {f"{tag}.{k}": p.grad.numpy()
                 for layer, tag in ((col, "col"), (row, "row"))
                 for k, p in layer.named_parameters()}
        return y.numpy(), grads
    finally:
        set_mesh(None)


@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_linears_match_plain(runs, n):
    """The reference's test of that name (:189), restated against the
    reference's pair and the dense pair, with the weights' gradients (the
    row bias summed over ranks by the sequence-parallel hooks)."""
    want, want_g = _ref_sp_linears(n)
    w1, b1 = _arr(61, 16, 32), _arr(60, 32)
    w2, b2 = _arr(63, 32, 16), _arr(62, 16)
    dense = (_arr(0, 2, 8, 16) @ w1 + b1) @ w2 + b2
    np.testing.assert_allclose(want, dense, rtol=1e-4, atol=1e-4)
    for r in range(n):
        got = _port(runs, n, r)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got["sp.out"], want, rtol=0,
                                   atol=1e-5 * scale)
        for k, w in want_g.items():
            np.testing.assert_allclose(
                got[f"sp.{k}.grad"], w, rtol=0,
                atol=1e-5 * float(np.abs(w).max()), err_msg=k)
