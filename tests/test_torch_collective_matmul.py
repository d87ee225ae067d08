"""The ring collective matmuls (``paddle_tpu_torch/parallel/
collective_matmul.py``) against the reference's
(``paddle_tpu/parallel/collective_matmul.py`` under ``shard_map`` on the
virtual CPU devices): the first seven tests of
``tests/test_collective_matmul.py``, restated with gradients.

One worker group of 2 and one of 4 gloo ranks (the port's launcher) run
every case and write each rank's outputs and gradients; the reference runs
the same inputs (numpy seeds) over as many devices, and ``jax.grad``
through its ring gives the gradients each rank's block is held against.
f32; tolerances: the reference's own (1e-4, 1e-5 for the ring against the
unfused form) and, for gpt_hybrid, losses rtol 2e-5 against the reference
and 2e-4 between collective_matmul on and off (the reference's bound).
``test_cm_under_pp_upstream_wall`` is a jax canary and is not mirrored.
"""
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
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
from paddle_tpu_torch.core.flags import set_flags
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed.fleet import (ColumnSequenceParallelLinear,
                                                RowSequenceParallelLinear)
from paddle_tpu_torch.distributed.fleet import mp_layers
from paddle_tpu_torch.distributed.fleet.sequence_parallel_utils import (
    all_gather, scatter)
from paddle_tpu_torch.distributed.mesh import ProcessMesh, set_mesh
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.parallel.collective_matmul import (
    all_gather_matmul, matmul_reduce_scatter)

out = sys.argv[1]
dist.init_parallel_env()
n, r = dist.get_world_size(), dist.get_rank()
set_mesh(ProcessMesh(shape=[n], dim_names=["tp"]))
res = {}

def arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)

def rows(a, k=None):
    k = k or a.shape[0] // n
    return torch.from_numpy(np.ascontiguousarray(a[r * k:(r + 1) * k]))

def cols(a):
    k = a.shape[1] // n
    return torch.from_numpy(np.ascontiguousarray(a[:, r * k:(r + 1) * k]))

def run(name, fn, inputs, c):
    ins = [x.requires_grad_(True) for x in inputs]
    y = fn(*ins)
    (y * c).sum().backward()
    res[f"{name}.out"] = y.detach().numpy()
    for i, x in enumerate(ins):
        res[f"{name}.grad{i}"] = x.grad.numpy()

# all_gather(x) @ w: x sequence-sharded, w column-sharded
run("ag", lambda x, w: all_gather_matmul(x, w, "tp"),
    [rows(arr(1, n * 4, 16)), cols(arr(2, 16, 16))], cols(arr(3, n * 4, 16)))
# reduce_scatter(x @ w): x and w sharded on k
run("rs", lambda x, w: matmul_reduce_scatter(x, w, "tp"),
    [cols(arr(4, 16, 32)), rows(arr(5, 32, 8))], rows(arr(6, 16, 8)))
# the Megatron pair
run("pair", lambda x, w1, w2: matmul_reduce_scatter(
        torch.nn.functional.gelu(all_gather_matmul(x, w1, "tp"),
                                 approximate="tanh"), w2, "tp"),
    [rows(arr(7, n * 2, 16)), cols(arr(8, 16, 32)), rows(arr(9, 32, 16))],
    rows(arr(10, n * 2, 16)))

# the sequence-parallel linears, FLAGS_collective_matmul off and on
for flag in (False, True):
    set_flags({"FLAGS_collective_matmul": flag})
    col = ColumnSequenceParallelLinear(16, 32, gather_output=False)
    row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
    for layer, base in ((col, 20), (row, 22)):
        mp_layers.set_global_params(layer, {
            k: arr(base + i, *p.global_shape)
            for i, (k, p) in enumerate(sorted(layer.named_parameters()))})
    x = paddle.to_tensor(arr(11, 2, 8, 16))
    y = all_gather(row(col(scatter(x))))
    res[f"sp.{flag}.out"] = y.numpy()
    # the mean over the global [2, 8, 32] output: each rank's share
    ((col(scatter(x)) ** 2).sum() / (2 * 8 * 32)).backward()
    res[f"sp.{flag}.col_w_grad"] = C._gather_along(
        col.weight.grad._data, col.weight.mp_group, 1).numpy()
set_flags({"FLAGS_collective_matmul": False})

# gpt_hybrid dp1 x tp n + sp, collective_matmul off and on, 2 steps
start = dict(np.load(os.path.join(out, "start.npz")))
tree = {"blocks": {}}
for k, v in start.items():
    if k.startswith("blocks."):
        tree["blocks"][k[7:]] = v
    else:
        tree[k] = v
cfg = GPTConfig.tiny()
ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 16)))
for cm in (False, True):
    pcfg = TH.ParallelConfig(dp=1, tp=n, sp=True, collective_matmul=cm,
                             remat=False, param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    params = TH.params_from_jax(tree, device="cpu", tp_rank=r, tp=n)
    opt = TH.dp_adamw_init(params, pcfg)
    step = TH.build_train_step(cfg, pcfg)
    res[f"gpt.{cm}"] = np.asarray([float(step(params, opt, (ids, ids))[2])
                                   for _ in range(2)])
np.savez(os.path.join(out, f"cm.{n}.{r}.npz"), **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu.models import gpt_hybrid as GH
    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    out = tmp_path_factory.mktemp("cm")
    params = GH.init_params(JaxGPTConfig.tiny(), GH.ParallelConfig(
        param_dtype=jnp.float32), jax.random.PRNGKey(0))
    flat = {f"blocks.{k}": np.asarray(v)
            for k, v in params["blocks"].items()}
    flat.update({k: np.asarray(v) for k, v in params.items()
                 if k != "blocks"})
    np.savez(out / "start.npz", **flat)
    script = out / "worker.py"
    script.write_text(WORKER)
    # the two worker groups run at once (each waits on its own imports)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for res in pool.map(lambda n: run_workers(script, n, [out],
                                                  timeout=120), WORLDS):
            assert res.returncode == 0, res.stderr[-3000:]
    return out


def _port(runs, n, r):
    with np.load(runs / f"cm.{n}.{r}.npz") as f:
        return {k: f[k] for k in f.files}


def _arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("tp",))


def _rows(a, r, n):
    k = a.shape[0] // n
    return a[r * k:(r + 1) * k]


def _cols(a, r, n):
    k = a.shape[1] // n
    return a[:, r * k:(r + 1) * k]


def _ring(name, n):
    """(global output, global gradients) of the reference's ring under
    shard_map on n devices, and the (output, input) layouts."""
    from paddle_tpu.parallel.collective_matmul import (
        all_gather_matmul, matmul_reduce_scatter)
    mesh = _mesh(n)
    if name == "ag":
        ins = (_arr(1, n * 4, 16), _arr(2, 16, 16))
        c, specs = _arr(3, n * 4, 16), (P("tp", None), P(None, "tp"))
        out_spec = P(None, "tp")

        def body(x, w):
            return all_gather_matmul(x, w, "tp")
    elif name == "rs":
        ins = (_arr(4, 16, 32), _arr(5, 32, 8))
        c, specs = _arr(6, 16, 8), (P(None, "tp"), P("tp", None))
        out_spec = P("tp", None)

        def body(x, w):
            return matmul_reduce_scatter(x, w, "tp")
    else:
        ins = (_arr(7, n * 2, 16), _arr(8, 16, 32), _arr(9, 32, 16))
        c = _arr(10, n * 2, 16)
        specs = (P("tp", None), P(None, "tp"), P("tp", None))
        out_spec = P("tp", None)

        def body(x, w1, w2):
            y = jax.nn.gelu(all_gather_matmul(x, w1, "tp"))
            return matmul_reduce_scatter(y, w2, "tp")
    f = jax.shard_map(body, mesh=mesh, in_specs=specs, out_specs=out_spec)

    def loss(*a):
        y = f(*a)
        return jnp.sum(y * c), y
    args = [jnp.asarray(a) for a in ins]
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(ins))), has_aux=True))(*args)
    return (np.asarray(out), [np.asarray(g) for g in grads], ins,
            out_spec, specs)


def _local(a, spec, r, n):
    if spec == P("tp", None):
        return _rows(a, r, n)
    return _cols(a, r, n)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name,dense", [
    ("ag", lambda x, w: x @ w),
    ("rs", lambda x, w: x @ w),
    ("pair", lambda x, w1, w2: np.asarray(jax.nn.gelu(x @ w1)) @ w2),
], ids=["all_gather_matmul", "matmul_reduce_scatter", "column_row_pair"])
def test_ring_matmul_and_its_gradient_match_reference(runs, name, dense, n):
    """test_all_gather_matmul_matches_reference,
    test_matmul_reduce_scatter_matches_reference,
    test_column_then_row_parallel_layer_pair and
    test_grad_flows_through_ring_matmuls, restated: each rank's output
    block and gradients against the reference ring's on n devices, and the
    output against the dense product."""
    out, grads, ins, out_spec, specs = _ring(name, n)
    np.testing.assert_allclose(out, dense(*ins), rtol=1e-4, atol=1e-4)
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_allclose(got[f"{name}.out"],
                                   _local(out, out_spec, r, n), rtol=1e-5,
                                   atol=1e-5)
        for i, (g, spec) in enumerate(zip(grads, specs)):
            np.testing.assert_allclose(got[f"{name}.grad{i}"],
                                       _local(g, spec, r, n), rtol=1e-4,
                                       atol=1e-4)


@functools.lru_cache(maxsize=None)
def _ref_sp(n, flag):
    """The reference's sequence-parallel pair on an n-device "mp" mesh with
    the worker's weights: its output and the column weight's gradient."""
    import paddle_tpu as paddle
    from paddle_tpu.core.flags import set_flags
    from paddle_tpu.distributed.fleet import (
        ColumnSequenceParallelLinear, RowSequenceParallelLinear)
    from paddle_tpu.distributed.fleet.sequence_parallel_utils import (
        all_gather, scatter)
    from paddle_tpu.distributed.mesh import ProcessMesh, set_mesh
    set_mesh(ProcessMesh(shape=[n], dim_names=["mp"]))
    set_flags({"FLAGS_collective_matmul": flag})
    try:
        col = ColumnSequenceParallelLinear(16, 32, gather_output=False)
        row = RowSequenceParallelLinear(32, 16, input_is_parallel=True)
        for layer, base in ((col, 20), (row, 22)):
            for i, (k, p) in enumerate(sorted(layer.named_parameters())):
                p.set_value(paddle.to_tensor(_arr(base + i, *p.shape)))
        x = paddle.to_tensor(_arr(11, 2, 8, 16))
        y = all_gather(row(col(scatter(x)))).numpy()
        paddle.mean(col(scatter(x)) ** 2).backward()
        return y, col.weight.grad.numpy()
    finally:
        set_flags({"FLAGS_collective_matmul": False})
        set_mesh(None)


@pytest.mark.parametrize("n", WORLDS)
def test_sp_linears_with_collective_matmul_match_constraint_path(runs, n):
    """The reference's test of that name, restated: FLAGS_collective_matmul
    on gives the values of off, and both the reference's (its constraint
    path, which its own test holds its ring against)."""
    want, _ = _ref_sp(n, False)
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_allclose(got["sp.True.out"], got["sp.False.out"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got["sp.True.out"], want, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_sp_linears_collective_matmul_autodiff(runs, n):
    """The reference's test of that name, restated: the column weight's
    gradient through the ring equals the one without it, and the
    reference's."""
    _, want = _ref_sp(n, False)
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_allclose(got["sp.True.col_w_grad"],
                                   got["sp.False.col_w_grad"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["sp.True.col_w_grad"], want,
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_hybrid_engine_collective_matmul_loss_parity(runs, n):
    """The reference's test of that name, restated at dp1 x tp n + sp: two
    steps with collective_matmul on equal two without it (rtol 2e-4, the
    reference's bound) and the reference's own steps (rtol 2e-5)."""
    from paddle_tpu.models import gpt_hybrid as GH
    from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
    ids = np.random.default_rng(3).integers(0, 256, (4, 16))
    want = {}
    for cm in (False, True):
        pcfg = GH.ParallelConfig(dp=1, pp=1, tp=n, sp=True,
                                 collective_matmul=cm, remat=False,
                                 param_dtype=jnp.float32,
                                 compute_dtype=jnp.float32)
        mesh, params, opt, step = GH.setup(JaxGPTConfig.tiny(), pcfg,
                                           seed=0, devices=jax.devices()[:n])
        with mesh:
            losses = []
            for _ in range(2):
                params, opt, loss = step(params, opt, (ids, ids))
                losses.append(float(loss))
        want[cm] = losses
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_allclose(got["gpt.True"], got["gpt.False"],
                                   rtol=2e-4)
        for cm in (False, True):
            np.testing.assert_allclose(got[f"gpt.{cm}"], want[cm],
                                       rtol=2e-5, atol=2e-5)
