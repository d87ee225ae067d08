"""Fleet's tensor-parallel layers (``distributed/fleet/mp_layers.py``), the
sequence-parallel gradient hooks, ``distributed.split`` and the RNG
tracker of the port at mp 2 and 4, against the reference's
(``paddle_tpu.distributed.fleet`` over an "mp" mesh of as many virtual
CPU devices; ``tests/test_distributed.py:67``, ``:99``).

One worker group of 2 and one of 4 gloo ranks (the port's launcher) runs
every case with ``fleet.init(mp_degree=n)``: each rank holds its shards,
and writes its outputs and its parameters' gradients gathered into the
global layout. The reference runs the same layers with the same global
weights and inputs (numpy seeds). f32; tolerances: layer outputs 1e-5,
gradients 1e-5 of each one's scale.
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

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
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch.distributed.fleet import mp_layers
from paddle_tpu_torch.distributed.fleet.sequence_parallel_utils import (
    all_gather, mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks, scatter)

out = sys.argv[1]
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 0, "pp_degree": 1,
                           "sharding_degree": 1}
dist.init_parallel_env()
n, r = dist.get_world_size(), dist.get_rank()
strategy.hybrid_configs["mp_degree"] = n
fleet.init(is_collective=True, strategy=strategy)
hcg = fleet.get_hybrid_communicate_group()
res = {"topo": np.asarray([hcg.get_model_parallel_world_size(),
                           hcg.get_model_parallel_rank(),
                           hcg.get_data_parallel_world_size()])}

def arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)

def grads(layer, tag):
    for k, p in layer.named_parameters():
        g = p.grad._data
        if getattr(p, "split_axis", None) is not None:
            g = dist.collective._gather_along(g, p.mp_group, p.split_axis)
        res[f"{tag}.grad.{k}"] = g.numpy()

def weights(layer, base):
    mp_layers.set_global_params(layer, {
        k: arr(base + i, *p.global_shape)
        for i, (k, p) in enumerate(sorted(layer.named_parameters()))})

# --- ColumnParallelLinear -> RowParallelLinear, both gather modes
paddle.seed(1)
for gather in (False, True):
    col = fleet.ColumnParallelLinear(16, 32, gather_output=gather,
                                     has_bias=True)
    row = fleet.RowParallelLinear(32, 16, input_is_parallel=not gather,
                                  has_bias=True)
    res[f"shapes.{gather}"] = np.asarray(list(col.weight.shape) +
                                         list(col.weight.global_shape))
    weights(col, 10)
    weights(row, 12)
    y = row(col(paddle.to_tensor(arr(0, 8, 16))))
    res[f"mlp.{gather}.out"] = y.numpy()
    (y * paddle.to_tensor(arr(1, 8, 16))).sum().backward()
    grads(col, f"mlp.{gather}.col")
    grads(row, f"mlp.{gather}.row")

# --- VocabParallelEmbedding
emb = fleet.VocabParallelEmbedding(64, 16)
weights(emb, 20)
ids = paddle.to_tensor(np.random.RandomState(2).randint(0, 64, (4, 8)))
e = emb(ids)
res["emb.out"] = e.numpy()
(e * paddle.to_tensor(arr(3, 4, 8, 16))).sum().backward()
grads(emb, "emb")

# --- ParallelCrossEntropy over vocab-sharded logits
logits = arr(4, 8, 64)
labels = np.random.RandomState(5).randint(0, 64, (8,))
labels[[1, 6]] = -100
vl = 64 // n
local = paddle.to_tensor(logits[:, r * vl:(r + 1) * vl], stop_gradient=False)
ce = fleet.ParallelCrossEntropy()(local, paddle.to_tensor(labels))
res["ce.out"] = ce.numpy()
(ce * paddle.to_tensor(arr(6, 8))).sum().backward()
res["ce.grad"] = dist.collective._gather_along(local.grad._data,
                                               hcg.get_model_parallel_group(),
                                               1).numpy()

# --- split: a column- and a row-parallel linear, an embedding
x = paddle.to_tensor(arr(0, 8, 16))
dist.split(x, (16, 32), "linear", axis=1, name="fc1")
dist.split(paddle.ones([8, 32]), (32, 16), "linear", axis=0, name="fc2")
dist.split(ids, (64, 16), "embedding", name="emb")
for key, layer in dist._split_layers.items():
    weights(layer, {"fc1": 30, "fc2": 32, "emb": 34}[key[0]])
h = dist.split(x, (16, 32), "linear", axis=1, name="fc1")
y = dist.split(h, (32, 16), "linear", axis=0, name="fc2")
res["split.out"] = y.numpy()
res["split.emb"] = dist.split(ids, (64, 16), "embedding", name="emb").numpy()
(y * paddle.to_tensor(arr(1, 8, 16))).sum().backward()
for key, layer in dist._split_layers.items():
    if key[0] != "emb":
        grads(layer, f"split.{key[0]}")

# --- sequence-parallel LayerNorm: the hooks sum its gradients over mp
for hooked in (True, False):
    ln = paddle.nn.LayerNorm(16)
    ln.weight.set_value(paddle.to_tensor(arr(40, 16)))
    ln.bias.set_value(paddle.to_tensor(arr(41, 16)))
    mark_as_sequence_parallel_parameter(ln.weight)
    mark_as_sequence_parallel_parameter(ln.bias)
    if hooked:
        register_sequence_parallel_allreduce_hooks(ln)
    xs = scatter(paddle.to_tensor(arr(42, 2, 8, 16)))
    yy = all_gather(ln(xs))
    (yy * paddle.to_tensor(arr(43, 2, 8, 16))).sum().backward()
    res[f"ln.{hooked}.out"] = yy.numpy()
    res[f"ln.{hooked}.wgrad"] = ln.weight.grad.numpy()
    res[f"ln.{hooked}.bgrad"] = ln.bias.grad.numpy()

# --- the RNG tracker: a stream a model-parallel rank, and a shared one
fleet.model_parallel_random_seed(100)
tracker = fleet.get_rng_state_tracker()
with tracker.rng_state("local_seed"):
    res["rng.local"] = paddle.rand([6]).numpy()
with tracker.rng_state("global_seed"):
    res["rng.global"] = paddle.rand([6]).numpy()
np.savez(os.path.join(out, f"tp.{n}.{r}.npz"), **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp")
    script = out / "worker.py"
    script.write_text(WORKER)
    # the two worker groups run at once (each waits on its own imports)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        for res in pool.map(lambda n: run_workers(script, n, [out],
                                                  timeout=120), WORLDS):
            assert res.returncode == 0, res.stderr[-3000:]
    return out


def _port(runs, n, r):
    with np.load(runs / f"tp.{n}.{r}.npz") as f:
        return {k: f[k] for k in f.files}


def _arr(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * (float(np.abs(want).max()) or 1),
                               err_msg=what)


class _RefMesh:
    """The reference's layers over an n-device "mp" mesh (its layers
    shard over it; the fleet topology's, if a reference test made one)."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from paddle_tpu.distributed.mesh import ProcessMesh, set_mesh
        set_mesh(ProcessMesh(shape=[self.n], dim_names=["mp"]))
        return self

    def __exit__(self, *exc):
        from paddle_tpu.distributed.mesh import set_mesh
        set_mesh(None)


def _ref_weights(layer, base):
    import paddle_tpu as paddle
    for i, (k, p) in enumerate(sorted(layer.named_parameters())):
        p.set_value(paddle.to_tensor(_arr(base + i, *p.shape)))


def _ref_grads(layer, tag):
    return {f"{tag}.grad.{k}": p.grad.numpy()
            for k, p in layer.named_parameters()}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("gather", [False, True])
def test_fleet_tp_layers_parity(runs, n, gather):
    """The reference's test of that name (test_distributed.py:67), restated
    at mp n: ColumnParallelLinear -> RowParallelLinear (gather_output=False
    with input_is_parallel, and gather_output=True into a row linear that
    splits its input) against the reference's pair and the dense one, and
    the weights' gradients; each rank holds a [16, 32 / n] column shard."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as rfleet
    with _RefMesh(n):
        col = rfleet.ColumnParallelLinear(16, 32, gather_output=gather)
        row = rfleet.RowParallelLinear(32, 16, input_is_parallel=not gather)
        _ref_weights(col, 10)
        _ref_weights(row, 12)
        y = row(col(paddle.to_tensor(_arr(0, 8, 16))))
        (y * paddle.to_tensor(_arr(1, 8, 16))).sum().backward()
        want = {"out": y.numpy(), **_ref_grads(col, "col"),
                **_ref_grads(row, "row")}
    dense = (_arr(0, 8, 16) @ _arr(11, 16, 32) + _arr(10, 32)) \
        @ _arr(13, 32, 16) + _arr(12, 16)
    _close(want["out"], dense, "reference against dense")
    for r in range(n):
        got = _port(runs, n, r)
        assert got["topo"].tolist() == [n, r, 1]
        assert got[f"shapes.{gather}"].tolist() == [16, 32 // n, 16, 32]
        _close(got[f"mlp.{gather}.out"], want["out"], "out")
        for k, w in want.items():
            if k != "out":
                _close(got[f"mlp.{gather}.{k}"], w, k)


@pytest.mark.parametrize("n", WORLDS)
def test_vocab_parallel_embedding(runs, n):
    """The reference's test of that name (:99), restated at mp n: the
    lookup equals the global weight's rows, and the weight's gradient the
    reference's."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as rfleet
    ids = np.random.RandomState(2).randint(0, 64, (4, 8))
    with _RefMesh(n):
        emb = rfleet.VocabParallelEmbedding(64, 16)
        _ref_weights(emb, 20)
        e = emb(paddle.to_tensor(ids))
        (e * paddle.to_tensor(_arr(3, 4, 8, 16))).sum().backward()
        want_g = emb.weight.grad.numpy()
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_array_equal(got["emb.out"], _arr(20, 64, 16)[ids])
        _close(got["emb.grad.weight"], want_g, "embedding grad")


@pytest.mark.parametrize("n", WORLDS)
def test_parallel_cross_entropy_matches_reference(runs, n):
    """Per-token CE over logits sharded on the vocab (the cross-rank max and
    sum of exponentials) against the reference's ParallelCrossEntropy on
    the whole logits, ignore_index included; the logits' gradient too."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed.fleet as rfleet
    labels = np.random.RandomState(5).randint(0, 64, (8,))
    labels[[1, 6]] = -100
    with _RefMesh(n):
        logits = paddle.to_tensor(_arr(4, 8, 64), stop_gradient=False)
        ce = rfleet.ParallelCrossEntropy()(logits, paddle.to_tensor(labels))
        (ce * paddle.to_tensor(_arr(6, 8))).sum().backward()
        want, want_g = ce.numpy(), logits.grad.numpy()
    for r in range(n):
        got = _port(runs, n, r)
        np.testing.assert_allclose(got["ce.out"], want, rtol=1e-5,
                                   atol=1e-5)
        _close(got["ce.grad"], want_g, "logits grad")


@pytest.mark.parametrize("n", WORLDS)
def test_split_matches_reference(runs, n):
    """distributed.split (reference distributed/__init__.py:90): a
    column-parallel then a row-parallel linear and an embedding, cached by
    name, against the reference's split with the same weights."""
    import paddle_tpu as paddle
    import paddle_tpu.distributed as rdist
    ids = paddle.to_tensor(np.random.RandomState(2).randint(0, 64, (4, 8)))
    x = paddle.to_tensor(_arr(0, 8, 16))
    with _RefMesh(n):
        rdist._split_layers.clear()
        rdist.split(x, (16, 32), "linear", axis=1, name="fc1")
        rdist.split(paddle.ones([8, 32]), (32, 16), "linear", axis=0,
                    name="fc2")
        rdist.split(ids, (64, 16), "embedding", name="emb")
        for key, layer in rdist._split_layers.items():
            _ref_weights(layer, {"fc1": 30, "fc2": 32, "emb": 34}[key[0]])
        y = rdist.split(rdist.split(x, (16, 32), "linear", axis=1,
                                    name="fc1"),
                        (32, 16), "linear", axis=0, name="fc2")
        e = rdist.split(ids, (64, 16), "embedding", name="emb")
        (y * paddle.to_tensor(_arr(1, 8, 16))).sum().backward()
        want_g = {}
        for key, layer in rdist._split_layers.items():
            if key[0] != "emb":
                want_g.update(_ref_grads(layer, key[0]))
        rdist._split_layers.clear()
    for r in range(n):
        got = _port(runs, n, r)
        _close(got["split.out"], y.numpy(), "split out")
        np.testing.assert_array_equal(got["split.emb"], e.numpy())
        for k, w in want_g.items():
            _close(got[f"split.{k}"], w, k)


def _dense_ln_grads():
    """LayerNorm(16) over the whole [2, 8, 16] input in float64: output and
    the gain's and bias's gradients of sum(out * c)."""
    x = _arr(42, 2, 8, 16).astype(np.float64)
    g, b, c = (_arr(40, 16).astype(np.float64), _arr(41, 16),
               _arr(43, 2, 8, 16))
    mu = x.mean(-1, keepdims=True)
    xhat = (x - mu) / np.sqrt(x.var(-1, keepdims=True) + 1e-5)
    return xhat * g + b, (c * xhat).sum((0, 1)), c.sum((0, 1))


@pytest.mark.parametrize("n", WORLDS)
def test_sequence_parallel_hooks_sum_layernorm_gradients(runs, n):
    """register_sequence_parallel_allreduce_hooks: a LayerNorm run on each
    rank's slice of the sequence gets the unsharded LayerNorm's gradients
    on every rank; without the hooks each rank holds its slice's part
    (the reference needs no hooks: GSPMD reduces them)."""
    out, wgrad, bgrad = _dense_ln_grads()
    parts = []
    for r in range(n):
        got = _port(runs, n, r)
        for hooked in (True, False):
            _close(got[f"ln.{hooked}.out"], out, "ln out")
        _close(got["ln.True.wgrad"], wgrad, "ln gain grad")
        _close(got["ln.True.bgrad"], bgrad, "ln bias grad")
        parts.append(got["ln.False.wgrad"])
        assert not np.allclose(got["ln.False.wgrad"], wgrad)
    _close(np.sum(parts, 0), wgrad, "the ranks' parts")


@pytest.mark.parametrize("n", WORLDS)
def test_rng_tracker_streams(runs, n):
    """model_parallel_random_seed: the "global_seed" stream draws the same
    on every rank, the "local_seed" stream differently on each
    model-parallel rank (dropout inside a tensor-parallel region)."""
    got = [_port(runs, n, r) for r in range(n)]
    for g in got[1:]:
        np.testing.assert_array_equal(g["rng.global"], got[0]["rng.global"])
    local = {tuple(g["rng.local"].tolist()) for g in got}
    assert len(local) == n
    assert tuple(got[0]["rng.global"].tolist()) not in local
