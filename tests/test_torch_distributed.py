"""Process groups, collectives, DataParallel, no_sync and recompute of the
port (``paddle_tpu_torch.distributed``) on the CPU over gloo.

One worker group at world 2 and one at world 4, each started by the port's
launcher (``_testing.run_workers``: its own timeout, the whole process group
killed past it), runs every multi-rank check and writes each rank's results;
the tests below hold them against numpy's expectation of the per-rank
semantics (rank r holds its own tensor; the collectives reduce, gather and
scatter across the ranks' values) and, for DataParallel, against the
reference (``paddle_tpu.distributed.DataParallel`` on the 8 virtual devices)
on the global batch. At world 1 (no launcher variables) each collective
equals the reference's eager call. f32 tolerances: losses rtol 2e-5, atol
2e-6 (the reference's group-sharded bound); gradients and parameters 1e-5
of each leaf's scale.
"""
import json

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu.distributed as pdist
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

WORLDS = (2, 4)
DP_STEPS = 3


def _x(rank):
    return (np.arange(6, dtype=np.float32).reshape(2, 3) * (rank + 1)
            + rank)


WORKER = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import torch
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import collective as C

out = sys.argv[1]
group = dist.init_parallel_env()
r, n = dist.get_rank(), dist.get_world_size()
res, js = {}, {}
def x(rank):
    return np.arange(6, dtype=np.float32).reshape(2, 3) * (rank + 1) + rank
def T(a):
    return paddle.to_tensor(np.asarray(a, np.float32))

# bootstrap (the reference's test_two_process_bootstrap_and_allgather)
js["bootstrap"] = [group.nranks, group.rank, dist.get_backend(),
                   os.environ["PADDLE_TRAINERS_NUM"]]
got = []
dist.all_gather(got, T([r + 1.0]))
res["bootstrap_gather"] = np.concatenate([g.numpy() for g in got])

for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
    t = T(x(r))
    dist.all_reduce(t, getattr(dist.ReduceOp, op))
    res[f"all_reduce_{op}"] = t.numpy()
t = T(x(r))
task = dist.all_reduce(t, sync_op=False)
js["task_type"] = type(task).__name__
task.wait()
res["all_reduce_async"] = t.numpy()
got = []
dist.all_gather(got, T(x(r)))
res["all_gather"] = np.stack([g.numpy() for g in got])
t = T(x(r))
dist.broadcast(t, src=1)
res["broadcast"] = t.numpy()
t = T(x(r))
dist.reduce(t, dst=0)
if r == 0:
    res["reduce"] = t.numpy()
t = T(np.zeros((2, 3)))
dist.scatter(t, [T(x(0) * 10 + j) for j in range(n)] if r == 0 else None,
             src=0)
res["scatter"] = t.numpy()
t = T(np.zeros((2, 3)))
dist.reduce_scatter(t, [T(x(r) + j) for j in range(n)])
res["reduce_scatter"] = t.numpy()
got = []
dist.alltoall([T(x(r) + 100 * j) for j in range(n)], got)
res["alltoall"] = np.stack([g.numpy() for g in got])
t = T(np.zeros((2 * n, 3)))
dist.alltoall_single(T(np.concatenate([x(r) + 100 * j for j in range(n)])), t)
res["alltoall_single"] = t.numpy()
t = T(np.zeros((2, 3)))
tasks = [dist.isend(T(x(r)), (r + 1) % n), dist.irecv(t, (r - 1) % n)]
for task in tasks:
    task.wait()
res["send_recv_ring"] = t.numpy()
t = T(np.zeros((2, 3)))
for task in dist.batch_isend_irecv([
        dist.P2POp(dist.isend, T(x(r) * 2), (r + 1) % n),
        dist.P2POp(dist.irecv, t, (r - 1) % n)]):
    task.wait()
res["batch_isend_irecv_ring"] = t.numpy()
got = []
dist.gather(T(x(r)), got, dst=0)
if r == 0:
    res["gather"] = np.stack([g.numpy() for g in got])
objs = []
dist.all_gather_object(objs, {"rank": r})
js["all_gather_object"] = objs
lst = [{"from": r}, r * 10]
dist.broadcast_object_list(lst, src=n - 1)
js["broadcast_object_list"] = lst
got = []
dist.scatter_object_list(got, [{"to": j} for j in range(n)] if r == 0
                         else None, src=0)
js["scatter_object_list"] = got
dist.barrier()

# groups: new_group by every rank, group-local ranks, non-members
g01 = dist.new_group([0, 1])
godd = dist.new_group([q for q in range(n) if q % 2 == 1])
js["groups"] = [g01.rank, g01.nranks, godd.rank, godd.ranks,
                godd.get_group_rank(r)]
if g01.rank >= 0:
    t = T(x(r))
    dist.all_reduce(t, group=g01)
    res["all_reduce_group01"] = t.numpy()
    dist.barrier(g01)
if godd.rank >= 0:
    got = []
    dist.all_gather(got, T(x(r)), group=godd)
    res["all_gather_odd"] = np.stack([g.numpy() for g in got])
    t = T(x(r))
    dist.broadcast(t, src=godd.ranks[-1], group=godd)
    res["broadcast_odd"] = t.numpy()

# mesh groups and the axis-keyed ops
if n == 4:
    mesh = dist.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"])
    dist.set_mesh(mesh)
    js["mesh"] = [mesh.get_group("dp").ranks, mesh.get_group("mp").ranks,
                  dist.ops.axis_index("mp")]
    xt = torch.from_numpy(x(r))
    res["ops_psum_mp"] = dist.ops.psum(xt, "mp").numpy()
    res["ops_pmean_dp"] = dist.ops.pmean(xt, "dp").numpy()
    res["ops_all_gather_dp"] = dist.ops.all_gather(xt, "dp", axis=1).numpy()
    res["ops_reduce_scatter_mp"] = dist.ops.reduce_scatter(
        torch.from_numpy(np.concatenate([x(r), x(r)])), "mp").numpy()
    res["ops_ppermute_mp"] = dist.ops.ppermute(xt, "mp",
                                               [(0, 1), (1, 0)]).numpy()
    dist.set_mesh(None)

# fused_allreduce_gradients: the global mean, no implicit divide; an
# explicit scale divides
from paddle_tpu_torch.distributed.fleet.utils.hybrid_parallel_util import (
    fused_allreduce_gradients_with_group)
lin = nn.Linear(3, 2)
for i, p in enumerate(lin.parameters()):
    p.grad = T(np.full(p.shape, 1.0 + i, np.float32))
fused_allreduce_gradients_with_group(list(lin.parameters()), group=None)
res["fused_same"] = np.concatenate([p.grad.numpy().ravel()
                                    for p in lin.parameters()])
for p in lin.parameters():
    p.grad = T(np.full(p.shape, float(r), np.float32))
fused_allreduce_gradients_with_group(list(lin.parameters()), group=None,
                                     scale=2.0)
res["fused_rank"] = np.concatenate([p.grad.numpy().ravel()
                                    for p in lin.parameters()])

# DataParallel: the reference test's model on this rank's rows of the
# global batch, DP_STEPS steps of AdamW
start = dict(np.load(os.path.join(out, "dp_start.npz")))
gx, gy = start.pop("x"), start.pop("y")
model = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
model.set_state_dict({k: v for k, v in start.items()})
dp = dist.DataParallel(model, comm_buffer_size=1, last_comm_buffer_size=0)
js["dp_buckets"] = len(dp._reducer.buckets)
opt = paddle.optimizer.AdamW(1e-2, parameters=model.parameters())
rows = slice(r * len(gx) // n, (r + 1) * len(gx) // n)
lx, ly = paddle.to_tensor(gx[rows]), paddle.to_tensor(gy[rows])
losses = []
for step in range(DP_STEPS):
    loss = nn.CrossEntropyLoss()(dp(lx), ly)
    loss.backward()
    if step == 0:
        for k, p in model.named_parameters():
            res[f"dp_grad.{k}"] = p.grad.numpy()
    opt.step()
    opt.clear_grad()
    g = loss.detach()
    dist.all_reduce(g, dist.ReduceOp.AVG)
    losses.append(float(g))
res["dp_loss"] = np.asarray(losses)
for k, p in model.named_parameters():
    res[f"dp_param.{k}"] = p.numpy()
js["dp_reductions"] = dp._reducer.reductions

# no_sync: two microbatches accumulate locally, one reduction at the exit
model2 = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
model2.set_state_dict({k: v for k, v in start.items()})
dp2 = dist.DataParallel(model2)
half = (rows.stop - rows.start) // 2
before = dp2._reducer.reductions
with dp2.no_sync():
    for c in range(2):
        sl = slice(rows.start + c * half, rows.start + (c + 1) * half)
        nn.CrossEntropyLoss()(dp2(paddle.to_tensor(gx[sl])),
                              paddle.to_tensor(gy[sl])).backward()
    js["no_sync_inside"] = dp2._reducer.reductions - before
js["no_sync_after"] = dp2._reducer.reductions - before
for k, p in model2.named_parameters():
    res[f"nosync_grad.{k}"] = p.grad.numpy()

# no_sync defers explicit collectives: recorded twice, replayed once
g = T(x(r))
with dp2.no_sync():
    dist.all_reduce(g)
    dist.all_reduce(g)
    res["defer_inside"] = g.numpy().copy()
res["defer_after"] = g.numpy()

# the stage-2 relay is deferred under defer_collectives
from paddle_tpu_torch.distributed.sharding import GroupShardedStage2
m3 = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
m3.set_state_dict({k: v for k, v in start.items()})
st2 = GroupShardedStage2(m3)
with C.defer_collectives():
    nn.CrossEntropyLoss()(st2(lx), ly).backward()
    js["relay_inside"] = [p.grad is not None for p in m3.parameters()] + \
        [s.shadow.grad is None for s in st2._shards]
js["relay_after"] = [p.grad is None for p in m3.parameters()] + \
    [s.shadow.grad is not None for s in st2._shards]

np.savez(os.path.join(out, f"res.{n}.{r}.npz"), **res)
with open(os.path.join(out, f"res.{n}.{r}.json"), "w") as f:
    json.dump(js, f)
dist.destroy_process_group()
'''.replace("DP_STEPS", str(DP_STEPS))


def _reference_model(seed=0):
    P.seed(seed)
    return P.nn.Sequential(P.nn.Linear(4, 8), P.nn.ReLU(),
                           P.nn.Linear(8, 2))


def _dp_batch():
    rng = np.random.RandomState(0)
    return (rng.randn(16, 4).astype(np.float32),
            rng.randint(0, 2, 16).astype(np.int64))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    model = _reference_model()
    x, y = _dp_batch()
    np.savez(out / "dp_start.npz", x=x, y=y,
             **{k: v.numpy() for k, v in model.state_dict().items()})
    script = out / "worker.py"
    script.write_text(WORKER)
    for world in WORLDS:
        res = run_workers(script, world, [out], timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
    got = {}
    for world in WORLDS:
        for r in range(world):
            with np.load(out / f"res.{world}.{r}.npz") as f:
                arrays = {k: f[k] for k in f.files}
            with open(out / f"res.{world}.{r}.json") as f:
                got[world, r] = (arrays, json.load(f))
    return got


def _ranks(results, world):
    return [results[world, r] for r in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_bootstrap_through_the_launcher(results, world):
    """The reference's test_two_process_bootstrap_and_allgather, restated:
    the launcher's variables make one gloo job; all_gather sees every
    rank."""
    for r, (a, js) in enumerate(_ranks(results, world)):
        assert js["bootstrap"] == [world, r, "gloo", str(world)]
        np.testing.assert_array_equal(a["bootstrap_gather"],
                                      np.arange(1, world + 1))


@pytest.mark.parametrize("world", WORLDS)
def test_all_reduce_ops(results, world):
    xs = np.stack([_x(r) for r in range(world)])
    want = {"SUM": xs.sum(0), "MAX": xs.max(0), "MIN": xs.min(0),
            "PROD": xs.prod(0), "AVG": xs.mean(0)}
    for a, js in _ranks(results, world):
        for op, w in want.items():
            np.testing.assert_allclose(a[f"all_reduce_{op}"], w, rtol=1e-6)
        np.testing.assert_allclose(a["all_reduce_async"], want["SUM"])
        assert js["task_type"] == "_Task"


@pytest.mark.parametrize("world", WORLDS)
def test_gather_scatter_and_broadcast(results, world):
    xs = np.stack([_x(r) for r in range(world)])
    for r, (a, _) in enumerate(_ranks(results, world)):
        np.testing.assert_array_equal(a["all_gather"], xs)
        np.testing.assert_array_equal(a["broadcast"], _x(1))
        np.testing.assert_array_equal(a["scatter"], _x(0) * 10 + r)
        np.testing.assert_allclose(a["reduce_scatter"], xs.sum(0) + world * r)
        np.testing.assert_array_equal(
            a["alltoall"], np.stack([_x(j) + 100 * r for j in range(world)]))
        np.testing.assert_array_equal(
            a["alltoall_single"],
            np.concatenate([_x(j) + 100 * r for j in range(world)]))
        if r == 0:
            np.testing.assert_allclose(a["reduce"], xs.sum(0))
            np.testing.assert_array_equal(a["gather"], xs)


@pytest.mark.parametrize("world", WORLDS)
def test_point_to_point_ring(results, world):
    for r, (a, _) in enumerate(_ranks(results, world)):
        np.testing.assert_array_equal(a["send_recv_ring"],
                                      _x((r - 1) % world))
        np.testing.assert_array_equal(a["batch_isend_irecv_ring"],
                                      _x((r - 1) % world) * 2)


@pytest.mark.parametrize("world", WORLDS)
def test_object_collectives(results, world):
    for r, (_, js) in enumerate(_ranks(results, world)):
        assert js["all_gather_object"] == [{"rank": q} for q in range(world)]
        assert js["broadcast_object_list"] == [{"from": world - 1},
                                               (world - 1) * 10]
        assert js["scatter_object_list"] == [{"to": r}]


@pytest.mark.parametrize("world", WORLDS)
def test_groups_and_group_local_ranks(results, world):
    """new_group on every rank; members get their rank in the group,
    non-members -1; a group's collectives stay inside it."""
    odd = [q for q in range(world) if q % 2 == 1]
    for r, (a, js) in enumerate(_ranks(results, world)):
        g01_rank, g01_n, godd_rank, godd_ranks, local = js["groups"]
        assert g01_n == 2 and g01_rank == (r if r < 2 else -1)
        assert godd_ranks == odd
        assert godd_rank == local == (odd.index(r) if r in odd else -1)
        if r < 2:
            np.testing.assert_allclose(a["all_reduce_group01"],
                                       _x(0) + _x(1))
        else:
            assert "all_reduce_group01" not in a
        if r in odd:
            np.testing.assert_array_equal(a["all_gather_odd"],
                                          np.stack([_x(q) for q in odd]))
            np.testing.assert_array_equal(a["broadcast_odd"], _x(odd[-1]))


def test_mesh_groups_and_axis_keyed_ops(results):
    """A 2x2 ProcessMesh (dp, mp) over DeviceMesh: one group per dim, and
    the reference's in-graph ops keyed by axis name."""
    for r, (a, js) in enumerate(_ranks(results, 4)):
        dp_ranks, mp_ranks, mp_index = js["mesh"]
        row, col = divmod(r, 2)
        assert dp_ranks == [col, col + 2] and mp_ranks == [2 * row,
                                                           2 * row + 1]
        assert mp_index == col
        peer = r ^ 1
        np.testing.assert_allclose(a["ops_psum_mp"], _x(r) + _x(peer))
        np.testing.assert_allclose(a["ops_pmean_dp"],
                                   (_x(col) + _x(col + 2)) / 2)
        np.testing.assert_array_equal(
            a["ops_all_gather_dp"], np.concatenate([_x(col), _x(col + 2)],
                                                   axis=1))
        np.testing.assert_allclose(
            a["ops_reduce_scatter_mp"], _x(2 * row) + _x(2 * row + 1))
        np.testing.assert_array_equal(a["ops_ppermute_mp"], _x(peer))


@pytest.mark.parametrize("world", WORLDS)
def test_fused_allreduce_gradients_no_implicit_divide(results, world):
    """The reference's test_fused_allreduce_no_implicit_divide, restated on
    real ranks: gradients equal on every rank stay as they are (the result
    is the global mean, with no further divide by the group's size); an
    explicit scale divides; different gradients become their mean."""
    same = np.concatenate([np.full(6, 1.0), np.full(2, 2.0)])
    mean = np.full(8, np.mean(np.arange(world)) / 2.0)
    for a, _ in _ranks(results, world):
        np.testing.assert_allclose(a["fused_same"], same)
        np.testing.assert_allclose(a["fused_rank"], mean)


def _reference_dp():
    """The reference's DataParallel (its test_data_parallel_loss_parity
    model) on the global batch: step-0 gradients, DP_STEPS losses and the
    parameters after, AdamW 1e-2."""
    model = _reference_model()
    dp = pdist.DataParallel(model)
    opt = P.optimizer.AdamW(1e-2, parameters=model.parameters())
    x, y = _dp_batch()
    x, y = P.to_tensor(x), P.to_tensor(y)
    losses, grads = [], None
    for step in range(DP_STEPS):
        loss = P.nn.CrossEntropyLoss()(dp(x), y)
        loss.backward()
        if step == 0:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, grads, {k: p.numpy() for k, p in model.named_parameters()}


def _leaf_close(got, want, rel, what):
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want))) or 1.0
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_matches_reference_on_the_global_batch(results, world):
    losses, grads, params = _reference_dp()
    for r, (a, js) in enumerate(_ranks(results, world)):
        np.testing.assert_allclose(a["dp_loss"], losses, rtol=2e-5,
                                   atol=2e-6)
        for k in grads:
            _leaf_close(a[f"dp_grad.{k}"], grads[k], 1e-5, f"grad {k}")
            _leaf_close(a[f"dp_param.{k}"], params[k], 1e-5, f"param {k}")
        # four parameters in buckets of 1 MB after a first of 0 MB: two
        # buckets, one all-reduce each a backward
        assert js["dp_buckets"] == 2
        assert js["dp_reductions"] == 2 * DP_STEPS


@pytest.mark.parametrize("world", WORLDS)
def test_no_sync_defers_the_reduction_to_the_exit(results, world):
    """Two microbatches under no_sync: no bucket is reduced inside, the one
    bucket (25 MB) once at the exit, on the accumulated gradients, which
    then equal the reference's gradient of the two microbatches' summed
    losses."""
    model = _reference_model()
    x, y = _dp_batch()
    n = len(x) // world
    loss_fn = P.nn.CrossEntropyLoss()
    total = 0
    for c in range(2):
        sl = [np.arange(r * n + c * n // 2, r * n + (c + 1) * n // 2)
              for r in range(world)]
        idx = np.concatenate(sl)
        total = total + loss_fn(model(P.to_tensor(x[idx])),
                                P.to_tensor(y[idx]))
    total.backward()
    for a, js in _ranks(results, world):
        assert js["no_sync_inside"] == 0
        assert js["no_sync_after"] == 1
        for k, p in model.named_parameters():
            _leaf_close(a[f"nosync_grad.{k}"], p.grad.numpy(), 1e-5, k)


@pytest.mark.parametrize("world", WORLDS)
def test_no_sync_defers_explicit_collectives(results, world):
    """The reference's test of that name, restated: inside no_sync the
    all-reduce is recorded (the tensor keeps its local value), and at the
    exit the two calls run once."""
    total = sum(_x(r) for r in range(world))
    for r, (a, _) in enumerate(_ranks(results, world)):
        np.testing.assert_array_equal(a["defer_inside"], _x(r))
        np.testing.assert_allclose(a["defer_after"], total)


@pytest.mark.parametrize("world", WORLDS)
def test_no_sync_defers_stage2_relay(results, world):
    """The reference's test of that name, restated: under a deferral the
    stage-2 reduce-scatter waits, full gradients stay on the parameters and
    the slices have none; at the exit each gradient is reduced onto its
    slice and the full one freed."""
    for _, js in _ranks(results, world):
        assert all(js["relay_inside"]) and all(js["relay_after"])


def test_world1_collectives_equal_the_references():
    """No launcher variables: world 1, and each collective's value is the
    reference's eager call's."""
    T.set_device("cpu")
    assert tdist.get_world_size() == pdist.get_world_size() == 1
    assert tdist.get_rank() == pdist.get_rank() == 0
    x = _x(0)

    def pair():
        return P.to_tensor(x.copy()), T.to_tensor(x.copy())
    for op in ("SUM", "MAX", "AVG"):
        p, t = pair()
        pdist.all_reduce(p, getattr(pdist.ReduceOp, op))
        tdist.all_reduce(t, getattr(tdist.ReduceOp, op))
        np.testing.assert_array_equal(t.numpy(), p.numpy())
    p, t = pair()
    pl, tl = [], []
    pdist.all_gather(pl, p)
    tdist.all_gather(tl, t)
    assert len(pl) == len(tl) == 1
    np.testing.assert_array_equal(tl[0].numpy(), pl[0].numpy())
    for name in ("broadcast", "reduce"):
        p, t = pair()
        getattr(pdist, name)(p, 0)
        getattr(tdist, name)(t, 0)
        np.testing.assert_array_equal(t.numpy(), p.numpy())
    p, t = pair()
    pdist.scatter(p, [P.to_tensor(x * 3)])
    tdist.scatter(t, [T.to_tensor(x * 3)])
    np.testing.assert_array_equal(t.numpy(), p.numpy())
    p, t = pair()
    pdist.reduce_scatter(p, [P.to_tensor(x + 1)])
    tdist.reduce_scatter(t, [T.to_tensor(x + 1)])
    np.testing.assert_array_equal(t.numpy(), p.numpy())
    pl, tl = [], []
    pdist.alltoall([P.to_tensor(x)], pl)
    tdist.alltoall([T.to_tensor(x)], tl)
    np.testing.assert_array_equal(tl[0].numpy(), pl[0].numpy())
    p, t = pair()
    po, to = P.zeros([2, 3]), T.zeros([2, 3])
    pdist.alltoall_single(p, po)
    tdist.alltoall_single(t, to)
    np.testing.assert_array_equal(to.numpy(), po.numpy())
    pl, tl = [], []
    pdist.gather(P.to_tensor(x), pl)
    tdist.gather(T.to_tensor(x), tl)
    np.testing.assert_array_equal(tl[0].numpy(), pl[0].numpy())
    pobj, tobj = [], []
    pdist.all_gather_object(pobj, {"a": 1})
    tdist.all_gather_object(tobj, {"a": 1})
    assert tobj == pobj == [{"a": 1}]
    assert tdist.broadcast_object_list([1, 2]) == \
        pdist.broadcast_object_list([1, 2])
    pobj, tobj = [], []
    pdist.scatter_object_list(pobj, [{"b": 2}])
    tdist.scatter_object_list(tobj, [{"b": 2}])
    assert tobj == pobj
    assert tdist.all_reduce(T.to_tensor(x), sync_op=False).wait()
    tdist.barrier()
    g = tdist.new_group([0])
    assert (g.rank, g.nranks) == (0, 1)


def test_init_parallel_env_on_the_cpu_is_gloo_and_nccl_needs_a_card():
    import torch
    T.set_device("cpu")
    assert tdist.get_backend() == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL backend needs a CUDA"):
            tdist.init_parallel_env(backend="nccl")
    assert not tdist.is_initialized()


def _recompute_pair(paddle, dropout):
    paddle.seed(3)
    layers = [paddle.nn.Linear(8, 8), paddle.nn.Tanh()]
    if dropout:
        layers.append(paddle.nn.Dropout(0.5))
    layers.append(paddle.nn.Linear(8, 8))
    layer = paddle.nn.Sequential(*layers)
    x = paddle.to_tensor(np.random.RandomState(4).randn(4, 8)
                         .astype(np.float32), stop_gradient=False)
    return layer, x


@pytest.mark.parametrize("dropout", [False, True])
def test_recompute_grads_equal_the_plain_backward(dropout):
    """The reference's test_recompute_grad_parity, restated, and with a
    dropout: the recomputation replays the generator, so the mask (and the
    gradients) are the plain run's from the same seed."""
    T.set_device("cpu")
    layer, x = _recompute_pair(T, dropout)
    T.seed(11)
    out = tdist.recompute(layer, x)
    out.sum().backward()
    g_re = {n: p.grad.numpy().copy() for n, p in layer.named_parameters()}
    gx_re = x.grad.numpy().copy()
    layer.clear_gradients()
    x2 = T.to_tensor(x.numpy(), stop_gradient=False)
    T.seed(11)
    out2 = layer(x2)
    np.testing.assert_array_equal(out.numpy(), out2.numpy())
    out2.sum().backward()
    for n, p in layer.named_parameters():
        np.testing.assert_allclose(g_re[n], p.grad.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(gx_re, x2.grad.numpy(), rtol=1e-6, atol=1e-7)
    if not dropout:
        # the reference's recompute on its own weights gives its gradients
        pl, px = _recompute_pair(P, False)
        pl.set_state_dict({k: v.numpy()
                           for k, v in layer.state_dict().items()})
        pdist.recompute(pl, px).sum().backward()
        for (n, a), (_, b) in zip(pl.named_parameters(),
                                  layer.named_parameters()):
            _leaf_close(b.grad.numpy(), a.grad.numpy(), 1e-5, n)


def test_spawn_starts_gloo_ranks(tmp_path):
    """distributed.spawn (reference spawn.py:463): two processes, each
    with the launcher's variables, join one gloo job."""
    import time
    from paddle_tpu_torch._testing import spawn_probe
    ctx = tdist.spawn(spawn_probe, args=(str(tmp_path),), nprocs=2,
                      join=False, backend="gloo")
    deadline = time.time() + 90
    try:
        while not ctx.join(timeout=1):
            assert time.time() < deadline, "spawned ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    got = [json.loads((tmp_path / f"spawn.{r}.json").read_text())
           for r in range(2)]
    assert got == [[0, 2, 3.0, "gloo"], [1, 2, 3.0, "gloo"]]
