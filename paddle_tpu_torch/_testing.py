"""Test environment helpers: the port's own ``force_cpu``, and the helpers
the multi-process tests start their ranks with.

The reference's ``paddle_tpu/_testing.py`` neutralises a TPU backend and
pins jax to the CPU before the first jax operation. The port imports no
jax: its ``force_cpu`` makes the CPU the default place, so that tensors,
Layers and optimizers built afterwards live on the CPU, as a CUDA-less
test or worker process needs (and ``distributed.init_parallel_env`` then
picks gloo). ``run_workers`` starts a script in N ranks through the
port's launcher with a timeout; ``spawn_probe`` is a worker for
``distributed.spawn``; ``pipeline_apply_probe`` and ``gpt_hybrid_worker``
are the ranks of the pipeline tests' jobs; ``share_the_cores_fixture``
gives a torch test module its worker's share of the cores; ``rpc_peer``,
``rpc_release`` and ``rpc_matmul`` are a process of the rpc tests and the
functions they call through it.
"""
from __future__ import annotations


def force_cpu(num_devices: int | None = None,
              pop_tpu: bool = False) -> None:
    """Make the CPU the default place for this process, and ``aot_eager``
    the default backend of ``jit.to_static`` (inductor's C++ compile takes
    tens of seconds a program on a CPU). ``num_devices`` and ``pop_tpu``
    are the reference's jax settings and are accepted and ignored: torch's
    CPU is one device and there is no TPU backend."""
    from .core.place import set_device
    from .jit import set_default_backend
    set_device("cpu")
    set_default_backend("aot_eager")


def share_the_cores_fixture():
    """A module-scoped autouse pytest fixture for a torch test module
    (``_share_the_cores = share_the_cores_fixture()``): under pytest-xdist
    each worker's torch would start an intra-op thread a core, and
    OpenMP's barriers then wait on descheduled threads (a torch test file
    ran twice as long beside five other workers); while the module runs,
    torch takes its worker's share of the cores, and gets its count back
    after it. Alone (no xdist), nothing changes."""
    import pytest

    @pytest.fixture(scope="module", autouse=True)
    def _share_the_cores():
        import os
        import torch
        threads = torch.get_num_threads()
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
        yield
        torch.set_num_threads(threads)
    return _share_the_cores


def run_workers(script, nprocs, args=(), env=None, timeout=120,
                launcher_args=()):
    """Runs ``script`` in ``nprocs`` ranks through
    ``python -m paddle_tpu_torch.distributed.launch`` from the repository
    root, in a session of its own: past ``timeout`` seconds the whole
    process group (launcher and workers) is killed and TimeoutError raised,
    so a hung rendezvous fails fast. Returns the CompletedProcess (text
    output). Each rank gets ``OMP_NUM_THREADS=1`` unless ``env`` or the
    caller's environment sets it."""
    import os
    import signal
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = root + os.pathsep + full_env.get("PYTHONPATH",
                                                             "")
    # N CPU ranks with a thread pool each of every core oversubscribe the
    # host (twice the wall time at 2 ranks)
    full_env.setdefault("OMP_NUM_THREADS", "1")
    full_env.update(env or {})
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nprocs), *launcher_args, str(script),
           *map(str, args)]
    proc = subprocess.Popen(cmd, env=full_env, cwd=root,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise TimeoutError(f"{script} at {nprocs} ranks passed {timeout} s; "
                           f"stderr: {err[-2000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def spawn_probe(out_dir):
    """A worker of ``distributed.spawn`` for the tests: joins the job,
    all-reduces rank + 1 and writes rank, world and the sum to
    ``out_dir/spawn.<rank>.json``."""
    import json
    import os
    import torch
    from . import distributed as dist
    dist.init_parallel_env()
    t = torch.tensor([dist.get_rank() + 1.0])
    dist.all_reduce(t)
    with open(os.path.join(out_dir, f"spawn.{dist.get_rank()}.json"),
              "w") as f:
        json.dump([dist.get_rank(), dist.get_world_size(), float(t[0]),
                   dist.get_backend()], f)
    dist.destroy_process_group()


def pipeline_apply_probe(out):
    """A rank of a pipeline_apply parity job: joins the job (each rank a
    stage of the world group), runs ``parallel.pipeline_apply`` of the
    stage tanh(x @ w) on ``out/papply.npz`` (its stacked stage weights "w"
    [n, d, d] and microbatches "x" [M, b, d]), and writes
    ``out/papply.<rank>.npz``: the outputs and the gradients of
    sum(out ** 2) with respect to this rank's stage weight and the input."""
    import os
    import numpy as np
    import torch
    from . import distributed as dist
    from .parallel import pipeline_apply
    force_cpu()
    group = dist.init_parallel_env()
    with np.load(os.path.join(out, "papply.npz")) as f:
        w = torch.from_numpy(f["w"][group.rank]).requires_grad_(True)
        x = torch.from_numpy(f["x"]).requires_grad_(True)
    y = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": w}, x,
                       group)
    gw, gx = torch.autograd.grad((y ** 2).sum(), [w, x])
    np.savez(os.path.join(out, f"papply.{group.rank}.npz"),
             out=y.detach().numpy(), gw=gw.numpy(), gx=gx.numpy())


def gpt_hybrid_worker(out, configs, batch, seq, steps):
    """A rank of a gpt_hybrid parity job (the multi-rank tests' worker):
    for each (name, size, ParallelConfig fields) of ``configs`` it loads
    the reference's parameters from ``out/start.<name>.npz`` (its global
    layout, flattened to "blocks.<leaf>" keys), takes this rank's stage and
    tp shards, runs ``steps`` steps of the (dp, pp, tp) step on batches of
    ``RandomState(step)`` ids, and writes ``out/<name>.<world>.<rank>.npz``:
    the losses, the loss of ``loss_fn`` on the first batch after the steps,
    and the parameters and moments gathered into the reference's layout
    ("p."/"m."/"v." + leaf). With experts, this rank keeps its dp rank's
    experts and also writes its all-to-alls over the steps
    ("alltoall_calls", from collective.ALLTOALL_STATS)."""
    import os
    import numpy as np
    import torch
    from . import distributed as dist
    from .models import gpt_hybrid as TH
    from .models.gpt import GPTConfig
    force_cpu()
    from .distributed import collective as C
    dist.init_parallel_env()
    rank, world = dist.get_rank(), dist.get_world_size()

    def tree(path):
        t = {"blocks": {}}
        with np.load(path) as f:
            for k in f.files:
                if k.startswith("blocks."):
                    t["blocks"][k[7:]] = f[k]
                else:
                    t[k] = f[k]
        return t

    def flat(t, prefix=""):
        o = {}
        for k in sorted(t):
            v = t[k]
            o.update(flat(v, prefix + k + ".") if isinstance(v, dict)
                     else {prefix + k: v.detach().float().numpy()})
        return o

    for name, size, fields in configs:
        cfg = GPTConfig(**size)
        pcfg = TH.ParallelConfig(**{"remat": False, "fused_ce": True,
                                    "param_dtype": torch.float32,
                                    "compute_dtype": torch.float32,
                                    **fields})
        grid = TH._grid(pcfg)
        params = TH.params_from_jax(
            tree(os.path.join(out, f"start.{name}.npz")), device="cpu",
            tp_rank=grid.tp_rank, tp=pcfg.tp, pp_rank=grid.pp_rank,
            pp=pcfg.pp, dp_rank=grid.dp_rank, dp=grid.dp)
        opt = TH.dp_adamw_init(params, pcfg)
        step = TH.build_train_step(cfg, pcfg)
        losses = []
        calls = C.ALLTOALL_STATS["calls"]
        for i in range(steps):
            x = np.random.RandomState(i).randint(0, size["vocab_size"],
                                                 (batch, seq))
            ids = torch.from_numpy(x).long()
            losses.append(float(step(params, opt, (ids, ids))[2]))
        calls = C.ALLTOALL_STATS["calls"] - calls
        x = np.random.RandomState(0).randint(0, size["vocab_size"],
                                             (batch, seq))
        ids = torch.from_numpy(x).long()
        with torch.no_grad():
            eval_loss = float(TH.loss_fn(params, (ids, ids), cfg, pcfg))
        full = TH.gather_opt_state(params, opt, pcfg, cfg)
        res = {"loss": np.asarray(losses), "eval_loss": eval_loss,
               "step": np.asarray(full["step"]),
               "alltoall_calls": np.asarray(calls)}
        for kind, t in (("p", TH.gather_params(params, cfg, pcfg)),
                        ("m", full["m"]), ("v", full["v"])):
            res.update({f"{kind}.{k}": v for k, v in flat(t).items()})
        np.savez(os.path.join(out, f"{name}.{world}.{rank}.npz"), **res)
    dist.destroy_process_group()


def auto_parallel_worker(out):
    """A rank of the semi-auto API's multi-rank tests (four ranks): the
    shard_tensor/reshard cases of the reference's test_distributed.py and
    test_reshard_matrix.py, ``annotate_tp`` on a (dp, mp) = (2, 2) mesh, and
    the Engine's and DistModel's data-parallel steps against plain steps on
    the whole batch. Writes ``out/auto.<rank>.npz``: for each case its
    local piece on this rank (".local"), its global value (".global") and
    its placements (".placements": "S<dim>" or "R" a mesh dim), and the
    other cases' values."""
    import os
    import numpy as np
    import torch
    force_cpu()
    from . import distributed as dist
    import paddle_tpu_torch as paddle
    from .distributed.auto_parallel import Engine, PlanCandidate
    from .distributed.auto_parallel.partitioner import annotate_tp
    dist.init_parallel_env()
    rank = dist.get_rank()
    res = {}
    f32 = np.float32

    def keep(name, t):
        a = t._data
        res[name + ".local"] = (a.to_local() if hasattr(a, "to_local")
                                else a).detach().float().numpy()
        res[name + ".global"] = t.numpy()
        res[name + ".placements"] = np.asarray(",".join(
            f"S{pl.get_dim()}" if pl.is_shard() else "R"
            for pl in t.placements or ()))

    data = np.arange(64, dtype=f32).reshape(8, 8)
    mesh4 = dist.ProcessMesh(shape=[4], dim_names=["x"])
    mesh22 = dist.ProcessMesh(shape=[2, 2], dim_names=["dp", "mp"])
    x = np.random.RandomState(0).randn(8, 16).astype(f32)
    keep("shard_2x2", dist.shard_tensor(paddle.to_tensor(x), mesh22,
                                        [dist.Shard(0), dist.Shard(1)]))
    d = dist.shard_tensor(paddle.to_tensor(data), mesh4, [dist.Shard(0)])
    keep("s0", d)
    r = dist.reshard(d, mesh4, [dist.Replicate()])
    keep("s0_to_r", r)
    keep("r_to_s1", dist.reshard(r, mesh4, [dist.Shard(1)]))
    keep("r_to_s0", dist.reshard(dist.shard_tensor(
        paddle.to_tensor(data), mesh4, [dist.Replicate()]), mesh4,
        [dist.Shard(0)]))
    keep("s0_to_s1", dist.reshard(d, mesh4, [dist.Shard(1)]))
    t = dist.shard_tensor(paddle.to_tensor(data), mesh22,
                          [dist.Shard(0), dist.Replicate()])
    keep("nd", t)
    keep("nd_flipped", dist.reshard(t, mesh22,
                                    [dist.Replicate(), dist.Shard(1)]))
    mesh_a = dist.ProcessMesh(shape=[2], dim_names=["x"])
    mesh_b = dist.ProcessMesh(shape=[4], dim_names=["y"],
                              process_ids=[0, 1, 2, 3])
    moved = dist.reshard(dist.shard_tensor(paddle.to_tensor(data), mesh_a,
                                           [dist.Shard(0)]),
                         mesh_b, [dist.Shard(1)])
    keep("cross_mesh", moved)
    res["cross_mesh.mesh_shape"] = np.asarray(moved.process_mesh.shape)
    keep("unshard", dist.unshard_dtensor(dist.reshard(d, mesh4,
                                                      [dist.Shard(1)])))
    keep("from_local", dist.dtensor_from_local(
        paddle.to_tensor(data[2 * rank:2 * rank + 2]), mesh4,
        [dist.Shard(0)]))
    rng = np.random.RandomState(0)
    a = rng.randn(16, 32).astype(f32)
    b = rng.randn(32, 8).astype(f32)
    mesh_mp = dist.ProcessMesh(shape=[4], dim_names=["mp"])
    prod = paddle.matmul(
        dist.shard_tensor(paddle.to_tensor(a), mesh_mp, [dist.Shard(1)]),
        dist.shard_tensor(paddle.to_tensor(b), mesh_mp, [dist.Shard(0)]))
    res["matmul.global"] = prod.numpy()
    try:
        dist.shard_tensor(paddle.to_tensor(data), mesh4, [dist.Partial()])
        res["partial_refused"] = np.asarray(False)
    except ValueError:
        res["partial_refused"] = np.asarray(True)
    xg = paddle.to_tensor(data, stop_gradient=False)
    rg = dist.reshard(dist.shard_tensor(xg, mesh4, [dist.Shard(0)]), mesh4,
                      [dist.Replicate()])
    (rg * 2).sum().backward()
    res["grad"] = xg.grad.numpy()
    with paddle.amp.auto_cast(enable=True, level="O2"):
        s = dist.shard_tensor(paddle.to_tensor(data), mesh4,
                              [dist.Shard(0)])
        x2 = paddle.to_tensor(data, stop_gradient=False)
        s2 = dist.shard_tensor(x2, mesh4, [dist.Shard(0)])
        r2 = dist.reshard(s2, mesh4, [dist.Replicate()])
    res["amp_dtypes"] = np.asarray([str(t.dtype) for t in (s, s2, r2)])

    # annotate_tp on (dp, mp) = (2, 2): an Embedding (width split), a
    # column-parallel Linear and a row-parallel one (5 outputs)
    def mlp():
        paddle.seed(0)
        return paddle.nn.Sequential(
            paddle.nn.Embedding(64, 16), paddle.nn.Linear(16, 32),
            paddle.nn.ReLU(), paddle.nn.Linear(32, 5))
    ids = paddle.to_tensor(np.random.RandomState(1).randint(0, 64, (4, 8)))
    dense = mlp()
    want = dense(ids)
    want.sum().backward()
    grads = {n: p.grad.numpy() for n, p in dense.named_parameters()}
    model = mlp()
    res["tp.annotated"] = np.asarray(annotate_tp(model, mesh22, "mp"))
    got = model(ids)
    got.sum().backward()
    res["tp.out_err"] = np.asarray(np.abs(got.numpy()
                                          - want.numpy()).max())
    mp = mesh22.get_group("mp")
    err = 0.0
    for n, p in model.named_parameters():
        g, w = p.grad.numpy(), grads[n]
        if g.shape != w.shape:
            dim = [i for i in range(g.ndim) if g.shape[i] != w.shape[i]][0]
            w = np.split(w, mp.nranks, dim)[mp.rank]
        err = max(err, float(np.abs(g - w).max()))
    res["tp.grad_err"] = np.asarray(err)

    # the Engine (dp4 with and without ZeRO-1; dp2 x tp2) and DistModel
    # (dp4 through shard_dataloader, with ShardingStage1) against plain
    # steps on the whole batch
    xs = np.random.RandomState(2).randn(8, 16).astype(f32)
    ys = np.random.RandomState(3).randint(0, 4, (8,))

    def net():
        paddle.seed(11)
        m = paddle.nn.Sequential(paddle.nn.Linear(16, 64), paddle.nn.ReLU(),
                                 paddle.nn.Linear(64, 4))
        return m, paddle.optimizer.AdamW(3e-3, parameters=m.parameters())
    loss_fn = paddle.nn.CrossEntropyLoss()
    batches = [(xs, ys)] * 3
    m, opt = net()
    plain = []
    for xb, yb in batches:
        loss = loss_fn(m(paddle.to_tensor(xb)), paddle.to_tensor(yb))
        loss.backward()
        opt.step()
        opt.clear_grad()
        plain.append(float(loss))
    res["plain"] = np.asarray(plain)
    for name, plan in (("dp4", PlanCandidate(dp=4)),
                       ("dp4_zero1", PlanCandidate(dp=4, zero=1)),
                       ("dp2_tp2", PlanCandidate(dp=2, tp=2))):
        m, opt = net()
        e = Engine(m, loss_fn, opt)
        e.prepare(plan=plan)
        res[f"engine.{name}"] = np.asarray(
            [float(e._step(e._rows(xb), e._rows(yb))) for xb, yb in batches])
    m, opt = net()
    e = Engine(m, loss_fn, opt)
    res["engine.auto_plan"] = np.asarray(e.plan(global_batch=8)[0].short())
    mesh_dp = dist.ProcessMesh(shape=[4], dim_names=["dp"])
    m, opt = net()
    dist.shard_layer(m, mesh_dp)
    dm = dist.to_static(m, None, loss_fn, dist.shard_optimizer(
        opt, dist.ShardingStage1("dp", mesh_dp)))
    loader = dist.shard_dataloader(
        [(paddle.to_tensor(xb), paddle.to_tensor(yb))
         for xb, yb in batches], mesh_dp, shard_dims="dp")
    res["distmodel.dp4_zero1"] = np.asarray([float(dm(xb, yb))
                                             for xb, yb in loader])
    # DistModel over parameters sharded on mp (Megatron's column and row
    # layouts of the two Linears): the layer runs on the DTensors
    m, opt = net()
    for p, pl in ((m[0].weight, dist.Shard(1)), (m[0].bias, dist.Shard(0)),
                  (m[2].weight, dist.Shard(0)),
                  (m[2].bias, dist.Replicate())):
        dist.shard_tensor(p, mesh22, [dist.Replicate(), pl])
    dm = dist.to_static(m, None, loss_fn, dist.shard_optimizer(opt))
    res["distmodel.mp2"] = np.asarray([
        float(dm(paddle.to_tensor(xb), paddle.to_tensor(yb)))
        for xb, yb in batches])
    np.savez(os.path.join(out, f"auto.{rank}.npz"), **res)
    dist.destroy_process_group()


#: the MoE exchange test's counts: rank r sends LOCAL_COUNTS[r][j * 2 + i]
#: rows to expert i of rank j (two ranks of two experts)
MOE_LOCAL_COUNTS = ((2, 1, 0, 3), (1, 0, 2, 2))


def moe_exchange_rows(rank):
    """(rank ``rank``'s rows for the MoE exchange test: its counted rows and
    one row it does not send, the cotangent its scatter output gets)."""
    import numpy as np
    lc = MOE_LOCAL_COUNTS[rank]
    x = np.arange((sum(lc) + 1) * 3, dtype=np.float32).reshape(-1, 3) \
        + 100 * rank
    gc = [MOE_LOCAL_COUNTS[j][rank * 2 + i] for j in range(2)
          for i in range(2)]
    w = np.random.RandomState(rank).randn(sum(gc), 3).astype(np.float32)
    return x, w


def moe_exchange_worker(out):
    """A rank of the two-rank ``global_scatter``/``global_gather`` test:
    writes ``out/moe.<rank>.npz`` with the scatter's output, the gather of
    it back, the gradient of sum(w * scatter(x)) with respect to x, and the
    gradient of sum(x * gather(scatter(x)))."""
    import os
    import numpy as np
    force_cpu()
    import paddle_tpu_torch as paddle
    from . import distributed as dist
    from .distributed.utils import global_gather, global_scatter
    dist.init_parallel_env()
    rank = dist.get_rank()
    lc = MOE_LOCAL_COUNTS[rank]
    gc = [MOE_LOCAL_COUNTS[j][rank * 2 + i] for j in range(2)
          for i in range(2)]
    x_np, w = moe_exchange_rows(rank)
    x = paddle.to_tensor(x_np, stop_gradient=False)
    s = global_scatter(x, paddle.to_tensor(np.asarray(lc)),
                       paddle.to_tensor(np.asarray(gc)))
    (s * paddle.to_tensor(w)).sum().backward()
    res = {"scatter": s.numpy(), "grad": x.grad.numpy()}
    x2 = paddle.to_tensor(x_np[:sum(lc)], stop_gradient=False)
    back = global_gather(global_scatter(x2, lc, gc), lc, gc)
    (back * x2).sum().backward()
    res.update(back=back.numpy(), back_grad=x2.grad.numpy())
    np.savez(os.path.join(out, f"moe.{rank}.npz"), **res)
    dist.destroy_process_group()


_RPC_RELEASED = None


def rpc_peer(name, rank, world_size, master):
    """A process of an rpc test: ``init_rpc`` as ``name``, serve calls
    until a peer calls ``rpc_release`` on it, then ``shutdown``."""
    import threading
    from .distributed import rpc
    global _RPC_RELEASED
    _RPC_RELEASED = threading.Event()
    rpc.init_rpc(name, rank=rank, world_size=world_size,
                 master_endpoint=master)
    try:
        if not _RPC_RELEASED.wait(120):
            raise TimeoutError(f"rpc_peer {name}: never released")
    finally:
        rpc.shutdown()


def rpc_release():
    """Called through rpc on an ``rpc_peer``: lets it shut down."""
    _RPC_RELEASED.set()
    return True


def rpc_matmul(a, b):
    """Called through rpc: ``a @ b`` on the callee's default place, as
    numpy."""
    import numpy as np
    from . import to_tensor
    return np.asarray((to_tensor(a) @ to_tensor(b)).numpy())


def tensor_queue_child(q_in, q_out):
    """A spawned process of ``incubate.multiprocessing``: takes two Tensors
    from ``q_in`` (CPU), sends back the first doubled with its
    stop_gradient, name and place, and the second as it came."""
    from . import set_device
    set_device("cpu")
    t, other = q_in.get(), q_in.get()
    q_out.put((t * 2, t.stop_gradient, t.name, str(t.place), other))


def numpy_initializers(jax):
    """A context manager, given the caller's ``jax`` module: while it is
    open, ``jax.random.normal``, ``uniform`` and ``truncated_normal`` draw
    from numpy (a ``RandomState`` seeded from the key's words) into float32
    jax arrays. A reference Layer model then builds without compiling one
    random kernel a parameter shape, which takes tens of seconds for a
    vision model on a CPU. The distributions are the reference's, drawn
    from another stream; a parity test copies the weights into the port,
    so both sides hold the same values."""
    import contextlib

    import numpy as np

    def seed(key):
        if jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key):
            key = jax.random.key_data(key)
        words = [int(w) for w in np.asarray(key).ravel()]
        return (words[0] * 2654435761 + words[-1]) % (1 << 32)

    def f32(x):
        return jax.numpy.asarray(x, np.float32)

    def normal(key, shape=(), dtype=None):
        return f32(np.random.RandomState(seed(key)).standard_normal(
            tuple(shape)))

    def uniform(key, shape=(), dtype=None, minval=0.0, maxval=1.0):
        return f32(np.random.RandomState(seed(key)).uniform(
            float(minval), float(maxval), tuple(shape)))

    def truncated_normal(key, lower, upper, shape=None, dtype=None):
        rs = np.random.RandomState(seed(key))
        z = rs.standard_normal(tuple(shape or ()))
        out = (z < lower) | (z > upper)
        while out.any():                       # redraw, not clip
            z[out] = rs.standard_normal(int(out.sum()))
            out = (z < lower) | (z > upper)
        return f32(z)

    @contextlib.contextmanager
    def patched():
        names = ("normal", "uniform", "truncated_normal")
        saved = {n: getattr(jax.random, n) for n in names}
        jax.random.normal, jax.random.uniform = normal, uniform
        jax.random.truncated_normal = truncated_normal
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(jax.random, n, fn)
    return patched()
