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
gives a torch test module its worker's share of the cores.
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
    ("p."/"m."/"v." + leaf)."""
    import os
    import numpy as np
    import torch
    from . import distributed as dist
    from .models import gpt_hybrid as TH
    from .models.gpt import GPTConfig
    force_cpu()
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
            pp=pcfg.pp)
        opt = TH.dp_adamw_init(params, pcfg)
        step = TH.build_train_step(cfg, pcfg)
        losses = []
        for i in range(steps):
            x = np.random.RandomState(i).randint(0, size["vocab_size"],
                                                 (batch, seq))
            ids = torch.from_numpy(x).long()
            losses.append(float(step(params, opt, (ids, ids))[2]))
        x = np.random.RandomState(0).randint(0, size["vocab_size"],
                                             (batch, seq))
        ids = torch.from_numpy(x).long()
        with torch.no_grad():
            eval_loss = float(TH.loss_fn(params, (ids, ids), cfg, pcfg))
        full = TH.gather_opt_state(params, opt, pcfg, cfg)
        res = {"loss": np.asarray(losses), "eval_loss": eval_loss,
               "step": np.asarray(full["step"])}
        for kind, t in (("p", TH.gather_params(params, cfg, pcfg)),
                        ("m", full["m"]), ("v", full["v"])):
            res.update({f"{kind}.{k}": v for k, v in flat(t).items()})
        np.savez(os.path.join(out, f"{name}.{world}.{rank}.npz"), **res)
    dist.destroy_process_group()
