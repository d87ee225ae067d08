"""Test environment helpers: the port's own ``force_cpu``, and the helpers
the multi-process tests start their ranks with.

The reference's ``paddle_tpu/_testing.py`` neutralises a TPU backend and
pins jax to the CPU before the first jax operation. The port imports no
jax: its ``force_cpu`` makes the CPU the default place, so that tensors,
Layers and optimizers built afterwards live on the CPU, as a CUDA-less
test or worker process needs (and ``distributed.init_parallel_env`` then
picks gloo). ``run_workers`` starts a script in N ranks through the
port's launcher with a timeout; ``spawn_probe`` is a worker for
``distributed.spawn``.
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
