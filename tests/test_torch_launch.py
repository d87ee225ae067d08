"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
and sharded checkpoints across world sizes, on the CPU.

Restated from the reference's tests on the port (their scripts import
``paddle_tpu_torch`` instead of ``paddle_tpu``): the launcher tests of
``tests/test_elastic_fault.py`` (``test_launcher_kills_job_on_worker_
failure``, ``test_launcher_relaunches_after_midrun_kill``,
``test_launcher_exhausts_restarts``,
``test_elastic_scale_{in,out}_resumes_from_checkpoint`` with a
``FileKVStore`` and with a ``tcp://`` store, a ``TCPKVStore`` the
launcher hosts), ``tests/test_checkpoint_profiler.py::test_launcher_cpu_sim``,
``test_sharded_checkpoint_roundtrip`` and
``test_checkpoint_reshards_across_mesh_change`` (the reference shards one
process's array over its mesh; here each rank of a gloo job saves its own
block as a ``ShardedTensor`` and another world size loads other blocks),
and a ZeRO-1 gpt_hybrid state saved at dp=2 and resumed at dp=4; and
concurrent launches, each of which joins the store its own launcher hosts.
Each launch has its own timeout, past which its whole process group is
killed.
"""
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch as T
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**kw):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    env.update(kw)
    return env


def _launch(args, timeout, **env):
    """Runs the launcher in a session of its own; past ``timeout`` the whole
    group is killed and the test fails."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *map(str, args)], env=_env(**env), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err


def test_launcher_cpu_sim(tmp_path):
    """2-process single-host launch: each worker sees its rank and the
    world, the reference's variables and torch's."""
    script = tmp_path / "worker.py"
    script.write_text(
        "import os, sys\n"
        "sys.stdout.write('rank %s world %s torch %s %s %s\\n' % (\n"
        "    os.environ['PADDLE_TRAINER_ID'],\n"
        "    os.environ['PADDLE_TRAINERS_NUM'], os.environ['RANK'],\n"
        "    os.environ['WORLD_SIZE'], os.environ['MASTER_PORT']))\n")
    rc, out, err = _launch(["--nproc_per_node", 2, script], timeout=60)
    assert rc == 0, err
    out = out.decode()
    assert "rank 0 world 2 torch 0 2" in out and \
        "rank 1 world 2 torch 1 2" in out


JOIN = r'''
import json, os, sys
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import torch
import paddle_tpu_torch.distributed as dist
out, job = sys.argv[1], int(sys.argv[2])
dist.init_parallel_env()
t = torch.tensor([float(job)])
dist.all_reduce(t)
with open(os.path.join(out, f"join.{job}.{dist.get_rank()}.json"), "w") as f:
    env = dist.ParallelEnv()
    json.dump({"sum": float(t[0]), "world": dist.get_world_size(),
               "port": os.environ["MASTER_PORT"],
               "hosted": os.environ["PADDLE_STORE_HOSTED"],
               "current": env.current_endpoint,
               "endpoints": env.trainer_endpoints}, f)
dist.destroy_process_group()
'''


def test_concurrent_launches_each_join_their_own_job(tmp_path):
    """Four 2-rank jobs launched at once: the launcher hosts each job's
    rendezvous store on a port it holds from before the workers start, so
    every job gets its own port and each rank joins its own job (its
    all-reduce sums its own job's values only). Each rank's endpoint is a
    "host:port" string, as the reference's launcher gives, and its entry
    of the trainer endpoints."""
    from concurrent.futures import ThreadPoolExecutor
    script = tmp_path / "join.py"
    script.write_text(JOIN)
    jobs = (1, 10, 100, 1000)
    with ThreadPoolExecutor(len(jobs)) as pool:
        res = list(pool.map(lambda j: run_workers(script, 2, [tmp_path, j],
                                                  timeout=120), jobs))
    for r in res:
        assert r.returncode == 0, r.stderr[-3000:]
    ports = set()
    for j in jobs:
        got = [json.loads((tmp_path / f"join.{j}.{r}.json").read_text())
               for r in range(2)]
        for r, g in enumerate(got):
            assert g["sum"] == 2.0 * j and g["world"] == 2, (j, g)
            assert g["hosted"] == "1"
            assert re.fullmatch(r"[\w.]+:\d+", g["current"]), g
            assert len(g["endpoints"]) == 2 and \
                g["endpoints"][r] == g["current"], g
        assert got[0]["port"] == got[1]["port"]
        ports.add(got[0]["port"])
    assert len(ports) == len(jobs)


def test_launcher_kills_job_on_worker_failure(tmp_path):
    """One worker exiting non-zero terminates the whole job with its code,
    its sleeping peer (and that peer's child) killed with it."""
    script = tmp_path / "failer.py"
    script.write_text(
        "import os, subprocess, sys, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "if rank == 1:\n"
        "    time.sleep(0.5)\n"
        "    sys.exit(3)\n"
        "child = subprocess.Popen([sys.executable, '-c',\n"
        "                          'import time; time.sleep(300)'])\n"
        f"open(r'{tmp_path}' + '/child.pid', 'w').write(str(child.pid))\n"
        "time.sleep(300)\n")
    t0 = time.time()
    rc, _, err = _launch(["--nproc_per_node", 2, script], timeout=60)
    assert rc == 3, (rc, err[-500:])
    assert time.time() - t0 < 30
    pid = int((tmp_path / "child.pid").read_text())
    time.sleep(0.2)
    # no orphan left behind: gone, or a zombie no parent reaps
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        state = "gone"
    assert state in ("gone", "Z"), state


def test_launcher_relaunches_after_midrun_kill(tmp_path):
    """A worker SIGKILLed mid-run on the first attempt; with --max_restarts
    the launcher respawns the whole job with PADDLE_RESTART_COUNT bumped,
    and the second attempt completes."""
    script = tmp_path / "crasher.py"
    script.write_text(
        "import os, signal, time\n"
        "rank = int(os.environ['PADDLE_TRAINER_ID'])\n"
        "attempt = int(os.environ['PADDLE_RESTART_COUNT'])\n"
        "open(f'%s/seen.{rank}.{attempt}', 'w').close()\n"
        "if rank == 1 and attempt == 0:\n"
        "    time.sleep(0.3)\n"
        "    os.kill(os.getpid(), signal.SIGKILL)\n"
        "time.sleep(0.5)\n" % tmp_path)
    rc, _, err = _launch(["--nproc_per_node", 2, "--max_restarts", 2,
                          script], timeout=60)
    assert rc == 0, (rc, err[-800:])
    assert b"relaunching job (attempt 1/2)" in err
    for marker in ("seen.0.0", "seen.1.0", "seen.0.1", "seen.1.1"):
        assert (tmp_path / marker).exists(), marker


def test_launcher_exhausts_restarts(tmp_path):
    script = tmp_path / "alwaysfail.py"
    script.write_text(
        "import os, sys\n"
        "attempt = int(os.environ['PADDLE_RESTART_COUNT'])\n"
        "open(f'%s/try.{os.environ[\"PADDLE_TRAINER_ID\"]}.{attempt}',"
        " 'w').close()\n"
        "sys.exit(7)\n" % tmp_path)
    rc, _, err = _launch(["--nproc_per_node", 1, "--max_restarts", 1,
                          script], timeout=60)
    assert rc == 7, (rc, err[-500:])
    assert (tmp_path / "try.0.0").exists()
    assert (tmp_path / "try.0.1").exists()
    assert not (tmp_path / "try.0.2").exists()


def test_launcher_refuses_a_tcp_store_until_the_native_store():
    """The native store is ported: a ``tcp://`` store is taken (the elastic
    test below runs one); what is refused is a port that is not a number,
    and the rendezvous store's port given to the elastic store too."""
    from paddle_tpu_torch.distributed.launch.main import main
    with pytest.raises(SystemExit, match="numeric port"):
        main(["--nproc_per_node", "1", "--np_range", "1:2",
              "--elastic_store", "tcp://127.0.0.1:x", "x.py"])
    with pytest.raises(SystemExit, match="share a port"):
        main(["--nproc_per_node", "1", "--np_range", "1:2", "--master",
              "127.0.0.1:29999", "--elastic_store", "tcp://127.0.0.1:29999",
              "x.py"])


def test_launcher_hosts_a_tcp_elastic_store(tmp_path):
    """``--elastic_store tcp://`` (the reference's launch main.py:130-139):
    the launcher hosts a TCPKVStore at that port, beside the rendezvous
    store at another; two workers put their keys and read each other's."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "kv.py"
    script.write_text(
        "import os, sys, time\n"
        "from paddle_tpu_torch.distributed.elastic import TCPKVStore\n"
        "rank = os.environ['PADDLE_TRAINER_ID']\n"
        "kv = TCPKVStore('127.0.0.1', int(sys.argv[1]))\n"
        "kv.put(f'job/nodes/{rank}', os.environ['MASTER_PORT'], ttl_s=60)\n"
        "while len(kv.get_prefix('job/nodes/')) < 2:\n"
        "    time.sleep(0.02)\n"
        "print(sorted(kv.get_prefix('job/nodes/').items()))\n")
    rc, out, err = _launch(["--nproc_per_node", 2, "--np_range", "2:2",
                            "--elastic_store", f"tcp://127.0.0.1:{port}",
                            script, port], timeout=60)
    assert rc == 0, err[-800:]
    lines = out.decode().splitlines()
    assert len(lines) == 2 and lines[0] == lines[1]
    rendezvous = eval(lines[0])[0][1]
    assert eval(lines[0]) == [("job/nodes/0", rendezvous),
                              ("job/nodes/1", rendezvous)]
    assert int(rendezvous) != port


ELASTIC = """
import json, os, signal, sys, time
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import numpy as np
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import checkpoint as dc

rank = int(os.environ["PADDLE_TRAINER_ID"])
world = int(os.environ["PADDLE_TRAINERS_NUM"])
attempt = int(os.environ["PADDLE_RESTART_COUNT"])
CK = os.environ["CKPT_DIR"]
MODE = os.environ["MODE"]
TOTAL = 8
open(os.path.join(CK, f"world.{attempt}.{rank}.{world}"), "w").close()

paddle.seed(0)
m = nn.Sequential(nn.Linear(4, 8), nn.Tanh(), nn.Linear(8, 2))
opt = paddle.optimizer.SGD(0.1, parameters=m.parameters())
x = paddle.to_tensor(np.random.RandomState(0).randn(16, 4).astype("f4"))
y = paddle.to_tensor(np.random.RandomState(1).randn(16, 2).astype("f4"))
loss_fn = nn.MSELoss()

state = {"model": m.state_dict(), "step": -1}
start = 0
latest = dc.latest_committed(CK)
if latest is not None:
    dc.load_state_dict(state, latest)
    start = state["step"] + 1

def ck_step():
    d = dc.latest_committed(CK)
    if d is None:
        return -1
    try:
        with open(os.path.join(d, "metadata.json")) as f:
            return json.load(f)["tensors"]["step"]["value"]
    except Exception:
        return -1

def barrier(step):
    open(os.path.join(CK, f"sync.{attempt}.{step}.{rank}"), "w").close()
    while not all(os.path.exists(os.path.join(
            CK, f"sync.{attempt}.{step}.{r}")) for r in range(world)):
        time.sleep(0.02)

for step in range(start, TOTAL):
    barrier(step)
    loss = loss_fn(m(x), y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    if rank == 0:
        dc.save_state_dict({"model": m.state_dict(), "step": step},
                           os.path.join(CK, "step_%04d" % step))
    if MODE == "in" and rank == 2 and attempt == 0 and step >= 3:
        while ck_step() < 3:
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGKILL)
    if MODE == "out" and attempt == 0:
        time.sleep(0.3)      # paces attempt 0 so that the join lands mid-run
if rank == 0:
    with open(os.path.join(CK, "final_loss"), "w") as f:
        f.write(str(float(loss)))
"""


def _oracle():
    T.set_device("cpu")
    T.seed(0)
    oracle = T.nn.Sequential(T.nn.Linear(4, 8), T.nn.Tanh(),
                             T.nn.Linear(8, 2))
    opt = T.optimizer.SGD(0.1, parameters=oracle.parameters())
    x = T.to_tensor(np.random.RandomState(0).randn(16, 4).astype("f4"))
    y = T.to_tensor(np.random.RandomState(1).randn(16, 2).astype("f4"))
    for _ in range(8):
        loss = T.nn.MSELoss()(oracle(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
    return float(loss), oracle


def _check_resumed(ck):
    from paddle_tpu_torch.distributed import checkpoint as dc
    loss, oracle = _oracle()
    final_loss = float((ck / "final_loss").read_text())
    assert abs(final_loss - loss) < 1e-5, (final_loss, loss)
    T.seed(0)
    fresh = T.nn.Sequential(T.nn.Linear(4, 8), T.nn.Tanh(),
                            T.nn.Linear(8, 2))
    state = {"model": fresh.state_dict(), "step": -1}
    latest = dc.latest_committed(str(ck))
    assert latest is not None and latest.endswith("step_0007"), latest
    dc.load_state_dict(state, latest)
    assert state["step"] == 7
    for (_, a), (_, b) in zip(fresh.named_parameters(),
                              oracle.named_parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_elastic_scale_in_resumes_from_checkpoint(tmp_path):
    """3 workers train; worker 2 dies mid-run; the launcher relaunches at
    the surviving world size 2, which resumes from the latest committed
    checkpoint and ends where an uninterrupted run ends."""
    ck = tmp_path / "ckpt"
    ck.mkdir()
    script = tmp_path / "elastic_train.py"
    script.write_text(ELASTIC)
    rc, _, err = _launch(["--nproc_per_node", 3, "--max_restarts", 2,
                          "--np_range", "2:3", script], timeout=100,
                         CKPT_DIR=str(ck), MODE="in")
    assert rc == 0, (rc, err[-800:])
    assert b"scaling 3 -> 2 workers" in err
    seen = sorted(p.name for p in ck.glob("world.*"))
    assert "world.0.0.3" in seen and "world.1.0.2" in seen, seen
    assert "world.1.1.2" in seen and not any(
        n.startswith("world.1.2") for n in seen), seen
    _check_resumed(ck)


def test_elastic_scale_out_resumes_from_checkpoint(tmp_path):
    """2 workers train; a third announces itself through the FileKVStore's
    join/ prefix; the launcher restarts the job at 3, which resumes from
    the checkpoint and ends where an uninterrupted run ends."""
    from paddle_tpu_torch.distributed import checkpoint as dc
    from paddle_tpu_torch.distributed.elastic import FileKVStore
    ck = tmp_path / "ckpt"
    ck.mkdir()
    store_dir = tmp_path / "store"
    script = tmp_path / "elastic_out_train.py"
    script.write_text(ELASTIC)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--max_restarts", "0", "--np_range", "2:3",
         "--elastic_store", str(store_dir), str(script)],
        env=_env(CKPT_DIR=str(ck), MODE="out"), stderr=subprocess.PIPE,
        start_new_session=True)

    def ck_step():
        d = dc.latest_committed(str(ck))
        if d is None:
            return -1
        try:
            return json.loads((pathlib.Path(d) / "metadata.json")
                              .read_text())["tensors"]["step"]["value"]
        except (OSError, ValueError, KeyError):
            return -1
    try:
        deadline = time.time() + 60
        while time.time() < deadline and ck_step() < 2:
            time.sleep(0.1)
        assert ck_step() >= 2, "attempt 0 never reached step 2"
        FileKVStore(str(store_dir)).put("join/worker-new", "1")
        _, err = proc.communicate(timeout=90)
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, (proc.returncode, err[-800:])
    assert b"scaling 2 -> 3 workers (join)" in err
    seen = sorted(p.name for p in ck.glob("world.*"))
    assert "world.0.0.2" in seen and "world.0.1.2" in seen, seen
    for r in range(3):
        assert f"world.1.{r}.3" in seen, seen
    _check_resumed(ck)


# ----------------------------------------------- sharded checkpoints
CKPT = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import torch
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed.checkpoint import (
    ShardedTensor, load_state_dict, save_state_dict)
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig

out, phase = sys.argv[1], sys.argv[2]
dist.init_parallel_env()
r, n = dist.get_rank(), dist.get_world_size()
W = np.arange(64, dtype=np.float32).reshape(8, 8)
res = {}
cfg = GPTConfig(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
                max_seq_len=16)
ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (8, 16)))

def gpt(pcfg):
    params, opt, step = TH.setup(cfg, pcfg, seed=0, device="cpu")
    return params, opt, step

if phase == "save":
    # rows sharded over the ranks (mesh [n], Shard(0)), a replicated bias
    rows = 8 // n
    w = ShardedTensor(paddle.to_tensor(W[r * rows:(r + 1) * rows]), (8, 8),
                      (r * rows, 0))
    save_state_dict({"w": w, "b": paddle.ones([8]), "step": 7},
                    os.path.join(out, "rows"))
    # gpt_hybrid's ZeRO-1 state after two steps, saved by every rank
    pcfg = TH.ParallelConfig(dp=n, zero1=True, remat=False,
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    params, opt, step = gpt(pcfg)
    for _ in range(2):
        step(params, opt, (ids, ids))
    save_state_dict({"params": params, **TH.opt_state_shards(params, opt,
                                                             pcfg)},
                    os.path.join(out, "gpt"))
    full = TH.gather_opt_state(params, opt, pcfg)
    res.update({f"m.{k}": v.numpy() for k, v in full["m"]["blocks"].items()})
    res["loss3"] = float(step(params, opt, (ids, ids))[2])
elif phase == "load":
    # the same rows into column shards (Shard(1)) at another world size
    cols = 8 // n
    w = ShardedTensor(paddle.zeros([8, cols]), (8, 8), (0, r * cols))
    sd = {"w": w, "b": paddle.zeros([8]), "step": 0}
    load_state_dict(sd, os.path.join(out, "rows"))
    res["cols"] = w.local.numpy()
    res["b"] = sd["b"].numpy()
    res["step"] = sd["step"]
    # 2-d blocks (a 2 x n/2 mesh, Shard(0) x Shard(1))
    if n >= 2:
        br, bc = 8 // 2, 8 // (n // 2)
        i, j = divmod(r, n // 2)
        blk = ShardedTensor(paddle.zeros([br, bc]), (8, 8), (i * br, j * bc))
        load_state_dict({"w": blk}, os.path.join(out, "rows"))
        res["block"] = blk.local.numpy()
    # the ZeRO-1 state resumed at this world size
    pcfg = TH.ParallelConfig(dp=n, zero1=True, remat=False,
                             param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    params, opt, step = gpt(pcfg)
    load_state_dict({"params": params}, os.path.join(out, "gpt"))
    TH.load_opt_state_shards(params, opt, pcfg, os.path.join(out, "gpt"))
    full = TH.gather_opt_state(params, opt, pcfg)
    res.update({f"m.{k}": v.numpy() for k, v in full["m"]["blocks"].items()})
    res["opt_step"] = opt["step"]
    res["loss3"] = float(step(params, opt, (ids, ids))[2])
np.savez(os.path.join(out, f"{phase}.{n}.{r}.npz"), **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt")
    script = out / "ckpt.py"
    script.write_text(CKPT)
    for world, phase in ((2, "save"), (4, "load"), (1, "load")):
        res = run_workers(script, world, [out, phase], timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]

    def load(phase, n, r):
        with np.load(out / f"{phase}.{n}.{r}.npz") as f:
            return {k: f[k] for k in f.files}
    return out, load


def test_sharded_checkpoint_roundtrip(sharded):
    """Saved as row blocks by 2 ranks; loaded as column blocks by 4 ranks
    and whole by 1: every value lands where it belongs, python values and
    the replicated tensor too."""
    out, load = sharded
    meta = json.loads((out / "rows" / "metadata.json").read_text())
    assert [e["index"] for e in meta["tensors"]["w"]["entries"]] == [
        [[0, 4], [0, 8]], [[4, 8], [0, 8]]]
    W = np.arange(64, dtype=np.float32).reshape(8, 8)
    for n in (4, 1):
        for r in range(n):
            res = load("load", n, r)
            cols = 8 // n
            np.testing.assert_array_equal(res["cols"],
                                          W[:, r * cols:(r + 1) * cols])
            np.testing.assert_array_equal(res["b"], np.ones(8))
            assert int(res["step"]) == 7


def test_checkpoint_reshards_across_mesh_change(sharded):
    """Saved over a 1-d mesh of 2 (rows), loaded into the 2-d blocks of a
    2 x 2 mesh: each rank's block is its 4 x 4 of the tensor."""
    _, load = sharded
    W = np.arange(64, dtype=np.float32).reshape(8, 8)
    for r in range(4):
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(load("load", 4, r)["block"],
                                      W[i * 4:(i + 1) * 4, j * 4:(j + 1) * 4])


def test_zero1_state_resumes_at_another_world_size(sharded):
    """gpt_hybrid's ZeRO-1 moments saved as 2 ranks' flat slices resume at
    dp=4 and dp=1: the gathered moments are the saved ones, and the next
    step's loss is the one the saving job computed."""
    _, load = sharded
    saved = load("save", 2, 0)
    for n in (4, 1):
        for r in range(n):
            got = load("load", n, r)
            assert int(got["opt_step"]) == 2
            for k in saved:
                if k.startswith("m."):
                    np.testing.assert_array_equal(got[k], saved[k])
            np.testing.assert_allclose(float(got["loss3"]),
                                       float(saved["loss3"]), rtol=2e-5)
