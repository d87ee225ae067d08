"""Group-sharded data parallelism (ZeRO stages 1/2/3) of the port on the CPU
over gloo, against the reference's single-replica AdamW trajectory
(tests/test_group_sharded.py:58's model, batch and optimizer).

One worker group at world 2 and one at world 4 (the port's launcher, each
with its own timeout) run ``group_sharded_parallel`` at each level, every
rank on its rows of the global batch, and record the global loss (the mean
over the ranks), the parameters after the steps, and what each rank holds
of the optimizer states, gradients and parameters. Tolerances: losses rtol
2e-5, atol 2e-6 (the reference test's own bound); parameters 1e-5 of each
leaf's scale.
"""
import json

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HID = 64
STEPS = 4
LEVELS = ("os", "os_g", "p_g_os")
WORLDS = (2, 4)

WORKER = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn

out = sys.argv[1]
dist.init_parallel_env()
r, n = dist.get_rank(), dist.get_world_size()
start = dict(np.load(os.path.join(out, "start.npz")))
gx, gy = start.pop("x"), start.pop("y")
rows = slice(r * len(gx) // n, (r + 1) * len(gx) // n)
x, y = paddle.to_tensor(gx[rows]), paddle.to_tensor(gy[rows])
res, js = {}, {}

def model():
    m = nn.Sequential(nn.Linear(16, HID), nn.ReLU(), nn.Linear(HID, 4))
    m.set_state_dict(dict(start))
    return m

for level, with_scaler in [(lv, False) for lv in LEVELS] + [("os_g", True)]:
    name = level + ("_scaler" if with_scaler else "")
    inner = model()
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=inner.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 8) \
        if with_scaler else None
    m, o, s = dist.group_sharded_parallel(inner, opt, level, scaler=scaler)
    losses = []
    for step in range(STEPS):
        loss = nn.CrossEntropyLoss()(m(x), y)
        if s is not None:
            s.scale(loss).backward()
            s.step(o)
            s.update()
        else:
            loss.backward()
            if step == 0:
                js[f"{name}.grads"] = [
                    [p.grad is None for p in inner.parameters()],
                    [None if sh.shadow.grad is None
                     else int(sh.shadow.grad._data.numel())
                     for sh in o._shards]]
            o.step()
        o.clear_grad()
        g = loss.detach()
        dist.all_reduce(g, dist.ReduceOp.AVG)
        losses.append(float(g))
    res[f"{name}.loss"] = np.asarray(losses)
    js[f"{name}.param_numel"] = [int(p._data.numel())
                                 for p in inner.parameters()]
    js[f"{name}.moment_numel"] = [
        int(t._data.numel())
        for key, d in o._inner_opt._accumulators.items()
        if key.startswith("moment1") for t in d.values()]
    for k, v in m.state_dict().items():
        res[f"{name}.param.{k}"] = v.numpy()
    if level == "p_g_os" and not with_scaler:
        dist.save_group_sharded_model(m, os.path.join(out, f"saved{n}"),
                                      optimizer=o)
        res["saved_out"] = m(paddle.to_tensor(gx)).numpy()
np.savez(os.path.join(out, f"res.{n}.{r}.npz"), **res)
with open(os.path.join(out, f"res.{n}.{r}.json"), "w") as f:
    json.dump(js, f)
dist.destroy_process_group()
'''.replace("HID", str(HID)).replace("LEVELS", repr(LEVELS)).replace(
    "STEPS", str(STEPS))


def _reference_model(seed=0):
    P.seed(seed)
    return P.nn.Sequential(P.nn.Linear(16, HID), P.nn.ReLU(),
                           P.nn.Linear(HID, 4))


def _batch():
    rng = np.random.RandomState(0)
    return rng.randn(8, 16).astype("float32"), np.arange(8) % 4


def _baseline():
    """The reference test's _baseline: plain single-replica AdamW."""
    m = _reference_model()
    opt = P.optimizer.AdamW(learning_rate=1e-2, parameters=m.parameters())
    x, y = _batch()
    x, y = P.to_tensor(x), P.to_tensor(y)
    losses = []
    for _ in range(STEPS):
        loss = P.nn.CrossEntropyLoss()(m(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses, {k: v.numpy() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("gs")
    x, y = _batch()
    np.savez(out / "start.npz", x=x, y=y,
             **{k: v.numpy() for k, v in _reference_model().state_dict()
                .items()})
    script = out / "worker.py"
    script.write_text(WORKER)
    for world in WORLDS:
        res = run_workers(script, world, [out], timeout=120)
        assert res.returncode == 0, res.stderr[-3000:]
    got = {"dir": out}
    for world in WORLDS:
        for r in range(world):
            with np.load(out / f"res.{world}.{r}.npz") as f:
                arrays = {k: f[k] for k in f.files}
            with open(out / f"res.{world}.{r}.json") as f:
                got[world, r] = (arrays, json.load(f))
    return got


def _close(got, want, what):
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want))) or 1.0
    assert err <= 1e-5 * scale, f"{what}: {err} > 1e-5 * {scale}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("level", list(LEVELS) + ["os_g_scaler"])
def test_group_sharded_loss_parity(results, level, world):
    losses, params = _baseline()
    for r in range(world):
        a, _ = results[world, r]
        np.testing.assert_allclose(a[f"{level}.loss"], losses, rtol=2e-5,
                                   atol=2e-6)
        for k, v in params.items():
            _close(a[f"{level}.param.{k}"], v, f"{level} {k}")


def _sizes():
    return [16 * HID, HID, HID * 4, 4]


@pytest.mark.parametrize("world", WORLDS)
def test_stage1_each_rank_holds_one_nth_of_the_optimizer_states(results,
                                                                world):
    for r in range(world):
        _, js = results[world, r]
        for level in LEVELS:
            assert js[f"{level}.moment_numel"] == [
                -(-n // world) for n in _sizes()], level


@pytest.mark.parametrize("world", WORLDS)
def test_stage2_each_rank_holds_one_nth_of_the_gradients(results, world):
    """After a backward at os_g every full gradient is freed and each slice
    holds ceil(n / N) elements; at os the full gradients stay until the
    step reduce-scatters them."""
    for r in range(world):
        _, js = results[world, r]
        freed, slices = js["os_g.grads"]
        assert all(freed)
        assert slices == [-(-n // world) for n in _sizes()]
        freed, slices = js["os.grads"]
        assert not any(freed) and slices == [None] * 4


@pytest.mark.parametrize("world", WORLDS)
def test_stage3_parameters_are_freed_between_steps(results, world):
    """p_g_os frees each parameter once its gradient is reduced (the
    forward all-gathers them again); stages 1 and 2 keep them whole."""
    for r in range(world):
        _, js = results[world, r]
        assert js["p_g_os.param_numel"] == [0, 0, 0, 0]
        assert js["os_g.param_numel"] == js["os.param_numel"] == _sizes()


def test_save_group_sharded_model_round_trips(results):
    """save_group_sharded_model writes the whole model (rank 0) and each
    rank's optimizer slices; a fresh model loads it and computes what the
    sharded model computed."""
    out = results["dir"] / "saved2"
    files = sorted(p.name for p in out.iterdir())
    assert files == ["model.1.pdopt", "model.pdmodel", "model.pdopt"]
    T.set_device("cpu")
    T.seed(123)
    fresh = T.nn.Sequential(T.nn.Linear(16, HID), T.nn.ReLU(),
                            T.nn.Linear(HID, 4))
    fresh.set_state_dict(T.load(str(out / "model.pdmodel")))
    x, _ = _batch()
    a, _ = results[2, 0]
    np.testing.assert_allclose(fresh(T.to_tensor(x)).numpy(),
                               a["saved_out"], rtol=1e-5, atol=1e-6)
    opt0 = T.load(str(out / "model.pdopt"))
    assert opt0["moment1_0"].shape == [-(-16 * HID // 2)]
