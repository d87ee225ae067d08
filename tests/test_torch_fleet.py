"""fleet's data-parallel and sharding surface of the port
(``paddle_tpu_torch.distributed.fleet``) on the CPU.

Bound here: 7 of the 9 tests of the reference's own
``tests/test_fleet_utils.py`` (the design of
``test_torch_training_reference_tests.py``: the file's source with the
other tests blanked and the imports of the ported modules rewritten to
``paddle_tpu_torch``). Restated instead: ``test_namespace_exports``, whose
reference imports ``pp_parallel_adaptor`` and ``sequence_parallel_utils``
(later slices: the restatement checks the rest and that those two raise
naming their slice), and ``test_fused_allreduce_no_implicit_divide``, whose
fake group has no ranks to reduce over (restated on real ranks in
``test_torch_distributed.py``). Also restated: the first three tests of
``tests/test_gradient_merge.py`` (its module imports jax at the top level,
so it cannot be bound).

A worker group at world 4 checks ``fleet.init`` with dp_degree and
sharding_degree, HybridCommunicateGroup's groups, and
``distributed_model`` + ``distributed_optimizer`` (DataParallel over dp,
the stage-1 sharding optimizer over sharding) against the reference's
single-replica AdamW on the global batch (losses rtol 2e-5, atol 2e-6;
parameters 1e-5 of each leaf's scale).
"""
import ast
import json
import os
import re

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
KEEP = (
    "test_local_fs_roundtrip",
    "test_hdfs_client_raises_cleanly_without_hadoop",
    "test_timers",
    "test_log_util_levels",
    "test_fused_allreduce_gradients_single_rank",
    "test_mix_precision_main_grad_accumulation",
    "test_distributed_infer_requires_ps",
)
RESTATED = {
    "test_namespace_exports": "test_torch_fleet.py",
    "test_fused_allreduce_no_implicit_divide": "test_torch_distributed.py",
}
PORTED = ("distributed.fleet", "distributed.fleet.utils",
          "distributed.fleet.utils.fs",
          "distributed.fleet.utils.hybrid_parallel_util",
          "distributed.fleet.utils.mix_precision_utils")
IMPORT = re.compile(r"^(\s*)(from|import)\s+paddle_tpu(\.[\w.]+)?(\s.*)$")
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(paddle_tpu|jax)\b(?!_)")


def _rewrite(line):
    m = IMPORT.match(line)
    if m is None:
        return line
    indent, kind, mod, rest = m.groups()
    if mod is None:
        ok = rest.strip() in ("as paddle", "import nn")
    else:
        ok = mod[1:] in PORTED
    return f"{indent}{kind} paddle_tpu_torch{mod or ''}{rest}" if ok \
        else line


def _port_source(path, keep):
    with open(path) as f:
        src = f.read()
    lines = src.splitlines(keepends=True)
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name.startswith("test") and node.name not in keep:
            first = min([node.lineno] + [d.lineno
                                          for d in node.decorator_list])
            for i in range(first - 1, node.end_lineno):
                lines[i] = "\n"
    lines = [_rewrite(line.rstrip("\n")) + "\n" for line in lines]
    foreign = [line for line in lines if FOREIGN_IMPORT.match(line)]
    assert not foreign, f"{path} still imports {foreign}"
    return "".join(lines)


def _bind():
    path = os.path.join(HERE, "test_fleet_utils.py")
    ns = {"__name__": f"{__name__}.test_fleet_utils", "__file__": path}
    exec(compile(_port_source(path, KEEP), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if k.startswith("test_") and callable(v)}
    clash = set(tests) & set(globals())
    assert not clash, clash
    globals().update(tests)
    return sorted(tests)


N_BOUND = _bind()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield
    # a test that made a process group leaves none for the next file
    tdist.destroy_process_group()
    from paddle_tpu_torch.distributed.fleet.topology import \
        set_hybrid_communicate_group
    set_hybrid_communicate_group(None)


def test_every_fleet_utils_test_is_bound_or_restated():
    with open(os.path.join(HERE, "test_fleet_utils.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    assert N_BOUND == sorted(KEEP)
    assert len(names) == 9 and names == set(KEEP) | set(RESTATED)
    for name, where in RESTATED.items():
        with open(os.path.join(HERE, where)) as f:
            assert name in f.read(), (name, where)


def test_namespace_exports():
    """The reference's test of that name, restated: the same __all__ and
    submodules (sequence_parallel_utils and pp_parallel_adaptor
    re-exported from fleet)."""
    from paddle_tpu_torch.distributed import fleet as fleet_mod
    from paddle_tpu_torch.distributed.fleet import utils as fleet_utils
    assert fleet_utils.__all__ == [
        "LocalFS", "recompute", "DistributedInfer", "HDFSClient"]
    from paddle_tpu_torch.distributed.fleet.utils import (  # noqa: F401
        fs, hybrid_parallel_util, log_util, mix_precision_utils, ps_util,
        sequence_parallel_utils, timer_helper)
    assert sequence_parallel_utils is fleet_mod.sequence_parallel_utils
    assert fleet_utils.pp_parallel_adaptor is fleet_mod.pp_parallel_adaptor


# ------------------------------------- test_gradient_merge.py, restated
def _mlp(seed=0):
    T.seed(seed)
    return T.nn.Sequential(T.nn.Linear(8, 16), T.nn.ReLU(),
                           T.nn.Linear(16, 4))


def test_gradient_merge_matches_big_batch_sgd():
    """k merged microbatch steps == one step on the k-times batch."""
    T.seed(0)
    x = T.randn([16, 8])
    y = T.randn([16, 4])
    loss_fn = T.nn.MSELoss()
    m1 = _mlp()
    opt1 = T.optimizer.GradientMergeOptimizer(
        T.optimizer.SGD(0.1, parameters=m1.parameters()), k_steps=4)
    for i in range(4):
        loss = loss_fn(m1(x[i * 4:(i + 1) * 4]), y[i * 4:(i + 1) * 4])
        loss.backward()
        opt1.step()
        opt1.clear_grad()
    m2 = _mlp()
    opt2 = T.optimizer.SGD(0.1, parameters=m2.parameters())
    loss = loss_fn(m2(x), y)
    loss.backward()
    opt2.step()
    opt2.clear_grad()
    for p1, p2 in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_gradient_merge_inner_not_stepped_midwindow():
    m = _mlp()
    inner = T.optimizer.SGD(0.1, parameters=m.parameters())
    opt = T.optimizer.GradientMergeOptimizer(inner, k_steps=3)
    w0 = m[0].weight.numpy().copy()
    x = T.randn([4, 8])
    for _ in range(2):
        T.mean(m(x)).backward()
        opt.step()
        opt.clear_grad()
        np.testing.assert_array_equal(m[0].weight.numpy(), w0)
    T.mean(m(x)).backward()
    opt.step()
    assert not np.array_equal(m[0].weight.numpy(), w0)


def test_fleet_strategy_gradient_merge_wires_up():
    from paddle_tpu_torch.optimizer.gradient_merge import \
        GradientMergeOptimizer
    strategy = fleet.DistributedStrategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": 2, "avg": True}
    fleet.init(is_collective=True, strategy=strategy)
    m = _mlp()
    opt = fleet.distributed_optimizer(
        T.optimizer.SGD(0.1, parameters=m.parameters()))
    assert isinstance(opt, GradientMergeOptimizer)
    assert opt._k_steps == 2
    assert fleet.worker_num() == 1 and fleet.worker_index() == 0


def test_fleet_refuses_the_degrees_of_later_slices():
    """pp_degree, mp_degree and sep_degree are ported: at world 1 a degree
    of 2 spans more ranks than the job. No slice is left: the parameter
    server's role makers are there, and ``is_collective=False`` without a
    role maker takes the collective path, as the reference's does."""
    for degree in ("pp_degree", "mp_degree", "sep_degree"):
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs[degree] = 2
        with pytest.raises(ValueError, match="spans 2 ranks"):
            fleet.init(is_collective=True, strategy=strategy)
    fleet.init(is_collective=False)
    assert fleet.get_hybrid_communicate_group() is not None
    assert fleet.is_worker() and not fleet.is_server()
    from paddle_tpu_torch.distributed import ps
    assert fleet.PaddleCloudRoleMaker is ps.PaddleCloudRoleMaker
    assert callable(fleet.UtilBase().get_file_shard)
    assert fleet.PipelineLayer is fleet.pp_layers.PipelineLayer


# ---------------------------------------------------------- world 4
WORKER = r'''
import json, os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch import nn
from paddle_tpu_torch.distributed import fleet

out = sys.argv[1]
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1, "pp_degree": 1,
                           "sharding_degree": 2, "sep_degree": 1}
fleet.init(is_collective=True, strategy=strategy)
hcg = fleet.get_hybrid_communicate_group()
r = dist.get_rank()
js = {"degrees": [hcg.get_data_parallel_world_size(),
                  hcg.get_sharding_parallel_world_size(),
                  hcg.get_model_parallel_world_size(),
                  hcg.get_pipe_parallel_world_size()],
      "dp_group": hcg.get_data_parallel_group().ranks,
      "sharding_group": hcg.get_sharding_parallel_group().ranks,
      "mp_group": hcg.get_model_parallel_group().ranks,
      "coords": [hcg.get_data_parallel_rank(),
                 hcg.get_sharding_parallel_rank()],
      "mesh": [dist.get_mesh().shape, dist.get_mesh().dim_names],
      "worker": [fleet.worker_num(), fleet.worker_index()]}
start = dict(np.load(os.path.join(out, "start.npz")))
gx, gy = start.pop("x"), start.pop("y")
model = nn.Sequential(nn.Linear(16, 32), nn.ReLU(), nn.Linear(32, 4))
model.set_state_dict(start)
opt = paddle.optimizer.AdamW(1e-2, parameters=model.parameters())
dmodel = fleet.distributed_model(model)
dopt = fleet.distributed_optimizer(opt)
js["wrapped"] = [type(dmodel).__name__, type(dopt._inner_opt).__name__]
rows = slice(r * 2, r * 2 + 2)
x, y = paddle.to_tensor(gx[rows]), paddle.to_tensor(gy[rows])
losses = []
for _ in range(3):
    loss = nn.CrossEntropyLoss()(dmodel(x), y)
    loss.backward()
    dopt.step()
    dopt.clear_grad()
    g = loss.detach()
    dist.all_reduce(g, dist.ReduceOp.AVG)
    losses.append(float(g))
js["losses"] = losses
js["moment_numel"] = sorted(
    int(t._data.numel()) for k, d in dopt._inner_opt._inner_opt
    ._accumulators.items() if k.startswith("moment1") for t in d.values())
np.savez(os.path.join(out, f"params.{r}.npz"),
         **{k: v.numpy() for k, v in model.state_dict().items()})
with open(os.path.join(out, f"res.{r}.json"), "w") as f:
    json.dump(js, f)
dist.destroy_process_group()
'''


def _reference_model():
    P.seed(0)
    return P.nn.Sequential(P.nn.Linear(16, 32), P.nn.ReLU(),
                           P.nn.Linear(32, 4))


def _batch():
    rng = np.random.RandomState(1)
    return rng.randn(8, 16).astype("float32"), np.arange(8) % 4


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("fleet")
    x, y = _batch()
    np.savez(out / "start.npz", x=x, y=y,
             **{k: v.numpy() for k, v in _reference_model().state_dict()
                .items()})
    script = out / "worker.py"
    script.write_text(WORKER)
    res = run_workers(script, 4, [out], timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = []
    for r in range(4):
        with open(out / f"res.{r}.json") as f:
            js = json.load(f)
        with np.load(out / f"params.{r}.npz") as f:
            got.append((js, {k: f[k] for k in f.files}))
    return got


def test_fleet_init_builds_the_hybrid_groups(world4):
    """dp 2 x sharding 2 (axis order pp, sep, mp, sharding, dp: dp
    innermost): rank = 2 * sharding + dp."""
    for r, (js, _) in enumerate(world4):
        s, d = divmod(r, 2)
        assert js["degrees"] == [2, 2, 1, 1]
        assert js["coords"] == [d, s]
        assert js["dp_group"] == [2 * s, 2 * s + 1]
        assert js["sharding_group"] == [d, d + 2]
        assert js["mp_group"] == [r]
        assert js["mesh"] == [[1, 1, 1, 2, 2],
                              ["pp", "sep", "mp", "sharding", "dp"]]
        assert js["worker"] == [4, r]


def test_distributed_optimizer_matches_reference(world4):
    """DataParallel over dp and the sharding optimizer over sharding give
    the reference's single-replica AdamW on the global batch; each rank
    holds half of each moment (sharding degree 2)."""
    m = _reference_model()
    opt = P.optimizer.AdamW(1e-2, parameters=m.parameters())
    x, y = _batch()
    losses = []
    for _ in range(3):
        loss = P.nn.CrossEntropyLoss()(m(P.to_tensor(x)), P.to_tensor(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    want = {k: v.numpy() for k, v in m.state_dict().items()}
    for js, params in world4:
        assert js["wrapped"] == ["DataParallel", "DygraphShardingOptimizer"]
        np.testing.assert_allclose(js["losses"], losses, rtol=2e-5,
                                   atol=2e-6)
        for k, w in want.items():
            err = float(np.max(np.abs(params[k] - w)))
            assert err <= 1e-5 * float(np.max(np.abs(w))), k
        assert js["moment_numel"] == sorted([16 * 32 // 2, 32 // 2,
                                             32 * 4 // 2, 4 // 2])
