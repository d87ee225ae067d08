"""The semi-auto parallel API, ``annotate_tp``, ``DistModel`` and the
``Engine`` of the port against the reference.

Four gloo ranks (one worker group, ``_testing.auto_parallel_worker``) run the
cases of the reference's test_distributed.py and test_reshard_matrix.py on
meshes of the reference's shapes cut to four ranks ([4], [2, 2], [2] -> [4]),
while the reference lays the same arrays out on four virtual CPU devices:
each rank's local piece equals the reference's shard on the device of that
rank's id, and the global value (``numpy()``, ``unshard_dtensor``) is the
array itself. The reference is one controller and the port SPMD, so
``dtensor_from_local`` differs by design: each rank gives its own piece
(checked against the global array it assembles to). The same group runs
``annotate_tp`` on a (dp, mp) = (2, 2) mesh (the forward and the gradients
against the unsharded model, the count of sharded parameters against the
reference's on the same model) and the Engine's and DistModel's
data-parallel steps against plain steps on the whole batch. In process at
world 1: DistModel and ``Engine.fit`` on the tiny Layer GPT against the eager
steps, and the Engine's planning and bookkeeping as the reference's
test_auto_engine.py drives them. Tolerances: values exact (layouts move
data), sharded math 1e-4 relative (test_distributed.py's), losses 1e-6
relative.
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

WORLD = 4
DATA = np.arange(64, dtype=np.float32).reshape(8, 8)
WORKER = ("from paddle_tpu_torch._testing import auto_parallel_worker\n"
          "import sys\n"
          "auto_parallel_worker(sys.argv[1])\n")
# case -> (placements as the worker writes them)
LAYOUTS = {"shard_2x2": "S0,S1", "s0": "S0", "s0_to_r": "R",
           "r_to_s1": "S1", "r_to_s0": "S0", "s0_to_s1": "S1",
           "nd": "S0,R", "nd_flipped": "R,S1", "cross_mesh": "S1"}


def _jax_cases():
    """The reference's distributed tensors for each case, on 4 devices."""
    jd = jdist
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    mesh4 = jd.ProcessMesh(shape=[4], dim_names=["x"])
    mesh22 = jd.ProcessMesh(shape=[2, 2], dim_names=["dp", "mp"])
    t = jpaddle.to_tensor
    d = jd.shard_tensor(t(DATA), mesh4, [jd.Shard(0)])
    r = jd.reshard(d, mesh4, [jd.Replicate()])
    nd = jd.shard_tensor(t(DATA), mesh22, [jd.Shard(0), jd.Replicate()])
    mesh_a = jd.ProcessMesh(shape=[2], dim_names=["x"])
    mesh_b = jd.ProcessMesh(shape=[4], dim_names=["y"])
    return {
        "shard_2x2": (x, jd.shard_tensor(t(x), mesh22,
                                         [jd.Shard(0), jd.Shard(1)])),
        "s0": (DATA, d), "s0_to_r": (DATA, r),
        "r_to_s1": (DATA, jd.reshard(r, mesh4, [jd.Shard(1)])),
        "r_to_s0": (DATA, jd.reshard(jd.shard_tensor(
            t(DATA), mesh4, [jd.Replicate()]), mesh4, [jd.Shard(0)])),
        "s0_to_s1": (DATA, jd.reshard(d, mesh4, [jd.Shard(1)])),
        "nd": (DATA, nd),
        "nd_flipped": (DATA, jd.reshard(nd, mesh22,
                                        [jd.Replicate(), jd.Shard(1)])),
        "cross_mesh": (DATA, jd.reshard(jd.shard_tensor(
            t(DATA), mesh_a, [jd.Shard(0)]), mesh_b, [jd.Shard(1)])),
    }


def _placements(t):
    return ",".join(f"S{p.get_dim()}" if p.is_shard() else "R"
                    for p in t.placements)


def _shards(t):
    """{device id: the reference's shard on it}."""
    return {s.device.id: np.asarray(s.data)
            for s in t._data.addressable_shards}


def _annotated_by_reference():
    """The reference's annotate_tp count on the worker's model, mp = 2."""
    from paddle_tpu.distributed.auto_parallel.partitioner import annotate_tp
    from jax.sharding import Mesh
    nn = jpaddle.nn
    model = nn.Sequential(nn.Embedding(64, 16), nn.Linear(16, 32),
                          nn.ReLU(), nn.Linear(32, 5))
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "mp"))
    return annotate_tp(model, mesh, "mp")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, and the reference's for the same cases."""
    out = tmp_path_factory.mktemp("auto4")
    script = out / "worker.py"
    script.write_text(WORKER)
    res = run_workers(script, WORLD, [out], timeout=150)
    assert res.returncode == 0, res.stderr[-3000:]
    got = []
    for r in range(WORLD):
        with np.load(out / f"auto.{r}.npz") as f:
            got.append({k: f[k] for k in f.files})
    ref = {k: (v, _placements(t), _shards(t))
           for k, (v, t) in _jax_cases().items()}
    ref["annotated"] = _annotated_by_reference()
    return got, ref


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_matches_reference(ranks, case):
    """shard_tensor / reshard: each rank's piece is the reference's shard on
    its device, the global value the array, the placements the reference's
    (test_distributed.py::test_mesh_and_shard_tensor, test_reshard;
    test_reshard_matrix.py's r_to_s, s_to_r, s_to_s_dim_swap,
    nd_mesh_mixed_placements, cross_mesh)."""
    got, ref = ranks
    value, placements, shards = ref[case]
    assert placements == LAYOUTS[case]
    for r, res in enumerate(got):
        assert str(res[f"{case}.placements"]) == placements
        np.testing.assert_array_equal(res[f"{case}.global"], value)
        np.testing.assert_array_equal(res[f"{case}.local"], shards[r])


def test_cross_mesh_lands_on_the_target_mesh(ranks):
    for res in ranks[0]:
        assert res["cross_mesh.mesh_shape"].tolist() == [4]


def test_unshard_and_from_local_give_the_global_value(ranks):
    """unshard_dtensor is the whole array on every rank; dtensor_from_local
    takes each rank's two rows (the reference's SPMD semantics) and
    assembles the array."""
    for res in ranks[0]:
        np.testing.assert_array_equal(res["unshard.global"], DATA)
        np.testing.assert_array_equal(res["unshard.local"], DATA)
        np.testing.assert_array_equal(res["from_local.global"], DATA)
        assert str(res["from_local.placements"]) == "S0"


def test_sharded_math_matches_dense(ranks):
    """test_distributed.py::test_sharded_math_matches_dense: a contraction
    over the sharded dim (Shard(1) @ Shard(0), a pending sum) equals the
    dense product."""
    rng = np.random.RandomState(0)
    a = rng.randn(16, 32).astype(np.float32)
    b = rng.randn(32, 8).astype(np.float32)
    for res in ranks[0]:
        np.testing.assert_allclose(res["matmul.global"], a @ b, rtol=1e-4,
                                   atol=1e-5)


def test_partial_grad_and_amp(ranks):
    """test_reshard_matrix.py: Partial is refused by shard_tensor; the
    gradient flows back through reshard to the global value (2 everywhere,
    on every rank); shard/reshard keep float32 under AMP O2."""
    for res in ranks[0]:
        assert bool(res["partial_refused"])
        np.testing.assert_array_equal(res["grad"], np.full_like(DATA, 2.0))
        assert res["amp_dtypes"].tolist() == ["float32"] * 3


def test_annotate_tp_matches_unsharded(ranks):
    """annotate_tp at mp = 2 on an Embedding, a column-parallel and a
    row-parallel Linear: the forward and every parameter's gradient (this
    rank's slice of the sharded ones) equal the unsharded model's, and as
    many parameters are sharded as the reference annotates."""
    got, ref = ranks
    for res in got:
        assert int(res["tp.annotated"]) == ref["annotated"] == 4
        assert float(res["tp.out_err"]) <= 1e-5
        assert float(res["tp.grad_err"]) <= 1e-5


@pytest.mark.parametrize("name", ["engine.dp4", "engine.dp4_zero1",
                                  "engine.dp2_tp2", "distmodel.dp4_zero1",
                                  "distmodel.mp2"])
def test_data_parallel_steps_match_plain_steps(ranks, name):
    """The Engine's dp4 plan (with and without ZeRO-1), its dp2 x tp2 plan
    (annotate_tp), DistModel over shard_dataloader with ShardingStage1, and
    DistModel over parameters sharded on mp (the layer on DTensors): three
    steps' losses equal plain AdamW steps on the whole batch, on every
    rank."""
    for res in ranks[0]:
        np.testing.assert_allclose(res[name], res["plain"], rtol=1e-6)


def test_engine_plans_data_parallel_for_a_plain_mlp(ranks):
    for res in ranks[0]:
        assert str(res["engine.auto_plan"]) == "dp4xtp1xpp1+zero1+noremat"


# ------------------------------------------------------------ world 1
@pytest.fixture
def world1():
    from paddle_tpu_torch._testing import force_cpu
    import paddle_tpu_torch.distributed as dist
    force_cpu()
    dist.init_parallel_env()
    yield dist
    dist.destroy_process_group()


def _lm_loss(paddle, vocab):
    def loss(logits, labels):
        return paddle.nn.functional.cross_entropy(
            logits[:, :-1].reshape([-1, vocab]), labels[:, 1:].reshape([-1]))
    return loss


def _gpt(paddle):
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    paddle.seed(0)
    cfg = GPTConfig.tiny()
    model = GPTForCausalLM(cfg)
    opt = paddle.optimizer.AdamW(1e-3, parameters=model.parameters())
    return cfg, model, opt


def _eager_losses(paddle, ids, steps):
    cfg, model, opt = _gpt(paddle)
    loss_fn = _lm_loss(paddle, cfg.vocab_size)
    out = []
    for _ in range(steps):
        loss = loss_fn(model(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


def test_distmodel_matches_eager_steps_at_world_1(world1):
    """shard_tensor (Replicate at world 1) over every parameter, then
    to_static -> DistModel: three steps' losses equal the eager Layer GPT's
    on the same parameters and batch."""
    import paddle_tpu_torch as paddle
    dist = world1
    ids = paddle.to_tensor(np.random.RandomState(0).randint(0, 256, (4, 32)))
    want = _eager_losses(paddle, ids, 3)
    cfg, model, opt = _gpt(paddle)
    mesh = dist.ProcessMesh([0], dim_names=["dp"])
    for p in model.parameters():
        dist.shard_tensor(p, mesh, [dist.Replicate()])
    assert all(p.placements == [dist.Replicate()]
               for p in model.parameters())
    dm = dist.to_static(model, None, _lm_loss(paddle, cfg.vocab_size),
                        dist.shard_optimizer(opt))
    got = [float(dm(ids, ids)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    dm.eval()
    assert np.isfinite(float(dm(ids, ids)))
    dm.predict()
    assert dm(ids).shape == [4, 32, cfg.vocab_size]
    scaler = dist.shard_scaler(paddle.amp.GradScaler(init_loss_scaling=4.0))
    assert float(scaler.scale(paddle.to_tensor(1.0))) == 4.0


def test_engine_fit_matches_eager_steps_at_world_1(world1, tmp_path):
    """Engine.fit at world 1 (the planner's dp1 plan): one epoch of three
    batches' losses equal the eager steps'; evaluate, predict, save and
    load work on the result."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    ids = np.random.RandomState(0).randint(0, 256, (4, 32))
    want = _eager_losses(paddle, paddle.to_tensor(ids), 3)
    cfg, model, opt = _gpt(paddle)
    engine = Engine(model, _lm_loss(paddle, cfg.vocab_size), opt)
    got = []
    engine.prepare(global_batch=4)
    assert engine._plan.short().startswith("dp1xtp1xpp1")
    for _ in range(3):
        got.append(float(engine._step(engine._rows(ids), engine._rows(ids))))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    hist = engine.fit([(ids, ids)] * 2, epochs=2, batch_size=4,
                      valid_data=[(ids, ids)])
    assert len(hist) == 2 and hist[1]["loss"] < hist[0]["loss"]
    assert np.isfinite(hist[1]["eval_loss"])
    assert engine.predict([ids], batch_size=4)[0].shape == [4, 32, 256]
    engine.save(str(tmp_path / "e.pd"))
    before = float(engine.evaluate([(ids, ids)]))
    engine.fit([(ids, ids)], epochs=1, batch_size=4)
    engine.load(str(tmp_path / "e.pd"))
    assert float(engine.evaluate([(ids, ids)])) == pytest.approx(before)


def _mlp_engine():
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    paddle.seed(11)
    nn = paddle.nn
    model = nn.Sequential(nn.Linear(16, 64), nn.ReLU(), nn.Linear(64, 4))
    opt = paddle.optimizer.AdamW(3e-3, parameters=model.parameters())
    return Engine(model=model, loss=nn.CrossEntropyLoss(), optimizer=opt)


def test_fleet_auto_namespace():
    """test_auto_engine.py::test_fleet_auto_namespace."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    assert fleet.auto.Engine is Engine
    assert hasattr(fleet.auto, "shard_tensor")
    assert hasattr(fleet.auto, "Planner")


def test_plan_and_cost():
    """test_auto_engine.py::test_plan_and_cost on 8 H100s: a block-less
    model plans data parallelism only."""
    e = _mlp_engine()
    best = e.plan(n_chips=8, global_batch=32)[0]
    assert best.dp * best.tp * best.pp == 8
    assert best.tp == 1 and best.pp == 1
    t, mem = e.cost(n_chips=8, global_batch=32)
    assert t > 0 and mem > 0


def test_engine_plan_searches_full_family_for_block_models():
    """test_auto_engine.py's, on the port's tiny Llama (a homogeneous
    block chain): the search includes model-parallel families, or plans
    pure data parallelism throughout."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny())
    eng = Engine(model=m, loss=paddle.nn.CrossEntropyLoss(),
                 optimizer=paddle.optimizer.SGD(
                     0.1, parameters=m.parameters()))
    assert len(eng._pipeline_blocks()) == LlamaConfig.tiny().num_layers
    plans = eng.plan(n_chips=8, global_batch=8, top_k=8)
    assert plans
    assert any(p.tp > 1 or p.pp > 1 for p in plans) or \
        all(p.dp == 8 for p in plans)
    assert all(p.pp == 1 for p in _mlp_engine().plan(n_chips=8,
                                                     global_batch=32))


def test_engine_pp_raises_clearly_without_blocks():
    """test_auto_engine.py's: a pp plan on a model without a block chain is
    refused, naming the contract."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.distributed.planner import PlanCandidate
    m = paddle.nn.Linear(4, 4)
    eng = Engine(model=m, loss=paddle.nn.MSELoss(),
                 optimizer=paddle.optimizer.SGD(
                     0.1, parameters=m.parameters()))
    with pytest.raises(NotImplementedError, match="block chain"):
        eng.prepare(global_batch=4, plan=PlanCandidate(dp=1, tp=1, pp=2))


def test_auto_parallel_names():
    """auto_parallel's __all__ is the reference's, and none of the
    distributed names waits for a later slice any more."""
    import paddle_tpu.distributed.auto_parallel as jap
    import paddle_tpu_torch.distributed as dist
    import paddle_tpu_torch.distributed.auto_parallel as ap
    assert ap.__all__ == jap.__all__
    for name in ap.__all__:
        assert getattr(ap, name) is not None
    for name in ("shard_tensor", "reshard", "shard_layer", "shard_optimizer",
                 "ShardingStage1", "ShardingStage2", "ShardingStage3",
                 "shard_dataloader", "shard_scaler", "unshard_dtensor",
                 "dtensor_from_fn", "dtensor_from_local", "Strategy",
                 "DistModel", "DistAttr", "to_static", "utils", "planner",
                 "auto_tuner"):
        assert name in vars(dist)     # a ported name, not a stub
        assert getattr(dist, name) is not None
