"""Fleet's pipeline surface: ``PipelineLayer``'s segmentation,
``PipelineParallel.train_batch`` at pp_degree 2 over two gloo ranks in each
schedule_mode against the reference's single-device oracle
(``tests/test_fleet_pipeline_parallel.py:67-104``), the mode guards and the
pass-through of a chain the pipeline cannot split, and the checkpoint
layout converter (``pp_parallel_adaptor``) against the reference's.

Both sides start from the reference's initial parameters (its state_dict,
loaded by name into the port's chain). Tolerances: the losses rtol 1e-4
(the reference test's), the parameters after three SGD steps within 1e-5
of each one's scale.
"""
import json

import numpy as np
import pytest

import paddle_tpu as rpaddle
from paddle_tpu import nn as rnn
from paddle_tpu.distributed.fleet import pp_parallel_adaptor as RA
from paddle_tpu.distributed.fleet.pp_layers import LayerDesc as RLayerDesc
from paddle_tpu.distributed.fleet.pp_layers import \
    PipelineLayer as RPipelineLayer
from paddle_tpu_torch._testing import run_workers
from paddle_tpu_torch.distributed.fleet import pp_layers as TL
from paddle_tpu_torch.distributed.fleet import pp_parallel_adaptor as TA
import paddle_tpu_torch as tpaddle
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

MODES = ("1F1B", "ZBH1", "ZBV")
STEPS = 3

WORKER = r'''
import json, os, sys, warnings
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import paddle_tpu_torch as paddle
from paddle_tpu_torch import nn
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch.distributed.fleet.pp_layers import (LayerDesc,
                                                          PipelineLayer)
from paddle_tpu_torch.distributed.fleet.meta_parallel import \
    PipelineParallel

out = sys.argv[1]
h = 16
with np.load(os.path.join(out, "start.npz")) as f:
    start = {k: f[k] for k in f.files}


class Block(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(h, h)

    def forward(self, x):
        return paddle.tanh(self.fc(x)) + x


def chain():
    descs = [LayerDesc(nn.Linear, 8, h)] \
        + [LayerDesc(Block) for _ in range(4)] \
        + [LayerDesc(nn.Linear, h, 4)]
    model = PipelineLayer(descs, num_stages=2, loss_fn=nn.CrossEntropyLoss())
    model.set_state_dict({k: paddle.to_tensor(v) for k, v in start.items()})
    return model


def init(mode, acc=4):
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2, "sharding_degree": 1}
    strategy.pipeline = True
    strategy.pipeline_configs = {"accumulate_steps": acc,
                                 "micro_batch_size": 2,
                                 "schedule_mode": mode}
    fleet.init(is_collective=True, strategy=strategy)


rng = np.random.RandomState(0)
x = paddle.to_tensor(rng.randn(8, 8).astype("f4"))
y = paddle.to_tensor(rng.randint(0, 4, (8,)))
res = {}
for mode in ("1F1B", "ZBH1", "ZBV"):
    init(mode)
    model = fleet.distributed_model(chain())
    assert isinstance(model, PipelineParallel)
    opt = paddle.optimizer.SGD(0.05, parameters=model.parameters())
    losses = [float(model.train_batch((x, y), opt)) for _ in range(3)]
    res[mode] = {"schedule": model.pp_schedule, "losses": losses,
                 "params": {k: v.numpy().tolist()
                            for k, v in model._layers.state_dict().items()}}
# the guards: FThenB wraps, runs forward, and refuses train_batch
init("FThenB")
wrapped = fleet.distributed_model(chain())
fwd = list(wrapped(paddle.to_tensor(np.zeros((4, 8), "f4"))).shape)
errs = []
for _ in range(2):
    try:
        wrapped.train_batch((x, y), optimizer=None)
    except ValueError as e:
        errs.append(str(e))
res["guard"] = {"forward_shape": fwd, "errors": errs,
                "schedule": wrapped.pp_schedule,
                "state_dict": len(wrapped.state_dict())}
# a chain without a homogeneous block run passes through with a warning
init("1F1B")
paddle.seed(0)
het = PipelineLayer([LayerDesc(nn.Linear, 8, 12), LayerDesc(nn.Linear, 12, 6),
                     LayerDesc(nn.Linear, 6, 4)], num_stages=2,
                    loss_fn=nn.CrossEntropyLoss())
with warnings.catch_warnings(record=True) as rec:
    warnings.simplefilter("always")
    plain = fleet.distributed_model(het)
res["passthrough"] = {
    "warned": any("PipelineParallel unavailable" in str(r.message)
                  for r in rec),
    "wrapped": type(plain).__name__,
    "shape": list(plain(paddle.randn([4, 8])).shape)}
hcg = fleet.get_hybrid_communicate_group()
res["stage"] = [hcg.get_stage_id(), hcg.is_first_stage(),
                hcg.is_last_stage(), hcg.get_pipe_parallel_group().nranks]
with open(os.path.join(out, f"fleet.{dist.get_rank()}.json"), "w") as f:
    json.dump(res, f)
dist.destroy_process_group()
'''


def _reference_chain(h=16, n_blocks=4, seed=3):
    """tests/test_fleet_pipeline_parallel.py's chain."""
    rpaddle.seed(seed)

    class Block(rnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = rnn.Linear(h, h)

        def forward(self, x):
            return rpaddle.tanh(self.fc(x)) + x

    descs = [RLayerDesc(rnn.Linear, 8, h)] \
        + [RLayerDesc(Block) for _ in range(n_blocks)] \
        + [RLayerDesc(rnn.Linear, h, 4)]
    return RPipelineLayer(descs, num_stages=2,
                          loss_fn=rnn.CrossEntropyLoss())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's two ranks (every schedule_mode, the guards), and the
    reference's oracle: the same chain trained on one device."""
    out = tmp_path_factory.mktemp("fleet_pp")
    oracle = _reference_chain()
    np.savez(out / "start.npz", **{k: np.asarray(v.numpy()) for k, v in
                                   oracle.state_dict().items()})
    script = out / "worker.py"
    script.write_text(WORKER)
    res = run_workers(script, 2, [out], timeout=150)
    assert res.returncode == 0, res.stderr[-3000:]
    opt = rpaddle.optimizer.SGD(0.05, parameters=oracle.parameters())
    ce = rnn.CrossEntropyLoss()
    rng = np.random.RandomState(0)
    x = rpaddle.to_tensor(rng.randn(8, 8).astype("f4"))
    y = rpaddle.to_tensor(rng.randint(0, 4, (8,)))
    want = []
    for _ in range(STEPS):
        loss = ce(oracle(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        want.append(float(loss))
    params = {k: np.asarray(v.numpy()) for k, v in
              oracle.state_dict().items()}
    ranks = [json.loads((out / f"fleet.{r}.json").read_text())
             for r in range(2)]
    return ranks, want, params


@pytest.mark.parametrize("mode", MODES)
def test_train_batch_matches_oracle(runs, mode):
    """train_batch at pp_degree 2 in each schedule_mode: the losses of both
    ranks and the parameters after three SGD steps equal the reference's
    single-device oracle's."""
    ranks, want, params = runs
    assert ranks[0][mode]["schedule"] == {"1F1B": "1f1b", "ZBH1": "zbh1",
                                          "ZBV": "zbvpp"}[mode]
    for r in ranks:
        np.testing.assert_allclose(r[mode]["losses"], want, rtol=1e-4)
        got = r[mode]["params"]
        assert set(got) == set(params)
        for k, w in params.items():
            err = float(np.max(np.abs(np.asarray(got[k]) - w)))
            assert err <= 1e-5 * float(np.max(np.abs(w))), (mode, k, err)
    assert ranks[0][mode]["losses"][-1] < ranks[0][mode]["losses"][0]


def test_schedule_mode_guards(runs):
    """FThenB: the wrap works as a facade (forward, state_dict) and every
    train_batch raises, naming the supported modes; a chain without a
    homogeneous block run passes through with a warning; the ranks hold
    their stage of the pipe group."""
    ranks, _, _ = runs
    for r, rank in enumerate(ranks):
        g = rank["guard"]
        assert g["forward_shape"] == [4, 4] and g["schedule"] is None
        assert g["state_dict"] > 0
        assert len(g["errors"]) == 2
        for mode in ("schedule_mode", "1F1B", "ZBH1", "ZBVPP"):
            assert mode in g["errors"][0], g["errors"][0]
        p = rank["passthrough"]
        assert p["warned"] and p["wrapped"] == "PipelineLayer"
        assert p["shape"] == [4, 4]
        assert rank["stage"] == [r, r == 0, r == 1, 2]


@pytest.mark.parametrize("n,stages", [(6, 2), (7, 3), (10, 4), (3, 1)])
def test_pipeline_layer_segmentation_matches_reference(n, stages):
    """Uniform segmentation: the stage bounds and get_stage_from_index
    equal the reference's."""
    rpaddle.seed(0)
    ref = RPipelineLayer([RLayerDesc(rnn.Linear, 4, 4) for _ in range(n)],
                         num_stages=stages)
    tpaddle.set_device("cpu")
    got = TL.PipelineLayer([TL.LayerDesc(tpaddle.nn.Linear, 4, 4)
                            for _ in range(n)], num_stages=stages)
    assert got._stage_bounds == ref._stage_bounds
    assert [got.get_stage_from_index(i) for i in range(n + 1)] == \
        [ref.get_stage_from_index(i) for i in range(n + 1)]
    assert len(got.run_function) == n


def test_pipeline_layer_shared_desc_and_loss():
    """A SharedLayerDesc builds its layer once for every entry with its key
    (with its forward_func), and loss() refuses without a loss_fn."""
    tpaddle.set_device("cpu")
    emb = TL.SharedLayerDesc("embed", tpaddle.nn.Linear, None, "weight", 4, 4)
    head = TL.SharedLayerDesc("embed", tpaddle.nn.Linear,
                              lambda layer, x: x @ layer.weight.T, "weight",
                              4, 4)
    model = TL.PipelineLayer([emb, head], num_stages=2)
    assert model.run_function[1].inner is model.run_function[0]
    assert tuple(model(tpaddle.randn([2, 4])).shape) == (2, 4)
    with pytest.raises(RuntimeError, match="no loss_fn"):
        model.loss(None, None)
    with pytest.raises(TypeError, match="Layer subclass"):
        TL.LayerDesc(int)


def _stage_dicts(num_layers, cfg, with_shared=True):
    dicts = []
    for s, layer_ids in enumerate(cfg.stage_chunks(num_layers)):
        d = {}
        for local, g in enumerate(layer_ids):
            d[f"layers.{local}.w"] = np.full((2,), float(g))
            d[f"layers.{local}.b"] = np.full((2,), 100.0 + g)
        if with_shared and s == 0:
            d["shared_embed.weight"] = np.arange(4.0)
        dicts.append(d)
    return dicts


@pytest.mark.parametrize("src_pp,src_vpp,dst_pp,dst_vpp", [
    (2, 1, 4, 1), (4, 1, 2, 1), (2, 2, 4, 1), (1, 1, 2, 2)])
def test_convert_pp_state_dicts_matches_reference(src_pp, src_vpp, dst_pp,
                                                  dst_vpp):
    """convert_pp_state_dicts (the cases of tests/test_pp_adaptor.py):
    the port's converted dicts equal the reference's, key by key, and a
    round trip back to the source layout gives the source dicts."""
    L = 8
    src, dst = TA.ParallelConfig(src_pp, src_vpp), TA.ParallelConfig(
        dst_pp, dst_vpp)
    rsrc, rdst = RA.ParallelConfig(src_pp, src_vpp), RA.ParallelConfig(
        dst_pp, dst_vpp)
    dicts = _stage_dicts(L, src)
    got = TA.convert_pp_state_dicts(dicts, src, dst)
    want = RA.convert_pp_state_dicts(dicts, rsrc, rdst)
    assert len(got) == len(want) == dst_pp
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    back = TA.convert_pp_state_dicts(got, dst, src)
    for b, d in zip(back, dicts):
        assert set(b) >= set(d)
        for k in d:
            np.testing.assert_array_equal(b[k], d[k])
    assert src.stage_chunks(L) == rsrc.stage_chunks(L)


def test_adaptor_class_and_refusals():
    """PipeLineModelAdaptor applies and peeks as the reference's; a wrong
    number of stage dicts and a bad layout raise."""
    src, dst = TA.ParallelConfig(2), TA.ParallelConfig(4)
    ad = TA.PipeLineModelAdaptor(src, dst)
    dicts = _stage_dicts(8, src, with_shared=False)
    assert ad.peek_model(dicts) == RA.PipeLineModelAdaptor(
        RA.ParallelConfig(2), RA.ParallelConfig(4)).peek_model(dicts)
    with pytest.raises(ValueError):
        TA.convert_pp_state_dicts([{}, {}], TA.ParallelConfig(3),
                                  TA.ParallelConfig(2))
    with pytest.raises(ValueError):
        TA.ParallelConfig(0)
    with pytest.raises(ValueError, match="not divisible"):
        TA.ParallelConfig(3).stage_chunks(8)
