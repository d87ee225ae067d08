"""The Layer models' tensor-parallel branches (``LlamaConfig`` and
``GPTConfig`` with ``use_tensor_parallel=True``), ``DistributedInfer``'s
client and ``static.xpu_places``, against the reference's.

One worker group of 2 gloo ranks (the port's launcher) runs the tiny Llama
(GQA: 4 query heads over 2 kv heads) and the tiny GPT with
``fleet.init(mp_degree=2)``: each rank holds its shards, set from global
weights made here from numpy seeds, and writes its logits, its loss and
every parameter's gradient gathered into the global layout. The reference
runs the same models over an "mp" mesh of 2 virtual CPU devices with the
same weights and ids. f32; tolerances: 1e-5 of each value's scale; the
greedy ids through the ``StaticCache`` exactly.
"""
import os
import threading

import numpy as np
import pytest

from paddle_tpu_torch._testing import (numpy_initializers, run_workers,
                                       share_the_cores_fixture)

_share_the_cores = share_the_cores_fixture()

MP = 2
IDS = np.random.RandomState(7).randint(0, 256, (2, 16))
PROMPT, NEW_TOKENS = IDS[:, :6], 6

WORKER = r'''
import os, sys
import numpy as np
from paddle_tpu_torch._testing import force_cpu
force_cpu()
import paddle_tpu_torch as paddle
import paddle_tpu_torch.distributed as dist
import paddle_tpu_torch.distributed.fleet as fleet
from paddle_tpu_torch.distributed.fleet import mp_layers
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

out = sys.argv[1]
dist.init_parallel_env()
n, r = dist.get_world_size(), dist.get_rank()
strategy = fleet.DistributedStrategy()
strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": n, "pp_degree": 1,
                           "sharding_degree": 1}
fleet.init(is_collective=True, strategy=strategy)
res = {}
with np.load(os.path.join(out, "inputs.npz")) as f:
    inputs = {k: f[k] for k in f.files}
ids = paddle.to_tensor(inputs["ids"])
for tag, make in (("llama", lambda: LlamaForCausalLM(LlamaConfig(
        **{**LlamaConfig.tiny().__dict__, "use_tensor_parallel": True}))),
                  ("gpt", lambda: GPTForCausalLM(GPTConfig(
        **{**GPTConfig.tiny().__dict__, "use_tensor_parallel": True})))):
    paddle.seed(0)
    model = make()
    arrays = {k[len(tag) + 1:]: v for k, v in inputs.items()
              if k.startswith(tag + ".")}
    mp_layers.set_global_params(model, arrays)
    params = dict(model.named_parameters())
    for k, v in mp_layers.gather_global_params(model).items():
        res[f"{tag}.roundtrip.{k}"] = v.numpy()
    for k, p in params.items():
        res[f"{tag}.local.{k}"] = p.numpy()
    res[f"{tag}.logits"] = model(ids).numpy()
    loss = model(ids, ids)
    res[f"{tag}.loss"] = loss.numpy()
    loss.backward()
    for k, p in params.items():
        res[f"{tag}.grad.{k}"] = mp_layers.gather_global(
            p, p.grad._data).numpy()
    if tag == "llama":
        attn = model.llama.layers[0].self_attn
        heads = [attn.num_heads, attn.num_kv_heads]
    else:
        heads = [model.gpt.blocks[0].attn.num_heads] * 2
    res[f"{tag}.local_heads"] = np.asarray(
        heads + [model.init_cache(2, 32)[0].k.shape[2]])
    res[f"{tag}.generated"] = model.generate(
        paddle.to_tensor(inputs["prompt"]),
        max_new_tokens=int(inputs["new_tokens"])).numpy()
np.savez(os.path.join(out, f"tp.{r}.npz"), **res)
dist.destroy_process_group()
'''


def _llama_cfg(pkg, tp):
    cfg = pkg.LlamaConfig.tiny()
    cfg.use_tensor_parallel = tp
    return cfg


def _gpt_cfg(pkg, tp):
    cfg = pkg.GPTConfig.tiny()
    cfg.use_tensor_parallel = tp
    return cfg


def _global_arrays(model, seed):
    """Global weights for every parameter of a port model, by name: norms
    near 1, the rest small, from numpy seeds."""
    out = {}
    for i, (k, p) in enumerate(sorted(model.named_parameters())):
        rs = np.random.RandomState(seed + i)
        a = rs.standard_normal(tuple(p.shape)).astype(np.float32)
        gain = ("norm" in k or ".ln" in k) and k.endswith("weight")
        out[k] = (1.0 + 0.05 * a if gain else 0.05 * a).astype(np.float32)
    return out


def _inputs():
    """The global weights of both models and the ids, as the workers read
    them."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models import llama as tl
    T.set_device("cpu")
    T.seed(0)
    weights = {"llama": _global_arrays(
        tl.LlamaForCausalLM(_llama_cfg(tl, False)), 100),
        "gpt": _global_arrays(tg.GPTForCausalLM(_gpt_cfg(tg, False)), 200)}
    return weights


class _RefMesh:
    """The reference's layers over an n-device "mp" mesh."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        from paddle_tpu.distributed.mesh import ProcessMesh, set_mesh
        set_mesh(ProcessMesh(shape=[self.n], dim_names=["mp"]))
        return self

    def __exit__(self, *exc):
        from paddle_tpu.distributed.mesh import set_mesh
        set_mesh(None)


def _reference(weights):
    """The reference's TP models over an "mp" mesh: logits, loss,
    gradients and greedy ids."""
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.models import gpt as rg
    from paddle_tpu.models import llama as rl
    want = {}
    with _RefMesh(MP):
        for tag, make in (
                ("llama", lambda: rl.LlamaForCausalLM(_llama_cfg(rl, True))),
                ("gpt", lambda: rg.GPTForCausalLM(_gpt_cfg(rg, True)))):
            with numpy_initializers(jax):
                paddle.seed(0)
                model = make()
            params = dict(model.named_parameters())
            for k, v in weights[tag].items():
                params[k].set_value(paddle.to_tensor(v))

            def step(ids, model=model, params=params):
                logits = model(ids)
                loss = model(ids, ids)
                loss.backward()
                return logits, loss, {k: p.grad for k, p in params.items()}
            # one compiled program: op by op the reference compiles a
            # kernel an op shape
            logits, loss, grads = paddle.jit.to_static(step, objs=[model])(
                paddle.to_tensor(IDS))
            want[f"{tag}.logits"] = logits.numpy()
            want[f"{tag}.loss"] = loss.numpy()
            for k, g in grads.items():
                want[f"{tag}.grad.{k}"] = g.numpy()
            want[f"{tag}.generated"] = model.generate(
                paddle.to_tensor(PROMPT), max_new_tokens=NEW_TOKENS).numpy()
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's 2 ranks and the reference, side by side."""
    out = tmp_path_factory.mktemp("layer_tp")
    weights = _inputs()
    np.savez(out / "inputs.npz", ids=IDS, prompt=PROMPT,
             new_tokens=np.asarray(NEW_TOKENS),
             **{f"{tag}.{k}": v for tag, w in weights.items()
                for k, v in w.items()})
    script = out / "worker.py"
    script.write_text(WORKER)
    done = {}
    thread = threading.Thread(target=lambda: done.setdefault(
        "res", run_workers(script, MP, [out], timeout=150)))
    thread.start()
    want = _reference(weights)
    thread.join()
    assert done["res"].returncode == 0, done["res"].stderr[-3000:]
    got = []
    for r in range(MP):
        with np.load(out / f"tp.{r}.npz") as f:
            got.append({k: f[k] for k in f.files})
    return weights, want, got


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * (float(np.abs(want).max()) or 1),
                               err_msg=what)


@pytest.mark.parametrize("tag", ["llama", "gpt"])
def test_tp_model_matches_reference(runs, tag):
    """Logits, loss and every parameter's gradient (gathered into the
    global layout) of the port's TP model on each of 2 ranks against the
    reference's over an "mp" mesh of 2."""
    _, want, got = runs
    for r, g in enumerate(got):
        for k in (f"{tag}.logits", f"{tag}.loss"):
            _close(g[k], want[k], f"rank {r} {k}")
        grads = [k for k in want if k.startswith(f"{tag}.grad.")]
        assert len(grads) == len([k for k in g
                                  if k.startswith(f"{tag}.grad.")]) > 0
        for k in grads:
            _close(g[k], want[k], f"rank {r} {k}")


@pytest.mark.parametrize("tag,heads", [("llama", [2, 1, 1]),
                                       ("gpt", [2, 2, 2])])
def test_tp_static_cache_greedy_ids(runs, tag, heads):
    """Greedy generation through the StaticCache: the same ids as the
    reference's; each rank attends over 2 of the 4 query heads (the
    Llama's over 1 of its 2 kv heads), and its cache holds its kv heads."""
    _, want, got = runs
    for g in got:
        np.testing.assert_array_equal(g[f"{tag}.generated"],
                                      want[f"{tag}.generated"])
        assert g[f"{tag}.local_heads"].tolist() == heads


@pytest.mark.parametrize("tag", ["llama", "gpt"])
def test_tp_params_round_trip(runs, tag):
    """set_global_params -> gather_global_params gives back every global
    array exactly, on every rank."""
    weights, _, got = runs
    for g in got:
        for k, v in weights[tag].items():
            np.testing.assert_array_equal(g[f"{tag}.roundtrip.{k}"], v)


def test_gpt_fused_qkv_shards_hold_their_heads(runs):
    """A rank's qkv shard holds its heads' q, k and v columns (its chunk of
    each third of the reference's global [h, 3h] weight and [3h] bias), not
    a contiguous slice that straddles q|k|v."""
    weights, _, got = runs
    for r, g in enumerate(got):
        for name in ("gpt.blocks.0.attn.qkv.weight",
                     "gpt.blocks.0.attn.qkv.bias"):
            w = weights["gpt"][name]
            want = np.concatenate([np.split(blk, MP, -1)[r]
                                   for blk in np.split(w, 3, -1)], -1)
            np.testing.assert_array_equal(g[f"gpt.local.{name}"], want)
            assert not np.array_equal(g[f"gpt.local.{name}"],
                                      np.split(w, MP, -1)[r])


@pytest.mark.parametrize("tag", ["llama", "gpt"])
def test_tp_model_at_world_one_is_dense(tag):
    """Without a model-parallel group the TP layers are their dense
    counterparts: the same weights give the dense model's logits exactly."""
    import paddle_tpu_torch as T
    from paddle_tpu_torch.models import gpt as tg
    from paddle_tpu_torch.models import llama as tl
    T.set_device("cpu")
    make = {"llama": lambda tp: tl.LlamaForCausalLM(_llama_cfg(tl, tp)),
            "gpt": lambda tp: tg.GPTForCausalLM(_gpt_cfg(tg, tp))}[tag]
    T.seed(0)
    dense, tp = make(False), make(True)
    tp.set_state_dict(dense.state_dict())
    ids = T.to_tensor(IDS)
    np.testing.assert_array_equal(tp(ids).numpy(), dense(ids).numpy())
    assert type(tp.state_dict()) is type(dense.state_dict())


def test_tp_head_counts_tp_does_not_divide_are_refused(monkeypatch):
    """A head count the model-parallel size does not divide is refused,
    naming both numbers."""
    from paddle_tpu_torch.models import llama as tl

    class _Group:
        nranks = 3

    class _Layer:
        _group = _Group()

    with pytest.raises(ValueError, match="num_heads=4 .* 3 model-parallel"):
        tl.local_heads(tl.LlamaConfig.tiny(), _Layer())


def test_distributed_infer_binds_a_client(monkeypatch):
    """DistributedInfer binds a PsClient from the role maker's endpoints
    and pulls the rows a direct PsClient pulls; without endpoints it binds
    none and pull_sparse raises, as the reference's."""
    import paddle_tpu.distributed.fleet.utils.ps_util as ref_ps_util
    from paddle_tpu_torch.distributed import ps
    from paddle_tpu_torch.distributed.fleet.utils import ps_util
    server = ps.PsServer(port=0, num_workers=1).start()
    client = ps.PsClient([f"127.0.0.1:{server.port}"])
    try:
        client.create_sparse_table(3, dim=4, seed=11)
        keys = np.asarray([5, 1, 9, 5, 40], dtype=np.int64)
        client.push_sparse(3, keys, np.ones((5, 4), np.float32))
        monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST",
                           f"127.0.0.1:{server.port}")
        infer = ps_util.DistributedInfer().init_distributed_infer_env()
        assert isinstance(infer._client, ps.PsClient)
        np.testing.assert_array_equal(infer.pull_sparse(3, keys),
                                      client.pull_sparse(3, keys))
        infer._client.close()
    finally:
        client.stop_servers()
        client.close()
        server.stop()
    monkeypatch.delenv("PADDLE_PSERVERS_IP_PORT_LIST")
    for mod in (ps_util, ref_ps_util):
        infer = mod.DistributedInfer().init_distributed_infer_env()
        assert infer._client is None
        with pytest.raises(RuntimeError, match="not initialized"):
            infer.pull_sparse(3, np.arange(2))


def test_xpu_places_are_the_reference_places():
    """static.xpu_places: XPUPlace(i) for the ids given (0 by default), as
    the reference's."""
    import paddle_tpu as P
    import paddle_tpu_torch as T
    for ids in (None, [0, 1, 3]):
        got, want = T.static.xpu_places(ids), P.static.xpu_places(ids)
        assert [type(p).__name__ for p in got] == ["XPUPlace"] * len(want)
        assert [vars(p) for p in got] == [vars(p) for p in want]
        assert [repr(p) for p in got] == [repr(p) for p in want]
