"""The PyTorch port stands alone: importing and running paddle_tpu_torch loads
neither jax nor the JAX package (the training step, the eager and Layer
APIs, serving: ``inference``, ``models.llama``, ``observability``'s
server, ``_chaos``, and ``amp``, ``models.bert``, ``models.moe`` and the
MoE step of ``models.gpt_hybrid``, ``io`` and ``vision`` with their
DataLoader workers, and the training-robustness modules: ``device``,
``training``, ``hapi`` with ``Model.fit``, ``metric``, ``callbacks``,
``distributed``'s ``checkpoint``/``watchdog``/``elastic`` and
``observability.training``, and the compiled programs: ``jit``, ``static``,
``base``, ``inference``'s predictor, ``incubate.jit``, ``tensorrt``, and
the rest of the eager API: ``_C_ops`` and ``ops/yaml``, ``core.infermeta``,
``ops``' ``extra``, ``vision_ops``, ``compat`` and ``array``, ``tensor``,
``linalg``, ``signal``, ``geometric``, ``nn``'s ``rnn``, extended layers and
functionals and ``quant``, ``core.string_tensor`` and ``text``, and
collective parallelism: ``distributed``'s ``env``, ``collective``,
``communication``, ``mesh``, ``parallel``, ``sharding``, ``fleet`` and
``launch``, with the data-parallel step of ``models.gpt_hybrid``, and
tensor and sequence parallelism: ``fleet``'s ``mp_layers`` and
``sequence_parallel_utils``, ``split``, the ``parallel`` package,
``models.gpt_manual_tp`` and gpt_hybrid's tp + sp step, and the breadth
slice: ``vision.ops``, ``static.nn.deform_conv2d``, ``base.core``,
``incubate``'s packages, ``fft`` and ``audio``, and the tail of the breadth:
``quantization``, ``sparse``, ``distribution``, ``decomposition``,
``regularizer``, ``utils``, ``onnx``, ``reader``, ``batch``, ``dataset``,
``hub``, ``sysconfig``, ``version``, ``pir_utils``, ``framework.core`` and
``common_ops_import``), and its entry points default to CUDA:
the training step's, and the eager API's, whose tensors land on gpu:0
unless set_device("cpu") was called."""
import os
import subprocess
import sys

import torch
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import torch
import paddle_tpu_torch
from paddle_tpu_torch.cost_model import cost_model
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.ops.hopper import (_build, autotune, blocked_flash,
                                         causal_attention, flash_attention,
                                         simple_attention, simple_attention2)
import paddle_tpu_torch as paddle
from paddle_tpu_torch import autograd, framework
from paddle_tpu_torch.autograd import tape
from paddle_tpu_torch.core import (dispatch, dtype, generator, place,
                                   tensor)
from paddle_tpu_torch.framework import io
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import (creation, extra, linalg, logic,
                                  manipulation, math, random, search,
                                  tensor_methods)

if not torch.cuda.is_available():
    try:
        paddle.to_tensor([1.0])
    except RuntimeError as e:
        print("EAGER_NO_CUDA_RAISES", "CUDA" in str(e))
paddle.set_device("cpu")
x = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]], stop_gradient=False)
y = paddle.ops.extra.flash_attn(x.reshape([1, 2, 1, 2]),
                                x.reshape([1, 2, 1, 2]),
                                x.reshape([1, 2, 1, 2]), causal=True)
(paddle.matmul(x, x).sum() + y.sum()).backward()
assert x.grad.shape == [2, 2]

cfg = GPTConfig.tiny()
pcfg = TH.ParallelConfig(remat=True, remat_policy="names")
params, opt, step = TH.setup(cfg, pcfg, seed=0, device="cpu")
ids = torch.randint(0, cfg.vocab_size, (2, 32))
loss = float(step(params, opt, (ids, ids))[2])
assert loss == loss
assert cost_model.gpt_flops_per_token(cfg, 32) > 0
assert flags.get_flag("FLAGS_attn_autotune") in (True, False)
assert autotune.candidates((2, 4096, 16, 64), 4096, torch.bfloat16,
                           True)[0] == "qblock"

# the Layer API, the optimizers and the Layer GPT
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.nn import functional, initializer, utils
from paddle_tpu_torch.nn.layer import (activation, common, conv, layers,
                                       loss, norm, pooling, transformer)
from paddle_tpu_torch.optimizer import gradient_merge, lr, optimizers
from paddle_tpu_torch.models.gpt import GPTForCausalLM
model = GPTForCausalLM(GPTConfig.tiny())
opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
ids_t = paddle.to_tensor(ids[:, :16].numpy())
model(ids_t, ids_t).backward()
opt.step()

# serving: the sessions, Llama, the scrape endpoint, fault injection
from paddle_tpu_torch import _chaos, inference, observability
from paddle_tpu_torch.incubate.nn import functional as incubate_functional
from paddle_tpu_torch.inference import admission, decode
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import catalog, server, snapshots
llama = LlamaForCausalLM(LlamaConfig.tiny())
assert llama.generate(ids_t[:1, :8], max_new_tokens=3).shape == [1, 11]
assert inference.DecodeSession is decode.DecodeSession
assert server.shared_server() is None and not _chaos.active()

# amp, BERT under AMP O2, the MoE layers and the MoE GPT step
from paddle_tpu_torch import amp, models
from paddle_tpu_torch.amp import debugging as amp_debugging, grad_scaler
from paddle_tpu_torch.models import bert, moe
from paddle_tpu_torch.models.bert import BertConfig, BertForMaskedLM
assert paddle.amp is amp and models.bert is bert and models.moe is moe
mlm = BertForMaskedLM(BertConfig.tiny())
mlm_opt = optimizer.AdamW(1e-3, parameters=mlm.parameters(),
                          multi_precision=True)
mlm, mlm_opt = amp.decorate(mlm, mlm_opt, level="O2", dtype="bfloat16")
scaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
with amp.auto_cast(level="O2", dtype="bfloat16"):
    mlm_loss = mlm(ids_t[:, :16], labels=ids_t[:, :16])
scaler.scale(mlm_loss).backward()
scaler.step(mlm_opt)
scaler.update()
assert not scaler.found_inf and mlm.bert.pooler.weight.dtype == paddle.bfloat16
moe_layer = moe.MoELayer(16, 32, num_experts=2)
assert moe_layer(paddle.randn([2, 4, 16])).shape == [2, 4, 16]
moe_pcfg = TH.ParallelConfig(num_experts=2, remat=True, remat_policy="names")
moe_params, moe_opt, moe_step = TH.setup(cfg, moe_pcfg, seed=0, device="cpu")
assert moe_params["blocks"]["fc1_w"].shape[:2] == (cfg.num_layers, 2)
grad_step, apply_step = TH.build_accum_steps(cfg, moe_pcfg)
acc, moe_loss = grad_step(moe_params, TH.init_grad_accum(moe_params),
                          (ids, ids))
apply_step(moe_params, moe_opt, acc, 1)
assert float(moe_loss) == float(moe_loss)

# io and vision: the DataLoader (workers too), transforms, datasets, the zoo
import numpy as np
from paddle_tpu_torch import io as pio, vision
from paddle_tpu_torch.vision import datasets as vdatasets, transforms
from paddle_tpu_torch.vision.models import resnet18
assert models.resnet.resnet50 is vision.models.resnet50
fake = vdatasets.FakeData(size=4, image_shape=(3, 32, 32),
                          transform=transforms.Compose([
                              transforms.Transpose((1, 2, 0)),
                              transforms.Resize(16), transforms.ToTensor()]))
batches = list(pio.DataLoader(fake, batch_size=2, num_workers=2))
assert batches[0][0].shape == [2, 3, 16, 16]
assert resnet18(num_classes=10)(batches[0][0]).shape == [2, 10]

# training robustness: Model.fit with a step guard, a watchdog and a
# committed checkpoint, the device stats, metrics, elastic stores
import tempfile
from paddle_tpu_torch import callbacks, device, hapi, metric, training
from paddle_tpu_torch import distributed
from paddle_tpu_torch.distributed import checkpoint, elastic, watchdog
from paddle_tpu_torch.observability import training as otraining
assert paddle.Model is hapi.Model and paddle.callbacks is callbacks
assert device.memory_allocated() >= 0 and device.device_count("cpu") == 1
assert otraining.DEFAULT_PEAK_FLOPS == cost_model.GPU_SPECS["H100"]["flops"]
net = nn.Linear(4, 2)
fit_model = paddle.Model(net)
fit_model.prepare(optimizer.SGD(0.1, parameters=net.parameters()),
                  nn.MSELoss(), metrics=None,
                  step_guard=training.StepGuard(check_grads=True),
                  watchdog=watchdog.TrainStepWatchdog(timeout_s=60.0))
xy = [(np.ones(4, "f4"), np.zeros(2, "f4"))] * 4
with tempfile.TemporaryDirectory() as ck:
    ftc = hapi.FaultTolerantCheckpoint(ck, every_n_steps=2)
    hist = fit_model.fit(xy, batch_size=2, epochs=1, verbose=0,
                         callbacks=[ftc])
    assert len(hist["loss"]) == 2 and checkpoint.latest_committed(ck)
    elastic.FileKVStore(ck).put("k", "v")
fit_model._watchdog.stop()
acc = metric.Accuracy()
acc.update(acc.compute(paddle.to_tensor([[0.1, 0.9]]),
                       paddle.to_tensor([[1]])))
assert acc.accumulate() == 1.0

# compiled programs: jit, static, base, the predictor, incubate.jit,
# tensorrt
from paddle_tpu_torch import base, jit, static, tensorrt
from paddle_tpu_torch.incubate import jit as incubate_jit
from paddle_tpu_torch.observability import compile_tracker
from paddle_tpu_torch.static import amp as static_amp, nn as static_nn
jit.set_default_backend("aot_eager")
assert paddle.jit is jit and paddle.static is static
assert base.Executor is static.Executor and static_amp.GradScaler is \
    amp.GradScaler
jit_net = nn.Linear(4, 2)
jit_opt = optimizer.SGD(0.1, parameters=jit_net.parameters())

def jit_step(x):
    loss = (jit_net(x) ** 2).mean()
    loss.backward()
    jit_opt.step()
    jit_opt.clear_grad()
    return loss

jit_x = paddle.to_tensor(np.ones((3, 4), "f4"))
with compile_tracker.count_compiles() as compiles:
    jit_losses = [float(jit.to_static(jit_step, objs=[jit_net, jit_opt])(
        jit_x)) for _ in range(1)]
assert compiles() == 1 and jit_losses[0] == jit_losses[0]
with tempfile.TemporaryDirectory() as jd:
    jit.save(jit_net, jd + "/m", input_spec=[jit.InputSpec([None, 4])])
    served = inference.create_predictor(inference.Config(jd + "/m"))
    assert served.run([jit_x])[0].shape == [3, 2]
assert incubate_jit.inference(nn.Linear(4, 2))(jit_x).shape == [3, 2]
assert static_nn.fc(jit_x, 5).shape == [3, 5]

# the rest of the eager API: _C_ops from the port's yaml, infermeta, the
# extra, vision and compat ops, tensor arrays, linalg, signal, geometric,
# the RNNs, nn's extended layers and functionals, nn.quant, string tensors
# and text
from paddle_tpu_torch import _C_ops, geometric, linalg, signal, tensor, text
from paddle_tpu_torch.core import infermeta, string_tensor
from paddle_tpu_torch.nn import quant
from paddle_tpu_torch.nn.functional import extended as fextended
from paddle_tpu_torch.nn.layer import extended as lextended, rnn
from paddle_tpu_torch.ops import array, compat, vision_ops
from paddle_tpu_torch.ops.yaml import bootstrap, generator
from paddle_tpu_torch.text import tokenizer
assert paddle._C_ops is _C_ops and paddle.linalg is linalg
assert _C_ops.matmul(jit_x, jit_x, False, True).shape == [3, 3]
assert _C_ops.elementwise_add is _C_ops.add
assert infermeta.infer_via_eval_shape(
    paddle.matmul, infermeta.MetaTensor([3, 4], "float32"),
    infermeta.MetaTensor([4, 5], "float32")).shape == (3, 5)
lstm = nn.LSTM(4, 8, num_layers=2, direction="bidirect")
lstm_out, (lstm_h, lstm_c) = lstm(jit_x.reshape([3, 1, 4]))
assert lstm_out.shape == [3, 1, 16] and rnn.ROUTES["aten"] >= 2
assert nn.GRU(4, 8)(jit_x.reshape([3, 1, 4]))[0].shape == [3, 1, 8]
q_w, q_s = quant.weight_quantize(paddle.randn([4, 6]))
assert quant.weight_only_linear(jit_x, q_w, weight_scale=q_s).shape == \
    [3, 6]
assert nn.functional.grid_sample(
    paddle.ones([1, 1, 4, 4]), paddle.zeros([1, 2, 2, 2])).shape == \
    [1, 1, 2, 2]
assert vision_ops.pool2d(paddle.ones([1, 1, 4, 4]), 2).shape == [1, 1, 2, 2]
assert signal.stft(paddle.ones([32]), 8).shape == [5, 17]
arr = tensor.array_write(jit_x, paddle.to_tensor([0]))
assert int(tensor.array_length(arr)) == 1
tok = text.FasterTokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "hi"])
assert tok(string_tensor.StringTensor(["hi"]))[0].numpy().tolist() == \
    [[2, 4, 3]]
assert compat.block_diag([jit_x, jit_x]).shape == [6, 8]
assert geometric.segment_sum(jit_x, paddle.to_tensor([0, 0, 1])).shape == \
    [2, 4]
assert paddle.linalg.inv(paddle.eye(3)).shape == [3, 3]

# collective parallelism at world 1 over gloo: process groups, collectives,
# DataParallel, the ZeRO stages, fleet, the launcher, the dp + ZeRO-1 step
import paddle_tpu_torch.distributed as dist
from paddle_tpu_torch.distributed import (collective, communication, env,
                                          fleet, io as dist_io, launch,
                                          mesh, parallel, sharding)
from paddle_tpu_torch.distributed.communication import stream
from paddle_tpu_torch.distributed.fleet import recompute, topology
from paddle_tpu_torch.distributed.fleet.utils import (
    fs, hybrid_parallel_util, log_util, mix_precision_utils, timer_helper)
from paddle_tpu_torch.distributed.launch import main as launch_main
params, opt, step = TH.setup(cfg, pcfg, seed=0, device="cpu")
single = float(step(params, opt, (ids, ids))[2])
dist.init_parallel_env()
assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
t = paddle.ones([4])
dist.all_reduce(t)
assert t.numpy().tolist() == [1.0] * 4
fleet.init(is_collective=True, strategy=fleet.DistributedStrategy())
lin = nn.Linear(4, 4)
dp_model = dist.DataParallel(lin)
dp_model(paddle.ones([2, 4])).sum().backward()
lin3 = nn.Linear(4, 4)
zm, zo, _ = dist.group_sharded_parallel(
    lin3, optimizer.AdamW(1e-3, parameters=lin3.parameters()), "p_g_os")
zm(paddle.ones([2, 4])).sum().backward()
zo.step()
params, opt, step = TH.setup(cfg, pcfg, seed=0, device="cpu")
assert isinstance(opt["m"]["float32"], torch.Tensor)      # flat buckets
assert float(step(params, opt, (ids, ids))[2]) == single
# tensor and sequence parallelism at world 1: fleet's mp and sp layers,
# split, the parallel package, the manual-tp block and the tp + sp step
import paddle_tpu_torch.parallel as tpar
from paddle_tpu_torch.distributed.fleet import (
    ColumnParallelLinear, ColumnSequenceParallelLinear, ParallelCrossEntropy,
    RowParallelLinear, RowSequenceParallelLinear, VocabParallelEmbedding,
    get_rng_state_tracker, mark_as_sequence_parallel_parameter, mp_layers,
    register_sequence_parallel_allreduce_hooks, sequence_parallel_utils)
from paddle_tpu_torch.models import gpt_manual_tp
from paddle_tpu_torch.parallel import (collective_matmul, ring_attention,
                                       sequence, ulysses)
assert dist.split(paddle.ones([2, 4]), (4, 6), "linear", axis=1).shape == \
    [2, 6]
tp_cfg = TH.ParallelConfig(sp=True, collective_matmul=True, remat=True,
                           remat_policy="names")
params, opt, step = TH.setup(cfg, tp_cfg, seed=0, device="cpu")
assert abs(float(step(params, opt, (ids, ids))[2]) - single) < 1e-3 * single
dist.destroy_process_group()

# the breadth slice: vision.ops, static.nn's deform_conv2d, base.core,
# incubate's packages, fft and audio
from paddle_tpu_torch import audio, fft, incubate
from paddle_tpu_torch.base import core as base_core
from paddle_tpu_torch.incubate import (asp, multiprocessing as imp,
                                       operators)
from paddle_tpu_torch.incubate import autograd as iag
from paddle_tpu_torch.vision import ops as vision_ops_mod
feat = paddle.randn([1, 4, 8, 8])
rois = paddle.to_tensor([[0.0, 0.0, 4.0, 4.0], [1.0, 2.0, 6.0, 7.0]])
assert vision_ops_mod.roi_align(feat, rois, paddle.to_tensor([2]),
                                2).shape == [2, 4, 2, 2]
assert vision_ops_mod.nms(rois, 0.5).shape == [2]
dcn = paddle.static.nn.deform_conv2d(feat, paddle.zeros([1, 18, 8, 8]),
                                     None, 3, 3, padding=1)
assert dcn.shape == [1, 3, 8, 8]
assert base_core.get_cuda_device_count() == paddle.device.device_count()
q_rot, _, _ = incubate.nn.functional.fused_rotary_position_embedding(
    paddle.randn([1, 4, 2, 8]))
assert q_rot.shape == [1, 4, 2, 8]
assert asp.calculate_density(paddle.ones([4])) == 1.0
assert iag.vjp(lambda t: t * t, [paddle.ones([2])])[1][0].shape == [2]
assert fft.rfft(paddle.ones([8])).shape == [5] and paddle.fft is fft
assert audio.features.MelSpectrogram(sr=8000, n_fft=64, n_mels=8)(
    paddle.randn([1, 256])).shape[1] == 8
assert callable(imp.Queue) and callable(operators.graph_send_recv)

# the tail of the breadth: quantization, sparse, distribution,
# decomposition, regularizer, utils, onnx, reader, batch, dataset, hub,
# sysconfig, version, pir_utils, framework.core, common_ops_import
from paddle_tpu_torch import (check_import_scipy, common_ops_import, hub,
                              pir_utils, sysconfig)
from paddle_tpu_torch.batch import batch as batch_fn
from paddle_tpu_torch.framework import core as framework_core
from paddle_tpu_torch.utils import cpp_extension, dlpack, download
for name in ("sparse", "distribution", "quantization", "utils",
             "regularizer", "dataset", "reader", "onnx", "hub",
             "decomposition", "pir_utils", "sysconfig", "version"):
    assert getattr(paddle, name).__name__ == f"paddle_tpu_torch.{name}"
assert paddle.batch is batch_fn is paddle.ops.compat.batch
qlin = paddle.quantization.QAT(paddle.quantization.QuantConfig()).quantize(
    nn.Sequential(nn.Linear(4, 2)))
assert qlin(paddle.randn([3, 4])).shape == [3, 2]
coo = paddle.sparse.sparse_coo_tensor([[0, 1], [1, 0]], [1.0, 2.0], [2, 2])
assert paddle.sparse.matmul(coo, paddle.ones([2, 3])).shape == [2, 3]
assert paddle.distribution.Normal(0.0, 1.0).sample([4]).shape == [4]
assert paddle.decomposition.has_decomp_rule("softmax")
assert iag.prim_enabled() is paddle.decomposition.prim_enabled()
assert paddle.regularizer.L2Decay(0.5)(paddle.ones([2])).shape == [2]
assert paddle.utils.flatten({"b": [1, 2], "a": 3}) == [3, 1, 2]
assert dlpack.from_dlpack(dlpack.to_dlpack(paddle.ones([2]))).shape == [2]
assert callable(cpp_extension.register_op) and callable(download.
                                                        get_path_from_url)
assert len(next(paddle.dataset.mnist.train()())[0]) == 784
assert list(paddle.reader.firstn(lambda: iter(range(5)), 2)()) == [0, 1]
assert framework_core.TCPStore is base_core.TCPStore
assert common_ops_import.Variable is paddle.Tensor
assert callable(hub.load) and check_import_scipy.check_import_scipy("posix")
assert sysconfig.get_include().endswith("csrc")
assert paddle.version.cuda() == (torch.version.cuda or "False")
with pir_utils.IrGuard():
    pass

def foreign(name):
    return (name in ("jax", "jaxlib", "paddle_tpu")
            or name.startswith(("jax.", "jaxlib.", "paddle_tpu.")))

print("FOREIGN", sorted(m for m in sys.modules if foreign(m)))
if not torch.cuda.is_available():
    try:
        TH.setup(cfg, pcfg)
    except RuntimeError as e:
        print("NO_CUDA_RAISES", "CUDA" in str(e))
"""


def test_port_imports_and_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout
    if not torch.cuda.is_available():
        assert "\nNO_CUDA_RAISES True" in out.stdout, out.stdout
        assert "EAGER_NO_CUDA_RAISES True" in out.stdout, out.stdout


def test_distributed_names_of_later_slices_raise_naming_their_queue_item():
    """The names the host-runtime slice brought resolve to the ported
    modules; none is left to a later slice, and a name the reference does
    not have still raises AttributeError."""
    import pytest
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import distributed, native, profiler
    from paddle_tpu_torch.distributed import (elastic, fleet_executor, ps,
                                              rpc)
    assert paddle.Model.__module__ == "paddle_tpu_torch.hapi"
    assert distributed.save_state_dict is distributed.checkpoint.\
        save_state_dict
    assert (distributed.rpc, distributed.ps, distributed.fleet_executor) == \
        (rpc, ps, fleet_executor)
    assert distributed.TCPStore is native.TCPStore
    assert distributed.InMemoryDataset.__module__ == distributed.__name__
    assert issubclass(distributed.InMemoryDataset, distributed.QueueDataset)
    for name in ("ProbabilityEntry", "CountFilterEntry", "ShowClickEntry"):
        assert getattr(distributed, name).__module__ == distributed.__name__
    assert distributed.fleet.PaddleCloudRoleMaker is ps.PaddleCloudRoleMaker
    assert distributed.fleet.UtilBase.__module__ == \
        distributed.fleet.__name__
    assert elastic.TCPKVStore.__module__ == elastic.__name__
    assert paddle.profiler is profiler
    # the auto-parallel slice's names (item 5e) are there
    assert distributed.auto_parallel.Engine is distributed.fleet.auto.Engine
    assert distributed.shard_tensor is distributed.api.shard_tensor
    with pytest.raises(AttributeError):
        distributed.no_such_name  # noqa: B018
    with pytest.raises(AttributeError):
        distributed.fleet.no_such_name  # noqa: B018
