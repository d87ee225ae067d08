"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for one NVIDIA H100.

It sits beside the JAX package ``paddle_tpu``, which stays the reference, and
imports neither ``jax`` nor anything of ``paddle_tpu``. Entry points run on
the CUDA device unless the caller asks for the CPU (``device="cpu"``, or
``set_device("cpu")`` for the eager API).

What is ported so far:

- the GPT training step of ``paddle_tpu.models.gpt_hybrid`` at dp=pp=tp=1
  (``models/gpt_hybrid.py``), with every Pallas attention kernel of the
  reference as a Hopper kernel (``ops/hopper``) and the attention autotuner;
- the eager Paddle API: ``Tensor`` over ``torch.Tensor``, dtypes, places,
  the generator, the flag registry, eager dispatch, autograd on
  ``torch.autograd`` (``backward``, ``grad``, ``PyLayer``, hooks), the core
  op library (creation, math, manipulation, logic, search, linalg, random),
  ``flash_attn`` (which reaches the Hopper kernels), and ``save``/``load``;
- the Layer API and the optimizers: ``nn`` (``Layer``, the layers, the
  functionals, initializers, clipping, ``nn.utils``; its
  ``scaled_dot_product_attention`` reaches the library attention tier's
  Hopper kernels) and ``optimizer`` (the 14 optimizers, ``lr``,
  ``GradientMergeOptimizer``), and the Layer GPT (``models/gpt.py``);
- serving: ``inference`` (the fixed-capacity KV cache, ``DecodeSession``,
  ``ContinuousBatchingSession``, admission control), the Llama model
  (``models/llama.py``) and the GPT's cache path, ``incubate``'s
  ``masked_multihead_attention``, and ``observability`` (the registry, its
  exporters, snapshots and the scrape endpoint) with the fault-injection
  hooks of ``_chaos``;
- ``amp`` (``auto_cast``, ``decorate``, ``GradScaler``, ``debugging``),
  the BERT models (``models/bert.py``), the MoE layers (``models/moe.py``)
  and ``models/gpt_hybrid``'s single-device MoE step and split gradient
  accumulation;
- ``io`` (datasets, samplers, the DataLoader with its worker processes and
  resumable position) and ``vision`` (transforms, datasets, the model zoo:
  ResNet and the others; ``models.resnet`` is ``vision.models.resnet``);
- training robustness: ``hapi`` (``Model`` with ``fit``, the callbacks,
  ``FaultTolerantCheckpoint``), ``metric``, ``callbacks``, ``training``
  (``StepGuard``, ``PreemptionHandler``, the train checkpoints),
  ``device`` (memory statistics), ``observability.training`` and the
  part of ``distributed`` they use: ``checkpoint``, ``watchdog``,
  ``elastic``;
- compiled programs: ``jit`` (``to_static`` over ``make_fx`` and
  ``torch.compile``, ``save``/``load`` over ``torch.export``), ``static``
  (the Program/Executor facade, ``static.nn``, ``static.amp``), ``base``,
  ``incubate.jit``, ``tensorrt``, and ``inference``'s predictor
  (``Config``, ``create_predictor``, the int8 weight-only export);
- the rest of the eager API: ``_C_ops``, generated from the port's own
  ``ops/yaml`` by its generator, ``core.infermeta``, the rest of
  ``ops/extra`` (norms, special functions, decode loops, the fused AMP
  and optimizer ops), ``ops/vision_ops``, ``ops/compat`` (the top-level
  names), ``ops/array`` with the ``tensor`` namespace, ``linalg``,
  ``signal``, ``nn``'s RNNs, extended layers and functionals and
  ``nn.quant``, string tensors and ``text``;
- collective parallelism over ``torch.distributed`` (``distributed``:
  process groups, collectives, ``DataParallel``, the ZeRO stages, fleet's
  dp and sharding, the launcher, sharded checkpoints) and
  ``models/gpt_hybrid``'s data-parallel step with ZeRO-1; its tensor,
  sequence, pipeline and expert-parallel branches; the semi-auto API
  (``distributed.api``, ``auto_parallel``'s Engine, the planner);
- the breadth: ``vision.ops``, ``fft``, ``audio``, the rest of
  ``incubate``, the parameter server and the native runtime, then
  ``quantization`` (QAT, PTQ), ``sparse`` (COO tensors over torch's,
  ``sparse.nn``), ``distribution``, ``decomposition``, ``regularizer``,
  ``utils`` (``cpp_extension``, ``dlpack``, ``download``), ``onnx``,
  ``reader``, ``batch``, ``dataset``, ``hub``, ``sysconfig``, ``version``
  and ``pir_utils``, each a lazy top-level name as in the reference.

Use it as ``import paddle_tpu_torch as paddle``.
"""
from __future__ import annotations

from .device import resolve_device  # noqa: F401

# ---- core -----------------------------------------------------------------
from .core.tensor import Tensor, Parameter  # noqa: F401
from .core.dtype import (  # noqa: F401
    bool_ as bool, uint8, int8, int16, int32, int64, float16, bfloat16,
    float32, float64, complex64, complex128, float8_e4m3fn, float8_e5m2,
    set_default_dtype, get_default_dtype, finfo, iinfo, promote_types,
    DType as dtype,
)
from .core.place import (  # noqa: F401
    CPUPlace, CUDAPlace, CUDAPinnedPlace, CustomPlace, IPUPlace, Place,
    TPUPlace, XPUPlace, get_device, set_device, is_compiled_with_tpu,
)
from .core.generator import seed, default_generator  # noqa: F401
from .core.flags import get_flags, set_flags, define_flag  # noqa: F401

# ---- ops (flat namespace like paddle.*) -----------------------------------
from . import ops  # noqa: F401  (patches Tensor methods)
from .ops.creation import *  # noqa: F401,F403
from .ops.math import *  # noqa: F401,F403
from .ops.manipulation import *  # noqa: F401,F403
from .ops.logic import *  # noqa: F401,F403
from .ops.search import *  # noqa: F401,F403
from .ops.linalg import (  # noqa: F401
    matmul, mm, bmm, mv, dot, cross, multi_dot, norm, dist, cdist, cholesky,
    cholesky_solve, inverse, solve, det, slogdet, t, einsum,
)
from .ops.random import (  # noqa: F401
    rand, randn, randint, randint_like, randperm, uniform, normal,
    standard_normal, bernoulli, bernoulli_, binomial, multinomial, poisson,
    rand_like, randn_like, normal_, uniform_, exponential_, laplace,
)
from .ops import extra  # noqa: F401
from .ops.extra import (  # noqa: F401
    renorm, reverse, shape, as_strided, reduce_as, gammaln, polygamma,
    gammainc, gammaincc, standard_gamma,
)
from .ops.compat import (  # noqa: F401
    block_diag, cartesian_prod, combinations, vander, column_stack,
    row_stack, hsplit, vsplit, dsplit, unflatten, add_n, slice_scatter,
    select_scatter, diagonal_scatter, isin, histogram_bin_edges, pdist,
    sinc, sgn, signbit, frexp, ldexp, trapezoid, cumulative_trapezoid,
    multigammaln, log_normal, rank, tolist, is_complex, is_integer,
    is_floating_point, check_shape, disable_signal_handler,
    set_printoptions, get_rng_state, set_rng_state, get_cuda_rng_state,
    set_cuda_rng_state, create_parameter, batch, LazyGuard, flops,
    cauchy_, geometric_, log_normal_,
)
from . import _C_ops  # noqa: F401  (generated dispatch surface)

# ---- autograd, io ---------------------------------------------------------
from . import autograd  # noqa: F401
from .autograd import (  # noqa: F401
    no_grad, enable_grad, set_grad_enabled, is_grad_enabled, grad,
)
from .framework.io import save, load  # noqa: F401
from . import io  # noqa: F401

# ---- the Layer API and the optimizers -------------------------------------
from . import nn  # noqa: F401
from . import optimizer  # noqa: F401
from . import amp  # noqa: F401
from . import jit  # noqa: F401
from .nn.layer.layers import ParamAttr  # noqa: F401
from . import fft  # noqa: F401
from . import linalg  # noqa: F401
from . import signal  # noqa: F401

# generated `<op>_` inplace variants over the out-of-place ops above
from .ops.tensor_methods import build_inplace_variants as _biv
globals().update(_biv(globals()))
del _biv

__version__ = "0.1.0"


_LAZY = {"vision", "hapi", "metric", "callbacks", "training",
         "distributed", "static", "inference", "incubate", "base",
         "tensorrt", "tensor", "text", "geometric", "profiler", "audio",
         "models", "parallel", "distribution", "sparse", "device",
         "quantization", "utils", "regularizer", "sysconfig", "hub", "onnx",
         "dataset", "reader", "decomposition", "pir_utils", "batch",
         "observability", "version"}


def __getattr__(name):
    """These modules load on first use, as the reference's do."""
    if name in _LAZY:
        import importlib
        mod = importlib.import_module(f"{__name__}.{name}")
        if name == "batch":
            return mod.batch      # paddle.batch is the function itself
        return mod
    if name == "Model":
        from .hapi import Model
        return Model
    if name == "DataParallel":
        from .distributed.parallel import DataParallel
        return DataParallel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def is_tensor(x):
    return isinstance(x, Tensor)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    return Tensor(data, dtype=dtype, place=place, stop_gradient=stop_gradient)


def get_flags_dict():
    return get_flags()


def device_count():
    import torch
    return torch.cuda.device_count()


def synchronize():
    """Block until all queued device work completes."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def summary(net, input_size=None, dtypes=None, input=None):
    """The parameter counts of ``net``, as the reference's summary gives
    them."""
    total = trainable = 0
    for _, p in net.named_parameters():
        n = p.size
        total += n
        if not p.stop_gradient:
            trainable += n
    return {"total_params": total, "trainable_params": trainable}


def in_dynamic_mode():
    return True


def disable_static(place=None):
    pass


def enable_static():
    raise NotImplementedError(
        "legacy static program mode is replaced by paddle_tpu_torch.jit."
        "to_static (program capture); see paddle_tpu_torch.static")


# bind the rest of the reference Tensor-method surface: every method in the
# reference tensor_method_func list whose op exists at module level
from .ops.tensor_methods import patch_from_modules as _pfm  # noqa: E402
_pfm()
del _pfm
