"""paddle.inference on torch: the port of ``paddle_tpu/inference/__init__.py``
(reference: AnalysisPredictor, fluid/inference/api/analysis_predictor.h:105
— config + predictor with zero-copy tensors, pass pipelines).

The serving sessions over the fixed-capacity KV cache live in ``decode``
(``DecodeSession``, ``ContinuousBatchingSession``, ``cached_generate``, the
cache primitives) and the request lifecycle in ``admission``.

The predictor: graph capture is ``jit.to_static`` (``make_fx`` and
``torch.compile``), a saved program is ``jit.save``'s ``torch.export``
archive, served as a ``TranslatedLayer``. What the predictor adds, as the
reference's does:

  * precision passes — ``enable_low_precision_inference`` casts the served
    weights and compute to bf16/fp16; ``enable_int8_weight_only``
    quantizes weights to int8 with per-channel scales and serves the
    dequantized values, keeping the int8 payload for an int8-native export
    (``save_int8_model`` / ``load_int8_model`` / ``Int8Linear``);
  * shape bucketing — ``enable_shape_bucketing`` pads the batch dim to a
    fixed bucket ladder so arbitrary request sizes hit a bounded set of
    compiled graphs (a batch past the top bucket runs in top-bucket
    chunks);
  * zero-copy IO — handles adopt existing device tensors;
  * async execution — ``run_async`` returns once the work is queued;
  * warmup + execution stats;
  * ``generate`` over ``DecodeSession`` (``enable_decode``).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import nn as _nn
from ..autograd import no_grad
from ..core import dtype as dtype_mod
from ..core.dispatch import run_op
from ..core.tensor import Tensor
from . import admission  # noqa: F401
from . import decode  # noqa: F401
from .admission import (  # noqa: F401
    AdmissionController, AdmissionRejected, RequestResult, RequestState,
    ServingStepError,
)
from .decode import (  # noqa: F401
    ContinuousBatchingSession, DecodeSession, StaticCache, cache_attention,
    cached_generate, init_static_cache, masked_multihead_attention_impl,
)


def _sync(outs):
    """Wait for the device work behind ``outs`` (Tensors)."""
    if any(o._data.is_cuda for o in outs):
        torch.cuda.synchronize()


class Config:
    def __init__(self, model_path: Optional[str] = None,
                 params_path: Optional[str] = None):
        self.model_path = model_path
        self.params_path = params_path
        self._layer = None
        self._donate = True
        self._precision = None          # None | bf16/fp16 DType
        self._int8_weights = False
        self._buckets: Optional[List[int]] = None
        self._decode: Optional[dict] = None

    # ---- reference-config surface (compiler-internal knobs are no-ops) --
    def enable_use_gpu(self, *a, **k):
        pass

    def enable_tpu(self, *a, **k):
        pass

    def disable_gpu(self):
        pass

    def switch_ir_optim(self, flag=True):
        pass

    def enable_memory_optim(self, flag=True):
        pass

    def set_cpu_math_library_num_threads(self, n):
        pass

    def enable_tensorrt_engine(self, *a, **k):
        raise NotImplementedError("TensorRT is not part of the port; "
                                  "torch.compile compiles the graph")

    # ---- real serving passes ----------------------------------------
    def enable_low_precision_inference(self, dtype="bfloat16"):
        """Mixed-precision pass: serve weights + compute in bf16/fp16
        (reference convert_to_mixed_precision / the gpu fp16 pass)."""
        self._precision = dtype_mod.convert_dtype(dtype)
        return self

    def enable_int8_weight_only(self, flag=True):
        """PTQ weight-only int8: per-output-channel symmetric scales.
        The served weights are quantize-dequantized in place (exact
        accuracy parity with an int8 deployment) and the int8 payload
        + scales are kept on each parameter (`_int8_payload`) for an
        int8-native export."""
        self._int8_weights = bool(flag)
        return self

    def enable_decode(self, max_length: int, prefill_buckets=None,
                      temperature=0.0, top_p=None, eos_token_id=None):
        """Serving decode config: fixed-capacity KV cache of
        `max_length` (see inference/decode.py). Enables
        Predictor.generate."""
        self._decode = dict(max_length=int(max_length),
                            prefill_buckets=prefill_buckets,
                            temperature=temperature, top_p=top_p,
                            eos_token_id=eos_token_id)
        return self

    def enable_shape_bucketing(self, buckets: Sequence[int]):
        """Pad the leading (batch) dim up to the nearest bucket so any
        request size compiles at most len(buckets) graphs."""
        self._buckets = sorted(int(b) for b in buckets)
        return self

    def set_model(self, model_path, params_path=None):
        self.model_path = model_path
        self.params_path = params_path

    def set_layer(self, layer):
        """Directly serve an in-memory Layer (fast path)."""
        self._layer = layer


def _quantize_int8(arr, channel_axis):
    """Per-channel symmetric int8 quantization; the scales are the
    reference's GroupWiseWeightObserver's (per-channel abs-max / 127)."""
    a = np.asarray(dtype_mod.to_numpy(arr), np.float32)
    ax = channel_axis % a.ndim
    red = tuple(i for i in range(a.ndim) if i != ax)
    shape = [1] * a.ndim
    shape[ax] = -1
    scale = np.maximum(np.abs(a).max(axis=red) / 127,
                       1e-8).astype(np.float32).reshape(shape)
    q = np.clip(np.round(a / scale), -127, 127).astype(np.int8)
    return q, scale


class Predictor:
    def __init__(self, config: Config):
        from ..jit import load as _jit_load
        self._config = config
        self._layer = config._layer
        if self._layer is None and config.model_path:
            # serve a jit.save artifact: <path>.pdmodel is a
            # torch.export archive, loaded as a TranslatedLayer
            import os
            path = config.model_path
            for suffix in (".pdmodel", ".json"):
                if path.endswith(suffix):
                    path = path[:-len(suffix)]
            if os.path.exists(path + ".pdmodel"):
                self._layer = _jit_load(path)
        if self._layer is None:
            raise NotImplementedError(
                "the predictor needs a model: pass Config(model_path) "
                "pointing at a paddle_tpu_torch.jit.save artifact, or use "
                "Config.set_layer(layer)")
        self._apply_passes()
        self._inputs: Dict[str, Tensor] = {}
        self._compiled = None
        self._last_out: Optional[Tensor] = None
        self._flag_cache = {}
        self.stats = {"runs": 0, "bucket_pad_total": 0,
                      "last_latency_ms": None, "warmup_shapes": []}

    def _translated(self):
        from ..jit import TranslatedLayer
        return isinstance(self._layer, TranslatedLayer)

    # ---- precision / quantization passes over the served weights ----
    def _apply_passes(self):
        cfg = self._config
        if self._translated():
            return                      # weights frozen in the program
        if cfg._int8_weights:
            self._int8_rewrite()
        if cfg._precision is not None:
            # composes with int8: QDQ'd weights are then SERVED in the
            # low precision (int8-emulated values, bf16 compute)
            dt = cfg._precision.torch
            for _, p in self._layer.named_parameters():
                if p._data.is_floating_point():
                    p._assign_array(p._data.detach().to(dt))
            for _, b in self._layer.named_buffers():
                if b._data.is_floating_point():
                    b._assign_array(b._data.to(dt))

    def _int8_rewrite(self):
        """Quantize-dequantize every >=2-D float parameter in place
        (int8 deployment numerics) and stash the (int8, scale) payload
        on the parameter for int8-native export. Channel convention:
        last dim for matrices (Linear [in, out]), dim 0 for conv
        weights ([out, in, k...])."""
        for _, p in self._layer.named_parameters():
            a = p._data
            if a.dim() >= 2 and a.is_floating_point():
                ax = -1 if a.dim() == 2 else 0
                q, scale = _quantize_int8(a, ax)
                deq = torch.from_numpy(q).to(a.device).float() \
                    * torch.from_numpy(scale).to(a.device)
                p._assign_array(deq.to(a.dtype))
                p._int8_payload = (q, scale)   # int8-native export

    # ---- IO handles --------------------------------------------------
    def get_input_names(self):
        return list(self._inputs) or ["x"]

    def get_input_handle(self, name):
        from ..ops.creation import zeros
        t = self._inputs.setdefault(name, zeros([1]))
        return _Handle(t)

    def get_output_names(self):
        return ["out"]

    def get_output_handle(self, name):
        # late-binding: reads the output of the most recent run()
        return _OutputHandle(self)

    # ---- execution ---------------------------------------------------
    def _bucketize(self, args):
        """Pad the BATCH dim (the first input's leading dim) up to the
        bucket ladder. Only inputs sharing that batch size are padded —
        side inputs pass through untouched. Returns (args, true_batch,
        padded_batch); (args, None, None) means no padding happened."""
        buckets = self._config._buckets
        if not buckets or not args or args[0]._data.dim() == 0:
            return args, None, None
        batch = args[0].shape[0]
        tgt = next((k for k in buckets if k >= batch), buckets[-1])
        if tgt <= batch:
            return args, None, None
        out = []
        for a in args:
            if a.shape[0] == batch:
                d = a._data
                pad = d.new_zeros((tgt - batch,) + tuple(d.shape[1:]))
                out.append(Tensor._wrap(torch.cat([d, pad]), True))
            else:
                out.append(a)
        return out, batch, tgt

    def _batch_output_flags(self, args):
        """Per-output batch relationship, probed on fake tensors at two
        batch sizes (no execution, no compile):
          True  — dim0 IS the batch (safe to pad + trim)
          False — dim0 is batch-independent (pass through)
          "affine" — dim0 depends on the batch but is not equal to it
                     (e.g. 2*B): bucketing must be skipped entirely
        None when the model cannot be run on fake tensors."""
        batch0 = args[0].shape[0] if args and args[0]._data.dim() else None
        key = tuple(
            (("B",) + tuple(a._data.shape[1:])
             if a._data.dim() and a.shape[0] == batch0
             else tuple(a._data.shape), a._data.dtype)
            for a in args)
        if key in self._flag_cache:
            return self._flag_cache[key]
        batch = args[0].shape[0]

        def shapes_at(b):
            from torch._subclasses.fake_tensor import FakeTensorMode
            from ..jit import _tracing
            with FakeTensorMode(allow_non_fake_inputs=True), \
                    no_grad(), _tracing():
                xs = []
                for a in args:
                    shp = list(a._data.shape)
                    if shp and shp[0] == batch:
                        shp[0] = b
                    xs.append(Tensor._wrap(torch.empty(
                        shp, dtype=a._data.dtype, device=a._data.device)))
                o = self._layer(*xs)
                o = [o] if isinstance(o, Tensor) else list(o)
                return [tuple(t._data.shape) for t in o]

        try:
            b1, b2 = max(batch, 1), max(batch, 1) + 1
            s1 = shapes_at(b1)
            s2 = shapes_at(b2)
            flags = []
            for a, b in zip(s1, s2):
                d1 = a[0] if a else None
                d2 = b[0] if b else None
                if d1 == d2:
                    flags.append(False)
                elif (d1, d2) == (b1, b2):
                    flags.append(True)
                else:
                    flags.append("affine")
        except Exception:
            flags = None                # fall back to the heuristic
        self._flag_cache[key] = flags
        return flags

    def _ensure_compiled(self):
        if self._compiled is None:
            self._layer.eval()
            if self._translated():
                self._compiled = self._layer
            else:
                from ..jit import to_static
                layer = self._layer
                self._compiled = to_static(
                    lambda *xs: layer(*xs), objs=[layer], donate=False)

    def warmup(self, shapes: Sequence[Sequence[int]],
               dtype="float32"):
        """Precompile the graph ladder for the given input shapes
        (serving cold-start elimination; with bucketing, pass one shape
        per bucket)."""
        from ..ops.creation import zeros
        for shape in shapes:
            self.run([zeros(list(shape), dtype=dtype)])
            self.stats["warmup_shapes"].append(tuple(shape))
        return self

    def run(self, inputs: Optional[List[Tensor]] = None):
        outs = self._run_impl(inputs, block=True)
        self._last_out = outs[0]
        return outs

    def _run_impl(self, inputs, block, record=True):
        args = inputs if inputs is not None else \
            list(self._inputs.values())
        args = [a if isinstance(a, Tensor) else Tensor(a) for a in args]
        if self._config._precision is not None and not self._translated():
            # a TranslatedLayer's program has frozen input dtypes — the
            # precision pass does not apply to it
            dt = self._config._precision.torch
            args = [Tensor._wrap(a._data.to(dt), True)
                    if a._data.is_floating_point() else a for a in args]
        buckets = self._config._buckets
        flags = self._batch_output_flags(args) if buckets and args \
            else None
        # any batch-dependent-but-not-batch output (dim0 = 2B etc.)
        # cannot be padded-and-trimmed NOR chunked: run unbucketed. A
        # failed probe (flags None) also skips bucketing.
        bucketable = (not buckets or not args) if flags is None else \
            not any(f == "affine" for f in flags)
        if buckets and args and bucketable \
                and args[0].shape[0] > buckets[-1]:
            # bigger than the top bucket: chunk into top-bucket pieces so
            # the graph count stays bounded by the ladder. Valid only when
            # every output carries the batch.
            if flags is not None and all(f is True for f in flags):
                top = buckets[-1]
                batch = args[0].shape[0]
                t0 = time.perf_counter()
                pieces = []
                for lo in range(0, batch, top):
                    part = [Tensor._wrap(a._data[lo:lo + top], True)
                            if a.shape[0] == batch else a for a in args]
                    # inner calls don't touch stats — this is ONE
                    # user-visible run
                    pieces.append(self._run_impl(part, block=False,
                                                 record=False))
                outs = [Tensor._wrap(
                    torch.cat([p[i]._data for p in pieces], 0), True)
                    for i in range(len(pieces[0]))]
                if block:
                    _sync(outs)
                if record:
                    self.stats["runs"] += 1
                    self.stats["last_latency_ms"] = \
                        (time.perf_counter() - t0) * 1e3
                return outs
        if bucketable:
            args, true_batch, padded = self._bucketize(args)
        else:
            true_batch = padded = None
        self._ensure_compiled()
        t0 = time.perf_counter()
        with no_grad():
            out = self._compiled(*args)
        outs = [out] if isinstance(out, Tensor) else list(out)
        if true_batch is not None:
            # trim ONLY the outputs whose leading dim tracks the batch
            outs = [Tensor._wrap(o._data[:true_batch], True)
                    if (flags[i] is True
                        if flags is not None and i < len(flags)
                        else o._data.dim() >= 1 and o.shape[0] == padded)
                    else o
                    for i, o in enumerate(outs)]
            self.stats["bucket_pad_total"] += 1
        if block:
            _sync(outs)
        if record:
            self.stats["runs"] += 1
            self.stats["last_latency_ms"] = \
                (time.perf_counter() - t0) * 1e3
        return outs

    def generate(self, input_ids, max_new_tokens=16, seed=0):
        """Serving generation over the fixed-capacity KV cache: needs
        Config.enable_decode and a layer implementing the
        init_cache/forward_with_cache contract (models/llama.py,
        models/gpt.py)."""
        if self._config._decode is None:
            raise RuntimeError("call Config.enable_decode(max_length) "
                               "before Predictor.generate")
        if not hasattr(self._layer, "forward_with_cache"):
            raise TypeError(
                "the served layer does not expose the decode contract "
                "(init_cache + forward_with_cache)")
        if getattr(self, "_decode_session", None) is None:
            self._decode_session = DecodeSession(self._layer,
                                                 **self._config._decode)
        t0 = time.perf_counter()
        out = self._decode_session.generate(input_ids, max_new_tokens,
                                            seed=seed)
        self.stats["runs"] += 1
        self.stats["last_latency_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def run_async(self, inputs: Optional[List[Tensor]] = None):
        """Dispatch without blocking (device work is queued); the
        returned future waits for it on .get()."""
        outs = self._run_impl(inputs, block=False)
        self._last_out = outs[0]
        return _Future(outs)

    def get_execution_stats(self):
        entry = self._compiled
        n_spec = graphs = 0
        if entry is not None and hasattr(entry, "specializations"):
            n_spec = sum(len(v) for v in
                         entry.specializations().values())
            graphs = sum(s.jitted._cache_size() for e in
                         entry._cache.values() for s in e["specs"])
        return dict(self.stats, executables=n_spec, compiled_graphs=graphs)


class _Future:
    def __init__(self, outs):
        self._outs = outs

    def done(self):
        return True                     # dispatch already queued

    def get(self):
        _sync(self._outs)
        return self._outs


class _OutputHandle:
    """Handle bound to a predictor's latest output (valid after run())."""

    def __init__(self, predictor: "Predictor"):
        self._p = predictor

    def copy_to_cpu(self):
        if self._p._last_out is None:
            raise RuntimeError("no output yet: call Predictor.run() first")
        return self._p._last_out.numpy()

    def shape(self):
        if self._p._last_out is None:
            raise RuntimeError("no output yet: call Predictor.run() first")
        return self._p._last_out.shape


class _Handle:
    """Zero-copy tensor handle parity (reference ZeroCopyTensor)."""

    def __init__(self, t: Tensor):
        self._t = t

    def reshape(self, shape):
        self._t._assign_array(self._t._data.new_zeros(tuple(shape)))

    def copy_from_cpu(self, arr):
        self._t._assign_array(dtype_mod.from_numpy(np.asarray(arr)).to(
            self._t._data.device))

    def share_external_data(self, arr):
        """Adopt an existing device tensor WITHOUT a copy (reference
        share_external_data zero-copy path)."""
        if isinstance(arr, Tensor):
            self._t._assign_array(arr._data)
        elif isinstance(arr, torch.Tensor):
            self._t._assign_array(arr)
        else:
            self._t._assign_array(torch.as_tensor(np.asarray(arr)))

    def copy_to_cpu(self):
        return self._t.numpy()

    def shape(self):
        return self._t.shape


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


# ---------------------------------------------------------------------
# Int8-native serving (consumes the _int8_payload the PTQ pass records)
# ---------------------------------------------------------------------

class Int8Linear(_nn.Layer):
    """Weight-only-int8 serving Linear: memory holds the int8 payload +
    per-output-channel scales; dequantization happens at the matmul edge
    inside the forward (reference: the int8 weight-only path of
    analysis_predictor's quant passes)."""

    def __init__(self, weight_q, weight_scale, bias=None,
                 compute_dtype="float32"):
        super().__init__()
        self._compute_dtype = dtype_mod.convert_dtype(compute_dtype)
        wq = weight_q if isinstance(weight_q, Tensor) else \
            Tensor(np.asarray(weight_q, np.int8))
        sc = weight_scale if isinstance(weight_scale, Tensor) else \
            Tensor(np.asarray(weight_scale, np.float32))
        self.register_buffer("weight_q", wq)
        self.register_buffer("weight_scale", sc)
        self.bias = None
        if bias is not None:
            self.bias = bias if isinstance(bias, Tensor) else Tensor(bias)

    def forward(self, x):
        cdt = self._compute_dtype.torch

        def f(a, wq, sc, *rest):
            w = wq.to(cdt) * sc.reshape(1, -1).to(cdt)
            out = a.to(cdt) @ w
            if rest:
                out = out + rest[0]
            return out
        args = [x, self.weight_q, self.weight_scale]
        if self.bias is not None:
            args.append(self.bias)
        return run_op("int8_linear", f, *args, differentiable=False)


def apply_int8_rewrite(layer, compute_dtype="float32"):
    """Swap every Linear carrying an _int8_payload for an Int8Linear
    holding the int8 buffer natively. Returns the count swapped."""
    from ..nn.layer.common import Linear as _Linear
    n = 0
    for name, sub in list(layer._sub_layers.items()):
        if isinstance(sub, _Linear) and \
                getattr(sub.weight, "_int8_payload", None) is not None:
            q, scale = sub.weight._int8_payload
            dev = sub.weight._data.device
            layer._sub_layers[name] = Int8Linear(
                Tensor._wrap(torch.as_tensor(np.asarray(q, np.int8),
                                             device=dev)),
                Tensor._wrap(torch.as_tensor(
                    np.asarray(scale, np.float32).reshape(-1), device=dev)),
                bias=sub.bias, compute_dtype=compute_dtype)
            n += 1
        else:
            n += apply_int8_rewrite(sub, compute_dtype)
    return n


def save_int8_model(predictor: Predictor, path: str):
    """Write the int8-native serving artifact: one npz holding each
    quantized Linear's (int8 payload, scales) plus every other state
    tensor in fp. Load with `load_int8_model(layer, path)`."""
    layer = predictor._layer
    if not predictor._config._int8_weights:
        raise ValueError("enable_int8_weight_only() first: the int8 "
                         "payload is recorded by that pass")
    entries = {}
    for name, p in layer.named_parameters():
        payload = getattr(p, "_int8_payload", None)
        if payload is not None:
            q, scale = payload
            entries[name + ".int8"] = np.asarray(q, np.int8)
            entries[name + ".scale"] = np.asarray(scale,
                                                  np.float32).reshape(-1)
        else:
            entries[name] = p.numpy()
    for name, b in layer.named_buffers():
        entries["buffer:" + name] = b.numpy()
    np.savez(path, **entries)


def load_int8_model(layer, path: str, compute_dtype="float32"):
    """Restore an int8 serving artifact into a freshly-built layer:
    quantized Linears are swapped to Int8Linear (int8 stays int8 in
    memory), everything else is loaded as saved."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    int8_weights = {k[:-len(".int8")]: data[k] for k in data.files
                    if k.endswith(".int8")}
    scales = {k[:-len(".scale")]: data[k] for k in data.files
              if k.endswith(".scale")}
    for name, p in layer.named_parameters():
        if name in int8_weights:
            # restore QDQ numerics for every quantized param; Linear
            # weights are then swapped to int8-native storage below
            # (non-Linear quantized params, e.g. embeddings, serve the
            # dequantized values — same numerics, fp storage)
            q, sc = int8_weights[name], scales[name]
            ax = -1 if q.ndim == 2 else 0
            shape = [1] * q.ndim
            shape[ax % q.ndim] = -1
            deq = q.astype(np.float32) * sc.reshape(shape)
            p.set_value(deq)
            p._int8_payload = (q, sc)
        elif name in data.files:
            p.set_value(data[name])
    for name, b in layer.named_buffers():
        key = "buffer:" + name
        if key in data.files:
            b.set_value(data[key])
    apply_int8_rewrite(layer, compute_dtype)
    return layer
