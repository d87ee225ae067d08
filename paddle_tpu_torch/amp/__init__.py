"""AMP: the port of ``paddle_tpu/amp/__init__.py`` (reference:
python/paddle/amp — auto_cast :1014, decorate :1099, GradScaler
grad_scaler.py:645, op lists amp_lists.py:33).

bf16 first (no loss scaling needed), fp16 supported for parity. The
auto-cast hook plugs into eager dispatch (``core/dispatch.py``'s
``set_amp_hook``), where ``run_op`` passes it each op's name and its input
tensors before the op runs; the casts it makes are recorded by torch's
autograd, so gradients come back in each leaf's own dtype.

The port's ``GradScaler`` unscales the gradients in place (the reference
rebinds each gradient to a new array). Inside a compiled step
(``jit.to_static``) it reads nothing back: the update is computed and then
kept or dropped with a device-side select on ``found_inf``, and the scale,
the good/bad step counts and ``found_inf`` are device state that the step
threads (``_trace_state``); the host reads them back when asked.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import dispatch as _dispatch
from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.flags import define_flag, get_flag
from ..core.tensor import Tensor, tracing

define_flag("FLAGS_low_precision_op_list", False,
            "record op names auto-cast by AMP; read with "
            "paddle.amp.debugging.get_low_precision_op_list()")

# ---- op lists (reference amp_lists.py / imperative/amp_auto_cast.h) -------
WHITE_LIST = {
    "matmul", "linear", "bmm", "mm", "mv", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "scaled_dot_product_attention", "flash_attn_unpadded",
}
BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "std",
    "var", "cos_sim", "softmax", "log_softmax", "cross_entropy",
    "softmax_with_cross_entropy", "sigmoid_focal_loss", "bce", "bce_logits",
    "layer_norm", "rms_norm", "batch_norm", "batch_norm_infer", "norm",
    "cumsum", "logsumexp", "erfinv", "pow", "logcumsumexp", "kl_div",
    "l1_loss", "mse_loss", "nll_loss", "smooth_l1_loss", "huber_loss",
    "linspace", "prod", "acos", "asin", "cosh", "sinh", "tan", "atanh",
    "acosh", "asinh",
}


class _AmpState:
    def __init__(self):
        self.enabled = False
        self.level = "O0"
        self.dtype = dtype_mod.bfloat16
        self.custom_white = set()
        self.custom_black = set()


_STATE = _AmpState()

# "op->dtype" -> count, while FLAGS_low_precision_op_list is on
_LOW_PRECISION_OPS = {}


def _record_low_precision(name, dt):
    if get_flag("FLAGS_low_precision_op_list"):
        key = f"{name}->{dtype_mod.from_torch(dt).name}"
        _LOW_PRECISION_OPS[key] = _LOW_PRECISION_OPS.get(key, 0) + 1


def _cast_to(arrays, dt):
    """Every floating tensor but float64 cast to ``dt``."""
    return [a.to(dt) if a.is_floating_point() and a.dtype != torch.float64
            and a.dtype != dt else a for a in arrays]


def _amp_hook(name, arrays):
    st = _STATE
    if not st.enabled or st.level == "O0":
        return arrays
    white = (WHITE_LIST | st.custom_white) - st.custom_black
    black = (BLACK_LIST | st.custom_black) - st.custom_white
    target = st.dtype.torch

    if name in white:
        _record_low_precision(name, target)
        return _cast_to(arrays, target)
    if name in black:
        return _cast_to(arrays, torch.float32)
    if st.level == "O2":
        _record_low_precision(name, target)
        return _cast_to(arrays, target)
    # O1 gray list: promote to the widest float among the inputs
    f_dtypes = {a.dtype for a in arrays if a.is_floating_point()}
    if len(f_dtypes) > 1:
        return _cast_to(arrays, torch.float32 if torch.float32 in f_dtypes
                        else target)
    return arrays


_dispatch.set_amp_hook(_amp_hook)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast (amp/auto_cast.py:1014)."""
    st = _STATE
    prev = (st.enabled, st.level, st.dtype, st.custom_white, st.custom_black)
    st.enabled = enable
    st.level = level if enable else "O0"
    st.dtype = dtype_mod.convert_dtype(dtype)
    st.custom_white = set(custom_white_list or ())
    st.custom_black = set(custom_black_list or ())
    try:
        yield
    finally:
        (st.enabled, st.level, st.dtype, st.custom_white,
         st.custom_black) = prev


amp_guard = auto_cast


def is_auto_cast_enabled():
    return _STATE.enabled


def get_amp_dtype():
    return "bfloat16" if _STATE.dtype == dtype_mod.bfloat16 else "float16"


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False):
    """paddle.amp.decorate (auto_cast.py:1099): O2 casts the model params
    to the AMP dtype (the same Parameter objects, so an optimizer built
    before keeps them); the optimizer gets fp32 master weights, made from
    the cast values at its first step."""
    d = dtype_mod.convert_dtype(dtype)
    model_list = models if isinstance(models, (list, tuple)) else [models]
    if level == "O2":
        for m in model_list:
            m.astype(d)
        if optimizers is not None:
            opt_list = optimizers if isinstance(optimizers, (list, tuple)) \
                else [optimizers]
            for opt in opt_list:
                opt._multi_precision = True if master_weight is None \
                    else master_weight
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Loss scaling (reference amp/grad_scaler.py:645 and the device-side
    check_finite_and_unscale / update_loss_scaling kernels,
    phi/kernels/amp_kernel.h:25). The scale is an f32 scalar on the
    default device; ``step`` reads ``found_inf`` back to the host once."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 16,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=2000,
                 decr_every_n_nan_or_inf=1, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = Tensor._wrap(torch.tensor(
            init_loss_scaling, dtype=torch.float32,
            device=place_mod.default_device()))
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False
        self._last_skipped = False
        # device state of compiled steps: [good, bad] counts and found_inf
        self._counts = None
        self._found_dev = None
        self._dev_fresh = False

    def is_enable(self):
        return self._enable

    def _trace_state(self):
        """The tensors a compiled step threads: the scale, the counts and
        found_inf (made from the host values on first use)."""
        dev = self._scale._data.device
        if self._counts is None:
            self._counts = Tensor._wrap(torch.tensor(
                [self._good_steps, self._bad_steps], dtype=torch.int64,
                device=dev))
            self._found_dev = Tensor._wrap(torch.tensor(
                self._found_inf, device=dev))
        return [self._scale, self._counts, self._found_dev]

    def _compiled_step_ran(self):
        """Called by jit after a compiled call: the device state is newer
        than the host's copy."""
        self._dev_fresh = True

    def _sync_host(self):
        if self._dev_fresh:
            self._dev_fresh = False
            self._good_steps, self._bad_steps = self._counts._data.tolist()
            self._found_inf = bool(self._found_dev._data)
            self._last_skipped = self._found_inf

    def _sync_device(self):
        if self._counts is not None:
            with torch.no_grad():
                self._counts._data.copy_(torch.tensor(
                    [self._good_steps, self._bad_steps]))
                self._found_dev._data.fill_(self._found_inf)

    @property
    def found_inf(self):
        self._sync_host()
        return self._found_inf

    def last_step_skipped(self):
        """True when the most recent ``step()`` skipped the optimizer
        update because check_finite_and_unscale found non-finite grads."""
        self._sync_host()
        return self._enable and self._last_skipped

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return Tensor._wrap(self._scale._data)

    def set_init_loss_scaling(self, v):
        self._scale._assign_array(torch.tensor(
            v, dtype=torch.float32, device=self._scale._data.device))

    def scale(self, var):
        if not self._enable:
            return var
        return _dispatch.run_op("scale_loss",
                                lambda a, sc: a * sc.to(a.dtype), var,
                                self._scale)

    @torch.no_grad()
    def _unscale(self, optimizer):
        """check_finite_and_unscale (amp_kernel.h:25) over all grads, each
        written in place in its own dtype."""
        if not self._enable or self._unscaled:
            return
        inv = 1.0 / self._scale._data
        found = torch.zeros((), dtype=torch.bool, device=inv.device)
        for p in optimizer._parameter_list:
            if p.grad is None:
                continue
            g = p.grad._data
            g32 = g.float() * inv
            found |= ~torch.isfinite(g32).all()
            g.copy_(g32)
        if tracing():
            if self._found_dev is None:
                raise RuntimeError(
                    "a GradScaler used in a compiled step must be among "
                    "the step's objs (to_static(fn, objs=[..., scaler]))")
            self._found_dev._assign_array(found)
        else:
            self._sync_host()
            self._found_inf = bool(found)
        self._unscaled = True

    def unscale_(self, optimizer):
        return self._unscale(optimizer)

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)
        self.update()

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self._unscale(optimizer)
        if tracing():
            self._select_step(optimizer)
        else:
            self._last_skipped = self._found_inf
            if not self._found_inf:
                optimizer.step()
        self._unscaled = False

    @torch.no_grad()
    def _select_step(self, optimizer):
        """The traced step: the update is computed, then every tensor it
        wrote keeps its old value where found_inf is set."""
        found = self._found_dev._data
        state = list(optimizer._parameter_list) + optimizer._state_tensors()
        before = [t._data.detach().clone() for t in state]
        optimizer.step()
        for t, old in zip(state, before):
            t._data.copy_(torch.where(found, old, t._data))

    def _select_update(self):
        """update_loss_scaling on the device, for a traced step."""
        found = self._found_dev._data
        s = self._scale._data
        good, bad = self._counts._data[0], self._counts._data[1]
        bad = torch.where(found, bad + 1, 0)
        good = torch.where(found, 0, good + 1)
        dec = found & (bad >= self._decr_every)
        inc = ~found & (good >= self._incr_every)
        self._scale._assign_array(torch.where(
            dec, torch.clamp(s * self._decr_ratio, min=1.0),
            torch.where(inc, s * self._incr_ratio, s)))
        self._counts._assign_array(torch.stack(
            [torch.where(inc, 0, good), torch.where(dec, 0, bad)]))

    def update(self):
        """update_loss_scaling (amp_kernel.h:32)."""
        if not (self._enable and self._dynamic):
            return
        if tracing():
            self._select_update()
            return
        self._sync_host()
        s = self._scale._data
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale._assign_array(
                    torch.clamp(s * self._decr_ratio, min=1.0))
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale._assign_array(s * self._incr_ratio)
                self._good_steps = 0
        self._sync_device()

    def state_dict(self):
        self._sync_host()
        return {
            "scale": self._scale._data.cpu().numpy(),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_count": self._good_steps,
            "decr_count": self._bad_steps,
        }

    def load_state_dict(self, sd):
        self._scale._assign_array(torch.tensor(
            np.asarray(sd["scale"]), dtype=torch.float32,
            device=self._scale._data.device))
        self._dev_fresh = False
        self._good_steps = sd.get("incr_count", 0)
        self._bad_steps = sd.get("decr_count", 0)
        self._sync_device()


AmpScaler = GradScaler


def is_bfloat16_supported(device=None):
    return True


def is_float16_supported(device=None):
    """Where the default place is the card (the reference: where jax's
    default backend is not the CPU)."""
    return place_mod.default_device().type == "cuda"
