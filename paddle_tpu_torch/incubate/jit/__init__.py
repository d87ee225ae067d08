"""incubate.jit on torch: the port of ``paddle_tpu/incubate/jit`` (reference
python/paddle/incubate/jit/: the ``inference`` decorator compiles a Layer's
forward or a function for fast repeated inference).

The reference rewrites the function into a Predictor with TensorRT
options; here the decorator lowers onto the one compile path —
``paddle_tpu_torch.jit.to_static`` under no_grad — whose executable caches a
compiled graph per input shape. The backend-tuning keywords are accepted and
ignored."""
from __future__ import annotations

import functools

__all__ = ["inference"]


def inference(function=None, cache_static_model=False,
              save_model_dir=None, memory_pool_init_size_mb=1000,
              precision_mode="float32", switch_ir_optim=True,
              switch_ir_debug=False, enable_cinn=False,
              with_trt=False, trt_precision_mode="float32",
              trt_use_static=False, collect_shape=False,
              enable_new_ir=False, exp_enable_use_cutlass=False,
              delete_pass_lists=None, skip_prune_program=False):
    """Decorator: compile `function` (or a Layer's forward) for
    inference (reference incubate/jit/inference_decorator.py)."""
    def wrap(fn):
        from ...autograd import no_grad
        from ...jit import to_static

        forward = fn.forward if hasattr(fn, "forward") else fn
        objs = [fn] if hasattr(fn, "forward") else None
        compiled = to_static(forward, objs=objs, donate=False)

        @functools.wraps(forward)
        def runner(*args, **kwargs):
            with no_grad():
                return compiled(*args, **kwargs)

        if hasattr(fn, "forward"):
            fn.forward = runner
            return fn
        return runner

    if function is not None:
        return wrap(function)
    return wrap
