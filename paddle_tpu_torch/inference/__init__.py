"""paddle.inference on the port: the serving sessions over the
fixed-capacity KV cache (``decode``: ``DecodeSession``,
``ContinuousBatchingSession``, ``cached_generate``, the cache primitives)
and the request lifecycle (``admission``).

The reference's predictor surface (``Config``, ``Predictor``,
``create_predictor`` and the int8 weight-only export: ``Int8Linear``,
``apply_int8_rewrite``, ``save_int8_model``, ``load_int8_model``) is built
on ``jit.save``/``jit.load`` and waits for the ``jit/`` slice of the port
(ROADMAP queue 1); those names raise ``NotImplementedError``.
"""
from __future__ import annotations

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

_PREDICTOR = ("Config", "Predictor", "create_predictor", "Int8Linear",
              "apply_int8_rewrite", "save_int8_model", "load_int8_model")


def __getattr__(name):
    if name in _PREDICTOR:
        raise NotImplementedError(
            f"paddle_tpu_torch.inference.{name}: the predictor and the int8 "
            "export need jit.save/jit.load and wait for the jit/ slice of "
            "the port (ROADMAP queue 1)")
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
