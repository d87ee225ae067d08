"""paddle.decomposition (reference: python/paddle/decomposition —
decompose() rewrites composite PIR ops into the primitive set for
higher-order AD and the compiler).

Port of ``paddle_tpu/decomposition``: the API surface, the prim switches
(which ``incubate.autograd``'s ``enable_prim``/``disable_prim`` set) and an
inspectable rule registry of decompositions of composite ops (softmax,
layer_norm, gelu, ...) written over primitive torch ops."""
from .register import register_decomp, get_decomp_rule, has_decomp_rule
from . import rules  # noqa: F401  (populates the registry)
from .decomp import decompose, prim_guard, enable_prim, prim_enabled

__all__ = [
    "decompose", "register_decomp", "get_decomp_rule", "has_decomp_rule",
    "prim_guard", "enable_prim", "prim_enabled",
]
