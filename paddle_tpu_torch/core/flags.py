"""Runtime flag registry: the port's own copy of ``paddle_tpu/core/flags.py``
(``define_flag``, ``get_flag``, ``set_flags``, with the ``FLAGS_*``
environment override at definition time).

Each module defines the flags it reads (``FLAGS_attn_autotune`` in
``ops/hopper/autotune.py``). The reference's observers, which push a flag
into jax's configuration when it is set, have no counterpart here.
"""
from __future__ import annotations

import os
from typing import Any, Dict

# name -> [value, type of the default]
_REGISTRY: Dict[str, list] = {}


def _coerce(ty, raw):
    if ty is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return ty(raw)


def define_flag(name: str, default, help: str = ""):
    """Registers ``name`` (``help`` documents it at the call site); the
    environment variable of the same name overrides the default."""
    ty = type(default)
    raw = os.environ.get(name)
    value = _coerce(ty, raw) if raw is not None else default
    _REGISTRY[name] = [value, ty]
    return value


def get_flag(name: str):
    return _REGISTRY[name][0]


def set_flags(flags: Dict[str, Any]):
    for name, v in flags.items():
        if name not in _REGISTRY:
            raise KeyError(f"unknown flag {name!r}")
        entry = _REGISTRY[name]
        entry[0] = _coerce(entry[1], v)
