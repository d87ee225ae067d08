"""decompose() + prim-mode switches (reference: decomposition/decomp.py:193
decompose(program, src_vars); base prim flags)."""
from __future__ import annotations

import contextlib

_prim_enabled = False


def prim_enabled():
    return _prim_enabled


def enable_prim(flag=True):
    global _prim_enabled
    _prim_enabled = bool(flag)


@contextlib.contextmanager
def prim_guard():
    """reference decomp.py:40 prim_guard."""
    prev = _prim_enabled
    enable_prim(True)
    try:
        yield
    finally:
        enable_prim(prev)


def decompose(program, src_vars=None, blacklist=frozenset(),
              whitelist=frozenset()):
    """Decompose composite ops in a captured static Program into primitives
    (reference decomp.py:193). A program captured by the port's
    ``jit``/``static`` is a traced FX graph of aten ops, which the backend
    lowers further itself, so this keeps the reference's API: it returns
    the program (and the passed vars) unchanged, after validating any
    whitelist names against the rule registry."""
    from .register import has_decomp_rule
    for name in whitelist:
        if not has_decomp_rule(name):
            raise ValueError(f"no decomposition rule registered for "
                             f"{name!r}")
    if src_vars is None:
        return program
    return program, src_vars
