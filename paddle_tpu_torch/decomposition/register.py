"""Decomposition-rule registry (reference: decomposition/register.py)."""
from __future__ import annotations

_rules = {}


def register_decomp(op_name):
    """Decorator: register fn as the primitive decomposition of op_name."""

    def wrap(fn):
        _rules[op_name] = fn
        return fn

    return wrap


def get_decomp_rule(op_name):
    return _rules.get(op_name)


def has_decomp_rule(op_name):
    return op_name in _rules
