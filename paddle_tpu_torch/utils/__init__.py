"""paddle.utils: the port of ``paddle_tpu/utils/__init__.py``."""
from __future__ import annotations

import functools
import warnings

from . import unique_name  # noqa: F401
from . import cpp_extension  # noqa: F401


def deprecated(update_to="", since="", reason="", level=0):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **k):
            warnings.warn(
                f"{fn.__name__} is deprecated since {since}: {reason} "
                f"(use {update_to})", DeprecationWarning, stacklevel=2)
            return fn(*a, **k)
        return wrapper
    return deco


def run_check():
    """paddle.utils.run_check: a product and its backward on the current
    device; prints torch's name of that device."""
    import torch
    import paddle_tpu_torch as paddle
    x = paddle.randn([4, 4])
    x.stop_gradient = False
    (x @ x).sum().backward()
    if x.grad is None or not bool(torch.isfinite(x.grad._data).all()):
        raise RuntimeError("run_check: the backward gave no finite gradient")
    dev = x._data.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "cpu"
    print(f"paddle_tpu_torch is installed successfully! device={dev} "
          f"({name}), torch {torch.__version__}")
    return True


def try_import(name):
    import importlib
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def _is_namedtuple(x):
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(nest):
    """The leaves of a nest of lists, tuples and dicts, in jax's
    ``tree_leaves`` order (dict keys sorted; None holds no leaf)."""
    if nest is None:
        return []
    if isinstance(nest, dict):
        return [leaf for k in sorted(nest) for leaf in flatten(nest[k])]
    if isinstance(nest, (list, tuple)):
        return [leaf for x in nest for leaf in flatten(x)]
    return [nest]


def pack_sequence_as(structure, flat):
    """``flat``'s leaves in ``structure``'s nesting (jax's
    ``tree_unflatten`` of ``structure``'s tree)."""
    it = iter(flat)

    def build(s):
        if s is None:
            return None
        if isinstance(s, dict):
            built = {k: build(s[k]) for k in sorted(s)}
            return type(s)((k, built[k]) for k in s)
        if _is_namedtuple(s):
            return type(s)(*[build(x) for x in s])
        if isinstance(s, (list, tuple)):
            return type(s)(build(x) for x in s)
        return next(it)
    return build(structure)


def require_version(min_version, max_version=None):
    """reference utils/__init__ require_version: validate the installed
    framework version is within range."""
    from ..version import full_version

    def parse(v):
        return tuple(int(p) for p in str(v).split(".")[:3] if p.isdigit())

    cur = parse(full_version)
    if parse(min_version) > cur:
        raise Exception(
            f"paddle_tpu_torch version {full_version} < required "
            f"{min_version}")
    if max_version is not None and parse(max_version) < cur:
        raise Exception(
            f"paddle_tpu_torch version {full_version} > allowed "
            f"{max_version}")
    return True
