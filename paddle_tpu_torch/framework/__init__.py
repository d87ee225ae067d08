"""paddle.framework: save / load (framework/io.py), the core shim
(framework/core.py, loaded on first use) and the default dtype."""
from .io import load, save  # noqa: F401


def get_default_dtype():
    from ..core.dtype import get_default_dtype as g
    return g()


def set_default_dtype(d):
    from ..core.dtype import set_default_dtype as s
    return s(d)


def in_dynamic_mode():
    return True


def __getattr__(name):
    if name == "core":
        import importlib
        return importlib.import_module(f"{__name__}.core")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
