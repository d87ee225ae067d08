"""paddle.framework: save / load (framework/io.py)."""
from .io import load, save  # noqa: F401
