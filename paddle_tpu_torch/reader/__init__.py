"""paddle.reader — reader-composition decorators (reference:
python/paddle/reader/decorator.py), the port of ``paddle_tpu/reader``:
pure-Python generator combinators feeding the host input pipeline."""
from .decorator import (  # noqa: F401
    buffered, cache, chain, compose, ComposeNotAligned, firstn,
    map_readers, multiprocess_reader, shuffle, xmap_readers,
)

__all__ = []
