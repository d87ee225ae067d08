"""paddle.audio: the port of ``paddle_tpu/audio`` (reference
python/paddle/audio): the mel and window functional, the feature layers,
wav IO and the datasets."""
from __future__ import annotations

from . import backends  # noqa: F401
from . import datasets  # noqa: F401
from . import features  # noqa: F401
from . import functional  # noqa: F401
from .backends import info, load, save  # noqa: F401

__all__ = ["functional", "features", "datasets", "backends", "load",
           "info", "save"]
