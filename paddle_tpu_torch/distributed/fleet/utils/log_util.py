"""Distributed logging helpers: the port of
``paddle_tpu/distributed/fleet/utils/log_util.py`` (reference
fleet/utils/log_util.py)."""
from __future__ import annotations

import logging
import os
import sys

logger = logging.getLogger("paddle_tpu_torch.fleet")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(levelname)s %(asctime)s %(name)s: %(message)s"))
    logger.addHandler(_h)
try:
    logger.setLevel(os.environ.get("FLEET_LOG_LEVEL", "INFO").upper())
except ValueError:
    logger.setLevel("INFO")   # bad env value must not break imports


def set_log_level(level):
    """INFO/DEBUG/... by name or logging numeric code."""
    if isinstance(level, str):
        level = level.upper()
    logger.setLevel(level)


def get_log_level_code():
    return logger.getEffectiveLevel()


def get_log_level_name():
    return logging.getLevelName(get_log_level_code())


def layer_to_str(base, *args, **kwargs):
    """Format a layer construction call for debug dumps."""
    parts = [str(a) for a in args]
    parts += [f"{k}={v}" for k, v in kwargs.items()]
    return f"{base}({', '.join(parts)})"
