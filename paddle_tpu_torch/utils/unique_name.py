"""paddle.utils.unique_name: the port of
``paddle_tpu/utils/unique_name.py``."""
from __future__ import annotations

import contextlib
from collections import defaultdict

_COUNTERS = defaultdict(int)


def generate(key="tmp"):
    _COUNTERS[key] += 1
    return f"{key}_{_COUNTERS[key] - 1}"


def switch(new_generator=None):
    global _COUNTERS
    old = _COUNTERS
    _COUNTERS = new_generator if new_generator is not None \
        else defaultdict(int)
    return old


@contextlib.contextmanager
def guard(new_generator=None):
    old = switch(new_generator)
    try:
        yield
    finally:
        switch(old)
