"""paddle.pir_utils equivalent (reference: python/paddle/pir_utils.py —
guards that flip between old-IR and PIR program modes).

The port has a single IR path (traced FX graphs), so the guards
are no-op context managers kept for API compatibility with code that
wraps itself in IrGuard/OldIrGuard."""
from __future__ import annotations

import contextlib
import functools


class IrGuard:
    """reference pir_utils.py IrGuard: ensure-PIR-mode guard."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class OldIrGuard(IrGuard):
    """Legacy-IR guard; single-IR here, so equally a no-op."""


@contextlib.contextmanager
def DygraphPirGuard():
    yield


def test_with_pir_api(fn):
    """Decorator used throughout reference tests to run both IR modes;
    one IR here, so runs once."""

    @functools.wraps(fn)
    def impl(*args, **kwargs):
        return fn(*args, **kwargs)

    return impl


def test_with_dygraph_pir(fn):
    return test_with_pir_api(fn)
