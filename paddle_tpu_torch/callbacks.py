"""paddle.callbacks namespace: the port of ``paddle_tpu/callbacks.py``
(reference: python/paddle/callbacks.py — re-export of the hapi callback
family)."""
from .hapi import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    ReduceLROnPlateau, VisualDL, WandbCallback,
)

__all__ = [
    'Callback', 'ProgBarLogger', 'ModelCheckpoint', 'VisualDL',
    'LRScheduler', 'EarlyStopping', 'ReduceLROnPlateau', 'WandbCallback',
]
