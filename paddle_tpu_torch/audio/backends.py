"""paddle.audio.backends: the port of ``paddle_tpu/audio/backends.py``
(reference python/paddle/audio/backends): wav IO with the standard
library's ``wave`` module (the reference's soundfile backend is optional
there too)."""
from __future__ import annotations

import wave as _wave
from dataclasses import dataclass

import numpy as np

from ..core.tensor import Tensor


@dataclass
class AudioInfo:
    sample_rate: int
    num_samples: int
    num_channels: int
    bits_per_sample: int
    encoding: str = "PCM_S"


def list_available_backends():
    return ["wave"]


def get_current_backend():
    return "wave"


def set_backend(backend_name):
    if backend_name != "wave":
        raise ValueError("only the built-in 'wave' backend is available")


def info(filepath, format=None):
    with _wave.open(filepath, "rb") as w:
        return AudioInfo(w.getframerate(), w.getnframes(), w.getnchannels(),
                         w.getsampwidth() * 8)


def load(filepath, frame_offset=0, num_frames=-1, normalize=True,
         channels_first=True, format=None):
    with _wave.open(filepath, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        w.setpos(frame_offset)
        count = n - frame_offset if num_frames < 0 else num_frames
        raw = w.readframes(count)
    dt = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    data = np.frombuffer(raw, dt).reshape(-1, ch)
    if normalize:
        if width == 1:
            data = (data.astype(np.float32) - 128) / 128.0
        else:
            data = data.astype(np.float32) / float(2 ** (8 * width - 1))
    arr = data.T if channels_first else data
    return Tensor(np.ascontiguousarray(arr)), sr


def save(filepath, src, sample_rate, channels_first=True,
         encoding="PCM_S", bits_per_sample=16, format=None):
    arr = np.asarray(src.numpy() if isinstance(src, Tensor) else src)
    if channels_first:
        arr = arr.T
    if arr.dtype in (np.float32, np.float64):
        arr = np.clip(arr, -1.0, 1.0)
        arr = (arr * (2 ** (bits_per_sample - 1) - 1)).astype(
            {8: np.uint8, 16: np.int16, 32: np.int32}[bits_per_sample])
    with _wave.open(filepath, "wb") as w:
        w.setnchannels(arr.shape[1] if arr.ndim > 1 else 1)
        w.setsampwidth(bits_per_sample // 8)
        w.setframerate(sample_rate)
        w.writeframes(arr.tobytes())


__all__ = ["info", "load", "save", "list_available_backends",
           "get_current_backend", "set_backend"]
