"""paddle.signal: the port of ``paddle_tpu/signal.py`` (frame, overlap_add,
stft, istft over ``torch.fft``)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as tF

from .core.dispatch import run_op
from .core.tensor import Tensor


def _t(x):
    return x if isinstance(x, Tensor) else Tensor(x)


def _frame_index(n, frame_length, hop_length, device):
    num = 1 + (n - frame_length) // hop_length
    idx = (np.arange(frame_length)[None, :]
           + hop_length * np.arange(num)[:, None])
    return torch.as_tensor(idx, device=device)


def frame(x, frame_length, hop_length, axis=-1, name=None):
    def f(a):
        moved = a.movedim(axis, -1)
        idx = _frame_index(moved.shape[-1], frame_length, hop_length,
                           a.device)
        return moved[..., idx].transpose(-1, -2)  # [..., frame_length, num]
    return run_op("frame", f, _t(x))


def _overlap(frames, hop, n):
    """Sum frames [..., num, L] into a signal of length n at stride hop."""
    num, length = frames.shape[-2], frames.shape[-1]
    out = frames.new_zeros(frames.shape[:-2] + (n,))
    for i in range(num):
        out = out + tF.pad(frames[..., i, :],
                           (i * hop, n - i * hop - length))
    return out


def overlap_add(x, hop_length, axis=-1, name=None):
    def f(a):
        # a: [..., frame_length, num_frames]
        frame_length, num = a.shape[-2], a.shape[-1]
        n = frame_length + hop_length * (num - 1)
        return _overlap(a.transpose(-1, -2), hop_length, n)
    return run_op("overlap_add", f, _t(x))


def _pad_window(w, wl, n_fft):
    if wl < n_fft:
        lpad = (n_fft - wl) // 2
        w = tF.pad(w, (lpad, n_fft - wl - lpad))
    return w


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft
    mode = {"reflect": "reflect", "constant": "constant",
            "edge": "replicate", "replicate": "replicate"}[pad_mode]

    def f(a, *maybe_win):
        sig = a
        if center:
            lead = sig.shape[:-1]
            sig = tF.pad(sig.reshape(-1, 1, sig.shape[-1]),
                         (n_fft // 2, n_fft // 2), mode=mode)
            sig = sig.reshape(lead + (sig.shape[-1],))
        frames = sig[..., _frame_index(sig.shape[-1], n_fft, hop, a.device)]
        if maybe_win:
            frames = frames * _pad_window(maybe_win[0], wl, n_fft)
        spec = torch.fft.rfft(frames, dim=-1) if onesided \
            else torch.fft.fft(frames, dim=-1)
        if normalized:
            spec = spec / math.sqrt(n_fft)
        return spec.transpose(-1, -2)            # [..., freq, num_frames]
    if window is not None:
        return run_op("stft", f, _t(x), _t(window))
    return run_op("stft", f, _t(x))


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    hop = hop_length or n_fft // 4
    wl = win_length or n_fft

    def f(spec, *maybe_win):
        s = spec.transpose(-1, -2)               # [..., frames, freq]
        if normalized:
            s = s * math.sqrt(n_fft)
        frames = torch.fft.irfft(s, n=n_fft, dim=-1) if onesided \
            else torch.fft.ifft(s, dim=-1).real
        w = _pad_window(maybe_win[0], wl, n_fft) if maybe_win \
            else torch.ones((n_fft,), dtype=frames.dtype,
                            device=frames.device)
        frames = frames * w
        num = frames.shape[-2]
        n = n_fft + hop * (num - 1)
        out = _overlap(frames, hop, n)
        wsum = _overlap((w * w).expand(num, n_fft), hop, n)
        out = out / torch.clamp_min(wsum, 1e-11)
        if center:
            out = out[..., n_fft // 2:]
            out = out[..., :length] if length is not None \
                else out[..., : n - n_fft]
        elif length is not None:
            out = out[..., :length]
        return out
    if window is not None:
        return run_op("istft", f, _t(x), _t(window))
    return run_op("istft", f, _t(x))
