"""paddle.audio.functional: the port of ``paddle_tpu/audio/functional.py``
(reference python/paddle/audio/functional/{functional,window}.py): the mel
scale, the filterbank, the DCT matrix and the windows are host math in
numpy (tables made once), returned as tensors on the default device;
``power_to_db`` runs on its input's device."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dispatch import run_op
from ..core.tensor import Tensor


def hz_to_mel(freq, htk=False):
    scalar = isinstance(freq, (int, float))
    f = np.asarray(freq, np.float64) if not isinstance(freq, Tensor) \
        else np.asarray(freq.numpy())
    if htk:
        mel = 2595.0 * np.log10(1.0 + f / 700.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        mel = (f - f_min) / f_sp
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        mel = np.where(f >= min_log_hz,
                       min_log_mel + np.log(np.maximum(f, 1e-10)
                                            / min_log_hz) / logstep, mel)
    if scalar:
        return float(mel)
    return Tensor(mel.astype(np.float32)) if isinstance(freq, Tensor) \
        else mel


def mel_to_hz(mel, htk=False):
    scalar = isinstance(mel, (int, float))
    m = np.asarray(mel, np.float64) if not isinstance(mel, Tensor) \
        else np.asarray(mel.numpy())
    if htk:
        hz = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    else:
        f_min, f_sp = 0.0, 200.0 / 3
        hz = f_min + f_sp * m
        min_log_hz = 1000.0
        min_log_mel = (min_log_hz - f_min) / f_sp
        logstep = math.log(6.4) / 27.0
        hz = np.where(m >= min_log_mel,
                      min_log_hz * np.exp(logstep * (m - min_log_mel)), hz)
    if scalar:
        return float(hz)
    return Tensor(hz.astype(np.float32)) if isinstance(mel, Tensor) else hz


def mel_frequencies(n_mels=64, f_min=0.0, f_max=11025.0, htk=False,
                    dtype="float32"):
    mels = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                       n_mels)
    return Tensor(np.asarray(mel_to_hz(mels, htk), dtype))


def fft_frequencies(sr, n_fft, dtype="float32"):
    return Tensor(np.linspace(0, sr / 2, 1 + n_fft // 2).astype(dtype))


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney", dtype="float32"):
    """Triangular mel filterbank [n_mels, 1+n_fft//2] (reference
    compute_fbank_matrix)."""
    f_max = f_max or sr / 2.0
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    melpts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                         n_mels + 2)
    hzpts = np.asarray(mel_to_hz(melpts, htk))
    fdiff = np.diff(hzpts)
    ramps = hzpts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hzpts[2:n_mels + 2] - hzpts[:n_mels])
        weights *= enorm[:, None]
    return Tensor(weights.astype(dtype))


def create_dct(n_mfcc, n_mels, norm="ortho", dtype="float32"):
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    dct = np.cos(np.pi / n_mels * (n + 0.5) * k)
    if norm == "ortho":
        dct[0] *= 1.0 / np.sqrt(2)
        dct *= np.sqrt(2.0 / n_mels)
    else:
        dct *= 2.0
    return Tensor(dct.T.astype(dtype))


def power_to_db(spect, ref_value=1.0, amin=1e-10, top_db=80.0):
    """10 log10(max(spect, amin)) - 10 log10(max(ref_value, amin)), cut
    at ``top_db`` below the largest value of the whole input (the
    reference's global max)."""
    x = spect if isinstance(spect, Tensor) else Tensor(np.asarray(spect))

    def f(a):
        log_spec = 10.0 * torch.log10(torch.clamp(a, min=amin))
        log_spec = log_spec - 10.0 * np.log10(max(ref_value, amin))
        if top_db is not None:
            log_spec = torch.maximum(log_spec, log_spec.max() - top_db)
        return log_spec
    return run_op("power_to_db", f, x)


def get_window(window, win_length, fftbins=True, dtype="float32"):
    """Window function table (reference functional/window.py)."""
    if isinstance(window, tuple):
        name, *params = window
    else:
        name, params = window, []
    n = win_length
    sym = not fftbins
    denom = n - 1 if sym else n
    t = np.arange(n)
    if name in ("hann", "hanning"):
        w = 0.5 - 0.5 * np.cos(2 * np.pi * t / denom)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * t / denom)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * t / denom)
             + 0.08 * np.cos(4 * np.pi * t / denom))
    elif name == "bartlett":
        w = 1.0 - np.abs(2 * t / denom - 1.0)
    elif name == "bohman":
        x = np.abs(2 * t / denom - 1.0)
        w = (1 - x) * np.cos(np.pi * x) + np.sin(np.pi * x) / np.pi
    elif name == "nuttall":
        a = [0.3635819, 0.4891775, 0.1365995, 0.0106411]
        w = (a[0] - a[1] * np.cos(2 * np.pi * t / denom)
             + a[2] * np.cos(4 * np.pi * t / denom)
             - a[3] * np.cos(6 * np.pi * t / denom))
    elif name == "gaussian":
        std = params[0] if params else 1.0
        w = np.exp(-0.5 * ((t - (n - 1) / 2) / (std * (n - 1) / 2)) ** 2) \
            if sym else np.exp(-0.5 * ((t - n / 2) / (std * n / 2)) ** 2)
    elif name == "general_gaussian":
        p, sig = (params + [1.0, 1.0])[:2]
        w = np.exp(-0.5 * np.abs((t - (n - 1) / 2) / sig) ** (2 * p))
    elif name == "exponential":
        tau = params[0] if params else 1.0
        w = np.exp(-np.abs(t - (n - 1) / 2) / tau)
    elif name == "triang":
        w = 1.0 - np.abs((t - (n - 1) / 2) / ((n + 1) / 2 if not sym
                                              else (n - 1) / 2 + 0.5))
    elif name in ("boxcar", "rectangular", "ones"):
        w = np.ones(n)
    elif name == "cosine":
        w = np.sin(np.pi * (t + 0.5) / n)
    elif name == "kaiser":
        beta = params[0] if params else 12.0
        w = np.kaiser(n, beta)
    elif name == "taylor":
        # 4-term Taylor window, -30 dB sidelobes (scipy default)
        nbar, sll = 4, 30
        b = 10 ** (sll / 20)
        a = np.arccosh(b) / np.pi
        s2 = nbar ** 2 / (a ** 2 + (nbar - 0.5) ** 2)
        fm = np.zeros(nbar - 1)
        signs = (-1) ** np.arange(1, nbar)
        m2 = np.arange(1, nbar) ** 2
        for mi in range(1, nbar):
            num = np.prod(1 - m2[mi - 1] / s2
                          / (a ** 2 + (np.arange(nbar - 1) + 0.5) ** 2))
            den = np.prod(1 - m2[mi - 1] / m2[np.arange(nbar - 1)
                                              != mi - 1])
            fm[mi - 1] = signs[mi - 1] * num / (2 * den)
        w = np.ones(n)
        for mi in range(1, nbar):
            w = w + 2 * fm[mi - 1] * np.cos(
                2 * np.pi * mi * (t - (n - 1) / 2) / n)
    else:
        raise ValueError(f"unknown window {name!r}")
    return Tensor(w.astype(dtype))


__all__ = ["compute_fbank_matrix", "create_dct", "fft_frequencies",
           "hz_to_mel", "mel_frequencies", "mel_to_hz", "power_to_db",
           "get_window"]
