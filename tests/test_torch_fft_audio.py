"""paddle_tpu_torch.fft and .audio against paddle_tpu's, on the CPU.

- ``fft``: every name of the reference's module (whose transforms are
  ``jnp.fft``'s, and whose n-dimensional Hermitian pair is an identity over
  ``irfftn``/``rfftn``) on the same seeded inputs, with ``norm``
  "backward", "forward" and "ortho", with ``n``/``s`` and ``axis``/``axes``
  given, within 1e-5 of each output's largest value; the frequency and
  shift helpers exactly.
- ``audio.functional``: the mel scale both ways (htk and Slaney), the
  frequencies, the filterbank, the DCT, ``power_to_db`` and every window,
  within 1e-6; the feature layers ``Spectrogram``, ``MelSpectrogram``,
  ``LogMelSpectrogram`` and ``MFCC`` on a batch of seeded signals within
  1e-5 (the dB values of their largest magnitude); ``backends``' wav
  ``save``/``load``/``info`` and the folder datasets read the same files
  to the same items.
"""
import os

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

TOL = 1e-5
NORMS = ("backward", "forward", "ortho")

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (got.shape, want.shape, got.dtype, want.dtype)
    return float(np.abs(got.astype(np.complex128) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _signal(*shape, seed=0, complex_=False):
    rs = np.random.RandomState(seed)
    if complex_:
        return (rs.randn(*shape) + 1j * rs.randn(*shape)).astype(
            np.complex64)
    return rs.randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ fft

ONE_D = {"fft": True, "ifft": True, "rfft": False, "irfft": True,
         "hfft": True, "ihfft": False}
N_D = {"fft2": True, "ifft2": True, "rfft2": False, "irfft2": True,
       "fftn": True, "ifftn": True, "rfftn": False, "irfftn": True,
       "hfftn": True, "ihfftn": False, "hfft2": True, "ihfft2": False}


@pytest.mark.parametrize("name", sorted(ONE_D))
def test_fft_1d(name):
    x = _signal(3, 10, seed=1, complex_=ONE_D[name])
    for norm in NORMS:
        for kw in ({}, {"n": 8, "axis": 0}, {"n": 12}):
            want = getattr(P.fft, name)(P.to_tensor(x), norm=norm, **kw)
            got = getattr(T.fft, name)(T.to_tensor(x), norm=norm, **kw)
            assert _rel(got.numpy(), want.numpy()) <= TOL, (norm, kw)


@pytest.mark.parametrize("name", sorted(N_D))
def test_fft_nd(name):
    x = _signal(2, 4, 6, seed=2, complex_=N_D[name])
    for norm in NORMS:
        for kw in ({}, {"axes": (0, 2)}, {"s": (4, 8), "axes": (1, 2)}):
            want = getattr(P.fft, name)(P.to_tensor(x), norm=norm, **kw)
            got = getattr(T.fft, name)(T.to_tensor(x), norm=norm, **kw)
            assert _rel(got.numpy(), want.numpy()) <= TOL, (norm, kw)


def test_fft_frequencies_and_shifts():
    for n, d in ((8, 1.0), (7, 0.5)):
        for fn in ("fftfreq", "rfftfreq"):
            np.testing.assert_array_equal(getattr(T.fft, fn)(n, d).numpy(),
                                          getattr(P.fft, fn)(n, d).numpy())
    x = _signal(3, 5, seed=3)
    for fn in ("fftshift", "ifftshift"):
        for axes in (None, 1, (0,)):
            np.testing.assert_array_equal(
                getattr(T.fft, fn)(T.to_tensor(x), axes).numpy(),
                getattr(P.fft, fn)(P.to_tensor(x), axes).numpy())
    import paddle_tpu_torch.fft as tfft
    assert T.fft is tfft
    assert {n for n in dir(P.fft) if not n.startswith("_")
            and callable(getattr(P.fft, n))} - set(dir(T.fft)) == set()


def test_rfft_irfft_round_trip():
    x = _signal(2, 400, seed=4)
    back = T.fft.irfft(T.fft.rfft(T.to_tensor(x)), n=400).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=1e-5)


# ------------------------------------------------------ audio.functional

def test_audio_functional_tables():
    PA, TA = P.audio.functional, T.audio.functional
    for htk in (False, True):
        for f in (440.0, 2000.0):
            assert abs(TA.hz_to_mel(f, htk) - PA.hz_to_mel(f, htk)) <= 1e-9
            mel = PA.hz_to_mel(f, htk)
            assert abs(TA.mel_to_hz(mel, htk) - PA.mel_to_hz(mel, htk)) \
                <= 1e-9
        freqs = np.linspace(0, 8000, 17).astype(np.float32)
        np.testing.assert_allclose(
            TA.hz_to_mel(T.to_tensor(freqs), htk).numpy(),
            PA.hz_to_mel(P.to_tensor(freqs), htk).numpy(), rtol=1e-6)
        np.testing.assert_allclose(TA.mel_to_hz(freqs / 100, htk),
                                   PA.mel_to_hz(freqs / 100, htk), rtol=1e-12)
        np.testing.assert_allclose(
            TA.mel_frequencies(20, 30.0, 7000.0, htk).numpy(),
            PA.mel_frequencies(20, 30.0, 7000.0, htk).numpy(), rtol=1e-6)
        for norm in ("slaney", None):
            np.testing.assert_allclose(
                TA.compute_fbank_matrix(16000, 400, 40, 20.0, None, htk,
                                        norm).numpy(),
                PA.compute_fbank_matrix(16000, 400, 40, 20.0, None, htk,
                                        norm).numpy(), rtol=1e-6)
    np.testing.assert_array_equal(TA.fft_frequencies(16000, 400).numpy(),
                                  PA.fft_frequencies(16000, 400).numpy())
    for norm in ("ortho", None):
        np.testing.assert_array_equal(TA.create_dct(13, 40, norm).numpy(),
                                      PA.create_dct(13, 40, norm).numpy())
    spec = np.abs(_signal(2, 5, 7, seed=5)) ** 3
    for top_db in (None, 20.0):
        for ref in (1.0, 0.5):
            got = TA.power_to_db(T.to_tensor(spec), ref, 1e-6, top_db)
            want = PA.power_to_db(P.to_tensor(spec), ref, 1e-6, top_db)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-5)


@pytest.mark.parametrize("window", [
    "hann", "hamming", "blackman", "bartlett", "bohman", "nuttall",
    ("gaussian", 0.4), ("general_gaussian", 1.5, 3.0), ("exponential", 2.0),
    "triang", "boxcar", "cosine", ("kaiser", 8.0), "taylor"])
def test_windows(window):
    for n, fftbins in ((16, True), (11, False)):
        got = T.audio.functional.get_window(window, n, fftbins)
        want = P.audio.functional.get_window(window, n, fftbins)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        T.audio.functional.get_window("nope", 8)


# ---------------------------------------------------------- the layers

@pytest.mark.parametrize("layer", ["Spectrogram", "MelSpectrogram",
                                   "LogMelSpectrogram", "MFCC"])
def test_feature_layers(layer):
    wav = _signal(2, 4000, seed=6) * 0.3
    kw = {"Spectrogram": dict(n_fft=400, hop_length=160, power=1.0),
          "MelSpectrogram": dict(sr=16000, n_fft=400, hop_length=160,
                                 n_mels=40),
          "LogMelSpectrogram": dict(sr=16000, n_fft=400, hop_length=160,
                                    n_mels=40, top_db=80.0),
          "MFCC": dict(sr=16000, n_mfcc=13, n_fft=400, hop_length=160,
                       n_mels=40, window="hamming")}[layer]
    got = getattr(T.audio.features, layer)(**kw)(T.to_tensor(wav)).numpy()
    want = getattr(P.audio.features, layer)(**kw)(P.to_tensor(wav)).numpy()
    assert _rel(got, want) <= TOL


def test_backends_and_datasets(tmp_path):
    rs = np.random.RandomState(7)
    wavs = {}
    for label in ("angry", "happy"):
        os.makedirs(tmp_path / "tess" / label)
        for i in range(2):
            path = str(tmp_path / "tess" / label / f"{i}.wav")
            data = (rs.rand(1, 800).astype(np.float32) - 0.5)
            T.audio.save(path, T.to_tensor(data), 8000)
            wavs[path] = data
    path = next(iter(wavs))
    info_t, info_p = T.audio.info(path), P.audio.info(path)
    assert (info_t.sample_rate, info_t.num_samples, info_t.num_channels,
            info_t.bits_per_sample) == (info_p.sample_rate,
                                        info_p.num_samples,
                                        info_p.num_channels,
                                        info_p.bits_per_sample)
    for kw in ({}, {"frame_offset": 100, "num_frames": 300},
               {"normalize": False, "channels_first": False}):
        (gt, sr_t), (gp, sr_p) = T.audio.load(path, **kw), \
            P.audio.load(path, **kw)
        assert sr_t == sr_p == 8000
        np.testing.assert_array_equal(gt.numpy(), gp.numpy())
    tds = T.audio.datasets.TESS(data_dir=str(tmp_path / "tess"))
    pds = P.audio.datasets.TESS(data_dir=str(tmp_path / "tess"))
    assert len(tds) == len(pds) == 4 and tds.n_class == 7
    for i in range(4):
        (wt, lt), (wp, lp) = tds[i], pds[i]
        np.testing.assert_array_equal(wt.numpy(), wp.numpy())
        assert lt == lp
    with pytest.raises(FileNotFoundError):
        T.audio.datasets.ESC50(data_dir=str(tmp_path / "missing"))
    assert T.audio.backends.list_available_backends() == ["wave"]
    assert T.audio is __import__("paddle_tpu_torch.audio").audio
