"""paddle.fft: the port of ``paddle_tpu/fft.py`` (reference
python/paddle/fft.py), over ``torch.fft`` with the semantics of
``jnp.fft``: the ``norm`` modes "backward", "forward" and "ortho", and the
n-dimensional Hermitian transforms by the identity the reference uses
(``hfftn(a) = irfftn(conj(a))`` with the norm's direction swapped)."""
from __future__ import annotations

import torch

from .core.dispatch import run_op
from .core.tensor import Tensor


def _fft_op(op_name, tfn):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return run_op(op_name, lambda a: tfn(a, n=n, dim=axis, norm=norm), x)
    op.__name__ = op_name
    return op


def _fftn_op(op_name, tfn, default_axes=None):
    def op(x, s=None, axes=None, norm="backward", name=None):
        dims = default_axes if axes is None else axes
        return run_op(op_name, lambda a: tfn(a, s=s, dim=dims, norm=norm), x)
    op.__name__ = op_name
    return op


fft = _fft_op("fft", torch.fft.fft)
ifft = _fft_op("ifft", torch.fft.ifft)
rfft = _fft_op("rfft", torch.fft.rfft)
irfft = _fft_op("irfft", torch.fft.irfft)
hfft = _fft_op("hfft", torch.fft.hfft)
ihfft = _fft_op("ihfft", lambda a, **kw: torch.fft.ihfft(a, **kw)
                .resolve_conj())
fft2 = _fftn_op("fft2", torch.fft.fftn, (-2, -1))
ifft2 = _fftn_op("ifft2", torch.fft.ifftn, (-2, -1))
rfft2 = _fftn_op("rfft2", torch.fft.rfftn, (-2, -1))
irfft2 = _fftn_op("irfft2", torch.fft.irfftn, (-2, -1))
fftn = _fftn_op("fftn", torch.fft.fftn)
ifftn = _fftn_op("ifftn", torch.fft.ifftn)
rfftn = _fftn_op("rfftn", torch.fft.rfftn)
irfftn = _fftn_op("irfftn", torch.fft.irfftn)

_INV_NORM = {"backward": "forward", "forward": "backward", "ortho": "ortho"}


def _hfftn(a, s=None, dim=None, norm="backward"):
    return torch.fft.irfftn(torch.conj(a), s=s, dim=dim,
                            norm=_INV_NORM[norm])


def _ihfftn(a, s=None, dim=None, norm="backward"):
    return torch.conj(torch.fft.rfftn(a, s=s, dim=dim,
                                      norm=_INV_NORM[norm])).resolve_conj()


hfftn = _fftn_op("hfftn", _hfftn)
ihfftn = _fftn_op("ihfftn", _ihfftn)
hfft2 = _fftn_op("hfft2", _hfftn, (-2, -1))
ihfft2 = _fftn_op("ihfft2", _ihfftn, (-2, -1))


def _freqs(k, n, d):
    """The bins ``k`` over n d in float32, as jnp.fft computes them."""
    from .core.place import default_device
    k = k.to(default_device(), torch.float32)
    return Tensor._wrap(k / torch.tensor(d * n, dtype=torch.float32,
                                         device=k.device))


def fftfreq(n, d=1.0, dtype=None, name=None):
    pos = (n - 1) // 2 + 1
    return _freqs(torch.cat([torch.arange(0, pos),
                             torch.arange(-(n // 2), 0)]), n, d)


def rfftfreq(n, d=1.0, dtype=None, name=None):
    return _freqs(torch.arange(0, n // 2 + 1), n, d)


def fftshift(x, axes=None, name=None):
    return run_op("fftshift", lambda a: torch.fft.fftshift(a, dim=axes), x)


def ifftshift(x, axes=None, name=None):
    return run_op("ifftshift", lambda a: torch.fft.ifftshift(a, dim=axes), x)
