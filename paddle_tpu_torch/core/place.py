"""Device identity: the port of ``paddle_tpu/core/place.py``.

A Place names a device and resolves to a ``torch.device``. The default place
is ``gpu:0``: the port runs on the card unless the caller asks for the CPU
(``set_device("cpu")``), and resolving a CUDA place without a CUDA device
raises, as ``device.resolve_device`` does. This build has no TPU:
``TPUPlace`` refuses to resolve and ``is_compiled_with_tpu()`` is False.
"""
from __future__ import annotations

import contextlib

import torch

from ..device import resolve_device


class Place:
    """Base device identity: (device_type, device_id)."""

    device_type = "undefined"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        raise ValueError(f"{self!r} names no device of paddle_tpu_torch")

    def get_device(self) -> torch.device:
        """The device this place names (the reference's returns its jax
        device)."""
        return self.torch_device()

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "Place(cpu)"


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch places tensors on a CUDA device ('gpu:0') "
                "by default and none is available; call "
                "paddle_tpu_torch.set_device('cpu') for the CPU")
        return resolve_device(f"cuda:{self.device_id}")


class CUDAPinnedPlace(Place):
    """Page-locked host memory: a CPU place."""
    device_type = "cpu"

    def torch_device(self):
        return torch.device("cpu")

    def __repr__(self):
        return "Place(gpu_pinned)"


class TPUPlace(Place):
    device_type = "tpu"

    def torch_device(self):
        raise ValueError(
            "paddle_tpu_torch has no TPU: it runs on CUDA devices ('gpu') "
            "and the CPU ('cpu')")


class XPUPlace(TPUPlace):
    """Accepted for API compatibility; maps to 'tpu', as the reference's,
    which the port does not have."""


class IPUPlace(CPUPlace):
    """Accepted for API compatibility; a CPU place, as the reference's."""


class CustomPlace(Place):
    """A place of a named device type: 'cpu' and 'gpu' resolve, any other
    type names no device of the port."""

    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type

    def torch_device(self):
        if self.device_type in ("cpu", "gpu", "cuda"):
            return _place_for(self.device_type,
                              self.device_id).torch_device()
        return super().torch_device()


def is_compiled_with_tpu() -> bool:
    return False


_CURRENT_PLACE = None
_CURRENT_DEVICE = None      # its torch.device, once resolved


def set_device(device) -> Place:
    """paddle.set_device: 'gpu', 'gpu:1', 'cuda:0', 'cpu'."""
    global _CURRENT_PLACE, _CURRENT_DEVICE
    place = _parse_place(device)
    dev = place.torch_device()
    _CURRENT_PLACE, _CURRENT_DEVICE = place, dev
    return place


def get_device() -> str:
    p = _current_place()
    return f"{p.device_type}:{p.device_id}"


def _parse_place(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return _place_for(device.type, device.index or 0)
    if isinstance(device, str):
        name, _, idx = device.partition(":")
        return _place_for(name.lower(), int(idx) if idx else 0)
    raise ValueError(f"cannot interpret device spec {device!r}")


def _place_for(platform: str, idx: int) -> Place:
    if platform == "cpu":
        return CPUPlace(idx)
    if platform in ("gpu", "cuda"):
        return CUDAPlace(idx)
    if platform == "tpu":
        return TPUPlace(idx)
    raise ValueError(f"paddle_tpu_torch has no device type {platform!r}")


def _current_place() -> Place:
    return _CURRENT_PLACE if _CURRENT_PLACE is not None else CUDAPlace(0)


def default_device() -> torch.device:
    """The current place's torch.device; raises without a CUDA device unless
    set_device('cpu') was called."""
    if _CURRENT_DEVICE is not None:
        return _CURRENT_DEVICE
    return _current_place().torch_device()


@contextlib.contextmanager
def device_guard(device):
    """Within the block the default place is ``device`` (a torch.device):
    the serving sessions run a model and allocate its caches on the device
    of its parameters, whatever ``set_device`` said."""
    global _CURRENT_PLACE, _CURRENT_DEVICE
    saved = _CURRENT_PLACE, _CURRENT_DEVICE
    dev = torch.device(device)
    _CURRENT_PLACE, _CURRENT_DEVICE = place_of(dev), dev
    try:
        yield
    finally:
        _CURRENT_PLACE, _CURRENT_DEVICE = saved


def place_of(dev: torch.device) -> Place:
    return CPUPlace() if dev.type == "cpu" else CUDAPlace(dev.index or 0)
