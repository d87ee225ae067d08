"""paddle.device: the port of ``paddle_tpu/device/__init__.py`` (device
selection and memory statistics; reference: python/paddle/device and
phi/core/memory/stats.cc as ``paddle.device.cuda.max_memory_allocated``).

Where the port runs: the CUDA device unless the caller asks otherwise
(``resolve_device``). The memory statistics are ``torch.cuda``'s caching
allocator's (allocated and reserved bytes, their peaks), 0 without a card.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None. Raises when a
    CUDA device is asked for and there is none: the port never carries on
    on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' for the plain CPU path")
    return dev


# core.place imports resolve_device from here: it is defined above first
from ..core.place import (  # noqa: E402,F401
    CPUPlace, CUDAPlace, CUDAPinnedPlace, Place, TPUPlace, get_device,
    set_device, is_compiled_with_tpu,
)


def _cuda():
    return torch.cuda.is_available()


def get_all_device_type():
    return ["cpu", "gpu"] if _cuda() else ["cpu"]


def get_available_device():
    """``gpu:N`` for each card (the reference lists ``platform:id`` of every
    jax device)."""
    return [f"gpu:{i}" for i in range(device_count("gpu"))]


def get_available_custom_device():
    return []


def device_count(device_type=None):
    if device_type in (None, "gpu", "cuda"):
        return torch.cuda.device_count() if _cuda() else 0
    if device_type == "cpu":
        return 1
    return 0


def synchronize(device=None):
    if _cuda():
        torch.cuda.synchronize(_device_id(device))


def _device_id(device) -> int:
    """Accept int, 'gpu:3'/'cuda:3' strings, Place, or torch.device."""
    if device is None:
        return 0
    if isinstance(device, int):
        return device
    if isinstance(device, str):
        return int(device.split(":")[1]) if ":" in device else 0
    if isinstance(device, torch.device):
        return device.index or 0
    return int(getattr(device, "device_id", getattr(device, "index", 0))
               or 0)


def _stat(fn, device):
    return int(fn(_device_id(device))) if _cuda() else 0


def max_memory_allocated(device=None):
    return _stat(torch.cuda.max_memory_allocated, device)


def max_memory_reserved(device=None):
    return _stat(torch.cuda.max_memory_reserved, device)


def memory_allocated(device=None):
    return _stat(torch.cuda.memory_allocated, device)


def memory_reserved(device=None):
    return _stat(torch.cuda.memory_reserved, device)


def dump_memory_stats(path=None, device=None):
    """Write the device memory stats as JSON to `path` (or
    FLAGS_memory_stats_dump_path) — the reference's memory-stats dump
    debugging surface. Returns the dict written. ``raw`` holds the caching
    allocator's own counters (``torch.cuda.memory_stats``)."""
    import json
    from ..core.flags import get_flag
    path = path or get_flag("FLAGS_memory_stats_dump_path")
    raw = torch.cuda.memory_stats(_device_id(device)) if _cuda() else {}
    stats = {
        "bytes_in_use": memory_allocated(device),
        "peak_bytes_in_use": max_memory_allocated(device),
        "pool_bytes": memory_reserved(device),
        "peak_pool_bytes": max_memory_reserved(device),
        "raw": {k: v for k, v in raw.items()
                if isinstance(v, (int, float, str))},
    }
    if path:
        with open(path, "w") as f:
            json.dump(stats, f, indent=1)
    return stats


class cuda:
    """Namespace parity for paddle.device.cuda."""

    device_count = staticmethod(lambda: device_count("gpu"))
    synchronize = staticmethod(synchronize)
    max_memory_allocated = staticmethod(max_memory_allocated)
    max_memory_reserved = staticmethod(max_memory_reserved)
    memory_allocated = staticmethod(memory_allocated)
    memory_reserved = staticmethod(memory_reserved)

    @staticmethod
    def empty_cache():
        import gc
        gc.collect()
        if _cuda():
            torch.cuda.empty_cache()


def is_compiled_with_cuda():
    return torch.version.cuda is not None


def is_compiled_with_rocm():
    return getattr(torch.version, "hip", None) is not None


def is_compiled_with_xpu():
    return False


def is_compiled_with_custom_device(device_type):
    return False
