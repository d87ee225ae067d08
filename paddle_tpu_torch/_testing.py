"""Test environment helpers: the port's own ``force_cpu``.

The reference's ``paddle_tpu/_testing.py`` neutralises a TPU backend and
pins jax to the CPU before the first jax operation. The port imports no
jax: its ``force_cpu`` makes the CPU the default place, so that tensors,
Layers and optimizers built afterwards live on the CPU, as a CUDA-less
test or worker process needs.
"""
from __future__ import annotations


def force_cpu(num_devices: int | None = None,
              pop_tpu: bool = False) -> None:
    """Make the CPU the default place for this process, and ``aot_eager``
    the default backend of ``jit.to_static`` (inductor's C++ compile takes
    tens of seconds a program on a CPU). ``num_devices`` and ``pop_tpu``
    are the reference's jax settings and are accepted and ignored: torch's
    CPU is one device and there is no TPU backend."""
    from .core.place import set_device
    from .jit import set_default_backend
    set_device("cpu")
    set_default_backend("aot_eager")
