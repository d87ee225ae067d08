"""paddle_tpu_torch: the PyTorch / CUDA port of paddle_tpu for one NVIDIA H100.

It sits beside the JAX package ``paddle_tpu``, which stays the reference, and
imports neither ``jax`` nor anything of ``paddle_tpu``. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.

What is ported so far is the GPT training step of
``paddle_tpu.models.gpt_hybrid`` at dp=pp=tp=1 (``models/gpt_hybrid.py``),
with its Pallas attention kernel as a Hopper kernel (``ops/hopper``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
