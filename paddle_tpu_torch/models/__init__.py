"""Model zoo: the port of ``paddle_tpu/models/__init__.py``.

Submodules import lazily: ``from paddle_tpu_torch.models import gpt`` etc.
``resnet`` is not in ``__all__`` yet: asking for it raises, naming the slice
that brings it.
"""
import importlib

__all__ = ["gpt", "gpt_hybrid", "llama", "bert", "moe"]


def __getattr__(name):
    if name == "resnet":
        raise NotImplementedError(
            "paddle_tpu_torch.models.resnet lives in vision.models, which "
            "the ResNet-50 CIFAR-10 slice of the port brings (ROADMAP)")
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
