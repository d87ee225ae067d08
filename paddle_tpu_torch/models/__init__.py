"""Model zoo: the port of ``paddle_tpu/models/__init__.py``.

Submodules import lazily: ``from paddle_tpu_torch.models import gpt`` etc.
``resnet`` is ``vision.models.resnet``, as in the reference.
"""
import importlib

__all__ = ["gpt", "gpt_hybrid", "llama", "bert", "moe", "resnet"]


def __getattr__(name):
    if name == "resnet":
        return importlib.import_module(
            "paddle_tpu_torch.vision.models.resnet")
    if name in __all__:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
