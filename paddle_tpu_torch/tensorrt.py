"""paddle.tensorrt on torch: the port of ``paddle_tpu/tensorrt.py``
(reference: python/paddle/tensorrt — PaddleToTensorRTConverter lowering
subgraphs into TensorRT engines).

The port has no TensorRT: the card has no package of finished kernels and
the port must not come to need one. This module keeps the import surface
and points users at the compile path the port has."""
from __future__ import annotations

__all__ = ["PaddleToTensorRTConverter"]


class PaddleToTensorRTConverter:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "TensorRT is not part of paddle_tpu_torch. The deployment path "
            "is paddle_tpu_torch.jit.save(layer, path, input_spec=...) "
            "followed by paddle_tpu_torch.inference.create_predictor("
            "Config(path)): torch.export saves the program and "
            "torch.compile compiles it.")
