"""Hand-written Hopper (sm_90a) kernels: one module per Pallas kernel of
``paddle_tpu/ops/pallas``, under the same stem, CUDA sources in ``csrc/``."""
