"""The PyTorch port stands alone: importing and running paddle_tpu_torch loads
neither jax nor the JAX package, and its entry points default to CUDA."""
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import sys
import torch
import paddle_tpu_torch
from paddle_tpu_torch.cost_model import cost_model
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.ops import fused_ce
from paddle_tpu_torch.ops.hopper import (_build, blocked_flash, causal_attention,
                                         flash_attention, simple_attention)

cfg = GPTConfig.tiny()
pcfg = TH.ParallelConfig(remat=True, remat_policy="names")
params, opt, step = TH.setup(cfg, pcfg, seed=0, device="cpu")
ids = torch.randint(0, cfg.vocab_size, (2, 32))
loss = float(step(params, opt, (ids, ids))[2])
assert loss == loss
assert cost_model.gpt_flops_per_token(cfg, 32) > 0

def foreign(name):
    return (name in ("jax", "jaxlib", "paddle_tpu")
            or name.startswith(("jax.", "jaxlib.", "paddle_tpu.")))

print("FOREIGN", sorted(m for m in sys.modules if foreign(m)))
if not torch.cuda.is_available():
    try:
        TH.setup(cfg, pcfg)
    except RuntimeError as e:
        print("NO_CUDA_RAISES", "CUDA" in str(e))
"""


def test_port_imports_and_runs_without_jax_or_the_jax_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout
    if not torch.cuda.is_available():
        assert "NO_CUDA_RAISES True" in out.stdout, out.stdout
