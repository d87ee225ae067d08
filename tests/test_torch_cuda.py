"""The port's Hopper kernels on the card: each kernel against its plain
PyTorch version, and a small train step that must go through them.

Every test here needs a CUDA device and skips without one. The file imports
neither jax nor the JAX package, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch.ops.hopper import flash_attention as tfa
from paddle_tpu_torch.ops.hopper import simple_attention as tsa


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32


def _rel_err(got, want):
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


# f32: the same f32 arithmetic in another order, so a few ulps of the
# output scale. bf16: one bf16 step (2^-8) of the output, a few times over.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 1e-2)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_kernels_match_plain_versions(d, dtype, tol):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(d)
    q, k, v, do = (torch.randn(2, 4, 256, d, generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    for causal in (True, False):
        got = tsa.simple_attention_fwd_cuda(q, k, v, scale, causal)
        want = tsa.simple_attention_reference(q, k, v, scale, causal)
        assert _rel_err(got, want) < tol
        gots = tsa.simple_attention_bwd_cuda(q, k, v, do, scale, causal)
        wants = tsa.simple_attention_bwd_reference(q, k, v, do, scale, causal)
        for g, w in zip(gots, wants):
            assert _rel_err(g, w) < tol


def test_kernel_wrapper_refuses_unbuilt_head_dim():
    _need_card()
    q = torch.zeros(1, 2, 128, 384, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="head dim 384"):
        tsa.simple_attention_fwd_cuda(q, q, q, 0.05, True)


def test_train_step_goes_through_the_kernels():
    _need_card()
    cfg = GPTConfig(vocab_size=256, hidden_size=128, num_layers=2,
                    num_heads=2, max_seq_len=128)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names",
                             param_dtype=torch.bfloat16,
                             compute_dtype=torch.bfloat16)
    params, opt, step = TH.setup(cfg, pcfg, seed=0)
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (2, 128))).cuda()
    tfa.reset_dispatch_counts()
    tsa.reset_launch_counts()
    losses = [float(step(params, opt, (ids, ids))[2]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    L = cfg.num_layers
    assert tsa.LAUNCHES == {"simple_attention_fwd": 3 * L,
                            "simple_attention_bwd": 3 * L}
    assert set(tfa.DISPATCH_COUNTS) == {("attn.dispatch", "simple")}
