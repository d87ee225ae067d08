"""The ``_C_ops`` twin of the eager GPT (``chip_smoke.capi_gpt_loss``, the
function phase 15b runs at the 1.3B width on the card) against the eager
GPT on both packages, on the CPU.

At ``GPTConfig.tiny()`` in f32, on the port's ``gpt_hybrid.init_params``
(seed 0) carried into both packages: the loss of the port's ``_C_ops``
twin agrees with the reference's ``_C_ops`` twin and with the port's
``eager_gpt_loss`` at rtol 1e-5, and every gradient within 1e-4 of its
leaf's scale. (The reference's ``eager_gpt_loss`` against the port's is
``test_torch_eager_gpt.py``'s.)
"""
import importlib.util
import os

import numpy as np
import pytest

import torch

import paddle_tpu as P
import paddle_tpu._C_ops as PC
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
import paddle_tpu_torch as T
import paddle_tpu_torch._C_ops as TC
from paddle_tpu_torch.models import gpt_hybrid as TH
from paddle_tpu_torch.models.gpt import GPTConfig
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 2, 32


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _leaf_items(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaf_items(tree[k], prefix + k + ".")
        else:
            yield prefix + k, tree[k]


def _grads(params):
    return {name: t.grad.numpy() for name, t in _leaf_items(params)}


def test_capi_gpt_matches_eager_gpt_on_both_packages():
    cs = _chip_smoke()
    jcfg, tcfg = JaxGPTConfig.tiny(), GPTConfig.tiny()
    pcfg = TH.ParallelConfig(param_dtype=torch.float32,
                             compute_dtype=torch.float32)
    tparams = TH.init_params(tcfg, pcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    ids = np.random.RandomState(0).randint(0, jcfg.vocab_size,
                                           (B, S)).astype(np.int64)

    def carried(pkg, tree):
        return {k: carried(pkg, v) if isinstance(v, dict)
                else pkg.to_tensor(v.detach().numpy(), stop_gradient=False)
                for k, v in tree.items()}
    runs = {}
    for name, pkg, loss_fn in (
            ("ref capi", P, lambda p, i: cs.capi_gpt_loss(PC, p, i, jcfg)),
            ("port eager", T,
             lambda p, i: cs.eager_gpt_loss(T, p, i, tcfg)),
            ("port capi", T, lambda p, i: cs.capi_gpt_loss(TC, p, i, tcfg))):
        params = carried(pkg, tparams)
        loss = loss_fn(params, pkg.to_tensor(ids))
        loss.backward()
        runs[name] = (float(loss), _grads(params))
    want_loss, want_grads = runs["ref capi"]
    for name, (loss, grads) in runs.items():
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss), (name, loss)
        assert grads.keys() == want_grads.keys()
        for leaf, g in grads.items():
            w = want_grads[leaf]
            err = float(np.max(np.abs(g - w)))
            assert err <= 1e-4 * float(np.max(np.abs(w))), (name, leaf, err)
