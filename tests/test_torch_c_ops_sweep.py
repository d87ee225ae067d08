"""Every ``_C_ops`` binding of the port called on one small input: the
sample of its name in the reference's sweep tables
(``test_ops_sweep{,2,3,4}.py`` CASES), given positionally with the case's
attributes, as a ``paddle._C_ops`` caller passes them.

- Each binding whose sample fits its signature runs in the port and gives
  Tensors. (Its values are held against the sweep's numpy, scipy and torch
  oracles by the bound sweeps in ``test_torch_eager_api_reference_tests``,
  through the ops the sweeps call.)
- The bindings whose target this slice adds (``ops.extra``,
  ``ops.vision_ops``, ``signal``) and those phase 15b's GPT is written in
  run through both packages' ``_C_ops`` and agree (rtol 1e-4, atol 1e-5, the
  sweeps' tolerance). The others run in the port only: each cold jax op on
  the reference's side costs tens of milliseconds of compile, and holding
  all of them would cost a tier-1 worker about 40 s.
- ``UNFIT`` names the samples that are the input of a sweep's lambda, not
  of the binding (the reference's binding refuses them too).
"""
import importlib
import os
import re
import sys

import numpy as np
import pytest

import paddle_tpu as P
import paddle_tpu._C_ops as PC
import paddle_tpu_torch as T
import paddle_tpu_torch._C_ops as TC
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
SWEEPS = ("test_ops_sweep", "test_ops_sweep2", "test_ops_sweep3",
          "test_ops_sweep4")
UNFIT = {
    "affine_grid", "as_strided", "broadcast_to", "channel_shuffle", "chunk",
    "clip_by_norm", "concat", "crop", "einsum", "expand", "fill",
    "fill_diagonal", "fold", "index_add", "index_fill", "index_put",
    "local_response_norm", "maxout", "moveaxis", "multi_dot", "multiplex",
    "nanquantile", "one_hot", "pad", "pad3d", "pixel_shuffle",
    "pixel_unshuffle", "put_along_axis", "quantile", "renorm", "reshape",
    "reverse", "scatter_nd", "shard_index", "slice", "split",
    "split_with_num", "stack", "strided_slice", "swapaxes", "temporal_shift",
    "tensor_split", "tensor_unfold", "transpose", "unsqueeze", "view",
    "view_dtype",
}
# the bindings of chip_smoke.capi_gpt_loss
GPT_OPS = {"add", "embedding", "layer_norm", "matmul", "flash_attn", "gelu",
           "cast", "logsumexp", "take_along_axis", "squeeze", "subtract",
           "mean", "unbind"}


def _samples():
    sys.path.insert(0, HERE)
    try:
        tables = [importlib.import_module(m).CASES for m in SWEEPS]
    finally:
        sys.path.remove(HERE)
    names = set(TC.__all__)
    out = {}
    for table in tables:
        for case in table:
            if case[0] in names and case[0] not in out:
                out[case[0]] = (case[3], case[4])
    return out


def _new_targets():
    with open(os.path.join(os.path.dirname(HERE), "paddle_tpu_torch",
                           "_C_ops.py")) as f:
        src = f.read()
    pairs = re.findall(r"def (\w+)\(\*args, \*\*kwargs\):\n"
                       r"    return _bind\('([^']+)'\)", src)
    return {n for n, path in pairs
            if path.rsplit(".", 1)[0] in ("paddle_tpu_torch.ops.extra",
                                          "paddle_tpu_torch.ops.vision_ops",
                                          "paddle_tpu_torch.signal")}


SAMPLES = _samples()
FIT = sorted(n for n in SAMPLES if n not in UNFIT)
BOTH = sorted(n for n in FIT if n in _new_targets() | GPT_OPS)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield


def _call(C, pd, name):
    inputs, attrs = SAMPLES[name]
    return getattr(C, name)(*[pd.to_tensor(v) for v in inputs.values()],
                            **attrs)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def test_sample_counts():
    assert len(SAMPLES) == 319 and len(UNFIT) == 47
    assert UNFIT <= set(SAMPLES)
    assert len(FIT) == 272 and len(BOTH) == 27


def test_every_fitting_binding_runs_in_the_port():
    for name in FIT:
        outs = _flat(_call(TC, T, name))
        assert outs and all(isinstance(o, T.Tensor) for o in outs), name


@pytest.mark.parametrize("name", BOTH)
def test_binding_matches_reference(name):
    ref, got = _flat(_call(PC, P, name)), _flat(_call(TC, T, name))
    assert len(got) == len(ref)
    for g, w in zip(got, ref):
        w = np.asarray(w.numpy())
        g = np.asarray(g.numpy())
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
