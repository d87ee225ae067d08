"""The predictor on the CPU: ``paddle_tpu_torch.inference``'s ``Config``,
``create_predictor`` and the int8 weight-only export against the
reference's, from one state_dict, on the same inputs (f32; the port on the
``aot_eager`` backend, ``force_cpu``).

- plain: the outputs within 1e-5 of the reference's;
- ``enable_low_precision_inference("bfloat16")``: within 2e-2 of the
  reference's bf16 outputs, relative to their scale;
- ``enable_int8_weight_only``: the int8 payloads and scales bit-equal to
  the reference's, the outputs within 1e-6;
- ``enable_shape_bucketing``: every batch 1-11 equal (1e-6) to an
  unbucketed predictor's, from at most the ladder's count of graphs;
- a ``jit.save`` artifact served through ``Config(path)`` at three batches
  from one program.

Restated here: ``test_inference.py::test_share_external_data_zero_copy``
(it adopts a ``jax.numpy`` array; here a torch tensor) and
``test_decode.py::test_int8_native_serving_export_roundtrip`` (it checks
the buffer's dtype against ``jnp.int8``; here ``torch.int8``).
"""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest keeps it on the CPU)

import paddle_tpu as P
import paddle_tpu.inference as pinf
import paddle_tpu_torch as T
import paddle_tpu_torch.inference as tinf
from paddle_tpu_torch._testing import force_cpu
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    force_cpu()


def _models():
    P.seed(7)
    ref = P.nn.Sequential(P.nn.Linear(8, 32), P.nn.ReLU(),
                          P.nn.Linear(32, 4))
    port = T.nn.Sequential(T.nn.Linear(8, 32), T.nn.ReLU(),
                           T.nn.Linear(32, 4))
    port.set_state_dict({k: v.numpy() for k, v in ref.state_dict().items()})
    return ref, port


def _pred(inf, model, *passes):
    cfg = inf.Config()
    cfg.set_layer(model)
    for name, arg in passes:
        getattr(cfg, name)(*arg)
    return inf.create_predictor(cfg)


def _x(b, seed=0):
    return np.random.RandomState(seed).randn(b, 8).astype(np.float32)


@pytest.mark.parametrize("passes,tol", [
    ((), 1e-5),
    ((("enable_low_precision_inference", ("bfloat16",)),), 2e-2),
], ids=["plain", "bfloat16"])
def test_predictor_outputs_match_the_references(passes, tol):
    ref, port = _models()
    rp, tp = _pred(pinf, ref, *passes), _pred(tinf, port, *passes)
    for b in (1, 5):
        want = np.asarray(rp.run([P.to_tensor(_x(b, b))])[0].numpy(),
                          np.float32)
        got = np.asarray(tp.run([T.to_tensor(_x(b, b))])[0].numpy(),
                         np.float32)
        assert got.shape == want.shape == (b, 4)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_int8_payloads_are_the_references_bit_for_bit():
    ref, port = _models()
    rp = _pred(pinf, ref, ("enable_int8_weight_only", ()))
    tp = _pred(tinf, port, ("enable_int8_weight_only", ()))
    for (rn, rparam), (tn, tparam) in zip(ref.named_parameters(),
                                          port.named_parameters()):
        assert rn == tn
        rpay = getattr(rparam, "_int8_payload", None)
        tpay = getattr(tparam, "_int8_payload", None)
        assert (rpay is None) == (tpay is None)
        if rpay is not None:
            assert tpay[0].dtype == np.int8
            np.testing.assert_array_equal(tpay[0], np.asarray(rpay[0]))
            np.testing.assert_array_equal(tpay[1], np.asarray(rpay[1]))
    want = rp.run([P.to_tensor(_x(6))])[0].numpy()
    got = tp.run([T.to_tensor(_x(6))])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_bucketed_runs_equal_unbucketed_ones():
    _, port = _models()
    plain = _pred(tinf, port)
    bucketed = _pred(tinf, port, ("enable_shape_bucketing", ([2, 4],)))
    for b in range(1, 12):
        x = T.to_tensor(_x(b, b))
        got = bucketed.run([x])[0].numpy()
        assert got.shape == (b, 4)
        np.testing.assert_allclose(got, plain.run([x])[0].numpy(),
                                   rtol=1e-6, atol=1e-6)
    stats = bucketed.get_execution_stats()
    assert stats["compiled_graphs"] <= 2
    assert stats["bucket_pad_total"] >= 5


def test_a_saved_program_serves_through_config_path(tmp_path):
    ref, port = _models()
    path = str(tmp_path / "mlp")
    T.jit.save(port, path, input_spec=[T.jit.InputSpec([None, 8])])
    pred = tinf.create_predictor(tinf.Config(path + ".pdmodel"))
    assert isinstance(pred._layer, T.jit.TranslatedLayer)
    for b in (1, 3, 17):
        got = pred.run([T.to_tensor(_x(b, b))])[0].numpy()
        want = ref(P.to_tensor(_x(b, b))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert pred._compiled is pred._layer      # one program, no retrace


def test_share_external_data_zero_copy():
    _, port = _models()
    pred = _pred(tinf, port)
    dev = torch.as_tensor(np.random.RandomState(3).randn(3, 8)
                          .astype(np.float32))
    h = pred.get_input_handle("x")
    h.share_external_data(dev)
    assert h._t._data is dev            # adopted, not copied
    out = pred.run()[0]
    assert out.shape == [3, 4]


def test_int8_native_serving_export_roundtrip(tmp_path):
    """PTQ -> export int8 payload -> load into fresh model: weights live
    as int8 in memory, logits match the QDQ-emulated predictor."""
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    T.seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny())
    m.eval()
    cfg = tinf.Config()
    cfg.set_layer(m)
    cfg.enable_int8_weight_only()
    pred = tinf.create_predictor(cfg)
    ids = T.randint(0, 256, [2, 8])
    with T.no_grad():
        qdq_logits = m(ids).numpy()     # QDQ-emulated numerics
    path = str(tmp_path / "llama_int8.npz")
    tinf.save_int8_model(pred, path)
    T.seed(0)
    fresh = LlamaForCausalLM(LlamaConfig.tiny())
    fresh.eval()
    n = tinf.load_int8_model(fresh, path)
    swapped = [s for _, s in n.named_sublayers()
               if isinstance(s, tinf.Int8Linear)]
    assert len(swapped) > 0
    # int8 actually lives in memory
    assert swapped[0].weight_q._data.dtype == torch.int8
    with T.no_grad():
        int8_logits = fresh(ids).numpy()
    np.testing.assert_allclose(qdq_logits, int8_logits, rtol=2e-4,
                               atol=2e-4)
