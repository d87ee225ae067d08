"""The eager API's core modules of paddle_tpu_torch (core/dtype.py,
core/place.py, core/generator.py) against the reference where both define
the behaviour, on the CPU; and core/flags.py's precision flags, which set
torch's f32 matmul and cuDNN's f32 convolution precision."""
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
         "bfloat16", "float32", "float64", "complex64", "complex128"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    yield
    T.set_default_dtype("float32")


@pytest.mark.parametrize("name", NAMES)
def test_dtype_equals_numpy_torch_and_name(name):
    d = getattr(T, name)
    np_dtype = np.dtype(getattr(ml_dtypes, name, name))
    assert d == name and d == np_dtype and d == getattr(torch, name)
    assert np_dtype == d and np.dtype(d) == np_dtype
    assert d != ("int8" if name != "int8" else "uint8")
    t = T.to_tensor(np.zeros(2, np.float32)).astype(name)
    assert t.dtype == d and t.dtype.name == name and str(t.dtype) == name
    assert t.dtype == getattr(P, name) or name in ("int64", "float64",
                                                   "complex128")


def test_dtype_aliases_and_default_dtype():
    assert T.core.dtype.convert_dtype("bf16") == T.bfloat16
    assert T.core.dtype.convert_dtype("paddle.float16") == T.float16
    assert T.core.dtype.convert_dtype(np.float32) == T.float32
    assert T.core.dtype.convert_dtype(float) == T.float64
    assert T.to_tensor(1.5).dtype == T.get_default_dtype() == T.float32
    T.set_default_dtype("float64")
    assert T.to_tensor(1.5).dtype == T.float64
    assert T.to_tensor(np.ones(2)).dtype == T.float64
    assert T.to_tensor(np.ones(2, np.float32)).dtype == T.float32
    with pytest.raises(TypeError):
        T.set_default_dtype("int32")


@pytest.mark.parametrize("a,b", [("int32", "float32"), ("bool", "int32"),
                                 ("float16", "bfloat16"), ("uint8", "int8"),
                                 ("int8", "float16"), ("bfloat16", "float32"),
                                 ("float32", "complex64")])
def test_promote_types_matches_reference(a, b):
    assert T.promote_types(a, b).name == np.dtype(P.promote_types(a, b)).name


def test_finfo_iinfo_match_reference():
    for name in ("float16", "bfloat16", "float32"):
        got, want = T.finfo(name), P.finfo(name)
        assert float(got.eps) == float(want.eps), name
        assert float(got.max) == float(want.max), name
    assert T.iinfo("int32").max == P.iinfo("int32").max
    assert T.iinfo("int8").min == P.iinfo("int8").min


def test_ml_dtypes_arrays_and_numpy_of_bf16():
    a = np.array([1.5, -2.25, 3.0e-3], ml_dtypes.bfloat16)
    t = T.to_tensor(a)
    assert t.dtype == T.bfloat16
    # numpy() of bf16 widens to float32: the card has no ml_dtypes
    out = t.numpy()
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, a.astype(np.float32))
    np.testing.assert_array_equal(P.to_tensor(a).numpy().astype(np.float32),
                                  out)


def test_places_and_devices():
    assert T.get_device() == "cpu:0"
    assert T.to_tensor([1.0]).place == T.CPUPlace()
    assert T.CUDAPlace(1) == T.core.place._parse_place("gpu:1")
    assert T.core.place._parse_place("cuda:0") == T.CUDAPlace(0)
    assert not T.is_compiled_with_tpu()
    with pytest.raises(ValueError, match="no TPU"):
        T.set_device("tpu")
    with pytest.raises(ValueError, match="no TPU"):
        T.to_tensor([1.0], place=T.TPUPlace())
    assert T.get_device() == "cpu:0"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.to_tensor([1.0], place="gpu:0")


def test_generator_state_round_trip():
    g = T.default_generator()
    T.seed(7)
    assert g.seed() == 7 == g.initial_seed()
    T.randn([3])
    state = g.get_state()
    a = T.randn([4]).numpy()
    b = T.rand([2]).numpy()
    g.set_state(state)
    np.testing.assert_array_equal(T.randn([4]).numpy(), a)
    np.testing.assert_array_equal(T.rand([2]).numpy(), b)
    assert g.get_state()["offset"] == state["offset"] + 2
    assert T.uniform([3], seed=5).numpy().tolist() == \
        T.uniform([3], seed=5).numpy().tolist()


@pytest.mark.parametrize("precision,deterministic,torch_precision,tf32", [
    ("", False, "highest", False), ("highest", False, "highest", False),
    ("high", False, "high", True), ("default", False, "medium", True),
    ("default", True, "highest", False), ("high", True, "highest", False)])
def test_precision_flags_govern_cudnn_f32_convolutions(
        precision, deterministic, torch_precision, tf32):
    """FLAGS_matmul_precision and FLAGS_deterministic set cuDNN's f32
    convolutions as jax's matmul precision governs conv_general_dilated:
    TF32 exactly when torch's matmul precision is not "highest"."""
    saved = T.get_flags(["FLAGS_matmul_precision", "FLAGS_deterministic"])
    try:
        T.set_flags({"FLAGS_deterministic": not deterministic})
        T.set_flags({"FLAGS_matmul_precision": precision})
        T.set_flags({"FLAGS_deterministic": deterministic})
        assert torch.get_float32_matmul_precision() == torch_precision
        assert torch.backends.cudnn.allow_tf32 is tf32
        T.set_flags({"FLAGS_deterministic": False})
        assert torch.backends.cudnn.allow_tf32 is (
            precision in ("high", "default"))
    finally:
        T.set_flags(saved)
    assert torch.backends.cudnn.allow_tf32 is (
        saved["FLAGS_matmul_precision"] in ("high", "default")
        and not saved["FLAGS_deterministic"])


def test_precision_flags_apply_at_import():
    """The flags' defaults set cuDNN's f32 convolutions to full f32 when the
    port is imported, where torch's own default allows TF32."""
    probe = ("import torch\n"
             "assert torch.backends.cudnn.allow_tf32\n"
             "import paddle_tpu_torch\n"
             "print(torch.backends.cudnn.allow_tf32,"
             " torch.get_float32_matmul_precision())\n")
    env = {k: v for k, v in os.environ.items() if not k.startswith("FLAGS_")}
    out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "highest"]
