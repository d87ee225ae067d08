"""The small modules of the breadth's tail against paddle_tpu's, on the CPU:
``decomposition``, ``regularizer`` with the optimizers, ``utils``,
``onnx``, ``reader``, ``batch``, ``dataset``, ``hub``, ``version``,
``sysconfig``, ``pir_utils``, ``framework.core``, ``common_ops_import``.

- Each decomposition rule on the same seeded f32 input as the reference's
  rule (on jnp), within 1e-6 relative; ``test_api_extras.py``'s
  ``TestDecomposition``, whose first test feeds the rules jnp arrays,
  restated on torch tensors.
- The reference's ``L2Decay`` step raises ``TypeError`` (its optimizer
  reads a ``_coeff`` the regularizer lacks; ROADMAP, found in the
  reference). The port's ``L2Decay(c)`` step equals the reference's float
  ``c`` step within 1e-6 relative, and ``L1Decay`` adds ``c * sign(p)``.
- The readers, ``batch`` and every dataset's synthetic reader give the
  reference's items exactly; so does the MNIST reader over a real-format
  idx file.
"""
import gzip
import os
import random
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ decomposition

def _rule_args(name, rs):
    x = rs.randn(4, 8).astype(np.float32)
    if name == "layer_norm":
        return (x, rs.randn(8).astype(np.float32),
                rs.randn(8).astype(np.float32)), {"epsilon": 1e-5}
    if name == "rms_norm":
        return (x, rs.randn(8).astype(np.float32)), {}
    if name == "batch_norm":
        x4 = rs.randn(2, 3, 4, 4).astype(np.float32)
        return (x4, rs.randn(3).astype(np.float32),
                rs.rand(3).astype(np.float32) + 0.5,
                rs.randn(3).astype(np.float32),
                rs.randn(3).astype(np.float32)), {}
    if name == "dropout":
        return (x, (rs.rand(4, 8) > 0.3).astype(np.float32)), {"p": 0.3}
    if name == "mean":
        return (x,), {"axis": 1, "keepdim": True}
    if name == "swiglu":
        return (x,), {}
    return (x,), {}


RULES = ["softmax", "log_softmax", "gelu", "silu", "layer_norm", "rms_norm",
         "batch_norm", "dropout", "mean", "sigmoid", "swiglu",
         "squared_l2_norm"]


@pytest.mark.parametrize("name", RULES)
def test_decomposition_rule_matches_the_reference(name):
    import paddle_tpu.decomposition as PDc
    import paddle_tpu_torch.decomposition as TDc
    args, kw = _rule_args(name, np.random.RandomState(RULES.index(name)))
    want = np.asarray(PDc.get_decomp_rule(name)(
        *[jnp.asarray(a) for a in args], **kw))
    got = TDc.get_decomp_rule(name)(*[torch.from_numpy(a) for a in args],
                                    **kw).numpy()
    assert _rel(got, want) <= 1e-6
    if name == "gelu":
        want = np.asarray(PDc.get_decomp_rule(name)(
            jnp.asarray(args[0]), approximate=True))
        got = TDc.get_decomp_rule(name)(torch.from_numpy(args[0]),
                                        approximate=True).numpy()
        assert _rel(got, want) <= 1e-6
    if name == "mean":
        assert _rel(TDc.rules.mean(torch.from_numpy(args[0])).numpy(),
                    np.asarray(PDc.rules.mean(jnp.asarray(args[0])))) <= 1e-6


class TestDecomposition:
    """``test_api_extras.py``'s class, its rules fed torch tensors."""

    def test_rules_match_ops(self):
        import paddle_tpu_torch.decomposition as dc
        a = np.random.RandomState(0).randn(4, 8).astype(np.float32)
        sm = dc.get_decomp_rule("softmax")(torch.from_numpy(a)).numpy()
        ref = T.nn.functional.softmax(T.to_tensor(a), axis=-1).numpy()
        np.testing.assert_allclose(sm, ref, rtol=1e-5)
        ln = dc.get_decomp_rule("layer_norm")(torch.from_numpy(a)).numpy()
        ref = T.nn.functional.layer_norm(
            T.to_tensor(a), normalized_shape=[8]).numpy()
        np.testing.assert_allclose(ln, ref, rtol=1e-4, atol=1e-5)

    def test_prim_guard(self):
        import paddle_tpu_torch.decomposition as dc
        assert not dc.prim_enabled()
        with dc.prim_guard():
            assert dc.prim_enabled()
        assert not dc.prim_enabled()

    def test_decompose_whitelist_validation(self):
        import paddle_tpu_torch.decomposition as dc
        with pytest.raises(ValueError):
            dc.decompose(None, whitelist={"not_a_real_op"})


def test_incubate_autograd_prim_switch_is_the_decomposition_switch():
    import paddle_tpu_torch.decomposition as dc
    from paddle_tpu_torch.incubate import autograd as iag
    prog = object()
    assert dc.decompose(prog) is prog
    assert dc.decompose(prog, ["v"], whitelist={"softmax"}) == (prog, ["v"])
    iag.enable_prim()
    try:
        assert dc.prim_enabled() and iag.prim_enabled()
    finally:
        iag.disable_prim()
    assert not dc.prim_enabled()


# --------------------------------------------------- regularizer, optimizer

def _linear_step(pkg, opt_name, weight_decay, **kw):
    rs = np.random.RandomState(5)
    w = rs.randn(4, 3).astype(np.float32)
    x = rs.randn(6, 4).astype(np.float32)
    layer = pkg.nn.Linear(4, 3)
    layer.set_state_dict({"weight": w, "bias": np.zeros(3, np.float32)})
    opt = getattr(pkg.optimizer, opt_name)(
        learning_rate=0.1, parameters=layer.parameters(),
        weight_decay=weight_decay, **kw)
    for _ in range(2):
        (layer(pkg.to_tensor(x)) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    return layer.weight.numpy(), w, x


def test_reference_l2decay_step_raises():
    with pytest.raises(TypeError):
        _linear_step(P, "SGD", P.regularizer.L2Decay(1e-2))


@pytest.mark.parametrize("opt_name,kw", [("SGD", {}),
                                         ("Momentum", {"momentum": 0.9}),
                                         ("Adam", {})])
def test_port_l2decay_equals_the_references_float_decay(opt_name, kw):
    want, _, _ = _linear_step(P, opt_name, 1e-2, **kw)
    got, _, _ = _linear_step(T, opt_name, T.regularizer.L2Decay(1e-2), **kw)
    float_step, _, _ = _linear_step(T, opt_name, 1e-2, **kw)
    assert _rel(got, want) <= 1e-6
    np.testing.assert_array_equal(got, float_step)


def test_port_l1decay_adds_coeff_times_sign():
    got, w, x = _linear_step(T, "SGD", T.regularizer.L1Decay(0.05))
    p = w.astype(np.float64)
    b = np.zeros(3)
    for _ in range(2):
        y = x @ p + b
        g = 2 * y / y.size
        gw, gb = x.T @ g, g.sum(0)
        p = p - 0.1 * (gw + 0.05 * np.sign(p))
        b = b - 0.1 * (gb + 0.05 * np.sign(b))     # the bias decays too
    assert _rel(got, p) <= 1e-5
    reg = T.regularizer.L1Decay(0.5)
    assert repr(reg) == "L1Decay(coeff=0.5)"
    np.testing.assert_array_equal(
        reg(T.to_tensor([-2.0, 0.0, 3.0])).numpy(), [-0.5, 0.0, 0.5])


def test_adamw_takes_a_regularizers_coefficient():
    got, _, _ = _linear_step(T, "AdamW", T.regularizer.L2Decay(0.1))
    want, _, _ = _linear_step(T, "AdamW", 0.1)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ utils

def test_utils_helpers_match_the_reference():
    import paddle_tpu.utils as PU
    import paddle_tpu_torch.utils as TU
    nest = {"b": [1, (2, 3)], "a": None, "c": {"y": 4, "x": [5]}}
    assert TU.flatten(nest) == PU.flatten(nest)
    flat = [10, 20, 30, 40, 50]
    assert TU.pack_sequence_as(nest, flat) == PU.pack_sequence_as(nest, flat)
    assert TU.try_import("math") is PU.try_import("math")
    assert TU.try_import("no_such_module_x") is None
    assert TU.require_version("0.0.1") and TU.require_version("0.1.0", "1.0")
    with pytest.raises(Exception):
        TU.require_version("9.0")

    @TU.deprecated(update_to="g", since="0.1", reason="renamed")
    def f(v):
        return v + 1
    with pytest.warns(DeprecationWarning):
        assert f(1) == 2
    from paddle_tpu_torch.utils import unique_name
    with unique_name.guard():
        assert [unique_name.generate("w") for _ in range(2)] == \
            ["w_0", "w_1"]


def test_run_check_names_the_device(capsys):
    assert T.utils.run_check()
    assert "device=cpu" in capsys.readouterr().out


def test_dlpack_round_trip_is_zero_copy():
    from paddle_tpu_torch.utils import dlpack
    x = T.to_tensor(np.arange(6, dtype=np.float32))
    y = dlpack.from_dlpack(dlpack.to_dlpack(x))
    assert y._data.data_ptr() == x._data.data_ptr()
    z = dlpack.from_dlpack(torch.arange(3.0))
    assert z.shape == [3]
    with pytest.raises(TypeError):
        dlpack.to_dlpack(np.ones(2))
    with pytest.raises(TypeError):
        dlpack.from_dlpack(3)


def test_download_resolves_the_cache_or_names_the_path(tmp_path):
    from paddle_tpu_torch.utils import download
    url = "https://example.invalid/models/w.pdparams"
    with pytest.raises(RuntimeError, match=str(tmp_path / "w.pdparams")):
        download.get_path_from_url(url, str(tmp_path))
    (tmp_path / "w.pdparams").write_bytes(b"abc")
    assert download.get_path_from_url(url, str(tmp_path)) == \
        str(tmp_path / "w.pdparams")
    md5 = "900150983cd24fb0d6963f7d28e17f72"      # md5(b"abc")
    assert download.get_path_from_url(url, str(tmp_path), md5sum=md5)
    with pytest.raises(RuntimeError):
        download.get_path_from_url(url, str(tmp_path), md5sum="0" * 32)


def test_cpp_extension_load_setup_and_register_op(tmp_path):
    from paddle_tpu.utils import cpp_extension as pce
    from paddle_tpu_torch.utils import cpp_extension as tce
    import ctypes
    src = tmp_path / "mul.cc"
    src.write_text('extern "C" int mul3(int a) { return 3 * a; }\n')
    lib = tce.load("mul3", [str(src)], build_directory=str(tmp_path / "b"))
    assert lib.mul3(ctypes.c_int(14)) == 42
    libs = tce.setup(name="mulx", ext_modules=tce.CppExtension(
        [str(src)], build_directory=str(tmp_path / "c")))
    assert libs["mulx"].mul3(ctypes.c_int(2)) == 6
    with pytest.raises(NotImplementedError, match="ops/hopper"):
        tce.CUDAExtension(["k.cu"])
    with pytest.raises(RuntimeError, match="failed"):
        bad = tmp_path / "bad.cc"
        bad.write_text("this is not C++\n")
        tce.load("bad", [str(bad)], build_directory=str(tmp_path / "d"))
    # a custom op's forward and backward against the reference's
    x = np.random.RandomState(6).randn(5).astype(np.float32)
    got = []
    for pkg, ce, lib_ in ((P, pce, jnp), (T, tce, torch)):
        op = ce.register_op(
            "cube_t", forward=lambda a: a ** 3,
            backward=lambda a, g: 3 * a * a * g)
        assert ce.get_op("cube_t") is op
        xt = pkg.to_tensor(x, stop_gradient=False)
        y = op(xt)
        (y * 2).sum().backward()
        got.append((y.numpy(), xt.grad.numpy()))
    assert _rel(got[1][0], got[0][0]) <= 1e-6
    assert _rel(got[1][1], got[0][1]) <= 1e-6


def test_onnx_export_writes_the_graph_text(tmp_path):
    from paddle_tpu_torch.jit import InputSpec
    layer = T.nn.Sequential(T.nn.Linear(4, 3), T.nn.ReLU())
    out = T.onnx.export(layer, str(tmp_path / "m"),
                        input_spec=[InputSpec([None, 4], "float32")])
    assert out == str(tmp_path / "m.graph.txt")
    text = open(out).read()
    assert "graph" in text and "relu" in text


# ------------------------------------------------------ reader and batch

def _items(n):
    return lambda: iter(range(n))


def test_reader_decorators_give_the_references_items():
    import paddle_tpu.reader as PR
    import paddle_tpu_torch.reader as TR
    cases = [
        ("cache", lambda R: R.cache(_items(5))),
        ("map_readers", lambda R: R.map_readers(lambda a, b: a * b,
                                                _items(4), _items(6))),
        ("chain", lambda R: R.chain(_items(2), _items(3))),
        ("compose", lambda R: R.compose(_items(3), lambda: iter(
            [(1, 2), (3, 4), (5, 6)]))),
        ("compose_unchecked", lambda R: R.compose(
            _items(2), _items(3), check_alignment=False)),
        ("buffered", lambda R: R.buffered(_items(9), 2)),
        ("firstn", lambda R: R.firstn(_items(9), 4)),
        ("xmap_ordered", lambda R: R.xmap_readers(lambda v: v * v,
                                                  _items(12), 3, 4, True)),
    ]
    for name, make in cases:
        assert list(make(TR)()) == list(make(PR)()), name
    random.seed(3)
    want = list(PR.shuffle(_items(20), 7)())
    random.seed(3)
    assert list(TR.shuffle(_items(20), 7)()) == want
    assert sorted(TR.xmap_readers(lambda v: -v, _items(10), 2, 3)()) == \
        sorted(PR.xmap_readers(lambda v: -v, _items(10), 2, 3)())
    assert sorted(TR.multiprocess_reader([_items(3), _items(4)])()) == \
        sorted(PR.multiprocess_reader([_items(3), _items(4)])())
    with pytest.raises(TR.ComposeNotAligned):
        list(TR.compose(_items(1), _items(2))())


def test_batch_is_one_function_and_the_references():
    from paddle_tpu_torch.batch import batch
    assert T.batch is batch is T.ops.compat.batch
    for drop_last in (False, True):
        assert list(T.batch(_items(10), 4, drop_last)()) == \
            list(P.batch(_items(10), 4, drop_last)())
    with pytest.raises(ValueError):
        T.batch(_items(3), 0)


# --------------------------------------------------------------- dataset

def _first(reader, n=3):
    out = []
    for i, item in enumerate(reader()):
        if i == n:
            break
        out.append(item)
    return out


def _equal(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b and type(a) is type(b)


READERS = [
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("cifar", "train10", ()), ("cifar", "test10", ()),
    ("cifar", "train100", ()), ("cifar", "test100", ()),
    ("uci_housing", "train", ()), ("uci_housing", "test", ()),
    ("imdb", "train", ()), ("imdb", "test", ()),
    ("imikolov", "train", ()), ("imikolov", "test", (None, 3, 2)),
    ("movielens", "train", ()), ("movielens", "test", ()),
    ("conll05", "test", ()), ("flowers", "train", ()),
    ("flowers", "test", ()), ("flowers", "valid", ()),
    ("voc2012", "train", ()), ("voc2012", "val", ()),
    ("wmt14", "train", (300,)), ("wmt14", "test", (300,)),
    ("wmt16", "train", (300, 200)), ("wmt16", "validation", (300, 200)),
]


def test_dataset_synthetic_readers_give_the_references_items():
    import paddle_tpu.dataset as PDs
    import paddle_tpu_torch.dataset as TDs
    for mod, fn, args in READERS:
        n = 2 if mod == "flowers" else 4
        got = _first(getattr(getattr(TDs, mod), fn)(*args), n)
        want = _first(getattr(getattr(PDs, mod), fn)(*args), n)
        assert len(got) == n, (mod, fn)
        _equal(got, want)
    assert len(list(TDs.mnist.train()())) == 512
    for mod, fn, args in (("imdb", "word_dict", ()),
                          ("imikolov", "build_dict", ()),
                          ("conll05", "get_dict", ()),
                          ("movielens", "movie_categories", ()),
                          ("wmt14", "get_dict", (5,)),
                          ("wmt16", "get_dict", ("en", 5, True))):
        assert getattr(getattr(TDs, mod), fn)(*args) == \
            getattr(getattr(PDs, mod), fn)(*args)
    assert [u.value() for u in TDs.movielens.user_info().values()] == \
        [u.value() for u in PDs.movielens.user_info().values()]


def _write_idx(tmp_path, n=7):
    rs = np.random.RandomState(8)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    lbls = rs.randint(0, 10, n).astype(np.uint8)
    ipath, lpath = tmp_path / "i.gz", tmp_path / "l.gz"
    with gzip.open(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(lpath, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lbls.tobytes())
    return str(ipath), str(lpath), imgs, lbls


def test_mnist_reads_a_real_idx_file(tmp_path):
    import paddle_tpu.dataset as PDs
    import paddle_tpu_torch.dataset as TDs
    ipath, lpath, imgs, lbls = _write_idx(tmp_path)
    got = list(TDs.mnist.reader_creator(ipath, lpath, 3)())
    _equal(got, list(PDs.mnist.reader_creator(ipath, lpath, 3)()))
    assert len(got) == 7 and got[0][1] == int(lbls[0])
    np.testing.assert_array_equal(
        got[0][0], imgs[0].ravel().astype(np.float32) / 255.0 * 2.0 - 1.0)
    # the train reader reads the files where DATA_HOME expects them
    os.makedirs(tmp_path / "mnist")
    os.rename(ipath, tmp_path / "mnist" / "train-images-idx3-ubyte.gz")
    os.rename(lpath, tmp_path / "mnist" / "train-labels-idx1-ubyte.gz")
    old = TDs.mnist.DATA_HOME
    TDs.mnist.DATA_HOME = str(tmp_path)
    try:
        _equal(list(TDs.mnist.train()()), got)
    finally:
        TDs.mnist.DATA_HOME = old


def test_dataset_common_split_cluster_reader_and_download(tmp_path):
    import paddle_tpu_torch.dataset as TDs
    common = TDs.common
    pattern = str(tmp_path / "part-%05d.pickle")
    common.split(_items(10), 3, suffix=pattern)
    # the reference's rule: a file at every line_count-th item after the
    # first line_count (items 0-3, 4-6, 7-9)
    assert len(os.listdir(tmp_path)) == 3
    both = sorted(list(common.cluster_files_reader(
        str(tmp_path / "part-*.pickle"), 2, 0)()) + list(
        common.cluster_files_reader(str(tmp_path / "part-*.pickle"), 2,
                                    1)()))
    assert both == list(range(10))
    with pytest.raises(RuntimeError, match=os.path.join(
            common.DATA_HOME, "mnist", "x.gz")):
        common.download("https://example.invalid/x.gz", "mnist", None)
    with pytest.raises(RuntimeError):
        TDs.cifar.fetch()


# -------------------------------------------------- the small top-level ones

def test_hub_loads_a_local_hubconf(tmp_path):
    (tmp_path / "hubconf.py").write_text(
        "def mlp(width=4):\n"
        "    '''A one-layer model.'''\n"
        "    import paddle_tpu_torch as paddle\n"
        "    return paddle.nn.Linear(width, 2)\n"
        "def _private():\n    pass\n")
    assert T.hub.list(str(tmp_path)) == ["mlp"]
    assert T.hub.help(str(tmp_path), "mlp") == "A one-layer model."
    layer = T.hub.load(str(tmp_path), "mlp", width=3)
    assert layer.weight.shape == [3, 2]
    with pytest.raises(RuntimeError):
        T.hub.load(str(tmp_path), "mlp", source="github")
    with pytest.raises(FileNotFoundError):
        T.hub.list(str(tmp_path / "absent"))


def test_version_sysconfig_pir_utils_and_the_shims():
    import paddle_tpu_torch.version as V
    from paddle_tpu_torch import (check_import_scipy, common_ops_import,
                                  pir_utils, sysconfig)
    from paddle_tpu_torch.base import core as base_core
    from paddle_tpu_torch.framework import core as framework_core
    assert V.cuda() == (torch.version.cuda or "False")
    assert V.cuda_version == V.cuda() and V.full_version == "0.1.0"
    assert V.xpu() == "False" and V.cinn() == "False"
    assert os.path.isfile(os.path.join(sysconfig.get_include(),
                                       "attention_mma.cuh"))
    assert os.path.isfile(os.path.join(sysconfig.get_include_dirs()[1],
                                       "store.cc"))
    assert sysconfig.get_lib().endswith(os.path.join("native", "_build"))
    with pir_utils.IrGuard(), pir_utils.OldIrGuard(), \
            pir_utils.DygraphPirGuard():
        pass

    @pir_utils.test_with_pir_api
    def g(v):
        return v * 2
    assert g(3) == 6
    assert framework_core.TCPStore is base_core.TCPStore
    assert framework_core.is_compiled_with_cuda() == \
        base_core.is_compiled_with_cuda()
    assert T.framework.core is framework_core
    assert T.framework.in_dynamic_mode()
    with pytest.raises(TypeError):
        common_ops_import.check_type(1, "x", (str,), "op")
    common_ops_import.check_variable_and_dtype(T.ones([1]), "x",
                                               ["float32"], "op")
    assert common_ops_import.LayerHelper("fc", a=1).kwargs == {"a": 1}
    assert check_import_scipy.check_import_scipy("nt")
