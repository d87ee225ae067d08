"""The port's op schema registry: ``paddle_tpu_torch/ops/yaml`` <-> the port's
op library <-> the generated ``paddle_tpu_torch/_C_ops.py``, and its
InferMeta functions against meta-tensor runs. ``tests/test_op_schema.py``
restated without jax, and ``tests/test_op_coverage.py``'s manifest held
over the port's yaml and the sweeps bound to the port.

Reference mechanism being mirrored: the yaml is the single source of truth
(paddle/phi/ops/yaml/ops.yaml) and the generated surface must stay in sync
(python_c_gen.py); infermeta shape functions must agree with the kernels.
"""
import functools
import importlib
import importlib.util
import inspect
import os
import re

import numpy as np
import pytest
import torch
import yaml

import paddle_tpu_torch as T
from paddle_tpu_torch.core import infermeta as im
from paddle_tpu_torch.ops.yaml import generator as gen
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REF_YAML = os.path.join(ROOT, "paddle_tpu", "ops", "yaml")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


@functools.lru_cache(maxsize=None)
def _schemas():
    return gen.load_schemas()


@pytest.fixture
def schemas():
    return _schemas()


def _resolve(path):
    mod, fn = path.rsplit(".", 1)
    return getattr(importlib.import_module(mod), fn, None)


def test_every_kernel_resolves_to_the_port(schemas):
    assert len(schemas) == 439
    for s in schemas:
        path = s["kernel"]["func"]
        assert path.startswith("paddle_tpu_torch."), path
        assert callable(_resolve(path)), f"kernel {path} does not resolve"


def test_inplace_variants_exist(schemas):
    n = 0
    for s in schemas:
        if "inplace" in s:
            assert callable(_resolve(s["kernel"]["func"] + "_")), s["op"]
            n += 1
    assert n == 22


def test_infermeta_func_resolves(schemas):
    for s in schemas:
        assert hasattr(im, s["infer_meta"]["func"]), s["op"]


def test_generated_c_ops_up_to_date():
    assert gen.main(["--check"]) == 0
    with open(os.path.join(ROOT, "paddle_tpu_torch", "_C_ops.py")) as f:
        assert f.read() == gen.generate()


def test_every_binding_resolves_to_a_port_callable():
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "_C_ops.py")).read()
    paths = sorted(set(re.findall(r"_bind\('([^']+)'\)", src)))
    assert len(paths) == 461
    for path in paths:
        fn = _resolve(path)
        assert callable(fn) and fn.__module__.startswith(
            "paddle_tpu_torch"), path
        assert "NotImplementedError" not in inspect.getsource(fn), path
    assert len(T._C_ops.__all__) == 490


def test_compat_aliases_bound():
    C = T._C_ops
    compat = gen.load_compat()
    assert len(compat) == 29
    for op, legacy in compat.items():
        assert getattr(C, legacy) is getattr(C, op)


def test_c_ops_callable_smoke():
    C = T._C_ops
    x = T.Tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    np.testing.assert_allclose(C.add(x, x).numpy(), x.numpy() * 2)
    np.testing.assert_allclose(C.matmul(x, x.T).numpy(),
                               x.numpy() @ x.numpy().T, rtol=1e-6)
    assert C.reshape(x, [3, 2]).shape == [3, 2]
    assert C.elementwise_add is C.add


def _fields(text, prefix):
    out = {}
    for s in yaml.safe_load(text):
        s = dict(s)
        s["kernel"] = {"func": s["kernel"]["func"].replace(
            prefix, "paddle_tpu.", 1)}
        out[s["op"]] = s
    return out


def test_ops_yaml_equals_the_reference_once_the_prefix_is_replaced():
    with open(os.path.join(REF_YAML, "ops.yaml")) as f:
        ref = _fields(f.read(), "paddle_tpu.")
    with open(os.path.join(ROOT, "paddle_tpu_torch", "ops", "yaml",
                           "ops.yaml")) as f:
        port = _fields(f.read(), "paddle_tpu_torch.")
    assert list(port) == list(ref)
    for op in ref:
        assert port[op] == ref[op], op
    for name in ("op_compat.yaml", "op_version.yaml"):
        with open(os.path.join(REF_YAML, name)) as f:
            want = yaml.safe_load(f)
        with open(os.path.join(ROOT, "paddle_tpu_torch", "ops", "yaml",
                               name)) as f:
            assert yaml.safe_load(f) == want, name


def test_bootstrap_reflects_the_port_library(capsys):
    from paddle_tpu_torch.ops.yaml import bootstrap
    bootstrap.main()
    out = capsys.readouterr().out
    ops = re.findall(r"^- op : (\S+)$", out, re.M)
    assert len(ops) > 380 and "matmul" in ops
    assert "func : paddle_tpu_torch.ops.linalg.matmul" in out
    assert "paddle_tpu." not in out.replace("paddle_tpu_torch.", "")


# ---------------------------------------------------------------- infermeta
def M(shape, dtype=np.float32):
    return im.MetaTensor(shape, dtype)


def test_broadcast_shape():
    assert im.broadcast_shape((2, 1, 3), (4, 3)) == (2, 4, 3)
    with pytest.raises(ValueError):
        im.broadcast_shape((2, 3), (4,))


@pytest.mark.parametrize("a,b,kw", [
    ((2, 3), (3, 4), {}),
    ((5, 2, 3), (3, 4), {}),
    ((5, 2, 3), (5, 3, 4), {}),
    ((3,), (3, 4), {}),
    ((2, 3), (3,), {}),
    ((2, 3), (2, 4), {"transpose_x": True}),
    ((2, 3), (4, 3), {"transpose_y": True}),
])
def test_matmul_infermeta_matches_a_meta_run(a, b, kw):
    got = im.matmul_infermeta(M(a), M(b), **kw)
    want = im.infer_via_eval_shape(
        lambda p, q: torch.matmul(
            p.transpose(-1, -2) if kw.get("transpose_x") and p.ndim > 1
            else p,
            q.transpose(-1, -2) if kw.get("transpose_y") and q.ndim > 1
            else q),
        M(a), M(b))
    assert got == want
    # and the port's own matmul, on meta tensors
    assert im.infer_via_eval_shape(T.matmul, M(a), M(b), **kw) == got


@pytest.mark.parametrize("shape,target", [
    ((2, 3, 4), (6, 4)), ((2, 3, 4), (-1,)), ((2, 3, 4), (0, -1)),
    ((6,), (2, 3)),
])
def test_reshape_infermeta(shape, target):
    got = im.reshape_infermeta(M(shape), target)
    t = [shape[i] if s == 0 else s for i, s in enumerate(target)]
    assert got.shape == np.zeros(shape).reshape(t).shape
    if 0 not in target:
        # the op itself, as the reference's, takes no 0 ("copy this dim")
        assert im.infer_via_eval_shape(T.reshape, M(shape),
                                       list(target)) == got


def test_reduce_infermeta():
    assert im.reduce_infermeta(M((2, 3, 4)), axis=1).shape == (2, 4)
    assert im.reduce_infermeta(M((2, 3, 4)), axis=(0, 2),
                               keepdim=True).shape == (1, 3, 1)
    assert im.reduce_infermeta(M((2, 3)), axis=None).shape == ()
    assert im.infer_via_eval_shape(T.sum, M((2, 3, 4)), axis=1) == \
        im.reduce_infermeta(M((2, 3, 4)), axis=1)


def test_concat_split_stack():
    assert im.concat_infermeta([M((2, 3)), M((4, 3))], 0).shape == (6, 3)
    assert im.stack_infermeta([M((2, 3))] * 4, 1).shape == (2, 4, 3)
    outs = im.split_infermeta(M((6, 3)), 3, 0)
    assert [o.shape for o in outs] == [(2, 3)] * 3
    outs = im.split_infermeta(M((6, 3)), [1, 2, 3], 0)
    assert [o.shape for o in outs] == [(1, 3), (2, 3), (3, 3)]
    assert im.infer_via_eval_shape(T.split, M((6, 3)), [1, 2, 3], 0) == outs


def test_conv_pool_infermeta_match_meta_runs():
    x, w = M((2, 3, 16, 16)), M((8, 3, 3, 3))
    got = im.conv2d_infermeta(x, w, stride=2, padding=1)
    out = im.infer_via_eval_shape(
        lambda a, b: torch.nn.functional.conv2d(a, b, stride=2, padding=1),
        x, w)
    assert got == out
    assert im.pool2d_infermeta(M((2, 3, 16, 16)), 2, 2).shape == (2, 3, 8, 8)
    assert im.infer_via_eval_shape(T.nn.functional.max_pool2d,
                                   M((2, 3, 16, 16)), 2, 2) == \
        im.pool2d_infermeta(M((2, 3, 16, 16)), 2, 2)


def test_elementwise_promotion():
    got = im.elementwise_infermeta(M((2, 3), np.float32),
                                   M((3,), np.float64))
    assert got.shape == (2, 3) and got.dtype == np.float64
    assert im.infer_via_eval_shape(T.add, M((2, 3)), M((3,), np.float64)) \
        == got


def test_transpose_expand_tile_pad():
    assert im.transpose_infermeta(M((2, 3, 4)), (2, 0, 1)).shape == (4, 2, 3)
    assert im.expand_infermeta(M((1, 3)), (5, -1)).shape == (5, 3)
    assert im.tile_infermeta(M((2, 3)), (2,)).shape == (2, 6)
    assert im.pad_infermeta(M((2, 3)), [1, 1, 0, 2]).shape == (4, 5)


def test_embedding_gather_where():
    assert im.embedding_infermeta(M((4, 7), np.int64),
                                  M((100, 16))).shape == (4, 7, 16)
    assert im.gather_infermeta(M((5, 3)), M((7,), np.int64), 0).shape \
        == (7, 3)
    assert im.where_infermeta(M((2, 1), np.bool_), M((2, 3)),
                              M((3,))).shape == (2, 3)


# The explicit meta functions of INFER_META against a meta run of the op
# the yaml binds them to, on the reference's sample shapes above.
EXPLICIT = [
    ("cast", [M((2, 3))], {"dtype": "bfloat16"},
     lambda: im.cast_infermeta(M((2, 3)), "bfloat16")),
    ("reshape", [M((2, 3, 4))], {"shape": [-1, 4]},
     lambda: im.reshape_infermeta(M((2, 3, 4)), [-1, 4])),
    ("transpose", [M((2, 3, 4))], {"perm": [2, 0, 1]},
     lambda: im.transpose_infermeta(M((2, 3, 4)), [2, 0, 1])),
    ("flatten", [M((2, 3, 4))], {"start_axis": 1},
     lambda: im.flatten_infermeta(M((2, 3, 4)), 1)),
    ("squeeze", [M((2, 1, 4))], {"axis": 1},
     lambda: im.squeeze_infermeta(M((2, 1, 4)), 1)),
    ("unsqueeze", [M((2, 4))], {"axis": [0, 2]},
     lambda: im.unsqueeze_infermeta(M((2, 4)), [0, 2])),
    ("expand", [M((1, 3))], {"shape": [5, -1]},
     lambda: im.expand_infermeta(M((1, 3)), [5, -1])),
    ("tile", [M((2, 3))], {"repeat_times": [2, 1, 2]},
     lambda: im.tile_infermeta(M((2, 3)), [2, 1, 2])),
    ("matmul", [M((5, 2, 3)), M((3, 4))], {},
     lambda: im.matmul_infermeta(M((5, 2, 3)), M((3, 4)))),
    ("embedding", [M((4, 7), np.int64), M((100, 16))], {},
     lambda: im.embedding_infermeta(M((4, 7), np.int64), M((100, 16)))),
    ("gather", [M((5, 3)), M((7,), np.int64)], {"axis": 0},
     lambda: im.gather_infermeta(M((5, 3)), M((7,), np.int64), 0)),
    ("index_select", [M((5, 3)), M((7,), np.int64)], {"axis": 1},
     lambda: im.index_select_infermeta(M((5, 3)), M((7,), np.int64), 1)),
    ("where", [M((2, 1), np.bool_), M((2, 3)), M((3,))], {},
     lambda: im.where_infermeta(M((2, 1), np.bool_), M((2, 3)), M((3,)))),
    ("addmm", [M((3, 4)), M((3, 5)), M((5, 4))], {},
     lambda: im.addmm_infermeta(M((3, 4)), M((3, 5)), M((5, 4)))),
    ("conv2d", [M((2, 3, 16, 16)), M((8, 3, 3, 3))],
     {"stride": 2, "padding": 1},
     lambda: im.conv2d_infermeta(M((2, 3, 16, 16)), M((8, 3, 3, 3)), 2, 1)),
    ("softmax", [M((2, 3))], {"axis": 0},
     lambda: im.softmax_infermeta(M((2, 3)), 0)),
    ("layer_norm", [M((2, 3, 4))], {"normalized_shape": [4]},
     lambda: im.layer_norm_infermeta(M((2, 3, 4)))),
    ("one_hot", [M((2, 3), np.int64)], {"num_classes": 5},
     lambda: im.one_hot_infermeta(M((2, 3), np.int64), 5)),
    ("tril", [M((3, 4))], {"diagonal": 1},
     lambda: im.tril_triu_infermeta(M((3, 4)), 1)),
    ("triu", [M((3, 4))], {}, lambda: im.tril_triu_infermeta(M((3, 4)))),
]


@pytest.mark.parametrize("op,metas,kw,meta_fn", EXPLICIT,
                         ids=[e[0] for e in EXPLICIT])
def test_explicit_infermeta_matches_the_op_on_meta_tensors(op, metas, kw,
                                                           meta_fn):
    path = next(s["kernel"]["func"] for s in _schemas() if s["op"] == op)
    assert im.infer_via_eval_shape(_resolve(path), *metas, **kw) == \
        meta_fn()


def test_every_explicit_infermeta_is_checked(schemas):
    explicit = {s["op"] for s in schemas
                if s["infer_meta"]["func"] != "infer_via_eval_shape"}
    assert explicit <= set(im.INFER_META) | {"pool2d"}
    assert {e[0] for e in EXPLICIT} | {"concat", "stack", "split",
                                       "pool2d"} >= explicit


def test_data_dependent_shapes_have_no_meta():
    # as under jax.eval_shape, an output shape that depends on the
    # input's values cannot be inferred
    for op in (T.unique, T.nonzero):
        with pytest.raises(Exception):
            im.infer_via_eval_shape(op, M((6,)))
    with pytest.raises(Exception):
        im.infer_via_eval_shape(T.masked_select, M((6,)), M((6,), np.bool_))


def test_meta_of_an_op_that_reads_a_value_raises():
    # segment_pool reads max(id) on the host: the meta device refuses it,
    # FakeTensorMode cannot give it a value either, so it raises
    with pytest.raises(Exception):
        im.infer_via_eval_shape(T.ops.extra.segment_pool, M((6, 3)),
                                M((6,), np.int64))
    # an op with no host read runs on the meta device
    assert im.infer_via_eval_shape(T.ops.extra.swiglu, M((3, 8))) == \
        M((3, 4))


# ---------------------------------------------------- the coverage manifest
def _coverage_manifest():
    spec = importlib.util.spec_from_file_location(
        "_op_coverage_manifest", os.path.join(HERE, "test_op_coverage.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_port_schema_is_covered_by_a_bound_test():
    cov = _coverage_manifest()
    with open(os.path.join(ROOT, "paddle_tpu_torch", "ops", "yaml",
                           "ops.yaml")) as f:
        schemas = re.findall(r"^- op : (\S+)$", f.read(), re.M)
    swept = cov._sweep_names()
    uncovered = [n for n in schemas if n not in swept
                 and n not in cov.FUNC_TESTS and n not in cov.POINTERS]
    assert not uncovered
    # every sweep file and every function the manifest names runs against
    # the port through the reference-test wrappers
    bound = set()
    for wrapper in ("test_torch_eager_api_reference_tests.py",
                    "test_torch_eager_reference_tests.py"):
        with open(os.path.join(HERE, wrapper)) as f:
            files = re.search(r"^FILES = \(([^)]*)\)", f.read(), re.M)
        bound |= set(re.findall(r'"(test_\w+\.py)"', files.group(1)))
    assert set(cov.SWEEP_FILES) <= bound
    for where in cov.FUNC_TESTS.values():
        assert where.split("::")[0] in bound, where
