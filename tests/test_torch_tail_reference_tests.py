"""The reference's own tests of the slice's tail modules, run against the
port.

The design of ``test_torch_breadth_reference_tests.py``: this module reads
each file's source, blanks every top-level test (function or class) but
those in ``KEEP``, rewrites the imports of the ported modules (``import
paddle_tpu as paddle``, ``from paddle_tpu import nn``, ``paddle_tpu.nn``,
``quantization``, ``sparse``, ``distribution``, ``utils``,
``utils.cpp_extension``, ``reader`` and ``dataset``) to the same names of
``paddle_tpu_torch``, refuses any other import of ``paddle_tpu`` or
``jax``, compiles the result under the original file name and binds its
tests and test classes here.

Bound: all of ``test_quantization.py`` (7), ``test_sparse.py`` (6) and
``test_sparse_nn_functional.py`` (10, its oracle is torch's dense ops);
``test_subsystems.py``'s ``test_distribution_normal``,
``test_distribution_rsample_grad``,
``test_distribution_categorical_bernoulli``, ``test_sparse_coo``,
``test_quantization_qat_and_ptq``, ``test_cpp_extension_load`` and
``test_unique_name_and_run_check``; ``test_api_extras.py``'s
``TestBatchAndReader``. None of their bodies imports jax.
``test_api_extras.py``'s ``TestDecomposition`` imports ``jax.numpy`` and is
restated in ``test_torch_tail_modules.py``.
"""
import ast
import os
import re

import pytest

import paddle_tpu_torch
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
# file -> its top-level tests (functions or classes) that are bound
KEEP = {
    "test_quantization.py": (
        "test_qat_default_wraps_linear_and_conv",
        "test_config_priority_instance_over_name_over_type",
        "test_quanter_factory_and_custom_mapping",
        "test_qat_trains_and_stays_close",
        "test_channelwise_weight_quanter_smaller_error",
        "test_ptq_calibrate_convert", "test_observers"),
    "test_sparse.py": (
        "test_unary_value_ops", "test_binary_and_matrix_ops",
        "test_structure_ops", "test_pca_lowrank_reconstructs",
        "test_nn_layers", "test_submanifold_preserves_support"),
    "test_sparse_nn_functional.py": (
        "test_conv3d_matches_torch_dense", "test_conv2d_matches_torch_dense",
        "test_subm_conv3d_support_and_values",
        "test_subm_conv2d_support_preserved",
        "test_max_pool3d_matches_torch", "test_activations_value_semantics",
        "test_functional_softmax_stored_entries_only",
        "test_sparse_attention_vs_numpy_oracle",
        "test_sparse_attention_padding_and_attn_masks",
        "test_layers_delegate_to_functional"),
    "test_subsystems.py": (
        "test_distribution_normal", "test_distribution_rsample_grad",
        "test_distribution_categorical_bernoulli", "test_sparse_coo",
        "test_quantization_qat_and_ptq", "test_cpp_extension_load",
        "test_unique_name_and_run_check"),
    "test_api_extras.py": ("TestBatchAndReader",),
}
PORTED = ("nn", "quantization", "sparse", "distribution", "utils",
          "utils.cpp_extension", "reader", "dataset")
PORTED_NAMES = {"nn"}
IMPORT = re.compile(r"^(\s*)(from|import)\s+paddle_tpu(\.[\w.]+)?(\s.*)$")
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(paddle_tpu|jax)\b(?!_)")


def _rewrite(line):
    m = IMPORT.match(line)
    if m is None:
        return line
    indent, kind, mod, rest = m.groups()
    if mod is None:
        ok = (kind == "import" and rest.strip() == "as paddle") or (
            kind == "from" and rest.strip().startswith("import ")
            and {n.strip() for n in rest.strip()[7:].split(",")}
            <= PORTED_NAMES)
    else:
        ok = mod[1:] in PORTED
    if not ok:
        return line
    return f"{indent}{kind} paddle_tpu_torch{mod or ''}{rest}"


def _port_source(path, keep=()):
    with open(path) as f:
        src = f.read()
    lines = src.splitlines(keepends=True)
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) \
                and node.name.lower().startswith("test") \
                and node.name not in keep:
            first = min([node.lineno] + [d.lineno
                                          for d in node.decorator_list])
            for i in range(first - 1, node.end_lineno):
                lines[i] = "\n"
    lines = [_rewrite(line.rstrip("\n")) + "\n" for line in lines]
    foreign = [line for line in lines if FOREIGN_IMPORT.match(line)]
    assert not foreign, f"{path} still imports {foreign}"
    return "".join(lines)


def _bind(fname, keep):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path}
    exec(compile(_port_source(path, keep), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if (k.startswith("test_") and callable(v))
             or (k.startswith("Test") and isinstance(v, type))}
    clash = set(tests) & set(globals())
    assert not clash, f"{fname}: names already bound here: {clash}"
    globals().update(tests)
    return sorted(tests)


N_BOUND = {fname: _bind(fname, keep) for fname, keep in KEEP.items()}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    paddle_tpu_torch.set_device("cpu")
    yield


def test_every_tail_reference_test_is_bound():
    assert N_BOUND == {k: sorted(v) for k, v in KEEP.items()}
    counts = {}
    for fname, names in KEEP.items():
        with open(os.path.join(HERE, fname)) as f:
            tree = ast.parse(f.read())
        counts[fname] = sum(
            len([m for m in n.body if isinstance(m, ast.FunctionDef)
                 and m.name.startswith("test_")])
            if isinstance(n, ast.ClassDef) else 1
            for n in tree.body if getattr(n, "name", "") in names)
    assert counts == {"test_quantization.py": 7, "test_sparse.py": 6,
                      "test_sparse_nn_functional.py": 10,
                      "test_subsystems.py": 7, "test_api_extras.py": 3}
