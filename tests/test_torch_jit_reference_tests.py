"""The reference's own jit, static and predictor tests, run against the port.

Built like ``test_torch_training_reference_tests.py``: this module reads
each reference file's source, blanks every top-level test function and test
class but those in ``KEEP``, rewrites the imports of the ported modules
(``import paddle_tpu as paddle``, ``from paddle_tpu import nn``,
``paddle_tpu.jit``, ``.static``, ``.inference``, ``.observability``,
``.hapi``, ``.metric``, ``.models.llama``, ``.vision``'s ``datasets`` and
``models``, ``.nn``, ``.nn.functional``, ``.core.flags``) to the same names
of ``paddle_tpu_torch``, refuses any other import of ``paddle_tpu`` or
``jax``, compiles the result under the original file name and binds its
tests and fixtures here (the autouse ``_metrics_on`` of
test_observability.py among them). Every test runs on the CPU with the
``aot_eager`` backend (``force_cpu``).

Bound: all 11 of ``test_sot_guards.py``, all 7 of
``test_symbolic_shapes.py``, all 3 of ``test_hapi_static.py``, 6 of the 7
of ``test_inference.py`` (``test_share_external_data_zero_copy`` adopts a
``jax.numpy`` array; ``test_torch_inference.py`` states it again with a
torch tensor), ``test_api_extras.py``'s ``TestJitExport``,
``TestGraphBreakFallback`` (2) and ``TestDynamicShapeExport``,
``test_subsystems.py::test_inference_predictor`` and two tests of
``test_observability.py``. ``test_observability.py::
test_compile_counter_on_toy_jit_fn`` counts the compiles of a ``jax.jit``
function and fails on the reference itself; ``test_torch_jit.py`` states
it again for a ``to_static`` function.
"""
import ast
import os
import re

import pytest

import paddle_tpu_torch
from paddle_tpu_torch._testing import force_cpu
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
# file -> its top-level tests (functions or classes) that are bound
KEEP = {
    "test_sot_guards.py": (
        "test_value_dependent_branch_two_specializations",
        "test_no_branching_single_spec_no_probe",
        "test_int_specialization_guard",
        "test_item_and_float_guards",
        "test_volatile_float_guard_falls_back_fast",
        "test_specialization_limit_falls_back",
        "test_branches_with_different_pytree_structures",
        "test_nested_static_function_inlines",
        "test_untraceable_numpy_falls_back_per_signature",
        "test_train_step_with_loss_conditional_stays_compiled",
        "test_sot_report_module_level",
    ),
    "test_symbolic_shapes.py": (
        "test_train_step_serves_two_batch_sizes_bounded",
        "test_shape_cap_falls_back_to_eager",
        "test_padded_buckets_one_executable_exact_rows",
        "test_pad_mode_refuses_stateful_train",
        "test_pad_mode_spares_batch_independent_outputs",
        "test_rank_mismatch_raises_clear_error",
        "test_pad_mask_bucketed_train_matches_unpadded",
    ),
    "test_hapi_static.py": (
        "test_hapi_fit_evaluate_predict",
        "test_metrics",
        "test_static_executor_roundtrip",
    ),
    "test_inference.py": (
        "test_basic_predict_and_handles",
        "test_low_precision_pass",
        "test_int8_weight_only_pass",
        "test_shape_bucketing_bounds_executables",
        "test_async_predict",
        "test_stats_and_warmup",
    ),
    "test_api_extras.py": (
        "TestJitExport", "TestGraphBreakFallback", "TestDynamicShapeExport",
    ),
    "test_subsystems.py": ("test_inference_predictor",),
    "test_observability.py": (
        "test_global_compile_counter_and_static_function_stats",
        "test_pad_mask_arg_unbound_dynamic_dim_raises_clear_error",
    ),
}
# the tests of the files above that are not bound, and where each is
# restated
RESTATED = {
    "test_inference.py::test_share_external_data_zero_copy":
        "test_torch_inference.py",
    "test_observability.py::test_compile_counter_on_toy_jit_fn":
        "test_torch_jit.py",
}
# modules of paddle_tpu whose imports are rewritten to paddle_tpu_torch's,
# and the names "from paddle_tpu import ..." may take
PORTED = ("jit", "static", "inference", "inference.decode", "observability",
          "observability.metrics", "hapi", "metric", "models.llama",
          "vision.datasets", "vision.models", "nn", "nn.functional",
          "core.flags")
PORTED_NAMES = {"nn", "observability as obs"}
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


def _is_fixture(obj):
    return type(obj).__name__ == "FixtureFunctionDefinition"


def _bind(fname, keep):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path}
    exec(compile(_port_source(path, keep), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if (k.startswith("test_") and callable(v))
             or (k.startswith("Test") and isinstance(v, type))}
    fixtures = {k: v for k, v in ns.items() if _is_fixture(v)}
    clash = (set(tests) | set(fixtures)) & set(globals())
    assert not clash, f"{fname}: names already bound here: {clash}"
    globals().update(fixtures)
    globals().update(tests)
    return sorted(tests)


force_cpu()
N_BOUND = {fname: _bind(fname, keep) for fname, keep in KEEP.items()}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    force_cpu()


def test_every_jit_reference_test_is_bound():
    assert N_BOUND == {k: sorted(v) for k, v in KEEP.items()}
    assert {k: len(v) for k, v in N_BOUND.items()} == {
        "test_sot_guards.py": 11, "test_symbolic_shapes.py": 7,
        "test_hapi_static.py": 3, "test_inference.py": 6,
        "test_api_extras.py": 3, "test_subsystems.py": 1,
        "test_observability.py": 2}


def test_every_file_is_bound_whole_or_restated():
    """test_sot_guards.py, test_symbolic_shapes.py, test_hapi_static.py and
    test_inference.py: each test is bound or restated, and each restated
    name is a test of the file that restates it."""
    for fname in ("test_sot_guards.py", "test_symbolic_shapes.py",
                  "test_hapi_static.py", "test_inference.py"):
        with open(os.path.join(HERE, fname)) as f:
            names = {n.name for n in ast.parse(f.read()).body
                     if isinstance(n, ast.FunctionDef)
                     and n.name.startswith("test_")}
        restated = {k.split("::")[1] for k in RESTATED
                    if k.startswith(fname + "::")}
        assert names == set(KEEP[fname]) | restated, fname
    for key, where in RESTATED.items():
        with open(os.path.join(HERE, where)) as f:
            assert key.split("::")[1] in f.read(), (key, where)


def test_the_rewrite_refuses_other_reference_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.distributed import fleet\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("import paddle_tpu as paddle\n"
                    "def test_x():\n"
                    "    from paddle_tpu.jit import to_static\n"
                    "def test_y():\n"
                    "    import jax.numpy as jnp\n")
    assert _port_source(str(path), keep=("test_x",)) == (
        "import paddle_tpu_torch as paddle\n"
        "def test_x():\n"
        "    from paddle_tpu_torch.jit import to_static\n"
        "\n\n")


def test_the_port_is_what_runs():
    assert paddle_tpu_torch.jit.default_backend() == "aot_eager"
    bound = globals()["test_sot_report_module_level"]
    assert bound.__globals__["paddle"] is paddle_tpu_torch
