"""The reference's own auto-tuner and MoE exchange tests, run against the
port.

Two reference files are bound here, the design of
``test_torch_training_reference_tests.py``: this module reads each file's
source, blanks every top-level test (function or class) but those in
``KEEP``, rewrites the imports of the ported modules (``import paddle_tpu as
paddle``, ``paddle_tpu.observability``, ``paddle_tpu.distributed``'s
``auto_tuner``, ``planner`` and ``utils``, ``from paddle_tpu import nn``) to
the same names of ``paddle_tpu_torch``, refuses any other import of
``paddle_tpu`` or ``jax``, compiles the result under the original file name
and binds its tests, test classes and fixtures here (the autouse
``_metrics_on`` of test_auto_tuner_telemetry.py among them).

Bound: 9 of the 10 tests of ``test_auto_tuner_telemetry.py``; its
``test_planner_rules_lockstep`` builds ``Planner("v5e")``, a TPU the port
has no figures for, and is restated for the H100 in
``test_torch_planner.py``. ``TestMoeCommOps`` of ``test_incubate_extras.py``
(``test_global_scatter_gather_roundtrip``).
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
    "test_auto_tuner_telemetry.py": (
        "test_tune_selects_best_from_registry_scores",
        "test_recompile_penalty_orders_candidates",
        "test_uniform_signal_rescoring_never_mixes_scales",
        "test_trial_log_warm_start_skips_completed",
        "test_trial_log_corrupt_tail_does_not_poison",
        "test_pinned_source_never_reuses_other_mode_trials",
        "test_mixed_mode_run_fn_aborts_loudly",
        "test_wallclock_mode_backward_compatible",
        "test_prune_by_planner_refuses_and_annotates",
    ),
    "test_incubate_extras.py": ("TestMoeCommOps",),
}
# the tests of those files that are not bound here, and where they are
# restated
RESTATED = {"test_planner_rules_lockstep": "test_torch_planner.py"}
PORTED = ("observability", "distributed.auto_tuner", "distributed.planner",
          "distributed.utils")
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


N_BOUND = {fname: _bind(fname, keep) for fname, keep in KEEP.items()}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    paddle_tpu_torch.set_device("cpu")


def test_every_auto_parallel_reference_test_is_bound():
    assert N_BOUND == {k: sorted(v) for k, v in KEEP.items()}


def test_every_telemetry_test_is_bound_or_restated():
    """The 10 tests of test_auto_tuner_telemetry.py: 9 bound, 1 restated,
    and the restated name is a test of the file named."""
    with open(os.path.join(HERE, "test_auto_tuner_telemetry.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    bound = set(KEEP["test_auto_tuner_telemetry.py"])
    assert len(names) == 10 and not bound & set(RESTATED)
    assert names == bound | set(RESTATED)
    for name, where in RESTATED.items():
        with open(os.path.join(HERE, where)) as f:
            assert name in f.read(), (name, where)
