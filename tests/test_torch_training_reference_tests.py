"""The reference's own training-robustness tests, run against the port.

Three reference files are bound here, the design of
``test_torch_amp_reference_tests.py``: this module reads each file's
source, blanks every top-level test but those in ``KEEP``, rewrites the
imports of the ported modules (``import paddle_tpu as paddle``,
``paddle_tpu.observability``, ``_chaos``, ``io``, ``nn``, ``amp``,
``distributed``'s ``checkpoint``/``elastic``/``watchdog``, ``hapi``,
``training``, ``metric``) to the same names of ``paddle_tpu_torch``,
refuses any other import of ``paddle_tpu`` or ``jax``, compiles the result
under the original file name and binds its tests and fixtures here (the
autouse ``_metrics_on`` of test_train_robustness.py among them).

Bound: 23 of the 29 tests of ``test_train_robustness.py``; its two that
poison a gradient through ``jax.numpy`` (``test_step_guard_checks_grads_
when_asked``, ``test_step_guard_is_amp_scaler_aware``) are restated in
``test_torch_training.py``, and its four DataLoader tests were restated in
``test_torch_io.py`` by the io slice. All 3 of
``test_metric_sklearn_oracle.py``. The three ``FileKVStore``/
``ElasticManager`` tests of ``test_elastic_fault.py``; its TCP-store and
launcher tests wait for ROADMAP queue 1, items 5-6.
"""
import ast
import os
import re

import pytest

import paddle_tpu_torch
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
# file -> its top-level tests that are bound
KEEP = {
    "test_train_robustness.py": (
        "test_step_guard_skips_nonfinite_step_and_ticks_counters",
        "test_step_guard_circuit_breaker_aborts_with_diagnostic",
        "test_step_watchdog_aborts_hung_step",
        "test_step_watchdog_names_stragglers",
        "test_watchdog_abort_token_consumed_exactly_once",
        "test_watchdog_monitor_hibernates_when_idle_and_rearms",
        "test_watchdog_rearm_after_trip_is_monitored",
        "test_watchdog_default_abort_refused_off_main_thread",
        "test_hang_report_flags_wedged_collective",
        "test_sigterm_flushes_committed_checkpoint_and_stops",
        "test_preempted_callback_is_reusable_for_the_resume_fit",
        "test_preemption_handler_restores_disposition",
        "test_chaos_preempt_site_drives_the_flush_path",
        "test_checkpoint_save_chaos_leaves_dir_uncommitted",
        "test_resume_equivalence_bitwise",
        "test_resume_equivalence_across_epochs",
        "test_resume_at_epoch_boundary_does_not_replay_epoch_end",
        "test_crashed_fit_still_restores_sigterm_handler",
        "test_watchdog_trip_state_clears_on_rearm",
        "test_resume_restores_lazy_optimizer_accumulators",
        "test_resume_restores_lr_scheduler_and_global_step",
        "test_run_resilient_bounded_retries_with_backoff",
        "test_chaos_env_spec_training_sites_roundtrip",
    ),
    "test_metric_sklearn_oracle.py": (
        "test_accuracy_top1",
        "test_precision_recall_binary",
        "test_auc_close_to_sklearn",
    ),
    "test_elastic_fault.py": (
        "test_membership_join_and_leave",
        "test_scale_out_triggers_on_change",
        "test_filekvstore_gc_purges_expired_entries",
    ),
}
# the tests of test_train_robustness.py that are not bound here, and where
# they are restated
RESTATED = {
    "test_step_guard_checks_grads_when_asked": "test_torch_training.py",
    "test_step_guard_is_amp_scaler_aware": "test_torch_training.py",
    "test_dataloader_seed_refused_with_external_sampler":
        "test_torch_io.py",
    "test_dataloader_state_roundtrip_replays_exact_order":
        "test_torch_io.py",
    "test_dataloader_resume_refuses_seed_mismatch": "test_torch_io.py",
    "test_prefetch_worker_exits_when_iterator_abandoned":
        "test_torch_io.py",
}
# modules of paddle_tpu whose imports are rewritten to paddle_tpu_torch's,
# and the names "from paddle_tpu import ..." may take
PORTED = ("observability", "amp", "distributed", "distributed.elastic",
          "distributed.watchdog", "distributed.checkpoint", "hapi",
          "training", "metric", "io")
PORTED_NAMES = {"_chaos", "io as pio", "nn"}
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
             if k.startswith("test_") and callable(v)}
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


def test_every_training_reference_test_is_bound():
    assert N_BOUND == {k: sorted(v) for k, v in KEEP.items()}
    assert {k: len(v) for k, v in N_BOUND.items()} == {
        "test_train_robustness.py": 23, "test_metric_sklearn_oracle.py": 3,
        "test_elastic_fault.py": 3}


def test_every_robustness_test_is_bound_or_restated():
    """The 29 tests of test_train_robustness.py: 23 bound, 6 restated, and
    each restated name is a test of the file named."""
    with open(os.path.join(HERE, "test_train_robustness.py")) as f:
        names = {n.name for n in ast.parse(f.read()).body
                 if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")}
    bound = set(KEEP["test_train_robustness.py"])
    assert len(names) == 29 and not bound & set(RESTATED)
    assert names == bound | set(RESTATED)
    for fname in set(RESTATED.values()):
        with open(os.path.join(HERE, fname)) as f:
            src = f.read()
        # each restatement names the reference test it restates
        for name, where in RESTATED.items():
            if where == fname:
                assert name in src, (name, fname)


def test_the_rewrite_refuses_other_reference_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.jit import to_static\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("import paddle_tpu as paddle\n"
                    "def test_x():\n"
                    "    from paddle_tpu.training import StepGuard\n"
                    "def test_y():\n"
                    "    import jax.numpy as jnp\n")
    assert _port_source(str(path), keep=("test_x",)) == (
        "import paddle_tpu_torch as paddle\n"
        "def test_x():\n"
        "    from paddle_tpu_torch.training import StepGuard\n"
        "\n\n")
