"""The reference's own AMP tests, run against the port.

The AMP tests of two reference files are bound here, the design of
``test_torch_serving_reference_tests.py``: this module reads each file's
source, blanks every top-level test function and test class but those in
``KEEP``, rewrites the imports of the ported modules in ``PORTED``
(``import paddle_tpu as paddle``, ``from paddle_tpu import nn``,
``paddle_tpu.core.flags``, ``paddle_tpu.core``'s ``flags``,
``paddle_tpu.amp.debugging``) to the same names of ``paddle_tpu_torch``,
refuses any other import of ``paddle_tpu`` or ``jax``, compiles the result
under the original file name and binds its tests and its fixtures (the
autouse ``_restore_flags`` of test_flags_effects.py among them) here.

Bound: ``test_flags_effects.py::test_low_precision_op_list`` and
``test_incubate_extras.py::TestAmpDebugging`` (``test_operator_stats``,
``test_check_numerics_raises_on_nan``). No AMP test of the two files is
left out. Since the jit slice, ``test_flags_effects.py``'s two jit flag
tests too (``test_max_specializations_flag_caps_jit``,
``test_print_jaxpr_flag``), on the ``aot_eager`` backend
(``force_cpu``). The files' other tests exercise modules of other slices
(``device``, ``distributed``, ``incubate``'s asp/autograd/optimizer,
``nn.quant``, ``utils.dlpack``).
``test_models.py``'s AMP test, ``test_bert_amp_o2``, is bound with the
other model tests in ``test_torch_serving_reference_tests.py``.
"""
import ast
import os
import re

import pytest

from paddle_tpu_torch._testing import force_cpu
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
# file -> its top-level tests that are bound
KEEP = {
    "test_flags_effects.py": ("test_low_precision_op_list",
                              "test_max_specializations_flag_caps_jit",
                              "test_print_jaxpr_flag"),
    "test_incubate_extras.py": ("TestAmpDebugging",),
}
# modules of paddle_tpu whose imports are rewritten to paddle_tpu_torch's,
# and the names "from paddle_tpu import ..." may take
PORTED = ("core", "core.flags", "amp", "amp.debugging")
PORTED_NAMES = {"nn", "amp"}
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
    force_cpu()


def test_every_amp_reference_test_is_bound():
    assert N_BOUND == {k: sorted(v) for k, v in KEEP.items()}


def test_the_rewrite_refuses_other_reference_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.jit import to_static\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("import paddle_tpu as paddle\n"
                    "def test_x():\n"
                    "    import paddle_tpu.amp.debugging as dbg\n"
                    "def test_y():\n"
                    "    import paddle_tpu.jit\n")
    assert _port_source(str(path), keep=("test_x",)) == (
        "import paddle_tpu_torch as paddle\n"
        "def test_x():\n"
        "    import paddle_tpu_torch.amp.debugging as dbg\n"
        "\n\n")
