"""The reference's own tests of the slice's modules, run against the port.

Five reference files are bound here, the design of
``test_torch_host_runtime_reference_tests.py``: this module reads each
file's source, blanks every top-level test (function or class) but those in
``KEEP``, rewrites the imports of the ported modules (``import paddle_tpu
as paddle``, ``from paddle_tpu import nn``/``incubate``, and
``paddle_tpu.incubate``'s ``asp`` and ``autograd``, ``paddle_tpu.audio``'s
``functional`` and ``features``, ``paddle_tpu.text``) to the same names of
``paddle_tpu_torch``, refuses any other import of ``paddle_tpu`` or
``jax``, compiles the result under the original file name and binds its
tests and test classes here.

Bound: ``test_incubate_extras.py``'s ``TestASP``,
``TestIncubateAutograd`` and ``TestLookAheadModelAverage``; the 6 tests
of ``test_incubate_toplevel.py``; all of ``test_audio_text.py``;
``test_api_extras.py``'s ``TestHermitianFFT``; ``test_subsystems.py``'s
``test_incubate_fused_ops``. None of their bodies imports jax.
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
    "test_incubate_extras.py": ("TestASP", "TestIncubateAutograd",
                                "TestLookAheadModelAverage"),
    "test_incubate_toplevel.py": (
        "test_all_matches_reference", "test_segment_alias",
        "test_identity_loss_reductions", "test_graph_send_recv_legacy_name",
        "test_graph_khop_sampler_two_hops", "test_jit_inference_decorator"),
    "test_audio_text.py": ("TestAudioFunctional", "TestTextViterbi",
                           "TestSignalStft"),
    "test_api_extras.py": ("TestHermitianFFT",),
    "test_subsystems.py": ("test_incubate_fused_ops",),
}
PORTED = ("incubate", "incubate.asp", "incubate.autograd",
          "incubate.nn.functional", "audio",
          "audio.functional", "audio.features", "text")
PORTED_NAMES = {"nn", "incubate"}
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


def test_every_breadth_reference_test_is_bound():
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
    assert counts == {"test_incubate_extras.py": 6,
                      "test_incubate_toplevel.py": 6,
                      "test_audio_text.py": 8, "test_api_extras.py": 1,
                      "test_subsystems.py": 1}
