"""The reference's own serving tests, run against the port.

Each file in FILES imports the reference only through the serving and
model modules of ``PORTED`` (``import paddle_tpu as paddle``, ``from
paddle_tpu import nn, _chaos, inference``, ``paddle_tpu.inference.decode``,
``.inference.admission``, ``.observability``, ``.observability.server``,
``._chaos``, ``.models.llama``, ``.models.gpt``, ``.models.bert``,
``.models.moe``, ``.amp``, ``.incubate.nn``'s ``functional``, ``.io``,
``.vision``, ``.vision.models``, ``.vision.datasets``),
at the top of the file or inside a test body. This module reads each
file's source, blanks the tests that are left out (below), rewrites those
imports to the same names of ``paddle_tpu_torch``, refuses any other
import of ``paddle_tpu`` or ``jax``, compiles the result under the
original file name and binds its ``test_*`` functions and its fixtures
here, so that each test runs against the port with the reference's own
assertions. The reference modules themselves are left alone.

Left out, each stated again where it can run without jax:
- ``test_decode.py::test_int8_native_serving_export_roundtrip``: it checks
  the int8 buffer's dtype against ``jnp.int8``; ``test_torch_inference.py``
  states it again with ``torch.int8``;
- ``test_decode.py::test_cache_overflow_raises_eagerly``: it builds its
  cache through ``jax.numpy``; ``test_torch_serving.py`` states it again
  without it;
- ``test_serving_robustness.py::test_total_deadline_times_out_within_a_
  step``: its premise is a speed. It gives a 60-token request a 0.05 s
  deadline and asserts that the request times out, which holds only while
  57 decode steps of its 4-wide LM take more than 0.05 s: on an 8-core
  Intel Xeon host the reference takes ~0.51 s for them and the port
  0.044-0.059 s, so the request may finish first.
  ``test_torch_serving.py`` states the test again with the deadline
  passing while the request decodes, whatever the speed.

All nine tests of ``test_models.py`` are bound: GPT, Llama, BERT MLM,
BERT under AMP O2, the MoE layer, and since the ResNet-50 CIFAR-10 slice
``test_resnet18_fakedata_trains``, ``test_vision_model_shapes`` and
``test_transforms_pipeline`` (``vision`` and ``io``).

The two files' autouse ``_metrics_on`` fixtures (test_metrics_server.py's
and test_serving_robustness.py's) share a name, so neither is bound: the
autouse fixture below does what both do, for every bound test.
"""
import ast
import os
import re

import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import _chaos
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import server as obs_server

HERE = os.path.dirname(os.path.abspath(__file__))
# file -> the tests of it that are not bound
FILES = {
    "test_decode.py": ("test_int8_native_serving_export_roundtrip",
                       "test_cache_overflow_raises_eagerly"),
    "test_continuous_batching.py": (),
    "test_serving_robustness.py": (
        "test_total_deadline_times_out_within_a_step",),
    "test_metrics_server.py": (),
    "test_models.py": (),
}
# modules of paddle_tpu whose imports are rewritten to paddle_tpu_torch's,
# and the names "from paddle_tpu import ..." may take
PORTED = ("inference.decode", "inference.admission", "observability",
          "observability.server", "_chaos", "models.llama", "models.gpt",
          "models.bert", "models.moe", "amp", "incubate.nn", "io", "vision",
          "vision.models", "vision.datasets")
PORTED_NAMES = {"nn", "_chaos", "inference"}
AUTOUSE = {"_metrics_on"}
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


def _port_source(path, left_out=()):
    with open(path) as f:
        src = f.read()
    lines = src.splitlines(keepends=True)
    for node in ast.parse(src).body:
        if isinstance(node, ast.FunctionDef) and node.name in left_out:
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


def _bind(fname, left_out):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path}
    exec(compile(_port_source(path, left_out), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if k.startswith("test_") and callable(v)}
    fixtures = {k: v for k, v in ns.items()
                if _is_fixture(v) and k not in AUTOUSE}
    clash = (set(tests) | set(fixtures)) & set(globals())
    assert not clash, f"{fname}: names already bound here: {clash}"
    globals().update(fixtures)
    globals().update(tests)
    return len(tests)


N_BOUND = {fname: _bind(fname, left_out)
           for fname, left_out in FILES.items()}


@pytest.fixture(scope="module", autouse=True)
def _port_on_cpu():
    """The port on the CPU, before the module-scoped models are built."""
    paddle_tpu_torch.set_device("cpu")


# test_models.py's vision tests: convolutions in every layer
CONV_HEAVY = {"test_resnet18_fakedata_trains", "test_vision_model_shapes",
              "test_transforms_pipeline"}


@pytest.fixture(autouse=True)
def _share_the_cores(request):
    """Under pytest-xdist each worker's torch would start an intra-op thread
    a core, and OpenMP's barriers then wait on descheduled threads (the
    resnet18 test ran ~60x slower beside five other workers): the
    convolution-heavy tests take their worker's share of the cores."""
    threads = torch.get_num_threads()
    if request.node.name in CONV_HEAVY:
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _serving_state():
    """For every bound test: the port's metrics on; after it, the scrape
    endpoint's env, the shared server, the health providers and the chaos
    rules and env all released (the reference files' ``_metrics_on``, plus
    the chaos reset their tests make on entry)."""
    paddle_tpu_torch.set_device("cpu")
    obs.enable()
    yield
    obs.enable()
    os.environ.pop(obs_server.PORT_ENV, None)
    while obs_server.shared_server() is not None:
        obs_server.session_finished()
    obs_server._health_providers.clear()
    os.environ.pop(_chaos.ENV, None)
    _chaos.clear()


def test_every_reference_test_is_bound():
    assert N_BOUND == {"test_decode.py": 14,
                       "test_continuous_batching.py": 7,
                       "test_serving_robustness.py": 18,
                       "test_metrics_server.py": 4, "test_models.py": 9}


def test_the_rewrite_refuses_other_reference_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.inference import Config\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("from paddle_tpu import nn, amp\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("from paddle_tpu import _chaos, nn\n"
                    "def test_x():\n"
                    "    from paddle_tpu.models.llama import LlamaConfig\n")
    assert _port_source(str(path)) == (
        "from paddle_tpu_torch import _chaos, nn\n"
        "def test_x():\n"
        "    from paddle_tpu_torch.models.llama import LlamaConfig\n")
