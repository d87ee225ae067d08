"""The reference's own eager tests, run against the port.

``tests/test_tensor.py`` and ``tests/test_autograd.py`` import
``paddle_tpu as paddle`` and nothing else of the reference or of jax. This
module reads each file's source, swaps that one import line for
``import paddle_tpu_torch as paddle``, compiles the result under the
original file name and binds its ``test_*`` functions here, so that each
runs against the port with the reference's own assertions. The reference
module itself (``sys.modules["paddle_tpu"]``) is left alone: other test
modules in the same worker import it.
"""
import os
import re

import pytest

import paddle_tpu_torch

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ("test_tensor.py", "test_autograd.py")
REFERENCE_IMPORT = "import paddle_tpu as paddle"
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(paddle_tpu|jax)\b(?!_)")


def _port_source(path):
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    hits = [i for i, line in enumerate(lines)
            if line.strip() == REFERENCE_IMPORT]
    assert len(hits) == 1, f"{path}: {len(hits)} lines {REFERENCE_IMPORT!r}"
    lines[hits[0]] = lines[hits[0]].replace(
        REFERENCE_IMPORT, "import paddle_tpu_torch as paddle")
    foreign = [line for line in lines if FOREIGN_IMPORT.match(line)]
    assert not foreign, f"{path} still imports {foreign}"
    return "".join(lines)


def _bind(fname):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path}
    exec(compile(_port_source(path), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if k.startswith("test_") and callable(v)}
    clash = set(tests) & set(globals())
    assert not clash, f"{fname}: test names already bound here: {clash}"
    globals().update(tests)
    return len(tests)


N_BOUND = {fname: _bind(fname) for fname in FILES}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    paddle_tpu_torch.set_device("cpu")
    paddle_tpu_torch.seed(2024)
    yield


def test_every_reference_test_is_bound():
    assert N_BOUND == {"test_tensor.py": 14, "test_autograd.py": 18}
