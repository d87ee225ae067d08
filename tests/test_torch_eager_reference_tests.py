"""The reference's own eager, nn and optimizer tests, run against the port.

Each file in FILES imports the reference only through the import lines in
``REWRITES`` (``import paddle_tpu as paddle``, ``import
paddle_tpu.nn.functional as F``, ``from paddle_tpu import nn``,
``from paddle_tpu.nn.utils import (...)``), and jax not at all. This module
reads each file's source, rewrites those lines to the same names from
``paddle_tpu_torch``, refuses any other import of ``paddle_tpu`` or
``jax``, compiles the result under the original file name and binds its
``test_*`` functions and ``Test*`` classes here, so that each runs against
the port with the reference's own assertions. The reference modules
themselves (``sys.modules["paddle_tpu"]`` and below) are left alone: other
test modules in the same worker import them.
"""
import os
import re

import pytest

import paddle_tpu_torch
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ("test_tensor.py", "test_autograd.py", "test_nn_torch_oracle.py",
         "test_transformer_torch_oracle.py", "test_optimizer_torch_oracle.py",
         "test_lr_torch_oracle.py", "test_nn_utils.py")
# (import line of the reference, the same names from the port); a line is
# rewritten only when it starts with one of these, whole
REWRITES = (
    ("import paddle_tpu as paddle", "import paddle_tpu_torch as paddle"),
    ("import paddle_tpu.nn.functional as F",
     "import paddle_tpu_torch.nn.functional as F"),
    ("from paddle_tpu import nn", "from paddle_tpu_torch import nn"),
    ("from paddle_tpu.nn.utils import (",
     "from paddle_tpu_torch.nn.utils import ("),
)
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(paddle_tpu|jax)\b(?!_)")


def _port_source(path):
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    for i, line in enumerate(lines):
        for ref, port in REWRITES:
            if line.rstrip("\n") == ref or (ref.endswith("(")
                                            and line.startswith(ref)):
                lines[i] = line.replace(ref, port, 1)
    foreign = [line for line in lines if FOREIGN_IMPORT.match(line)]
    assert not foreign, f"{path} still imports {foreign}"
    return "".join(lines)


def _bind(fname):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path}
    exec(compile(_port_source(path), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if (k.startswith("test_") and callable(v))
             or (k.startswith("Test") and isinstance(v, type))}
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
    # functions, and classes (test_nn_torch_oracle.py: TestConv, TestPool,
    # TestNorm, TestInterpolate, TestLosses)
    assert N_BOUND == {"test_tensor.py": 14, "test_autograd.py": 18,
                       "test_nn_torch_oracle.py": 5,
                       "test_transformer_torch_oracle.py": 2,
                       "test_optimizer_torch_oracle.py": 6,
                       "test_lr_torch_oracle.py": 6, "test_nn_utils.py": 5}


def test_the_rewrite_refuses_other_reference_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.core import dispatch\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
