"""The reference's own DataLoader worker tests, run against the port.

``tests/test_dataloader_mp.py`` is bound here, the design of
``test_torch_serving_reference_tests.py``: this module reads the file's
source, rewrites its imports of the ported modules (``import paddle_tpu as
paddle``, ``paddle_tpu.io``) to the same names of ``paddle_tpu_torch``,
refuses any other import of ``paddle_tpu`` or ``jax``, compiles the result
under the original file name and binds its five tests here, so that each
runs against the port with the reference's own assertions: worker batches
in the sampler's order, dict samples, ``worker_init_fn`` with
``get_worker_info``, a worker's error raised in the parent, and no worker
info in the main process. The reference file is left alone.

The three vision tests of ``test_models.py`` are bound with its other
model tests in ``test_torch_serving_reference_tests.py``.
"""
import os
import re

import pytest

import paddle_tpu_torch
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ("test_dataloader_mp.py",)
# modules of paddle_tpu whose imports are rewritten to paddle_tpu_torch's
PORTED = ("io",)
IMPORT = re.compile(r"^(\s*)(from|import)\s+paddle_tpu(\.[\w.]+)?(\s.*)$")
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(paddle_tpu|jax)\b(?!_)")


def _rewrite(line):
    m = IMPORT.match(line)
    if m is None:
        return line
    indent, kind, mod, rest = m.groups()
    if mod is None:
        ok = kind == "import" and rest.strip() == "as paddle"
    else:
        ok = mod[1:] in PORTED
    if not ok:
        return line
    return f"{indent}{kind} paddle_tpu_torch{mod or ''}{rest}"


def _port_source(path):
    with open(path) as f:
        lines = [_rewrite(line) for line in f.read().splitlines()]
    foreign = [line for line in lines if FOREIGN_IMPORT.match(line)]
    assert not foreign, f"{path} still imports {foreign}"
    return "\n".join(lines) + "\n"


def _bind(fname):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path}
    exec(compile(_port_source(path), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if k.startswith("test_") and callable(v)}
    clash = set(tests) & set(globals())
    assert not clash, f"{fname}: names already bound here: {clash}"
    globals().update(tests)
    return len(tests)


N_BOUND = {fname: _bind(fname) for fname in FILES}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    """The parent's batches land on the CPU."""
    paddle_tpu_torch.set_device("cpu")


def test_every_reference_test_is_bound():
    assert N_BOUND == {"test_dataloader_mp.py": 5}


def test_the_rewrite_refuses_other_reference_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.vision import ops\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("import jax\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))
    path.write_text("import paddle_tpu as paddle\n"
                    "from paddle_tpu.io import DataLoader\n")
    assert _port_source(str(path)) == (
        "import paddle_tpu_torch as paddle\n"
        "from paddle_tpu_torch.io import DataLoader\n")
