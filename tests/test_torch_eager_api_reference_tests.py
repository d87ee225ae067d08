"""The reference's own op-library, RNN and string-tensor tests, run against
the port.

Each file in FILES reaches the reference only through its import lines of
``paddle_tpu`` (``import paddle_tpu as paddle``, ``import
paddle_tpu._C_ops as C``, ``from paddle_tpu.text import ...``, also those
inside a test function) and through ``from op_test import OpTest``.
This module reads each file's source, points every such line at the same
module of ``paddle_tpu_torch``, replaces the ``op_test`` import with the
port's twin of the harness (``OpTest`` below: ``tests/op_test.py`` imports
jax, and the conftest admits no new helper file beside it), refuses any
other import of ``paddle_tpu`` or ``jax``, compiles the result under the
original file name and binds its ``test_*`` functions and ``Test*``
classes here, so that each runs against the port with the reference's own
assertions. A name that two files share is bound a second time with the
file's stem after it. The reference modules themselves
(``sys.modules["paddle_tpu"]`` and below) are left alone. Nothing is run
through jax: the sweeps hold the port against their numpy, scipy and torch
oracles only.
"""
import os
import re

import numpy as np
import pytest

import paddle_tpu_torch
import paddle_tpu_torch as paddle
from paddle_tpu_torch._testing import force_cpu
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
FILES = ("test_ops_numeric.py", "test_ops_sweep.py", "test_ops_sweep2.py",
         "test_ops_sweep3.py", "test_ops_sweep4.py", "test_ops_sweep5.py",
         "test_rnn_torch_oracle.py", "test_string_tensor.py",
         "test_tensor_array.py")
# an import of the reference, at any indentation: the module path after
# "paddle_tpu" is kept and put under paddle_tpu_torch
REF_IMPORT = re.compile(
    r"^(\s*)(import|from)\s+paddle_tpu(?![_\w])(\S*)(\s.*)?$")
OP_TEST = re.compile(r"^\s*from\s+op_test\s+import\s+OpTest\s*$")
FOREIGN_IMPORT = re.compile(r"^\s*(import|from)\s+(paddle_tpu|jax|op_test)"
                            r"\b(?!_)")


class OpTest:
    """The port's twin of ``tests/op_test.py`` (reference:
    test/legacy_test/op_test.py:418): check_output against a numpy oracle
    eagerly and compiled (``jit.to_static``), check_grad against central
    finite differences. Subclasses set ``op`` (taking Tensors), ``ref``
    (taking numpy arrays), ``inputs``, ``attrs``, and may set the
    tolerances."""

    op = None
    ref = None
    inputs = {}
    attrs = {}
    rtol = 1e-5
    atol = 1e-6
    grad_rtol = 5e-2
    grad_atol = 5e-3
    fd_eps = 1e-3

    def _tensors(self, stop_gradient=True):
        return {k: paddle.to_tensor(v, stop_gradient=stop_gradient)
                for k, v in self.inputs.items()}

    def _run_op(self, tensors):
        return type(self).op(*tensors.values(), **self.attrs)

    def check_output(self, compiled=True):
        out = self._run_op(self._tensors())
        ref_out = type(self).ref(*[np.asarray(v)
                                   for v in self.inputs.values()],
                                 **self.attrs)
        self._compare(out, ref_out, "eager")
        if compiled:
            op, attrs = type(self).op, self.attrs

            def fn(*ts):
                return op(*ts, **attrs)
            static_fn = paddle.jit.to_static(fn, objs=[])
            self._compare(static_fn(*self._tensors().values()), ref_out,
                          "compiled")

    def _compare(self, out, ref_out, mode):
        outs = out if isinstance(out, (tuple, list)) else [out]
        refs = ref_out if isinstance(ref_out, (tuple, list)) else [ref_out]
        for i, (o, r) in enumerate(zip(outs, refs)):
            np.testing.assert_allclose(
                np.asarray(o.numpy(), np.float64)
                if o.dtype != np.bool_ else o.numpy(),
                np.asarray(r, np.float64)
                if np.asarray(r).dtype != np.bool_ else r,
                rtol=self.rtol, atol=self.atol,
                err_msg=f"{mode} output {i} mismatch")

    def check_grad(self, grad_inputs=None, output_index=0):
        names = list(grad_inputs or
                     [k for k, v in self.inputs.items()
                      if np.issubdtype(np.asarray(v).dtype, np.floating)])
        tensors = self._tensors(stop_gradient=False)
        for k in tensors:
            tensors[k].stop_gradient = k not in names
        out = self._run_op(tensors)
        out0 = (out[output_index]
                if isinstance(out, (tuple, list)) else out)
        out0.sum().backward()
        for name in names:
            analytic = tensors[name].grad.numpy().astype(np.float64)
            numeric = self._numeric_grad(name, output_index)
            np.testing.assert_allclose(
                analytic, numeric, rtol=self.grad_rtol,
                atol=self.grad_atol,
                err_msg=f"grad mismatch for input {name!r}")

    def _numeric_grad(self, name, output_index):
        """central finite differences of sum(op(...)[output_index])."""
        base = {k: np.asarray(v, np.float64).copy()
                for k, v in self.inputs.items()}
        grad = np.zeros_like(base[name])

        def f(vals):
            ts = {k: paddle.to_tensor(v.astype(self.inputs[k].dtype))
                  for k, v in vals.items()}
            out = self._run_op(ts)
            o = out[output_index] if isinstance(out, (tuple, list)) else out
            return float(np.asarray(o.numpy(), np.float64).sum())

        flat, gflat = base[name].reshape(-1), grad.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + self.fd_eps
            fp = f(base)
            flat[i] = orig - self.fd_eps
            fm = f(base)
            flat[i] = orig
            gflat[i] = (fp - fm) / (2 * self.fd_eps)
        return grad


def _port_source(path):
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    for i, line in enumerate(lines):
        if OP_TEST.match(line.rstrip("\n")):
            lines[i] = line[:len(line) - len(line.lstrip())] + "pass\n"
            continue
        m = REF_IMPORT.match(line.rstrip("\n"))
        if m:
            lines[i] = (f"{m.group(1)}{m.group(2)} paddle_tpu_torch"
                        f"{m.group(3)}{m.group(4) or ''}\n")
    foreign = [line for line in lines if FOREIGN_IMPORT.match(line)]
    assert not foreign, f"{path} still imports {foreign}"
    return "".join(lines)


# the port on the CPU while the files are executed: their module-level
# tables call the op library
force_cpu()


def _bind(fname):
    path = os.path.join(HERE, fname)
    ns = {"__name__": f"{__name__}.{fname[:-3]}", "__file__": path,
          "OpTest": OpTest}
    exec(compile(_port_source(path), path, "exec"), ns)
    tests = {k: v for k, v in ns.items()
             if (k.startswith("test_") and callable(v))
             or (k.startswith("Test") and isinstance(v, type))}
    bound = {}
    for k, v in tests.items():
        bound[f"{k}__{fname[5:-3]}" if k in globals() else k] = v
    globals().update(bound)
    return len(bound)


N_BOUND = {fname: _bind(fname) for fname in FILES}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    force_cpu()
    paddle_tpu_torch.seed(2024)
    yield


def test_every_reference_test_is_bound():
    # functions and classes (test_ops_numeric.py's 18 Test* classes,
    # test_rnn_torch_oracle.py's 2); a parametrized sweep counts once here
    # and once a case under pytest
    assert N_BOUND == {"test_ops_numeric.py": 18, "test_ops_sweep.py": 1,
                       "test_ops_sweep2.py": 1, "test_ops_sweep3.py": 4,
                       "test_ops_sweep4.py": 7, "test_ops_sweep5.py": 13,
                       "test_rnn_torch_oracle.py": 2,
                       "test_string_tensor.py": 8,
                       "test_tensor_array.py": 6}


def test_the_rewrite_refuses_other_imports(tmp_path):
    path = tmp_path / "test_foreign.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "import jax.numpy as jnp\n")
    with pytest.raises(AssertionError, match="still imports"):
        _port_source(str(path))


def test_the_rewrite_points_every_reference_import_at_the_port(tmp_path):
    path = tmp_path / "test_imports.py"
    path.write_text("import paddle_tpu as paddle\n"
                    "import paddle_tpu._C_ops as C\n"
                    "from op_test import OpTest\n"
                    "def test_x():\n"
                    "    from paddle_tpu.ops.extra import dirichlet\n")
    assert _port_source(str(path)).splitlines() == [
        "import paddle_tpu_torch as paddle",
        "import paddle_tpu_torch._C_ops as C", "pass",
        "def test_x():",
        "    from paddle_tpu_torch.ops.extra import dirichlet"]
