"""The port's native host runtime (``paddle_tpu_torch.native``) on the CPU.

The MultiSlot parser against the plain Python parser and against the
reference's plain parser (``InMemoryDataset._py_parse``: the reference's
loader, run without its native library), collate bit-equal to ``np.stack``
(and the DataLoader's collation through it, in one process and in forked
workers), the fused image transform against its numpy form, a build by six
concurrent importers that ends in one library, and the reference's library
left alone. The reference's own ``tests/test_native.py`` is bound to the
port in ``test_torch_host_runtime_reference_tests.py``.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.distributed as P_dist
import paddle_tpu_torch as T
from paddle_tpu_torch import native
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_SO = os.path.join(ROOT, "paddle_tpu", "native", "libpaddle_native.so")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")


def _multislot(path, rows, seed):
    """A MultiSlot file of ``rows`` rows: a ragged id slot (0-3 ids, a row
    with none among them), a one-id slot and a float slot of 2 values,
    exact in float32 (multiples of 1/1024), so both parsers agree bit for
    bit."""
    rs = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(rows):
            n = rs.randint(0, 4)
            ids = rs.randint(0, 10 ** 6, n)
            vals = rs.randint(-4096, 4096, 2) / 1024.0
            f.write(" ".join([str(n)] + [str(i) for i in ids]
                             + ["1", str(rs.randint(0, 99))]
                             + ["2"] + [repr(float(v)) for v in vals])
                    + "\n")


SLOTS = [False, False, True]


@pytest.mark.parametrize("rows", [7, 5000])
def test_native_parser_equals_the_python_parsers(tmp_path, rows):
    """5000 rows exceed 64 KiB, so the native parser splits the file over
    its threads."""
    path = tmp_path / "part-0"
    _multislot(path, rows, seed=rows)
    got = native.parse_multislot_file(str(path), SLOTS)
    plain = native.parse_multislot_file_py(str(path), SLOTS)
    ref = P_dist.InMemoryDataset._py_parse(str(path), SLOTS)
    assert len(got) == len(plain) == len(ref) == 3
    for (v, o), (pv, po), (rv, ro) in zip(got, plain, ref):
        assert v.dtype == pv.dtype == rv.dtype
        np.testing.assert_array_equal(v, pv)
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(o, po)
        np.testing.assert_array_equal(o, ro)
    assert got[0][1][-1] < rows * 3 and len(got[1][0]) == rows


def test_parser_refuses_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_multislot_file(str(tmp_path / "nope"), SLOTS)


@pytest.mark.parametrize("shape,dtype", [((3, 32, 32), np.float32),
                                         ((64, 64), np.int64),
                                         ((5,), np.float64),
                                         ((2, 3, 224, 7), np.uint8)])
def test_collate_is_bit_equal_to_np_stack(shape, dtype):
    rs = np.random.RandomState(0)
    samples = [(rs.randn(*shape) * 100).astype(dtype) for _ in range(9)]
    out = native.collate(samples)
    assert out.dtype == dtype and out.shape == (9,) + shape
    np.testing.assert_array_equal(out, np.stack(samples))
    # mixed shapes go to np.stack, which refuses them
    with pytest.raises(ValueError):
        native.collate(samples + [np.zeros((1,), dtype)])


def test_fused_transform_equals_its_numpy_form():
    rs = np.random.RandomState(0)
    imgs = [rs.randint(0, 256, (8, 6, 3), dtype=np.uint8) for _ in range(5)]
    mean, std = [0.48, 0.45, 0.4], [0.22, 0.23, 0.21]
    out = native.u8hwc_to_f32chw_batch(imgs, mean, std)
    np.testing.assert_allclose(
        out, native.u8hwc_to_f32chw_batch_py(imgs, mean, std),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="3 values"):
        native.u8hwc_to_f32chw_batch(imgs, mean[:2], std)


class _Big(T.io.Dataset):
    """Samples of 64 KiB, at the gate of the native collate."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        return np.full((128, 128), i, np.float32) + np.arange(
            128, dtype=np.float32), i


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_collates_through_native(workers, monkeypatch):
    calls = []
    real = native.collate
    monkeypatch.setattr(native, "collate",
                        lambda arrs: calls.append(len(arrs)) or real(arrs))
    batches = list(T.io.DataLoader(_Big(), batch_size=4,
                                   num_workers=workers))
    want = np.stack([_Big()[i][0] for i in range(4)])
    np.testing.assert_array_equal(batches[0][0].numpy(), want)
    assert batches[1][1].numpy().tolist() == [4, 5, 6, 7]
    if workers == 0:        # forked workers patch their own copy
        assert calls == [4, 4]
    # small samples stay on np.stack, the reference's 16 KiB ones too
    calls.clear()
    T.io.default_collate_fn([np.zeros(3, np.float32)] * 4)
    T.io.default_collate_fn([np.zeros((64, 64), np.float32)] * 4)
    assert calls == []


_IMPORTER = """
import sys
sys.path.insert(0, sys.argv[1])
import native
print(native.build())
"""


def test_six_concurrent_importers_build_one_library(tmp_path):
    """Six processes import a fresh copy of the package and build it at
    once: one compiles under the lock, the others load its library; no
    temporary file is left. The reference's library is not touched."""
    before = os.stat(REF_SO).st_mtime_ns if os.path.exists(REF_SO) else None
    pkg = tmp_path / "pkg" / "native"
    shutil.copytree(os.path.dirname(native.__file__), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    procs = [subprocess.Popen([sys.executable, "-c", _IMPORTER,
                               str(tmp_path / "pkg")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    built = sorted(os.listdir(pkg / "_build"))
    assert built == sorted(["lock", os.path.basename(paths.pop())])
    assert not native.library_path().startswith(
        os.path.dirname(REF_SO) + os.sep)
    after = os.stat(REF_SO).st_mtime_ns if os.path.exists(REF_SO) else None
    # the reference's own tests may build it meanwhile, never rebuild it
    assert before is None or after == before


def test_build_failure_raises_with_the_compiler_output(tmp_path):
    """No silent fallback: a source that does not compile raises."""
    pkg = tmp_path / "native"
    shutil.copytree(os.path.dirname(native.__file__), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for src in (pkg / "src").iterdir():
        src.unlink()
    (pkg / "src" / "broken.cc").write_text("int f( {\n")
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]);"
         " import native; native.get_lib()", str(tmp_path)],
        capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "g++ failed" in out.stderr and "broken.cc" in out.stderr
