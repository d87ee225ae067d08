"""Builds the Hopper kernels of this package with nvcc and loads them with ctypes.

Each source ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` on first use into ``_build/`` beside this
file (listed in ``.gitignore``), under a name keyed by a hash of every file
under ``csrc/`` (the sources and the ``.cuh`` headers they share) and the
flags: an edit anywhere there rebuilds, an unchanged tree is loaded as it
is. Nothing is built when the module is imported.

    python3 -c "from paddle_tpu_torch.ops.hopper import _build; _build.build_all()"
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("simple_attention", "causal_attention", "blocked_flash")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (neither on PATH nor under CUDA_HOME): "
                       "the Hopper kernels are compiled on the machine with "
                       "the card")


def _target(name: str) -> Path:
    digest = hashlib.sha256(name.encode())
    for path in sorted(p for p in CSRC.iterdir() if p.is_file()):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Starts nvcc for one source into a temporary file; returns
    (process, temporary path, target) or None when the target exists."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> str:
    """Waits for one nvcc; moves its output into place. Returns its log."""
    proc, tmp, target = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)   # atomic: a concurrent build sees a whole file
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compiles every source that is not built yet, one nvcc per source,
    all started together. Returns {name: compiler log} of what it built."""
    started: List = [(n, _start(n)) for n in names]
    logs = {}
    try:
        for name, job in started:
            if job is not None:
                logs[name] = _finish(name, job)
    finally:
        for _, job in started:
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
