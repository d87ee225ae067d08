"""Native host runtime: ctypes bindings over the C++ sources in ``src/``
(the port's own copies of ``paddle_tpu/native/src``).

``paddle_native.cc`` collates samples into a batch and fuses the uint8 HWC
-> float32 CHW transform, and holds a blocking queue; ``store.cc`` is the
TCP key-value store; ``tracer.cc`` the host span tracer and the stats
registry; ``datafeed.cc`` the MultiSlot text parser.

The library is built with ``g++`` on first use into ``_build/`` beside this
file, under a file lock, into a temporary name that ``os.replace`` moves into
place, so concurrent importers end with one library. Its name carries a hash
of the sources, so an edited source builds anew. Unlike the reference, which
falls back to numpy when the build or the load fails, every entry point here
raises: the numpy forms (``np.stack``, ``parse_multislot_file_py``) are kept
as the plain versions that tests compare with.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "src")
BUILD_DIR = os.path.join(_DIR, "_build")
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _sources():
    return sorted(os.path.join(_SRC_DIR, f) for f in os.listdir(_SRC_DIR)
                  if f.endswith(".cc"))


def library_path() -> str:
    """Where the library of the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libpaddle_native_{h.hexdigest()[:16]}.so")


_lib = None
_lock = threading.Lock()


def build() -> str:
    """Build the library if it is not there yet; returns its path. Raises
    ``RuntimeError`` with the compiler's output if ``g++`` fails."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(so):      # another process built it meanwhile
                return so
            tmp = f"{so}.{os.getpid()}.tmp"
            try:
                out = subprocess.run(["g++", *CXXFLAGS, *_sources(), "-o",
                                      tmp], capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"native: no g++ to build {so}") from e
            if out.returncode != 0:
                raise RuntimeError(f"native: g++ failed building {so}:\n"
                                   f"{out.stderr[-4000:]}")
            os.replace(tmp, so)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def _bind(lib):
    c = ctypes
    sigs = {
        "pn_collate": (None, [c.POINTER(c.c_void_p), c.c_int64, c.c_void_p,
                              c.c_int64, c.c_int32]),
        "pn_u8hwc_to_f32chw_batch": (None, [
            c.POINTER(c.c_void_p), c.c_void_p, c.c_int64, c.c_int64,
            c.c_int64, c.c_int64, c.c_void_p, c.c_void_p, c.c_float,
            c.c_int32]),
        "pn_queue_create": (c.c_void_p, [c.c_int64]),
        "pn_queue_destroy": (None, [c.c_void_p]),
        "pn_queue_close": (None, [c.c_void_p]),
        "pn_queue_push": (c.c_int32, [c.c_void_p, c.c_void_p, c.c_int64]),
        "pn_queue_next_size": (c.c_int64, [c.c_void_p]),
        "pn_queue_pop": (c.c_int64, [c.c_void_p, c.c_void_p, c.c_int64]),
        "pn_queue_size": (c.c_int64, [c.c_void_p]),
        "pn_store_server_start": (c.c_void_p, [c.c_int32]),
        "pn_store_server_stop": (None, [c.c_void_p]),
        "pn_store_connect": (c.c_void_p, [c.c_char_p, c.c_int32,
                                          c.c_int32]),
        "pn_store_client_close": (None, [c.c_void_p]),
        "pn_store_set": (c.c_int32, [c.c_void_p, c.c_char_p, c.c_void_p,
                                     c.c_int64]),
        "pn_store_get": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_void_p,
                                     c.c_int64, c.c_int64]),
        "pn_store_add": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_int64]),
        "pn_store_check": (c.c_int32, [c.c_void_p, c.c_char_p]),
        "pn_store_delete": (c.c_int32, [c.c_void_p, c.c_char_p]),
        "pn_store_list": (c.c_int64, [c.c_void_p, c.c_char_p, c.c_void_p,
                                      c.c_int64, c.POINTER(c.c_int32)]),
        "pn_prof_enable": (None, [c.c_int32]),
        "pn_prof_enabled": (c.c_int32, []),
        "pn_prof_clear": (None, []),
        "pn_prof_begin": (None, [c.c_char_p]),
        "pn_prof_end": (None, []),
        "pn_prof_record": (None, [c.c_char_p, c.c_double, c.c_double]),
        "pn_prof_count": (c.c_int64, []),
        "pn_prof_get": (c.c_int64, [
            c.c_int64, c.c_char_p, c.c_int64, c.POINTER(c.c_double),
            c.POINTER(c.c_double), c.POINTER(c.c_int64)]),
        "pn_stat_update": (c.c_int64, [c.c_char_p, c.c_int64]),
        "pn_stat_current": (c.c_int64, [c.c_char_p]),
        "pn_stat_peak": (c.c_int64, [c.c_char_p]),
        "pn_stat_reset_peak": (None, [c.c_char_p]),
        "pn_feed_parse": (c.c_void_p, [c.c_char_p, c.c_int32,
                                       c.POINTER(c.c_int32), c.c_int32]),
        "pn_feed_rows": (c.c_int64, [c.c_void_p]),
        "pn_feed_slot_size": (c.c_int64, [c.c_void_p, c.c_int32]),
        "pn_feed_copy_slot": (None, [c.c_void_p, c.c_int32, c.c_void_p,
                                     c.POINTER(c.c_int64)]),
        "pn_feed_free": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def get_lib():
    """The loaded library, built on the first call. Raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                _bind(lib)
                _lib = lib
    return _lib


def available() -> bool:
    """True once the library is loaded; raises where it cannot be (the
    reference's returns False there)."""
    return get_lib() is not None


# --------------------------------------------------------------------------
def _ptrs(arrs):
    """The arrays' data addresses as a ``void**``: one ``uintp`` array from
    the int ``ndarray.ctypes.data`` of each (``data_as`` builds a ctypes
    object a sample, twice the cost); the pointer keeps the array alive."""
    ptrs = np.array([a.ctypes.data for a in arrs], np.uintp)
    return ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p))


def collate(samples, nthreads=4):
    """Stack equally shaped arrays into a batch with a parallel native
    memcpy; bit-equal to ``np.stack``. Arrays of mixed shapes or dtypes go
    to ``np.stack``, which raises or promotes as it always does."""
    arrs = [np.ascontiguousarray(s) for s in samples]
    first = arrs[0]
    shape, dtype = first.shape, first.dtype
    for a in arrs:
        if a.shape != shape or a.dtype != dtype:
            return np.stack(arrs)
    out = np.empty((len(arrs),) + shape, dtype)
    get_lib().pn_collate(_ptrs(arrs), len(arrs),
                         out.ctypes.data_as(ctypes.c_void_p), first.nbytes,
                         nthreads)
    return out


def u8hwc_to_f32chw_batch(images, mean, std, scale=1.0 / 255.0,
                          nthreads=4):
    """ToTensor, Normalize and the HWC -> CHW transpose in one pass over a
    batch of uint8 HWC images: float32 ``[N, C, H, W]``."""
    arrs = [np.ascontiguousarray(im, np.uint8) for im in images]
    h, w, c = arrs[0].shape
    if any(a.shape != (h, w, c) for a in arrs):
        raise ValueError("u8hwc_to_f32chw_batch: images of mixed shapes")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"u8hwc_to_f32chw_batch: mean and std need {c} "
                         "values")
    out = np.empty((len(arrs), c, h, w), np.float32)
    get_lib().pn_u8hwc_to_f32chw_batch(
        _ptrs(arrs), out.ctypes.data_as(ctypes.c_void_p), len(arrs), h, w, c,
        mean.ctypes.data_as(ctypes.c_void_p),
        std.ctypes.data_as(ctypes.c_void_p), scale, nthreads)
    return out


def u8hwc_to_f32chw_batch_py(images, mean, std, scale=1.0 / 255.0):
    """The plain numpy form of ``u8hwc_to_f32chw_batch``."""
    batch = np.stack(images).astype(np.float32) * np.float32(scale)
    batch = (batch - np.asarray(mean, np.float32).reshape(1, 1, 1, -1)) \
        / np.asarray(std, np.float32).reshape(1, 1, 1, -1)
    return batch.transpose(0, 3, 1, 2).copy()


class BlockingQueue:
    """A condition-variable blocking queue of byte blobs
    (LoDTensorBlockingQueue's analog)."""

    def __init__(self, capacity=8):
        self._lib = get_lib()
        self._handle = ctypes.c_void_p(self._lib.pn_queue_create(capacity))

    def push(self, data: bytes) -> bool:
        buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        return bool(self._lib.pn_queue_push(self._handle, buf, len(data)))

    def pop(self):
        """bytes, or None at end of stream (closed and drained)."""
        size = self._lib.pn_queue_next_size(self._handle)
        if size < 0:
            return None
        out = ctypes.create_string_buffer(size)
        got = self._lib.pn_queue_pop(self._handle, out, size)
        if got < 0:
            return None
        return out.raw[:got]

    def close(self):
        if self._handle is not None:
            self._lib.pn_queue_close(self._handle)

    def __len__(self):
        return self._lib.pn_queue_size(self._handle)

    def __del__(self):
        if getattr(self, "_handle", None) is not None:
            self._lib.pn_queue_close(self._handle)
            self._lib.pn_queue_destroy(self._handle)
            self._handle = None


# --------------------------------------------------------------------------
class TCPStore:
    """The native TCP rendezvous key-value store (reference
    phi/core/distributed/store/tcp_store.h:121): the master also runs the
    server thread, bound to ``0.0.0.0:port``. Values are bytes; ``add``
    keeps int64 counters, mirrored into the key space so ``get`` sees
    them."""

    def __init__(self, host: str, port: int, is_master: bool = False,
                 world_size: int = 1, timeout: float = 90.0):
        lib = get_lib()
        self._lib = lib
        self.host = host
        self.port = port
        self.is_master = is_master
        self.world_size = world_size
        self.timeout = timeout
        self._server = None
        self._client = None
        self._barrier_seq = {}
        if is_master:
            self._server = lib.pn_store_server_start(port)
            if not self._server:
                raise RuntimeError(f"TCPStore: cannot bind port {port}")
        self._client = lib.pn_store_connect(host.encode(), port,
                                            int(timeout * 1000))
        if not self._client:
            if self._server:
                lib.pn_store_server_stop(self._server)
                self._server = None
            raise RuntimeError(f"TCPStore: cannot connect {host}:{port}")

    def set(self, key: str, value) -> None:
        if isinstance(value, str):
            value = value.encode()
        buf = (ctypes.c_char * len(value)).from_buffer_copy(value) \
            if value else None
        if not self._lib.pn_store_set(self._client, key.encode(), buf,
                                      len(value)):
            raise RuntimeError("TCPStore.set failed")

    def get(self, key: str, timeout: float = None) -> bytes:
        """Waits until ``key`` is set, then returns its value."""
        tmo = int((self.timeout if timeout is None else timeout) * 1000)
        cap = 1 << 16
        while True:
            out = ctypes.create_string_buffer(cap)
            n = self._lib.pn_store_get(self._client, key.encode(), out, cap,
                                       tmo)
            if n == -2:                 # the value is larger than cap
                cap *= 16
                continue
            if n < 0:
                raise TimeoutError(f"TCPStore.get({key!r}) timed out")
            return out.raw[:n]

    def add(self, key: str, delta: int = 1) -> int:
        v = self._lib.pn_store_add(self._client, key.encode(), delta)
        if v == -(2 ** 63):
            raise RuntimeError("TCPStore.add failed")
        return v

    def check(self, key: str) -> bool:
        return self._lib.pn_store_check(self._client, key.encode()) == 1

    def delete_key(self, key: str) -> bool:
        return bool(self._lib.pn_store_delete(self._client, key.encode()))

    def list(self, prefix: str = "") -> dict:
        """Every (key, value) whose key starts with ``prefix``."""
        cap = 1 << 16
        while True:
            out = ctypes.create_string_buffer(cap)
            count = ctypes.c_int32()
            n = self._lib.pn_store_list(self._client, prefix.encode(), out,
                                        cap, ctypes.byref(count))
            if n == -2:
                cap *= 16
                continue
            if n < 0:
                raise RuntimeError("TCPStore.list failed")
            buf, off, res = out.raw, 0, {}
            for _ in range(count.value):
                (klen,) = struct.unpack_from("<I", buf, off)
                off += 4
                key = buf[off:off + klen].decode()
                off += klen
                (vlen,) = struct.unpack_from("<Q", buf, off)
                off += 8
                res[key] = buf[off:off + vlen]
                off += vlen
            return res

    def wait(self, keys, timeout: float = None) -> None:
        for k in [keys] if isinstance(keys, str) else keys:
            self.get(k, timeout=timeout)

    def barrier(self, tag: str = "default", timeout: float = None) -> None:
        """A reusable host barrier of ``world_size`` callers: each call
        advances a per-tag generation (every rank calls it equally often)
        and meets on that generation's arrival count and release key; the
        last to arrive deletes the previous generation's keys."""
        seq = self._barrier_seq.get(tag, 0)
        self._barrier_seq[tag] = seq + 1
        if self.add(f"__barrier/{tag}/{seq}/arrived", 1) == self.world_size:
            self.set(f"__barrier/{tag}/{seq}/release", b"1")
            if seq > 0:
                self.delete_key(f"__barrier/{tag}/{seq - 1}/arrived")
                self.delete_key(f"__barrier/{tag}/{seq - 1}/release")
        self.get(f"__barrier/{tag}/{seq}/release", timeout=timeout)

    def close(self):
        if getattr(self, "_client", None):
            self._lib.pn_store_client_close(self._client)
            self._client = None
        if getattr(self, "_server", None):
            self._lib.pn_store_server_stop(self._server)
            self._server = None

    def __del__(self):
        self.close()


# --------------------------------------------------------------------------
# Host tracer (the native RecordEvent span buffer).

def tracer_enable(on: bool = True) -> bool:
    get_lib().pn_prof_enable(1 if on else 0)
    return True


def tracer_clear():
    get_lib().pn_prof_clear()


def tracer_begin(name: str):
    get_lib().pn_prof_begin(name.encode())


def tracer_end():
    get_lib().pn_prof_end()


def tracer_record(name: str, start_us: float, dur_us: float):
    get_lib().pn_prof_record(name.encode(), start_us, dur_us)


def tracer_spans():
    """The recorded spans: a list of (name, start_us, dur_us, tid)."""
    lib = get_lib()
    out = []
    name = ctypes.create_string_buffer(512)
    start, dur, tid = ctypes.c_double(), ctypes.c_double(), ctypes.c_int64()
    for i in range(lib.pn_prof_count()):
        if lib.pn_prof_get(i, name, 512, ctypes.byref(start),
                           ctypes.byref(dur), ctypes.byref(tid)) >= 0:
            out.append((name.value.decode(errors="replace"), start.value,
                        dur.value, tid.value))
    return out


# --------------------------------------------------------------------------
# Stats registry (memory/stats.cc's analog).

def stat_update(key: str, delta: int) -> int:
    return get_lib().pn_stat_update(key.encode(), delta)


def stat_current(key: str) -> int:
    return get_lib().pn_stat_current(key.encode())


def stat_peak(key: str) -> int:
    return get_lib().pn_stat_peak(key.encode())


def stat_reset_peak(key: str):
    get_lib().pn_stat_reset_peak(key.encode())


# --------------------------------------------------------------------------
# MultiSlot data feed (fluid/framework/data_feed.cc's analog): the PS
# training text format, "<count> v..." a slot a line, parsed in C++ threads
# into (values, offsets) ragged arrays a slot.

def parse_multislot_file(path, slot_is_float, num_threads=4):
    """Parse one MultiSlot text file: a list, a slot each, of (values,
    offsets) numpy pairs; offsets int64[rows + 1], values int64 or float32
    by ``slot_is_float``. A line with fewer slots than asked is skipped."""
    lib = get_lib()
    n = len(slot_is_float)
    flags = (ctypes.c_int32 * n)(*[1 if f else 0 for f in slot_is_float])
    h = lib.pn_feed_parse(str(path).encode(), n, flags, num_threads)
    if not h:
        raise FileNotFoundError(path)
    try:
        rows = lib.pn_feed_rows(h)
        out = []
        for s in range(n):
            vals = np.empty(lib.pn_feed_slot_size(h, s),
                            np.float32 if slot_is_float[s] else np.int64)
            offs = np.empty(rows + 1, np.int64)
            lib.pn_feed_copy_slot(
                h, s, vals.ctypes.data_as(ctypes.c_void_p),
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            out.append((vals, offs))
        return out
    finally:
        lib.pn_feed_free(h)


def parse_multislot_file_py(path, slot_is_float):
    """The plain Python form of ``parse_multislot_file`` (the reference's
    ``InMemoryDataset._py_parse``)."""
    n = len(slot_is_float)
    vals = [[] for _ in range(n)]
    offs = [[0] for _ in range(n)]
    with open(path) as fh:
        for line in fh:
            toks = line.split()
            i = 0
            row = []
            for _ in range(n):
                if i >= len(toks):
                    break
                cnt = int(toks[i])
                row.append(toks[i + 1:i + 1 + cnt])
                i += 1 + cnt
            if len(row) < n:
                continue
            for s in range(n):
                conv = float if slot_is_float[s] else int
                vals[s] += [conv(t) for t in row[s]]
                offs[s].append(offs[s][-1] + len(row[s]))
    return [(np.asarray(vals[s], np.float32 if slot_is_float[s]
                        else np.int64), np.asarray(offs[s], np.int64))
            for s in range(n)]
