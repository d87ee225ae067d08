"""The reference's own host-runtime tests, run against the port.

Four reference files are bound here, the design of
``test_torch_auto_parallel_reference_tests.py``: this module reads each
file's source, blanks every top-level test (function or class) but those in
``KEEP``, rewrites the imports of the ported modules (``import paddle_tpu as
paddle``, ``from paddle_tpu import native``, ``paddle_tpu.distributed``
with its ``ps``, ``fleet_executor`` and ``elastic``, ``paddle_tpu.io``,
``paddle_tpu.profiler``) to the same names of ``paddle_tpu_torch``,
refuses any other import of ``paddle_tpu`` or ``jax``, compiles the result
under the original file name and binds its tests, test classes and
fixtures here.

Bound: the 10 tests of ``test_ps.py``, the 4 of ``test_fleet_executor.py``,
the 15 of ``test_native.py`` and ``test_elastic_fault.py``'s
``test_kvstore_ttl_semantics_parity_file_vs_tcp``. Restated instead:
``test_rpc.py``'s one test, which binds the fixed port 29431 (under xdist
its bound copy would race the reference's own run for it): here on a port
the OS picks, and beside it an rpc between two processes.
"""
import ast
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu_torch
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# file -> its top-level tests (functions or classes) that are bound
KEEP = {
    "test_ps.py": ("TestTables", "TestClientServer", "TestGeoWorker",
                   "TestFleetPsMode", "TestEndToEndPsPipeline"),
    "test_fleet_executor.py": (
        "test_linear_pipeline_runs_all_microbatches",
        "test_payloads_flow_downstream", "test_cross_carrier_message_bus",
        "test_error_propagates"),
    "test_native.py": (
        "test_collate_matches_numpy", "test_fused_image_transform",
        "test_blocking_queue_producer_consumer", "test_queue_blocks_when_full",
        "test_dataloader_uses_native_collate",
        "test_tcp_store_kv_counters_barrier",
        "test_tcp_store_blocking_get_and_timeout", "test_elastic_tcp_kv_store",
        "test_native_tracer_nested_spans", "test_profiler_uses_native_tracer",
        "test_stats_registry", "test_tcp_store_barrier_is_reusable",
        "test_tcp_store_hostname_resolution",
        "test_native_multislot_datafeed", "test_inmemory_dataset_slots"),
    "test_elastic_fault.py": (
        "test_kvstore_ttl_semantics_parity_file_vs_tcp",),
}
# tests of those files (and of test_rpc.py) that are restated here
RESTATED = {"test_rpc.py": ("test_rpc_sync_async_and_registry",)}
PORTED = ("distributed", "distributed.ps", "distributed.fleet_executor",
          "distributed.elastic", "io", "profiler")
PORTED_NAMES = {"native"}
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
    paddle_tpu_torch.set_device("cpu")
    yield
    # test_ps's fleet PS flow leaves its role maker on fleet's singleton
    paddle_tpu_torch.distributed.fleet._fleet._role_maker = None


def test_every_host_runtime_reference_test_is_bound():
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
    assert counts == {"test_ps.py": 10, "test_fleet_executor.py": 4,
                      "test_native.py": 15, "test_elastic_fault.py": 1}
    with open(os.path.join(HERE, "test_rpc.py")) as f:
        assert {n.name for n in ast.parse(f.read()).body
                if isinstance(n, ast.FunctionDef)
                and n.name.startswith("test_")} == \
            set(RESTATED["test_rpc.py"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _add(a, b):
    return a + b


def test_rpc_sync_async_and_registry():
    """test_rpc.py's test on a port the OS picks; its invoke goes through
    a function of ``_testing`` (the callee imports what it unpickles)."""
    import pickle

    from paddle_tpu_torch._testing import rpc_matmul
    from paddle_tpu_torch.distributed import rpc
    from paddle_tpu_torch.distributed.ps.rpc import RpcClient
    master = f"127.0.0.1:{_free_port()}"
    rpc.init_rpc("worker0", rank=0, world_size=1, master_endpoint=master)
    try:
        assert rpc.rpc_sync("worker0", _add, args=(2, 3)) == 5
        fut = rpc.rpc_async("worker0", _add, args=(4, 5))
        assert fut.wait() == 9
        assert rpc.get_worker_info("worker0").rank == 0
        # a remote peer registering and invoking over the socket path
        c = RpcClient(master)
        infos = c.call("register", name="w1", rank=1, ip="127.0.0.1",
                       port=1)
        assert set(infos) == {"worker0", "w1"}
        out = c.call("invoke", fn=pickle.dumps(rpc_matmul),
                     args=pickle.dumps((np.eye(2), [[1.0], [2.0]])),
                     kwargs=pickle.dumps({}))
        np.testing.assert_array_equal(out, [[1.0], [2.0]])
        c.close()
    finally:
        rpc.shutdown()
    assert rpc.get_all_worker_infos() == []


def test_rpc_between_two_processes():
    """A second process joins through init_rpc; the main process calls it
    synchronously and asynchronously, then releases it."""
    from paddle_tpu_torch._testing import rpc_matmul, rpc_release
    from paddle_tpu_torch.distributed import rpc
    master = f"127.0.0.1:{_free_port()}"
    rpc.init_rpc("main", rank=0, world_size=2, master_endpoint=master)
    env = dict(os.environ, PYTHONPATH=ROOT)
    peer = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; from paddle_tpu_torch._testing import force_cpu, "
         "rpc_peer; force_cpu(); rpc_peer('peer', 1, 2, sys.argv[1])",
         master], env=env, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 60
        while len(rpc.get_all_worker_infos()) < 2:
            assert time.time() < deadline and peer.poll() is None
            time.sleep(0.05)
        info = rpc.get_worker_info("peer")
        assert info.rank == 1 and info.port > 0
        a = np.arange(6, dtype=np.float32).reshape(2, 3)
        b = np.ones((3, 2), np.float32)
        want = rpc_matmul(a, b)
        np.testing.assert_array_equal(
            rpc.rpc_sync("peer", rpc_matmul, args=(a, b)), want)
        np.testing.assert_array_equal(
            rpc.rpc_async("peer", rpc_matmul, args=(a, b)).wait(), want)
        with pytest.raises(RuntimeError, match="invoke failed"):
            rpc.rpc_sync("peer", rpc_matmul, args=(a, a))
        assert rpc.rpc_sync("peer", rpc_release) is True
        assert peer.wait(timeout=60) == 0, peer.stderr.read()
    finally:
        if peer.poll() is None:
            peer.kill()
            peer.wait()
        rpc.shutdown()
