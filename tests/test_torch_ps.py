"""The port's parameter server (``paddle_tpu_torch.distributed.ps``), its
``InMemoryDataset`` and fleet's PS mode, against the reference on the CPU.

The same request sequence goes through two reference ``PsServer``s and a
``PsClient`` and through the port's: rows, dense values and sizes are
bit-equal for SGD, Adagrad and Adam tables, a geo table under a
``GeoWorker``, and a push that carries an id twice (two sequential updates,
never summed). ``InMemoryDataset`` on one MultiSlot file (ragged int64
slots and a float32 slot) gives the reference's slot arrays and batches.
Fleet's PS flow (server and worker roles from the environment, the first
worker's ``stop_worker`` stopping the servers) and
``fleet.init(None, is_collective=False)`` taking the collective path, as
the reference's does. Every server is stopped and every client closed in
teardown.
"""
import threading

import numpy as np
import pytest

import paddle_tpu.distributed as P_dist
import paddle_tpu.distributed.ps as P_ps
import paddle_tpu.native as P_native
import paddle_tpu_torch as T
import paddle_tpu_torch.distributed as T_dist
import paddle_tpu_torch.distributed.ps as T_ps
from paddle_tpu_torch._testing import share_the_cores_fixture
from paddle_tpu_torch.distributed import fleet

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")


def _cluster(ps):
    servers = [ps.PsServer(port=0, num_workers=1).start() for _ in range(2)]
    return servers, ps.PsClient([f"127.0.0.1:{s.port}" for s in servers])


@pytest.fixture()
def clusters():
    """Two servers and a client of the reference's and of the port's."""
    made = [_cluster(P_ps), _cluster(T_ps)]
    yield [client for _, client in made]
    for servers, client in made:
        client.stop_servers()
        client.close()
        for s in servers:
            s.stop()


def _requests(c, rs, optimizer, opt_kw):
    """One request sequence; returns what every pull saw, and the sizes."""
    seen = []
    c.create_dense_table(0, 11, optimizer=optimizer, **opt_kw)
    c.set_dense(0, rs.randn(11).astype(np.float32))
    c.create_sparse_table(1, dim=5, optimizer=optimizer, seed=3, **opt_kw)
    for _ in range(4):
        keys = rs.randint(0, 40, 12).astype(np.int64)
        keys[3] = keys[7]                     # an id twice in one push
        seen.append(c.pull_sparse(1, keys))
        c.push_sparse(1, keys, rs.randn(12, 5).astype(np.float32))
        seen.append(c.pull_dense(0, 11))
        c.push_dense(0, rs.randn(11).astype(np.float32))
    seen.append(c.pull_dense(0, 11))
    seen.append(c.pull_sparse(1, np.arange(40, dtype=np.int64)))
    return seen, c.sparse_size(1)


@pytest.mark.parametrize("optimizer,opt_kw", [
    ("sgd", {"lr": 0.5}), ("adagrad", {"lr": 0.1}),
    ("adam", {"lr": 0.01, "beta1": 0.8})])
def test_tables_bit_equal_to_the_reference(clusters, optimizer, opt_kw):
    (ref, ref_size), (port, port_size) = [
        _requests(c, np.random.RandomState(0), optimizer, opt_kw)
        for c in clusters]
    assert ref_size == port_size
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_duplicate_ids_get_two_sequential_updates():
    """Adam: an id twice in one push steps its state twice, exactly as two
    pushes of one id each; summing the two gradients first differs."""
    t = T_ps.SparseTable(3, optimizer="adam", lr=0.1, seed=1)
    twice = T_ps.SparseTable(3, optimizer="adam", lr=0.1, seed=1)
    summed = T_ps.SparseTable(3, optimizer="adam", lr=0.1, seed=1)
    g = np.array([[1.0, -2.0, 0.5], [0.25, 4.0, -1.0]], np.float32)
    t.push(np.array([9, 9]), g)
    twice.push(np.array([9]), g[:1])
    twice.push(np.array([9]), g[1:])
    summed.push(np.array([9]), g.sum(0, keepdims=True))
    np.testing.assert_array_equal(t.pull(np.array([9])),
                                  twice.pull(np.array([9])))
    assert not np.array_equal(t.pull(np.array([9])),
                              summed.pull(np.array([9])))
    ref = P_ps.SparseTable(3, optimizer="adam", lr=0.1, seed=1)
    ref.push(np.array([9, 9]), g)
    np.testing.assert_array_equal(t.pull(np.array([9])),
                                  ref.pull(np.array([9])))


def test_geo_worker_bit_equal_to_the_reference(clusters):
    outs = []
    for c, ps in zip(clusters, (P_ps, T_ps)):
        rs = np.random.RandomState(1)
        c.create_sparse_table(2, dim=4, geo=True, seed=5)
        w = ps.GeoWorker(c, table_id=2, dim=4, push_interval=2)
        seen = []
        for _ in range(5):
            keys = rs.randint(0, 9, 6).astype(np.int64)
            seen.append(w.lookup(keys))
            w.apply_grads(keys, rs.randn(6, 4).astype(np.float32), lr=0.1)
        w.sync()
        seen.append(c.pull_sparse(2, np.arange(9, dtype=np.int64)))
        outs.append((seen, c.sparse_size(2)))
    (ref, ref_n), (port, port_n) = outs
    assert ref_n == port_n
    for a, b in zip(ref, port):
        np.testing.assert_array_equal(a, b)


def test_barrier_releases_all_workers_together():
    server = T_ps.PsServer(port=0, num_workers=3).start()
    try:
        eps = [f"127.0.0.1:{server.port}"]
        order, lock = [], threading.Lock()

        def worker(i):
            c = T_ps.PsClient(eps)
            with lock:
                order.append("enter")
            c.barrier()
            with lock:
                order.append("exit")
            c.close()

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert order == ["enter"] * 3 + ["exit"] * 3
    finally:
        server.stop()


def test_rpc_errors_reach_the_caller(clusters):
    with pytest.raises(RuntimeError, match="pull_dense failed"):
        clusters[1].pull_dense(77, 4)


class _Var:
    def __init__(self, dtype):
        self.dtype = dtype


def test_inmemory_dataset_equals_the_reference(tmp_path, monkeypatch):
    """Two files of ragged int64 slots and a float32 slot; the reference
    parses with its plain parser (its native library is not built here:
    the port's has to stand alone)."""
    rs = np.random.RandomState(0)
    files = []
    for part in range(2):
        lines = []
        for _ in range(9 + part):
            n = rs.randint(0, 4)
            ids = " ".join(str(i) for i in rs.randint(0, 1000, n))
            lines.append(f"{n} {ids} 1 {rs.randint(0, 2)} 1 "
                         f"{rs.randint(0, 64) / 8.0}".replace("  ", " "))
        p = tmp_path / f"part-{part}"
        p.write_text("\n".join(lines) + "\n")
        files.append(str(p))
    monkeypatch.setattr(P_native, "parse_multislot_file",
                        lambda *a, **k: None)
    use = [_Var("int64"), _Var("int64"), _Var("float32")]
    sets = [P_dist.InMemoryDataset(), T_dist.InMemoryDataset()]
    for ds in sets:
        ds.set_filelist(files)
        ds.set_use_var(use)
        ds.load_into_memory()
    ref, port = sets
    assert port.get_memory_data_size() == ref.get_memory_data_size() == 19
    for (rv, ro), (pv, po) in zip(ref.slot_arrays(), port.slot_arrays()):
        assert rv.dtype == pv.dtype
        np.testing.assert_array_equal(rv, pv)
        np.testing.assert_array_equal(ro, po)
    for bs in (4, 19):
        rb = list(ref.batch_generator(batch_size=bs))
        pb = list(port.batch_generator(batch_size=bs))
        assert len(rb) == len(pb) == -(-19 // bs)
        for r_batch, p_batch in zip(rb, pb):
            for r, p in zip(r_batch, p_batch):
                assert isinstance(p, T.Tensor)
                assert p._data.device.type == "cpu"
                np.testing.assert_array_equal(np.asarray(r.numpy()),
                                              p.numpy())
    port.release_memory()
    assert port.get_memory_data_size() == 0


def test_fleet_ps_flow(monkeypatch):
    """A server role serves through init_server/run_server (in a thread, as
    its own process would); a worker role's init_worker reaches it and the
    first worker's stop_worker stops it."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"PADDLE_PSERVERS_IP_PORT_LIST": f"127.0.0.1:{port}",
           "PADDLE_TRAINERS_NUM": "1", "PADDLE_TRAINER_ID": "0",
           "PADDLE_PORT": str(port)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    server_fleet = fleet.Fleet()
    server_fleet.init(fleet.PaddleCloudRoleMaker(), is_collective=False)
    assert server_fleet.is_server() and not server_fleet.is_worker()
    server_fleet.init_server()
    served = threading.Thread(target=server_fleet.run_server)
    served.start()
    try:
        monkeypatch.setenv("TRAINING_ROLE", "TRAINER")
        role = fleet.PaddleCloudRoleMaker()
        assert role.is_first_worker() and role.server_endpoints() == [
            f"127.0.0.1:{port}"]
        fleet.init(role, is_collective=False)
        assert fleet.is_worker() and not fleet.is_server()
        fleet.init_worker()
        fleet.ps_client.create_dense_table(0, 4)
        np.testing.assert_array_equal(fleet.ps_client.pull_dense(0, 4),
                                      np.zeros(4, np.float32))
        fleet.stop_worker()
        assert fleet.ps_client is None
        served.join(timeout=30)
        assert not served.is_alive()
    finally:
        if served.is_alive():
            server_fleet._ps_server.stop()
        fleet._fleet._role_maker = None


def test_user_defined_role_maker_and_util():
    rm = fleet.UserDefinedRoleMaker(role=fleet.Role.SERVER, worker_num=3,
                                    server_endpoints=["h:1", "h:2"])
    ref = P_dist.fleet.UserDefinedRoleMaker(
        role=P_dist.fleet.Role.SERVER, worker_num=3,
        server_endpoints=["h:1", "h:2"])
    for name in ("is_server", "is_worker", "worker_num", "server_num",
                 "server_endpoints", "worker_index"):
        assert getattr(rm, name)() == getattr(ref, name)()
    assert fleet.UtilBase().get_file_shard(["a", "b"]) == ["a", "b"]

    class Gen(fleet.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                yield [("ids", [3, 4]), ("label", [1])]
            return it
    assert Gen()._format([("ids", [3, 4]), ("label", [1])]) == "2 3 4 1 1"


def test_fleet_init_without_a_role_maker_is_collective():
    """The reference takes the collective path for
    ``fleet.init(is_collective=False)`` with no role maker."""
    try:
        fleet.init(None, is_collective=False)
        assert fleet._fleet._role_maker is None
        assert fleet.get_hybrid_communicate_group() is not None
        assert fleet.is_worker() and not fleet.is_server()
        assert fleet.worker_num() == 1
    finally:
        T_dist.destroy_process_group()
        from paddle_tpu_torch.distributed.fleet.topology import \
            set_hybrid_communicate_group
        set_hybrid_communicate_group(None)
