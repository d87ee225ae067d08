"""paddle_tpu_torch.io against paddle_tpu.io, on the CPU.

The samplers draw from numpy in both packages, so batch orders are compared
index for index: the seeded RandomSampler across epochs, BatchSampler,
DistributedBatchSampler, the unseeded samplers and random_split under one
numpy seed, and the DataLoader's order under ``seed``, ``set_epoch`` and a
``state_dict`` resume. The datasets, ``default_collate_fn`` and the worker
processes' batches (equal to the single-process ones, Tensor samples
included) are held against the reference too, and
tests/test_train_robustness.py's four DataLoader tests are restated on the
port (that file's top imports need training/, hapi/ and distributed/).
"""
import threading
import time

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest keeps it on the CPU)

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu import io as pio
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    yield


class Idx:
    """A map-style dataset of (index array, int label) in either package."""

    def __init__(self, pkg_io, n=37):
        self.n = n
        self.cls = type("IdxDs", (pkg_io.Dataset,), {
            "__len__": lambda s: n,
            "__getitem__": lambda s, i: (np.full((2,), i, np.float32),
                                         int(i % 5))})

    def __call__(self):
        return self.cls()


def _order(loader):
    """The indices each batch holds."""
    return [b[0].numpy()[:, 0].astype(int).tolist() for b in loader]


# ------------------------------------------------------------- samplers
@pytest.mark.parametrize("replacement,num_samples", [
    (False, None), (False, 10), (True, 50)])
def test_seeded_random_sampler_draws_the_references_order(replacement,
                                                          num_samples):
    ds = list(range(23))
    ref = pio.RandomSampler(ds, replacement, num_samples, seed=5)
    port = tio.RandomSampler(ds, replacement, num_samples, seed=5)
    for epoch in (0, 1, 7):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        assert list(port) == list(ref)
        assert len(port) == len(ref)


def test_unseeded_samplers_and_random_split_follow_numpys_global_draws():
    ds = list(range(17))
    got, want = [], []
    for pkg, out in ((pio, want), (tio, got)):
        np.random.seed(3)
        out.append(list(pkg.RandomSampler(ds)))
        out.append(list(pkg.RandomSampler(ds, replacement=True,
                                          num_samples=9)))
        out.append(list(pkg.WeightedRandomSampler([1, 2, 3, 4], 12)))
        out.append(list(pkg.WeightedRandomSampler([1, 2, 3, 4], 3,
                                                  replacement=False)))
        out.append(list(pkg.SubsetRandomSampler([4, 8, 15, 16, 23])))
        out.append([list(s) for s in pkg.random_split(ds, [10, 7])])
        out.append([list(s) for s in pkg.random_split(ds, [0.5, 0.5])])
        out.append(list(pkg.SequenceSampler(ds)))
    assert got == want
    with pytest.raises(ValueError):
        tio.SubsetRandomSampler([])
    with pytest.raises(ValueError):
        tio.random_split(ds, [3, 3])


@pytest.mark.parametrize("shuffle,drop_last", [
    (False, False), (True, False), (True, True)])
def test_batch_samplers_match_the_reference(shuffle, drop_last):
    ds = list(range(29))
    for epoch in (0, 3):
        np.random.seed(epoch)
        want = list(pio.BatchSampler(ds, shuffle=shuffle, batch_size=4,
                                     drop_last=drop_last))
        np.random.seed(epoch)
        got = list(tio.BatchSampler(ds, shuffle=shuffle, batch_size=4,
                                    drop_last=drop_last))
        assert got == want
    for rank in (0, 1, 2):
        ref = pio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                          shuffle=shuffle,
                                          drop_last=drop_last)
        port = tio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                           shuffle=shuffle,
                                           drop_last=drop_last)
        for epoch in (0, 2):
            ref.set_epoch(epoch)
            port.set_epoch(epoch)
            assert list(port) == list(ref)
            assert len(port) == len(ref)


def test_distributed_batch_sampler_is_one_rank_outside_a_process_group():
    s = tio.DistributedBatchSampler(list(range(10)), 4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert list(s) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


# ------------------------------------------------------------- datasets
def test_datasets_match_the_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    for pkg_io, pkg in ((pio, P), (tio, T)):
        td = pkg_io.TensorDataset([pkg.to_tensor(a), pkg.to_tensor(b)])
        assert len(td) == 6
        assert td[4][0].numpy().tolist() == [8.0, 9.0]
        assert int(td[4][1]) == 4
    for pkg_io in (pio, tio):
        d1, d2 = Idx(pkg_io, 5)(), Idx(pkg_io, 3)()
        cat = pkg_io.ConcatDataset([d1, d2])
        assert len(cat) == 8
        assert cat[6][0][0] == 1 and cat[-1][0][0] == 2
        comp = pkg_io.ComposeDataset([d1, d2])
        assert len(comp) == 3 and len(comp[2]) == 4
        sub = pkg_io.Subset(d1, [4, 0])
        assert len(sub) == 2 and sub[0][1] == 4
        it = type("It", (pkg_io.IterableDataset,), {
            "__iter__": lambda s: iter(range(3))})
        chain = pkg_io.ChainDataset([it(), it()])
        assert [x for x in chain] == [0, 1, 2] * 2
        with pytest.raises(RuntimeError):
            it()[0]


# ------------------------------------------------------------ collation
def test_default_collate_matches_the_reference():
    batch = [{"img": np.full((2, 3), i, np.float32), "id": i,
              "w": float(i) / 2, "tag": f"s{i}",
              "pair": (np.int64(i), np.float64(i))} for i in range(4)]
    want = pio.default_collate_fn(batch)
    got = tio.default_collate_fn(batch)
    assert set(got) == set(want)
    for k in ("img", "id", "w"):
        # the reference keeps int64 as 32 bits while jax's x64 is off
        assert str(got[k].dtype) == {"int32": "int64"}.get(
            str(want[k].dtype), str(want[k].dtype))
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    assert got["tag"] == want["tag"] == ["s0", "s1", "s2", "s3"]
    for g, w in zip(got["pair"], want["pair"]):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(TypeError, match="cannot collate"):
        tio.default_collate_fn([object()])


def test_default_collate_stacks_tensor_samples_in_their_dtype():
    samples = [T.to_tensor(np.full((3,), i, np.float32)).astype("bfloat16")
               for i in range(2)]
    out = tio.default_collate_fn(samples)
    assert out.dtype == T.bfloat16 and out.shape == [2, 3]
    assert out.place == T.CPUPlace() and out.stop_gradient


# ------------------------------------------------------- loader orders
@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=4, shuffle=True, seed=11),
    dict(batch_size=5, shuffle=True, seed=3, num_workers=1),
    dict(batch_size=None)], ids=str)
def test_loader_order_matches_the_reference(kw):
    ref = pio.DataLoader(Idx(pio)(), **kw)
    port = tio.DataLoader(Idx(tio)(), **kw)
    for epoch in range(2):
        if kw.get("batch_size") is None:
            want = [int(b[0].numpy()[0, 0]) for b in ref]
            got = [int(b[0].numpy()[0, 0]) for b in port]
        else:
            want, got = _order(ref), _order(port)
        assert got == want, epoch
        assert len(port) == len(ref)
    assert port.state_dict() == ref.state_dict()


def test_loader_set_epoch_and_resume_match_the_reference():
    orders = {}
    for pkg_io in (pio, tio):
        dl = pkg_io.DataLoader(Idx(pkg_io)(), batch_size=4, shuffle=True,
                               seed=7)
        dl.set_epoch(5)
        it = iter(dl)
        first = [next(it)[0].numpy()[:, 0].tolist() for _ in range(3)]
        state = dl.state_dict()
        resumed = pkg_io.DataLoader(Idx(pkg_io)(), batch_size=4,
                                    shuffle=True, seed=7)
        resumed.set_state_dict(state)
        rest = _order(resumed)
        orders[pkg_io] = (state, first, rest, _order(resumed),
                          resumed.state_dict())
    assert orders[tio] == orders[pio]
    state, first, rest, next_epoch, _ = orders[tio]
    assert state == {"epoch": 5, "batches_served": 3, "seed": 7}
    assert sorted(sum(first, []) + sum(rest, [])) == list(range(37))
    assert next_epoch != first + rest          # epoch 6 reshuffles


def test_iterable_loader_resume_drops_consumed_batches():
    for pkg_io in (pio, tio):
        it = type("It", (pkg_io.IterableDataset,), {
            "__iter__": lambda s: iter(np.arange(11, dtype=np.int64))})
        dl = pkg_io.DataLoader(it(), batch_size=3, drop_last=True)
        dl.set_state_dict({"epoch": 0, "batches_served": 1, "seed": None})
        assert [b.numpy().tolist() for b in dl] == [[3, 4, 5], [6, 7, 8]]
        with pytest.raises(ValueError, match="seed"):
            pkg_io.DataLoader(it(), batch_size=3, seed=1)


def test_loader_records_fetch_wait_and_batches():
    tobs.enable()
    hist = tobs.REGISTRY.histogram("dataloader.fetch_wait_s")
    batches = tobs.REGISTRY.counter("dataloader.batches")
    n0, b0 = hist.count, batches.value
    list(tio.DataLoader(Idx(tio)(), batch_size=8))
    assert hist.count - n0 == 5 and batches.value - b0 == 5


# --------------------------------------------------------------- workers
class _TensorItems(tio.Dataset):
    """Items built as Tensors, as ToTensor builds them, on the default
    place of the process that reads them."""

    def __len__(self):
        return 12

    def __getitem__(self, i):
        return (T.to_tensor(np.full((2, 2), i, np.float32)),
                np.int64(i), {"w": float(i)})


def test_workers_collate_tensor_samples_as_the_single_process_loader():
    mp = list(tio.DataLoader(_TensorItems(), batch_size=5, num_workers=2))
    sp = list(tio.DataLoader(_TensorItems(), batch_size=5, num_workers=0))
    assert len(mp) == len(sp) == 3
    for a, b in zip(mp, sp):
        for x, y in ((a[0], b[0]), (a[1], b[1]), (a[2]["w"], b[2]["w"])):
            assert x.dtype == y.dtype and x.place == y.place
            np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_the_references_worker_collate_refuses_tensor_samples():
    """The reference's worker collate has no branch for a Tensor sample,
    which its single-process collate stacks (a reference fault, ROADMAP
    queue 3): the port's stacks it."""
    with pytest.raises(TypeError, match="cannot collate"):
        pio._np_collate([P.to_tensor(np.ones(2, np.float32))] * 2)
    kind, arr = tio._np_collate([T.to_tensor(np.ones(2, np.float32))] * 2)
    assert kind == "__t__" and arr.shape == (2, 2)


def test_worker_runs_on_the_cpu_with_one_thread():
    """A forked worker's default place is the CPU and it takes one intra-op
    thread before worker_init_fn runs."""
    seen = []

    def init(wid):
        seen.append((T.get_device(), torch.get_num_threads()))
        assert T.get_device() == "cpu:0" and torch.get_num_threads() == 1

    class Probe(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return np.asarray([torch.get_num_threads(),
                               T.to_tensor([1.0]).place == T.CPUPlace()],
                              np.int64)

    out = list(tio.DataLoader(Probe(), batch_size=2, num_workers=2,
                              worker_init_fn=init))
    assert [b.numpy().tolist() for b in out] == [[[1, 1], [1, 1]]] * 2


def test_loader_order_with_workers_matches_the_reference():
    kw = dict(batch_size=6, shuffle=True, seed=2, num_workers=3)
    want = _order(pio.DataLoader(Idx(pio)(), **kw))
    got = _order(tio.DataLoader(Idx(tio)(), **kw))
    assert got == want


# ------------- tests/test_train_robustness.py's DataLoader tests, restated
_SERVED = []


class _RecData(tio.Dataset):
    def __len__(self):
        return 32

    def __getitem__(self, i):
        _SERVED.append(i)
        r = np.random.RandomState(i)
        return (r.randn(4).astype("f4"), r.randn(2).astype("f4"))


def test_dataloader_seed_refused_with_external_sampler():
    ds = _RecData()
    with pytest.raises(ValueError, match="external"):
        tio.DataLoader(ds, batch_sampler=tio.BatchSampler(
            ds, shuffle=True, batch_size=4), seed=7)


def test_dataloader_state_roundtrip_replays_exact_order():
    _SERVED.clear()
    list(tio.DataLoader(_RecData(), batch_size=4, shuffle=True, seed=11))
    oracle = list(_SERVED)

    _SERVED.clear()
    first = tio.DataLoader(_RecData(), batch_size=4, shuffle=True, seed=11)
    it = iter(first)
    for _ in range(3):
        next(it)
    state = first.state_dict()
    assert state["batches_served"] == 3 and state["seed"] == 11

    resumed = tio.DataLoader(_RecData(), batch_size=4, shuffle=True,
                             seed=11)
    resumed.set_state_dict(state)
    list(resumed)
    # the skipped batches were not loaded again, and the consumed order
    # equals the uninterrupted pass
    assert _SERVED == oracle
    assert resumed.state_dict() == {"epoch": 1, "batches_served": 0,
                                    "seed": 11}


def test_dataloader_resume_refuses_seed_mismatch():
    dl = tio.DataLoader(_RecData(), batch_size=4, shuffle=True, seed=1)
    with pytest.raises(ValueError, match="seed"):
        dl.set_state_dict({"epoch": 0, "batches_served": 2, "seed": 9})
    with pytest.raises(ValueError, match="seed"):
        dl.set_state_dict({"epoch": 0, "batches_served": 2,
                           "seed": None})


def test_prefetch_worker_exits_when_iterator_abandoned():
    before = set(threading.enumerate())
    dl = tio.DataLoader(_RecData(), batch_size=2, num_workers=1,
                        prefetch_factor=1)
    for _ in range(2):
        it = iter(dl)
        next(it)
        it.close()
    deadline = time.time() + 5
    while time.time() < deadline and (set(threading.enumerate()) - before):
        time.sleep(0.05)
    leaked = set(threading.enumerate()) - before
    assert not leaked, leaked


def test_unseeded_resume_warns():
    dl = tio.DataLoader(_RecData(), batch_size=4, shuffle=True)
    with pytest.warns(UserWarning, match="unseeded"):
        dl.set_state_dict({"epoch": 0, "batches_served": 1, "seed": None})
