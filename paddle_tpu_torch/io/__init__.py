"""Datasets, samplers and the DataLoader: the port of
``paddle_tpu/io/__init__.py`` (reference: python/paddle/io/reader.py:262,
io/dataloader/dataloader_iter.py:155,370).

The samplers draw from numpy as the reference's do (a seeded
``RandomSampler`` from ``RandomState((seed + 1000003 * epoch) % 2**32)``),
so the port's batch order is the reference's, index for index.

Loading paths, as the reference splits them:
- num_workers 0/1: in-process iterator, optional background-thread
  prefetch.
- num_workers > 1 (map-style): forked worker processes pull index
  batches and collate to numpy; the parent reorders for sampler
  determinism and re-wraps each batch on the default place (the card
  unless ``set_device("cpu")``). A forked child must never touch the card
  its parent initialised: ``_worker_loop`` makes the CPU its default place
  and takes one intra-op thread before it runs ``worker_init_fn`` or reads
  the dataset, so a transform that builds a ``Tensor`` (``ToTensor``)
  builds it on the CPU, and items cross as numpy.

Collation stacks arrays of 64 KiB or more with the native threaded
collate (``native.collate``, bit-equal to ``np.stack``), in the main
process and in the forked workers; smaller ones with ``np.stack`` (the
reference's gate is 4 KiB).
"""
from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Iterable, List, Optional

import numpy as np

import torch

from ..core import dtype as dtype_mod
from ..core import place as place_mod
from ..core.tensor import Tensor
from ..observability import metrics as _met


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumsizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumsizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cumsizes, idx, side="right"))
        prev = self.cumsizes[di - 1] if di > 0 else 0
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    total = len(dataset)
    if all(isinstance(l, float) for l in lengths):
        counts = [int(np.floor(total * l)) for l in lengths]
        rem = total - sum(counts)
        for i in range(rem):
            counts[i % len(counts)] += 1
        lengths = counts
    if sum(lengths) != total:
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(total)
    out = []
    off = 0
    for l in lengths:
        out.append(Subset(dataset, perm[off:off + l].tolist()))
        off += l
    return out


# ------------------------------- samplers ----------------------------------
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None, seed=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        #: seeded mode: epoch `e`'s draw is a pure function of
        #: (seed, e) — the restorable-position contract DataLoader
        #: resume relies on (the DistributedBatchSampler idiom).
        #: seed=None keeps the legacy global-RNG behavior.
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.seed is not None:
            rng = np.random.RandomState(
                (int(self.seed) + 1000003 * self.epoch) % (2 ** 32))
            if self.replacement:
                return iter(rng.randint(0, n, self.num_samples).tolist())
            return iter(rng.permutation(n)[: self.num_samples].tolist())
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[: self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """Sample randomly (without replacement) from a fixed index subset
    (reference io/sampler.py SubsetRandomSampler)."""

    def __init__(self, indices):
        if len(indices) == 0:
            raise ValueError(
                "The length of `indices` in SubsetRandomSampler should "
                "be greater than 0.")
        self.indices = list(indices)

    def __iter__(self):
        perm = np.random.permutation(len(self.indices))
        return iter(self.indices[i] for i in perm)

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def set_epoch(self, epoch):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of torch.distributed's default group, (1, 0)
    outside one: the reference's ``distributed.get_world_size``/``get_rank``
    on one process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Shards the index space across data-parallel ranks (reference:
    io/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None \
            else _world()[0]
        self.local_rank = rank if rank is not None else _world()[1]
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices = np.concatenate(
            [indices, indices[: self.total_size - n]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# ------------------------------ collation ----------------------------------
# The native collate gathers one pointer a sample in Python: for samples
# under 64 KiB that costs more than np.stack's whole copy (the reference's
# gate is 4 KiB; ROADMAP, deliberate differences)
NATIVE_COLLATE_MIN_BYTES = 1 << 16


def _stack(arrs):
    """``np.stack``, through the native threaded collate for more than one
    sample of at least ``NATIVE_COLLATE_MIN_BYTES``."""
    if len(arrs) > 1 and arrs[0].nbytes >= NATIVE_COLLATE_MIN_BYTES:
        from .. import native
        return native.collate(arrs)
    return np.stack(arrs)


def default_collate_fn(batch):
    """A batch of samples as Tensors on the default place: arrays and
    Tensors stacked, ints as int64, floats as float32, strings kept as a
    list, dicts and sequences collated field by field."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return Tensor._wrap(torch.stack([s._data.detach() for s in batch])
                            .to(place_mod.default_device()))
    if isinstance(sample, np.ndarray):
        return Tensor(_stack(batch))
    if isinstance(sample, (int, np.integer)):
        return Tensor(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return Tensor(np.asarray(batch, np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [default_collate_fn(list(items)) for items in zip(*batch)]
    raise TypeError(f"cannot collate {type(sample)}")


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, seed=None):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        if seed is not None and (self._iterable_mode
                                 or batch_sampler is not None
                                 or batch_size is None):
            # seed only governs the loader-BUILT sampler; silently
            # storing it next to an external/iterable ordering would
            # let a resume fast-forward a permutation the seed never
            # produced (claiming exact replay while corrupting order)
            raise ValueError(
                "DataLoader(seed=...) requires the loader-built batch "
                "sampler (map-style dataset, batch_size set, no "
                "external batch_sampler) — an external sampler owns "
                "its ordering and must carry its own seed/epoch state")
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        elif batch_size is None:
            self.batch_sampler = None
        else:
            sampler = RandomSampler(dataset, seed=seed) \
                if (shuffle and seed is not None) else None
            self.batch_sampler = BatchSampler(
                dataset, sampler=sampler, shuffle=shuffle,
                batch_size=batch_size, drop_last=drop_last)
        # resumable position: with `seed` set, the shuffle
        # order is a pure function of (seed, epoch) and the loader's
        # position is three ints — what preemption-safe checkpoints
        # capture so a resume replays the exact data order.
        self._seed = seed
        self._epoch = 0
        self._batches_served = 0
        self._skip_next = 0
        self._auto_epoch = (batch_sampler is None
                            and self.batch_sampler is not None)

    # ---------------------------------------------- resumable position
    def set_epoch(self, epoch):
        self._epoch = int(epoch)

    def state_dict(self):
        """Loader position for preemption-safe checkpoints: epoch,
        batches already CONSUMED this epoch, and the shuffle seed."""
        return {"epoch": int(self._epoch),
                "batches_served": int(self._batches_served),
                "seed": self._seed}

    def set_state_dict(self, state):
        saved_seed = state.get("seed")
        if saved_seed != self._seed:
            # EITHER direction (including seed=None on one side): a
            # position under one shuffle order is meaningless under
            # another — silently fast-forwarding a different
            # permutation would re-train some samples and skip others
            # while claiming exact resume
            raise ValueError(
                f"DataLoader resume: checkpoint shuffle seed "
                f"{saved_seed!r} != this loader's seed {self._seed!r} "
                "— the saved data order cannot be replayed")
        self._epoch = int(state.get("epoch", 0))
        self._skip_next = int(state.get("batches_served", 0))
        self._batches_served = self._skip_next
        if self._skip_next and self._seed is None and self._auto_epoch \
                and isinstance(getattr(self.batch_sampler, "sampler",
                                       None), RandomSampler):
            import warnings
            warnings.warn(
                "DataLoader resume with unseeded shuffle: the position "
                "is restored but the permutation is not reproducible — "
                "pass DataLoader(..., seed=N) for exact data-order "
                "replay", stacklevel=2)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset has no len()")
        if self.batch_sampler is None:
            return len(self.dataset)
        return len(self.batch_sampler)

    def _produce(self, skip=0):
        # skip: batches already consumed before a resume. Index-driven
        # modes fast-forward WITHOUT loading the skipped samples;
        # iterable datasets must consume (and drop) them.
        if self._iterable_mode:
            it = iter(self.dataset)
            if self.batch_size is None:
                for _ in itertools.islice(it, skip):
                    pass
                yield from (self.collate_fn([s]) for s in it)
                return
            while skip > 0:
                if not list(itertools.islice(it, self.batch_size)):
                    return
                skip -= 1
            while True:
                batch = list(itertools.islice(it, self.batch_size))
                if not batch:
                    return
                if len(batch) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(batch)
        elif self.batch_sampler is None:
            for i in range(skip, len(self.dataset)):
                yield self.collate_fn([self.dataset[i]])
        else:
            for batch_idx in self.batch_sampler:
                if skip > 0:
                    skip -= 1
                    continue
                yield self.collate_fn(
                    [self.dataset[i] for i in batch_idx])

    def __iter__(self):
        # epoch sync + fast-forward happen here (once per pass), so
        # every loading mode shares the resume semantics; position is
        # counted at CONSUMPTION (prefetch queues may hold more)
        if self._auto_epoch and hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(self._epoch)
        skip = self._skip_next
        self._skip_next = 0
        self._batches_served = skip
        inner = self._iter_batches(skip)
        if not _met._ENABLED:
            for item in inner:
                self._batches_served += 1
                yield item
            self._epoch += 1
            self._batches_served = 0
            return
        # fetch-wait accounting: how long the consumer (the train loop)
        # blocks per batch — the input-pipeline stall signal. Covers
        # every loading mode since it wraps the mode dispatch.
        hist = _met.REGISTRY.histogram("dataloader.fetch_wait_s")
        batches = _met.REGISTRY.counter("dataloader.batches")
        import time as _time
        while True:
            t0 = _time.perf_counter()
            try:
                item = next(inner)
            except StopIteration:
                self._epoch += 1
                self._batches_served = 0
                return
            hist.observe(_time.perf_counter() - t0)
            batches.inc()
            self._batches_served += 1
            yield item

    def _iter_batches(self, skip=0):
        if not self.use_buffer_reader or self.num_workers == 0:
            yield from self._produce(skip)
            return
        if not self._iterable_mode and self.batch_sampler is not None \
                and self.num_workers > 1:
            yield from self._iter_multiprocess(skip)
            return
        # background-thread prefetch (buffered reader / blocking-queue role)
        q: "queue.Queue" = queue.Queue(
            maxsize=max(2, self.prefetch_factor * max(self.num_workers, 1)))
        stop = object()
        abandoned = threading.Event()

        def _put(item) -> bool:
            # bounded-blocking put that gives up when the consumer
            # abandoned the iterator (mid-epoch preemption / crash):
            # a worker stuck forever on q.put would leak one thread
            # plus its buffered batches per crashed attempt
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self._produce(skip):
                    if not _put(item):
                        return
            finally:
                _put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            abandoned.set()

    # ----------------------------------------------------------------
    # True multi-process loading (reference
    # io/dataloader/dataloader_iter.py:370 _DataLoaderIterMultiProcess:
    # worker processes pull index batches, collate to numpy, push
    # results; the parent reorders to keep sampler determinism).
    # ----------------------------------------------------------------
    def _iter_multiprocess(self, skip=0):
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        n = self.num_workers
        idx_queues = [ctx.Queue() for _ in range(n)]
        out_q = ctx.Queue(maxsize=max(2, self.prefetch_factor * n))
        timeout = self.timeout if getattr(self, "timeout", 0) else 120

        procs = [ctx.Process(
            target=_worker_loop,
            args=(self.dataset, self.collate_fn, idx_queues[w], out_q,
                  w, n, self.worker_init_fn),
            daemon=True) for w in range(n)]
        for p in procs:
            p.start()
        try:
            batches = list(self.batch_sampler)[skip:]
            for seq, b in enumerate(batches):
                idx_queues[seq % n].put((seq, list(b)))
            for iq in idx_queues:
                iq.put(None)
            pending = {}
            want = 0
            got = 0
            while got < len(batches):
                if want in pending:
                    item = pending.pop(want)
                else:
                    seq, payload = out_q.get(timeout=timeout)
                    if seq == -1:
                        raise RuntimeError(
                            f"DataLoader worker failed: {payload}")
                    if seq != want:
                        pending[seq] = payload
                        continue
                    item = payload
                got += 1
                want += 1
                yield _rewrap(item)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)


class WorkerInfo:
    """reference io/dataloader/worker.py WorkerInfo."""

    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info: Optional[WorkerInfo] = None


def _unwrap(item):
    """Tensor -> numpy for the queue (tensors cross processes as
    numpy)."""
    if isinstance(item, Tensor):
        return ("__t__", item.numpy())
    if isinstance(item, (list, tuple)):
        return type(item)(_unwrap(i) for i in item)
    if isinstance(item, dict):
        return {k: _unwrap(v) for k, v in item.items()}
    return item


def _rewrap(item):
    if isinstance(item, tuple) and len(item) == 2 and item[0] == "__t__":
        return Tensor(item[1])
    if isinstance(item, (list, tuple)):
        return type(item)(_rewrap(i) for i in item)
    if isinstance(item, dict):
        return {k: _rewrap(v) for k, v in item.items()}
    return item


def _np_collate(batch):
    """default_collate_fn's values as numpy, for worker processes; the
    parent re-wraps them. A Tensor sample (on the worker's CPU place) is
    stacked like an array, as default_collate_fn stacks it; the
    reference's has no branch for one and raises (ROADMAP queue 3)."""
    sample = batch[0]
    if isinstance(sample, Tensor):
        return ("__t__", dtype_mod.to_numpy(
            torch.stack([s._data for s in batch])))
    if isinstance(sample, np.ndarray):
        return ("__t__", _stack(batch))
    if isinstance(sample, (int, np.integer)):
        return ("__t__", np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return ("__t__", np.asarray(batch, np.float32))
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: _np_collate([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return [_np_collate(list(items)) for items in zip(*batch)]
    raise TypeError(f"cannot collate {type(sample)}")


def _worker_loop(dataset, collate_fn, idx_q, out_q, worker_id,
                 num_workers, worker_init_fn):
    global _worker_info
    # a forked child of a process that initialised CUDA must not touch the
    # card: everything it builds lands on the CPU
    place_mod.set_device("cpu")
    torch.set_num_threads(1)
    _worker_info = WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    np_mode = collate_fn is default_collate_fn
    try:
        while True:
            job = idx_q.get()
            if job is None:
                break
            seq, indices = job
            items = [dataset[i] for i in indices]
            if np_mode:
                out = _np_collate(items)
            else:
                # custom collate: its Tensors (CPU-resident here) cross
                # as numpy
                out = _unwrap(collate_fn(items))
            out_q.put((seq, out))
    except Exception as e:  # surface the error to the parent
        out_q.put((-1, f"worker {worker_id}: {e!r}"))


def get_worker_info():
    """Inside a worker process: (id, num_workers, dataset); None in the
    main process (reference io/dataloader/worker.py get_worker_info)."""
    return _worker_info
