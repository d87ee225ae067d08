"""Reader decorators (reference: python/paddle/reader/decorator.py:75-640).
A "reader" is a zero-arg callable returning an iterator of items."""
from __future__ import annotations

import itertools
import random
from queue import Queue
from threading import Thread


def cache(reader):
    """Cache the first full pass in memory; later passes replay it
    (reference decorator.py:75)."""
    all_data = tuple(reader())

    def __impl__():
        for item in all_data:
            yield item

    return __impl__


def map_readers(func, *readers):
    """Element-wise func over parallel readers (reference :161)."""

    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle (reference :202)."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers; each item gets chained into a flat stream
    (reference :247)."""

    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into combined tuples (reference :310)."""
    check_alignment = kwargs.pop('check_alignment', True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned.")
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Read ahead into a bounded buffer on a thread (reference :369)."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = Queue(maxsize=size)
        t = Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    """Limit to the first n items (reference :431)."""

    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


class XmapEndSignal:
    pass


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map items through `mapper` with process_num worker threads
    (reference :476 — thread pool there too, despite the name)."""
    end = XmapEndSignal()

    def read_worker(r, in_q):
        for i in r():
            in_q.put(i)
        in_q.put(end)

    def order_read_worker(r, in_q):
        for i, d in enumerate(r()):
            in_q.put((i, d))
        in_q.put(end)

    def handle_worker(in_q, out_q, m):
        sample = in_q.get()
        while not isinstance(sample, XmapEndSignal):
            out_q.put(m(sample))
            sample = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def order_handle_worker(in_q, out_q, m, out_order):
        cond, state = out_order
        ins = in_q.get()
        while not isinstance(ins, XmapEndSignal):
            order_id, sample = ins
            r = m(sample)
            with cond:
                while order_id != state[0]:
                    cond.wait()
                out_q.put(r)
                state[0] += 1
                cond.notify_all()
            ins = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        from threading import Condition
        in_q = Queue(buffer_size)
        out_q = Queue(buffer_size)
        out_order = (Condition(), [0])
        target = order_read_worker if order else read_worker
        t = Thread(target=target, args=(reader, in_q))
        t.daemon = True
        t.start()
        target = order_handle_worker if order else handle_worker
        args = (in_q, out_q, mapper, out_order) if order else \
            (in_q, out_q, mapper)
        workers = []
        for _ in range(process_num):
            w = Thread(target=target, args=args)
            w.daemon = True
            w.start()
            workers.append(w)
        finish = 0
        sample = out_q.get()
        while finish < process_num:
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample
            if finish < process_num:
                sample = out_q.get()

    return xreader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Fan-in several readers concurrently (reference :578; threads
    here — the items flow into the host pipeline either way)."""
    if len(readers) < 1:
        raise ValueError("multiprocess_reader needs at least one reader")
    end = XmapEndSignal()

    def work(r, q):
        for i in r():
            q.put(i)
        q.put(end)

    def queue_reader():
        q = Queue(queue_size)
        for r in readers:
            t = Thread(target=work, args=(r, q))
            t.daemon = True
            t.start()
        finish = 0
        while finish < len(readers):
            sample = q.get()
            if isinstance(sample, XmapEndSignal):
                finish += 1
            else:
                yield sample

    return queue_reader
