"""paddle.batch (reference: python/paddle/batch.py:26) — wrap an
item-reader generator into a batched reader. ``paddle_tpu_torch.batch``
and ``ops.compat.batch`` are this one function."""
from __future__ import annotations


def batch(reader, batch_size, drop_last=False):
    if batch_size <= 0:
        raise ValueError("batch_size should be a positive integer value, "
                         f"but got batch_size={batch_size}")

    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
