"""MNIST readers (reference: python/paddle/dataset/mnist.py:42,102,129).
Items: (image float32[784] scaled to [-1,1], label int64)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from .common import DATA_HOME

_SYNTH_N = 512


def reader_creator(image_filename, label_filename, buffer_size):
    def reader():
        with gzip.open(image_filename, 'rb') as imgf, \
                gzip.open(label_filename, 'rb') as lblf:
            magic, n, rows, cols = struct.unpack(">IIII", imgf.read(16))
            struct.unpack(">II", lblf.read(8))
            while True:
                buf = imgf.read(rows * cols * buffer_size)
                if not buf:
                    break
                imgs = np.frombuffer(buf, np.uint8).reshape(
                    -1, rows * cols).astype(np.float32)
                imgs = imgs / 255.0 * 2.0 - 1.0
                lbls = np.frombuffer(
                    lblf.read(len(imgs)), np.uint8).astype(np.int64)
                for im, lb in zip(imgs, lbls):
                    yield im, int(lb)

    return reader


def _synth_reader(seed):
    def reader():
        rs = np.random.RandomState(seed)
        for _ in range(_SYNTH_N):
            yield (rs.uniform(-1, 1, 784).astype(np.float32),
                   int(rs.randint(10)))

    return reader


def _files(split):
    d = os.path.join(DATA_HOME, "mnist")
    return (os.path.join(d, f"{split}-images-idx3-ubyte.gz"),
            os.path.join(d, f"{split}-labels-idx1-ubyte.gz"))


def train():
    imgs, lbls = _files("train")
    if os.path.exists(imgs) and os.path.exists(lbls):
        return reader_creator(imgs, lbls, 100)
    return _synth_reader(0)


def test():
    imgs, lbls = _files("t10k")
    if os.path.exists(imgs) and os.path.exists(lbls):
        return reader_creator(imgs, lbls, 100)
    return _synth_reader(1)


def fetch():
    from .common import download
    download("https://dataset.bj.bcebos.com/mnist/train-images-idx3-ubyte.gz",
             "mnist", None)
