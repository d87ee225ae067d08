"""Image datasets: the port of ``paddle_tpu/vision/datasets.py``.

The archive readers read local files only and never download: where a file
is absent they raise ``FileNotFoundError``, as the reference's do. Their
default location is the port's data directory, ``$PADDLE_TPU_CACHE_DIR`` or
else ``.cache/`` at the root of the checkout (the reference's is
``~/.cache/paddle_tpu``); every reader also takes an explicit path.
``FakeData`` items equal the reference's bit for bit (``RandomState(idx)``).
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile

import numpy as np

from ..io import Dataset


def _data_home():
    base = os.environ.get("PADDLE_TPU_CACHE_DIR")
    if base is None:
        base = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))), ".cache")
    return base


class FakeData(Dataset):
    """Deterministic synthetic image dataset for tests/benchmarks."""

    def __init__(self, size=256, image_shape=(3, 32, 32), num_classes=10,
                 transform=None):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(*self.image_shape).astype(np.float32)
        label = np.int64(rng.randint(self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class MNIST(Dataset):
    """Loads the standard idx-format files from `image_path`/`label_path`."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None,
                 root=None):
        root = root or os.path.join(_data_home(), "mnist")
        names = {"train": ("train-images-idx3-ubyte.gz",
                           "train-labels-idx1-ubyte.gz"),
                 "test": ("t10k-images-idx3-ubyte.gz",
                          "t10k-labels-idx1-ubyte.gz")}
        img_f = image_path or os.path.join(root, names[mode][0])
        lab_f = label_path or os.path.join(root, names[mode][1])
        if not (os.path.exists(img_f) and os.path.exists(lab_f)):
            raise FileNotFoundError(
                f"MNIST files not found at {img_f}; place the idx .gz "
                "files there (nothing is downloaded)")
        with gzip.open(img_f, "rb") as f:
            data = np.frombuffer(f.read(), np.uint8, offset=16)
            self.images = data.reshape(-1, 28, 28)
        with gzip.open(lab_f, "rb") as f:
            self.labels = np.frombuffer(f.read(), np.uint8, offset=8) \
                .astype(np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar10(Dataset):
    """Loads cifar-10-python.tar.gz from `data_file`."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        data_file = data_file or os.path.join(_data_home(),
                                              "cifar-10-python.tar.gz")
        if not os.path.exists(data_file):
            raise FileNotFoundError(
                f"CIFAR-10 archive not found at {data_file} "
                "(nothing is downloaded)")
        self.transform = transform
        images, labels = [], []
        with tarfile.open(data_file) as tf:
            members = [m for m in tf.getmembers()
                       if ("data_batch" in m.name if mode == "train"
                           else "test_batch" in m.name)]
            for m in sorted(members, key=lambda m: m.name):
                d = pickle.load(tf.extractfile(m), encoding="bytes")
                images.append(d[b"data"])
                labels.extend(d[b"labels"])
        self.images = np.concatenate(images).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


Cifar100 = Cifar10  # same container format; different archive


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        exts = extensions or (".png", ".jpg", ".jpeg", ".npy")
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            for fn in sorted(os.listdir(os.path.join(root, c))):
                if fn.lower().endswith(exts):
                    self.samples.append(
                        (os.path.join(root, c, fn), self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        try:
            from PIL import Image
            return np.asarray(Image.open(path).convert("RGB"))
        except ImportError as e:
            raise RuntimeError("PIL not available for image loading") from e

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, label


ImageFolder = DatasetFolder


class FashionMNIST(MNIST):
    """Same idx format as MNIST, different files (reference
    vision/datasets/mnist.py FashionMNIST)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None, root=None):
        root = root or os.path.join(_data_home(), "fashion-mnist")
        super().__init__(image_path, label_path, mode, transform,
                         download, backend, root=root)


class Flowers(Dataset):
    """Oxford 102 Flowers (reference vision/datasets/flowers.py): images
    in a directory + scipy-format label .mat replaced by a labels.npy,
    or synthesized per-file labels when absent."""

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=False,
                 backend=None):
        root = data_file or os.path.join(_data_home(), "flowers")
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"Flowers data dir not found at {root} "
                "(nothing is downloaded; place extracted images there)")
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root)
            if f.lower().endswith((".jpg", ".png", ".npy")))
        lab = label_file or os.path.join(root, "labels.npy")
        if os.path.exists(lab):
            self.labels = np.load(lab).astype(np.int64)
        else:
            self.labels = np.zeros(len(self.files), np.int64)
        self.transform = transform

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        path = self.files[idx]
        if path.endswith(".npy"):
            img = np.load(path)
        else:
            from . import image_load
            img = image_load(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class VOC2012(Dataset):
    """Pascal VOC2012 segmentation pairs (reference
    vision/datasets/voc2012.py): JPEGImages/ + SegmentationClass/ under
    `data_file`."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        root = data_file or os.path.join(_data_home(), "voc2012")
        img_dir = os.path.join(root, "JPEGImages")
        seg_dir = os.path.join(root, "SegmentationClass")
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(
                f"VOC2012 not found at {root} (nothing is downloaded)")
        segs = sorted(os.listdir(seg_dir)) if os.path.isdir(seg_dir) \
            else []
        self.pairs = []
        for s in segs:
            stem = os.path.splitext(s)[0]
            img = os.path.join(img_dir, stem + ".jpg")
            if os.path.exists(img):
                self.pairs.append((img, os.path.join(seg_dir, s)))
        self.transform = transform

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx):
        from . import image_load
        img_p, seg_p = self.pairs[idx]
        img = image_load(img_p)
        seg = image_load(seg_p)
        if self.transform is not None:
            img = self.transform(img)
        return img, seg
