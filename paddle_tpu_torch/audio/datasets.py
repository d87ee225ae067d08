"""paddle.audio.datasets: the port of ``paddle_tpu/audio/datasets.py``
(reference python/paddle/audio/datasets): TESS and ESC50 over extracted
wav files in a local folder: ``data_dir``, else ``<name>/`` under the
port's data directory (``$PADDLE_TPU_CACHE_DIR`` or ``.cache/`` at the
root of the checkout; the reference's is ``~/.cache/paddle_tpu``).
Nothing is downloaded, and a missing folder raises."""
from __future__ import annotations

import os

import numpy as np

from ..io import Dataset
from ..vision.datasets import _data_home


class _AudioFolderDataset(Dataset):
    _NAME = ""

    def __init__(self, mode="train", feat_type="raw", data_dir=None,
                 archive=None, **kw):
        root = data_dir or os.path.join(_data_home(), self._NAME)
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"{type(self).__name__} data not found at {root} "
                "(no network access; place extracted wavs there)")
        self.files = []
        self.labels = []
        for dirpath, _, files in os.walk(root):
            for f in sorted(files):
                if f.endswith(".wav"):
                    self.files.append(os.path.join(dirpath, f))
                    self.labels.append(os.path.basename(dirpath))
        names = sorted(set(self.labels))
        self.label_ids = {n: i for i, n in enumerate(names)}
        self.feat_type = feat_type

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        from .backends import load
        wav, sr = load(self.files[idx])
        return wav, np.int64(self.label_ids[self.labels[idx]])


class TESS(_AudioFolderDataset):
    _NAME = "tess"
    n_class = 7


class ESC50(_AudioFolderDataset):
    _NAME = "esc50"
    n_class = 50


__all__ = ["TESS", "ESC50"]
