"""paddle.text: the port of ``paddle_tpu/text`` (reference:
python/paddle/text): NLP datasets, Viterbi decoding, string tensors and the
tokenizers."""
from __future__ import annotations

import os

import numpy as np

from ..io import Dataset
from ..nn.layer.layers import Layer
from ..ops.extra import viterbi_decode  # noqa: F401
from ..core.string_tensor import (  # noqa: F401
    StringTensor, strings_empty, strings_lower, strings_upper)
from .tokenizer import (  # noqa: F401
    BasicTokenizer, FasterTokenizer, WordpieceTokenizer)


class ViterbiDecoder(Layer):
    """Layer wrapper over the viterbi_decode op (reference
    text/viterbi_decode.py)."""

    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        super().__init__()
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def forward(self, potentials, lengths):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)


class _FileDataset(Dataset):
    """Shared shell for the classic text datasets: files are read, never
    downloaded, from ``data_file`` or the port's data directory
    (``$PADDLE_TPU_CACHE_DIR`` or ``.cache/`` at the root of the checkout),
    as the vision datasets read theirs."""

    _NAME = ""

    def __init__(self, data_file=None, mode="train", **kw):
        from ..vision.datasets import _data_home
        root = data_file or os.path.join(_data_home(), self._NAME)
        if not os.path.exists(root):
            raise FileNotFoundError(
                f"{type(self).__name__} data not found at {root} "
                "(files are not downloaded; place the "
                "extracted files there)")
        self.root = root
        self.mode = mode
        self._load()

    def _load(self):
        self.samples = []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


class Conll05st(_FileDataset):
    _NAME = "conll05st"


class Imdb(_FileDataset):
    _NAME = "imdb"

    def _load(self):
        self.samples = []
        for lab, sub in ((0, "neg"), (1, "pos")):
            d = os.path.join(self.root, self.mode, sub)
            if os.path.isdir(d):
                for f in sorted(os.listdir(d)):
                    self.samples.append((os.path.join(d, f), lab))

    def __getitem__(self, idx):
        path, lab = self.samples[idx]
        with open(path, encoding="utf-8") as f:
            return f.read(), np.int64(lab)


class Imikolov(_FileDataset):
    _NAME = "imikolov"


class Movielens(_FileDataset):
    _NAME = "movielens"


class UCIHousing(_FileDataset):
    _NAME = "uci_housing"

    def _load(self):
        path = os.path.join(self.root, "housing.data")
        data = np.loadtxt(path) if os.path.exists(path) else \
            np.zeros((0, 14))
        # standard 80/20 split, features normalized (reference semantics)
        n = len(data)
        split = int(n * 0.8)
        feats = data[:, :-1].astype(np.float32)
        if n:
            mx, mn = feats.max(0), feats.min(0)
            feats = (feats - feats.mean(0)) / np.maximum(mx - mn, 1e-6)
        labels = data[:, -1:].astype(np.float32)
        sel = slice(0, split) if self.mode == "train" else slice(split, n)
        self.samples = list(zip(feats[sel], labels[sel]))


class WMT14(_FileDataset):
    _NAME = "wmt14"


class WMT16(_FileDataset):
    _NAME = "wmt16"


__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16", "ViterbiDecoder", "viterbi_decode"]
