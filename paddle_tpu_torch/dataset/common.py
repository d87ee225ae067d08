"""Dataset cache helpers (reference: python/paddle/dataset/common.py).

Port of ``paddle_tpu/dataset/common.py``. ``DATA_HOME`` is ``dataset/``
under the port's data directory (``$PADDLE_TPU_CACHE_DIR`` or ``.cache/``
at the root of the checkout; the reference's is ``~/.cache/paddle/dataset``).
There is no network: ``download`` returns a cached file or raises with the
path where it is expected."""
from __future__ import annotations

import hashlib
import os
import pickle

from ..vision.datasets import _data_home

DATA_HOME = os.path.join(_data_home(), "dataset")


def must_mkdirs(path):
    os.makedirs(path, exist_ok=True)


def md5file(fname):
    hash_md5 = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(4096), b""):
            hash_md5.update(chunk)
    return hash_md5.hexdigest()


def download(url, module_name, md5sum, save_name=None):
    """reference common.py:74. No network egress here: returns the cached
    file if present, else raises with the expected path so the user can
    place the archive manually."""
    dirname = os.path.join(DATA_HOME, module_name)
    must_mkdirs(dirname)
    filename = os.path.join(
        dirname, url.split('/')[-1] if save_name is None else save_name)
    if os.path.exists(filename) and (
            not md5sum or md5file(filename) == md5sum):
        return filename
    raise RuntimeError(
        f"dataset file not cached and this environment has no network "
        f"egress; place the file from {url} at {filename}")


def fetch_all():
    raise RuntimeError("fetch_all requires network egress; place dataset "
                       f"archives under {DATA_HOME} manually")


def split(reader, line_count, suffix="%05d.pickle", dumper=pickle.dump):
    """Split reader output into pickled chunk files (reference
    common.py:152)."""
    indx_f = 0
    lines = []
    for i, d in enumerate(reader()):
        lines.append(d)
        if i >= line_count and i % line_count == 0:
            with open(suffix % indx_f, "wb") as f:
                dumper(lines, f)
            lines = []
            indx_f += 1
    if lines:
        with open(suffix % indx_f, "wb") as f:
            dumper(lines, f)


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=pickle.load):
    """Read one trainer's slice of chunked files (reference
    common.py:190)."""

    def reader():
        import glob
        file_list = glob.glob(files_pattern)
        file_list.sort()
        my_file_list = [f for i, f in enumerate(file_list)
                        if i % trainer_count == trainer_id]
        for fn in my_file_list:
            with open(fn, "rb") as f:
                lines = loader(f)
                for line in lines:
                    yield line

    return reader
