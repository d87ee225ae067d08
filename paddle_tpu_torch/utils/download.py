"""paddle.utils.download (reference: utils/download.py —
get_weights_path_from_url + cached archive handling). There is no network:
a file resolves from the local cache, and a missing one raises with the
path where it is expected. The cache is the port's data directory
(``$PADDLE_TPU_CACHE_DIR`` or ``.cache/`` at the root of the checkout),
``hapi/weights`` under it; the reference's is
``~/.cache/paddle/hapi/weights``."""
from __future__ import annotations

import hashlib
import os
import tarfile
import zipfile

from ..vision.datasets import _data_home

__all__ = ["get_weights_path_from_url", "get_path_from_url"]

WEIGHTS_HOME = os.path.join(_data_home(), "hapi", "weights")


def _md5check(fullname, md5sum=None):
    if md5sum is None:
        return True
    md5 = hashlib.md5()
    with open(fullname, 'rb') as f:
        for chunk in iter(lambda: f.read(4096), b""):
            md5.update(chunk)
    return md5.hexdigest() == md5sum


def _decompress(fname, dirname):
    if tarfile.is_tarfile(fname):
        with tarfile.open(fname) as tf:
            tf.extractall(dirname)
    elif zipfile.is_zipfile(fname):
        with zipfile.ZipFile(fname) as zf:
            zf.extractall(dirname)
    return dirname


def get_path_from_url(url, root_dir, md5sum=None, check_exist=True,
                      decompress=True):
    fname = os.path.basename(url)
    fullname = os.path.join(root_dir, fname)
    if os.path.exists(fullname) and _md5check(fullname, md5sum):
        if decompress and (tarfile.is_tarfile(fullname)
                           or zipfile.is_zipfile(fullname)):
            _decompress(fullname, root_dir)
        return fullname
    raise RuntimeError(
        f"no network egress in this environment; place the file from "
        f"{url} at {fullname}")


def get_weights_path_from_url(url, md5sum=None):
    """reference download.py get_weights_path_from_url."""
    os.makedirs(WEIGHTS_HOME, exist_ok=True)
    return get_path_from_url(url, WEIGHTS_HOME, md5sum, decompress=False)
