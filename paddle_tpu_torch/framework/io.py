"""paddle.save / paddle.load: the port of ``paddle_tpu/framework/io.py``
(reference: python/paddle/framework/io.py:773, 1020 - pickled state dicts).

A Tensor is stored as a numpy array, its dtype's name and its
stop_gradient. bfloat16 and float8 are stored as their unsigned-integer
bits (core/dtype.py ``to_bits``), so a file loads where ``ml_dtypes`` is
not installed. ``load`` also reads the reference's files, whose bfloat16
arrays need ``ml_dtypes`` to unpickle.
"""
from __future__ import annotations

import os
import pickle

from ..core import dtype as dtype_mod
from ..core.place import default_device
from ..core.tensor import Tensor


def _to_storable(obj):
    if isinstance(obj, Tensor):
        data, name = dtype_mod.to_bits(obj._data)
        return {"__tensor__": True, "data": data, "dtype": name,
                "stop_gradient": obj.stop_gradient}
    if isinstance(obj, dict):
        return {k: _to_storable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_to_storable(v) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def _from_storable(obj, return_numpy=False):
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            arr = (dtype_mod.from_bits(obj["data"], obj["dtype"])
                   if "dtype" in obj else dtype_mod.from_numpy(obj["data"]))
            if return_numpy:
                return dtype_mod.to_numpy(arr)
            return Tensor._wrap(arr.to(default_device()),
                                stop_gradient=obj.get("stop_gradient", True))
        return {k: _from_storable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        t = [_from_storable(v, return_numpy) for v in obj]
        return t if isinstance(obj, list) else tuple(t)
    return obj


def save(obj, path, protocol=4, **configs):
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_to_storable(obj), f, protocol=protocol)


def load(path, return_numpy=False, **configs):
    """Unpickles ``path``: load only files that this program wrote."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    return _from_storable(obj, return_numpy)
