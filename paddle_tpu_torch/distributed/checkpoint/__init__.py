"""Distributed checkpoint: the port of
``paddle_tpu/distributed/checkpoint/__init__.py`` (reference:
paddle.distributed.checkpoint — save_state_dict writes per-rank shard files
plus a metadata file; load_state_dict fills the target tensors).

The layout is the reference's: ``metadata.json`` maps each flat key to its
shape, dtype and the entries that hold it, ``shard_<rank>.npz`` holds the
arrays, and ``_COMMITTED.json`` is written last. A checkpoint that either
package wrote loads in the other.

Commit protocol: per-file atomicity alone cannot order the metadata
publish against the shard writes — a writer killed mid-save could leave a
READABLE but torn checkpoint. The coordinator therefore removes any stale
``_COMMITTED.json`` FIRST, writes its shard + metadata, and publishes the
commit manifest LAST; ``load_state_dict`` refuses a directory without a
valid manifest or whose manifest references files that do not exist. Into
a FRESH directory (the per-step layout resume uses via
:func:`latest_committed`) an interrupted save is simply never committed.
Re-saving into an EXISTING directory reuses shard filenames, so prefer
per-save directories.

What the port does differently:

- every tensor is copied to the host before ``save_state_dict`` returns,
  also with ``async_save``: the port's optimizers write their states in
  place, so a write thread reading live tensors would save whatever the
  next step made of them;
- bfloat16 is stored as its 16-bit pattern (``uint16``) with the dtype name
  ``bfloat16`` in the metadata: numpy has no bfloat16 without
  ``ml_dtypes``. A reference checkpoint's bfloat16 arrays are read by their
  bits as well;
- loading copies into the live tensors in place, on their own devices;
- the rank is ``torch.distributed``'s, or 0 when no process group exists;
- a plain ``torch.Tensor`` (a leaf of gpt_hybrid's parameter tree) is saved
  and loaded in place like a Tensor;
- a sharded tensor is a ``ShardedTensor``: this rank's block of a global
  tensor, with the global shape and the block's offsets. Each rank writes
  its own blocks as the reference's ``index`` entries ([start, stop) per
  dim); the coordinator gathers every rank's entries into the metadata
  (so every rank of the group calls ``save_state_dict``, and the save is
  synchronous). ``load_state_dict`` assembles a target's region, whole
  tensor or ``ShardedTensor`` block, from whichever entries overlap it, so a
  checkpoint written at one world size loads at another.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ...core.tensor import Tensor
from ...io import _world

#: commit manifest written LAST by the coordinator; its presence (and
#: the existence of every file it references) defines "committed"
COMMIT_MARKER = "_COMMITTED.json"


class ShardedTensor:
    """This rank's block of a global tensor: ``local`` (a Tensor) holds the
    elements at ``offsets`` .. ``offsets + local.shape`` of a tensor of
    ``global_shape``."""

    def __init__(self, local: Tensor, global_shape, offsets):
        self.local = local
        self.global_shape = tuple(int(n) for n in global_shape)
        self.offsets = tuple(int(o) for o in offsets)
        if len(self.offsets) != len(self.global_shape) or \
                len(self.offsets) != local._data.dim():
            raise ValueError("ShardedTensor: offsets, global shape and the "
                             "local block need the same rank")

    @property
    def index(self):
        return [[o, o + n] for o, n in zip(self.offsets,
                                            self.local._data.shape)]


def _flat(state_dict, prefix=""):
    out = {}
    for k, v in state_dict.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _dtype_name(arr: torch.Tensor) -> str:
    return str(arr.dtype).replace("torch.", "")


def _to_host(arr: torch.Tensor) -> np.ndarray:
    """A host copy of ``arr`` as numpy (never a view of a live tensor);
    bfloat16 as its bits."""
    host = arr.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")     # keeps a 0-d array 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, async_save: bool = False):
    os.makedirs(path, exist_ok=True)
    pid = _world()[1]
    flat = _flat(state_dict)
    meta = {"version": 1, "tensors": {}}
    arrays = {}
    sharded = False
    for key, t in flat.items():
        if isinstance(t, ShardedTensor):
            sharded = True
            arr = t.local._data
            entries = []
            if arr.numel():
                name = f"{key}.{pid}"
                arrays[name] = _to_host(arr)
                entries.append({"file": f"shard_{pid}.npz", "name": name,
                                "index": t.index})
            meta["tensors"][key] = {"kind": "tensor",
                                    "shape": list(t.global_shape),
                                    "dtype": _dtype_name(arr),
                                    "entries": entries}
            continue
        if not isinstance(t, (Tensor, torch.Tensor)):
            meta["tensors"][key] = {"kind": "python", "value": t}
            continue
        arr = t._data if isinstance(t, Tensor) else t
        entries = []
        # dedup: only the coordinator writes (every tensor is whole)
        if pid == coordinator_rank:
            name = f"{key}.full"
            arrays[name] = _to_host(arr)
            entries.append({"file": f"shard_{pid}.npz", "name": name,
                            "index": None})
        meta["tensors"][key] = {
            "kind": "tensor",
            "shape": list(arr.shape),
            "dtype": _dtype_name(arr),
            "entries": entries,
        }
    gather = sharded and _world()[0] > 1

    def _write():
        # atomic PER FILE (tmp + os.replace): a writer killed mid-save
        # never leaves a truncated npz/metadata. ORDERING is the commit
        # manifest's job: drop any stale marker first (the directory is
        # "in progress" from here), publish the marker LAST, and let
        # load verify every referenced file exists.
        if pid == coordinator_rank:
            try:
                os.remove(os.path.join(path, COMMIT_MARKER))
            except FileNotFoundError:
                pass
        # chaos site: a fault here models a writer killed mid-save — the
        # stale marker is gone, nothing is committed, and resume must
        # skip this directory
        from ... import _chaos
        _chaos.hit("train.checkpoint_save", path=path)
        shard = os.path.join(path, f"shard_{pid}.npz")
        np.savez(shard + ".tmp.npz", **arrays)
        os.replace(shard + ".tmp.npz", shard)
        if gather:
            # every rank's entries, once every shard file is in place
            import torch.distributed as dist
            everyone = [None] * dist.get_world_size()
            dist.all_gather_object(everyone, meta)
            for r, other in enumerate(everyone):
                for key, info in other["tensors"].items():
                    if r != pid and info.get("kind") == "tensor" and any(
                            e["index"] is not None for e in info["entries"]):
                        meta["tensors"][key]["entries"].extend(
                            info["entries"])
        if pid == coordinator_rank:
            mpath = os.path.join(path, "metadata.json")
            with open(mpath + ".tmp", "w") as f:
                json.dump(meta, f)
            os.replace(mpath + ".tmp", mpath)
            files = sorted({e["file"]
                            for info in meta["tensors"].values()
                            if info.get("kind") == "tensor"
                            for e in info["entries"]})
            marker = {"version": 1, "ts": time.time(),
                      "files": files + ["metadata.json"]}
            cpath = os.path.join(path, COMMIT_MARKER)
            with open(cpath + ".tmp", "w") as f:
                json.dump(marker, f)
            os.replace(cpath + ".tmp", cpath)

    if async_save and not gather:
        th = threading.Thread(target=_write, daemon=True)
        th.start()
        return th
    _write()


def _read_marker(path: str) -> Optional[dict]:
    try:
        with open(os.path.join(path, COMMIT_MARKER)) as f:
            marker = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return marker if isinstance(marker, dict) else None


def is_committed(path: str) -> bool:
    """True when ``path`` holds a fully-committed checkpoint: the
    commit manifest exists AND every file it references does too."""
    marker = _read_marker(path)
    if marker is None:
        return False
    return all(os.path.exists(os.path.join(path, f))
               for f in marker.get("files", ()))


def latest_committed(root: str) -> Optional[str]:
    """The newest COMMITTED checkpoint at ``root``: the root itself if
    it is committed, else the newest committed immediate subdirectory
    (by the manifest's commit timestamp, then name). Uncommitted /
    torn / in-progress saves are skipped. None when nothing committed
    exists."""
    if is_committed(root):
        return root
    best = None
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return None
    for name in names:
        sub = os.path.join(root, name)
        if not os.path.isdir(sub) or not is_committed(sub):
            continue
        ts = _read_marker(sub).get("ts", 0)
        if best is None or (ts, name) > best[:2]:
            best = (ts, name, sub)
    return best[2] if best else None


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0, offload: bool = False,
                    require_committed: bool = True):
    """Fill `state_dict`'s tensors in place, on each tensor's own device
    and in its own dtype; python values are written back into the dict.

    Refuses an UNCOMMITTED checkpoint (no ``_COMMITTED.json``, or a
    manifest referencing missing shard files): a save interrupted
    mid-write is indistinguishable from a valid one by per-file
    inspection alone, and loading it silently corrupts the resume.
    ``require_committed=False`` skips the check for legacy
    checkpoints written before the commit protocol existed."""
    if require_committed:
        marker = _read_marker(path)
        if marker is None:
            raise ValueError(
                f"checkpoint at {path!r} is not committed (missing or "
                f"unreadable {COMMIT_MARKER}) — the save was "
                "interrupted or is still in progress; pick a committed "
                "checkpoint (latest_committed()) or pass "
                "require_committed=False for pre-protocol checkpoints")
        missing = [f for f in marker.get("files", ())
                   if not os.path.exists(os.path.join(path, f))]
        if missing:
            raise ValueError(
                f"checkpoint at {path!r} is partial: committed "
                f"manifest references missing file(s) {missing} — "
                "refusing to load a torn save")
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    files: Dict[str, "np.lib.npyio.NpzFile"] = {}
    flat = _flat(state_dict)
    restored_py = {}
    try:
        for key, t in flat.items():
            info = meta["tensors"].get(key)
            if info is None:
                continue
            if info["kind"] == "python":
                restored_py[key] = info["value"]
                continue
            if isinstance(t, ShardedTensor):
                dst, lo = t.local._data, t.offsets
                owner = t.local
            elif isinstance(t, (Tensor, torch.Tensor)):
                owner = t if isinstance(t, Tensor) else None
                dst = t._data if owner is not None else t
                lo = (0,) * dst.dim()
                if tuple(info["shape"]) != tuple(dst.shape):
                    raise ValueError(
                        f"checkpoint entry {key!r} has shape "
                        f"{tuple(info['shape'])}, the target "
                        f"{tuple(dst.shape)}")
            else:
                continue
            _fill(dst, lo, key, info, path, files)
            if owner is not None:
                owner._version += 1
    finally:
        for f in files.values():
            f.close()
    if restored_py:
        _write_back_python(state_dict, restored_py)
    return state_dict


def _fill(dst, lo, key, info, path, files):
    """Copies into ``dst`` (the block at offsets ``lo`` of the saved
    tensor) every saved entry's overlap with it; raises unless the entries
    cover the block."""
    hi = [o + n for o, n in zip(lo, dst.shape)]
    shape = info["shape"]
    if any(h > n for h, n in zip(hi, shape)) or len(lo) != len(shape):
        raise ValueError(f"checkpoint entry {key!r} of shape {tuple(shape)} "
                         f"holds no block at {list(lo)} of shape "
                         f"{tuple(dst.shape)}")
    covered = 0
    for e in info["entries"]:
        idx = e["index"] or [[0, n] for n in shape]
        a = [max(s, o) for (s, _), o in zip(idx, lo)]
        b = [min(t, h) for (_, t), h in zip(idx, hi)]
        if any(x >= y for x, y in zip(a, b)) and dst.dim():
            continue
        if e["file"] not in files:
            files[e["file"]] = np.load(os.path.join(path, e["file"]))
        src = _from_host(files[e["file"]][e["name"]], info["dtype"])
        src_sl = tuple(slice(x - s, y - s) for x, y, (s, _) in zip(a, b, idx))
        dst_sl = tuple(slice(x - o, y - o) for x, y, o in zip(a, b, lo))
        with torch.no_grad():
            dst[dst_sl].copy_(src[src_sl])
        covered += int(np.prod([y - x for x, y in zip(a, b)]))
    if covered < dst.numel():
        raise ValueError(f"checkpoint entry {key!r} at {path!r}: the saved "
                         f"blocks cover {covered} of the {dst.numel()} "
                         "elements asked for")


def _write_back_python(tree, restored, prefix=""):
    """Restore saved python (non-tensor) values into the nested
    state_dict in place (step counters, LR schedule scalars). Key
    layout matches _flat()."""
    for k in list(tree):
        key = f"{prefix}.{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            _write_back_python(v, restored, key)
        elif not isinstance(v, (Tensor, torch.Tensor, ShardedTensor)) \
                and key in restored:
            tree[k] = restored[key]
