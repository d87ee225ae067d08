"""Filesystem helpers: the port of ``paddle_tpu/distributed/fleet/utils/fs.py``
(reference: fleet/utils/fs.py — FS/LocalFS over
python fs ops, HDFSClient over the `hadoop fs` CLI). The checkpoint
paths (framework/io, distributed/checkpoint) accept any FS."""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FSShellCmdAborted(ExecuteError):
    pass


class FS:
    """Abstract FS surface (reference fs.py:72)."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def upload(self, local_path, fs_path):
        raise NotImplementedError

    def download(self, fs_path, local_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem (reference fs.py:134)."""

    def ls_dir(self, fs_path):
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            (dirs if os.path.isdir(os.path.join(fs_path, name))
             else files).append(name)
        return dirs, files

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            return
        with open(fs_path, "a"):
            pass

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if self.is_exist(dst_path):
            if not overwrite:
                raise FSFileExistsError(dst_path)
            self.delete(dst_path)
        shutil.move(src_path, dst_path)

    def upload(self, local_path, fs_path):
        if local_path != fs_path:
            shutil.copy(local_path, fs_path)

    def download(self, fs_path, local_path):
        if local_path != fs_path:
            shutil.copy(fs_path, local_path)

    def list_dirs(self, fs_path) -> List[str]:
        return self.ls_dir(fs_path)[0]


class HDFSClient(FS):
    """`hadoop fs` CLI wrapper (reference fs.py:474). Commands raise
    ExecuteError when the hadoop client is missing or fails — the
    checkpoint paths fall back to LocalFS on single-host setups."""

    def __init__(self, hadoop_home=None, configs=None,
                 time_out=5 * 60 * 1000, sleep_inter=1000):
        self._hadoop = os.path.join(hadoop_home, "bin", "hadoop") \
            if hadoop_home else "hadoop"
        self._configs = configs or {}
        self._timeout_s = time_out / 1000.0

    def _run(self, *args) -> str:
        cfg = []
        for k, v in self._configs.items():
            cfg += ["-D", f"{k}={v}"]
        cmd = [self._hadoop, "fs"] + cfg + list(args)
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=self._timeout_s)
        except FileNotFoundError as e:
            raise ExecuteError(f"hadoop client not found: {e}") from e
        except subprocess.TimeoutExpired as e:
            raise FSTimeOut(str(e)) from e
        if out.returncode != 0:
            raise ExecuteError(f"{' '.join(cmd)}: {out.stderr[-500:]}")
        return out.stdout

    def ls_dir(self, fs_path):
        lines = self._run("-ls", fs_path).splitlines()
        dirs, files = [], []
        for ln in lines:
            parts = ln.split()
            if len(parts) < 8:
                continue
            name = parts[-1].rsplit("/", 1)[-1]
            (dirs if parts[0].startswith("d") else files).append(name)
        return dirs, files

    def is_exist(self, fs_path):
        try:
            self._run("-test", "-e", fs_path)
            return True
        except ExecuteError:
            return False

    def is_file(self, fs_path):
        try:
            self._run("-test", "-f", fs_path)
            return True
        except ExecuteError:
            return False

    def is_dir(self, fs_path):
        try:
            self._run("-test", "-d", fs_path)
            return True
        except ExecuteError:
            return False

    def mkdirs(self, fs_path):
        self._run("-mkdir", "-p", fs_path)

    def delete(self, fs_path):
        self._run("-rm", "-r", "-f", fs_path)

    def rename(self, fs_src_path, fs_dst_path):
        self._run("-mv", fs_src_path, fs_dst_path)

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=True):
        # reference fs.py:1033 — overwrite-delete first, then the
        # existence checks (src must exist, dst must not)
        if overwrite and self.is_exist(fs_dst_path):
            self.delete(fs_dst_path)
        if test_exists:
            if not self.is_exist(fs_src_path):
                raise FSFileNotExistsError(f"{fs_src_path} is not exists")
            if self.is_exist(fs_dst_path):
                raise FSFileExistsError(f"{fs_dst_path} exists already")
        self._run("-mv", fs_src_path, fs_dst_path)

    def upload(self, local_path, fs_path):
        self._run("-put", local_path, fs_path)

    def download(self, fs_path, local_path):
        self._run("-get", fs_path, local_path)

    def touch(self, fs_path, exist_ok=True):
        if not exist_ok and self.is_exist(fs_path):
            raise FSFileExistsError(fs_path)
        self._run("-touchz", fs_path)

    def need_upload_download(self):
        return True
