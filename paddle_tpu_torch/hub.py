"""paddle.hub (reference: python/paddle/hapi/hub.py), the port of
``paddle_tpu/hub.py``: load models from a local hubconf.py (the
github/gitee sources need egress; local dirs work)."""
from __future__ import annotations

import importlib.util
import os
import sys


def _load_hubconf(repo_dir):
    path = os.path.join(repo_dir, "hubconf.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no hubconf.py in {repo_dir}")
    spec = importlib.util.spec_from_file_location("hubconf", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["hubconf"] = mod
    spec.loader.exec_module(mod)
    return mod


def list(repo_dir, source="local", force_reload=False):
    if source != "local":
        raise RuntimeError("no network egress: only source='local' "
                           "is supported")
    mod = _load_hubconf(repo_dir)
    return [n for n in dir(mod)
            if callable(getattr(mod, n)) and not n.startswith("_")]


def help(repo_dir, model, source="local", force_reload=False):
    mod = _load_hubconf(repo_dir)
    return getattr(mod, model).__doc__


def load(repo_dir, model, *args, source="local", force_reload=False,
         **kwargs):
    if source != "local":
        raise RuntimeError("no network egress: only source='local' "
                           "is supported")
    mod = _load_hubconf(repo_dir)
    return getattr(mod, model)(*args, **kwargs)


__all__ = ["list", "help", "load"]
