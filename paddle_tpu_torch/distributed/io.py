"""paddle.distributed.io: the port of ``paddle_tpu/distributed/io.py``
(reference: python/paddle/distributed/io.py): save of a program's
persistables through ``paddle.save``."""
from __future__ import annotations

import os


def is_persistable(var):
    return getattr(var, "persistable", False)


def save_persistables(executor, dirname, main_program=None, filename=None):
    from ..framework import io as fio
    os.makedirs(dirname, exist_ok=True)
    pers = getattr(main_program, "_persistables", {}) if main_program \
        else {}
    fio.save(dict(pers),
             os.path.join(dirname, filename or "persistables.pdparams"))


def load_inference_model_distributed(dirname, executor, **kw):
    raise NotImplementedError("use paddle_tpu_torch.jit.load")
