"""Named wall-clock timers for train-loop phases: the port of
``paddle_tpu/distributed/fleet/utils/timer_helper.py`` (reference
fleet/utils/timer_helper.py: get_timers/set_timers, _Timer, Timers)."""
from __future__ import annotations

import time

_GLOBAL_TIMERS = None


def is_timer_initialized():
    return _GLOBAL_TIMERS is not None


def set_timers():
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        _GLOBAL_TIMERS = Timers()
    return _GLOBAL_TIMERS


def get_timers():
    assert _GLOBAL_TIMERS is not None, "timers are not initialized"
    return _GLOBAL_TIMERS


class _Timer:
    def __init__(self, name):
        self.name = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0

    def start(self):
        assert not self.started_, f"timer {self.name} already started"
        self.start_time = time.time()
        self.started_ = True

    def stop(self):
        assert self.started_, f"timer {self.name} is not started"
        self.elapsed_ += time.time() - self.start_time
        self.started_ = False

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset=True):
        started = self.started_
        if started:
            self.stop()
        e = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return e


class Timers:
    def __init__(self):
        self.timers = {}

    def __call__(self, name):
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def write(self, names, iteration, normalizer=1.0, reset=False):
        assert normalizer > 0.0
        for name in names:
            if name in self.timers:
                _ = self.timers[name].elapsed(reset=reset) / normalizer

    def log(self, names=None, normalizer=1.0, reset=True):
        assert normalizer > 0.0
        names = names if names is not None else list(self.timers)
        parts = []
        for name in names:
            if name in self.timers:
                e = self.timers[name].elapsed(reset=reset) / normalizer
                parts.append(f"{name}: {e * 1000.0:.2f}")
        msg = "time (ms) | " + " | ".join(parts)
        from .log_util import logger
        logger.info(msg)
        return msg
