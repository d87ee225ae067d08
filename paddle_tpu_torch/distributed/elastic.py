"""Elastic training: the port of ``paddle_tpu/distributed/elastic.py``
(reference: ElasticManager, fleet/elastic/manager.py:125 — etcd heartbeat
membership, scale in/out, trainer relaunch).

The heartbeat/membership state machine against a pluggable KV store
(file-based store for single-host + tests, etcd-style interface for
clusters), the relaunch decision logic and the in-process restart
supervisor ``run_resilient``. Pure Python, as in the reference, but for
``TCPKVStore``, which rides the native ``TCPStore`` (``native/src/store.cc``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional


def _wrap_ttl(value: str, ttl_s: Optional[float]) -> str:
    return json.dumps({"value": value,
                       "expires": time.time() + ttl_s if ttl_s else None})


def _unwrap_ttl(raw) -> Optional[str]:
    """Decoded value, or None if malformed/expired."""
    value, _expired = _decode_ttl(raw)
    return value


def _decode_ttl(raw):
    """(value, expired): value is None when malformed OR expired;
    expired is True only for a well-formed entry past its TTL — the
    distinction lets FileKVStore physically purge expired files while
    leaving foreign/malformed files alone."""
    try:
        payload = json.loads(raw)
    except (json.JSONDecodeError, UnicodeDecodeError, TypeError):
        return None, False
    if not isinstance(payload, dict) or "value" not in payload:
        return None, False  # e.g. raw counters mirrored into kv space
    if payload.get("expires") and payload["expires"] < time.time():
        return None, True
    return payload["value"], False


class KVStore:
    """Pluggable store interface (etcd analog)."""

    def put(self, key: str, value: str, ttl_s: Optional[float] = None):
        raise NotImplementedError

    def get_prefix(self, prefix: str) -> Dict[str, str]:
        raise NotImplementedError

    def delete(self, key: str):
        raise NotImplementedError


class FileKVStore(KVStore):
    """Shared-filesystem store (works across hosts on NFS/GCS-fuse)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key):
        return os.path.join(self.root, key.replace("/", "__"))

    def put(self, key, value, ttl_s=None):
        # unique tmp per writer: concurrent puts of the SAME key (a
        # watchdog's arm-time publish racing its monitor thread's
        # startup publish, or two hosts heartbeating one shared key)
        # must not steal each other's tmp file — os.replace stays the
        # single atomic point and last-writer-wins
        tmp = self._path(key) + \
            f".{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(_wrap_ttl(value, ttl_s))
        os.replace(tmp, self._path(key))

    def get_prefix(self, prefix):
        out = {}
        p = prefix.replace("/", "__")
        for fn in os.listdir(self.root):
            if not fn.startswith(p) or fn.endswith(".tmp"):
                continue
            try:
                with open(os.path.join(self.root, fn)) as f:
                    raw = f.read()
            except OSError:
                continue
            value, expired = _decode_ttl(raw)
            if value is not None:
                out[fn.replace("__", "/")] = value
            elif expired:
                # lazy GC: a long-running job heartbeats forever and
                # would otherwise grow the store unboundedly with dead
                # nodes' files. Racing a concurrent re-put is benign:
                # worst case one fresh heartbeat file is dropped and
                # the next heartbeat (heartbeat_s later) restores it.
                try:
                    os.remove(os.path.join(self.root, fn))
                except OSError:
                    pass
        return out

    def delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass


class TCPKVStore(KVStore):
    """KVStore over the native C++ TCPStore (``native/src/store.cc``): the
    in-cluster etcd stand-in where no shared filesystem exists. TTLs are
    enforced read-side from an expiry stamp in the payload, as
    ``FileKVStore`` does."""

    def __init__(self, host: str, port: int, is_master: bool = False):
        from ..native import TCPStore
        self._store = TCPStore(host, port, is_master=is_master)

    def put(self, key, value, ttl_s=None):
        self._store.set(key, _wrap_ttl(value, ttl_s))

    def get_prefix(self, prefix):
        out = {}
        for key, raw in self._store.list(prefix).items():
            value, expired = _decode_ttl(raw)
            if value is not None:
                out[key] = value
            elif expired:
                # lazy GC, as FileKVStore's: only well-formed expired
                # entries go; racing a concurrent re-put is benign (the
                # next heartbeat restores the key)
                self._store.delete_key(key)
        return out

    def delete(self, key):
        self._store.delete_key(key)


def run_resilient(fn: Callable[[int], object], *, max_restarts: int = 3,
                  backoff_s: float = 0.5, backoff_factor: float = 2.0,
                  max_backoff_s: float = 30.0,
                  restartable=(Exception,), on_restart=None):
    """Single-host supervised restart: the in-process
    analog of the launcher's ``--max_restarts`` relaunch loop, for
    loops that recover from *catchable* crashes — an injected chaos
    fault, a poisoned step, a transient runtime error — without
    paying process teardown.

    Calls ``fn(attempt)`` (attempt 0 first). When fn raises a
    ``restartable`` exception, waits ``backoff_s * backoff_factor **
    (attempt-1)`` (capped at ``max_backoff_s``), ticks the
    ``train.restarts`` counter, calls ``on_restart(attempt, exc)`` if
    given, and calls fn again — at most ``max_restarts`` restarts,
    then the last exception propagates. ``KeyboardInterrupt`` /
    ``SystemExit`` always propagate (the operator's ctrl-C must win).

    Recovery of *state* is fn's job: build the loop with a
    ``hapi.FaultTolerantCheckpoint`` (or call
    ``training.load_train_checkpoint``) so every attempt resumes from
    ``checkpoint.latest_committed()`` — the resume-equivalence test
    proves crash+resume reproduces the uninterrupted run bitwise.
    NOTE a ``training.NonFiniteStepError`` abort is deterministic for
    a given data shard; restarting replays the same garbage, so the
    breaker fires again and the supervisor gives up after the bounded
    retries — by design it never converts a diagnostic abort into an
    infinite crash loop."""
    attempt = 0
    while True:
        try:
            return fn(attempt)
        except (KeyboardInterrupt, SystemExit):
            raise
        except restartable as e:
            attempt += 1
            if attempt > max_restarts:
                raise
            from ..observability import metrics as _met
            if _met._ENABLED:
                _met.REGISTRY.counter("train.restarts").inc()
            if on_restart is not None:
                on_restart(attempt, e)
            delay = min(backoff_s * (backoff_factor ** (attempt - 1)),
                        max_backoff_s)
            if delay > 0:
                time.sleep(delay)


class ElasticManager:
    """Heartbeat + membership watcher (manager.py:125 semantics):
    each node heartbeats `{prefix}/nodes/{rank}` with a TTL; the watcher
    detects join/leave and calls on_change(world) so the trainer can
    checkpoint + relaunch with new endpoints."""

    def __init__(self, store: KVStore, job_id: str, rank: int,
                 np_range: Optional[tuple] = None, heartbeat_s: float = 2.0,
                 ttl_s: float = 6.0,
                 on_change: Optional[Callable[[List[int]], None]] = None):
        self.store = store
        self.prefix = f"elastic/{job_id}"
        self.rank = rank
        self.heartbeat_s = heartbeat_s
        self.ttl_s = ttl_s
        self.on_change = on_change
        self.np_min, self.np_max = np_range or (1, 1 << 30)
        self._stop = threading.Event()
        self._threads = []
        self._last_world: List[int] = []

    def world(self) -> List[int]:
        nodes = self.store.get_prefix(f"{self.prefix}/nodes/")
        return sorted(int(k.rsplit("/", 1)[-1]) for k in nodes)

    def _heartbeat_loop(self):
        while not self._stop.is_set():
            self.store.put(f"{self.prefix}/nodes/{self.rank}",
                           json.dumps({"ts": time.time()}),
                           ttl_s=self.ttl_s)
            self._stop.wait(self.heartbeat_s)

    def _watch_loop(self):
        while not self._stop.wait(self.heartbeat_s):
            w = self.world()
            if w != self._last_world:
                prev = self._last_world
                self._last_world = w
                if prev and self.on_change is not None:
                    self.on_change(w)

    def start(self):
        self.store.put(f"{self.prefix}/nodes/{self.rank}",
                       json.dumps({"ts": time.time()}), ttl_s=self.ttl_s)
        self._last_world = self.world()
        for target in (self._heartbeat_loop, self._watch_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=1.0)
        self.store.delete(f"{self.prefix}/nodes/{self.rank}")

    def healthy(self) -> bool:
        n = len(self.world())
        return self.np_min <= n <= self.np_max
