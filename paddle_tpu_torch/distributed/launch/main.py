"""``python -m paddle_tpu_torch.distributed.launch [--opts] script.py
args...``: the port of ``paddle_tpu/distributed/launch/main.py``.

Failure policy (reference launch controllers): one worker exiting non-zero
stops the job with its code, or with ``--max_restarts`` relaunches the
whole job (``PADDLE_RESTART_COUNT`` counts the attempts); ``--np_range
MIN:MAX`` relaunches at the surviving world size (scale-in) and, with
``--elastic_store DIR`` (a ``FileKVStore``) or ``--elastic_store
tcp://HOST:PORT`` (a ``TCPKVStore``, whose native ``TCPStore`` server this
launcher hosts at that port), at a larger one when workers announce
themselves under ``join/`` (scale-out).

Every worker starts in a session of its own, and a stop kills each
worker's whole process group (SIGTERM, then SIGKILL after 5 s), so no
worker or child of one is left blocked in a rendezvous.

The rendezvous store is the launcher's own: on the first node it hosts a
torch ``TCPStore`` (at ``--master``'s port, or at a port the OS picks) for
each launch of the job, and every worker joins it as a client
(``PADDLE_STORE_HOSTED``). The port stays bound from before the workers
start until the job's attempt ends, so no other process on the machine can
take it in between, and a worker never outlives the store it talks to. The
elastic ``tcp://`` store is another store, bound before the first
rendezvous store: the two never share a port (``--master`` at the elastic
store's port is refused).
``PADDLE_TRAINER_ENDPOINTS`` and ``PADDLE_CURRENT_ENDPOINT`` name the
workers as the reference's launcher does (host:port, the ports after the
store's, one a rank); nothing listens at them.
"""
from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time


def _host_store(host, port, world):
    """A TCPStore server at ``host:port`` (port 0: the OS picks one) that
    the job's workers join as clients; returns (store, its port)."""
    import datetime

    import torch.distributed as dist
    store = dist.TCPStore(host, int(port), world, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=300))
    return store, str(store.port)


def _parse(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--master", default=None,
                   help="host:port of rank 0's rendezvous store")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--rank", type=int, default=0,
                   help="this node's rank (multi-host)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes on this host: one per GPU")
    p.add_argument("--devices", default=None,
                   help="accepted for the reference's command line")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--job_id", default="default")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="on a worker failure, restart the whole job up to "
                        "N times")
    p.add_argument("--np_range", default=None, metavar="MIN:MAX",
                   help="elastic world size: on a worker failure, relaunch "
                        "at the surviving world size (>= MIN); with "
                        "--elastic_store, grow up to MAX on joins")
    p.add_argument("--elastic_store", default=None,
                   metavar="DIR|tcp://HOST:PORT",
                   help="the store watched for join/<name> announcements "
                        "(scale-out): a FileKVStore directory, or a "
                        "TCPKVStore this launcher hosts at PORT")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def _spawn(args, attempt, nprocs=None):
    """Starts this node's workers of one attempt; returns [(rank, Popen)].
    On the first node it first hosts the attempt's store
    (``args.store``, replacing the last attempt's)."""
    nprocs = nprocs if nprocs is not None else args.nproc_per_node
    world = args.nnodes * nprocs
    if args.master is None:
        host, port = "127.0.0.1", "0"
    else:
        host, port = args.master.rsplit(":", 1)
    if args.rank == 0:
        args.store = None          # the last attempt's port is free again
        args.store, port = _host_store(host, port, world)
    master = f"{host}:{port}"
    # the reference's placeholders: host:port a rank, after the store's port
    base_port = int(port) + 1
    endpoints = ",".join(f"{host}:{base_port + r}" for r in range(world))
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs = []
    for local in range(nprocs):
        rank = args.rank * nprocs + local
        env = dict(os.environ)
        env.update({
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_MASTER": master,
            "PADDLE_MASTER_ENDPOINT": master,
            "PADDLE_LOCAL_RANK": str(local),
            "PADDLE_JOB_ID": args.job_id,
            "PADDLE_TRAINER_ENDPOINTS": endpoints,
            "PADDLE_CURRENT_ENDPOINT": f"{host}:{base_port + rank}",
            "PADDLE_STORE_HOSTED": "1",
            "PADDLE_RESTART_COUNT": str(attempt),
            "RANK": str(rank),
            "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(local),
            "LOCAL_WORLD_SIZE": str(nprocs),
            "MASTER_ADDR": host,
            "MASTER_PORT": port,
        })
        cmd = [sys.executable, args.script] + args.script_args
        out = open(os.path.join(
            args.log_dir, f"worker.{rank}.attempt{attempt}.log"), "w") \
            if args.log_dir else None
        try:
            procs.append((rank, subprocess.Popen(
                cmd, env=env, stdout=out,
                stderr=subprocess.STDOUT if out else None,
                start_new_session=True)))
        finally:
            if out is not None:
                out.close()
    return procs


def _kill_all(procs):
    """SIGTERM every worker's process group, SIGKILL what is left after
    5 s, and reap the workers."""
    for _, p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
    deadline = time.time() + 5
    for _, p in procs:
        try:
            p.wait(max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
    for _, p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        p.wait()


def main(argv=None):
    args = _parse(argv)
    lo = hi = None
    if args.np_range:
        try:
            lo, hi = (int(v) for v in args.np_range.split(":"))
        except ValueError:
            raise SystemExit(
                f"--np_range must be MIN:MAX, got {args.np_range!r}")
        if not (1 <= lo <= hi):
            raise SystemExit(
                f"--np_range needs 1 <= MIN <= MAX, got {args.np_range!r}")
    if args.elastic_store and not args.np_range:
        raise SystemExit("--elastic_store requires --np_range (the join "
                         "watcher needs a MAX world size to scale to)")
    if args.master is None and args.nnodes != 1:
        raise SystemExit("--master host:port is required with --nnodes > 1")
    args.store = None
    store = None
    if args.elastic_store:
        if args.elastic_store.startswith("tcp://"):
            from ..elastic import TCPKVStore
            hostport = args.elastic_store[6:]
            if ":" not in hostport or \
                    not hostport.rsplit(":", 1)[1].isdigit():
                raise SystemExit(
                    f"--elastic_store {args.elastic_store!r}: expected "
                    "tcp://HOST:PORT with a numeric port")
            host, port = hostport.rsplit(":", 1)
            if args.master is not None and \
                    args.master.rsplit(":", 1)[1] == port:
                raise SystemExit(
                    f"--elastic_store {args.elastic_store!r} and --master "
                    f"{args.master!r} share a port: the elastic store and "
                    "the rendezvous store are two servers")
            store = TCPKVStore(host, int(port), is_master=True)
        else:
            from ..elastic import FileKVStore
            store = FileKVStore(args.elastic_store)
    attempt = 0            # spawn generation (PADDLE_RESTART_COUNT)
    restarts = 0           # failure relaunches (gated by --max_restarts)
    cur_np = args.nproc_per_node
    procs = _spawn(args, attempt)
    code = 0

    def _on_term(*_):
        _kill_all(procs)
        sys.exit(143)

    signal.signal(signal.SIGTERM, _on_term)
    try:
        while procs:
            if store is not None:
                joins = store.get_prefix("join/")
                if joins and cur_np >= hi:
                    # at MAX already: consume the announcements, or they
                    # would fire a scale-out after a later scale-in
                    for key in joins:
                        store.delete(key)
                    print(f"[launch] ignoring {len(joins)} join(s): "
                          f"already at max world size {hi}",
                          file=sys.stderr)
                elif joins:
                    new_np = min(hi, cur_np + len(joins))
                    print(f"[launch] scaling {cur_np} -> {new_np} "
                          "workers (join)", file=sys.stderr)
                    _kill_all(procs)
                    for key in joins:
                        store.delete(key)
                    attempt += 1
                    cur_np = new_np
                    procs = _spawn(args, attempt, nprocs=cur_np)
                    continue
            alive, failed = [], None
            for rank, p in procs:
                ret = p.poll()
                if ret is None:
                    alive.append((rank, p))
                elif ret != 0:
                    failed = (rank, ret)
                    break
            if failed is not None:
                rank, ret = failed
                n_alive = sum(1 for _, p in procs if p.poll() is None)
                _kill_all(procs)
                if restarts < args.max_restarts:
                    restarts += 1
                    attempt += 1
                    next_np = cur_np
                    if args.np_range:
                        # scale-in: continue at the surviving count
                        next_np = max(lo, min(hi, n_alive))
                        if next_np != cur_np:
                            print(f"[launch] scaling {cur_np} -> "
                                  f"{next_np} workers", file=sys.stderr)
                    print(f"[launch] worker {rank} exited with {ret}; "
                          f"relaunching job (attempt {restarts}/"
                          f"{args.max_restarts})", file=sys.stderr)
                    cur_np = next_np
                    procs = _spawn(args, attempt, nprocs=cur_np)
                    continue
                print(f"[launch] worker {rank} exited with {ret}; "
                      "terminating job", file=sys.stderr)
                code = ret if ret > 0 else 128 - ret
                procs = []
                break
            procs = alive
            time.sleep(0.1)
    except KeyboardInterrupt:
        _kill_all(procs)
        code = 130
    sys.exit(code)


if __name__ == "__main__":
    main()
