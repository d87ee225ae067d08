"""The pipeline schedules (``parallel/pp_schedule.py`` and the lockstep
grids of ``parallel/pipeline_1f1b.py``) against the reference's, and their
executors against torch autograd of the unpipelined chain.

The schedule makers are pure Python on both sides: every maker's cells, its
``simulate`` makespan and bubble and its ``peak_activations`` must be the
reference's for (n, m, v) in {(2,4,1), (4,8,1), (2,4,2), (4,8,2)}.
``run_schedule`` (every stage in one process) and ``run_stage`` (one stage a
rank; here each stage in a thread of this process, the hops through an
in-process mailbox) must give the unpipelined chain's outputs and
gradients (rtol 1e-5, and atol 1e-5 of each tensor's largest value: the
schedules sum the microbatches' gradients in other orders; f32).
"""
import queue
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.parallel import pipeline_1f1b as RP1
from paddle_tpu.parallel import pp_schedule as RS
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.parallel import pipeline_1f1b as P1
from paddle_tpu_torch.parallel import pp_schedule as PS
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

GEOMETRIES = [(2, 4, 1), (4, 8, 1), (2, 4, 2), (4, 8, 2)]


def _makers(n, m, v):
    """(name, port's Schedule, reference's Schedule) of every maker that
    takes this geometry."""
    out = []
    if v == 1:
        for name in ("schedule_fthenb", "schedule_1f1b", "schedule_zbh1",
                     "schedule_zbvpp"):
            out.append((name, getattr(PS, name)(n, m),
                        getattr(RS, name)(n, m)))
        for name in ("compiled_1f1b_schedule", "compiled_zbh1_schedule",
                     "compiled_zbvpp_schedule"):
            out.append((name, getattr(P1, name)(n, m),
                        getattr(RP1, name)(n, m)))
    else:
        out.append(("schedule_interleaved", PS.schedule_interleaved(n, m, v),
                    RS.schedule_interleaved(n, m, v)))
        out.append(("compiled_interleaved_schedule",
                    P1.compiled_interleaved_schedule(n, m, v),
                    RP1.compiled_interleaved_schedule(n, m, v)))
    return out


def _cells(sched):
    return [[tuple(op) for op in ops] for ops in sched.per_stage]


@pytest.mark.parametrize("n,m,v", GEOMETRIES)
def test_schedules_match_reference(n, m, v):
    """Cells, makespan and bubble, peak activations, chunk directions and
    the durations of every schedule maker equal the reference's."""
    for name, got, want in _makers(n, m, v):
        assert got.name == want.name, name
        assert _cells(got) == _cells(want), name
        assert got.chunk_dirs == want.chunk_dirs, name
        assert got.durations == want.durations, name
        assert got.simulate() == want.simulate(), name
        assert got.peak_activations() == want.peak_activations(), name
        for s in range(n):
            for c in range(got.n_chunks):
                assert got.virtual_index(s, c) == want.virtual_index(s, c)


@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (3, 5)])
def test_drain_ticks_match_reference(n, m):
    """The zero-bubble W drain ticks past the lockstep grid."""
    assert P1.zbh1_extra_ticks(n, m) == RP1.zbh1_extra_ticks(n, m)
    assert P1.zbvpp_extra_ticks(n, m) == RP1.zbvpp_extra_ticks(n, m)


def test_interleaved_refuses_uneven_microbatches():
    with pytest.raises(ValueError, match="microbatches % stages"):
        PS.schedule_interleaved(4, 6, 2)
    with pytest.raises(ValueError, match="microbatches % stages"):
        RS.schedule_interleaved(4, 6, 2)


def test_deadlock_is_reported():
    """simulate refuses an order whose cells wait on each other."""
    bad = PS.Schedule("bad", 2, 1, [[PS.PipeOp("B", 0, 0)],
                                    [PS.PipeOp("F", 1, 0),
                                     PS.PipeOp("B", 1, 0)]])
    with pytest.raises(RuntimeError, match="deadlocked"):
        bad.simulate()


# ---------------------------------------------------------------- executors
H = 6


def _chain(nv, seed=0):
    """nv virtual stages of y = tanh(x W + b) + x, f32."""
    rng = np.random.RandomState(seed)
    return [{"w": torch.tensor(rng.randn(H, H) * 0.5, dtype=torch.float32),
             "b": torch.tensor(rng.randn(H) * 0.1, dtype=torch.float32)}
            for _ in range(nv)]


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"]) + x


def _close(got, want, what=""):
    want = want.numpy()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def _reference_grads(params, xs, targets):
    """Outputs, loss, input and parameter gradients of the unpipelined
    chain (loss = sum over microbatches of 0.5 |y - t|^2)."""
    leaves = [p[k].clone().requires_grad_(True) for p in params
              for k in ("b", "w")]
    x = xs.clone().requires_grad_(True)
    y = x
    for i in range(len(params)):
        y = _stage({"b": leaves[2 * i], "w": leaves[2 * i + 1]}, y)
    loss = 0.5 * ((y - targets) ** 2).sum()
    g = torch.autograd.grad(loss, [x] + leaves)
    return y.detach(), float(loss.detach()), g[0], g[1:]


def _schedules(n, m):
    return [PS.schedule_fthenb(n, m), PS.schedule_1f1b(n, m),
            PS.schedule_zbh1(n, m), PS.schedule_interleaved(n, m, 2),
            PS.schedule_zbvpp(n, m)]


@pytest.mark.parametrize("n,m", [(2, 4), (4, 8)])
def test_run_schedule_matches_autograd(n, m):
    """run_schedule over torch autograd (B the input gradient, W the
    deferred weight gradient on the zero-bubble schedules): the outputs,
    the stage-0 input gradients and every weight gradient equal autograd
    of the unpipelined chain."""
    rng = np.random.RandomState(1)
    xs = torch.tensor(rng.randn(m, 3, H), dtype=torch.float32)
    tg = torch.tensor(rng.randn(m, 3, H), dtype=torch.float32)
    for sched in _schedules(n, m):
        nv = n * sched.n_chunks
        params = _chain(nv)
        want_y, _, want_dx, want_g = _reference_grads(params, xs, tg)
        grads = [{"b": torch.zeros(H), "w": torch.zeros(H, H)}
                 for _ in range(nv)]
        dx0 = {}

        def vi(stage, chunk):
            return sched.virtual_index(stage, chunk)

        def forward(stage, chunk, x):
            with torch.no_grad():
                return _stage(params[vi(stage, chunk)], x), {"x": x}

        def graph(stage, chunk, ctx):
            p = {k: t.clone().requires_grad_(True)
                 for k, t in params[vi(stage, chunk)].items()}
            xg = ctx["x"].clone().requires_grad_(True)
            return _stage(p, xg), xg, p

        def backward(stage, chunk, ctx, gy):
            y, xg, p = graph(stage, chunk, ctx)
            if sched._has_w():
                (gx,) = torch.autograd.grad(y, [xg], gy, retain_graph=True)
                ctx["graph"] = (y, p)
            else:
                gx, gb, gw = torch.autograd.grad(y, [xg, p["b"], p["w"]], gy)
                grads[vi(stage, chunk)]["b"] += gb
                grads[vi(stage, chunk)]["w"] += gw
            if vi(stage, chunk) == 0:
                dx0[id(ctx["x"])] = gx
            return gx

        def weight_grad(stage, chunk, ctx, gy):
            y, p = ctx.pop("graph")
            gb, gw = torch.autograd.grad(y, [p["b"], p["w"]], gy)
            grads[vi(stage, chunk)]["b"] += gb
            grads[vi(stage, chunk)]["w"] += gw

        mbs = list(xs.unbind(0))
        outs = PS.run_schedule(sched, forward, backward,
                               weight_grad if sched._has_w() else None, mbs,
                               lambda mb, y: y - tg[mb])
        _close(torch.stack(outs), want_y, sched.name)
        _close(torch.stack([dx0[id(x)] for x in mbs]), want_dx, sched.name)
        got_g = [g[k] for g in grads for k in ("b", "w")]
        for a, b in zip(got_g, want_g):
            _close(a, b, sched.name)


def test_run_schedule_refuses_mismatched_weight_grads():
    """A weight_grad callback on a schedule without W cells, or none on a
    zero-bubble one, raises: the reference's refusals."""
    def f(*a):
        raise AssertionError("not reached")
    for mod in (PS, RS):
        with pytest.raises(ValueError, match="has no W cells"):
            mod.run_schedule(mod.schedule_1f1b(2, 2), f, f, f, [0, 0],
                             [0, 0])
        with pytest.raises(ValueError, match="contains W cells"):
            mod.run_schedule(mod.schedule_zbh1(2, 2), f, f, None, [0, 0],
                             [0, 0])


@pytest.mark.parametrize("builder,dims", [
    ("schedule_1f1b", (2, 4)), ("schedule_zbh1", (2, 4)),
    ("schedule_interleaved", (2, 4, 2)), ("schedule_zbvpp", (2, 4))])
def test_gpt_schedule_value_and_grad_matches_unpipelined(builder, dims):
    """gpt_hybrid's ``schedule_value_and_grad`` (its pipeline stage, head
    seed and embedding backward, every stage in this process through
    ``run_all_stages``) gives the unpipelined step's loss and gradients:
    the tiny GPT (vocab 64, h32, 4 layers, 4 heads, S16, B8, f32, remat
    "names", so that the zero-bubble B takes the stage without its
    checkpoints); rtol 1e-5, and atol 1e-5 of each leaf's largest value."""
    from paddle_tpu_torch.models import gpt_hybrid as TH
    cfg = TH.GPTConfig(vocab_size=64, hidden_size=32, num_layers=4,
                       num_heads=4, max_seq_len=16)
    pcfg = TH.ParallelConfig(remat=True, remat_policy="names",
                             compute_dtype=torch.float32)
    params = TH.init_params(cfg, pcfg, torch.Generator().manual_seed(0),
                            "cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (8, 16)))
    want_loss, want = TH._value_and_grad(params, (ids, ids), cfg, pcfg)
    loss, got = TH.schedule_value_and_grad(params, (ids, ids), cfg, pcfg,
                                           getattr(PS, builder)(*dims))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert len(got) == len(want)
    for name, g, w in zip(TH._leaf_names(params), got, want):
        _close(g.float(), w.float(), name)


class _Group:
    def __init__(self, rank, n):
        self.rank, self.nranks, self.ranks = rank, n, list(range(n))


def _mailbox_exchange():
    """p2p_exchange between threads: a queue per (sender, receiver, tag)."""
    boxes, lock = {}, threading.Lock()

    def box(key):
        with lock:
            return boxes.setdefault(key, queue.Queue())

    def exchange(sends, recvs, group):
        for t, peer, tag in sends:
            box((group.rank, peer, tag)).put(t.clone())
        return [box((peer, group.rank, tag)).get(timeout=30)
                for _, _, _, peer, tag in recvs]
    return exchange


@pytest.mark.parametrize("kind,n,m", [("1f1b", 2, 4), ("1f1b", 4, 8),
                                      ("vpp", 2, 4), ("vpp", 4, 8),
                                      ("zbh1", 2, 4), ("zbh1", 4, 8),
                                      ("zbvpp", 2, 4), ("zbvpp", 4, 8)])
def test_run_stage_matches_autograd(monkeypatch, kind, n, m):
    """run_stage, one stage a thread and the hops through a mailbox, walks
    each stage's list of the lockstep grid (``compiled_*_schedule``):
    the head's loss, the stage-0 input cotangents and every stage's
    gradients equal autograd of the unpipelined chain."""
    monkeypatch.setattr(C, "p2p_exchange", _mailbox_exchange())
    sched = {"1f1b": lambda: P1.compiled_1f1b_schedule(n, m),
             "vpp": lambda: P1.compiled_interleaved_schedule(n, m, 2),
             "zbh1": lambda: P1.compiled_zbh1_schedule(n, m),
             "zbvpp": lambda: P1.compiled_zbvpp_schedule(n, m)}[kind]()
    v = sched.n_chunks
    params = _chain(n * v)
    rng = np.random.RandomState(2)
    xs = torch.tensor(rng.randn(m, 3, H), dtype=torch.float32)
    tg = torch.tensor(rng.randn(m, 3, H), dtype=torch.float32)
    want_y, want_loss, want_dx, want_g = _reference_grads(params, xs, tg)

    def last_grad(y, hp, mb):
        return (0.5 * ((y - tg[mb]) ** 2).sum(), y - tg[mb], None)

    results = {}

    def stage(s):
        chunks = [params[sched.virtual_index(s, c)] for c in range(v)]
        results[s] = P1.run_stage(sched, _Group(s, n), _stage, chunks, xs,
                                  last_grad)
    threads = [threading.Thread(target=stage, args=(s,)) for s in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert len(results) == n
    head = sched._chain_list[-1][0]
    loss = results[head][0]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    first = sched._chain_list[0][0]
    _close(results[first][3], want_dx)
    for s in range(n):
        for c in range(v):
            vi = sched.virtual_index(s, c)
            g = results[s][1][c]
            _close(g["b"], want_g[2 * vi], f"{kind} stage {s} chunk {c}")
            _close(g["w"], want_g[2 * vi + 1], f"{kind} stage {s} chunk {c}")


# ------------------------------------------------------------ GPipe
# tests/test_parallel_primitives.py's two pipeline tests, restated: the
# port's pipeline_apply (each stage in a thread of this process, its hops
# and the final psum through in-process stand-ins for the collectives)
# against the sequential chain, as the reference's hold its own.
def _threaded_collectives(monkeypatch, n):
    boxes, lock = {}, threading.Lock()
    barrier = threading.Barrier(n)
    sums = {}

    def box(key):
        with lock:
            return boxes.setdefault(key, queue.Queue())

    def permute(x, group, perm):
        out = torch.zeros_like(x)
        for i, j in perm:
            if i == group.rank:
                box((i, j)).put(x.detach().clone())
        for i, j in perm:
            if j == group.rank:
                out = box((i, j)).get(timeout=30)
        return out

    def sum_over(x, group, op=None):
        with lock:
            sums[group.rank] = x.detach().clone()
        barrier.wait(30)
        total = sum(sums[r] for r in range(n))
        barrier.wait(30)
        return total

    monkeypatch.setattr(C, "_permute", permute)
    monkeypatch.setattr(C, "_sum_over", sum_over)


def _run_ranks(n, fn):
    res = {}
    errs = []

    def one(r):
        try:
            res[r] = fn(r)
        except BaseException as e:      # surfaced below
            errs.append(e)
    threads = [threading.Thread(target=one, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if errs:
        raise errs[0]
    return res


def _gpipe(monkeypatch, stage_ws, x, grads):
    """Each rank's pipeline_apply output (and its stage weight's and the
    input's gradients of sum(out^2))."""
    from paddle_tpu_torch.parallel import pipeline as PP
    n = len(stage_ws)
    _threaded_collectives(monkeypatch, n)

    def rank(r):
        w = torch.tensor(stage_ws[r], requires_grad=True)
        xt = torch.tensor(x, requires_grad=True)
        out = PP.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]),
                                {"w": w}, xt, _Group(r, n))
        if not grads:
            return out.detach()
        gw, gx = torch.autograd.grad((out ** 2).sum(), [w, xt])
        return out.detach(), gw, gx
    return _run_ranks(n, rank)


def test_pipeline_apply_matches_sequential(monkeypatch):
    """4 stages, 8 microbatches: every rank's outputs are the sequential
    chain's (rtol and atol 1e-5, as the reference's test)."""
    rng = np.random.RandomState(0)
    stage_ws = [(rng.randn(8, 8) * 0.3).astype(np.float32)
                for _ in range(4)]
    x = rng.randn(8, 4, 8).astype(np.float32)
    got = _gpipe(monkeypatch, stage_ws, x, grads=False)
    ref = x
    for w in stage_ws:
        ref = np.tanh(ref @ w)
    for r in range(4):
        np.testing.assert_allclose(got[r].numpy(), ref, rtol=1e-5,
                                   atol=1e-5)


def test_pipeline_grad_flows(monkeypatch):
    """2 stages: each rank's stage-weight gradient of sum(out^2) is the
    sequential chain's (rtol 1e-4, atol 1e-5, as the reference's test),
    and the input gradients summed over the ranks are too."""
    rng = np.random.RandomState(0)
    stage_ws = [(rng.randn(4, 4) * 0.3).astype(np.float32)
                for _ in range(2)]
    x = rng.randn(4, 2, 4).astype(np.float32)
    got = _gpipe(monkeypatch, stage_ws, x, grads=True)
    ws = [torch.tensor(w, requires_grad=True) for w in stage_ws]
    xt = torch.tensor(x, requires_grad=True)
    y = xt
    for w in ws:
        y = torch.tanh(y @ w)
    want = torch.autograd.grad((y ** 2).sum(), ws + [xt])
    for r in range(2):
        np.testing.assert_allclose(got[r][1].numpy(), want[r].numpy(),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sum(got[r][2] for r in range(2)).numpy(),
                               want[2].numpy(), rtol=1e-4, atol=1e-5)


def test_stack_stage_params_stacks_like_reference():
    from paddle_tpu.parallel import stack_stage_params as ref_stack
    from paddle_tpu_torch.parallel import stack_stage_params
    rng = np.random.RandomState(0)
    trees = [{"w": rng.randn(2, 3).astype(np.float32),
              "b": {"c": rng.randn(3).astype(np.float32)}}
             for _ in range(3)]
    got = stack_stage_params([{"w": torch.tensor(t["w"]),
                               "b": {"c": torch.tensor(t["b"]["c"])}}
                              for t in trees])
    want = ref_stack(trees)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))
