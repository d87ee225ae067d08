"""The training-robustness slice on the CPU: ``hapi.Model.fit``, the step
guard, the train checkpoints, ``distributed.checkpoint``, ``device``,
``metric`` and ``observability.training`` of the port, against the
reference's on the same inputs.

- ``Model.fit`` on the tiny Layer GPT (``GPTConfig.tiny()``, parameters
  carried from the reference's ``state_dict()``), the same numpy token
  data, ``AdamW``, ``FaultTolerantCheckpoint(every_n_steps=2)`` and
  ``StepGuard(check_grads=True)``, with one injected non-finite step, runs
  6 steps on both sides: the skipped step and its counters agree, and the
  losses and final parameters agree at the Layer GPT's f32 tolerance of
  ``test_torch_gpt_layer.py`` (1e-5 relative on the losses; each
  parameter within 1e-5 of its scale per three AdamW updates, except
  elements where the two gradients differed in sign or were under 100 eps
  at some step, which are held to Adam's largest step, ~lr a step on each
  side).
- The port resumes from a checkpoint the reference wrote (model, AdamW
  moments, loader position, step): one more step then equals the
  reference's one more step at the same tolerance.
- The port alone: 8 steps straight equal 4 steps, a SIGTERM through
  ``PreemptionHandler``, and 4 more from a fresh Model, optimizer and
  DataLoader, bit for bit, with dropout 0.1 (the generator's state) and an
  LR schedule.

Restated here from the reference's tests: ``test_train_robustness.py``'s
``test_step_guard_checks_grads_when_asked`` and
``test_step_guard_is_amp_scaler_aware`` (they poison a gradient through
``jax.numpy``), and ``test_checkpoint_profiler.py``'s
``test_async_checkpoint``, ``test_commit_marker_orders_the_save`` and
``test_latest_committed_skips_in_progress_saves`` (that file imports jax
at the top).
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest keeps it on the CPU)

import paddle_tpu as P
import paddle_tpu.observability as pobs
from paddle_tpu import hapi as phapi
from paddle_tpu import training as ptraining
from paddle_tpu.models.gpt import GPTConfig as JaxGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JaxGPT
import paddle_tpu_torch as T
import paddle_tpu_torch.observability as obs
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import training as ttraining
from paddle_tpu_torch.distributed import checkpoint as dc
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch._testing import share_the_cores_fixture

_share_the_cores = share_the_cores_fixture()

EPS = 1e-8     # AdamW's default epsilon
LR = 1e-3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    T.set_device("cpu")
    T.seed(2024)
    obs.enable()
    obs.REGISTRY.reset()
    pobs.enable()
    pobs.REGISTRY.reset()
    yield


# ---------------------------------------------------------------- helpers
class _Tokens:
    """n sequences of seeded token ids, each item (ids, ids)."""

    def __init__(self, n=12, s=32, vocab=256, seed=0):
        self.ids = np.random.RandomState(seed).randint(
            0, vocab, (n, s)).astype("int64")

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.ids[i]


def _dataset(pkg, **kw):
    base = _Tokens(**kw)

    class DS(pkg.io.Dataset):
        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            return base[i]
    return DS()


def _lm_loss(pkg, nan_at=None):
    """Next-token cross-entropy of (logits, labels); the call numbered
    ``nan_at`` (1-based) returns NaN: a poisoned batch."""
    calls = [0]

    def loss(logits, labels):
        calls[0] += 1
        v = logits.shape[-1]
        out = pkg.nn.functional.cross_entropy(
            logits[:, :-1].reshape([-1, v]), labels[:, 1:].reshape([-1]))
        return out * float("nan") if calls[0] == nan_at else out
    return loss


def _record_grads(opt, into):
    """Wraps opt.step to keep each parameter's gradient of the step."""
    step = opt.step

    def wrapped():
        into.append([None if p.grad is None else p.grad.numpy().copy()
                     for p in opt._parameter_list])
        return step()
    opt.step = wrapped


def _pair(seed=0, dropout=0.0):
    P.seed(seed)
    cfg = JaxGPTConfig.tiny()
    cfg.dropout = dropout
    ref = JaxGPT(cfg)
    tcfg = GPTConfig.tiny()
    tcfg.dropout = dropout
    port = GPTForCausalLM(tcfg)
    missing, unexpected = port.set_state_dict(
        {k: v.numpy() for k, v in ref.state_dict().items()})
    assert not missing and not unexpected
    return ref, port


def _fit_setup(pkg, hapi, training, net, root, nan_at=None):
    opt = pkg.optimizer.AdamW(learning_rate=LR, epsilon=EPS,
                              parameters=net.parameters())
    model = hapi.Model(net)
    guard = training.StepGuard(check_grads=True)
    model.prepare(opt, _lm_loss(pkg, nan_at), step_guard=guard)
    loader = pkg.io.DataLoader(_dataset(pkg), batch_size=2, shuffle=True,
                               seed=5)
    ftc = hapi.FaultTolerantCheckpoint(root, every_n_steps=2,
                                       dataloader=loader,
                                       install_signal_handler=False)
    return model, opt, guard, loader, ftc


def _assert_adam_close(got, want, shaky, steps):
    """The Layer GPT's f32 tolerance (test_torch_gpt_layer.py), which holds
    three AdamW updates to 1e-5 of the leaf's scale: 1e-5 per three
    updates here. A zero-initialised bias is the sum of its Adam steps,
    and each step carries the gradients' round-off relative to m/sqrt(v):
    5 updates put 1.2e-5 of the scale on a LayerNorm bias."""
    err = np.abs(got - want)
    scale = np.abs(want).max()
    if (~shaky).any():
        assert err[~shaky].max() <= 1e-5 * max(steps, 3) / 3 * scale
    assert err.max() <= 2 * steps * LR * 1.01


def _shaky(rgrads, tgrads, shapes):
    out = [np.zeros(s, bool) for s in shapes]
    for rs, ts in zip(rgrads, tgrads):
        for i, (g, h) in enumerate(zip(rs, ts)):
            if g is None:
                continue
            out[i] |= (np.sign(g) != np.sign(h)) | (np.abs(g) < 100 * EPS)
    return out


# ------------------------------------------------ Model.fit against the ref
def test_fit_matches_the_reference_with_a_skipped_step(tmp_path):
    ref, port = _pair()
    rmodel, ropt, rguard, rloader, rftc = _fit_setup(
        P, phapi, ptraining, ref, str(tmp_path / "ref"), nan_at=3)
    tmodel, topt, tguard, tloader, tftc = _fit_setup(
        T, thapi, ttraining, port, str(tmp_path / "port"), nan_at=3)
    rgrads, tgrads = [], []
    _record_grads(ropt, rgrads)
    _record_grads(topt, tgrads)
    rhist = rmodel.fit(rloader, epochs=1, verbose=0, callbacks=[rftc])
    thist = tmodel.fit(tloader, epochs=1, verbose=0, callbacks=[tftc])

    rl, tl = np.array(rhist["loss"]), np.array(thist["loss"])
    assert len(rl) == len(tl) == 6
    assert np.isnan(rl[2]) and np.isnan(tl[2])
    finite = ~np.isnan(rl)
    np.testing.assert_allclose(tl[finite], rl[finite], rtol=1e-5)
    # the skipped step: counted alike, no update, the run went on
    assert (tguard.nan_steps, tguard.skipped_steps) == \
        (rguard.nan_steps, rguard.skipped_steps) == (1, 1)
    assert obs.counter("train.nan_steps").value == 1
    assert obs.counter("train.skipped_steps").value == 1
    assert len(tgrads) == len(rgrads) == 5
    assert topt._global_step == ropt._global_step == 5
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref")) == \
        ["step_00000002", "step_00000004", "step_00000006"]

    rp, tp = ref.parameters(), port.parameters()
    shaky = _shaky(rgrads, tgrads, [p.shape for p in rp])
    for r, t, s in zip(rp, tp, shaky):
        _assert_adam_close(t.numpy(), r.numpy(), s, steps=5)


def test_the_port_resumes_from_the_references_checkpoint(tmp_path):
    ref, port = _pair()
    rmodel, ropt, _, rloader, rftc = _fit_setup(
        P, phapi, ptraining, ref, str(tmp_path / "ref"))
    rgrads = []
    _record_grads(ropt, rgrads)
    rmodel.fit(rloader, epochs=1, verbose=0, callbacks=[rftc], num_iters=4)
    assert dc.latest_committed(str(tmp_path / "ref")).endswith(
        "step_00000004")

    # a fresh port model (other weights), optimizer and loader
    T.seed(99)
    fresh = GPTForCausalLM(GPTConfig.tiny())
    tmodel, topt, _, tloader, _ = _fit_setup(
        T, thapi, ttraining, fresh, str(tmp_path / "unused"))
    meta = ttraining.load_train_checkpoint(str(tmp_path / "ref"), fresh,
                                           topt, tloader)
    assert meta["step"] == 4 and meta["loader"]["batches_served"] == 4
    assert tloader.state_dict() == rloader.state_dict()
    assert topt._global_step == ropt._global_step == 4
    for (k, r), t in zip(ref.state_dict().items(),
                         fresh.state_dict().values()):
        np.testing.assert_array_equal(t.numpy(), r.numpy(), k)
    rsd, tsd = ropt.state_dict(), topt.state_dict()
    for k, v in rsd.items():
        if hasattr(v, "numpy"):
            np.testing.assert_array_equal(tsd[k].numpy(), v.numpy(), k)

    # one more step on each side: the port's resumed loader gives batch 4
    # of the reference's order
    tgrads = []
    _record_grads(topt, tgrads)
    tbatch = next(iter(tloader))
    want = list(P.io.DataLoader(_dataset(P), batch_size=2, shuffle=True,
                                seed=5))[4]
    np.testing.assert_array_equal(tbatch[0].numpy(), want[0].numpy())
    rbatch = [P.to_tensor(b.numpy()) for b in tbatch]
    rloss = rmodel.train_batch([rbatch[0]], [rbatch[1]])[0]
    tloss = tmodel.train_batch([tbatch[0]], [tbatch[1]])[0]
    assert abs(tloss - rloss) <= 1e-5 * abs(rloss)
    shaky = _shaky(rgrads[-1:], tgrads, [p.shape for p in ref.parameters()])
    for r, t, s in zip(ref.parameters(), fresh.parameters(), shaky):
        _assert_adam_close(t.numpy(), r.numpy(), s, steps=1)


class _Sigterm(thapi.Callback):
    def __init__(self, at_step):
        self.at_step = at_step

    def on_train_batch_end(self, step, logs=None):
        if step == self.at_step:
            os.kill(os.getpid(), signal.SIGTERM)


def _bitwise_run(root, stop_at=None):
    """The tiny GPT with dropout 0.1 under a step-decayed LR: a fresh
    model, optimizer and loader; fit for one epoch of 8 batches with a
    FaultTolerantCheckpoint under ``root`` (a SIGTERM after batch
    ``stop_at`` when given)."""
    T.seed(11)
    cfg = GPTConfig.tiny()
    cfg.dropout = 0.1
    net = GPTForCausalLM(cfg)
    sched = T.optimizer.lr.StepDecay(2e-3, step_size=3, gamma=0.5)
    opt = T.optimizer.AdamW(sched, parameters=net.parameters())
    model = thapi.Model(net)
    model.prepare(opt, _lm_loss(T))
    loader = T.io.DataLoader(_dataset(T, n=16), batch_size=2,
                             shuffle=True, seed=3)
    cbs = [thapi.LRScheduler(by_step=True)]
    if stop_at is not None:
        cbs.insert(0, _Sigterm(stop_at))
    ftc = thapi.FaultTolerantCheckpoint(root, every_n_steps=0,
                                        dataloader=loader)
    hist = model.fit(loader, epochs=1, verbose=0, callbacks=cbs + [ftc])
    return hist["loss"], net, opt, ftc


def test_bitwise_resume_after_sigterm_with_dropout_and_a_schedule(tmp_path):
    straight, snet, sopt, _ = _bitwise_run(str(tmp_path / "a"))
    assert len(straight) == 8
    first, _, _, ftc = _bitwise_run(str(tmp_path / "b"), stop_at=3)
    assert ftc.preempted and len(first) == 4
    assert dc.latest_committed(str(tmp_path / "b")).endswith("step_00000004")
    second, rnet, ropt, ftc2 = _bitwise_run(str(tmp_path / "b"))
    assert ftc2.resumed_from.endswith("step_00000004") and len(second) == 4
    assert np.array(first + second).tobytes() == \
        np.array(straight).tobytes()
    for (k, a), b in zip(snet.state_dict().items(),
                         rnet.state_dict().values()):
        assert a.numpy().tobytes() == b.numpy().tobytes(), k
    ssd, rsd = sopt.state_dict(), ropt.state_dict()
    assert ssd["LR_Scheduler"] == rsd["LR_Scheduler"]
    for k, v in ssd.items():
        if hasattr(v, "numpy"):
            assert v.numpy().tobytes() == rsd[k].numpy().tobytes(), k


def test_train_checkpoint_carries_the_generators_device_states(tmp_path):
    T.seed(4)
    net = T.nn.Linear(4, 2)
    T.rand([3])                      # draw: the CPU generator exists
    save = T.default_generator().get_state()
    path = ttraining.save_train_checkpoint(str(tmp_path), 1, net)
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)["tensors"]
    assert meta["train.rng.seed"]["value"] == 4
    assert [d for d, _ in meta["train.rng_devices"]["value"]] == ["cpu"]
    want = T.rand([5]).numpy()
    T.seed(123)
    ttraining.load_train_checkpoint(str(tmp_path), net)
    state = T.default_generator().get_state()
    assert (state["seed"], state["offset"]) == (save["seed"],
                                                save["offset"])
    np.testing.assert_array_equal(T.rand([5]).numpy(), want)


def test_resume_restores_multi_precision_master_weights(tmp_path):
    """A fresh multi_precision optimizer's resume restores the saved f32
    masters; without them its first step would rebuild them from the bf16
    parameters."""
    T.seed(1)
    net = T.nn.Linear(8, 8)
    net.bfloat16()
    opt = T.optimizer.AdamW(1e-2, parameters=net.parameters(),
                            multi_precision=True)
    x = T.randn([4, 8]).astype("bfloat16")
    for _ in range(3):
        net(x).astype("float32").mean().backward()
        opt.step()
        opt.clear_grad()
    ttraining.save_train_checkpoint(str(tmp_path), 3, net, opt)
    T.seed(1)
    net2 = T.nn.Linear(8, 8)
    net2.bfloat16()
    opt2 = T.optimizer.AdamW(1e-2, parameters=net2.parameters(),
                             multi_precision=True)
    ttraining.load_train_checkpoint(str(tmp_path), net2, opt2)
    sd, sd2 = opt.state_dict(), opt2.state_dict()
    assert "master_0" in sd2
    for k, v in sd.items():
        if hasattr(v, "numpy"):
            np.testing.assert_array_equal(sd2[k].numpy(), v.numpy(), k)
    for o, n in ((opt, net), (opt2, net2)):
        n(x).astype("float32").mean().backward()
        o.step()
    for a, b in zip(net.parameters(), net2.parameters()):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# -------------------------------------------- test_train_robustness, restated
def _mlp_model(pkg, hapi):
    pkg.seed(7)
    net = pkg.nn.Sequential(pkg.nn.Linear(4, 8), pkg.nn.Tanh(),
                            pkg.nn.Linear(8, 2))
    model = hapi.Model(net)
    model.prepare(pkg.optimizer.SGD(0.1, parameters=net.parameters()),
                  pkg.nn.MSELoss())
    return model


def test_step_guard_checks_grads_when_asked():
    """test_train_robustness.py::test_step_guard_checks_grads_when_asked,
    with the gradient poisoned by a torch array."""
    model = _mlp_model(T, thapi)
    guard = ttraining.StepGuard(max_consecutive_bad=5, check_grads=True)
    x = T.to_tensor(np.random.randn(4, 4).astype("f4"))
    y = T.to_tensor(np.zeros((4, 2), "f4"))
    model.train_batch(x, y)
    loss = T.nn.MSELoss()(model.network(x), y)
    loss.backward()
    p = model.network.parameters()[0]
    p.grad._assign_array(torch.full(p.grad._data.shape, float("inf"),
                                    dtype=p.grad._data.dtype))
    assert not guard.pre_step(loss, model._optimizer)
    assert guard.nan_steps == 1


def test_step_guard_is_amp_scaler_aware():
    """test_train_robustness.py::test_step_guard_is_amp_scaler_aware, with
    the gradient poisoned by a torch array."""
    T.seed(0)
    net = T.nn.Linear(4, 2)
    opt = T.optimizer.SGD(0.1, parameters=net.parameters())
    scaler = T.amp.GradScaler(enable=True, init_loss_scaling=8.0)
    guard = ttraining.StepGuard(max_consecutive_bad=2)
    x = T.to_tensor(np.random.randn(4, 4).astype("f4"))

    loss = net(x).mean()
    scaler.scale(loss).backward()
    p = net.parameters()[0]
    p.grad._assign_array(torch.full(p.grad._data.shape, float("inf"),
                                    dtype=p.grad._data.dtype))
    scaler.step(opt)
    assert scaler.last_step_skipped()
    assert not guard.observe_scaler(scaler)
    assert guard.skipped_steps == 1 and guard.nan_steps == 0
    assert obs.counter("train.skipped_steps").value == 1
    scaler.update()
    opt.clear_grad()

    loss = net(x).mean()
    scaler.scale(loss).backward()
    scaler.step(opt)
    assert not scaler.last_step_skipped()
    assert guard.observe_scaler(scaler)
    assert guard.consecutive_bad == 0


@pytest.mark.parametrize("bad", ["loss_nan", "grad_inf", "bf16_grad_nan",
                                 "none"])
def test_finite_check_is_the_references(bad):
    """StepGuard._finite_all over a loss and gradients of mixed dtypes
    answers as the reference's per-array jnp.isfinite."""
    rs = np.random.RandomState(0)
    arrays = [rs.randn(3).astype("f4"), rs.randn(4, 5).astype("f4"),
              rs.randn(6).astype("f4"), np.arange(3)]
    if bad == "loss_nan":
        arrays[0][1] = np.nan
    elif bad == "grad_inf":
        arrays[1][2, 3] = -np.inf
    elif bad == "bf16_grad_nan":
        arrays[2][5] = np.nan
    import jax.numpy as jnp
    want = ptraining.StepGuard._finite_all([jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(a) for a in arrays]
    ts[2] = ts[2].to(torch.bfloat16)
    assert ttraining.StepGuard._finite_all(ts) is want


# --------------------------------------- test_checkpoint_profiler, restated
def test_async_checkpoint(tmp_path):
    """test_checkpoint_profiler.py::test_async_checkpoint."""
    sd = {"a": T.to_tensor([1.0, 2.0])}
    th = dc.save_state_dict(sd, str(tmp_path / "ck2"), async_save=True)
    th.join()
    out = {"a": T.zeros([2])}
    dc.load_state_dict(out, str(tmp_path / "ck2"))
    np.testing.assert_allclose(out["a"].numpy(), [1, 2])


def test_commit_marker_orders_the_save(tmp_path):
    """test_checkpoint_profiler.py::test_commit_marker_orders_the_save."""
    ck = tmp_path / "ck"
    sd = {"a": T.to_tensor([3.0, 4.0]), "step": 5}
    dc.save_state_dict(sd, str(ck))
    assert (ck / dc.COMMIT_MARKER).exists()
    assert dc.is_committed(str(ck))
    os.remove(ck / dc.COMMIT_MARKER)
    out = {"a": T.zeros([2]), "step": 0}
    with pytest.raises(ValueError, match="not committed"):
        dc.load_state_dict(out, str(ck))
    dc.load_state_dict(out, str(ck), require_committed=False)
    np.testing.assert_allclose(out["a"].numpy(), [3, 4])
    dc.save_state_dict(sd, str(ck))
    os.remove(ck / "shard_0.npz")
    assert not dc.is_committed(str(ck))
    with pytest.raises(ValueError, match="partial"):
        dc.load_state_dict(out, str(ck))


def test_latest_committed_skips_in_progress_saves(tmp_path):
    """test_checkpoint_profiler.py::
    test_latest_committed_skips_in_progress_saves."""
    root = tmp_path / "ckpts"
    root.mkdir()
    assert dc.latest_committed(str(root)) is None
    for step in (0, 1, 2):
        dc.save_state_dict({"a": T.to_tensor([float(step)]), "step": step},
                           str(root / f"step_{step:04d}"))
    dc.save_state_dict({"a": T.to_tensor([3.0]), "step": 3},
                       str(root / "step_0003"))
    os.remove(root / "step_0003" / dc.COMMIT_MARKER)
    latest = dc.latest_committed(str(root))
    assert latest is not None and latest.endswith("step_0002"), latest
    out = {"a": T.zeros([1]), "step": -1}
    dc.load_state_dict(out, latest)
    assert out["step"] == 2
    dc.save_state_dict({"a": T.to_tensor([9.0])}, str(root))
    assert dc.latest_committed(str(root)) == str(root)


# ------------------------------------------------ the checkpoint's own rules
def test_async_save_snapshots_before_the_next_step(tmp_path):
    """The optimizers write in place: async_save copies every tensor before
    it returns, so a step taken while the thread writes does not reach the
    checkpoint."""
    T.seed(3)
    net = T.nn.Linear(16, 16)
    opt = T.optimizer.AdamW(1e-1, parameters=net.parameters())
    x = T.randn([4, 16])
    net(x).mean().backward()
    opt.step()
    opt.clear_grad()
    state = {"model": net.state_dict(), "opt": opt.state_dict()}
    before = {k: v.numpy().copy() for k, v in dc._flat(state).items()
              if hasattr(v, "numpy")}
    import threading
    gate = threading.Event()
    real = np.savez

    def slow_savez(*a, **kw):          # the write waits for the step
        gate.wait(10)
        return real(*a, **kw)
    dc.np.savez = slow_savez
    try:
        th = dc.save_state_dict(state, str(tmp_path), async_save=True)
        net(x).mean().backward()
        opt.step()                     # in place, while the save waits
        gate.set()
        th.join()
    finally:
        dc.np.savez = real
    T.seed(3)
    net2 = T.nn.Linear(16, 16)
    opt2 = T.optimizer.AdamW(1e-1, parameters=net2.parameters())
    opt2._create_accumulators()
    out = {"model": net2.state_dict(), "opt": opt2.state_dict()}
    dc.load_state_dict(out, str(tmp_path))
    for k, v in dc._flat(out).items():
        if hasattr(v, "numpy"):
            np.testing.assert_array_equal(v.numpy(), before[k], k)
    assert any(not np.array_equal(p.numpy(), before[f"model.{k}"])
               for k, p in net.state_dict().items())


def test_bfloat16_is_stored_as_its_bits(tmp_path):
    bits = np.array([0x3F80, 0xC000, 0x7FC0, 0x0001], np.uint16)
    t = T.Tensor._wrap(torch.from_numpy(bits.view(np.int16)).view(
        torch.bfloat16))
    dc.save_state_dict({"w": t, "f": T.to_tensor([1.5])}, str(tmp_path))
    with open(tmp_path / "metadata.json") as f:
        meta = json.load(f)["tensors"]
    assert meta["w"]["dtype"] == "bfloat16" and meta["f"]["dtype"] == \
        "float32"
    with np.load(tmp_path / "shard_0.npz") as z:
        np.testing.assert_array_equal(z["w.full"], bits)
    out = {"w": T.zeros([4], "bfloat16"), "f": T.zeros([1])}
    dc.load_state_dict(out, str(tmp_path))
    got = out["w"]._data.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, bits)
    assert out["w"]._data.dtype == torch.bfloat16


def test_load_fills_the_live_tensors_in_place(tmp_path):
    net = T.nn.Linear(3, 2)
    dc.save_state_dict({"m": net.state_dict()}, str(tmp_path))
    T.seed(8)
    net2 = T.nn.Linear(3, 2)
    arrays = [p._data for p in net2.parameters()]
    dc.load_state_dict({"m": net2.state_dict()}, str(tmp_path))
    assert all(p._data is a and a.is_leaf and a.requires_grad
               for p, a in zip(net2.parameters(), arrays))
    for a, b in zip(net.parameters(), net2.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_the_references_checkpoint_loads_and_a_sharded_entry_is_refused(
        tmp_path):
    from paddle_tpu.distributed import checkpoint as pdc
    ref = {"a": P.to_tensor(np.arange(6, dtype="f4").reshape(2, 3)),
           "b": P.to_tensor([1.0, 2.0]).astype("bfloat16"), "step": 3}
    pdc.save_state_dict(ref, str(tmp_path))
    out = {"a": T.zeros([2, 3]), "b": T.zeros([2], "bfloat16"), "step": 0}
    dc.load_state_dict(out, str(tmp_path))
    np.testing.assert_array_equal(out["a"].numpy(), ref["a"].numpy())
    np.testing.assert_array_equal(out["b"].numpy(), [1.0, 2.0])
    assert out["step"] == 3
    with open(tmp_path / "metadata.json") as f:
        meta = json.load(f)
    # the reference's sharded layout: an entry holding the whole tensor as
    # one block loads; blocks that leave part of the target uncovered are
    # refused
    meta["tensors"]["a"]["entries"][0]["index"] = [[0, 2], [0, 3]]
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump(meta, f)
    out["a"] = T.zeros([2, 3])
    dc.load_state_dict(out, str(tmp_path))
    np.testing.assert_array_equal(out["a"].numpy(), ref["a"].numpy())
    meta["tensors"]["a"]["shape"] = [4, 3]
    with open(tmp_path / "metadata.json", "w") as f:
        json.dump(meta, f)
    out["a"] = T.zeros([4, 3])
    with pytest.raises(ValueError, match="cover 6 of the 12"):
        dc.load_state_dict(out, str(tmp_path))


# ----------------------------------------------------- device, flags, obs
def test_the_robustness_flags_are_the_references():
    from paddle_tpu.core import flags as pflags
    from paddle_tpu_torch.core import flags as tflags
    for name in ("FLAGS_max_bad_steps", "FLAGS_step_timeout_s",
                 "FLAGS_watchdog_interval_s", "FLAGS_watchdog_store_root",
                 "FLAGS_memory_stats_dump_path",
                 "FLAGS_collective_timeout_s"):
        assert tflags.get_flag(name) == pflags.get_flag(name), name


def test_device_memory_stats_and_their_dump(tmp_path):
    path = tmp_path / "mem.json"
    T.set_flags({"FLAGS_memory_stats_dump_path": str(path)})
    try:
        stats = tdevice.dump_memory_stats()
    finally:
        T.set_flags({"FLAGS_memory_stats_dump_path": ""})
    with open(path) as f:
        assert json.load(f) == stats
    assert set(stats) == set(P.device.dump_memory_stats())
    if not torch.cuda.is_available():
        assert stats["bytes_in_use"] == 0 and stats["raw"] == {}
        assert tdevice.get_available_device() == []
        assert tdevice.device_count() == 0
    assert tdevice.device_count("cpu") == 1
    assert tdevice.is_compiled_with_cuda() == (torch.version.cuda
                                               is not None)
    tdevice.cuda.empty_cache()
    tdevice.synchronize()


def test_record_step_divides_by_the_h100_peak():
    """observability.training: the same counters and gauges as the
    reference's, with MFU over one H100's peak (the reference's over one
    v5e chip's, a deliberate difference)."""
    from paddle_tpu_torch.cost_model.cost_model import GPU_SPECS
    from paddle_tpu_torch.observability import training as otr
    from paddle_tpu.observability import training as potr
    for mod, reg in ((otr, obs), (potr, pobs)):
        mod.configure(flops_per_token=2.7395e9)
        mod.record_step(0.5, samples=4, tokens=4 * 2048)
    assert otr.DEFAULT_PEAK_FLOPS == GPU_SPECS["H100"]["flops"] == 989e12
    for name in ("train.steps", "train.samples", "train.tokens"):
        assert obs.counter(name).value == pobs.counter(name).value
    assert obs.gauge("train.tokens_per_s").value == 16384.0
    want = 16384.0 * 2.7395e9 / 989e12
    assert obs.gauge("train.mfu").value == pytest.approx(want, rel=1e-12)
    assert pobs.gauge("train.mfu").value == pytest.approx(
        16384.0 * 2.7395e9 / potr.DEFAULT_PEAK_FLOPS, rel=1e-12)
    otr.configure(flops_per_token=0.0)
    potr.configure(flops_per_token=0.0)


# ------------------------------------------------------ metric, hapi surface
def test_metrics_match_the_reference():
    rs = np.random.RandomState(3)
    logits = rs.randn(40, 6).astype("f4")
    labels = rs.randint(0, 6, (40, 1)).astype("int64")
    scores = rs.rand(40).astype("f4")
    binary = (rs.rand(40) < scores).astype("int64")
    got = []
    for pkg in (T, P):
        acc = pkg.metric.Accuracy(topk=(1, 3))
        acc.update(acc.compute(pkg.to_tensor(logits), pkg.to_tensor(labels)))
        pr, rc, auc = (pkg.metric.Precision(), pkg.metric.Recall(),
                       pkg.metric.Auc(num_thresholds=255))
        for m in (pr, rc, auc):
            m.update(pkg.to_tensor(scores), pkg.to_tensor(binary))
        top1 = pkg.metric.accuracy(pkg.to_tensor(logits),
                                   pkg.to_tensor(labels), k=2)
        got.append((acc.accumulate(), pr.accumulate(), rc.accumulate(),
                    auc.accumulate(), float(top1), acc.name()))
    assert got[0] == got[1]


def test_evaluate_predict_save_load_and_summary_match_the_reference(
        tmp_path):
    out = []
    for pkg, hapi in ((T, thapi), (P, phapi)):
        pkg.seed(0)
        net = pkg.nn.Linear(4, 3)
        model = hapi.Model(net)
        model.prepare(pkg.optimizer.Adam(0.1, parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss(),
                      metrics=pkg.metric.Accuracy())
        out.append((model, net))
    tnet, pnet = out[0][1], out[1][1]
    tnet.set_state_dict({k: v.numpy() for k, v in pnet.state_dict().items()})
    rs = np.random.RandomState(1)
    data = [(rs.randn(4).astype("f4"), np.array([i % 3], "int64"))
            for i in range(8)]
    tm, pm = out[0][0], out[1][0]
    tlogs = tm.evaluate(data, batch_size=4, verbose=0)
    plogs = pm.evaluate(data, batch_size=4, verbose=0)
    assert set(tlogs) == set(plogs) == {"loss", "acc"}
    np.testing.assert_allclose(tlogs["loss"], plogs["loss"], rtol=1e-6)
    assert tlogs["acc"] == plogs["acc"]
    tpred = tm.predict([(d[0],) for d in data], batch_size=4)
    ppred = pm.predict([(d[0],) for d in data], batch_size=4)
    for a, b in zip(tpred, ppred):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
    assert tm.summary() == pm.summary() == {"total_params": 15,
                                            "trainable_params": 15}
    hist_t = tm.fit(data, batch_size=4, epochs=2, verbose=0, shuffle=False)
    hist_p = pm.fit(data, batch_size=4, epochs=2, verbose=0, shuffle=False)
    np.testing.assert_allclose(hist_t["loss"], hist_p["loss"], rtol=1e-5)
    tm.save(str(tmp_path / "m"))
    T.seed(5)
    net2 = T.nn.Linear(4, 3)
    m2 = thapi.Model(net2)
    m2.prepare(T.optimizer.Adam(0.1, parameters=net2.parameters()))
    m2.load(str(tmp_path / "m"))
    for a, b in zip(tnet.parameters(), net2.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_train_batch_records_tokens_only_for_integer_ids():
    net = T.nn.Embedding(16, 4)
    model = thapi.Model(net)
    model.prepare(T.optimizer.SGD(0.1, parameters=net.parameters()),
                  lambda out, y: out.mean())
    model.train_batch([T.to_tensor(np.zeros((2, 5), "int64"))],
                      [T.zeros([2])])
    assert obs.counter("train.tokens").value == 10
    assert obs.counter("train.samples").value == 2
    lin = T.nn.Linear(5, 1)
    m2 = thapi.Model(lin)
    m2.prepare(T.optimizer.SGD(0.1, parameters=lin.parameters()),
               lambda out, y: out.mean())
    m2.train_batch([T.to_tensor(np.zeros((2, 5), "f4"))], [T.zeros([2])])
    assert obs.counter("train.tokens").value == 10
    assert obs.counter("train.samples").value == 4


def test_visualdl_writes_scalars_and_wandb_needs_its_package(tmp_path):
    cb = thapi.VisualDL(str(tmp_path))
    cb.on_train_batch_end(3, {"loss": 0.5})
    cb.on_train_end()
    with open(tmp_path / "scalars.jsonl") as f:
        assert json.loads(f.readline()) == {"tag": "train/loss",
                                            "value": 0.5, "step": 3}
    try:
        import wandb  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="wandb"):
            thapi.WandbCallback()


def test_the_watchdog_probe_answers_on_the_cpu():
    from paddle_tpu_torch.distributed import watchdog
    wd = watchdog.CollectiveWatchdog(timeout_s=5.0, interval_s=0.01)
    assert wd._probe_once()
    assert wd.rank == 0 and wd.world_size == 1
    g = watchdog.start_watchdog(timeout_s=5.0, interval_s=0.01)
    assert watchdog.start_watchdog() is g
    watchdog.stop_watchdog()
    assert watchdog._GLOBAL is None


def test_force_cpu_sets_the_default_place():
    from paddle_tpu_torch import _testing
    from paddle_tpu_torch.core import place
    place.set_device("gpu:0") if torch.cuda.is_available() else None
    _testing.force_cpu(num_devices=8)
    assert T.get_device() == "cpu:0"
    assert T.zeros([1])._data.device.type == "cpu"
