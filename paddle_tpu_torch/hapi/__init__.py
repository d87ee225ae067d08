"""High-level API: the port of ``paddle_tpu/hapi/__init__.py`` (reference:
python/paddle/hapi/model.py — Model :1082, fit :1808, callbacks).

``Model.train_batch`` keeps the reference's order: the ``train.step``
chaos site, forward, backward, the step guard's ``pre_step``, the update
or its skip, ``float(loss)`` (the step's one sync with the device), and
only then ``record_step``, so the step time covers the device's work.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

import torch

from .. import _chaos
from .. import training as _ftrain
from ..autograd import no_grad
from ..core.tensor import Tensor
from ..framework.io import load as _load, save as _save
from ..io import DataLoader
from ..metric import Metric
from ..observability import metrics as _met
from ..observability import training as _otrain


class Callback:
    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=1):
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}"
                              for k, v in (logs or {}).items())
            print(f"Epoch {self.epoch} step {step}: {items}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._t0
            items = ", ".join(f"{k}: {v:.4f}" if isinstance(v, float)
                              else f"{k}: {v}"
                              for k, v in (logs or {}).items())
            print(f"Epoch {epoch} done in {dt:.1f}s: {items}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, str(epoch)))


class FaultTolerantCheckpoint(Callback):
    """Preemption-safe periodic checkpointing with exact resume
    (reference posture: fleet/elastic auto-resume).

    Every ``every_n_steps`` completed optimizer steps — and, crucially,
    when a preemption notice arrives (SIGTERM by default, or the
    ``train.preempt`` chaos site in drills) — the callback flushes a
    COMMITTED checkpoint (``_COMMITTED.json`` protocol) holding model
    + optimizer tensors, the default-Generator RNG state, and the
    dataloader position, then stops ``fit`` cleanly at the step
    boundary. On the next run, ``on_train_begin`` resumes from
    ``latest_committed(root)``: parameters restore in place and the
    dataloader fast-forwards so the run consumes the EXACT remaining
    data order, bit for bit.

    Pass the SAME ``DataLoader`` instance to both ``fit`` and this
    callback (and give it a ``seed`` for reproducible shuffling) —
    the loader's position is part of the checkpoint."""

    def __init__(self, root, every_n_steps=1, dataloader=None,
                 scaler=None, resume=True, install_signal_handler=True,
                 signals=None, keep_last=None):
        self.root = root
        self.every_n_steps = int(every_n_steps)
        self.dataloader = dataloader
        self.scaler = scaler
        self.resume = resume
        self.keep_last = keep_last
        self.global_step = 0          # completed optimizer steps
        self.fit_epoch = 0            # fit epoch currently running
        self.resumed_from = None
        self.preempted = False
        self.stopped = False
        self._handler = None
        if install_signal_handler:
            import signal as _signal
            sigs = signals if signals is not None else (_signal.SIGTERM,)
            self._handler = _ftrain.PreemptionHandler(sigs)

    def on_train_begin(self, logs=None):
        os.makedirs(self.root, exist_ok=True)
        # a REUSED callback (the natural resume-retry pattern: call
        # fit again with the same instance) must not carry a consumed
        # preemption notice into the next run — it would stop every
        # subsequent fit after one batch
        self.stopped = False
        self.preempted = False
        if self.resume:
            # resume BEFORE installing the signal handler: a failed
            # load (seed mismatch, corrupt checkpoint) must not leave
            # a flag-only SIGTERM handler installed on an abandoned
            # run — it would swallow every later real preemption
            meta = _ftrain.load_train_checkpoint(
                self.root, self.model.network, self.model._optimizer,
                self.dataloader, self.scaler)
            if meta is not None:
                self.global_step = int(meta["step"])
                self.fit_epoch = int(meta.get("epoch", 0))
                self.resumed_from = meta["path"]
                # chaos/step-guard contexts key on the GLOBAL step,
                # and fit's epoch BUDGET must not re-run completed
                # epochs (the loader position covers the partial one)
                self.model._steps_seen = self.global_step
                self.model._initial_epoch = self.fit_epoch
                self._normalize_epoch_boundary()
        if self._handler is not None:
            self._handler.triggered = False
            self._handler.install()

    def _normalize_epoch_boundary(self):
        """A checkpoint flushed at an epoch's FINAL batch restores as
        (epoch e, all batches served): re-entering epoch e would yield
        zero batches but still fire on_epoch_end/eval a second time
        (double-stepping epoch-wise LR schedulers, double-counting
        early-stop patience). Normalize to the equivalent position —
        the start of epoch e+1 — for both the loader and fit's epoch
        budget."""
        dl = self.dataloader
        if dl is None or not hasattr(dl, "state_dict"):
            return
        st = dl.state_dict()
        try:
            per_epoch = len(dl)
        except TypeError:
            return
        if per_epoch and st["batches_served"] >= per_epoch:
            dl.set_state_dict({"epoch": st["epoch"] + 1,
                               "batches_served": 0,
                               "seed": st["seed"]})
            self.fit_epoch += 1
            self.model._initial_epoch = self.fit_epoch

    def on_epoch_begin(self, epoch, logs=None):
        self.fit_epoch = int(epoch)

    def on_train_batch_end(self, step, logs=None):
        gs = self.global_step = self.global_step + 1
        preempt = self._handler is not None and self._handler.triggered
        try:
            _chaos.hit("train.preempt", step=gs)
        except _chaos.ChaosError:
            preempt = True       # injected preemption notice (drills)
        if preempt:
            self._flush(gs)
            if _met._ENABLED:
                _met.REGISTRY.counter("train.preemptions").inc()
            self.preempted = True
            self.stopped = True           # fit stops at this batch
            self.model.stop_training = True
            return
        if self.every_n_steps and gs % self.every_n_steps == 0:
            self._flush(gs)

    def on_train_end(self, logs=None):
        if self._handler is not None:
            self._handler.restore()

    def _flush(self, gs):
        _ftrain.save_train_checkpoint(
            self.root, gs, self.model.network, self.model._optimizer,
            self.dataloader, self.scaler, epoch=self.fit_epoch)
        if self.keep_last:
            self._prune()

    def _prune(self):
        import shutil
        from ..distributed import checkpoint as dc
        committed = [d for d in sorted(os.listdir(self.root))
                     if d.startswith("step_")
                     and dc.is_committed(os.path.join(self.root, d))]
        for d in committed[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.root, d),
                          ignore_errors=True)


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0,
                 verbose=1, min_delta=0, baseline=None,
                 save_best_model=True):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.best = None
        self.wait = 0
        self.stopped = False
        self.mode = "min" if mode == "auto" and "loss" in monitor else mode

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        better = self.best is None or (
            cur < self.best - self.min_delta if self.mode == "min"
            else cur > self.best + self.min_delta)
        if better:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                self.stopped = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler per batch/epoch (reference
    hapi/callbacks.py LRSchedulerCallback)."""

    def __init__(self, by_step=True, by_epoch=False):
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()


class ReduceLROnPlateau(Callback):
    """Reduce LR when a metric has stopped improving (reference
    hapi/callbacks.py ReduceLROnPlateau)."""

    def __init__(self, monitor='loss', factor=0.1, patience=10, verbose=1,
                 mode='auto', min_delta=1e-4, cooldown=0, min_lr=0):
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = "min" if mode == "auto" and "loss" in monitor else mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.wait = 0
        self.cooldown_counter = 0

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        better = self.best is None or (
            cur < self.best - self.min_delta if self.mode == "min"
            else cur > self.best + self.min_delta)
        if better:
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                opt = getattr(self.model, "_optimizer", None)
                if opt is not None:
                    new_lr = max(opt.get_lr() * self.factor, self.min_lr)
                    opt.set_lr(new_lr)
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr -> {new_lr:g}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class VisualDL(Callback):
    """Scalar logging callback (reference hapi/callbacks.py VisualDL;
    scalars go to a jsonl file under log_dir, as the reference writes
    them without the visualdl package)."""

    def __init__(self, log_dir):
        self.log_dir = log_dir
        self._f = None

    def _write(self, tag, logs, step):
        import json
        if self._f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._f = open(os.path.join(self.log_dir, "scalars.jsonl"),
                           "a")
        for k, v in (logs or {}).items():
            try:
                v = float(v[0] if isinstance(v, (list, tuple)) else v)
            except (TypeError, ValueError):
                continue
            self._f.write(json.dumps(
                {"tag": f"{tag}/{k}", "value": v, "step": step}) + "\n")
        self._f.flush()

    def on_train_batch_end(self, step, logs=None):
        self._write("train", logs, step)

    def on_eval_end(self, logs=None):
        self._write("eval", logs, 0)

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None


class WandbCallback(Callback):
    """Weights&Biases logging (reference hapi/callbacks.py
    WandbCallback); gated on the wandb package being importable."""

    def __init__(self, project=None, run=None, **kwargs):
        try:
            import wandb
            self.wandb = wandb
        except ImportError:
            raise ImportError(
                "WandbCallback requires the `wandb` package, which is "
                "not installed")
        self.project = project
        self.kwargs = kwargs
        self.run = run

    def on_train_begin(self, logs=None):
        if self.run is None:
            self.run = self.wandb.init(project=self.project, **self.kwargs)

    def on_train_batch_end(self, step, logs=None):
        self.run.log({k: v for k, v in (logs or {}).items()
                      if isinstance(v, (int, float))})

    def on_train_end(self, logs=None):
        if self.run is not None:
            self.run.finish()


class Model:
    """Keras-like trainer (reference hapi/model.py:1082)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False
        self._step_guard = None
        self._watchdog = None
        self._steps_seen = 0
        self._initial_epoch = 0

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, step_guard=None, watchdog=None):
        """``step_guard``: a ``training.StepGuard`` giving train_batch
        skip-step semantics on non-finite loss/grads plus the
        consecutive-bad circuit breaker. ``watchdog``: a
        ``distributed.watchdog.TrainStepWatchdog`` armed around every
        step — a stalled step aborts with a ``TrainHangError``
        straggler report instead of hanging silently."""
        self._optimizer = optimizer
        self._loss = loss
        self._step_guard = step_guard
        self._watchdog = watchdog
        if metrics is None:
            self._metrics = []
        else:
            self._metrics = metrics if isinstance(metrics, (list, tuple)) \
                else [metrics]

    # --------------------------------------------------------------- steps
    def train_batch(self, inputs, labels=None):
        self.network.train()
        # unconditional: enabling metrics mid-step must not record a
        # dt measured from 0.0 (perf_counter is ~ns, no cost to skip)
        t0 = time.perf_counter()
        step_idx = self._steps_seen
        wd = self._watchdog
        if wd is not None:
            wd.step_begin(step_idx)
        skipped = False
        try:
            _chaos.hit("train.step", step=step_idx)
            inputs = inputs if isinstance(inputs, (list, tuple)) \
                else [inputs]
            labels = labels if labels is None or isinstance(
                labels, (list, tuple)) else [labels]
            outputs = self.network(*inputs)
            losses = self._loss(outputs, *labels) if labels is not None \
                else outputs
            loss = losses if isinstance(losses, Tensor) else sum(losses)
            loss.backward()
            guard = self._step_guard
            if guard is not None and not guard.pre_step(
                    loss, self._optimizer, step=step_idx):
                # skip-step: non-finite loss/grads — drop this update,
                # keep the run alive (pre_step's circuit breaker
                # aborts when bad steps persist)
                self._optimizer.clear_grad()
                skipped = True
            else:
                self._optimizer.step()
                self._optimizer.clear_grad()
            loss_val = float(loss)
        except KeyboardInterrupt:
            # translate on the abort TOKEN, not trip state: a
            # late-landing watchdog SIGINT (next step already re-armed)
            # is still a hang abort; a genuine ctrl-C never carries a
            # token and propagates
            err = wd.consume_abort() if wd is not None else None
            if err is not None:
                raise err from None
            raise
        finally:
            if wd is not None:
                wd.step_end()
        self._steps_seen += 1
        if skipped:
            # not an optimizer step: keep MFU/step-time clean and the
            # metric accumulators unpolluted by the bad batch
            metrics = [m.accumulate() for m in self._metrics]
            return ([loss_val], metrics) if metrics else [loss_val]
        if _met._ENABLED:
            # timed AFTER the float(loss) device sync: the step's true
            # end — timing only the async dispatch would report
            # impossible throughput on a real accelerator
            self._record_step_metrics(time.perf_counter() - t0, inputs)
        metrics = []
        for m in self._metrics:
            m.update(m.compute(outputs, *labels)
                     if labels is not None else m.compute(outputs))
            metrics.append(m.accumulate())
        return ([loss_val], metrics) if metrics else [loss_val]

    @staticmethod
    def _record_step_metrics(dt, inputs):
        """One train step into the observability registry: step time,
        samples/s, and — for token batches ([B, S] integer ids) —
        tokens/s feeding the MFU gauge when
        observability.training.configure() declared the model cost."""
        samples = tokens = None
        x = inputs[0] if inputs else None
        if isinstance(x, Tensor) and x.ndim >= 1:
            samples = int(x.shape[0])
            d = x._data.dtype
            if x.ndim >= 2 and not (d.is_floating_point or d.is_complex
                                    or d == torch.bool):
                tokens = int(x.shape[0]) * int(x.shape[1])
        _otrain.record_step(dt, samples=samples, tokens=tokens)

    @no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if labels is None or isinstance(
            labels, (list, tuple)) else [labels]
        outputs = self.network(*inputs)
        losses = self._loss(outputs, *labels) if self._loss and \
            labels is not None else None
        metrics = []
        for m in self._metrics:
            m.update(m.compute(outputs, *labels)
                     if labels is not None else m.compute(outputs))
            metrics.append(m.accumulate())
        loss_val = [float(losses if isinstance(losses, Tensor)
                          else sum(losses))] if losses is not None else []
        return (loss_val, metrics) if metrics else loss_val

    @no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        out = self.network(*inputs)
        return out

    # ----------------------------------------------------------------- fit
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=1, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        loader = train_data if isinstance(train_data, DataLoader) else \
            DataLoader(train_data, batch_size=batch_size, shuffle=shuffle,
                       drop_last=drop_last, num_workers=num_workers)
        cbs = list(callbacks or [])
        if verbose:
            cbs.append(ProgBarLogger(log_freq, verbose))
        if save_dir:
            cbs.append(ModelCheckpoint(save_freq, save_dir))
        for cb in cbs:
            cb.set_model(self)
        it = 0
        history = {"loss": []}
        stop = False
        self.stop_training = False
        try:
            # on_train_begin INSIDE the try: a callback that fails
            # here (e.g. a refused resume) must still get the
            # finally's on_train_end cleanup — signal handlers and
            # file sinks cannot leak on a failed start
            for cb in cbs:
                cb.on_train_begin()
            # a resume (FaultTolerantCheckpoint) sets _initial_epoch
            # so the epoch BUDGET carries across a restart: completed
            # epochs are not re-run (the dataloader's own restored
            # position covers the partial one). One-shot: consumed
            # here, reset for later fits.
            start_epoch = self._initial_epoch
            self._initial_epoch = 0
            for epoch in range(start_epoch, epochs):
                for m in self._metrics:
                    m.reset()
                for cb in cbs:
                    cb.on_epoch_begin(epoch)
                logs = {}
                data_iter = iter(loader)
                step = 0
                try:
                    while True:
                        _chaos.hit("train.data_fetch", epoch=epoch,
                                   step=it)
                        try:
                            batch = next(data_iter)
                        except StopIteration:
                            break
                        for cb in cbs:
                            cb.on_train_batch_begin(step)
                        batch = batch if isinstance(batch,
                                                    (list, tuple)) \
                            else [batch]
                        ins, labs = batch[:-1], batch[-1:]
                        if len(batch) == 1:
                            ins, labs = batch, None
                        res = self.train_batch(list(ins), labs)
                        loss_val = res[0][0] if isinstance(res, tuple) \
                            else res[0]
                        logs = {"loss": loss_val}
                        if isinstance(res, tuple):
                            for m, v in zip(self._metrics, res[1]):
                                logs[m.name()] = v
                        history["loss"].append(loss_val)
                        for cb in cbs:
                            cb.on_train_batch_end(step, logs)
                        it += 1
                        step += 1
                        if self.stop_training or any(
                                getattr(cb, "stopped", False)
                                for cb in cbs):
                            # preemption / early stop honored at the
                            # step boundary, mid-epoch
                            stop = True
                            break
                        if num_iters is not None and it >= num_iters:
                            # unlike the preemption stop above, a
                            # num_iters exit ends the RUN (never
                            # resumed back into this epoch), so the
                            # long-standing fire-epoch-end-after-break
                            # behavior cannot double-step anything —
                            # kept for compatibility
                            break
                finally:
                    # deterministic release on every exit (preempt,
                    # crash, num_iters): an abandoned loader iterator
                    # must unwind its prefetch machinery now, not at
                    # a later GC
                    close = getattr(data_iter, "close", None)
                    if close is not None:
                        close()
                if stop:
                    # the epoch was cut short (preemption / stop flag):
                    # its end-of-epoch hooks belong to the RESUMED run
                    # — firing them here would double-step epoch-wise
                    # LR schedulers and early-stop patience
                    break
                for cb in cbs:
                    cb.on_epoch_end(epoch, logs)
                if eval_data is not None and (epoch + 1) % eval_freq == 0:
                    eval_logs = self.evaluate(eval_data,
                                              batch_size=batch_size,
                                              verbose=0)
                    for cb in cbs:
                        cb.on_eval_end(eval_logs)
                if any(getattr(cb, "stopped", False) for cb in cbs):
                    break
                if num_iters is not None and it >= num_iters:
                    break
        except KeyboardInterrupt:
            # a watchdog abort whose SIGINT lands between steps (the
            # step completed while the monitor was dumping) must still
            # surface as a hang report, not a bare ctrl-C — the abort
            # token distinguishes the two
            wd = self._watchdog
            err = wd.consume_abort() if wd is not None else None
            if err is not None:
                raise err from None
            raise
        finally:
            # ALWAYS — even when an attempt crashes mid-loop: a leaked
            # SIGTERM handler on a dead callback would swallow the next
            # attempt's preemption notice, and file-backed callbacks
            # must close their sinks. Per-callback isolation: one sink
            # failing to close must neither skip another's cleanup nor
            # mask the in-flight training exception.
            import sys as _sys
            in_flight = _sys.exc_info()[0] is not None
            cleanup_err = None
            for cb in cbs:
                try:
                    cb.on_train_end()
                except Exception as ce:  # noqa: BLE001
                    if cleanup_err is None:
                        cleanup_err = ce
                    import traceback
                    traceback.print_exc()
            if cleanup_err is not None and not in_flight:
                raise cleanup_err
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=1,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = eval_data if isinstance(eval_data, DataLoader) else \
            DataLoader(eval_data, batch_size=batch_size)
        for m in self._metrics:
            m.reset()
        total_loss, n = 0.0, 0
        for step, batch in enumerate(loader):
            batch = batch if isinstance(batch, (list, tuple)) else [batch]
            ins, labs = batch[:-1], batch[-1:]
            res = self.eval_batch(list(ins), labs)
            losses = res[0] if isinstance(res, tuple) else res
            if losses:
                total_loss += losses[0]
                n += 1
            if num_iters is not None and step + 1 >= num_iters:
                break
        logs = {"loss": [total_loss / max(n, 1)]}
        for m in self._metrics:
            logs[m.name()] = m.accumulate()
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) else \
            DataLoader(test_data, batch_size=batch_size)
        outs = []
        for batch in loader:
            batch = batch if isinstance(batch, (list, tuple)) else [batch]
            outs.append(self.predict_batch(batch[:1]))
        return outs

    # ------------------------------------------------------------- persist
    def save(self, path, training=True):
        _save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            _save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        self.network.set_state_dict(_load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(opt_path):
            self._optimizer.set_state_dict(_load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        from .. import summary
        return summary(self.network)
