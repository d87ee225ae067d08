"""Fleet-side pipeline training: the port of
``paddle_tpu/distributed/fleet/meta_parallel.py`` (reference:
fleet/meta_parallel/pipeline_parallel.py, ``PipelineParallel.train_batch``,
:547, with the schedule chosen by
``DistributedStrategy.pipeline_configs["schedule_mode"]``).

``train_batch`` runs the step eagerly on each rank: the auto-parallel
partitioner's pipeline (``auto_parallel.partitioner.PipelinePartition``)
over the pp group for the forward and backward, the gradients averaged
over the dp group, then the optimizer and the scheduler.

schedule_mode (the reference's names, case-insensitive):
  "1F1B"          -> 1F1B (pipeline_1f1b.compiled_1f1b_schedule)
  "ZBH1"          -> zero-bubble ZBH1
  "ZBVPP" / "ZBV" -> zero-bubble ZB-V
  "FThenB"        -> refused at train_batch, as the reference refuses it
"""
from __future__ import annotations

import time

from ... import _chaos
from ...nn.layer.layers import Layer
from ...observability import metrics as _met
from ...observability import training as _otrain


class UnpartitionableModel(ValueError):
    """The model's structure cannot take the pipeline executor (no
    homogeneous block run): a structural limit that distributed_model
    passes through with a warning, unlike config errors (a bad
    schedule_mode), which surface."""


class PipelineParallel(Layer):
    """Wraps a PipelineLayer for fleet-driven pipeline training."""

    def __init__(self, layers, hcg, strategy=None):
        super().__init__()
        from ..auto_parallel.partitioner import (PipelinePartition,
                                                 find_pipeline_blocks)
        pp = hcg.get_pipe_parallel_world_size()
        if pp <= 1:
            raise ValueError("PipelineParallel needs pp_degree > 1")
        self._steps_seen = 0
        self._hcg = hcg
        topo = hcg.topology()
        for ax in ("sep", "sharding"):
            if ax in topo.get_hybrid_group_names() and \
                    topo.get_dim(ax) > 1:
                raise NotImplementedError(
                    f"fleet PipelineParallel with {ax}_degree > 1: use "
                    "the hybrid engine (models/gpt_hybrid.py) or the "
                    "auto-parallel Engine for sep/sharding hybrids")
        cfg = getattr(strategy, "pipeline_configs", None) or {}
        mode = str(cfg.get("schedule_mode", "1F1B")).lower()
        sched = {"1f1b": "1f1b", "zbh1": "zbh1",
                 "zbvpp": "zbvpp", "zbv": "zbvpp"}.get(mode)
        self._sched_error = None
        self._layers = layers
        self._micro_bs = cfg.get("micro_batch_size")
        self._partition = None
        self._sched = sched
        if sched is None:
            # a train-path config error: the wrap stays a working facade
            # (forward, state_dict) and every train_batch raises
            self._sched_error = (
                f"pipeline_configs schedule_mode {mode!r}: supported "
                "modes are 1F1B, ZBH1, ZBVPP/ZBV (FThenB's analog is the "
                "GPipe rotation — parallel/pipeline.py — kept off this "
                "facade because 1F1B strictly bounds its memory)")
            return
        # accumulate_steps maps 1:1 onto pipeline microbatches
        micro = max(1, int(cfg.get("accumulate_steps", 1)))
        blocks = self._longest_homogeneous_run(
            list(getattr(layers, "run_function", [])))
        if not blocks:
            blocks = find_pipeline_blocks(layers)
        if not blocks:
            raise UnpartitionableModel(
                "PipelineParallel needs a homogeneous block run in its "
                "layer chain (the reference PipelineLayer contract); "
                "none found on this model")
        self._partition = PipelinePartition(
            layers, getattr(layers, "_loss_fn", None), blocks,
            hcg.get_pipe_parallel_group(), pp, microbatches=micro,
            pp_schedule=sched, tp=hcg.get_model_parallel_world_size())

    @staticmethod
    def _longest_homogeneous_run(children):
        sigs = [tuple((n, tuple(p.shape))
                      for n, p in c.named_parameters())
                for c in children]
        best, cur = [], []
        for c, s in zip(children, sigs):
            if cur and s and s == cur[-1][1]:
                cur.append((c, s))
            else:
                cur = [(c, s)]
            if len(cur) > len(best):
                best = list(cur)
        return [c for c, _ in best] if len(best) >= 2 else None

    # transparent layer facade -----------------------------------------
    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @property
    def pp_schedule(self):
        return self._sched

    def train_batch(self, data, optimizer, lr_scheduler=None,
                    scaler=None, step_guard=None, watchdog=None):
        """One pipelined train step (the reference's train_batch): ``data``
        = (inputs, labels), this dp rank's batch; the forward and backward
        through the pipeline, the gradients averaged over dp, the
        optimizer's update, the scheduler's step. Returns the loss, the
        same on every rank of the pp group.

        ``watchdog``: a ``TrainStepWatchdog`` armed around the step.
        ``step_guard``: a ``training.StepGuard`` run after the step
        (``observe_loss``): it detects a non-finite loss and breaks the
        circuit, as the reference's fused step does."""
        if self._sched_error is not None:
            raise ValueError(self._sched_error)
        if scaler is not None:
            raise NotImplementedError(
                "train_batch with a GradScaler: use amp.auto_cast "
                "inside the loss or the hybrid engine's AMP path")
        x, y = data
        bs = x.shape[0]
        part = self._partition
        if self._micro_bs and bs != part.microbatches * int(self._micro_bs) \
                and not getattr(self, "_mb_warned", False):
            import warnings
            warnings.warn(
                f"pipeline_configs: batch {bs} != accumulate_steps "
                f"({part.microbatches}) * micro_batch_size "
                f"({self._micro_bs}); the batch is split into "
                f"accumulate_steps microbatches of {bs // part.microbatches} "
                "— micro_batch_size is informational here",
                stacklevel=2)
            self._mb_warned = True
        step_idx = self._steps_seen
        if watchdog is not None:
            watchdog.step_begin(step_idx)
        t0 = time.perf_counter()
        try:
            _chaos.hit("train.step", step=step_idx)
            loss = part.train_grads(x, y)
            self._average_over_dp(loss)
            optimizer.step()
            optimizer.clear_grad()
            loss_val = float(loss)
        except KeyboardInterrupt:
            err = watchdog.consume_abort() if watchdog is not None \
                else None
            if err is not None:
                raise err from None
            raise
        finally:
            if watchdog is not None:
                watchdog.step_end()
        self._steps_seen += 1
        if step_guard is not None:
            step_guard.observe_loss(loss_val, step=step_idx)
        if _met._ENABLED:
            tokens = int(x.shape[0]) * int(x.shape[1]) \
                if len(x.shape) >= 2 and "int" in str(x.dtype) else None
            _otrain.record_step(time.perf_counter() - t0, samples=int(bs),
                                tokens=tokens)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def _average_over_dp(self, loss):
        """The gradients (and the loss) averaged over the dp group."""
        from .. import collective as C
        group = self._hcg.get_data_parallel_group()
        if group is None or group.nranks <= 1:
            return
        import torch
        params = [p for p in self._layers.parameters() if p.grad is not None]
        flat = torch.cat([p.grad._data.reshape(-1).float() for p in params]
                         + [loss._data.reshape(1).float()])
        C.all_reduce_flat(flat, C.ReduceOp.AVG, group)
        off = 0
        for p in params:
            n = p.grad._data.numel()
            p.grad = flat[off:off + n].view(p.grad._data.shape).to(
                p._data.dtype)
            off += n
        loss._data = flat[off].to(loss._data.dtype)
