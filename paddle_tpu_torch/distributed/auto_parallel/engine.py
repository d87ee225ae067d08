"""The auto-parallel Engine: the port of
``paddle_tpu/distributed/auto_parallel/engine.py`` (reference:
distributed/auto_parallel/static/engine.py:98 — Engine(model, loss,
optimizer, metrics, strategy) with fit/evaluate/predict/cost over an
automatically planned distributed program).

The plan comes from the port's ``Planner`` (``chip="H100"``); the job's
ranks are laid out as a (dp, pp, mp) ``ProcessMesh``, mp innermost, and
every rank runs the same eager step:

  dp x ZeRO <= 1 : any model. Each rank runs its rows of the global batch;
                   the gradients are averaged over dp (with ZeRO-1 by the
                   port's ``sharding.DygraphShardingOptimizer``, which also
                   shards the optimizer's states over dp).
  + tp           : any model. ``partitioner.annotate_tp`` shards its
                   Linear and Embedding parameters over mp.
  + pp           : models with a homogeneous LayerList/Sequential block
                   chain (the reference's PipelineLayer requirement),
                   through ``partitioner.PipelinePartition`` over the pp
                   group (1F1B, or the zero-bubble schedules at tp = 1).

The reference compiles its steps with ``jit.to_static``; the port's Engine
runs them eagerly (``jit.to_static`` around a step is the user's choice).
A plan must span the job's ranks: dp x pp x tp equals the world size.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...core.tensor import Tensor
from ..planner import ModelSpec, Planner


class Engine:
    def __init__(self, model=None, loss=None, optimizer=None,
                 metrics=None, strategy=None, chip: str = "H100"):
        self.model = model
        self.loss = loss
        self.optimizer = optimizer
        self.metrics = metrics if isinstance(metrics, (list, tuple)) \
            else ([metrics] if metrics is not None else [])
        self.strategy = strategy
        self._chip = chip
        self._mesh = None
        self._plan = None
        self._step = None
        self._eval_step = None
        self._partition = None
        self.history = []

    # ------------------------------------------------------------ plan
    def _pipeline_blocks(self):
        if not hasattr(self, "_blocks_cache"):
            from .partitioner import find_pipeline_blocks
            self._blocks_cache = find_pipeline_blocks(self.model)
        return self._blocks_cache

    def _model_spec(self) -> ModelSpec:
        n = sum(int(np.prod(p.shape))
                for _, p in self.model.named_parameters())
        blocks = self._pipeline_blocks()
        if blocks:
            # geometry from the block chain: layers = chain length,
            # hidden from the widest square-ish weight
            hidden = max((min(p.shape) for _, p in
                          blocks[0].named_parameters()
                          if len(p.shape) == 2), default=1)
            return ModelSpec(float(n), layers=len(blocks),
                             hidden=int(hidden), heads=max(1,
                             int(hidden) // 64), seq=128, vocab=1)
        return ModelSpec(float(n), layers=1, hidden=1, heads=1, seq=1,
                         vocab=1)

    @staticmethod
    def _world():
        from ..env import get_world_size
        return get_world_size()

    def plan(self, n_chips: Optional[int] = None, global_batch: int = 32,
             top_k: int = 5):
        """Ranked parallel plans for this model on n_chips cards (the job's
        ranks by default). Models with a pipeline block chain search the
        full (dp, tp, pp, zero) family; block-less models the plans without
        pp. ZeRO stays at most 1: the Engine implements stage 1."""
        n = n_chips or self._world()
        planner = Planner(self._chip, zero_stages=(0, 1))
        plans = planner.plan(self._model_spec(), n, global_batch,
                             top_k=max(top_k, 8))
        if not self._pipeline_blocks():
            plans = [p for p in plans if p.pp == 1] or plans[:1]
        return plans[:top_k]

    def cost(self, n_chips: Optional[int] = None, global_batch: int = 32):
        """Estimated (step_seconds, per_card_memory_bytes) of the best
        plan (the reference Engine.cost surface)."""
        best = self.plan(n_chips, global_batch)[0]
        return best.est_step_s, best.est_mem_bytes

    # --------------------------------------------------------- prepare
    def prepare(self, n_chips: Optional[int] = None,
                global_batch: int = 32, plan=None, zero_bubble=False):
        """Lays the plan (the planner's best by default) onto the job's
        ranks and builds the steps. ``zero_bubble`` runs pp > 1 plans at
        tp = 1 on ZBH1 (True) or ZB-V ("zbvpp") instead of 1F1B."""
        from ..mesh import ProcessMesh
        world = self._world()
        best = plan if plan is not None else \
            self.plan(n_chips or world, global_batch)[0]
        if best.pp > 1 and not self._pipeline_blocks():
            raise NotImplementedError(
                f"plan {best.short()} needs a homogeneous "
                "LayerList/Sequential block chain for pipeline "
                "partitioning (the reference PipelineLayer "
                "contract); this model has none")
        need = best.dp * best.pp * best.tp
        if need != world:
            raise ValueError(f"plan {best.short()} needs {need} ranks; the "
                             f"job has {world}")
        self._plan = best
        self._mesh = ProcessMesh(shape=[best.dp, best.pp, best.tp],
                                 dim_names=["dp", "pp", "mp"])
        self._dp = self._mesh.get_group("dp")
        if best.tp > 1:
            from .partitioner import annotate_tp
            annotate_tp(self.model, self._mesh, "mp")
        if best.pp > 1:
            self._prepare_pp(best, zero_bubble)
        if best.zero >= 1 and best.dp > 1 and self.optimizer is not None:
            from ..sharding import DygraphShardingOptimizer
            self.optimizer = DygraphShardingOptimizer(self.optimizer,
                                                      group=self._dp)
        self._step = self._train_step
        self._eval_step = self._eval
        return self

    def _prepare_pp(self, best, zero_bubble):
        from .partitioner import PipelinePartition
        blocks = self._pipeline_blocks()
        # an explicitly planned microbatch count is kept; 1 (the
        # dataclass default) means unset and gets 2 * pp
        mbs = best.microbatches if best.microbatches > 1 else 2 * best.pp
        if zero_bubble and best.tp == 1:
            sched = zero_bubble if isinstance(zero_bubble, str) else "zbh1"
        else:
            sched = "1f1b"
        self._partition = PipelinePartition(
            self.model, self.loss, blocks, self._mesh.get_group("pp"),
            best.pp, microbatches=mbs, pp_schedule=sched, tp=best.tp)

    # ------------------------------------------------------------ steps
    def _rows(self, arr):
        """This rank's rows of a global batch (its dp slice)."""
        t = arr if isinstance(arr, Tensor) else Tensor(np.asarray(arr))
        n, r = self._dp.nranks, self._dp.rank
        if n > 1 and t.shape[0] % n == 0:
            b = t.shape[0] // n
            t = Tensor._wrap(t._data[r * b:(r + 1) * b])
        return t

    @torch.no_grad()
    def _average(self, arrays):
        """Averages the arrays in place over dp, in one buffer."""
        from .. import collective as C
        if self._dp.nranks == 1 or not arrays:
            return
        flat = torch.cat([a.reshape(-1).float() for a in arrays])
        C.all_reduce_flat(flat, C.ReduceOp.AVG, self._dp)
        off = 0
        for a in arrays:
            a.copy_(flat[off:off + a.numel()].view(a.shape))
            off += a.numel()

    def _train_step(self, xb, yb):
        if self._partition is not None:
            loss = self._partition.train_grads(xb, yb)
        else:
            loss = self.loss(self.model(xb), yb)
            loss.backward()
        if not hasattr(self.optimizer, "_shards"):     # ZeRO-1 reduces
            self._average([p.grad._data for p in self.model.parameters()
                           if p.grad is not None])
        self.optimizer.step()
        self.optimizer.clear_grad()
        out = loss._data.detach().float().reshape(1).clone()
        self._average([out])
        return out[0]

    def _eval(self, xb, yb):
        from ...autograd import no_grad
        with no_grad():
            loss = self.loss(self.model(xb), yb)
        out = loss._data.detach().float().reshape(1).clone()
        self._average([out])
        return out[0]

    # ------------------------------------------------------------- fit
    def fit(self, train_data, epochs: int = 1, batch_size: int = 32,
            steps_per_epoch: Optional[int] = None, log_freq: int = 0,
            valid_data=None):
        """reference Engine.fit: iterate the data source, one step per
        batch, this rank computing on its dp rows of each global batch."""
        if self._step is None:
            self.prepare(global_batch=batch_size)
        loader = self._as_loader(train_data, batch_size)
        for epoch in range(epochs):
            losses = []
            for i, batch in enumerate(loader):
                if steps_per_epoch and i >= steps_per_epoch:
                    break
                loss = self._step(self._rows(batch[0]),
                                  self._rows(batch[1]))
                losses.append(float(loss))
                if log_freq and i % log_freq == 0:
                    print(f"[engine] epoch {epoch} step {i} "
                          f"loss {losses[-1]:.4f}")
            entry = {"epoch": epoch,
                     "loss": float(np.mean(losses)) if losses else None}
            if valid_data is not None:
                entry["eval_loss"] = self.evaluate(valid_data,
                                                   batch_size)
            self.history.append(entry)
        return self.history

    def evaluate(self, eval_data, batch_size: int = 32,
                 steps: Optional[int] = None):
        if self._eval_step is None:
            self.prepare(global_batch=batch_size)
        self.model.eval()
        losses = []
        for i, batch in enumerate(self._as_loader(eval_data, batch_size)):
            if steps and i >= steps:
                break
            losses.append(float(self._eval_step(self._rows(batch[0]),
                                                self._rows(batch[1]))))
        self.model.train()
        return float(np.mean(losses)) if losses else None

    def predict(self, data, batch_size: int = 32):
        """The model's outputs on every batch (each rank computes the whole
        batch)."""
        from ...autograd import no_grad
        if self._mesh is None:
            self.prepare(global_batch=batch_size)
        self.model.eval()
        outs = []
        with no_grad():
            for batch in self._as_loader(data, batch_size):
                xb = batch[0] if isinstance(batch, (list, tuple)) \
                    else batch
                xb = xb if isinstance(xb, Tensor) else Tensor(np.asarray(xb))
                outs.append(self.model(xb))
        self.model.train()
        return outs

    # ------------------------------------------------------------ misc
    def _as_loader(self, data, batch_size):
        from ...io import DataLoader, Dataset
        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=False)
        if hasattr(data, "__next__"):
            # a one-shot iterator would train epoch 0 only; every epoch
            # sees the batches
            return list(data)
        return data                      # any re-iterable of batches

    def save(self, path, training=True):
        from ... import framework
        state = {"model": self.model.state_dict()}
        if training and self.optimizer is not None:
            state["optimizer"] = self.optimizer.state_dict()
        framework.save(state, path)

    def load(self, path):
        from ... import framework
        state = framework.load(path)
        self.model.set_state_dict(state["model"])
        if self.optimizer is not None and "optimizer" in state:
            self.optimizer.set_state_dict(state["optimizer"])
        return self
