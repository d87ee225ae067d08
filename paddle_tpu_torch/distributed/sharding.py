"""Group-sharded data parallelism (ZeRO stages 1/2/3): the port of
``paddle_tpu/distributed/sharding.py`` (reference surface:
sharding/group_sharded.py group_sharded_parallel and
save_group_sharded_model; DygraphShardingOptimizer,
dygraph_sharding_optimizer.py:48; GroupShardedStage2,
group_sharded_stage2.py:46; GroupShardedStage3, group_sharded_stage3.py:85).

Each trainable parameter is flattened and padded to a multiple of the
sharding group's size N, and rank r owns the elements [r * c, (r + 1) * c),
c = its padded size / N. The owned slice lives in a ``shadow`` Parameter of
c elements, and the wrapped optimizer runs on the shadows (their names and
learning-rate attributes are the parameters'), so every rank holds 1/N of
the optimizer states (and master weights) of each parameter:

- stage 1 (``os``): at ``step`` each gradient is reduce-scattered (AVG)
  onto its shadow, the optimizer updates the shadows, and an all-gather
  writes the new values back into the full parameters;
- stage 2 (``os_g``): a hook after each parameter's gradient accumulation
  reduce-scatters it onto the shadow's gradient and frees the full one, so
  a rank keeps 1/N of the gradients (under ``no_sync`` the hook is deferred
  to the context's exit, on the accumulated gradient);
- stage 3 (``p_g_os``): the parameters' storage is freed too; the wrapper's
  ``forward`` all-gathers them from the shadows, and the stage-2 hook frees
  each again once its gradient is reduced.

The reference lays each state out sharded on a tensor dim and lets XLA emit
the collectives; any partition of the elements gives the same numbers for an
elementwise update. A gradient clip by global norm sums the squares over
the group first.
"""
from __future__ import annotations

import os

import torch

from ..core.tensor import Parameter, Tensor
from ..nn.layer.layers import Layer
from . import collective as C
from .env import get_rank


def _resolve_group(group=None):
    """The sharding group: ``group``, else fleet's sharding group when its
    degree exceeds 1, else the whole job."""
    if group is not None:
        return group
    from .fleet.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        return hcg.get_sharding_parallel_group()
    return None


def _group_size(group):
    from .env import get_world_size
    return get_world_size(group)


def _group_rank(group):
    return group.rank if group is not None else get_rank()


class _Shard:
    """One parameter's slice on this rank."""

    def __init__(self, p, n, r):
        self.p = p
        self.numel = p._data.numel()
        self.shape = tuple(p._data.shape)
        self.chunk = -(-self.numel // n)
        self.n, self.r = n, r
        flat = self.padded_flat(p._data.detach())
        sl = flat[r * self.chunk:(r + 1) * self.chunk].clone()
        self.shadow = Parameter._wrap_param(sl, trainable=True, name=p.name)
        self.shadow.optimize_attr = dict(getattr(p, "optimize_attr", {}))
        self.shadow.need_clip = getattr(p, "need_clip", True)
        self.shadow.regularizer = getattr(p, "regularizer", None)

    def padded_flat(self, a):
        flat = a.reshape(-1)
        pad = self.chunk * self.n - self.numel
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        return flat

    def gathered(self, group):
        """The full parameter, all-gathered from the shadows."""
        s = self.shadow._data.detach()
        full = torch.empty(self.chunk * self.n, dtype=s.dtype,
                           device=s.device)
        C.all_gather_flat(full, s, group)
        return full[:self.numel].view(self.shape)

    def reduced_grad(self, g, group):
        """This rank's slice of the AVG over the group of ``g``."""
        out = torch.empty(self.chunk, dtype=g.dtype, device=g.device)
        C.reduce_scatter_flat(out, self.padded_flat(g), C.ReduceOp.AVG,
                              group)
        return out


def _add_grad(t, g):
    if t.grad is None:
        t.grad = Tensor._wrap(g)
    else:
        t.grad._data.add_(g)


class _GroupGlobalNormClip:
    """ClipGradByGlobalNorm over the shadows: the squared norms are summed
    over the group before the scale is taken."""

    def __init__(self, clip, group):
        self.clip_norm = clip.clip_norm
        self._group = group

    def __call__(self, params_grads):
        sq = [torch.sum(torch.square(g._data.float()))
              for p, g in params_grads
              if g is not None and getattr(p, "need_clip", True)]
        if not sq:
            return params_grads
        total = torch.stack(sq).sum().reshape(1)
        C.all_reduce_flat(total, C.ReduceOp.SUM, self._group)
        scale = self.clip_norm / torch.clamp_min(torch.sqrt(total[0]),
                                                 self.clip_norm)
        out = []
        for p, g in params_grads:
            if g is not None and getattr(p, "need_clip", True):
                g = Tensor._wrap((g._data.float() * scale).to(g._data.dtype))
            out.append((p, g))
        return out


class DygraphShardingOptimizer:
    """Stage-1 sharded optimizer (reference
    dygraph_sharding_optimizer.py:48): the wrapped optimizer updates this
    rank's slices of the parameters (``_shards``)."""

    def __init__(self, optimizer, hcg=None, group=None):
        if group is None and hcg is not None:
            group = hcg.get_sharding_parallel_group()
        self._group = _resolve_group(group)
        self._inner_opt = optimizer
        n, r = _group_size(self._group), _group_rank(self._group)
        params = [p for p in optimizer._parameter_list if not p.stop_gradient]
        self._shards = [_Shard(p, n, r) for p in params]
        by_id = {id(s.p): s.shadow for s in self._shards}
        optimizer._parameter_list = [by_id.get(id(p), p)
                                     for p in optimizer._parameter_list]
        if optimizer._param_groups is not None:
            for g in optimizer._param_groups:
                g["params"] = [by_id.get(id(p), p) for p in g["params"]]
        clip = getattr(optimizer, "_grad_clip", None)
        if clip is not None:
            from ..nn.clip import ClipGradByGlobalNorm, ClipGradByValue
            if isinstance(clip, ClipGradByGlobalNorm):
                optimizer._grad_clip = _GroupGlobalNormClip(clip, self._group)
            elif not isinstance(clip, ClipGradByValue):
                raise NotImplementedError(
                    f"{type(clip).__name__} over sharded parameters: the "
                    "sharding optimizer takes ClipGradByGlobalNorm or "
                    "ClipGradByValue")
        self._grads_sharded = False      # set by GroupShardedStage2
        self._params_sharded = False     # set by GroupShardedStage3
        self._grads_ready = False

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    @torch.no_grad()
    def _shard_grads(self):
        """Stage 1: reduce-scatter each full gradient onto its shadow."""
        if self._grads_sharded or self._grads_ready:
            return
        for s in self._shards:
            g = s.p.grad
            g = g._data if g is not None else torch.zeros(
                s.shape, dtype=s.p._data.dtype, device=s.p._data.device)
            s.shadow.grad = Tensor._wrap(s.reduced_grad(g, self._group))
        self._grads_ready = True

    @torch.no_grad()
    def step(self):
        self._shard_grads()
        self._inner_opt.step()
        if not self._params_sharded:
            for s in self._shards:
                s.p._data.copy_(s.gathered(self._group))
                s.p._version += 1
        self._grads_ready = False

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad()
        for s in self._shards:
            s.p.clear_grad()
        self._grads_ready = False

    clear_gradients = clear_grad

    def minimize(self, loss, *a, **k):
        self.step()

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)


class GroupShardedStage2(Layer):
    """Stage-2 wrapper (reference group_sharded_stage2.py:46): each
    gradient is reduce-scattered onto this rank's slice once backward has
    accumulated it, and the full gradient is freed. Without a sharding
    optimizer the slices are the wrapper's own (``_shards``)."""

    def __init__(self, layer: Layer, optimizer=None, group=None,
                 sync_buffers=False, buffer_max_size=2 ** 23,
                 auto_refresh_trainable=True, device="gpu",
                 dp_group=None):
        super().__init__()
        self._layers = layer
        if isinstance(optimizer, DygraphShardingOptimizer):
            self._group = optimizer._group
            shards = optimizer._shards
            optimizer._grads_sharded = True
        else:
            self._group = _resolve_group(group)
            n, r = _group_size(self._group), _group_rank(self._group)
            shards = [_Shard(p, n, r) for p in layer.parameters()
                      if not p.stop_gradient]
        self._optimizer = optimizer
        self._shards = shards
        self._by_param = {id(s.p): s for s in shards}
        for s in shards:
            s.p._register_backward_hook(self._reduce_grad)

    def _reduce_grad(self, p):
        s = self._by_param[id(p)]

        @torch.no_grad()
        def relay():
            g = p.grad
            if g is None:
                return
            _add_grad(s.shadow, s.reduced_grad(g._data, self._group))
            p.grad = None
            self._after_relay(s)
        # under no_sync the reduce-scatter is deferred to the context's exit:
        # one per parameter per accumulation window, on the accumulated
        # gradient
        C.defer_or_run(("stage2_relay", id(p)), relay)

    def _after_relay(self, s):
        pass

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, *a, **k):
        return self._layers.set_state_dict(*a, **k)

    def parameters(self, *a, **k):
        return self._layers.parameters(*a, **k)

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def get_all_parameters(self):
        """Reference API: make every parameter whole on this rank."""


class GroupShardedStage3(GroupShardedStage2):
    """Stage-3 wrapper (reference group_sharded_stage3.py:85): the
    parameters' storage is freed at wrap time; ``forward`` all-gathers
    them from the shadows and each is freed again once its gradient has
    been reduce-scattered."""

    def __init__(self, layer: Layer, optimizer=None, group=None,
                 sync_buffers=False, device="gpu", segment_size=2 ** 20,
                 pertrain_sync_models=True, offload=False, sync_comm=False,
                 dp_group=None, exclude_layer=None):
        super().__init__(layer, optimizer=optimizer, group=group,
                         sync_buffers=sync_buffers, dp_group=dp_group)
        if isinstance(optimizer, DygraphShardingOptimizer):
            optimizer._params_sharded = True
        for s in self._shards:
            self._free(s)

    @staticmethod
    def _free(s):
        a = s.p._data
        a.data = torch.empty(0, dtype=a.dtype, device=a.device)

    def _after_relay(self, s):
        self._free(s)

    @torch.no_grad()
    def get_all_parameters(self):
        for s in self._shards:
            if s.p._data.numel() != s.numel:
                s.p._data.data = s.gathered(self._group)

    def forward(self, *inputs, **kwargs):
        self.get_all_parameters()
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *a, **k):
        self.get_all_parameters()
        return self._layers.state_dict(*a, **k)


class GroupShardedScaler:
    """Reference group_sharded_utils.GroupShardedScaler over a GradScaler:
    the gradients are sharded before they are unscaled, and found_inf is
    the OR over the group (each rank checks its own slices)."""

    def __init__(self, scaler, group=None):
        self._scaler = scaler
        unscale = scaler._unscale

        def sharded_unscale(optimizer):
            if not scaler._enable or scaler._unscaled:
                return
            if hasattr(optimizer, "_shard_grads"):
                optimizer._shard_grads()
            unscale(optimizer)
            g = getattr(optimizer, "_group", group)
            flag = torch.tensor([float(scaler._found_inf)],
                                device=scaler._scale._data.device)
            C.all_reduce_flat(flag, C.ReduceOp.MAX, g)
            scaler._found_inf = bool(flag[0])
        scaler._unscale = sharded_unscale

    def __getattr__(self, item):
        return getattr(self._scaler, item)


def group_sharded_parallel(model, optimizer, level, scaler=None,
                           group=None, offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """reference group_sharded.py:33 — wrap (model, optimizer, scaler)
    for ZeRO level 'os' | 'os_g' | 'p_g_os'."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be one of 'os', 'os_g', 'p_g_os'")
    optimizer = DygraphShardingOptimizer(optimizer, group=group)
    if level == "os_g":
        model = GroupShardedStage2(model, optimizer, group=group,
                                   sync_buffers=sync_buffers,
                                   buffer_max_size=buffer_max_size,
                                   dp_group=dp_group)
    elif level == "p_g_os":
        model = GroupShardedStage3(model, optimizer, group=group,
                                   sync_buffers=sync_buffers,
                                   segment_size=segment_size,
                                   offload=offload, sync_comm=sync_comm,
                                   dp_group=dp_group,
                                   exclude_layer=exclude_layer)
    if scaler is not None:
        scaler = GroupShardedScaler(scaler, optimizer._group)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """reference group_sharded.py save_group_sharded_model: the full model
    as a plain state_dict (``model.pdmodel``, written by the group's first
    rank) and each rank's optimizer slices (``model.pdopt`` on the first
    rank, ``model.<rank>.pdopt`` on the others)."""
    from ..framework import io as fio

    group = getattr(model, "_group", None)
    if isinstance(model, GroupShardedStage3):
        model.get_all_parameters()
    inner = model._layers if isinstance(model, GroupShardedStage2) else model
    r = _group_rank(group)
    os.makedirs(output, exist_ok=True)
    if r == 0:
        fio.save(inner.state_dict(), os.path.join(output, "model.pdmodel"))
    if optimizer is not None:
        name = "model.pdopt" if r == 0 else f"model.{r}.pdopt"
        fio.save(optimizer.state_dict(), os.path.join(output, name))
