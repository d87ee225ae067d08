"""The semi-auto parallel API: the port of ``paddle_tpu/distributed/api.py``
(reference: shard_tensor, auto_parallel/api.py:181; reshard, :703;
shard_optimizer, :1512; shard_layer; dtensor_from_fn; DistTensor,
phi/core/distributed/auto_parallel/dist_tensor.h:39).

The reference is one controller over every device: its "DistTensor" is a
jax.Array carrying a NamedSharding, and GSPMD partitions the ops on it. The
port is SPMD, a process a rank, so a distributed tensor is a Tensor whose
array is a ``torch.distributed.tensor.DTensor`` over the ``ProcessMesh``'s
``DeviceMesh``: each rank holds its local piece, and DTensor's sharding
propagation gives an op on distributed tensors its collectives, as GSPMD
does for the reference. Every rank calls these functions with the same
arguments (the global value, where there is one):

- ``shard_tensor`` lays the global value out by ``placements`` (each rank
  keeps its piece; its gradient flows back to the global value, whole on
  every rank); ``Partial`` is refused, as in the reference;
- ``reshard`` redistributes, differentiably within one mesh; to another mesh
  it goes through the global value (broadcast from the first rank of the
  source mesh), outside autograd;
- ``unshard_dtensor``, ``Tensor.numpy()`` and ``item()`` give the global
  value on every rank;
- ``dtensor_from_local`` takes THIS rank's local piece (the reference's
  semantics: its single-controller port cannot express a per-rank piece and
  treats the argument as the global value);
- ``ShardingStage1``/``2``/``3`` given to ``shard_optimizer`` run on the
  port's ``sharding`` module (the optimizer's states over the mesh axis'
  group; like the reference's, stage 2 is stage 1, and stage 3 leaves the
  parameters whole here, see ShardingStage3);
- ``to_static`` -> ``DistModel`` runs eager steps, as the reference's does.
  With every parameter replicated (pure data parallelism), a step runs the
  layer on the parameters' local arrays (so the card's kernels see plain
  tensors) and averages the gradients over the mesh axes the batch is
  sharded on; with a sharded parameter it runs the layer on the distributed
  tensors. The optimizer always updates the local pieces, which is exact for
  an elementwise update.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from ..core.tensor import Parameter, Tensor
from .mesh import (Partial, Placement, ProcessMesh, Replicate, Shard,
                   get_mesh)


# ------------------------------------------------------------------ helpers
def _dt():
    from torch.distributed.tensor import DTensor
    return DTensor


def _is_dt(a) -> bool:
    return isinstance(a, _dt())


#: ProcessMesh of each DeviceMesh made (the DTensors know theirs only)
_MESHES = {}


def _device_mesh(mesh: ProcessMesh):
    dm = mesh.device_mesh
    _MESHES.setdefault(id(dm), mesh)
    return dm


def _torch_placements(placements, mesh: ProcessMesh):
    from torch.distributed.tensor import (Partial as TPartial,
                                          Replicate as TReplicate,
                                          Shard as TShard)
    pls = list(placements) + [Replicate()] * (mesh.ndim - len(placements))
    if len(pls) != mesh.ndim:
        raise ValueError(f"{len(placements)} placements for a "
                         f"{mesh.ndim}-d mesh")
    out = []
    for pl in pls:
        if isinstance(pl, Shard):
            out.append(TShard(pl.get_dim()))
        elif isinstance(pl, Partial):
            out.append(TPartial(pl.reduce_type))
        else:
            out.append(TReplicate())
    return out


def _port_placements(pls):
    out = []
    for pl in pls:
        if pl.is_shard():
            out.append(Shard(pl.dim))
        elif pl.is_partial():
            out.append(Partial(getattr(pl, "reduce_op", "sum")))
        else:
            out.append(Replicate())
    return out


def _refuse_partial(placements):
    for pl in placements:
        if isinstance(pl, Partial):
            raise ValueError(
                "shard_tensor cannot materialize Partial placement; Partial "
                "arises only as an op-output state and is reduced by "
                "reshard()")


def _distribute(a, mesh, placements):
    """``a`` (the global value, the same on every rank) laid out by
    ``placements``: a replicated DTensor redistributed, so the forward keeps
    each rank's piece and the backward all-gathers the gradient."""
    DTensor = _dt()
    from torch.distributed.tensor import Replicate as TReplicate
    dm = _device_mesh(mesh)
    rep = DTensor.from_local(a, dm, [TReplicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(dm, _torch_placements(placements, mesh))


# ------------------------------------------------------------------- API
def shard_tensor(data, mesh: ProcessMesh, placements: Sequence[Placement],
                 dtype=None, place=None, stop_gradient=None) -> Tensor:
    """Lays a tensor out on a mesh with one placement a mesh dim
    (reference api.py:181). A Parameter is laid out in place, as a new
    trainable leaf."""
    if not isinstance(data, Tensor):
        data = Tensor(data, dtype=dtype, place=place)
    _refuse_partial(placements)
    if isinstance(data, Parameter):
        data._assign_array(_distribute(data._data.detach(), mesh,
                                       placements))
        return data
    if not data.stop_gradient:
        from ..core.dispatch import run_op
        out = run_op("shard_tensor",
                     lambda a: _distribute(a, mesh, placements), data,
                     amp=False)
        if stop_gradient is not None:
            out.stop_gradient = stop_gradient
        return out
    return Tensor._wrap(_distribute(data._data, mesh, placements),
                        data.stop_gradient if stop_gradient is None
                        else stop_gradient)


def _cross_mesh(a, mesh, placements):
    """The global value of ``a`` (on its own mesh, or a plain array) laid
    out on ``mesh``: every rank takes it from the first rank of the source
    mesh."""
    from . import collective as C
    from .env import is_initialized
    if _is_dt(a) and is_initialized():
        src = _MESHES.get(id(a.device_mesh))
        first = min(src.process_ids) if src is not None else \
            int(a.device_mesh.mesh.min())
        member = a.device_mesh.get_coordinate() is not None
        full = a.full_tensor().detach() if member else torch.zeros(
            a.shape, dtype=a.dtype, device=a.device)
        full = full.contiguous()
        C.broadcast(full, src=first)
        a = full
    return _distribute(a, mesh, placements)


def reshard(x: Tensor, mesh: ProcessMesh,
            placements: Sequence[Placement]) -> Tensor:
    """Changes placements (reference api.py:703): DTensor's redistribution
    within the mesh (differentiable: the gradient moves back by the
    transpose redistribution), the global value to another mesh."""
    from ..core.dispatch import run_op
    a = x._data
    if _is_dt(a) and _MESHES.get(id(a.device_mesh)) == mesh:
        tpl = _torch_placements(placements, mesh)
        dm = a.device_mesh
        return run_op("reshard", lambda t: t.redistribute(dm, tpl), x,
                      amp=False)
    return run_op("reshard", lambda t: _cross_mesh(t, mesh, placements), x,
                  amp=False)


def dtensor_from_fn(fn, mesh: ProcessMesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def dtensor_from_local(local_tensor, mesh: ProcessMesh, placements):
    """A distributed tensor from THIS rank's piece (reference semantics;
    the global shape assumes even pieces)."""
    _refuse_partial(placements)
    from ..core.dispatch import run_op
    t = local_tensor if isinstance(local_tensor, Tensor) else \
        Tensor(local_tensor)
    dm = _device_mesh(mesh)
    tpl = _torch_placements(placements, mesh)
    return run_op("dtensor_from_local",
                  lambda a: _dt().from_local(a, dm, tpl, run_check=False), t,
                  amp=False)


def unshard_dtensor(dist_tensor):
    """The global value, replicated and dense, on every rank (reference
    auto_parallel/api.py unshard_dtensor); differentiable."""
    from ..core.dispatch import run_op
    if not _is_dt(dist_tensor._data):
        return dist_tensor
    return run_op("unshard_dtensor", lambda a: a.full_tensor(), dist_tensor,
                  amp=False)


# ---- introspection (DistTensor attribute parity) --------------------------
def _tensor_process_mesh(self):
    a = self._data
    if not _is_dt(a):
        return None
    return _MESHES.get(id(a.device_mesh)) or ProcessMesh(
        a.device_mesh.mesh.tolist(),
        dim_names=list(a.device_mesh.mesh_dim_names or []) or None)


def _tensor_placements(self):
    a = self._data
    return _port_placements(a.placements) if _is_dt(a) else None


def _tensor_is_dist(self):
    a = self._data
    return _is_dt(a) and a.device_mesh.size() > 1


Tensor.process_mesh = property(_tensor_process_mesh)
Tensor.placements = property(_tensor_placements)
Tensor.is_dist = _tensor_is_dist


def shard_layer(layer, process_mesh: ProcessMesh, shard_fn=None,
                input_fn=None, output_fn=None):
    """Lays out every parameter of a layer (reference api.py shard_layer):
    ``shard_fn(name, sublayer, mesh)``, by default replicated."""
    if shard_fn is None:
        def shard_fn(name, sublayer, mesh):
            for p in list(sublayer._parameters.values()):
                if p is not None and not _is_dt(p._data):
                    shard_tensor(p, mesh, [Replicate()] * mesh.ndim)
    for name, sub in layer.named_sublayers(include_self=True):
        shard_fn(name, sub, process_mesh)
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda l, inp: input_fn(inp, process_mesh))
    if output_fn is not None:
        layer.register_forward_post_hook(
            lambda l, inp, out: output_fn(out, process_mesh))
    return layer


# ------------------------------------------------------------ optimizer
class ShardingStage1:
    """ZeRO stage 1 over a mesh axis (reference api.py ShardingStage1):
    given to ``shard_optimizer``, the optimizer's states are sharded over
    the ranks along ``axis_name`` of ``mesh`` (the port's
    ``sharding.DygraphShardingOptimizer``, which also averages the
    gradients over them)."""

    def __init__(self, axis_name="dp", mesh=None):
        self.axis_name = axis_name
        self.mesh = mesh

    def group(self):
        mesh = self.mesh or get_mesh()
        if mesh is None:
            raise ValueError(f"{type(self).__name__} needs a mesh (pass "
                             "mesh= or set_mesh first)")
        return mesh.get_group(self.axis_name)


class ShardingStage2(ShardingStage1):
    """ZeRO stage 2 (reference api.py): the optimizer's states sharded as
    ShardingStage1's, as the reference's are (its gradients live inside the
    compiled step); ``sharding.group_sharded_parallel(level="os_g")``
    frees the gradients a rank does not own."""


class ShardingStage3(ShardingStage1):
    """ZeRO stage 3 (reference api.py): the optimizer's states sharded as
    ShardingStage1's; the parameters stay whole on every rank, where the
    reference lays them out over the axis
    (``sharding.group_sharded_parallel(level="p_g_os")`` frees them)."""


class _ShardOptimizer:
    """The optimizer of a distributed layer (reference shard_optimizer
    api.py:1512): it updates each parameter's local piece, in place, from
    its gradient laid out like the parameter; with a ``ShardingStage`` its
    states are sharded over that mesh axis (the port's ``sharding``
    module). Any other ``shard_fn(name, param, accumulator)`` is called on
    the accumulators before each step, as the reference calls it."""

    def __init__(self, optimizer, shard_fn=None):
        self._inner = optimizer
        self._shard_fn = shard_fn
        self._zero = None
        if isinstance(shard_fn, ShardingStage1):
            from .sharding import DygraphShardingOptimizer
            with local_params(optimizer._parameter_list):
                self._zero = DygraphShardingOptimizer(
                    optimizer, group=shard_fn.group())

    def __getattr__(self, item):
        return getattr(self._inner, item)

    @property
    def _active(self):
        return self._zero if self._zero is not None else self._inner

    def _params(self):
        if self._zero is not None:
            return [s.p for s in self._zero._shards]
        return list(self._inner._parameter_list)

    def step(self):
        with local_params(self._params()):
            if self._shard_fn is not None and self._zero is None:
                for name, d in self._inner._accumulators.items():
                    for key, acc in d.items():
                        p = next((p for p in self._inner._parameter_list
                                  if id(p) == key), None)
                        if p is not None:
                            self._shard_fn(name, p, acc)
            self._active.step()

    def clear_grad(self, *a, **k):
        self._active.clear_grad(*a, **k)
        for p in self._params():
            p.clear_grad()

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner.state_dict()

    def set_state_dict(self, state):
        return self._inner.set_state_dict(state)


def shard_optimizer(optimizer, shard_fn=None):
    return _ShardOptimizer(optimizer, shard_fn)


@contextlib.contextmanager
def local_params(params):
    """For the length of the block, each distributed parameter's array is
    its local piece (a trainable leaf sharing the storage) and its gradient
    the local piece of the gradient laid out like it; the distributed
    arrays come back after, with the updated values."""
    swapped = []
    for p in params:
        a = p._data
        if not _is_dt(a):
            continue
        g = a.grad
        local = a._local_tensor.detach().requires_grad_(a.requires_grad)
        if g is not None:
            if _is_dt(g):
                if tuple(g.placements) != tuple(a.placements):
                    g = g.redistribute(a.device_mesh, a.placements)
                g = g._local_tensor
            local.grad = g.detach()
        swapped.append((p, a, p._leaf))
        p._data, p._leaf = local, local
        p._grad_t = None
    try:
        yield
    finally:
        for p, a, leaf in swapped:
            a.grad = None
            p._data, p._leaf = a, leaf
            p._grad_t = None


def shard_dataloader(dataloader, meshes, shard_dims=None, is_dataset=False,
                     input_keys=None):
    """reference shard_dataloader (auto_parallel/api.py:3016): the loader's
    batches (the global batch, the same on every rank) laid out on the mesh,
    split on their first dim over the mesh dim ``shard_dims`` (a name or an
    index; None replicates)."""
    mesh = meshes[0] if isinstance(meshes, (list, tuple)) else meshes

    class _ShardedLoader:
        def __init__(self, dl):
            self._dl = dl

        def __len__(self):
            return len(self._dl)

        def __iter__(self):
            names = list(mesh.dim_names)
            if isinstance(shard_dims, str):
                axis = names.index(shard_dims)
            else:
                axis = None if shard_dims is None else int(shard_dims)

            def place(t):
                if not isinstance(t, Tensor):
                    return t
                pl = [Replicate()] * mesh.ndim
                if axis is not None:
                    pl[axis] = Shard(0)
                return shard_tensor(t, mesh, pl)
            for batch in self._dl:
                if isinstance(batch, (list, tuple)):
                    yield type(batch)(place(b) for b in batch)
                else:
                    yield place(batch)
    return _ShardedLoader(dataloader)


def shard_scaler(scaler):
    """reference shard_scaler: the GradScaler's found-inf reduced over the
    job's ranks (``sharding.GroupShardedScaler``), so every rank skips the
    same steps; unchanged without a process group."""
    from .env import is_initialized
    if not is_initialized():
        return scaler
    from .sharding import GroupShardedScaler
    return GroupShardedScaler(scaler, None)


class Strategy:
    """reference distributed.Strategy (auto_parallel/strategy.py): typed
    config bundle for to_static/DistModel."""

    class _Sub:
        def __init__(self, defaults, overrides):
            self.__dict__.update(defaults)
            self.__dict__.update(overrides)

    def __init__(self, config=None):
        cfg = config or {}
        self.sharding = Strategy._Sub(
            dict(enable=False, degree=1, stage=1), cfg.get("sharding", {}))
        self.fused_passes = Strategy._Sub(
            dict(enable=False, fused_passes_list=[]),
            cfg.get("fused_passes", {}))
        self.gradient_merge = Strategy._Sub(
            dict(enable=False, k_steps=1), cfg.get("gradient_merge", {}))
        self.pipeline = Strategy._Sub(
            dict(enable=False, schedule_mode="1F1B", micro_batch_size=1,
                 accumulate_steps=1), cfg.get("pipeline", {}))
        self.amp = Strategy._Sub(
            dict(enable=False, dtype="float16", level="O1"),
            cfg.get("amp", {}))


def _batch_axes(inputs):
    """(mesh, the mesh dims the inputs' first dim is sharded over)."""
    for t in inputs:
        a = getattr(t, "_data", None)
        if _is_dt(a):
            dims = [i for i, pl in enumerate(a.placements)
                    if pl.is_shard(0)]
            return _MESHES.get(id(a.device_mesh)), dims
    return None, []


class DistModel:
    """reference DistModel (auto_parallel/api.py): the to_static product,
    a train/eval/predict callable over the distributed layer; each call is
    one eager step (see the module docstring)."""

    def __init__(self, layer, loader, loss=None, optimizer=None,
                 strategy=None, metrics=None):
        self.network = layer
        self._loader = loader
        self._loss = loss
        self._opt = optimizer
        self._strategy = strategy or Strategy()
        self._mode = "train"

    def train(self):
        self._mode = "train"
        self.network.train()

    def eval(self):
        self._mode = "eval"
        self.network.eval()

    def predict(self):
        self._mode = "predict"
        self.network.eval()

    def _layer_params(self):
        return list(self.network.parameters())

    def _replicated(self):
        return all(all(pl.is_replicate() for pl in p._data.placements)
                   for p in self._layer_params() if _is_dt(p._data))

    def _inputs(self, inputs, local):
        """Distributed inputs as their local pieces (``local``), or plain
        ones as replicated distributed tensors on the parameters' mesh."""
        out = []
        mesh = next((p.process_mesh for p in self._layer_params()
                     if _is_dt(p._data)), None)
        for t in inputs:
            a = getattr(t, "_data", None)
            if local and _is_dt(a):
                t = Tensor._wrap(a.to_local(), t.stop_gradient)
            elif not local and mesh is not None and \
                    isinstance(t, Tensor) and not _is_dt(a):
                t = shard_tensor(t, mesh, [Replicate()] * mesh.ndim)
            out.append(t)
        return out

    @torch.no_grad()
    def _average(self, tensors, mesh, dims):
        """Averages the arrays in place over the mesh dims ``dims``."""
        from . import collective as C
        if mesh is None or not dims or not tensors:
            return
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        for d in dims:
            C.all_reduce_flat(flat, C.ReduceOp.AVG,
                              mesh.get_group(mesh.dim_names[d]))
        off = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view(t.shape))
            off += n

    def __call__(self, *inputs):
        if self._mode == "predict" or self._loss is None:
            local = self._replicated()
            with local_params(self._layer_params()) if local else \
                    contextlib.nullcontext():
                return self.network(*self._inputs(inputs, local))
        *feats, label = inputs
        mesh, dims = _batch_axes(inputs)
        local = self._replicated()
        params = self._layer_params()
        if self._mode != "train" or self._opt is None:
            from ..autograd import no_grad
            with no_grad(), (local_params(params) if local
                             else contextlib.nullcontext()):
                out = self.network(*self._inputs(feats, local))
                loss = self._loss(out, *self._inputs([label], local))
            if local:
                self._average([loss._data], mesh, dims)
            return loss
        with local_params(params) if local else contextlib.nullcontext():
            out = self.network(*self._inputs(feats, local))
            loss = self._loss(out, *self._inputs([label], local))
            loss.backward()
            if local:
                zero = getattr(self._opt, "_zero", None)
                if zero is None:
                    self._average([p._data.grad for p in params
                                   if p._data.grad is not None], mesh, dims)
                self._average([loss._data], mesh, dims)
            with local_params(params):
                self._opt.step()
                self._opt.clear_grad()
        return loss.detach()

    def state_dict(self, mode="all"):
        return self.network.state_dict()

    def dist_main_program(self, mode=None):
        return None


def to_static(layer, loader=None, loss=None, optimizer=None, strategy=None,
              input_spec=None):
    """reference distributed.to_static (auto_parallel/api.py:2510): the
    layer, loader, loss and optimizer as a DistModel."""
    return DistModel(layer, loader, loss, optimizer, strategy)


class DistAttr:
    """Legacy TensorDistAttr surface (reference base/dist_attr.py
    DistAttr): a (mesh, sharding_specs) pair."""

    def __init__(self, mesh=None, sharding_specs=None):
        self.process_mesh = mesh
        self.sharding_specs = sharding_specs

