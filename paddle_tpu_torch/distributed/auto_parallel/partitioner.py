"""The generic-model partitioner: the port of
``paddle_tpu/distributed/auto_parallel/partitioner.py`` (``annotate_tp``,
``find_pipeline_blocks``, ``PipelinePartition``).

Tensor parallelism (``annotate_tp``). The reference annotates the
parameters of any model's Linear and Embedding layers with mp-axis
shardings and lets GSPMD propagate them and insert the collectives. Here
each rank of the mp group keeps its slice of those parameters and the
layer's forward gets the collectives that make its output the unsharded
one, Megatron's way (fleet's mp layers): a Linear whose output features
divide by tp is column-parallel (a pvary'd input times this rank's columns
plus its bias, all-gathered on the feature dim), else one whose input
features divide is row-parallel (this rank's slice of the input times its
rows, psum'd, plus the bias); an Embedding whose width divides is split on
it (this rank's columns looked up, all-gathered). Every rank computes the
same output, so the rest of the model (replicated) needs no change.

The reference stacks the model's homogeneous blocks by stage and compiles
their chain onto its pipelines; the computation before the blocks (the
prologue) and after them (the epilogue and the loss) is cut out of the
model's own forward by shimming the blocks while it runs. Here each rank of
the pp group holds the whole model and runs its stage's blocks through
``parallel.pipeline_1f1b`` over ``torch.distributed`` hops, with the same
shims: block 0 raises to capture the prologue's output, and for the
epilogue every block is the identity but the last, which returns the
pipeline's output. Every rank ends with the gradients of every parameter
(the stages' blocks summed over pp, the prologue's and epilogue's from the
epilogue's sums), so that each rank's optimizer updates the same model.
"""
from __future__ import annotations

from typing import List

import torch

from ...core.tensor import Tensor


def _keep_slice(p, dim, group):
    """``p`` (a Parameter holding the global value) keeps this rank's slice
    along ``dim``."""
    n, r = group.nranks, group.rank
    p._assign_array(p._data.detach().chunk(n, dim)[r].contiguous())
    p.is_distributed = True


def _column_forward(layer, group):
    from ...core.dispatch import run_op
    from .. import collective as C

    def forward(x):
        def f(a, w, *b):
            out = torch.matmul(C._Pvary.apply(a, group), w)
            if b:
                out = out + b[0]
            return C._GatherInvariant.apply(out, group, out.dim() - 1)
        args = (x, layer.weight) + ((layer.bias,)
                                    if layer.bias is not None else ())
        return run_op("column_parallel_linear", f, *args)
    return forward


def _row_forward(layer, group):
    from ...core.dispatch import run_op
    from .. import collective as C

    def forward(x):
        def f(a, w, *b):
            out = torch.matmul(C._Split.apply(a, group, a.dim() - 1), w)
            out = C._Psum.apply(out, group)
            return out + b[0] if b else out
        args = (x, layer.weight) + ((layer.bias,)
                                    if layer.bias is not None else ())
        return run_op("row_parallel_linear", f, *args)
    return forward


def _embedding_forward(layer, group):
    import torch.nn.functional as F
    from ...core.dispatch import run_op
    from .. import collective as C
    pad = getattr(layer, "_padding_idx", None)

    def forward(x):
        def f(ids, w):
            out = F.embedding(ids, w, pad)
            return C._GatherInvariant.apply(out, group, out.dim() - 1)
        return run_op("embedding_tp", f, x, layer.weight)
    return forward


def annotate_tp(model, mesh, axis: str = "mp"):
    """Shards the Linear and Embedding parameters of any model over the mp
    axis of ``mesh`` (a ProcessMesh, or the mp Group itself): column-
    parallel where the output features divide by tp, else row-parallel
    where the input features do; Embeddings on their width. Each rank keeps
    its slices (the model must hold the same global parameters on every
    rank of the group) and the layers' forwards get their collectives, so
    the model's output is the unsharded one. Returns the number of
    parameters sharded, as the reference's does."""
    from ...nn.layer.common import Embedding, Linear
    from ..env import Group
    group = mesh if isinstance(mesh, Group) else mesh.get_group(axis)
    tp = group.nranks
    if tp <= 1:
        return 0
    n = 0
    for _, sub in model.named_sublayers():
        if isinstance(sub, Linear):
            din, dout = sub.weight.shape
            if dout % tp == 0:
                _keep_slice(sub.weight, 1, group)
                if sub.bias is not None:
                    _keep_slice(sub.bias, 0, group)
                    n += 1
                sub.__dict__["forward"] = _column_forward(sub, group)
            elif din % tp == 0:
                _keep_slice(sub.weight, 0, group)
                sub.__dict__["forward"] = _row_forward(sub, group)
            else:
                continue
            n += 1
        elif isinstance(sub, Embedding):
            if sub.weight.shape[1] % tp == 0:
                _keep_slice(sub.weight, 1, group)
                sub.__dict__["forward"] = _embedding_forward(sub, group)
                n += 1
    return n


def _signature(layer):
    return tuple((n, tuple(p.shape)) for n, p in layer.named_parameters())


def find_pipeline_blocks(model):
    """The dominant homogeneous LayerList: the one with >= 2 children whose
    parameters match in names and shapes, holding the most parameters.
    Returns the list of block Layers, or None."""
    from ...nn.layer.layers import LayerList, Sequential
    best, best_size = None, 0
    for _, sub in model.named_sublayers():
        if not isinstance(sub, (LayerList, Sequential)):
            continue
        children = list(sub)
        if len(children) < 2:
            continue
        sigs = [_signature(c) for c in children]
        if any(s != sigs[0] for s in sigs[1:]):
            continue
        size = sum(int(torch.Size(shape).numel()) for _, shape in sigs[0]) \
            * len(children)
        if size > best_size:
            best, best_size = children, size
    return best


def _wrap(a):
    """A Tensor over ``a`` that keeps its autograd graph."""
    return Tensor._wrap(a, stop_gradient=not a.requires_grad)


class _BlockCapture(Exception):
    def __init__(self, value):
        self.value = value


class _Rebound:
    """Parameters' storage temporarily replaced by given torch tensors (the
    reference's ``p._data = a``), restored on exit."""

    def __init__(self, params, arrays):
        self.params, self.arrays = params, arrays

    def __enter__(self):
        self.saved = [p._data for p in self.params]
        for p, a in zip(self.params, self.arrays):
            p._data = a

    def __exit__(self, *exc):
        for p, s in zip(self.params, self.saved):
            p._data = s


class PipelinePartition:
    """The pp execution plan for one model: its blocks split into the
    stages of ``pp_schedule`` ("1f1b", "zbh1" or "zbvpp") over the pp
    ``group``, and the shims that cut out the prologue and the epilogue."""

    def __init__(self, model, loss_fn, blocks, group, pp: int,
                 microbatches: int, pp_schedule: str = "1f1b", tp: int = 1):
        if len(blocks) % pp:
            raise ValueError(
                f"{len(blocks)} pipeline blocks not divisible by "
                f"pp={pp}")
        if pp_schedule not in ("1f1b", "zbh1", "zbvpp"):
            raise ValueError(
                f"partitioner pp_schedule must be '1f1b', 'zbh1' or "
                f"'zbvpp', got {pp_schedule!r}")
        if pp_schedule in ("zbh1", "zbvpp") and tp > 1:
            raise ValueError(
                f"pp_schedule={pp_schedule!r} requires a "
                "collective-free stage "
                "body (tp=1): the zero-bubble phases are cond-gated "
                "per stage and GSPMD tp collectives inside a cond "
                "branch deadlock the mesh (gpt_hybrid."
                "_validate_pp_schedule has the full diagnosis)")
        if pp_schedule == "zbvpp" and len(blocks) % (2 * pp):
            raise ValueError(
                f"{len(blocks)} pipeline blocks not divisible by "
                f"2*pp={2 * pp} (pp_schedule='zbvpp' splits the chain "
                "into 2*pp V-placed chunks)")
        self.model = model
        self.loss_fn = loss_fn
        self.blocks = list(blocks)
        self.group = group
        self.pp = pp
        self.pp_schedule = pp_schedule
        self.microbatches = microbatches
        self.block_params = [[p for _, p in b.named_parameters()]
                             for b in self.blocks]
        block_ids = {id(p) for ps in self.block_params for p in ps}
        self.other_params = [p for _, p in model.named_parameters()
                             if id(p) not in block_ids]

    # -- shims ---------------------------------------------------------
    def _run_with_shims(self, shims: dict, x):
        """Runs model.forward with selected blocks' forwards replaced."""
        saved = []
        try:
            for b, fn in shims.items():
                saved.append((b, b.__dict__.get("forward")))
                b.__dict__["forward"] = fn
            return self.model(x)
        finally:
            for b, fwd in saved:
                if fwd is None:
                    b.__dict__.pop("forward", None)
                else:
                    b.__dict__["forward"] = fwd

    def prologue(self, x):
        """What the model computes before block 0: (block 0's input, its
        extra positional args, its extra keyword args)."""
        def capture(inp, *a, **k):
            raise _BlockCapture((inp, a, k))
        try:
            self._run_with_shims({self.blocks[0]: capture}, x)
        except _BlockCapture as c:
            return c.value
        raise RuntimeError(
            "pipeline blocks were not reached by model.forward — the "
            "LayerList is not on the forward path")

    def epilogue_loss(self, y, x_probe, labels):
        """What the model computes after the last block, and the loss, on
        ``y``: the blocks are the identity and the last returns ``y``."""
        shims = {b: (lambda inp, *a, **k: inp) for b in self.blocks}
        shims[self.blocks[-1]] = lambda inp, *a, **k: y
        out = self._run_with_shims(shims, x_probe)
        if self.loss_fn is not None:
            return self.loss_fn(out, labels)
        return out

    # -- the stages ----------------------------------------------------
    def _schedule(self):
        from ...parallel import pipeline_1f1b as P1
        n, m = self.pp, self.microbatches
        return {"1f1b": P1.compiled_1f1b_schedule,
                "zbh1": P1.compiled_zbh1_schedule,
                "zbvpp": P1.compiled_zbvpp_schedule}[self.pp_schedule](n, m)

    def _chunk_blocks(self, sched, stage) -> List[List[int]]:
        """The block indices of each of ``stage``'s chunks."""
        nv = self.pp * sched.n_chunks
        per = len(self.blocks) // nv
        out = []
        for c in range(sched.n_chunks):
            vi = sched.virtual_index(stage, c)
            out.append(list(range(vi * per, (vi + 1) * per)))
        return out

    def train_grads(self, x, labels):
        """Forward and backward through the prologue, this rank's stage of
        the pipeline and the epilogue and loss: sets ``.grad`` on every
        parameter of the model (accumulating, as backward does) and returns
        the loss (a Tensor), the same on every rank of the pp group."""
        from ...distributed import collective as C
        from ...parallel import pipeline_1f1b as P1
        m = self.microbatches
        sched = self._schedule()
        stage = self.group.rank
        xd = x._data if isinstance(x, Tensor) else x
        ld = labels._data if isinstance(labels, Tensor) else labels
        b = xd.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by "
                             f"microbatches={m}")
        # the prologue, differentiable in the other parameters
        leaves = [p._data.detach().requires_grad_(True)
                  for p in self.other_params]
        with torch.enable_grad(), _Rebound(self.other_params, leaves):
            h0, extra, kw = self.prologue(Tensor._wrap(xd))
        if any(isinstance(v, Tensor) for v in list(extra) + list(kw.values())):
            raise NotImplementedError(
                "the port's pipeline partitioner takes blocks with one "
                "tensor input; tensor side inputs of the blocks are not "
                "supported")
        h0d = h0._data
        mb = h0d.detach().reshape((m, b // m) + tuple(h0d.shape[1:]))
        x_mb = xd.reshape((m, b // m) + tuple(xd.shape[1:]))
        lbl_mb = ld.reshape((m, b // m) + tuple(ld.shape[1:]))
        chunks = self._chunk_blocks(sched, stage)

        def tree(idx):
            return {f"{i:04d}.{j:04d}": p._data for i in idx
                    for j, p in enumerate(self.block_params[i])}

        def stage_fn(params, h):
            arrays = [params[f"{i:04d}.{j:04d}"] for i in idx_of(params)
                      for j in range(len(self.block_params[i]))]
            ps = [p for i in idx_of(params) for p in self.block_params[i]]
            with _Rebound(ps, arrays):
                out = _wrap(h)
                for i in idx_of(params):
                    out = self.blocks[i](out, *extra, **kw)
            return out._data

        def idx_of(params):
            return sorted({int(k.split(".")[0]) for k in params})

        def last_grad(y, hp, mb_idx):
            arrs = [hp[f"{i:04d}"].detach().requires_grad_(True)
                    for i in range(len(self.other_params))]
            yg = y.detach().requires_grad_(True)
            with torch.enable_grad(), _Rebound(self.other_params, arrs):
                loss = self.epilogue_loss(
                    _wrap(yg), _wrap(x_mb[mb_idx]),
                    _wrap(lbl_mb[mb_idx]))._data / m
            g = torch.autograd.grad(loss, [yg] + arrs, allow_unused=True)
            gh = {f"{i:04d}": (d if d is not None else torch.zeros_like(a))
                  for i, (d, a) in enumerate(zip(g[1:], arrs))}
            return loss.detach(), g[0], gh

        head = {f"{i:04d}": p._data for i, p in
                enumerate(self.other_params)}
        loss, grads, hgrads, dx0 = P1.pipeline_train_chunks(
            sched, stage_fn, [tree(idx) for idx in chunks], mb, last_grad,
            head, self.group)
        # the prologue's backward from dx0 (the same on every rank)
        pg = torch.autograd.grad(h0d, leaves,
                                 dx0.reshape(h0d.shape).to(h0d.dtype),
                                 allow_unused=True)
        for i, p in enumerate(self.other_params):
            g = hgrads[f"{i:04d}"].to(torch.float32)
            if pg[i] is not None:
                g = g + pg[i].float()
            self._acc_grad(p, g)
        # every stage's blocks, summed over pp (zeros where not held)
        own = {}
        for idx, g in zip(chunks, grads):
            for i in idx:
                for j, p in enumerate(self.block_params[i]):
                    own[id(p)] = g[f"{i:04d}.{j:04d}"]
        allp = [p for ps in self.block_params for p in ps]
        flat = torch.cat([own[id(p)].reshape(-1).float() if id(p) in own
                          else torch.zeros(p._data.numel(),
                                           device=p._data.device)
                          for p in allp])
        C.all_reduce_flat(flat, C.ReduceOp.SUM, self.group)
        off = 0
        for p in allp:
            n = p._data.numel()
            self._acc_grad(p, flat[off:off + n].view(p._data.shape))
            off += n
        return Tensor._wrap(loss)

    @staticmethod
    def _acc_grad(p, g):
        g = g.to(p._data.dtype)
        if p.grad is None:
            p.grad = Tensor._wrap(g.clone())
        else:
            p.grad = Tensor._wrap(p.grad._data + g)
