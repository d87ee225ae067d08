"""Fleet: the port of ``paddle_tpu/distributed/fleet/__init__.py`` for
collective parallelism (reference: fleet/fleet.py:151 — fleet.init builds
the HybridCommunicateGroup from the DistributedStrategy; distributed_model
wraps by strategy, fleet/model.py:32; distributed_optimizer wraps with
HybridParallelOptimizer, hybrid_parallel_optimizer.py:258).

Ported: ``dp_degree`` and ``sharding_degree`` (DataParallel over the dp
group, the stage-1 sharding optimizer over the sharding group),
``mp_degree`` and ``sep_degree`` (their groups, in the reference's axis
order pp -> sep -> mp -> sharding -> dp; the tensor-parallel layers of
``mp_layers`` and the sequence-parallel ones of
``sequence_parallel_utils`` over the mp group), ``pp_degree`` (the pipe
group; ``distributed_model`` wraps a ``PipelineLayer`` in
``meta_parallel.PipelineParallel``, whose ``train_batch`` runs the
``pipeline_configs`` schedule), gradient merge and AMP O2 as the strategy
wires them. Parameter-server mode: ``fleet.init(role_maker,
is_collective=False)`` (only with a role maker; without one ``init`` takes
the collective path, as the reference's does), the role makers,
``init_server``/``run_server`` (a ``ps.PsServer`` on ``0.0.0.0`` at the
role's port), ``init_worker``/``stop_worker`` (a ``ps.PsClient`` of the
role's servers), ``UtilBase`` and the MultiSlot data generators.
"""
from __future__ import annotations

import numpy as np

from ...nn.layer.layers import Layer
from ..env import get_rank, get_world_size, init_parallel_env
from ..mesh import set_mesh
from ..parallel import DataParallel
from . import utils  # noqa: F401
from .recompute import recompute, recompute_sequential  # noqa: F401
from .topology import (CommunicateTopology, HybridCommunicateGroup,
                       get_hybrid_communicate_group,
                       set_hybrid_communicate_group)
from . import mp_layers, sequence_parallel_utils  # noqa: F401
from . import meta_parallel, pp_layers, pp_parallel_adaptor  # noqa: F401
from .pp_layers import LayerDesc, PipelineLayer, SharedLayerDesc  # noqa: F401
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                        RowParallelLinear, VocabParallelEmbedding,
                        get_rng_state_tracker, model_parallel_random_seed)
from .sequence_parallel_utils import (  # noqa: F401
    ColumnSequenceParallelLinear, RowSequenceParallelLinear,
    mark_as_sequence_parallel_parameter,
    register_sequence_parallel_allreduce_hooks)
from ..ps import PaddleCloudRoleMaker

__all__ = [
    "init", "DistributedStrategy", "distributed_model",
    "distributed_optimizer", "distributed_scaler",
    "get_hybrid_communicate_group", "Fleet", "recompute",
    "recompute_sequential", "CommunicateTopology",
    "HybridCommunicateGroup", "HybridParallelOptimizer", "worker_num",
    "worker_index", "ColumnParallelLinear", "RowParallelLinear",
    "VocabParallelEmbedding", "ParallelCrossEntropy",
    "get_rng_state_tracker", "ColumnSequenceParallelLinear",
    "RowSequenceParallelLinear", "mark_as_sequence_parallel_parameter",
    "register_sequence_parallel_allreduce_hooks", "LayerDesc",
    "PipelineLayer", "SharedLayerDesc", "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker", "Role", "UtilBase", "MultiSlotDataGenerator",
    "MultiSlotStringDataGenerator", "is_server", "is_worker", "init_server",
    "run_server", "init_worker", "stop_worker",
]

def __getattr__(name):
    if name == "auto":
        # the reference fleet's re-export of distributed.auto_parallel
        from .. import auto_parallel
        return auto_parallel
    if name == "ps_client":
        return _fleet.ps_client
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class Role:
    """reference fleet/base/role_maker.py Role constants."""
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4
    COORDINATOR = 5


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    """reference UserDefinedRoleMaker: the role and ranks given, not read
    from the environment."""

    def __init__(self, is_collective=False, init_gloo=False, **kwargs):
        super().__init__(is_collective=is_collective)
        names = {Role.WORKER: "TRAINER", Role.SERVER: "PSERVER"}
        self._role = names.get(kwargs.get("current_id_role",
                                          kwargs.get("role", Role.WORKER)),
                               "TRAINER")
        if "role" in kwargs:
            self._role = names[kwargs["role"]]
        self._worker_id = int(kwargs.get("current_id", 0))
        self._num_workers = int(kwargs.get("worker_num", 1))
        self._servers = list(kwargs.get("server_endpoints", []))


class UtilBase:
    """reference fleet UtilBase: barrier, all-reduce and file-shard helpers
    for user scripts."""

    def barrier(self, comm_world="worker"):
        from ..env import barrier
        barrier()

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        return np.asarray(input)

    def get_file_shard(self, files):
        return [f for i, f in enumerate(files)
                if i % get_world_size() == get_rank()]


class MultiSlotDataGenerator:
    """reference distributed/fleet/data_generator: a subclass's
    ``generate_sample(line)`` yields samples of (slot_name, values) pairs;
    ``run_from_stdin`` writes them in the MultiSlot text format the data
    feed parses."""

    def generate_sample(self, line):
        raise NotImplementedError

    def _format(self, sample):
        out = []
        for _name, values in sample:
            out.append(str(len(values)))
            out += [str(v) for v in values]
        return " ".join(out)

    def run_from_stdin(self):
        import sys
        for line in sys.stdin:
            gen = self.generate_sample(line)
            for sample in (gen() if callable(gen) else gen):
                sys.stdout.write(self._format(sample) + "\n")


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    pass


class DistributedStrategy:
    """reference fleet/base/distributed_strategy.py:284 (protobuf-backed);
    here a plain config."""

    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.amp = False
        self.amp_configs = {}
        self.recompute = False
        self.recompute_configs = {}
        self.sharding = False
        self.sharding_configs = {}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.gradient_merge = False
        self.gradient_merge_configs = {}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.without_graph_optimization = False


def _amp_dtype_level(strategy):
    cfg = getattr(strategy, "amp_configs", {}) or {}
    level = cfg.get("level") or ("O2" if cfg.get("use_pure_fp16")
                                 or cfg.get("use_pure_bf16") else "O1")
    dtype = cfg.get("dtype") or ("bfloat16" if cfg.get("use_pure_bf16")
                                 else "float16")
    return dtype, level.upper()


class _Fleet:
    def __init__(self):
        self._strategy = None
        self._hcg = None
        self._is_init = False
        self._role_maker = None
        self._ps_server = None
        self._ps_client = None

    def init(self, role_maker=None, is_collective=True, strategy=None,
             log_level="INFO"):
        if role_maker is not None and not is_collective:
            # parameter-server mode (the reference's fleet PS flow); with no
            # role maker the reference takes the collective path below
            self._role_maker = role_maker
            self._strategy = strategy or DistributedStrategy()
            self._is_init = True
            return self
        init_parallel_env()
        self._strategy = strategy or DistributedStrategy()
        hc = self._strategy.hybrid_configs
        dims = {n: int(hc.get(f"{n}_degree", 1))
                for n in ("pp", "sep", "mp", "sharding", "dp")}
        world = get_world_size()
        total = int(np.prod(list(dims.values())))
        if total == 1 and world > 1:
            dims["dp"] = world
            total = world
        if total != world:
            raise ValueError(f"hybrid config {dims} spans {total} ranks; "
                             f"the job has {world}")
        topo = CommunicateTopology(list(dims), list(dims.values()))
        self._hcg = HybridCommunicateGroup(topo)
        set_hybrid_communicate_group(self._hcg)
        set_mesh(self._hcg.process_mesh)
        self._is_init = True
        return self

    @property
    def worker_num(self):
        return get_world_size()

    def worker_index(self):
        return get_rank()

    def is_first_worker(self):
        return get_rank() == 0

    def barrier_worker(self):
        from ..env import barrier
        barrier()

    def get_hybrid_communicate_group(self):
        return self._hcg

    def distributed_model(self, model: Layer):
        """Wrap by strategy (reference fleet/model.py:32): AMP O2 casts the
        parameters when the strategy asks for it; at pp_degree > 1 a
        ``PipelineLayer`` becomes a ``PipelineParallel`` (which averages
        its gradients over dp itself), and one the pipeline cannot split
        passes through with a warning; dp_degree > 1 wraps in DataParallel
        over the dp group. At mp_degree > 1 the model's tensor-parallel
        layers already hold their shards and communicate over the mp group
        (reference :205), so nothing more is wrapped."""
        hcg = self._hcg
        if hcg is None:
            raise RuntimeError("call fleet.init first")
        if getattr(self._strategy, "amp", False):
            dtype, level = _amp_dtype_level(self._strategy)
            if level == "O2":
                from ... import amp
                model = amp.decorate(models=model, level="O2", dtype=dtype)
        if hcg.get_pipe_parallel_world_size() > 1 and \
                isinstance(model, PipelineLayer):
            model.build_pipeline(hcg)
            from .meta_parallel import PipelineParallel, UnpartitionableModel
            try:
                return PipelineParallel(model, hcg, self._strategy)
            except (UnpartitionableModel, NotImplementedError) as e:
                import warnings
                warnings.warn(
                    f"fleet PipelineParallel unavailable for this "
                    f"model ({e}); falling back to the plain wrap path "
                    "(the pipeline layer as-is, DataParallel-wrapped "
                    "when dp_degree > 1 — forward/eval works; use the "
                    "hybrid engine for pipelined training)", stacklevel=2)
        if hcg.get_data_parallel_world_size() > 1:
            model = DataParallel(
                model, group=hcg.get_data_parallel_group(),
                find_unused_parameters=self._strategy.find_unused_parameters)
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        strategy = strategy or self._strategy
        opt = HybridParallelOptimizer(optimizer, self._hcg, strategy)
        if strategy is not None and getattr(strategy, "gradient_merge",
                                            False):
            # reference auto_parallel_gradient_merge pass: k-step
            # accumulation outside the (possibly sharded) update
            from ...optimizer.gradient_merge import GradientMergeOptimizer
            cfgs = getattr(strategy, "gradient_merge_configs", {}) or {}
            return GradientMergeOptimizer(
                opt, k_steps=int(cfgs.get("k_steps", 1)),
                avg=bool(cfgs.get("avg", True)))
        return opt

    def distributed_scaler(self, scaler):
        hcg = self._hcg
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
            from ..sharding import GroupShardedScaler
            return GroupShardedScaler(scaler,
                                      hcg.get_sharding_parallel_group())
        return scaler


    # --------------------------------------------- parameter-server mode
    # (reference fleet.py init_server/run_server/init_worker/stop_worker)
    def is_server(self):
        return self._role_maker is not None and self._role_maker.is_server()

    def is_worker(self):
        return self._role_maker is None or self._role_maker.is_worker()

    def init_server(self, *args, **kwargs):
        from ..ps import PsServer
        rm = self._role_maker
        self._ps_server = PsServer(host="0.0.0.0", port=rm.server_port(),
                                   num_workers=rm.worker_num())

    def run_server(self):
        """Serve until the first worker's ``stop_worker`` stops the
        server."""
        if self._ps_server is None:
            self.init_server()
        self._ps_server.run()

    def init_worker(self, scopes=None):
        from ..ps import PsClient
        self._ps_client = PsClient(self._role_maker.server_endpoints())

    def stop_worker(self):
        if self._ps_client is not None:
            if self._role_maker.is_first_worker():
                self._ps_client.stop_servers()
            self._ps_client.close()
            self._ps_client = None

    @property
    def ps_client(self):
        return self._ps_client


class HybridParallelOptimizer:
    """reference hybrid_parallel_optimizer.py:258: with sharding_degree > 1
    the stage-1 sharding optimizer over the sharding group, else the
    optimizer itself."""

    def __init__(self, optimizer, hcg, strategy):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
            from ..sharding import DygraphShardingOptimizer
            self._inner_opt = DygraphShardingOptimizer(optimizer, hcg=hcg)

    def __getattr__(self, item):
        return getattr(self._inner_opt, item)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, *a, **k):
        self._inner_opt.clear_grad(*a, **k)

    clear_gradients = clear_grad

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, state):
        return self._inner_opt.set_state_dict(state)


Fleet = _Fleet
_fleet = _Fleet()


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    return _fleet.init(role_maker, is_collective, strategy, log_level)


def distributed_model(model):
    return _fleet.distributed_model(model)


def distributed_optimizer(optimizer, strategy=None):
    return _fleet.distributed_optimizer(optimizer, strategy)


def distributed_scaler(scaler):
    return _fleet.distributed_scaler(scaler)


def worker_num():
    return _fleet.worker_num


def worker_index():
    return _fleet.worker_index()


def is_server():
    return _fleet.is_server()


def is_worker():
    return _fleet.is_worker()


def init_server(*args, **kwargs):
    return _fleet.init_server(*args, **kwargs)


def run_server():
    return _fleet.run_server()


def init_worker(scopes=None):
    return _fleet.init_worker(scopes)


def stop_worker():
    return _fleet.stop_worker()
