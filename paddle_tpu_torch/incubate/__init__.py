"""paddle.incubate on the port: the port of ``paddle_tpu/incubate``
(reference python/paddle/incubate): ``nn`` (the fused functions,
``identity_loss``, ``FusedLinear``), ``asp``, ``autograd``, ``optimizer``
(``LookAhead``, ``ModelAverage``), ``operators`` (the legacy graph ops),
``multiprocessing``, ``jit``'s ``inference`` decorator and
``distributed.models.moe``, with the reference's top-level names."""
from . import asp  # noqa: F401
from . import autograd  # noqa: F401
from . import distributed  # noqa: F401
from . import jit  # noqa: F401
from . import multiprocessing  # noqa: F401
from . import nn  # noqa: F401
from . import operators  # noqa: F401
from . import optimizer  # noqa: F401
from ..geometric import (  # noqa: F401
    segment_max, segment_mean, segment_min, segment_sum,
)
from ..ops.extra import (  # noqa: F401
    fused_softmax_mask as softmax_mask_fuse,
    fused_softmax_mask_upper_triangle as softmax_mask_fuse_upper_triangle,
)
from .jit import inference  # noqa: F401
from .nn.loss import identity_loss  # noqa: F401
from .operators import (  # noqa: F401
    graph_khop_sampler, graph_reindex, graph_sample_neighbors,
    graph_send_recv,
)
from .optimizer import LookAhead, ModelAverage  # noqa: F401

__all__ = [
    'LookAhead', 'ModelAverage', 'graph_khop_sampler', 'graph_reindex',
    'graph_sample_neighbors', 'graph_send_recv', 'identity_loss',
    'inference', 'segment_max', 'segment_mean', 'segment_min',
    'segment_sum', 'softmax_mask_fuse',
    'softmax_mask_fuse_upper_triangle',
]
