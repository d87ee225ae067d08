"""paddle.nn: the port of ``paddle_tpu/nn``."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .layer.layers import (  # noqa: F401
    Layer, LayerDict, LayerList, ParamAttr, ParameterList, Sequential,
)
from .layer.common import (  # noqa: F401
    AlphaDropout, Bilinear, ChannelShuffle, CosineSimilarity, Dropout,
    Dropout2D, Dropout3D, Embedding, Flatten, Fold, Identity, Linear,
    Pad1D, Pad2D, Pad3D, PixelShuffle, PixelUnshuffle, Unfold, Upsample,
    UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm, SyncBatchNorm,
)
from .layer.pooling import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D,
)
from .layer.activation import (  # noqa: F401
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, Sigmoid, Silu, Softmax, Softplus, Softshrink, Softsign,
    Swish, Tanh, Tanhshrink, ThresholdedReLU,
)
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .layer.rnn import (  # noqa: F401
    BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .layer.loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CTCLoss, CosineEmbeddingLoss,
    CrossEntropyLoss, HingeEmbeddingLoss, HuberLoss, KLDivLoss, L1Loss,
    MSELoss, MarginRankingLoss, MultiLabelSoftMarginLoss, NLLLoss,
    SmoothL1Loss, SoftMarginLoss, TripletMarginLoss,
)
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
    clip_grad_value_,
)
from . import utils  # noqa: F401
from . import quant  # noqa: F401

from ..core.tensor import Parameter  # noqa: F401


def initializer_set(*a, **k):
    pass


from .layer.extended import (  # noqa: F401,E402
    AdaptiveLogSoftmaxWithLoss, BeamSearchDecoder, FeatureAlphaDropout,
    FractionalMaxPool2D, FractionalMaxPool3D, GaussianNLLLoss,
    HSigmoidLoss, LPPool1D, LPPool2D, MaxUnPool1D, MaxUnPool2D,
    MaxUnPool3D, MultiMarginLoss, PairwiseDistance, PoissonNLLLoss,
    RNNTLoss, Softmax2D, TripletMarginWithDistanceLoss, Unflatten,
    ZeroPad1D, ZeroPad3D, dynamic_decode,
)
