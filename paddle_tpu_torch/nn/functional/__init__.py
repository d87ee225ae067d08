"""paddle.nn.functional: the port of ``paddle_tpu/nn/functional``."""
from .activation import *  # noqa: F401,F403
from .common import (  # noqa: F401
    linear, dropout, dropout2d, dropout3d, alpha_dropout, embedding,
    one_hot, normalize, cosine_similarity, label_smooth, pad, interpolate,
    upsample, pixel_shuffle, pixel_unshuffle, channel_shuffle, unfold, fold,
    sequence_mask, bilinear,
)
from .conv import (  # noqa: F401
    conv1d, conv2d, conv3d, conv1d_transpose, conv2d_transpose,
    conv3d_transpose,
)
from .pooling import (  # noqa: F401
    max_pool1d, max_pool2d, max_pool3d, avg_pool1d, avg_pool2d, avg_pool3d,
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
    lp_pool1d, lp_pool2d,
)
from .norm import (  # noqa: F401
    batch_norm, layer_norm, rms_norm, instance_norm, group_norm,
    local_response_norm,
)
from .loss import (  # noqa: F401
    cross_entropy, softmax_with_cross_entropy, nll_loss, mse_loss, l1_loss,
    smooth_l1_loss, huber_loss, binary_cross_entropy,
    binary_cross_entropy_with_logits, kl_div, margin_ranking_loss,
    hinge_embedding_loss, cosine_embedding_loss, triplet_margin_loss,
    multi_label_soft_margin_loss, soft_margin_loss, square_error_cost,
    log_loss, sigmoid_focal_loss, ctc_loss, npair_loss, dice_loss,
)
from .attention import (  # noqa: F401
    scaled_dot_product_attention, flash_attention, flash_attn_unpadded,
)
from .extended import (  # noqa: F401
    pairwise_distance, poisson_nll_loss, gaussian_nll_loss,
    multi_margin_loss, triplet_margin_with_distance_loss, hsigmoid_loss,
    rnnt_loss, adaptive_log_softmax_with_loss, feature_alpha_dropout,
    zeropad2d, max_unpool1d, max_unpool2d, max_unpool3d,
    fractional_max_pool2d, fractional_max_pool3d, affine_grid, grid_sample,
    class_center_sample, sparse_attention, gather_tree, temporal_shift,
    margin_cross_entropy, flash_attn_qkvpacked,
    flash_attn_varlen_qkvpacked, flashmask_attention,
)
