"""``paddle.nn.functional`` of the port — counterpart of
``paddle_tpu/nn/functional/__init__.py``: every functional that file
exports except the fluid-era ``legacy`` surface and the detection
aliases of ``vision.ops``, which later slices port.  Each takes torch tensors (and returns them) or
tensor-layer handles (and returns handles): ``_io``."""
import numpy as np

from .activation import (  # noqa: F401
    relu, relu6, sigmoid, tanh, silu, mish, softsign, tanhshrink,
    log_sigmoid, gelu, leaky_relu, elu, celu, selu, hardtanh, hardsigmoid,
    hardswish, swish, hardshrink, softshrink, softplus, thresholded_relu,
    softmax, log_softmax, prelu, glu, maxout, gumbel_softmax,
)
from .common import (  # noqa: F401
    linear, apply_linear, apply_layer_norm, matmul, dropout, dropout2d,
    dropout3d, alpha_dropout, embedding, one_hot, pad, zeropad2d,
    pixel_shuffle, pixel_unshuffle, interpolate, upsample, unfold,
    label_smooth, sequence_mask, cosine_similarity, class_center_sample,
)
from .conv import (  # noqa: F401
    conv1d, conv2d, conv3d,
    conv1d_transpose, conv2d_transpose, conv3d_transpose,
)
from .pooling import (  # noqa: F401
    max_pool1d, max_pool2d, max_pool3d,
    avg_pool1d, avg_pool2d, avg_pool3d,
    adaptive_avg_pool1d, adaptive_avg_pool2d, adaptive_avg_pool3d,
    adaptive_max_pool1d, adaptive_max_pool2d, adaptive_max_pool3d,
)
from .norm import (  # noqa: F401
    batch_norm, layer_norm, instance_norm, group_norm, normalize,
    local_response_norm,
)
from .loss import (  # noqa: F401
    cross_entropy, softmax_with_cross_entropy, binary_cross_entropy,
    binary_cross_entropy_with_logits, sigmoid_focal_loss, mse_loss,
    l1_loss, smooth_l1_loss, nll_loss, kl_div, margin_ranking_loss,
    hinge_embedding_loss, cosine_embedding_loss, triplet_margin_loss,
    ctc_loss, square_error_cost, log_loss, fused_linear_cross_entropy,
    vocab_parallel_linear_cross_entropy,
)
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        scaled_dot_product_attention_masked)
from .sequence import (  # noqa: F401
    sequence_pad, sequence_unpad, sequence_pool, sequence_softmax,
    sequence_expand, sequence_reverse, edit_distance, row_conv,
    sequence_first_step, sequence_last_step, sequence_concat,
    sequence_expand_as, sequence_slice, sequence_scatter,
    sequence_enumerate, sequence_reshape, sequence_conv,
    sequence_erase, sequence_topk_avg_pooling,
)
from .extension import (  # noqa: F401
    grid_sample, diag_embed, gather_tree, bilinear,
    bilinear_tensor_product, dice_loss, npair_loss, affine_grid,
    linear_chain_crf, viterbi_decode, add_position_encoding,
    pad_constant_like, fsp_matrix, im2sequence, hash,
)
from . import common, conv, extension, loss, norm, pooling  # noqa: F401
from . import activation, attention, sequence  # noqa: F401

# -- fluid-era functional aliases ------------------------------------------
from .common import interpolate as image_resize  # noqa: F401
from .common import pad as pad2d  # noqa: F401
from ...ops.math import erf  # noqa: F401
from ...ops.compat_ops import tanh_  # noqa: F401
from ...ops.compat_ops import (  # noqa: F401
    array_length, array_read, array_write, create_array)
from ...core.selected_rows import get_tensor_from_selected_rows  # noqa: F401
from ._io import api as _api


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, ceil_mode=False,
           exclusive=True, data_format="NCHW", name=None):
    """fluid's ``pool2d``."""
    if global_pooling:
        fn = adaptive_max_pool2d if pool_type == "max" \
            else adaptive_avg_pool2d
        return fn(input, output_size=1)
    if pool_type == "max":
        return max_pool2d(input, kernel_size=pool_size, stride=pool_stride,
                          padding=pool_padding, ceil_mode=ceil_mode,
                          data_format=data_format)
    return avg_pool2d(input, kernel_size=pool_size, stride=pool_stride,
                      padding=pool_padding, ceil_mode=ceil_mode,
                      exclusive=exclusive, data_format=data_format)


def warpctc(input, label, blank=0, norm_by_times=False,
            input_length=None, label_length=None):
    """fluid's ``warpctc``: the per-sequence CTC loss."""
    return ctc_loss(input, label, input_length, label_length, blank=blank,
                    reduction="none")


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """The hierarchical sigmoid over the default complete binary tree
    with the given ``weight [num_classes - 1, feature]`` and ``bias``
    (custom ``path_table`` / ``path_code`` trees are not supported)."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid_loss custom trees (path_table/path_code) are not "
            "supported — use the default complete-binary tree")
    from ..layer.loss import hsigmoid
    return hsigmoid(input, label, num_classes, weight, bias)


# -- eager forms of the static builders ------------------------------------
def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None):
    """fluid's ``fc``: ``x`` (its dims from ``num_flatten_dims`` flattened)
    times a new Xavier-uniform ``[in, size]`` weight, plus a zero bias,
    then ``activation``; the parameters are made on the current place at
    each call, as the JAX package's eager ``static.nn.fc`` makes them."""
    from .. import initializer as I
    from ..layer.base import Layer
    maker = Layer("fc")
    in_dim = int(np.prod(x.shape[num_flatten_dims:]))
    w = maker.create_parameter([in_dim, size], attr=weight_attr,
                               default_initializer=I.XavierUniform())
    b = None if bias_attr is False else maker.create_parameter(
        [size], attr=bias_attr, is_bias=True)
    out = _api(lambda a: a.reshape(list(a.shape[:num_flatten_dims])
                                  + [in_dim]))(x)
    out = linear(out, w, b)
    return globals()[activation](out) if activation else out


def data_norm(input, act=None, epsilon=1e-5, param_attr=None, name=None,
              **kwargs):
    """fluid's ``data_norm`` as the JAX package serves it: batch norm with
    the fresh accumulated statistics (mean 0, variance 1, scale 1, shift
    0) in inference mode."""
    out = _api(lambda x: x / (1.0 + epsilon) ** 0.5)(input)
    return globals()[act](out) if act else out


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=10, name=None,
        sampler="uniform", custom_dist=None, seed=0, is_sparse=False):
    """fluid's ``nce`` through a new ``NCELoss`` layer."""
    from ..layer.loss import NCELoss
    return NCELoss(input.shape[-1], num_total_classes,
                   num_neg_samples=num_neg_samples, sampler=sampler)(
        input, label)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """fluid's ``spectral_norm`` through a new ``SpectralNorm`` layer."""
    from ..layer.norm import SpectralNorm
    return SpectralNorm(list(weight.shape), axis=dim,
                        power_iters=power_iters, epsilon=eps)(weight)


_STEP_COUNTERS = {}


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """A process-global step counter, bumped at each call (an int64
    ``[1]`` handle on the current place)."""
    from ...core.tensor import Tensor
    key = counter_name or "@STEP_COUNTER@"
    val = _STEP_COUNTERS.get(key, begin - step) + step
    _STEP_COUNTERS[key] = val
    return Tensor(np.asarray([val], np.int64))
