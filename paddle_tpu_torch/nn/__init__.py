"""``paddle.nn`` of the port — counterpart of ``paddle_tpu/nn/__init__.py``:
``Layer`` and its containers, every layer, ``ParamAttr``, the
initializers, gradient clipping, beam-search decoding and
``nn.functional``.  The layers are ``torch.nn.Module``\\ s holding their
parameters on the card (or on the CPU after ``set_device("cpu")``):
see ``nn/layer/base.py``."""
from .layer.base import (  # noqa: F401
    Layer, LayerList, Sequential, ParameterList,
)
from .layer.common import (  # noqa: F401
    Identity, Linear, Embedding, Dropout, Dropout2D, Dropout3D,
    AlphaDropout, Flatten, Upsample, UpsamplingNearest2D,
    UpsamplingBilinear2D, Pad1D, Pad2D, Pad3D, ZeroPad2D, PixelShuffle,
    PixelUnshuffle, CosineSimilarity, Bilinear, Unfold,
)
from .layer.conv import (  # noqa: F401
    Conv1D, Conv2D, Conv3D, Conv1DTranspose, Conv2DTranspose,
    Conv3DTranspose,
)
from .layer.pooling import (  # noqa: F401
    MaxPool1D, MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D, AvgPool3D,
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
)
from .layer.scan import ScanLayers  # noqa: F401
from .layer.norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, SyncBatchNorm,
    LayerNorm, GroupNorm, InstanceNorm1D, InstanceNorm2D, InstanceNorm3D,
    LocalResponseNorm, SpectralNorm,
)
from .layer.activation import (  # noqa: F401
    ReLU, ReLU6, Sigmoid, Tanh, Softsign, Tanhshrink, LogSigmoid, Silu,
    Mish, Hardswish, Swish, GELU, LeakyReLU, ELU, CELU, SELU, Hardtanh,
    Hardsigmoid, Hardshrink, Softshrink, Softplus, ThresholdedReLU,
    Softmax, LogSoftmax, PReLU, Maxout,
)
from .layer.loss import (  # noqa: F401
    CrossEntropyLoss, MSELoss, L1Loss, NLLLoss, BCELoss, BCEWithLogitsLoss,
    KLDivLoss, SmoothL1Loss, MarginRankingLoss, CTCLoss,
    HingeEmbeddingLoss, CosineEmbeddingLoss, TripletMarginLoss,
    PairwiseDistance, HSigmoidLoss, NCELoss,
)
from .layer.rnn import (  # noqa: F401
    SimpleRNN, LSTM, GRU, LSTMCell, GRUCell, SimpleRNNCell,
    RNNCellBase, RNN, BiRNN,
)
from .decode import BeamSearchDecoder, dynamic_decode  # noqa: F401
from .layer.transformer import (  # noqa: F401
    MultiHeadAttention, TransformerEncoderLayer, TransformerEncoder,
    TransformerDecoderLayer, TransformerDecoder, Transformer,
)
from .param_attr import ParamAttr  # noqa: F401
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByNorm, ClipGradByValue, ClipGradByGlobalNorm, clip_grad_norm_,
)
from . import utils  # noqa: F401

# submodule aliases matching the reference layout
from .functional import common, conv, loss, norm, extension  # noqa: F401
from .layer import rnn  # noqa: F401
from .layer import common as _layer_common  # noqa: F401
from . import utils as weight_norm_hook  # noqa: F401
vision = extension  # noqa: F401  (the JAX package's alias)
