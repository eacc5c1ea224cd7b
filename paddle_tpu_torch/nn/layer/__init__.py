"""Layers of the port — counterpart of ``paddle_tpu/nn/layer``: ``Layer``
and its containers, the activation, common, conv, pooling, norm, loss,
RNN and transformer layers, and ``ScanLayers``."""
from .base import (Layer, LayerList, Sequential,  # noqa: F401
                   ParameterList, HookRemoveHelper, torch_attributes,
                   torch_named_parameters, torch_parameters,
                   torch_named_buffers, torch_buffers, torch_state_dict)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D)
from .scan import ScanLayers, owner_of  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
from . import (activation, common, conv, loss, norm, pooling,  # noqa: F401
               rnn, transformer)
