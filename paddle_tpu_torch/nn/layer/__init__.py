"""Layers of the port that have no torch counterpart: ``ScanLayers``, the
transformer encoder layers, and the batch-norm layers with Paddle's
conventions."""
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D,  # noqa: F401
                   BatchNorm3D)
from .scan import ScanLayers, owner_of  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
