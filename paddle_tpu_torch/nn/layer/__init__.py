"""Layers of the port that have no torch counterpart: ``ScanLayers`` and
the transformer encoder layers."""
from .scan import ScanLayers, owner_of  # noqa: F401
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)
