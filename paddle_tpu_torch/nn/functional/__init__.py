"""Functionals of the port: attention, losses, and linear / layer norm /
gelu with their amp sites."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (apply_layer_norm, apply_linear, gelu,  # noqa: F401
                     linear)
from .loss import cross_entropy, fused_linear_cross_entropy  # noqa: F401
