"""Functionals of the port: attention and losses."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .loss import cross_entropy, fused_linear_cross_entropy  # noqa: F401
