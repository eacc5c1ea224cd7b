"""Functionals of the port: attention, losses, and linear / layer norm /
matmul and the activations with their amp sites."""
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        scaled_dot_product_attention_masked)
from .common import (apply_layer_norm, apply_linear, gelu,  # noqa: F401
                     linear, matmul, softmax, tanh)
from .loss import (cross_entropy, fused_linear_cross_entropy,  # noqa: F401
                   vocab_parallel_linear_cross_entropy)
