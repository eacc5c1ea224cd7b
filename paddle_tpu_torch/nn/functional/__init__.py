"""Functionals of the port: attention, losses, and linear / embedding /
layer norm / matmul and the activations with their amp sites."""
from .attention import (scaled_dot_product_attention,  # noqa: F401
                        scaled_dot_product_attention_masked)
from .common import (apply_layer_norm, apply_linear, embedding,  # noqa: F401
                     gelu, linear, matmul, softmax, tanh)
from .loss import (cross_entropy, fused_linear_cross_entropy,  # noqa: F401
                   vocab_parallel_linear_cross_entropy)
