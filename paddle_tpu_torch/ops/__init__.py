"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it."""
from .ragged_paged_attn import (  # noqa: F401
    ragged_paged_attention, ragged_paged_attention_ref,
)
