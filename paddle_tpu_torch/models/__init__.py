"""Model zoo of the port: the GPT decoder."""
from .gpt import (  # noqa: F401
    GPT_CONFIGS, GPTAttention, GPTBlock, GPTEmbeddings, GPTLMHead, GPTMLP,
    GPTModel, sample_rows,
)
