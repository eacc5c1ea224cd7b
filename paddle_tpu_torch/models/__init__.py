"""Model zoo of the port: the GPT decoder."""
from .gpt import (  # noqa: F401
    GPT_CONFIGS, GPTAttention, GPTBlock, GPTEmbeddings, GPTLMHead, GPTMLP,
    GPTModel, GPTPretrainingCriterion, GPTScanBlocks, packed_doc_inputs,
    sample_rows,
)
