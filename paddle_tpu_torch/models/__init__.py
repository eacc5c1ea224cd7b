"""Model zoo of the port: the GPT decoder and BERT."""
from .bert import (  # noqa: F401
    BERT_CONFIGS, BertEmbeddings, BertForMaskedLM,
    BertForSequenceClassification, BertModel, BertPooler,
    BertPretrainingCriterion,
)
from .gpt import (  # noqa: F401
    GPT_CONFIGS, GPTAttention, GPTBlock, GPTEmbeddings, GPTLMHead, GPTMLP,
    GPTModel, GPTPretrainingCriterion, GPTScanBlocks, packed_doc_inputs,
    gpt_pipe_model, sample_rows,
)
