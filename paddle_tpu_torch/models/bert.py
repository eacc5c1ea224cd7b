"""BERT — counterpart of ``paddle_tpu/models/bert.py`` (the repo's
``BASELINE.md`` config 3, the BERT-base fine-tune).

Embeddings (word + position + token type, LayerNorm at eps 1e-12,
dropout), a post-LN ``TransformerEncoder`` of exact-GELU layers, the
tanh pooler over the first token, and the heads: sequence
classification and masked LM, with ``BertPretrainingCriterion``.  A
``[B, S]`` 1/0 ``attention_mask`` becomes the additive ``[B, 1, 1, S]``
mask ``(1 - m) * -1e4`` (f32), which the encoder's masked attention adds
to its scores.  Under ``amp.auto_cast`` O1 the linears go to bf16 and
the masked attention, the GELU, the tanh and the norms stay as the JAX
package leaves them (they are on no white list).

No TPU kernel runs on this path: the JAX package computes BERT in
jnp / XLA, and the masked attention never takes the flash kernel.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..nn.functional import apply_layer_norm, apply_linear, cross_entropy
from ..nn.functional import gelu, tanh
from ..nn.layer import TransformerEncoder, TransformerEncoderLayer
from ..nn.layer.common import Linear as PLinear
from ..nn.layer.norm import LayerNorm as PLayerNorm

BERT_CONFIGS = {
    "bert-base": dict(num_layers=12, hidden_size=768, num_heads=12,
                      vocab_size=30522, max_position=512,
                      type_vocab_size=2, intermediate_size=3072),
    "bert-large": dict(num_layers=24, hidden_size=1024, num_heads=16,
                       vocab_size=30522, max_position=512,
                       type_vocab_size=2, intermediate_size=4096),
    "tiny": dict(num_layers=2, hidden_size=64, num_heads=4,
                 vocab_size=128, max_position=64, type_vocab_size=2,
                 intermediate_size=128),
}


class BertEmbeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position,
                 type_vocab_size=2, dropout=0.1):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size)
        self.position_embeddings = nn.Embedding(max_position, hidden_size)
        self.token_type_embeddings = nn.Embedding(type_vocab_size,
                                                  hidden_size)
        self.layer_norm = nn.LayerNorm(hidden_size, eps=1e-12)
        self.dropout = nn.Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None):
        seq = input_ids.shape[-1]
        pos = torch.arange(seq, device=input_ids.device)
        emb = self.word_embeddings(input_ids) + self.position_embeddings(pos)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = emb + self.token_type_embeddings(token_type_ids)
        return self.dropout(apply_layer_norm(self.layer_norm, emb))


class BertPooler(nn.Module):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size)

    def forward(self, hidden_states):
        return tanh(apply_linear(self.dense, hidden_states[:, 0]))


class BertModel(nn.Module):
    """The encoder: ``forward(input_ids, token_type_ids=None,
    attention_mask=None)`` returns ``(sequence output [B, S, E], pooled
    [B, E])`` (the sequence output alone without the pooler)."""

    def __init__(self, num_layers=12, hidden_size=768, num_heads=12,
                 vocab_size=30522, max_position=512, type_vocab_size=2,
                 intermediate_size=3072, dropout=0.1, with_pool=True,
                 scan_layers=False):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden_size,
                                         max_position, type_vocab_size,
                                         dropout)
        enc_layer = TransformerEncoderLayer(
            hidden_size, num_heads, intermediate_size, dropout=dropout,
            activation="gelu")
        self.encoder = TransformerEncoder(enc_layer, num_layers,
                                          scan_layers=scan_layers)
        self.pooler = BertPooler(hidden_size) if with_pool else None

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        emb = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None:
            # [B, S] 1/0 -> additive [B, 1, 1, S]
            m = attention_mask.float()
            attention_mask = (1.0 - m)[:, None, None, :] * -1e4
        out = self.encoder(emb, src_mask=attention_mask)
        if self.pooler is not None:
            return out, self.pooler(out)
        return out

    @classmethod
    def from_config(cls, name, device=None, seed=0, **overrides):
        """A ``BERT_CONFIGS`` model on ``device`` (None = the CUDA card;
        raises without one) with weights drawn from ``seed``
        (``_init_weights``)."""
        dev = resolve_device(device)
        cfg = dict(BERT_CONFIGS[name])
        cfg.update(overrides)
        with torch.device(dev):
            model = cls(**cfg)
        _init_weights(model, seed)
        return model


def _head_linear(bert, n_in, n_out):
    """A head's linear on ``bert``'s device and dtype, initialized as the
    JAX package's (XavierNormal weight, zero bias) from torch's global
    generator, as the JAX package draws from its global seed."""
    w = bert.pooler.dense.weight
    lin = nn.Linear(n_in, n_out, device=w.device, dtype=w.dtype)
    with torch.no_grad():
        lin.weight.normal_(0.0, math.sqrt(2.0 / (n_in + n_out)))
        lin.bias.zero_()
    return lin


class BertForSequenceClassification(nn.Module):
    """The pooled output -> dropout -> a ``num_classes`` linear: logits
    ``[B, num_classes]``."""

    def __init__(self, bert, num_classes=2, dropout=0.1):
        super().__init__()
        self.bert = bert
        self.dropout = nn.Dropout(dropout)
        hidden = bert.pooler.dense.out_features
        self.classifier = _head_linear(bert, hidden, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return apply_linear(self.classifier, self.dropout(pooled))


class BertForMaskedLM(nn.Module):
    """The sequence output -> linear -> exact GELU -> LayerNorm (eps 1e-12)
    -> the vocabulary decoder: logits ``[B, S, V]``."""

    def __init__(self, bert):
        super().__init__()
        self.bert = bert
        hidden = bert.pooler.dense.out_features
        vocab = bert.embeddings.word_embeddings.num_embeddings
        self.transform = _head_linear(bert, hidden, hidden)
        w = bert.pooler.dense.weight
        self.layer_norm = nn.LayerNorm(hidden, eps=1e-12, device=w.device,
                                       dtype=w.dtype)
        self.decoder = _head_linear(bert, hidden, vocab)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq_out, _ = self.bert(input_ids, token_type_ids, attention_mask)
        x = apply_layer_norm(self.layer_norm,
                             gelu(apply_linear(self.transform, seq_out)))
        return apply_linear(self.decoder, x)


class BertPretrainingCriterion(nn.Module):
    """Mean masked-LM cross entropy of ``[B, S, V]`` scores against int
    ``[B, S]`` labels, ``ignore_index`` positions left out."""

    def forward(self, prediction_scores, masked_lm_labels,
                ignore_index=-100):
        b, s, v = prediction_scores.shape
        return cross_entropy(prediction_scores.reshape(b * s, v),
                             masked_lm_labels.reshape(b * s),
                             ignore_index=ignore_index)


@torch.no_grad()
def _init_weights(model, seed=0):
    """The JAX package's initializers, drawn from ``seed``: Normal(0, 0.02)
    embeddings, XavierNormal linear weights (std ``sqrt(2 / (in +
    out))``), zero biases, LayerNorm at 1 / 0.  A ``scan_layers``
    encoder's stacked ``[L, in, out]`` weights draw as one tensor each, so
    its weights are not an unrolled model's of the same seed."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, PLinear):
            w = mod._parameters["weight"]
            w.normal_(0.0, math.sqrt(2.0 / (w.shape[-2] + w.shape[-1])),
                      generator=gen)
            if mod._parameters["bias"] is not None:
                mod._parameters["bias"].zero_()
        elif isinstance(mod, PLayerNorm):
            mod._parameters["weight"].fill_(1.0)
            mod._parameters["bias"].zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(mod, nn.Linear):
            w = mod.weight
            fan_out, fan_in = w.shape[-2], w.shape[-1]
            w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                      generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model

