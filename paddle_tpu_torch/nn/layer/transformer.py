"""Transformer encoder layers — counterpart of
``paddle_tpu/nn/layer/transformer.py`` (``MultiHeadAttention``,
``TransformerEncoderLayer``, ``TransformerEncoder``).

Inputs are ``[batch, seq, embed]`` (paddle's layout).  Attention runs
through ``nn.functional.scaled_dot_product_attention`` (with a mask, its
masked form; without one, the flash op at long sequences), or with
``need_weights`` through explicit scores that return the probabilities.
Every linear and layer norm passes its JAX amp site (``apply_linear``,
``apply_layer_norm``), so a forward under ``amp.auto_cast`` casts where
the JAX package's does.  Linear weights are torch's ``[out, in]``
``nn.Linear`` ones; the weight bridge (``convert.py``) transposes the
JAX package's ``[in, out]``.

The decoder layers of the JAX file (``TransformerDecoderLayer``,
``TransformerDecoder``, ``Transformer``) are ROADMAP Queue A 12's.
"""
from __future__ import annotations

import collections
import copy
import math

import torch
from torch import nn
from torch.nn import functional as F

from .. import functional as PF
from ..functional import apply_layer_norm, apply_linear
from .scan import ScanLayers


class MultiHeadAttention(nn.Module):
    """Multi-head attention over ``[B, S, E]``: q/k/v/out projections
    (``kdim`` / ``vdim`` for the key and value inputs).  ``Cache`` grows
    with each call (incremental decode); ``StaticCache`` holds projected
    keys and values computed once (``gen_cache(key, value,
    type=StaticCache)``).  ``need_weights`` returns ``(out, probs)``;
    with a ``Cache`` the grown cache comes last."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(self.kdim, embed_dim)
        self.v_proj = nn.Linear(self.vdim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def _split_heads(self, x):
        b, s = x.shape[0], x.shape[1]
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key`` / ``value`` projected once, or an
        empty ``Cache`` ``[B, 0, H, hd]`` (f32) to grow."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(apply_linear(self.k_proj, key))
            v = self._split_heads(apply_linear(
                self.v_proj, value if value is not None else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(torch.zeros(shape, device=key.device),
                          torch.zeros(shape, device=key.device))

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(apply_linear(self.q_proj, query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(apply_linear(self.k_proj, key))
            v = self._split_heads(apply_linear(self.v_proj, value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k, k], dim=1)
                v = torch.cat([cache.v, v], dim=1)
                cache = self.Cache(k, v)
        if self.need_weights:
            out, weights = self._attention_with_weights(q, k, v, attn_mask)
        else:
            out = PF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
            weights = None
        b, s = out.shape[0], out.shape[1]
        out = apply_linear(self.out_proj, out.reshape(b, s, self.embed_dim))
        outs = [out]
        if self.need_weights:
            outs.append(weights)
        if isinstance(cache, self.Cache):
            outs.append(cache)
        return out if len(outs) == 1 else tuple(outs)

    def _attention_with_weights(self, q, k, v, attn_mask):
        """Explicit scores (``matmul``), a bool mask at -1e9 or an additive
        one, ``softmax``, dropout on the probabilities; returns ``(out
        [B, S, H, hd], probs [B, H, Sq, Sk])``."""
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        scores = PF.matmul(qh, kh, transpose_y=True) \
            * (1.0 / math.sqrt(self.head_dim))
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                scores = torch.where(attn_mask, scores,
                                     torch.full_like(scores, -1e9))
            else:
                scores = scores + attn_mask
        probs = PF.softmax(scores, axis=-1)
        if self.dropout and self.training:
            probs = F.dropout(probs, p=self.dropout, training=True)
        out = PF.matmul(probs, vh)
        return out.transpose(1, 2), probs


_ACTIVATIONS = {"relu": F.relu, "gelu": PF.gelu, "tanh": PF.tanh}


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and
    a LayerNorm (eps 1e-5): post-LN by default, pre-LN with
    ``normalize_before``.  ``activation`` is ``"relu"``, ``"gelu"`` (the
    exact erf form, as the JAX package's ``F.gelu``) or ``"tanh"``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.dropout = nn.Dropout(act_dropout)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)
        if activation not in _ACTIVATIONS:
            raise ValueError(f"activation {activation!r}: expected one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.activation = _ACTIVATIONS[activation]

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = apply_layer_norm(self.norm1, src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = apply_layer_norm(self.norm1, src)
        residual = src
        if self.normalize_before:
            src = apply_layer_norm(self.norm2, src)
        src = apply_linear(self.linear2, self.dropout(
            self.activation(apply_linear(self.linear1, src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = apply_layer_norm(self.norm2, src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


class TransformerEncoder(nn.Module):
    """``num_layers`` copies of ``encoder_layer`` (the first is the layer
    itself, the rest deep copies, so all start with its weights), then an
    optional final ``norm``.  ``scan_layers`` stacks their parameters
    (``ScanLayers``: the same weights and math as unrolled, no
    cache-based decode)."""

    def __init__(self, encoder_layer, num_layers, norm=None,
                 scan_layers=False):
        super().__init__()
        self.scan_layers = scan_layers
        if scan_layers:
            first = [encoder_layer]
            self.layers = ScanLayers(
                lambda: first.pop() if first
                else copy.deepcopy(encoder_layer), num_layers)
        else:
            self.layers = nn.ModuleList(
                [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
                 for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if self.scan_layers:
            if cache is not None:
                raise NotImplementedError(
                    "TransformerEncoder(scan_layers=True) does not do "
                    "cache-based incremental decode — use the unrolled "
                    "form")
            output = self.layers(src, src_mask)
            if self.norm is not None:
                output = apply_layer_norm(self.norm, output)
            return output
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = apply_layer_norm(self.norm, output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        if self.scan_layers:
            raise NotImplementedError(
                "gen_cache needs per-layer cache objects — use the "
                "unrolled TransformerEncoder")
        return [layer.gen_cache(src) for layer in self.layers]
