"""Transformer layers — counterpart of ``paddle_tpu/nn/layer/transformer.py``
(``MultiHeadAttention``, ``TransformerEncoderLayer``,
``TransformerEncoder``, ``TransformerDecoderLayer``,
``TransformerDecoder``, ``Transformer``).

Inputs are ``[batch, seq, embed]`` (paddle's layout); torch tensors in
give torch tensors out, handles give handles.  The projections are
Paddle ``Linear`` layers (weights ``[in, out]``, the JAX package's
layout and names, so a JAX model's ``state_dict`` loads as it is) and
the norms Paddle ``LayerNorm`` (eps 1e-5), each through its JAX amp
site.  Attention runs through ``nn.functional.scaled_dot_product_attention``:
with a mask its masked form, without one the flash op at long sequences
(the hand-written kernels on the card), or with ``need_weights``
through explicit scores that return the probabilities.

Incremental decoding: ``MultiHeadAttention.Cache`` grows with each call;
``StaticCache`` holds keys and values projected once
(``gen_cache(key, value, type=StaticCache)``).  A decoder layer's cache
is ``(Cache, StaticCache)``: its self-attention grows the first and its
cross-attention reads the memory's projections from the second, made
once by ``TransformerDecoder.gen_cache(memory)`` (``do_zip`` regroups the
per-layer pairs).  ``Transformer.generate_square_subsequent_mask(n)`` is
the additive causal mask.
"""
from __future__ import annotations

import collections
import copy
import math

import torch
from torch.nn import functional as TF

from .. import functional as F
from ..functional._io import follows_input, wrap
from .base import Layer, LayerList
from .common import Dropout, Linear
from .norm import LayerNorm
from .scan import ScanLayers


class MultiHeadAttention(Layer):
    """Multi-head attention: q/k/v/out projections (``kdim`` / ``vdim``
    for the key and value inputs).  ``need_weights`` returns ``(out,
    probs)``; with a ``Cache`` the grown cache comes last."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None):
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
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _split_heads(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads,
                         self.head_dim)

    @follows_input
    def gen_cache(self, key, value=None, type=None):
        """A ``StaticCache`` of ``key`` / ``value`` projected once, or an
        empty ``Cache`` ``[B, 0, H, hd]`` (f32) to grow."""
        if type == MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(
                value if value is not None else key))
            return self.StaticCache(k, v)
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return self.Cache(torch.zeros(shape, device=key.device),
                          torch.zeros(shape, device=key.device))

    @follows_input
    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, self.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, self.Cache):
                k = torch.cat([cache.k.to(k.dtype), k], dim=1)
                v = torch.cat([cache.v.to(v.dtype), v], dim=1)
                cache = self.Cache(k, v)
        if self.need_weights:
            out, weights = self._attention_with_weights(q, k, v, attn_mask)
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                training=self.training)
            weights = None
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
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
        scores = F.matmul(qh, kh, transpose_y=True) \
            * (1.0 / math.sqrt(self.head_dim))
        if attn_mask is not None:
            if attn_mask.dtype == torch.bool:
                scores = torch.where(attn_mask, scores,
                                     torch.full_like(scores, -1e9))
            else:
                scores = scores + attn_mask
        probs = F.softmax(scores, axis=-1)
        if self.dropout and self.training:
            probs = TF.dropout(probs, p=self.dropout, training=True)
        return F.matmul(probs, vh).transpose(1, 2), probs


def _activation(name):
    fn = getattr(F, name, None)
    if fn is None or not callable(fn):
        raise ValueError(f"activation {name!r} is not a functional of "
                         "nn.functional")
    return fn


class TransformerEncoderLayer(Layer):
    """Self-attention and a feed-forward block, each with a residual, a
    dropout and a LayerNorm: post-LN by default, pre-LN with
    ``normalize_before``.  ``activation`` names a functional of
    ``nn.functional`` (``"relu"``, ``"gelu"``: the exact erf form)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout=attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = _activation(activation)

    @follows_input
    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, incremental_cache = self.self_attn(src, src, src, src_mask,
                                                    cache)
        src = residual + self.dropout1(src)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src if cache is None else (src, incremental_cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _copies(layer, num_layers):
    """``layer`` and ``num_layers - 1`` deep copies of it."""
    return [layer if i == 0 else copy.deepcopy(layer)
            for i in range(num_layers)]


class TransformerEncoder(Layer):
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
            self.layers = LayerList(_copies(encoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    @follows_input
    def forward(self, src, src_mask=None, cache=None):
        if self.scan_layers:
            if cache is not None:
                raise NotImplementedError(
                    "TransformerEncoder(scan_layers=True) does not do "
                    "cache-based incremental decode — use the unrolled "
                    "form")
            output = self.layers(src, src_mask)
            return self.norm(output) if self.norm is not None else output
        output, new_caches = src, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask=src_mask)
            else:
                output, new_cache = mod(output, src_mask=src_mask,
                                        cache=cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        if self.scan_layers:
            raise NotImplementedError(
                "gen_cache needs per-layer cache objects — use the "
                "unrolled TransformerEncoder")
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(Layer):
    """Self-attention, cross-attention over ``memory`` and a feed-forward
    block, each with a residual, a dropout and a LayerNorm (post-LN, or
    pre-LN with ``normalize_before``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             weight_attr=weight_attr,
                                             bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr)
        self.norm1 = LayerNorm(d_model)
        self.norm2 = LayerNorm(d_model)
        self.norm3 = LayerNorm(d_model)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.activation = _activation(activation)

    @follows_input
    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, incremental_cache = self.self_attn(tgt, tgt, tgt, tgt_mask,
                                                    cache[0])
        tgt = residual + self.dropout1(tgt)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, memory_mask,
                              None if cache is None else cache[1])
        tgt = residual + self.dropout2(tgt)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.dropout(self.activation(self.linear1(tgt))))
        tgt = residual + self.dropout3(tgt)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (incremental_cache,
                                                cache[1]))

    def gen_cache(self, memory):
        """``(Cache, StaticCache)``: an empty self-attention cache and the
        memory's cross-attention projections."""
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(
                    memory, memory, type=MultiHeadAttention.StaticCache))


class TransformerDecoder(Layer):
    """``num_layers`` copies of ``decoder_layer``, then an optional
    ``norm``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(_copies(decoder_layer, num_layers))
        self.num_layers = num_layers
        self.norm = norm

    @follows_input
    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output, new_caches = tgt, []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, new_cache = mod(output, memory, tgt_mask,
                                        memory_mask, cache[i])
                new_caches.append(new_cache)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory, do_zip=False):
        cache = [layer.gen_cache(memory) for layer in self.layers]
        return list(zip(*cache)) if do_zip else cache


class Transformer(Layer):
    """The encoder-decoder of Vaswani et al. 2017; the defaults are its
    "base" model (d_model 512, 8 heads, 6 + 6 layers, FFN 2048, dropout
    0.1).  A final LayerNorm closes each stack under
    ``normalize_before``."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None):
        super().__init__()
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_layer = TransformerEncoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.encoder = TransformerEncoder(
                enc_layer, num_encoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_layer = TransformerDecoderLayer(
                d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
            self.decoder = TransformerDecoder(
                dec_layer, num_decoder_layers,
                LayerNorm(d_model) if normalize_before else None)
        self.d_model = d_model
        self.nhead = nhead

    @follows_input
    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """``[length, length]`` f32: 0 on and below the diagonal, -inf
        above (a handle on the current place; a torch tensor when
        ``device`` names a torch device)."""
        from .base import layer_device
        dev = layer_device() if device is None else device
        mask = torch.triu(torch.full((length, length), float("-inf"),
                                     device=dev), diagonal=1)
        return mask if device is not None else wrap(mask)
