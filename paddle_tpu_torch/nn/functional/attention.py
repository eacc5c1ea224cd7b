"""Attention functionals — counterpart of
``paddle_tpu/nn/functional/attention.py``.

``scaled_dot_product_attention`` takes ``[batch, seq, heads, head_dim]``
(paddle's layout; torch tensors or handles, ``_io.api``) and dispatches
as the JAX package does: without an explicit mask, at ``seq >=
FLASH_MIN_SEQ``, with both lengths multiples of 128 and ``head_dim % 64
== 0``, attention goes to the flash op (``ops/flash_attention.py``);
everything else takes ``_reference_attention``, which materializes the
scores.  A call with ``attn_mask`` is
``scaled_dot_product_attention_masked`` (the JAX package's primitive of
that name): the reference attention under a bool or additive mask,
through its own amp site, which is on no list, so O1 leaves it in its
inputs' dtype.  The flash op also needs one length for q and k: the
upstream kernel's causal diagonal is top-left and the reference's
bottom-right, and the two agree only when the lengths are equal
(training always has them equal).

Where the JAX package asks whether a TPU backend serves the Pallas
kernel, the port asks whether the tensors lie on a device the flash op
serves: CUDA, where it launches the hand-written kernels, and the CPU,
where it runs their plain versions (the parity tests lower
``FLASH_MIN_SEQ`` to reach it).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ... import amp
# looked up at call time, so a comparison can route the same model
# through the plain versions (flash_attention_ref)
from ...ops.flash_attention import flash_attention
from ._io import api

# flash engages at seq >= this, as in the JAX package
FLASH_MIN_SEQ = 2048
_FLASH_DEVICES = ("cuda", "cpu")


def _reference_attention(q, k, v, mask=None, scale=None, is_causal=False):
    """[B, S, H, D] layout.  Scores in q's dtype, masked at the dtype's
    minimum (causal: ``tril(k=sk-sq)``, the bottom-right diagonal),
    softmax in f32, value product in q's dtype."""
    sq, d = q.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    lowest = torch.finfo(scores.dtype).min
    if is_causal:
        sk = k.shape[1]
        causal = torch.ones(sq, sk, dtype=torch.bool,
                            device=q.device).tril(diagonal=sk - sq)
        scores = scores.masked_fill(~causal, lowest)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, lowest)
        else:
            scores = scores + mask
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _flash_gate(q, k, mask):
    seq, seq_kv, d = q.shape[1], k.shape[1], q.shape[-1]
    return (mask is None and q.device.type in _FLASH_DEVICES
            and seq >= FLASH_MIN_SEQ and seq % 128 == 0
            and seq_kv % 128 == 0 and d % 64 == 0 and seq == seq_kv)


def _sdpa(q, k, v, segment_ids=None, mask=None, scale=None,
          is_causal=False):
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if _flash_gate(q, k, mask):
        return flash_attention(q, k, v, segment_ids, causal=is_causal,
                               sm_scale=scale)
    if segment_ids is not None:
        # dense fallback: the block-diagonal mask, combined with causal
        # inside _reference_attention
        mask = (segment_ids[:, :, None]
                == segment_ids[:, None, :])[:, None, :, :]
    return _reference_attention(q, k, v, mask, scale, is_causal)


@api
def scaled_dot_product_attention_masked(query, key, value, mask, scale=None,
                                        is_causal=False):
    """``_reference_attention`` under ``mask`` ``[B or 1, H or 1, Sq,
    Sk]``: bool (False masks a pair at the scores' dtype minimum) or
    additive (added to the scores, which promotes bf16 scores beside an
    f32 mask to f32, as jnp does).  q, k, v and the mask pass the
    ``scaled_dot_product_attention_masked`` amp site."""
    query, key, value, mask = amp.cast_inputs(
        "scaled_dot_product_attention_masked", query, key, value, mask)
    return _reference_attention(query, key, value, mask, scale, is_causal)


@api
def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, scale=None,
                                 segment_ids=None, name=None):
    """Inputs ``[batch, seq, num_heads, head_dim]``.  ``segment_ids``
    ``[B, S]`` int32 blocks attention to same-segment pairs.  Dropout
    (``dropout_p`` in training) applies to the attention OUTPUT, as the
    JAX package applies it.  Without a mask, q, k and v pass the
    ``scaled_dot_product_attention`` amp site (O1 casts them to bf16);
    with one, the call is ``scaled_dot_product_attention_masked``."""
    if attn_mask is not None and segment_ids is not None:
        raise ValueError(
            "scaled_dot_product_attention: pass attn_mask OR "
            "segment_ids, not both (fold any padding mask into the "
            "segment ids instead)")
    if attn_mask is not None:
        out = scaled_dot_product_attention_masked(query, key, value,
                                                  attn_mask, scale,
                                                  is_causal)
    else:
        query, key, value = amp.cast_inputs("scaled_dot_product_attention",
                                            query, key, value)
        out = _sdpa(query, key, value, segment_ids, scale=scale,
                    is_causal=is_causal)
    if dropout_p > 0.0 and training:
        out = F.dropout(out, p=dropout_p, training=True)
    return out
