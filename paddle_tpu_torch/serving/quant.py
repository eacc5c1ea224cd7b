"""Quantized serving — int8 weight codes and int8 KV block pools
(counterpart of ``paddle_tpu/serving/quant.py``).

* ``Engine(weight_dtype="int8")`` relayouts every transformer-block
  Linear through weight-only int8 (``relayout_weights_int8``): the codes
  and per-output-channel scales become buffers of
  ``quantization.WeightOnlyInt8Linear`` layers, and the model's forward
  runs through them unchanged.
* ``Engine(kv_dtype="int8")`` keeps each layer's K and V pools as int8
  codes ``[NB, bs, H, hd]`` with one f32 scale per block and head
  (``QuantKV``).  A write is a touched-block read-modify-write
  (``paged_insert``); the ragged kernels read the codes and dequantize
  each block as they stream it, so the pool is never dequantized whole.
  One block costs ``bs*H*hd`` code bytes plus ``H`` scale floats per
  layer and pool instead of ``bs*H*hd`` f32s: the same ``kv_budget_mb``
  holds about 4x the blocks of an f32 pool.

Quantization convention (shared with the weight quantizer):
``amax = max(|x|)`` clamped to 1e-8, codes
``round(clip(x, -amax, amax) / amax * 127)``, stored scale ``amax / 127``,
so dequantization is ``codes * scale``.  Re-quantizing a block under its
own scale gives its codes back exactly, so the read-modify-write loses
precision only when a block's amax grows.

Scale-pool invariants, as in the JAX package: one scale row ``[H]`` per
physical block, layer and pool; writes land only in a slot's own fresh
blocks, so a block shared through the prefix cache never changes; a
freshly reserved block has its scale row zeroed before its first write
(``Engine._zero_fresh_scales``), which turns its stale codes into zeros.

Unlike the JAX package, ``paged_insert`` updates the pool in place (the
port's pools are written in place everywhere) and returns it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..quantization.weight_only import (WeightOnlyInt8Linear,
                                        quantize_weights_int8)

_EPS = 1e-8  # amax clamp, as in the weight quantizer


class QuantKV:
    """One layer's quantized K (or V) block pool: int8 ``codes``
    ``[NB, bs, H, hd]`` and f32 ``scale`` ``[NB, H]``.  ``.shape`` and
    ``.dtype`` proxy the codes, so callers that read only the pool's
    geometry (``k_pools[0].shape[1]`` for the block size) take both
    forms."""

    __slots__ = ("codes", "scale")

    def __init__(self, codes, scale):
        self.codes = codes
        self.scale = scale

    @property
    def shape(self):
        return self.codes.shape

    @property
    def dtype(self):
        return self.codes.dtype

    def __repr__(self):
        return (f"QuantKV(codes={tuple(self.codes.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def quantize_blocks(vals):
    """Whole-block quantize: ``[n, bs, H, hd]`` -> (int8 codes, f32 scale
    ``[n, H]``) with a fresh scale per block and head."""
    vals = vals.float()
    amax = torch.clamp(vals.abs().amax(dim=(1, 3)), min=_EPS)   # [n, H]
    scale = amax / 127.0
    a = amax[:, None, :, None]
    q = torch.round(torch.clamp(vals, -a, a) / a * 127.0)
    return q.to(torch.int8), scale


def dequantize_blocks(codes, scale):
    """int8 ``[..., bs, H, hd]`` times f32 ``[..., H]`` -> f32 blocks."""
    return codes.float() * scale[..., None, :, None]


def paged_gather(pool, block_tables):
    """Dequantized logical rows of a batch of block tables: ``pool``
    QuantKV, ``block_tables`` int ``[B, nbt]`` -> f32
    ``[B, nbt * bs, H, hd]``.  Only the gathered blocks are
    dequantized."""
    t = block_tables.long()
    kf = dequantize_blocks(pool.codes[t], pool.scale[t])
    B = t.shape[0]
    return kf.reshape(B, -1, kf.shape[3], kf.shape[4])


def paged_insert(pool, blk, off, vals):
    """Insert per-lane rows into a quantized block pool, in place — the
    touched-block read-modify-write:

    1. each lane's target block is dequantized;
    2. the written rows are placed: every lane writes into the copy of
       its block held by the first lane naming that block, and each copy
       then takes its canonical copy's content, so all copies of a block
       are identical before the scatter back;
    3. the whole block is re-quantized with a fresh per-head amax.

    ``pool``: QuantKV; ``blk``/``off``: int ``[N]`` physical block and
    in-block row per lane; ``vals``: ``[N, H, hd]``.  Masked lanes are
    routed by the caller to the scratch block (row 0), as in the JAX
    package.

    Where two lanes write one (block, row), the JAX package sums their
    values (its one-hot fold) and this copy keeps the last lane's: the
    engine's valid lanes never share a (block, row), so the two agree,
    code for code and scale for scale, on every block but the scratch
    block, which no live lane reads.  Nothing here reads a tensor back
    to the host."""
    codes, scale = pool.codes, pool.scale
    bs = codes.shape[1]
    blk = blk.long()
    off = off.long()
    n = blk.shape[0]
    lane = torch.arange(n, device=blk.device)
    # the first lane naming each lane's block holds the block's copy
    rep = torch.argmax((blk[:, None] == blk[None, :]).to(torch.int32),
                       dim=1)
    # one writer per (copy, row): the last lane, so the scatter below
    # never sees two different values for one element
    key = rep * bs + off
    last = torch.full((n * bs,), -1, dtype=torch.long, device=blk.device)
    last.scatter_reduce_(0, key, lane, reduce="amax")
    kf = dequantize_blocks(codes[blk], scale[blk])       # [N, bs, H, hd]
    kf[rep, off] = vals.float()[last[key]]
    q, s = quantize_blocks(kf[rep])
    codes[blk] = q
    scale[blk] = s
    return pool


def _iter_block_linears(model):
    """``(path, layer)`` for every plain ``nn.Linear`` inside the model's
    transformer blocks (embeddings and the LM head are left alone)."""
    for bi, block in enumerate(model.blocks):
        stack = [(f"blocks[{bi}]", block)]
        while stack:
            prefix, layer = stack.pop()
            for name, child in layer.named_children():
                path = f"{prefix}.{name}"
                if isinstance(child, WeightOnlyInt8Linear):
                    continue
                if isinstance(child, nn.Linear):
                    yield path, child
                else:
                    stack.append((path, child))


def relayout_weights_int8(model, compute_dtype=None):
    """Validate, then relayout every transformer-block Linear of a serving
    model through weight-only int8 (per-output-channel abs-max codes).
    Validation runs first over the whole model and raises a
    ``ValueError`` naming the offending layer before anything is
    swapped; a model with nothing left to code (already relayouted)
    raises too.  Returns the number of relayouted layers."""
    todo = list(_iter_block_linears(model))
    for path, lin in todo:
        w = getattr(lin, "weight", None)
        if not isinstance(w, torch.Tensor) or w.dim() != 2 \
                or not w.is_floating_point():
            got = (f"shape {list(w.shape)} dtype {w.dtype}"
                   if isinstance(w, torch.Tensor) else "no weight")
            raise ValueError(
                f"weight_dtype='int8' cannot relayout layer {path}: "
                f"{got} — weight-only int8 codes need a 2-D floating "
                "[out, in] Linear weight")
    if not todo:
        raise ValueError(
            "weight_dtype='int8' found no Linear layers in model.blocks "
            "to relayout — a pre-quantized model has nothing to code")
    with torch.no_grad():
        for block in model.blocks:
            quantize_weights_int8(block, compute_dtype=compute_dtype)
    return len(todo)
