"""GPT decoder in PyTorch — counterpart of ``paddle_tpu/models/gpt.py``.

The dense model (``GPTModel.forward`` returns logits, or the loss when
given labels; with ``caches=`` the logits and the grown K/V caches)
trains through ``scaled_dot_product_attention``
(``nn/functional/attention.py``: the flash kernels at long sequences).
The serving engine runs one of two window families:

* the RAGGED paged window: every decoder layer's ``ragged_window_paged``
  writes the window's K/V through the slots' block tables and runs the
  ragged paged attention kernel (``ops/ragged_paged_attn.py``), and
  ``_fused_ragged_tick_slots`` adds the on-device sample /
  stop-condition epilogue of one engine tick;
* the XLA windows of the JAX package, in plain torch: ``decode_slots`` /
  ``verify_slots`` over contiguous ``[B, L, H, hd]`` slot rows,
  ``decode_slots_paged`` / ``verify_slots_paged`` /
  ``prefill_chunk_paged`` over block pools (gathering each slot's whole
  row), the shared-position ``decode`` of the contiguous chunk prefill,
  and the whole-prompt, bucketed and block-granular prefills
  (``_prefill_slot``, ``_prefill_paged``), all through the one
  ``_slot_attn`` or ``forward(caches=)``.  ``_fused_decode_tick_slots``
  and ``_fused_spec_verify_tick_slots`` add the same epilogue as the
  ragged tick.  Where JAX jit-compiles these with donated pools, the
  port writes the pools in place.

Layouts follow the JAX package so the weight bridge (``convert.py``) and
the parity tests compare like with like: the fused QKV projection
reshapes to ``[b, s, 3, H, hd]`` and splits on dim 2, and KV pools are
``[num_blocks, block_size, H, hd]``.  Sampling runs on the device
without reading anything back: each lane's 64-bit key is a splitmix64
mix of the request's seed words and emitted-token counter, computed in
int64 tensor ops (``_slot_sample_keys``), and its draw is the inverse
CDF of the filtered distribution at a uniform number taken from the key
(``_sample_lanes``).  The keys do not reproduce jax's draws, only the
same stream for the same seed.

Per-slot LoRA adapters (``serving/lora.py``) enter through
``_lora_scope``: inside it every ``GPTAttention._out`` adds each batch
row's own adapter delta, so every window above serves adapter lanes
unchanged; outside it ``_out`` is the plain projection.
``GPTModel.generate`` decodes a batch of prompts on its own (eager, one
fixed-buffer step a token, the whole decode with no host read, or
prompt-lookup speculative).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
from torch import nn
from torch.nn import functional as F

from .. import amp
from ..device import resolve_device
from ..distributed.collective import mesh_all_reduce
from ..distributed.fleet.utils import recompute
from ..distributed.moe import ExpertFFN, MoELayer
from ..distributed.ring import ring_attention, ulysses_attention
from ..distributed.sharding import (ColumnParallelLinear, RowParallelLinear,
                                    VocabParallelEmbedding)
from ..nn.functional import (apply_layer_norm, apply_linear, cross_entropy,
                             fused_linear_cross_entropy, gelu,
                             scaled_dot_product_attention,
                             vocab_parallel_linear_cross_entropy)
from ..nn.layer import ScanLayers, owner_of
from ..ops.ragged_paged_attn import ragged_paged_attention
from ..serving.quant import (QuantKV, dequantize_blocks, paged_gather,
                             paged_insert, quantize_blocks)

GPT_CONFIGS = {
    # name: (n_layer, hidden, heads, ffn_mult, vocab, max_seq)
    "gpt2-small": dict(num_layers=12, hidden_size=768, num_heads=12,
                       vocab_size=50304, max_position=1024),
    "gpt2-medium": dict(num_layers=24, hidden_size=1024, num_heads=16,
                        vocab_size=50304, max_position=1024),  # 345M
    "gpt2-large": dict(num_layers=36, hidden_size=1280, num_heads=20,
                       vocab_size=50304, max_position=1024),
    "gpt3-1.3b": dict(num_layers=24, hidden_size=2048, num_heads=16,
                      vocab_size=50304, max_position=2048),
    "tiny": dict(num_layers=2, hidden_size=64, num_heads=4,
                 vocab_size=128, max_position=64),
}

_MASK = -1e30


def _i64(c):
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_SPLITMIX = (_i64(0x9E3779B97F4A7C15), _i64(0xBF58476D1CE4E5B9),
             _i64(0x94D049BB133111EB))


def _shr(x, s):
    """Logical right shift of an int64 tensor's bits: torch's ``>>`` is
    arithmetic on int64, so the sign bits it brings in are masked off."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x):
    """splitmix64 finalizer over an int64 tensor, on its device: spreads
    each element's 64 bits.  Adds and multiplies wrap modulo 2**64, so
    the bits are those of the unsigned arithmetic."""
    golden, m1, m2 = _SPLITMIX
    x = x + golden
    x = (x ^ _shr(x, 30)) * m1
    x = (x ^ _shr(x, 27)) * m2
    return x ^ _shr(x, 31)


# The per-slot LoRA context of ``_lora_scope``.  Thread-local, as in the
# JAX package: sibling engines over one model may run on other threads,
# and one engine's adapter lanes must not reach another's windows.
_LORA_TLS = threading.local()


@contextmanager
def _lora_scope(lora):
    """Activate per-slot LoRA deltas for every ``GPTAttention._out`` run
    on this thread: ``lora`` is ``(adapter_id [B], a_bank [n_lanes,
    n_layers, r, E], b_bank [n_lanes, n_layers, E, r])``, each batch row
    gathering its lane once here (lane 0, all zeros, is the base model);
    empty or None is the base model with no extra kernel at all."""
    if not lora:
        yield
        return
    aid, a_bank, b_bank = lora
    aid = aid.long()
    prev = getattr(_LORA_TLS, "ctx", None)
    _LORA_TLS.ctx = (a_bank.index_select(0, aid),
                     b_bank.index_select(0, aid))
    try:
        yield
    finally:
        _LORA_TLS.ctx = prev


def window_write_rows(block_tables, pos, width, scratch, W, block_size):
    """Where each lane of a W-lane ragged window writes its K/V: lane s of
    slot b lands at position ``pos[b] + s``, i.e. physical block
    ``block_tables[b, (pos[b] + s) // bs]``, row ``(pos[b] + s) % bs``.
    Lanes ``s >= width[b]``, and any offset past the table, write row 0
    of the slot's scratch block ``scratch[b]`` instead, so a masked lane
    never touches a live row.  Returns (blk, off), int64 ``[B * W]``."""
    dev = block_tables.device
    bs = int(block_size)
    bps = block_tables.shape[1]
    lane = torch.arange(W, device=dev)
    offs = pos.long()[:, None] + lane[None, :]              # [B, W]
    valid = (lane[None, :] < width.long()[:, None]) & (offs < bps * bs)
    offs_safe = torch.where(valid, offs, torch.zeros_like(offs))
    blk = torch.gather(block_tables.long(), 1, offs_safe // bs)
    blk = torch.where(valid, blk, scratch.long()[:, None])
    off = torch.where(valid, offs_safe % bs, torch.zeros_like(offs_safe))
    return blk.reshape(-1), off.reshape(-1)


def write_window_kv(k_pool, v_pool, k_rows, v_rows, blk, off):
    """Write a window's K/V rows ``[N, H, hd]`` into the pools in place at
    (``blk``, ``off``) from ``window_write_rows``: a row scatter into fp
    pools, the touched-block read-modify-write (``paged_insert``) into
    ``QuantKV`` pools."""
    if isinstance(k_pool, QuantKV):
        paged_insert(k_pool, blk, off, k_rows)
        paged_insert(v_pool, blk, off, v_rows)
        return
    NB, bs, H, hd = k_pool.shape
    widx = blk * bs + off
    k_pool.view(NB * bs, H, hd)[widx] = k_rows.to(k_pool.dtype)
    v_pool.view(NB * bs, H, hd)[widx] = v_rows.to(v_pool.dtype)


def kernel_view(pool):
    """A pool as the ragged kernels take it: (rows ``[NB * bs, H, hd]``,
    the scale pool ``[NB, H]`` of a ``QuantKV`` or None)."""
    codes = pool.codes if isinstance(pool, QuantKV) else pool
    NB, bs, H, hd = codes.shape
    return (codes.view(NB * bs, H, hd),
            pool.scale if isinstance(pool, QuantKV) else None)


def gather_block_rows(pool, block_tables):
    """Each slot's logical ``[L]`` row of a block pool: ``pool`` ``[NB,
    bs, H, hd]`` (or ``QuantKV``, dequantized block by block), tables int
    ``[B, L/bs]`` -> ``[B, L, H, hd]``."""
    if isinstance(pool, QuantKV):
        return paged_gather(pool, block_tables)
    NB, bs, H, hd = pool.shape
    gidx = (block_tables.long()[:, :, None] * bs
            + torch.arange(bs, device=pool.device)).reshape(
                block_tables.shape[0], -1)
    return pool.view(NB * bs, H, hd)[gidx]


def scatter_slot_rows(buf, pos, vals, in_range=False):
    """``buf[b, pos[b] + j] = vals[b, j]`` into contiguous slot rows
    ``[B, L, H, hd]``, in place, with JAX's scatter rule: a lane past
    ``L`` is dropped.  A dropped lane writes the row just before its
    slot's window back onto itself instead (no lane of the window writes
    that row, so no two lanes write one row with different values).
    ``in_range=True`` says the caller knows every ``pos[b] + W <= L``
    and skips that.  ``vals`` ``[B, W, H, hd]`` with W <= L."""
    B, L = buf.shape[0], buf.shape[1]
    W = vals.shape[1]
    dev = buf.device
    flat = buf.view(B * L, *buf.shape[2:])
    cols = pos.long()[:, None] + torch.arange(W, device=dev)[None, :]
    base = torch.arange(B, device=dev)[:, None] * L
    vals = vals.to(buf.dtype)
    if not in_range:
        valid = cols < L
        keep = torch.clamp(pos.long() - 1, 0, L - 1)[:, None].expand(B, W)
        cols = torch.where(valid, cols, keep)
        vals = torch.where(valid[..., None, None], vals,
                           flat[(base + keep).reshape(-1)].view_as(vals))
    flat[(base + cols).reshape(-1)] = vals.reshape(B * W, *buf.shape[2:])


def slot_attention(qa, k_rows, v_rows, pos):
    """Windowed attention over each slot's gathered cache rows — the
    plain oracle the ragged kernel is held to: f32 scores, the query at
    window offset q of slot b sees cache positions <= pos[b] + q, softmax,
    value contraction.  qa [B, S, H, hd]; k_rows/v_rows [B, L, H, hd]; pos
    [B].  Returns the context [B, S, H, hd] in qa's dtype."""
    S = qa.shape[1]
    scale = 1.0 / math.sqrt(qa.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", qa.float(),
                          k_rows.float()) * scale
    L = k_rows.shape[1]
    dev = qa.device
    visible = (torch.arange(L, device=dev)[None, None, :]
               <= (pos.long()[:, None]
                   + torch.arange(S, device=dev)[None, :])[:, :, None])
    scores = torch.where(visible[:, None], scores,
                         torch.full_like(scores, _MASK))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs,
                        v_rows.float()).to(qa.dtype)


def paged_window_rows(block_tables, pos, W, block_size):
    """Where lane j of slot b of an XLA paged window writes: the block
    holding ``pos[b] + j`` (a column past the table clamps to its last
    entry, as JAX's gather clamps) and the row in it.  Returns (blk, off),
    int64 ``[B * W]``."""
    bs = int(block_size)
    offs = pos.long()[:, None] + torch.arange(W, device=pos.device)[None]
    blk = torch.gather(block_tables.long(), 1,
                       torch.clamp(offs // bs, max=block_tables.shape[1] - 1))
    return blk.reshape(-1), (offs % bs).reshape(-1)


def chunk_write_rows(block_table, pos, true_len, scratch, C, block_size):
    """Where lane s of a C-token prefill chunk at ``pos`` (host ints)
    writes through ONE slot's table: lanes ``>= true_len`` into row 0 of
    the scratch block ``scratch``.  Returns (blk, off), int64 ``[C]``."""
    bs = int(block_size)
    dev = block_table.device
    lane = torch.arange(C, device=dev)
    valid = lane < int(true_len)
    offs = torch.where(valid, lane + int(pos), torch.zeros_like(lane))
    blk = block_table.long()[torch.clamp(offs // bs,
                                         max=block_table.shape[0] - 1)]
    blk = torch.where(valid, blk, torch.full_like(blk, int(scratch)))
    return blk, torch.where(valid, offs % bs, torch.zeros_like(lane))


def paged_ctx_rows(pool, blocks, dtype):
    """The adopted prefix blocks ``blocks`` (int [n]) of one pool as a
    ``[1, n * bs, H, hd]`` attention context in ``dtype`` (``QuantKV``
    pools dequantize only these blocks)."""
    if isinstance(pool, QuantKV):
        rows = dequantize_blocks(pool.codes[blocks],
                                 pool.scale[blocks]).to(dtype)
    else:
        rows = pool[blocks]
    return rows.reshape(1, -1, *rows.shape[2:])


def store_tail_blocks(pool, tail, blocks):
    """A prompt tail's K or V rows ``[s_tail, H, hd]``, zero-padded to
    whole blocks, into ``blocks`` (int [n]) of one pool, in place
    (``QuantKV`` pools quantize each whole fresh block with a fresh
    scale)."""
    n, bs = blocks.shape[0], pool.shape[1]
    tail = F.pad(tail, (0, 0, 0, 0, 0, n * bs - tail.shape[0])).reshape(
        n, bs, *tail.shape[1:])
    if isinstance(pool, QuantKV):
        codes, scale = quantize_blocks(tail)
        pool.codes[blocks] = codes
        pool.scale[blocks] = scale
    else:
        pool[blocks] = tail.to(pool.dtype)


def sample_rows(last, temperature, top_k, top_p, seed_lo, seed_hi, ctr):
    """One token per row of ``last`` [B, V] with per-row sampling
    parameters and keys derived from the seed words and counters
    (``GPTModel._sample_lanes``)."""
    keys = GPTModel._slot_sample_keys(seed_lo, seed_hi, ctr)
    return GPTModel._sample_lanes(last, temperature, top_k, top_p, keys)


class GPTEmbeddings(nn.Module):
    def __init__(self, vocab_size, hidden_size, max_position, dropout=0.1,
                 use_mp=False):
        super().__init__()
        self.word_embeddings = (
            VocabParallelEmbedding(vocab_size, hidden_size) if use_mp
            else nn.Embedding(vocab_size, hidden_size))
        self.position_embeddings = nn.Embedding(max_position, hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, input_ids, position_offset=0, position_ids=None):
        """Word plus position embeddings; positions are ``position_ids``,
        or ``position_offset + [0, S)`` (a host int), clamped into the
        table as JAX's gather clamps them."""
        if position_ids is None:
            seq = input_ids.shape[-1]
            position_ids = torch.arange(seq, device=input_ids.device) \
                + int(position_offset)
            maxp = self.position_embeddings.weight.shape[0]
            if int(position_offset) + seq > maxp:
                position_ids = torch.clamp(position_ids, max=maxp - 1)
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        return self.dropout(emb)


class GPTAttention(nn.Module):
    """Causal self-attention with fused QKV.

    Dense form: ``qkv_proj`` / ``out_proj`` Linears.  Tensor-parallel form
    (``use_mp=True``): einsum-layout weights that carry the head axis
    explicitly, as in the JAX package — ``qkv_weight [E, 3, H, hd]``,
    ``qkv_bias [3, 1, H, hd]``, ``out_weight [H, hd, E]``, ``out_bias
    [E]`` — so a mesh splits heads without a reshape across a split
    dimension; outside a mesh it computes the dense form's math.

    ``use_sp`` (True / ``"ring"`` or ``"ulysses"``) runs the training
    forward's attention through ``distributed.ring``'s sequence-parallel
    attention over the process mesh's ``sp`` axis (``set_mesh``), as the
    JAX package does; a KV-cache forward and the serving windows keep the
    plain attention."""

    def __init__(self, hidden_size, num_heads, dropout=0.1, use_mp=False,
                 use_sp=False):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = hidden_size // num_heads
        self.hidden_size = hidden_size
        self.dropout = dropout
        self.use_mp = use_mp
        self.use_sp = use_sp
        # the layer whose LoRA factors ``_out`` gathers; GPTModel stamps
        # each block's index
        self._layer_idx = 0
        if use_mp:
            H, hd = num_heads, self.head_dim
            self.qkv_weight = nn.Parameter(
                torch.empty(hidden_size, 3, H, hd).normal_(0.0, 0.02))
            self.qkv_weight.partition_spec = (None, None, "mp", None)
            self.qkv_bias = nn.Parameter(torch.zeros(3, 1, H, hd))
            self.qkv_bias.partition_spec = (None, None, "mp", None)
            self.out_weight = nn.Parameter(
                torch.empty(H, hd, hidden_size).normal_(0.0, 0.02))
            self.out_weight.partition_spec = ("mp", None, None)
            self.out_bias = nn.Parameter(torch.zeros(hidden_size))
            self.out_bias.partition_spec = ()
        else:
            self.qkv_proj = nn.Linear(hidden_size, 3 * hidden_size)
            self.out_proj = nn.Linear(hidden_size, hidden_size)

    def _qkv_mp(self, x):
        """The tensor-parallel form's QKV: ``einsum("bse,ethd->btshd")``
        plus the bias; (q, k, v) each [B, S, H, hd]."""
        x, w = amp.promote(*amp.cast_inputs("einsum", x, self.qkv_weight))
        qkv = torch.einsum("bse,ethd->btshd", x, w) + self.qkv_bias
        return qkv[:, 0], qkv[:, 1], qkv[:, 2]

    def _qkv_step(self, x):
        """Fused QKV for a window: [B, S, E] -> (q, k, v) each
        [B, S, H, hd], split on dim 2 of ``[B, S, 3, H, hd]`` (or through
        ``_qkv_mp`` in the tensor-parallel form)."""
        if self.use_mp:
            return self._qkv_mp(x)
        b, s = x.shape[0], x.shape[1]
        qkv = apply_linear(self.qkv_proj, x).view(b, s, 3, self.num_heads,
                                                  self.head_dim)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]

    def _out(self, ctx):
        """Output projection of the attention context [B, S, H, hd] ->
        [B, S, E]: ``out_proj``, or ``einsum("bshd,hde->bse")`` plus the
        bias in the tensor-parallel form.  Inside a ``_lora_scope`` (the
        JAX package's ``_lora_out``) each batch row adds its own adapter's
        delta ``(x @ a_sel^T) @ b_sel^T``, the scale folded into b, taken
        in f32 and cast to the projection's dtype; the tensor-parallel
        form refuses a scope."""
        lora = getattr(_LORA_TLS, "ctx", None)
        if self.use_mp:
            if lora is not None:
                raise ValueError(
                    "LoRA adapters ride the dense out_proj form: the "
                    "tensor-parallel attention takes no adapter lanes")
            ctx, w = amp.promote(*amp.cast_inputs("einsum", ctx,
                                                  self.out_weight))
            # on a mesh each rank holds its heads: the partial products
            # meet over mp before the bias (the identity elsewhere)
            return mesh_all_reduce(torch.einsum("bshd,hde->bse", ctx, w),
                                   "mp") + self.out_bias
        b, s = ctx.shape[0], ctx.shape[1]
        x = ctx.reshape(b, s, self.hidden_size)
        y = apply_linear(self.out_proj, x)
        if lora is None:
            return y
        a_sel = lora[0][:, self._layer_idx]               # [B, r, E]
        b_sel = lora[1][:, self._layer_idx]               # [B, E, r]
        h = torch.bmm(x.float(), a_sel.transpose(1, 2))   # [B, S, r]
        if y.dtype == torch.float32:
            # in place: y is the projection's fresh output, and the
            # out-of-place form would first copy it
            return y.baddbmm_(h, b_sel.transpose(1, 2))
        return y + torch.bmm(h, b_sel.transpose(1, 2)).to(y.dtype)

    def forward(self, x, cache=None, doc_segments=None):
        """Dense causal attention through ``scaled_dot_product_attention``
        (the flash kernels at long sequences, the reference attention
        otherwise).  In training, dropout applies to the attention
        output, before ``out_proj``, as in the JAX package.
        ``doc_segments`` int ``[B, S]`` (packed documents) keeps each
        query to its own document's keys.  With ``cache`` (k, v ``[B, P,
        H, hd]``, P may be 0) the window's K/V are appended to it and the
        queries attend over all P + S keys under the bottom-right causal
        diagonal; returns (out, (k, v)).

        Under ``use_sp`` (no cache) the causal attention is
        ``ring_attention`` or ``ulysses_attention`` over the ``sp`` axis;
        with no ``sp`` mesh set that is the single block of the JAX
        package's degenerate ring: ``_reference_attention`` in the
        activations' dtype (never the flash op, at any length), or in
        training with dropout the f32 block with dropout on the
        probabilities.  Packed documents are refused there."""
        if doc_segments is not None and self.use_sp and cache is None:
            raise NotImplementedError(
                "packed-sequence attention is not supported under "
                "sequence parallelism (the ring/all-to-all kernels "
                "build their own causal masks)")
        q, k, v = self._qkv_step(x)
        if cache is not None:
            if cache[0].shape[1]:
                k = torch.cat([cache[0], k], dim=1)
                v = torch.cat([cache[1], v], dim=1)
            cache = (k, v)
        if self.use_sp and cache is None:
            dp = self.dropout if (self.training and self.dropout) else 0.0
            gen = None
            if dp:
                gen = (torch.cuda.default_generators[q.device.index or 0]
                       if q.device.type == "cuda" else torch.default_generator)
            sp_attn = (ulysses_attention if self.use_sp == "ulysses"
                       else ring_attention)
            out = self._out(sp_attn(q, k, v, axis="sp", causal=True,
                                    dropout_p=dp, rng_key=gen))
        else:
            out = self._out(scaled_dot_product_attention(
                q, k, v, is_causal=True, dropout_p=self.dropout,
                training=self.training, segment_ids=doc_segments))
        return out if cache is None else (out, cache)

    def decode(self, x, k_buf, v_buf, pos):
        """Windowed decode at ONE shared position: the window's K/V go to
        rows ``pos..pos+S-1`` of every slot row (the start clamped so the
        window fits, as ``dynamic_update_slice`` clamps it), and query q
        sees positions <= pos + q (the unclamped pos).  x [B, S, E];
        k_buf/v_buf [B, L, H, hd], written in place; pos a host int.
        Returns (out [B, S, E], k_buf, v_buf)."""
        S = x.shape[1]
        qa, ka, va = self._qkv_step(x)
        L = k_buf.shape[1]
        start = min(max(int(pos), 0), L - S)
        k_buf[:, start:start + S] = ka
        v_buf[:, start:start + S] = va
        pos_b = torch.full((x.shape[0],), int(pos), dtype=torch.long,
                           device=x.device)
        return self._slot_attn(qa, k_buf, v_buf, pos_b), k_buf, v_buf

    def decode_slots(self, x, k_buf, v_buf, pos, in_range=False):
        """One-token decode with per-slot positions over contiguous slot
        rows: row b writes its K/V at ``pos[b]`` and attends through
        ``_slot_attn``.  x [B, 1, E]; k_buf/v_buf [B, L, H, hd], written in
        place (``scatter_slot_rows``: a position past L is dropped unless
        the caller vouches ``in_range``); pos int [B].  Returns (out
        [B, 1, E], k_buf, v_buf)."""
        if x.shape[1] != 1:
            raise ValueError(
                f"decode_slots is a one-token step (got S={x.shape[1]});"
                " windowed decode keeps the shared-position decode()")
        qa, ka, va = self._qkv_step(x)
        scatter_slot_rows(k_buf, pos, ka, in_range)
        scatter_slot_rows(v_buf, pos, va, in_range)
        return self._slot_attn(qa, k_buf, v_buf, pos), k_buf, v_buf

    def verify_slots(self, x, k_buf, v_buf, pos, in_range=False):
        """Speculative verify window over contiguous slot rows: window
        lane j of slot b writes its K/V at ``pos[b] + j`` and attends
        through the same ``_slot_attn`` as ``decode_slots``.  x
        [B, W, E]; k_buf/v_buf [B, L, H, hd], written in place (lanes past
        L dropped unless ``in_range``); pos int [B].  Returns (out
        [B, W, E], k_buf, v_buf)."""
        qa, ka, va = self._qkv_step(x)
        scatter_slot_rows(k_buf, pos, ka, in_range)
        scatter_slot_rows(v_buf, pos, va, in_range)
        return self._slot_attn(qa, k_buf, v_buf, pos), k_buf, v_buf

    def _paged_window(self, x, k_pool, v_pool, block_tables, pos):
        """The body of ``decode_slots_paged`` / ``verify_slots_paged``:
        lane j of slot b writes at logical position ``pos[b] + j`` through
        the slot's table (a column past the table clamps to its last
        entry, as JAX's gather clamps), then every slot's whole logical
        row is gathered (dequantized block by block from ``QuantKV``)
        for ``_slot_attn``."""
        qa, ka, va = self._qkv_step(x)
        B, W = qa.shape[0], qa.shape[1]
        H, hd = ka.shape[2], ka.shape[3]
        blk, off = paged_window_rows(block_tables, pos, W, k_pool.shape[1])
        write_window_kv(k_pool, v_pool, ka.reshape(B * W, H, hd),
                        va.reshape(B * W, H, hd), blk, off)
        out = self._slot_attn(qa, gather_block_rows(k_pool, block_tables),
                              gather_block_rows(v_pool, block_tables), pos)
        return out, k_pool, v_pool

    def decode_slots_paged(self, x, k_pool, v_pool, block_tables, pos):
        """One-token decode through per-slot block tables: the write goes
        to the block holding ``pos[b]``, the gathered rows through the same
        ``_slot_attn`` as ``decode_slots``.  x [B, 1, E]; k_pool/v_pool
        [NB, bs, H, hd] tensors or ``QuantKV`` (``paged_insert`` /
        ``paged_gather``), written in place; block_tables int [B, L/bs];
        pos int [B].  Returns (out [B, 1, E], k_pool, v_pool)."""
        if x.shape[1] != 1:
            raise ValueError(
                f"decode_slots_paged is a one-token step "
                f"(got S={x.shape[1]})")
        return self._paged_window(x, k_pool, v_pool, block_tables, pos)

    def verify_slots_paged(self, x, k_pool, v_pool, block_tables, pos):
        """Block-table twin of ``verify_slots``: the W window lanes
        scatter through each slot's table (fp rows, or ``QuantKV``
        touched-block inserts) and the gathered rows go through
        ``_slot_attn``.  Returns (out [B, W, E], k_pool, v_pool)."""
        return self._paged_window(x, k_pool, v_pool, block_tables, pos)

    def prefill_chunk_paged(self, x, k_pool, v_pool, block_table, pos,
                            true_len, scratch=0):
        """Chunked prefill through ONE slot's block table: C prompt
        tokens at positions ``pos..pos+C-1``; lanes ``>= true_len`` (the
        pad of a partial final chunk) write row 0 of the slot's scratch
        block ``scratch``; the queries attend over the slot's whole
        gathered row.  x [1, C, E]; block_table int [L/bs]; pos,
        true_len, scratch host ints; the pools (tensors or ``QuantKV``)
        written in place.  Returns (out [1, C, E], k_pool, v_pool)."""
        qa, ka, va = self._qkv_step(x)
        blk, off = chunk_write_rows(block_table, pos, true_len, scratch,
                                    qa.shape[1], k_pool.shape[1])
        write_window_kv(k_pool, v_pool, ka[0], va[0], blk, off)
        table = block_table[None]
        pos_b = torch.full((1,), int(pos), dtype=torch.long, device=x.device)
        out = self._slot_attn(qa, gather_block_rows(k_pool, table),
                              gather_block_rows(v_pool, table), pos_b)
        return out, k_pool, v_pool

    def _slot_attn(self, qa, k_rows, v_rows, pos):
        """``slot_attention`` then the output projection: [B, S, E]."""
        return self._out(slot_attention(qa, k_rows, v_rows, pos))

    def ragged_window_paged(self, x, k_pool, v_pool, block_tables, pos,
                            width, scratch=None, variant="stream"):
        """Ragged paged window: each slot runs its ``width[b]`` real
        lanes of the W-lane window at positions ``pos[b]..``.

        The window's K/V scatter through each slot's table with the
        width mask applied first: lanes ``s >= width[b]``, and any offset
        past the table, write into the slot's scratch block
        (``scratch[b]``, block 0 when None), so a masked lane never
        touches a live row.  The JAX version returns new (donated)
        pools; here the writes go INTO ``k_pool``/``v_pool`` in place,
        and the same pools are returned.  Quantized pools (``QuantKV``,
        ``Engine(kv_dtype="int8")``) take the same rule in insert form:
        each lane read-modify-writes its block (masked lanes row 0 of
        their scratch block) through ``paged_insert``, and the kernel
        gets the code rows plus the scale pools.  ``variant`` picks the
        kernel body: ``"stream"`` (``attn_impl="ragged"``) or
        ``"gather"`` (``attn_impl="ragged_gather"``).

        x [B, W, E]; k_pool/v_pool [NB, bs, H, hd] tensors or QuantKV;
        block_tables int32 [B, L/bs]; pos/width int32 [B]; scratch
        optional int32 [B].  Returns (out [B, W, E], k_pool, v_pool)."""
        qa, ka, va = self._qkv_step(x)
        B, W = qa.shape[0], qa.shape[1]
        bs = k_pool.shape[1]
        H, hd = self.num_heads, self.head_dim
        if scratch is None:
            scratch = torch.zeros(B, dtype=torch.int32, device=x.device)
        blk, off = window_write_rows(block_tables, pos, width, scratch, W,
                                     bs)
        write_window_kv(k_pool, v_pool, ka.reshape(B * W, H, hd),
                        va.reshape(B * W, H, hd), blk, off)
        k_rows, k_scale = kernel_view(k_pool)
        v_rows, v_scale = kernel_view(v_pool)
        ctx = ragged_paged_attention(
            qa.contiguous(), k_rows, v_rows, block_tables, pos, width,
            block_size=bs, k_scale=k_scale, v_scale=v_scale,
            variant=variant)
        return self._out(ctx), k_pool, v_pool


class GPTMLP(nn.Module):
    """Two-layer tanh-GELU MLP; in the tensor-parallel form ``fc1`` is
    column-parallel and ``fc2`` row-parallel (``[in, out]`` weights)."""

    def __init__(self, hidden_size, ffn_hidden=None, dropout=0.1,
                 use_mp=False):
        super().__init__()
        ffn_hidden = ffn_hidden or 4 * hidden_size
        if use_mp:
            self.fc1 = ColumnParallelLinear(hidden_size, ffn_hidden,
                                            gather_output=False)
            self.fc2 = RowParallelLinear(ffn_hidden, hidden_size,
                                         input_is_parallel=True)
        else:
            self.fc1 = nn.Linear(hidden_size, ffn_hidden)
            self.fc2 = nn.Linear(ffn_hidden, hidden_size)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.dropout(apply_linear(
            self.fc2, gelu(apply_linear(self.fc1, x), approximate=True)))


class GPTBlock(nn.Module):
    """Pre-LN transformer block.  ``use_recompute`` runs the block's
    training forward (``_inner``) through ``fleet.utils.recompute`` with
    ``recompute_policy``.  ``moe_experts`` > 0 swaps the MLP for a
    ``MoELayer`` of that many experts (its defaults: k=2, capacity factor
    2.0); every window below then feeds the MoE the whole ``[B, W, E]``
    window, padding and idle lanes included, as the JAX package's
    windows do."""

    def __init__(self, hidden_size, num_heads, dropout=0.1, use_mp=False,
                 use_recompute=False, moe_experts=0, recompute_policy=None,
                 use_sp=False):
        super().__init__()
        self.ln1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.attn = GPTAttention(hidden_size, num_heads, dropout, use_mp,
                                 use_sp=use_sp)
        self.ln2 = nn.LayerNorm(hidden_size, eps=1e-5)
        if moe_experts:
            self.mlp = MoELayer(hidden_size, num_experts=moe_experts)
        else:
            self.mlp = GPTMLP(hidden_size, dropout=dropout, use_mp=use_mp)
        self.use_recompute = use_recompute
        self.recompute_policy = recompute_policy

    def _inner(self, x, doc_segments=None):
        x = x + self.attn(apply_layer_norm(self.ln1, x),
                          doc_segments=doc_segments)
        return x + self.mlp(apply_layer_norm(self.ln2, x))

    def forward(self, x, cache=None, doc_segments=None):
        """With ``cache`` (GPTAttention.forward): returns (x, cache)."""
        if cache is not None:
            attn_out, cache = self.attn(apply_layer_norm(self.ln1, x),
                                        cache=cache)
            x = x + attn_out
            return x + self.mlp(apply_layer_norm(self.ln2, x)), cache
        if self.use_recompute:
            return recompute(self._inner, x, doc_segments,
                             policy=self.recompute_policy)
        return self._inner(x, doc_segments)

    def _window(self, method, x, *args, **kw):
        """Run the attention window ``method`` on ln1(x), then the MLP:
        the shared body of the block's window twins."""
        attn_out, k_pool, v_pool = getattr(self.attn, method)(
            apply_layer_norm(self.ln1, x), *args, **kw)
        x = x + attn_out
        return x + self.mlp(apply_layer_norm(self.ln2, x)), k_pool, v_pool

    def decode(self, x, k_buf, v_buf, pos):
        """Shared-position window (GPTAttention.decode)."""
        return self._window("decode", x, k_buf, v_buf, pos)

    def decode_slots(self, x, k_buf, v_buf, pos, in_range=False):
        """Per-slot one-token decode (GPTAttention.decode_slots)."""
        return self._window("decode_slots", x, k_buf, v_buf, pos,
                            in_range=in_range)

    def decode_slots_paged(self, x, k_pool, v_pool, block_tables, pos):
        """Block-table one-token decode (GPTAttention.decode_slots_paged)."""
        return self._window("decode_slots_paged", x, k_pool, v_pool,
                            block_tables, pos)

    def verify_slots(self, x, k_buf, v_buf, pos, in_range=False):
        """Speculative verify window (GPTAttention.verify_slots)."""
        return self._window("verify_slots", x, k_buf, v_buf, pos,
                            in_range=in_range)

    def verify_slots_paged(self, x, k_pool, v_pool, block_tables, pos):
        """Block-table verify window (GPTAttention.verify_slots_paged)."""
        return self._window("verify_slots_paged", x, k_pool, v_pool,
                            block_tables, pos)

    def prefill_chunk_paged(self, x, k_pool, v_pool, block_table, pos,
                            true_len, scratch=0):
        """Block-table chunk prefill (GPTAttention.prefill_chunk_paged)."""
        return self._window("prefill_chunk_paged", x, k_pool, v_pool,
                            block_table, pos, true_len, scratch=scratch)

    def ragged_window_paged(self, x, k_pool, v_pool, block_tables, pos,
                            width, scratch=None, variant="stream"):
        """Ragged paged window (GPTAttention.ragged_window_paged)."""
        attn_out, k_pool, v_pool = self.attn.ragged_window_paged(
            apply_layer_norm(self.ln1, x), k_pool, v_pool, block_tables, pos,
            width, scratch=scratch, variant=variant)
        x = x + attn_out
        x = x + self.mlp(apply_layer_norm(self.ln2, x))
        return x, k_pool, v_pool


class GPTScanBlocks(ScanLayers):
    """All transformer blocks as one stacked-parameter stack (see
    ``nn.layer.ScanLayers``): the JAX package's ``GPTScanBlocks``, its
    parameters named ``ln1.weight`` ``[L, E]``, ``attn.qkv_proj.weight``
    ``[L, 3E, E]`` and so on.  Init equals the unrolled ``ModuleList``'s
    under the same seed.  Scope: the dense and packed (``doc_segments``)
    training forward; KV-cache decode and serving run through
    ``GPTModel._sync_decode_twin``.  Tensor/sequence-parallel and MoE
    blocks stay unrolled."""

    def __init__(self, num_layers, hidden_size, num_heads, dropout=0.1,
                 use_recompute=False, recompute_policy=None):
        super().__init__(
            lambda: GPTBlock(hidden_size, num_heads, dropout),
            num_layers, use_recompute=use_recompute,
            recompute_policy=recompute_policy)


class GPTLMHead(nn.Module):
    def __init__(self, hidden_size, vocab_size, use_mp=False):
        super().__init__()
        self.ln_f = nn.LayerNorm(hidden_size, eps=1e-5)
        # the tensor-parallel head is column-parallel over vocab, weight
        # [E, V]; the dense one an nn.Linear, weight [V, E]
        self.use_mp = use_mp
        self.lm_head = (
            ColumnParallelLinear(hidden_size, vocab_size, has_bias=False)
            if use_mp else nn.Linear(hidden_size, vocab_size, bias=False))

    def forward(self, x):
        return apply_linear(self.lm_head, apply_layer_norm(self.ln_f, x))


def packed_doc_inputs(doc_lens, seq, device=None):
    """Packed-sequence (several documents a row) attention inputs, the
    JAX package's ``packed_doc_inputs``.

    ``doc_lens`` int ``[B, D]`` (or ``[D]`` for one row): zero-padded
    document lengths per row, each row summing to at most ``seq``
    (checked on the host when ``doc_lens`` is a host array, else with one
    read back).  Returns int32 ``position_ids [B, seq]`` restarting at 0
    at each document, int32 ``doc_segments [B, seq]`` (the document id
    of every position; padding gets the one-past id D, which matches no
    live document) and bool ``label_keep [B, seq]`` (False at each
    document's last token and at padding, whose next-token target lies
    outside the document), on ``device`` (``doc_lens``'s by default)."""
    dl = torch.as_tensor(doc_lens)
    if dl.dim() == 1:
        dl = dl[None, :]
    worst = int(dl.sum(dim=1).max())
    if worst > seq:
        raise ValueError(
            f"packed_doc_inputs: doc_lens sum to {worst} > seq {seq} — the "
            "tail would be silently truncated and its labels scored "
            "against phantom targets")
    dl = dl.to(device=device if device is not None else dl.device,
               dtype=torch.int32)
    dev = dl.device
    splits = torch.cat([torch.zeros((dl.shape[0], 1), dtype=torch.int32,
                                    device=dev),
                        torch.cumsum(dl, dim=1, dtype=torch.int32)], dim=1)
    pos = torch.arange(seq, dtype=torch.int32, device=dev)[None, :]
    # pos >= total implies pos >= every split, so padding lands on the
    # one-past id D with no extra masking
    doc_ids = (pos[:, :, None] >= splits[:, None, 1:]).sum(
        dim=-1, dtype=torch.int32)
    total = splits[:, -1:]
    live = pos < total
    starts = torch.gather(splits, 1, doc_ids.long())
    position_ids = torch.where(live, pos - starts,
                               torch.zeros_like(starts))
    nxt = torch.clamp(pos + 1, max=seq - 1).long().expand(doc_ids.shape)
    next_doc = torch.gather(doc_ids, 1, nxt)
    label_keep = live & (doc_ids == next_doc) & (pos + 1 < total)
    return position_ids, doc_ids, label_keep


class GPTModel(nn.Module):
    """Decoder-only LM returning logits [B, S, V], or the mean loss when
    ``forward`` gets labels.  ``use_mp=True`` builds the tensor-parallel
    form (einsum-layout attention, column/row-parallel MLP,
    vocab-parallel embedding, column-parallel head) that
    ``Engine(mesh=...)`` shards; ``to_tensor_parallel()`` relayouts a
    dense model into it.  ``use_recompute`` recomputes each block's
    activations in backward (``recompute_policy``: a
    ``fleet.utils.REMAT_POLICIES`` key); ``scan_layers`` stacks the
    blocks' parameters (``GPTScanBlocks``; the dense block only).
    ``moe_experts`` > 0 makes every ``moe_every``-th block (1-based) an
    MoE block (``distributed.moe.MoELayer``); ``TrainStep`` adds their
    aux loss.  ``use_sp`` (True / ``"ring"`` / ``"ulysses"``) runs the
    training attention sequence-parallel (``GPTAttention``)."""

    def __init__(self, num_layers=12, hidden_size=768, num_heads=12,
                 vocab_size=50304, max_position=1024, dropout=0.1,
                 fused_loss=False, fused_loss_chunk=128, use_mp=False,
                 use_sp=False, moe_experts=0, use_recompute=False,
                 scan_layers=False, moe_every=2, recompute_policy=None,
                 attn_impl="ragged"):
        super().__init__()
        if attn_impl not in ("xla", "ragged", "ragged_gather"):
            raise ValueError(
                f"attn_impl must be 'xla', 'ragged' or "
                f"'ragged_gather', got {attn_impl!r}")
        # the serving attention an Engine(attn_impl=None) takes: the
        # ragged kernels by default (JAX's default is "xla")
        self.attn_impl = attn_impl
        if moe_experts and moe_every < 1:
            raise ValueError(f"moe_every must be >= 1, got {moe_every}")
        if scan_layers and (use_mp or use_sp or moe_experts):
            raise ValueError(
                "scan_layers supports the dense block only — "
                "tensor/sequence-parallel and MoE variants use the "
                "unrolled form (their blocks are not homogeneous "
                "scan bodies)")
        # sequence-chunk size of the fused head + CE (see
        # nn/functional/loss.py fused_linear_cross_entropy)
        self.fused_loss = fused_loss
        self.fused_loss_chunk = fused_loss_chunk
        # the dense hyperparameters, from which to_tensor_parallel()
        # builds the tensor-parallel form
        self._config = dict(
            num_layers=num_layers, hidden_size=hidden_size,
            num_heads=num_heads, vocab_size=vocab_size,
            max_position=max_position, dropout=dropout,
            fused_loss=fused_loss, fused_loss_chunk=fused_loss_chunk,
            attn_impl=attn_impl)
        self.embeddings = GPTEmbeddings(vocab_size, hidden_size,
                                        max_position, dropout, use_mp)
        self.scan_layers = bool(scan_layers)
        if self.scan_layers:
            self.blocks = GPTScanBlocks(
                num_layers, hidden_size, num_heads, dropout,
                use_recompute=use_recompute,
                recompute_policy=recompute_policy)
        else:
            self.blocks = nn.ModuleList([
                GPTBlock(hidden_size, num_heads, dropout, use_mp,
                         use_recompute=use_recompute,
                         moe_experts=(moe_experts
                                      if moe_experts
                                      and (i + 1) % moe_every == 0
                                      else 0),
                         recompute_policy=recompute_policy, use_sp=use_sp)
                for i in range(num_layers)])
            for i, blk in enumerate(self.blocks):
                blk.attn._layer_idx = i
        self.head = GPTLMHead(hidden_size, vocab_size, use_mp)
        self.last_spec_forwards = None  # generate(compiled="speculative")

    @classmethod
    def from_config(cls, name, device=None, seed=0, **overrides):
        """Build a ``GPT_CONFIGS`` model on ``device`` (None = the CUDA
        card; raises without one) with weights drawn from ``seed``:
        Normal(0, 0.02) for embeddings and linear weights, zero biases,
        LayerNorm at 1 / 0, as the reference initializes them."""
        dev = resolve_device(device)
        cfg = dict(GPT_CONFIGS[name])
        cfg.update(overrides)
        with torch.device(dev):
            model = cls(**cfg)
        model.reset_parameters(seed)
        return model

    @torch.no_grad()
    def reset_parameters(self, seed=0):
        """Redraw every weight from ``seed`` (see ``from_config``).  A
        ``scan_layers`` model draws layer by layer into its stacked
        parameters, in the unrolled model's order, so both forms get the
        same weights from a seed."""
        gen = torch.Generator(device=self.head.lm_head.weight.device)
        gen.manual_seed(int(seed))
        scan = self.blocks if self.scan_layers else None
        inside = {id(m) for m in scan.modules()} if scan else set()
        for mod in self.modules():
            if mod is scan:
                for i in range(scan.num_layers):
                    for sub in scan.children():
                        for leaf in sub.modules():
                            _init_module(leaf, gen, i)
            elif id(mod) not in inside:
                _init_module(mod, gen)

    def forward(self, input_ids, labels=None, caches=None,
                position_offset=0, doc_lens=None):
        """Logits ``[B, S, V]``; with ``labels`` (int ``[B, S]``, already
        shifted, -100 ignored) the mean cross entropy instead — fused
        with the LM head per sequence chunk when ``fused_loss`` (the
        ``[B, S, V]`` logits never exist whole), else over the whole
        logits in their dtype.  ``doc_lens`` (int ``[B, D]``) packs
        several documents a row (``packed_doc_inputs``): positions
        restart at each document, attention stays within it (segment
        ids into ``scaled_dot_product_attention``), and labels at each
        document's last token and at padding become -100.  With
        ``caches`` (one (k, v) ``[B, P, H, hd]`` pair a layer, P may be
        0) the tokens run at positions ``position_offset..`` after the
        cached ones and the result is (logits, the grown caches);
        ``labels`` are then ignored, as in the JAX package."""
        doc_segments = position_ids = None
        if doc_lens is not None:
            if caches is not None:
                raise ValueError(
                    "doc_lens (packed sequences) cannot combine with "
                    "KV-cache decoding")
            position_ids, doc_segments, label_keep = packed_doc_inputs(
                doc_lens, input_ids.shape[-1], device=input_ids.device)
            if labels is not None:
                labels = torch.where(label_keep, labels,
                                     torch.full_like(labels, -100))
        if caches is not None:
            if self.scan_layers:
                raise NotImplementedError(
                    "scan_layers covers the training/forward path; for "
                    "KV-cache decode call generate(), which serves through "
                    "an unrolled twin (_sync_decode_twin)")
            x, caches = self._forward_cached(input_ids, caches,
                                             position_offset)
            return self.head(x), caches
        x = self.embeddings(input_ids, position_offset=position_offset,
                            position_ids=position_ids)
        if self.scan_layers:
            x = self.blocks(x, None, doc_segments)
        else:
            for blk in self.blocks:
                x = blk(x, doc_segments=doc_segments)
        if labels is not None and self.fused_loss:
            w = self.head.lm_head.weight
            h = apply_layer_norm(self.head.ln_f, x)
            if self.head.use_mp:
                # a mesh rank holds its vocab columns and computes their
                # part of the CE (the whole CE off a mesh)
                return vocab_parallel_linear_cross_entropy(
                    h, w, labels, "mp", chunk_size=self.fused_loss_chunk,
                    ignore_index=-100)
            return fused_linear_cross_entropy(
                h, w.t(), labels, chunk_size=self.fused_loss_chunk,
                ignore_index=-100)
        logits = self.head(x)
        if labels is not None:
            b, s, v = logits.shape
            return cross_entropy(logits.reshape(b * s, v),
                                 labels.reshape(b * s))
        return logits

    def _sync_decode_twin(self):
        """The unrolled twin a ``scan_layers`` model decodes and serves
        through: built once (on the meta device, so it allocates and draws
        nothing) from the dense hyperparameters, then every call re-points
        its parameters at the live weights — block ``i``'s at views of the
        stacked parameters' ``[i]`` slices, the rest at the same tensors —
        so a model trained in place decodes its current weights.  The twin
        sits in ``__dict__``, outside the module tree: the scan model's
        ``state_dict`` and ``parameters`` stay twin-free."""
        twin = self.__dict__.get("_decode_twin_obj")
        if twin is None:
            with torch.device("meta"):
                twin = GPTModel(**self._config)
            twin.eval()
            self.__dict__["_decode_twin_obj"] = twin
        names = set(dict(twin.named_parameters()))
        synced = set()

        def rebind(name, t):
            owner, leaf = owner_of(twin, name)  # KeyError = loud
            owner._parameters[leaf] = nn.Parameter(t, requires_grad=False)
            synced.add(name)

        for name, p in self.named_parameters():
            if name.startswith("blocks."):
                rest = name[len("blocks."):]
                for i, view in enumerate(p.detach().unbind(0)):
                    rebind(f"blocks.{i}.{rest}", view)
            else:
                rebind(name, p.detach())
        leftover = names - synced
        if leftover:
            raise RuntimeError(
                "decode twin has parameters the scan model never synced: "
                f"{sorted(leftover)[:5]}")
        return twin

    @torch.no_grad()
    def to_tensor_parallel(self):
        """The tensor-parallel form of this dense model with the SAME
        weights (``paddle_tpu``'s ``GPTModel.to_tensor_parallel``): a pure
        relayout — ``qkv_proj.weight`` read as ``[E, 3, H, hd]`` exactly
        as the dense forward's ``[b, s, 3E] -> [b, s, 3, H, hd]`` reshape
        reads it, ``out_proj.weight`` as ``[H, hd, E]``, the MLP, head and
        embedding weights in the ``[in, out]`` / ``[vocab, hidden]``
        layouts of the parallel layers.  It computes the dense math up to
        float summation order.  A tensor-parallel model returns itself;
        blocks that are not the dense variant (MoE, sequence-parallel,
        weight-only int8) are refused.  The new model lies on this one's
        device and dtype, in eval mode.  A ``scan_layers`` model relayouts
        its unrolled twin."""
        if self.scan_layers:
            return self._sync_decode_twin().to_tensor_parallel()
        if self.blocks[0].attn.use_mp:
            return self
        for i, blk in enumerate(self.blocks):
            if not hasattr(blk.mlp, "fc1"):
                raise ValueError(
                    "to_tensor_parallel supports the dense GPT variant "
                    "only — MoE blocks already carry their expert-parallel "
                    "sharding")
            if getattr(blk.attn, "use_sp", False):
                raise ValueError(
                    "to_tensor_parallel supports the dense GPT variant "
                    "only — sequence-parallel attention shards the "
                    "sequence axis, not heads")
            for name, lin in (("attn.qkv_proj", blk.attn.qkv_proj),
                              ("attn.out_proj", blk.attn.out_proj),
                              ("mlp.fc1", blk.mlp.fc1),
                              ("mlp.fc2", blk.mlp.fc2)):
                if not isinstance(lin, nn.Linear):
                    raise ValueError(
                        f"to_tensor_parallel cannot relayout blocks[{i}]."
                        f"{name} ({type(lin).__name__}): the tensor-parallel "
                        "form takes dense Linear weights — convert before "
                        "weight_dtype='int8', or serve the model dense")
        ref = self.head.ln_f.weight
        with torch.device(ref.device):
            tp = GPTModel(use_mp=True, **self._config)
        tp.to(ref.dtype)
        attn0 = self.blocks[0].attn
        H, hd, E = attn0.num_heads, attn0.head_dim, attn0.hidden_size
        copies = [
            (tp.embeddings.word_embeddings.weight,
             self.embeddings.word_embeddings.weight),
            (tp.embeddings.position_embeddings.weight,
             self.embeddings.position_embeddings.weight),
            (tp.head.ln_f.weight, self.head.ln_f.weight),
            (tp.head.ln_f.bias, self.head.ln_f.bias),
            (tp.head.lm_head.weight, self.head.lm_head.weight.t())]
        for sb, tb in zip(self.blocks, tp.blocks):
            sa, ta = sb.attn, tb.attn
            copies += [
                (tb.ln1.weight, sb.ln1.weight), (tb.ln1.bias, sb.ln1.bias),
                (tb.ln2.weight, sb.ln2.weight), (tb.ln2.bias, sb.ln2.bias),
                (ta.qkv_weight, sa.qkv_proj.weight.t().reshape(E, 3, H, hd)),
                (ta.qkv_bias, sa.qkv_proj.bias.reshape(3, H, hd)[:, None]),
                (ta.out_weight, sa.out_proj.weight.t().reshape(H, hd, E)),
                (ta.out_bias, sa.out_proj.bias)]
            for fc in ("fc1", "fc2"):
                copies += [
                    (getattr(tb.mlp, fc).weight,
                     getattr(sb.mlp, fc).weight.t()),
                    (getattr(tb.mlp, fc).bias, getattr(sb.mlp, fc).bias)]
        for dst, src in copies:
            dst.copy_(src)
        tp.eval()
        return tp

    # -- sampling ---------------------------------------------------------
    @staticmethod
    def _filter_logits_lanes(last, temperature, top_k, top_p):
        """Per-lane sampling filters on f32 logits [B, V]: temperature,
        then top-k, then top-p over the already-masked row, each
        parameter a [B] tensor.  ``top_k == 0`` / ``top_p == 1`` disable
        their filter lane-wise, and a ``temperature == 0`` greedy lane
        passes through at temperature 1."""
        V = last.shape[-1]
        t_eff = torch.where(temperature > 0, temperature,
                            torch.ones_like(temperature))[:, None]
        x = last / t_eff
        srt = torch.sort(x, dim=-1, descending=True).values
        k_eff = torch.clamp(top_k.long(), 1, V)
        kth = torch.gather(srt, 1, (k_eff - 1)[:, None])
        x = torch.where((top_k > 0)[:, None] & (x < kth),
                        torch.full_like(x, -1e9), x)
        p_eff = torch.clamp(top_p, min=1e-9)[:, None]
        srt2 = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(srt2, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < p_eff
        cutoff = torch.where(keep, srt2, torch.full_like(srt2, math.inf)
                             ).amin(dim=-1, keepdim=True)
        return torch.where((top_p < 1.0)[:, None] & (x < cutoff),
                           torch.full_like(x, -1e9), x)

    @staticmethod
    def _slot_sample_keys(seed_lo, seed_hi, ctr):
        """Per-lane 64-bit sampling keys, as int64 tensors on ``ctr``'s
        device: ``mix64((hi << 32 | lo) ^ mix64(ctr))`` of the request's
        seed words and the emitted-token counter, so token i of a request
        always draws from key(seed, i), whether a decode tick or a final
        prefill chunk emits it.  Elementwise: the three may broadcast."""
        dev = torch.as_tensor(ctr).device
        lo = torch.as_tensor(seed_lo, device=dev).long() & 0xFFFFFFFF
        hi = torch.as_tensor(seed_hi, device=dev).long() & 0xFFFFFFFF
        word = (hi * (1 << 32)) | lo   # wraps into the sign bit
        return _mix64(word ^ _mix64(torch.as_tensor(ctr).long()))

    @staticmethod
    def _key_uniform(keys):
        """A float64 in (0, 1] from each int64 key: its top 53 bits plus
        one, over 2**53 (exact in float64)."""
        return (_shr(keys, 11) + 1).double() * 2.0 ** -53

    @staticmethod
    def _sample_lanes(last, temperature, top_k, top_p, keys):
        """One token per row of [B, V] logits with per-lane parameters:
        lanes with ``temperature == 0`` (the greedy sentinel) take the
        raw argmax (the first maximum, as in jnp), sampling lanes draw
        from the lane-filtered distribution by inverse CDF at their
        key's uniform number (``keys``: int64 [B] from
        ``_slot_sample_keys``).  The draw is the first token whose
        cumulative probability (float64) reaches u times the total, so a
        filtered-out token (probability exactly 0) is never drawn.  Runs
        on the device and reads nothing back.  ``keys=None`` says no lane
        samples: the filter and the draw are skipped.  Returns int32
        [B]."""
        last = last.float()
        greedy = torch.argmax(last, dim=-1).to(torch.int32)
        if keys is None:  # the caller knows no lane samples
            return greedy
        filt = GPTModel._filter_logits_lanes(last, temperature, top_k,
                                             top_p)
        cum = torch.cumsum(torch.softmax(filt, dim=-1).double(), dim=-1)
        target = GPTModel._key_uniform(keys) * cum[:, -1]
        drawn = torch.searchsorted(cum, target[:, None]).squeeze(1)
        # NaN logits would search past the end: keep the id a valid row
        # of the embedding the next tick reads
        drawn = torch.clamp(drawn, max=last.shape[-1] - 1).to(torch.int32)
        return torch.where(temperature > 0, drawn, greedy)

    # -- generation ---------------------------------------------------------
    def _decode_window(self, toks, k_bufs, v_bufs, pos):
        """S tokens of every row at the shared positions ``pos..pos+S-1``
        (a host int) against fixed-size cache buffers [B, L, H, hd], in
        one forward through each block's ``decode`` (the buffers are
        written in place).  Returns (logits [B, S, V], k_bufs, v_bufs)."""
        x = self.embeddings(toks, position_offset=pos)
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.decode(x, k_bufs[j], v_bufs[j], pos)
        return self.head(x), k_bufs, v_bufs

    def _decode_tick(self, tok, k_bufs, v_bufs, pos):
        """One-token step of ``_decode_window``: (last logits [B, V],
        k_bufs, v_bufs)."""
        logits, k_bufs, v_bufs = self._decode_window(tok, k_bufs, v_bufs,
                                                     pos)
        return logits[:, -1], k_bufs, v_bufs

    def _prefill_buffers(self, ids, L):
        """The prompt's forward over empty caches, its K/V copied into
        zeroed buffers [B, L, H, hd] a layer (the JAX package's
        ``_compiled_prefill_fn``).  Returns (last logits [B, V], k_bufs,
        v_bufs)."""
        b, s = ids.shape
        attn0 = self.blocks[0].attn
        H, hd = attn0.num_heads, attn0.head_dim
        dtype = self._cache_dtype()
        empty = [(torch.zeros((b, 0, H, hd), dtype=dtype, device=ids.device),
                  torch.zeros((b, 0, H, hd), dtype=dtype, device=ids.device))
                 for _ in self.blocks]
        x, caches = self._forward_cached(ids, empty)
        k_bufs, v_bufs = [], []
        for ck, cv in caches:
            kb = ck.new_zeros((b, L, H, hd))
            vb = cv.new_zeros((b, L, H, hd))
            kb[:, :s] = ck
            vb[:, :s] = cv
            k_bufs.append(kb)
            v_bufs.append(vb)
        return self.head(x[:, -1:])[:, 0], k_bufs, v_bufs

    def _cache_dtype(self):
        """The K/V dtype: the QKV projection's compute dtype (read first:
        a weight-only int8 projection's ``.weight`` would materialize the
        dequantized matrix)."""
        attn0 = self.blocks[0].attn
        if attn0.use_mp:
            return attn0.qkv_weight.dtype
        return (getattr(attn0.qkv_proj, "compute_dtype", None)
                or attn0.qkv_proj.weight.dtype)

    @staticmethod
    def _generate_pick(last, do_sample, temperature, top_k, top_p, seed,
                       ctr):
        """Tokens from logits [N, V]: the argmax (the first maximum), or
        the draw of ``_sample_lanes`` with key(seed, ``ctr``) per row
        (``ctr`` int64 [N] on the logits' device).  Reads nothing back.
        Returns int64 [N]."""
        last = last.float()
        if not do_sample:
            return torch.argmax(last, dim=-1)
        n, dev = last.shape[0], last.device
        keys = GPTModel._slot_sample_keys(seed & 0xFFFFFFFF,
                                          (seed >> 32) & 0xFFFFFFFF, ctr)
        return GPTModel._sample_lanes(
            last, torch.full((n,), float(temperature), device=dev),
            torch.full((n,), int(top_k or 0), dtype=torch.int32, device=dev),
            torch.full((n,), float(top_p), device=dev), keys).long()

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=20, temperature=1.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=None,
                 compiled=False, draft_k=8, lookup_ngram=3):
        """KV-cached autoregressive decoding of a batch of prompts (the JAX
        package's ``GPTModel.generate``): greedy, or top-k / top-p nucleus
        sampling (``top_p <= 0`` keeps the top token) when a sampling
        parameter is set.  ``input_ids`` int [B, S] (a tensor, numpy array
        or nested list); returns int64 [B, S + new] on the model's device.

        The modes name code paths (nothing is compiled):

        * ``compiled=False``: eager, caches growing from length 0
          (``forward(caches=)``), one host read a token for the eos stop;
        * ``compiled=True`` (or any other true value, as in JAX): the
          prompt's K/V in buffers of length L = S + max_new_tokens, then
          one ``_decode_tick`` (the shared-position ``decode`` window) a
          token;
        * ``compiled="fused"``: the same steps with sampling on the device
          and no host read until the end, then truncation after the first
          step where every row emitted ``eos_token_id``;
        * ``compiled="speculative"``: prompt-lookup drafts of ``draft_k``
          tokens (the most recent earlier occurrence of the last
          ``lookup_ngram`` tokens) verified in one ``_decode_window`` of
          ``draft_k + 1`` tokens; the batch advances by its smallest
          accepted count, so every row stays its own greedy (or sampled)
          trajectory.  One host read a window (the cursor);
          ``last_spec_forwards`` counts the windows.

        Greedy output is token-identical across the modes and to JAX's.
        Draws use the port's splitmix64 keys (``_slot_sample_keys``), not
        jax's threefry, so a seed repeats its stream but does not
        reproduce JAX's: token i of row r draws with key(seed, i * B + r)
        in the first three modes (they share their draws given the same
        logits), and as in JAX the speculative windows draw per (window,
        row, position), key(seed, (n * B + r) * (draft_k + 1) + j), the
        first token with key(seed, 2**30 + r).  ``seed=None`` takes a
        seed from torch's default generator.  A ``scan_layers`` model
        decodes through its unrolled twin (``_sync_decode_twin``)."""
        if self.scan_layers:
            twin = self._sync_decode_twin()
            out = twin.generate(
                input_ids, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_token_id=eos_token_id, seed=seed, compiled=compiled,
                draft_k=draft_k, lookup_ngram=lookup_ngram)
            self.last_spec_forwards = twin.last_spec_forwards
            return out
        dev = self.head.lm_head.weight.device
        ids = torch.as_tensor(input_ids, device=dev).long()
        if ids.dim() != 2:
            raise ValueError(
                f"generate: input_ids must be [B, S], got {tuple(ids.shape)}")
        b, s = ids.shape
        if max_new_tokens <= 0:
            return ids  # every path: the prompt unchanged, no sampling
        max_position = self.embeddings.position_embeddings.weight.shape[0]
        if s + max_new_tokens > max_position:
            raise ValueError(
                f"generate: prompt ({s}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_position ({max_position}) "
                "— positions past the table would silently clamp")
        if compiled == "speculative" \
                and s + max_new_tokens + draft_k > max_position:
            raise ValueError(
                "generate(compiled='speculative'): the verify window can "
                f"reach position {s + max_new_tokens + draft_k - 1} >= "
                f"max_position ({max_position}) — lower draft_k or "
                "max_new_tokens")
        do_sample = bool((top_k and top_k > 0) or temperature != 1.0
                         or top_p < 1.0)
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (1,)))
        seed = int(seed) & 0xFFFFFFFFFFFFFFFF
        rows = torch.arange(b, device=dev)

        def pick(last, ctr):
            return self._generate_pick(last, do_sample, temperature, top_k,
                                       top_p, seed, ctr)

        def truncate_at_eos(toks):
            # stop after the first step where every row emitted eos, as
            # the eager loop does
            if eos_token_id is None:
                return toks
            all_eos = (toks == int(eos_token_id)).all(dim=0)
            if bool(all_eos.any()):
                toks = toks[:, :int(torch.argmax(all_eos.int())) + 1]
            return toks

        was_training = self.training
        self.eval()
        try:
            if compiled == "speculative":
                toks = self._speculative_decode(
                    ids, max_new_tokens, int(draft_k), int(lookup_ngram),
                    pick)
                return torch.cat([ids, truncate_at_eos(toks)], dim=1)
            if compiled:
                last, k_bufs, v_bufs = self._prefill_buffers(
                    ids, s + max_new_tokens)
            else:
                H, hd = self.blocks[0].attn.num_heads, \
                    self.blocks[0].attn.head_dim
                empty = torch.zeros((b, 0, H, hd), dtype=self._cache_dtype(),
                                    device=dev)
                caches = [(empty, empty) for _ in self.blocks]
                x, caches = self._forward_cached(ids, caches)
                last = self.head(x[:, -1:])[:, 0]
            out = []
            for step in range(max_new_tokens):
                nxt = pick(last, step * b + rows).view(b, 1)
                out.append(nxt)
                if compiled != "fused" and eos_token_id is not None \
                        and bool((nxt == int(eos_token_id)).all()):
                    break
                if step == max_new_tokens - 1:
                    break  # the last token needs no forward
                if compiled:
                    last = self._decode_tick(nxt, k_bufs, v_bufs,
                                             s + step)[0]
                else:
                    logits, caches = self.forward(
                        nxt, caches=caches, position_offset=s + step)
                    last = logits[:, -1]
            toks = torch.cat(out, dim=1)
            if compiled == "fused":
                toks = truncate_at_eos(toks)
            return torch.cat([ids, toks], dim=1)
        finally:
            if was_training:
                self.train()

    def _speculative_decode(self, ids, max_new, draft_k, ngram, pick):
        """``generate(compiled="speculative")``'s loop (the JAX package's
        ``_spec_generate_fn``, step for step): returns the new tokens
        [B, max_new] and sets ``last_spec_forwards``.  ``pick(logits [N,
        V], ctr [N])`` picks tokens."""
        b, s = ids.shape
        dev = ids.device
        W = draft_k + 1
        T = s + max_new + W          # margin: a window never clamps
        last0, k_bufs, v_bufs = self._prefill_buffers(ids, T)
        rows = torch.arange(b, device=dev)
        seq = torch.zeros((b, T), dtype=torch.long, device=dev)
        seq[:, :s] = ids
        seq[:, s] = pick(last0, 2 ** 30 + rows)
        t_idx = torch.arange(T, device=dev)
        win_idx = torch.clamp(
            t_idx[:, None] + torch.arange(ngram, device=dev)[None], max=T - 1)
        d_lane = torch.arange(draft_k, device=dev)
        lanes = torch.arange(W, device=dev)
        pos, n_out, n_fwd = s, 0, 0
        while n_out < max_new - 1:
            cur = seq[:, pos:pos + 1]
            # the draft: the tokens after the most recent earlier
            # occurrence of the trailing n-gram (windows ending before
            # pos), else the current token repeated
            ps = min(max(pos - (ngram - 1), 0), T - ngram)
            pat = seq[:, ps:ps + ngram]
            ok = (seq[:, win_idx] == pat[:, None, :]).all(dim=-1) \
                & ((t_idx + ngram - 1) < pos)[None]
            found = ok.any(dim=1)
            j = torch.where(
                found, T - 1 - torch.argmax(ok.flip(1).int(), dim=1),
                torch.zeros_like(rows))
            dstart = torch.clamp(j + ngram, 0, T - draft_k)
            d = torch.gather(seq, 1, dstart[:, None] + d_lane[None])
            d = torch.where(found[:, None], d, cur.expand(b, draft_k))
            logits = self._decode_window(torch.cat([cur, d], dim=1), k_bufs,
                                         v_bufs, pos)[0]      # [B, W, V]
            ctr = (n_fwd * b + rows)[:, None] * W + lanes[None]
            preds = pick(logits.reshape(b * W, -1),
                         ctr.reshape(-1)).view(b, W)
            match = d == preds[:, :draft_k]
            m_row = torch.argmin(torch.cat(
                [match, torch.zeros((b, 1), dtype=torch.bool, device=dev)],
                dim=1).int(), dim=1)
            seq[:, pos + 1:pos + 1 + W] = preds
            adv = int(m_row.min()) + 1   # the host read: the cursor
            pos += adv
            n_out += adv
            n_fwd += 1
        self.last_spec_forwards = n_fwd
        return seq[:, s:s + max_new]

    # -- prefill ----------------------------------------------------------
    def _forward_cached(self, input_ids, caches, position_offset=0):
        """Embeddings at ``position_offset..`` and every block with its
        cache (``GPTBlock.forward(cache=)``).  Returns (hidden states
        before the head, the grown caches)."""
        x = self.embeddings(input_ids, position_offset=position_offset)
        new_caches = []
        for blk, cache in zip(self.blocks, caches):
            x, cache = blk(x, cache=cache)
            new_caches.append(cache)
        return x, new_caches

    def _last_logits(self, x, n):
        """The LM head at the ``n``-th position (a host int; index n - 1)
        of x [1, S, E] only: the head is per-position, so the other rows
        need no vocab matmul.  Returns [1, V]."""
        i = min(max(int(n) - 1, 0), x.shape[1] - 1)  # dynamic_slice clamp
        return self.head(x[:, i:i + 1])[:, 0]

    def _prefill_slot(self, ids, k_pools, v_pools, slot, true_len=None):
        """Whole-prompt prefill of one request into row ``slot`` of the
        contiguous pools ``[B, L, H, hd]`` (the JAX engine's
        ``_compiled_prefill_fn`` plus its row insert, in place): the
        prompt's forward over empty caches, its K/V at positions
        ``[0, S)`` and zeros over the rest of the row, so nothing of an
        earlier request stays in it.  Bucketed prefill
        (``_compiled_bucket_prefill_fn``) passes ``ids`` right-padded to
        the bucket length S and the prompt's ``true_len``: the logits are
        read at ``true_len - 1``, and the pad tail's K/V are stored as
        JAX stores them (causal attention hides them until decode
        overwrites them).  At S >= 2048 (a multiple of 128) the attention
        is the flash kernel's.  Returns the last logits [1, V]."""
        S = ids.shape[1]
        H, hd = k_pools[0].shape[2], k_pools[0].shape[3]
        empty = [(kp.new_zeros((1, 0, H, hd)), vp.new_zeros((1, 0, H, hd)))
                 for kp, vp in zip(k_pools, v_pools)]
        x, caches = self._forward_cached(ids, empty)
        for (ck, cv), kp, vp in zip(caches, k_pools, v_pools):
            kp[slot, :S] = ck[0]
            vp[slot, :S] = cv[0]
            kp[slot, S:] = 0
            vp[slot, S:] = 0
        return self._last_logits(x, S if true_len is None else true_len)

    def _prefill_paged(self, ids_tail, k_pools, v_pools, ctx_blocks,
                       tail_blocks):
        """Block-granular admission prefill (the JAX engine's
        ``_compiled_paged_prefill_fn``, in place): the adopted prefix
        blocks ``ctx_blocks`` (int [n_ctx]; ``QuantKV`` pools dequantize
        only these, ``_ctx_rows``) are the attention context, the
        prompt's tail ``ids_tail`` [1, s_tail] runs at positions
        ``n_ctx * bs..``, and its K/V, zero-padded to whole blocks, are
        stored into ``tail_blocks`` (int [n_tail]; ``QuantKV`` pools
        quantize each whole fresh block with a fresh scale,
        ``_store_tail``).  Returns the last logits [1, V]."""
        s_tail = ids_tail.shape[1]
        ctx_len = ctx_blocks.shape[0] * k_pools[0].shape[1]
        # in the compute dtype, where the window's K/V join them
        dt = self.head.ln_f.weight.dtype
        caches = [(paged_ctx_rows(kp, ctx_blocks, dt),
                   paged_ctx_rows(vp, ctx_blocks, dt))
                  for kp, vp in zip(k_pools, v_pools)]
        x, caches = self._forward_cached(ids_tail, caches,
                                         position_offset=ctx_len)
        for (ck, cv), kp, vp in zip(caches, k_pools, v_pools):
            store_tail_blocks(kp, ck[0, ctx_len:], tail_blocks)
            store_tail_blocks(vp, cv[0, ctx_len:], tail_blocks)
        return self._last_logits(x, s_tail)

    def _chunk_prefill_tick(self, toks, k_bufs, v_bufs, pos, true_len):
        """One chunk of a prompt against contiguous cache rows: C tokens
        at positions ``pos..pos+C-1`` through each block's shared-position
        ``decode``, the head on the last real lane (``true_len - 1``)
        only.  toks [1, C]; k_bufs/v_bufs [1, L, H, hd] rows (views of the
        pools, written in place); pos, true_len host ints.  Returns
        (last logits [1, V], k_bufs, v_bufs)."""
        x = self.embeddings(toks, position_offset=pos)
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.decode(x, k_bufs[j], v_bufs[j], pos)
        return self._last_logits(x, true_len), k_bufs, v_bufs

    def _chunk_prefill_slot(self, toks, k_pools, v_pools, slot, pos,
                            true_len):
        """The JAX engine's ``_compiled_chunk_prefill_fn``: one chunk into
        row ``slot`` of the contiguous pools, in place (its rows are
        views).  Returns the last logits [1, V]."""
        rows_k = [kp[slot:slot + 1] for kp in k_pools]
        rows_v = [vp[slot:slot + 1] for vp in v_pools]
        return self._chunk_prefill_tick(toks, rows_k, rows_v, pos,
                                        true_len)[0]

    def _chunk_prefill_tick_paged(self, toks, k_pools, v_pools,
                                  block_table, pos, true_len, scratch=0):
        """Paged twin of ``_chunk_prefill_tick`` (the JAX engine's
        ``_compiled_paged_chunk_prefill_fn``): the chunk's K/V scatter
        through ONE slot's table (pad lanes into its scratch block) and
        the queries see the slot's whole gathered row.  Returns (last
        logits [1, V], k_pools, v_pools)."""
        x = self.embeddings(toks, position_offset=pos)
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.prefill_chunk_paged(
                x, k_pools[j], v_pools[j], block_table, pos, true_len,
                scratch=scratch)
        return self._last_logits(x, true_len), k_pools, v_pools

    # -- XLA engine ticks ------------------------------------------------
    def _window_positions(self, pos, W):
        """Positions ``pos[b] + [0, W)`` of a slot window, clamped into
        the position table as JAX's gather clamps them: [B, W]."""
        maxp = self.embeddings.position_embeddings.weight.shape[0]
        return torch.clamp(pos.long()[:, None]
                           + torch.arange(W, device=pos.device)[None],
                           max=maxp - 1)

    def _decode_tick_slots(self, tok, k_bufs, v_bufs, pos, in_range=False):
        """One-token decode over contiguous slot rows (the JAX engine's
        slot decode): every row b an independent request at ``pos[b]``.
        tok int [B, 1]; pos int [B]; pools written in place.  Returns
        (last logits [B, V], k_bufs, v_bufs)."""
        x = self.embeddings(tok, position_ids=self._window_positions(pos, 1))
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.decode_slots(x, k_bufs[j], v_bufs[j], pos,
                                       in_range=in_range)
        return self.head(x)[:, -1], k_bufs, v_bufs

    def _decode_tick_slots_paged(self, tok, k_pools, v_pools, block_tables,
                                 pos):
        """One-token decode over a paged slot pool (the JAX engine's slot
        paged decode).  Returns (last logits [B, V], k_pools, v_pools)."""
        x = self.embeddings(tok, position_ids=self._window_positions(pos, 1))
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.decode_slots_paged(x, k_pools[j], v_pools[j],
                                             block_tables, pos)
        return self.head(x)[:, -1], k_pools, v_pools

    def _spec_verify_tick_slots(self, toks, k_bufs, v_bufs, pos,
                                in_range=False):
        """Speculative verify over contiguous slot rows: every slot's W =
        k+1 window tokens at ``pos[b]..`` in one forward.  Returns (logits
        [B, W, V], k_bufs, v_bufs)."""
        x = self.embeddings(toks, position_ids=self._window_positions(
            pos, toks.shape[1]))
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.verify_slots(x, k_bufs[j], v_bufs[j], pos,
                                       in_range=in_range)
        return self.head(x), k_bufs, v_bufs

    def _spec_verify_tick_slots_paged(self, toks, k_pools, v_pools,
                                      block_tables, pos):
        """Paged twin of ``_spec_verify_tick_slots``.  Returns (logits
        [B, W, V], k_pools, v_pools)."""
        x = self.embeddings(toks, position_ids=self._window_positions(
            pos, toks.shape[1]))
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.verify_slots_paged(x, k_pools[j], v_pools[j],
                                             block_tables, pos)
        return self.head(x), k_pools, v_pools

    def _fused_decode_tick_slots(self, tok, k_bufs, v_bufs, pos, temp,
                                 top_k, top_p, seed_lo, seed_hi, ctr, eos,
                                 rem, block_tables=None, any_sampling=None,
                                 in_range=False):
        """One-token decode plus the on-device sample and stop condition
        (the JAX engine's fused decode tick), contiguous or, with
        ``block_tables``, paged: ``fused_decode_tick``.  Returns (ids [B],
        done bool [B], new_tok [B, 1], new_pos [B], new_ctr [B], new_rem
        [B], k_bufs, v_bufs); nothing is read back."""
        L = (k_bufs[0].shape[1] if block_tables is None
             else block_tables.shape[1] * k_bufs[0].shape[1])
        return fused_decode_tick(
            self, tok, k_bufs, v_bufs, pos, temp, top_k, top_p, seed_lo,
            seed_hi, ctr, eos, rem, L=L, block_tables=block_tables,
            any_sampling=any_sampling, in_range=in_range)

    def _fused_spec_verify_tick_slots(self, toks, k_bufs, v_bufs, pos,
                                      lanes, temp, top_k, top_p, seed_lo,
                                      seed_hi, ctr, eos, rem,
                                      block_tables=None, any_sampling=None,
                                      in_range=False):
        """Speculative verify plus on-device picks, accept scan and stop
        condition (the JAX engine's fused verify tick):
        ``fused_spec_verify_tick``.  Returns (picks [B, W], n_acc [B],
        n_emit [B], done bool [B], new_tok [B, 1], new_pos [B], new_ctr
        [B], new_rem [B], k_bufs, v_bufs)."""
        L = (k_bufs[0].shape[1] if block_tables is None
             else block_tables.shape[1] * k_bufs[0].shape[1])
        return fused_spec_verify_tick(
            self, toks, k_bufs, v_bufs, pos, lanes, temp, top_k, top_p,
            seed_lo, seed_hi, ctr, eos, rem, L=L, block_tables=block_tables,
            any_sampling=any_sampling, in_range=in_range)

    # -- ragged engine tick -------------------------------------------------
    def _ragged_window_tick_slots(self, toks, k_pools, v_pools,
                                  block_tables, pos, width, scratch=None,
                                  head_lanes=None, variant="stream"):
        """Run each slot's ``width[b]`` real window tokens (of W) at
        positions ``pos[b]..`` through every block's
        ``ragged_window_paged``: decode lanes and prefill chunks in one
        pass.  ``head_lanes`` (int [B, K]) gathers K lanes per slot
        before the LM head, so the vocab matmul pays only for lanes
        something reads; ``variant`` picks the attention kernel body
        (``"stream"`` or ``"gather"``), and the pools may be tensors or
        ``QuantKV``.  Returns (logits [B, W or K, V], k_pools, v_pools);
        the pools are written in place."""
        W = toks.shape[1]
        maxp = self.embeddings.position_embeddings.weight.shape[0]
        # the clamp only guards the discarded lanes past width; real
        # lanes satisfy pos + s < max_position by admission
        pids = torch.clamp(
            pos.long()[:, None] + torch.arange(W, device=toks.device)[None],
            max=maxp - 1)
        x = self.embeddings(toks, position_ids=pids)
        for j, blk in enumerate(self.blocks):
            x, _, _ = blk.ragged_window_paged(
                x, k_pools[j], v_pools[j], block_tables, pos, width,
                scratch=scratch, variant=variant)
        if head_lanes is not None:
            x = torch.gather(
                x, 1, head_lanes.long()[:, :, None].expand(-1, -1,
                                                           x.shape[-1]))
        return self.head(x), k_pools, v_pools

    def _fused_ragged_tick_slots(self, toks, k_pools, v_pools,
                                 block_tables, width, mode, lanes, tok,
                                 pos, temp, top_k, top_p, seed_lo,
                                 seed_hi, ctr, eos, rem, scratch=None,
                                 emit_w=None, variant="stream",
                                 any_sampling=None, any_final=None):
        """One engine tick: the ragged window plus the sample /
        accept-scan / stop-condition epilogue.  Per-slot ``mode``:

        * 0 — decode window: lane 0 is the slot's current token (``tok``),
          lane j is sampled with key(seed, ctr + j), the longest accepted
          prefix is scanned (one lane without drafts), and eos / the
          remaining budget stop the lane.
        * 1 — prefill chunk: ``width[b]`` prompt tokens are written; the
          cursor advances by the width, nothing is sampled.
        * 2 — final prefill chunk: as mode 1, plus the last real lane's
          logits sample the next token with the UNSHIFTED key(seed, ctr),
          delivered on picks lane 0.

        Width-0 (parked) slots and finished lanes (rem 0) keep tok, pos
        and ctr.  ``variant`` (``"stream"``/``"gather"``) and the pool
        form (tensors or ``QuantKV``) pass through to every layer's
        ``ragged_window_paged``.  ``any_sampling`` / ``any_final`` are
        facts the caller knows from its host state: whether some lane has
        ``temp > 0``, whether some lane is mode 2.  False skips the
        sampling filter / the last lane's pick; None (not known) computes
        them, so the epilogue never reads a device tensor back.  Returns
        (picks [B, E], n_acc [B], n_emit [B], done bool [B], new_tok
        [B, 1], new_pos [B], new_ctr [B], new_rem [B], k_pools, v_pools)
        with E = min(W, emit_w)."""
        return fused_ragged_tick(
            self, toks, k_pools, v_pools, block_tables, width, mode, lanes,
            tok, pos, temp, top_k, top_p, seed_lo, seed_hi, ctr, eos, rem,
            block_size=k_pools[0].shape[1], scratch=scratch, emit_w=emit_w,
            variant=variant, any_sampling=any_sampling,
            any_final=any_final)


def _init_module(mod, gen, layer=None):
    """The reference initialization of one module's own weights:
    Normal(0, 0.02) for embeddings, linear weights, MoE routers and
    expert stacks, zero biases, LayerNorm at 1 / 0.  ``layer`` selects
    index ``layer`` of stacked parameters."""
    def at(t):
        return t if layer is None else t[layer]

    if isinstance(mod, (nn.Linear, nn.Embedding, ColumnParallelLinear,
                        RowParallelLinear, VocabParallelEmbedding)):
        at(mod.weight).normal_(0.0, 0.02, generator=gen)
        if getattr(mod, "bias", None) is not None:
            at(mod.bias).zero_()
    elif isinstance(mod, MoELayer):
        at(mod.gate).normal_(0.0, 0.02, generator=gen)
    elif isinstance(mod, ExpertFFN):
        at(mod.w1).normal_(0.0, 0.02, generator=gen)
        at(mod.w2).normal_(0.0, 0.02, generator=gen)
        at(mod.b1).zero_()
        at(mod.b2).zero_()
    elif isinstance(mod, GPTAttention) and mod.use_mp:
        at(mod.qkv_weight).normal_(0.0, 0.02, generator=gen)
        at(mod.out_weight).normal_(0.0, 0.02, generator=gen)
        at(mod.qkv_bias).zero_()
        at(mod.out_bias).zero_()
    elif isinstance(mod, nn.LayerNorm):
        at(mod.weight).fill_(1.0)
        at(mod.bias).zero_()


class GPTPretrainingCriterion(nn.Module):
    """Next-token CE over shifted logits (PaddleNLP GPT criterion shape):
    ``[B, S, V]`` logits against int ``[B, S]`` labels, -100 ignored."""

    def forward(self, logits, labels):
        b, s, v = logits.shape
        return cross_entropy(logits.reshape(b * s, v),
                             labels.reshape(b * s))


def gpt_pipe_model(name="gpt2-medium", device=None, seed=0, **overrides):
    """The ``PipelineLayer`` form of a ``GPT_CONFIGS`` model, as the JAX
    package's ``gpt_pipe_model``: ``pre`` the embeddings, the blocks,
    ``post`` the head (logits; train it with ``GPTPretrainingCriterion``),
    ``use_mp`` honoured.  Built on ``device`` (None = the CUDA card) with
    weights drawn from ``seed`` in ``GPTModel.from_config``'s order, so the
    same name, overrides and seed give the same weights as that model."""
    from ..distributed.fleet.meta_parallel import PipelineLayer
    dev = resolve_device(device)
    cfg = dict(GPT_CONFIGS[name])
    cfg.update(overrides)
    hidden, heads = cfg.pop("hidden_size"), cfg.pop("num_heads")
    vocab, use_mp = cfg.pop("vocab_size"), cfg.pop("use_mp", False)
    dropout = cfg.pop("dropout", 0.1)
    with torch.device(dev):
        pipe = PipelineLayer(
            pre=GPTEmbeddings(vocab, hidden, cfg.pop("max_position"),
                              dropout, use_mp),
            blocks=[GPTBlock(hidden, heads, dropout, use_mp)
                    for _ in range(cfg.pop("num_layers"))],
            post=GPTLMHead(hidden, vocab, use_mp))
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    with torch.no_grad():
        for mod in pipe.modules():
            _init_module(mod, gen)
    return pipe


def fused_ragged_tick(model, toks, k_pools, v_pools, block_tables, width,
                      mode, lanes, tok, pos, temp, top_k, top_p, seed_lo,
                      seed_hi, ctr, eos, rem, *, block_size, scratch=None,
                      emit_w=None, variant="stream", any_sampling=None,
                      any_final=None):
    """The body of ``GPTModel._fused_ragged_tick_slots`` (see there) for
    any ``model`` with a ``_ragged_window_tick_slots`` of the same
    contract: the dense or tensor-parallel ``GPTModel``, or the mesh's
    ``serving.sharded.ShardedServingModel``.  The sampling epilogue runs
    on the full logits the window returns, every picked lane in one
    batched ``_sample_lanes`` call."""
    B, W = toks.shape
    E = min(W, emit_w) if emit_w else W
    dev = toks.device
    i32 = torch.int32
    window = torch.where((mode == 0)[:, None],
                         torch.cat([tok, toks[:, 1:]], dim=1), toks)
    head_lanes = torch.cat(
        [torch.arange(E, device=dev)[None, :].expand(B, E),
         torch.clamp(width.long() - 1, min=0)[:, None]], dim=1)
    logits, k_pools, v_pools = model._ragged_window_tick_slots(
        window, k_pools, v_pools, block_tables, pos, width,
        scratch=scratch, head_lanes=head_lanes,
        variant=variant)                                 # [B, E+1, V]
    L = block_tables.shape[1] * int(block_size)
    V = logits.shape[-1]
    # the lanes picked: the E emit lanes, lane j with key(seed, ctr + j),
    # and (when a final chunk may be present) the last real lane, which
    # samples the next token with the UNSHIFTED key(seed, ctr)
    n = E + 1 if any_final is None or any_final else E
    shift = torch.arange(n, device=dev)
    shift = torch.where(shift < E, shift, torch.zeros_like(shift))
    keys = (GPTModel._slot_sample_keys(seed_lo[:, None], seed_hi[:, None],
                                       ctr[:, None] + shift[None, :])
            .reshape(-1) if any_sampling is None or any_sampling else None)

    def per_lane(t):
        return t[:, None].expand(B, n).reshape(-1)

    drawn = GPTModel._sample_lanes(
        logits[:, :n].reshape(B * n, V), per_lane(temp), per_lane(top_k),
        per_lane(top_p), keys).view(B, n)
    picks = drawn[:, :E].clone()                         # [B, E]
    is_final = mode == 2
    last_pick = (drawn[:, E] if n > E
                 else torch.zeros(B, dtype=i32, device=dev))
    is_pref = mode == 1
    live = (rem > 0) & (width > 0)
    match = (window[:, 1:E] == picks[:, :E - 1]) \
        & (torch.arange(E - 1, device=dev)[None, :] < lanes[:, None])
    n_acc = torch.argmin(
        torch.cat([match, torch.zeros(B, 1, dtype=torch.bool,
                                      device=dev)], dim=1).to(i32),
        dim=1).to(i32)
    hit_eos = (eos[:, None] >= 0) & (picks == eos[:, None])
    eos_stop = torch.where(hit_eos.any(dim=1),
                           torch.argmax(hit_eos.to(i32), dim=1) + 1,
                           E + 1).to(i32)
    n_emit0 = torch.minimum(torch.minimum(n_acc + 1, rem), eos_stop)
    fc_eos = (eos >= 0) & (last_pick == eos)
    zero = torch.zeros_like(rem)
    n_emit = torch.where(
        is_pref, zero,
        torch.where(is_final, torch.clamp(rem, max=1),
                    torch.where(live, n_emit0, zero))).to(i32)
    last_idx = torch.clamp(n_emit - 1, min=0).long()
    pick_tok = torch.gather(picks, 1, last_idx[:, None])
    new_tok = torch.where(
        is_final[:, None], last_pick[:, None],
        torch.where((is_pref | ~live)[:, None], tok, pick_tok))
    new_rem = torch.where(
        is_pref, rem,
        torch.where(is_final, torch.where(fc_eos, zero, rem - 1),
                    torch.where(live,
                                torch.where(n_emit == eos_stop, zero,
                                            rem - n_emit), rem)))
    done = new_rem <= 0
    adv = torch.where(is_pref | is_final, width,
                      torch.where(live, n_emit, zero))
    # L-1, not L-W: a chunk lane's legitimate prefill positions can
    # pass L-W; runaway writes are parked in the scratch block by the
    # width+range mask in ragged_window_paged
    new_pos = torch.clamp(pos + adv, max=L - 1).to(i32)
    new_ctr = (ctr + n_emit).to(i32)
    picks[:, 0] = torch.where(is_final, last_pick, picks[:, 0])
    return (picks, n_acc, n_emit, done, new_tok.to(i32), new_pos,
            new_ctr, new_rem.to(i32), k_pools, v_pools)

def fused_decode_tick(model, tok, k_bufs, v_bufs, pos, temp, top_k, top_p,
                      seed_lo, seed_hi, ctr, eos, rem, *, L,
                      block_tables=None, any_sampling=None, in_range=False):
    """The body of ``GPTModel._fused_decode_tick_slots`` for any ``model``
    with its ``_decode_tick_slots`` / ``_decode_tick_slots_paged`` (the
    dense or tensor-parallel ``GPTModel``, or the mesh's
    ``serving.sharded.ShardedServingModel``); ``L`` is a slot's row length.
    Lanes draw through ``_sample_lanes`` with key(seed, ctr), as every path
    does; a lane whose budget (``rem``) is spent is frozen (token, position
    and counter kept), and eos or the last budgeted token spends it.
    ``any_sampling`` as in ``fused_ragged_tick``; ``in_range`` passes to
    the contiguous rows' writes."""
    if block_tables is None:
        last, _, _ = model._decode_tick_slots(tok, k_bufs, v_bufs, pos,
                                              in_range=in_range)
    else:
        last, _, _ = model._decode_tick_slots_paged(
            tok, k_bufs, v_bufs, block_tables, pos)
    keys = (GPTModel._slot_sample_keys(seed_lo, seed_hi, ctr)
            if any_sampling is None or any_sampling else None)
    sampled = GPTModel._sample_lanes(last, temp, top_k, top_p, keys)
    live = rem > 0
    zero = torch.zeros_like(rem)
    ids = torch.where(live, sampled, tok[:, 0])
    hit_eos = live & (eos >= 0) & (ids == eos)
    new_rem = torch.where(live, torch.where(hit_eos, zero, rem - 1), rem)
    new_pos = torch.where(live, torch.clamp(pos + 1, max=L - 1), pos)
    new_ctr = torch.where(live, ctr + 1, ctr)
    return (ids, new_rem <= 0, ids[:, None], new_pos, new_ctr, new_rem,
            k_bufs, v_bufs)


def fused_spec_verify_tick(model, toks, k_bufs, v_bufs, pos, lanes, temp,
                           top_k, top_p, seed_lo, seed_hi, ctr, eos, rem, *,
                           L, block_tables=None, any_sampling=None,
                           in_range=False):
    """The body of ``GPTModel._fused_spec_verify_tick_slots`` for any
    ``model`` with its verify windows (as ``fused_decode_tick``): lane j of
    slot b draws with key(seed, ctr + j), the accepted prefix is the
    leading run of real draft lanes (j < ``lanes[b]``) whose draft equals
    the pick, and the slot emits min(accepted + 1, rem, through the first
    eos pick) tokens; the cursor advances by that, clamped at L - W."""
    if block_tables is None:
        logits, _, _ = model._spec_verify_tick_slots(
            toks, k_bufs, v_bufs, pos, in_range=in_range)
    else:
        logits, _, _ = model._spec_verify_tick_slots_paged(
            toks, k_bufs, v_bufs, block_tables, pos)
    B, W = toks.shape
    dev = toks.device
    i32 = torch.int32
    lane = torch.arange(W, device=dev)
    keys = (GPTModel._slot_sample_keys(seed_lo[:, None], seed_hi[:, None],
                                       ctr[:, None] + lane[None, :])
            .reshape(-1) if any_sampling is None or any_sampling
            else None)

    def per_lane(t):
        return t[:, None].expand(B, W).reshape(-1)

    picks = GPTModel._sample_lanes(
        logits.reshape(B * W, -1), per_lane(temp), per_lane(top_k),
        per_lane(top_p), keys).view(B, W)
    match = (toks[:, 1:] == picks[:, :-1]) \
        & (lane[None, :-1] < lanes[:, None])
    n_acc = torch.argmin(
        torch.cat([match, torch.zeros(B, 1, dtype=torch.bool,
                                      device=dev)], dim=1).to(i32),
        dim=1).to(i32)
    live = rem > 0
    zero = torch.zeros_like(rem)
    hit_eos = (eos[:, None] >= 0) & (picks == eos[:, None])
    eos_stop = torch.where(hit_eos.any(dim=1),
                           torch.argmax(hit_eos.to(i32), dim=1) + 1,
                           W + 1).to(i32)
    n_emit = torch.where(
        live, torch.minimum(torch.minimum(n_acc + 1, rem), eos_stop),
        zero).to(i32)
    last_idx = torch.clamp(n_emit - 1, min=0).long()
    new_tok = torch.where(live[:, None],
                          torch.gather(picks, 1, last_idx[:, None]),
                          toks[:, :1])
    new_rem = torch.where(
        live, torch.where(n_emit == eos_stop, zero, rem - n_emit), rem)
    new_pos = torch.where(live, torch.clamp(pos + n_emit, max=L - W),
                          pos).to(i32)
    return (picks, n_acc, n_emit, new_rem <= 0, new_tok.to(i32),
            new_pos, (ctr + n_emit).to(i32), new_rem.to(i32), k_bufs,
            v_bufs)
