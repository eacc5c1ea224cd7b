"""Ragged paged attention — one kernel for every paged window.

Counterpart of ``paddle_tpu/ops/ragged_paged_attn.py``
(``ragged_paged_attention(variant="stream")`` → ``_stream_impl``).  Per
slot, ``pos[b]`` (the window start), ``width[b]`` (real query lanes this
tick: 1 for a decode lane, the chunk length for a prefill chunk, 0 for a
parked slot) and the slot's block table are DATA, so a batch that mixes
decode lanes and prefill chunks is one launch.

The kernel (``csrc/ragged_paged_attn.cu``) walks each slot's live blocks
up to the causal horizon with the flash online-softmax recurrence, in
f32, and zeroes the lanes at or past ``width``.  It is allclose to the
gather-then-softmax oracle (``models/gpt.py`` ``GPTAttention._slot_attn``),
not bitwise: the block-by-block accumulation sums in another order.

``ragged_paged_attention`` launches the kernel for CUDA tensors and runs
``ragged_paged_attention_ref`` — the same recurrence in plain PyTorch —
only for CPU tensors.  The K/V writes happen before the call, in the
caller (``GPTAttention.ragged_window_paged``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 227 * 1024  # an H100 block's shared-memory ceiling
_MASK = -1e30


def causal_horizon(pos, width, block_size, blocks_per_slot):
    """Live blocks per slot: ``min(nb, (pos + max(width, 1) - 1) // bs
    + 1)``.  Blocks past it are fully masked, so skipping them is exact;
    a parked width-0 slot still walks block 0."""
    live = (pos + torch.clamp(width, min=1) - 1) // block_size + 1
    return torch.clamp(live, max=blocks_per_slot)


def ragged_paged_attention_ref(q, k_flat, v_flat, block_tables, pos,
                               width, *, block_size):
    """Plain PyTorch version of the kernel: the same online-softmax
    recurrence over each slot's live blocks, batched over slots (a slot
    whose horizon is behind the loop keeps its carry unchanged).

    Shapes as ``ragged_paged_attention``.  Returns ``[B, W, H, hd]`` in
    q's dtype."""
    B, W, H, hd = q.shape
    bs = int(block_size)
    nb = block_tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    blocks_k = k_flat.reshape(-1, bs, H, hd)
    blocks_v = v_flat.reshape(-1, bs, H, hd)
    tables = block_tables.long()
    pos = pos.long()
    width = width.long()
    qa = q.float()
    n_live = causal_horizon(pos, width, bs, nb)
    s_ids = torch.arange(W, device=q.device)
    r_ids = torch.arange(bs, device=q.device)
    m = torch.full((B, H, W), _MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, W), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, W, hd), dtype=torch.float32, device=q.device)
    for j in range(int(n_live.max())):
        kb = blocks_k[tables[:, j]].float()              # [B, bs, H, hd]
        vb = blocks_v[tables[:, j]].float()
        sc = torch.einsum("bqhd,bkhd->bhqk", qa, kb) * scale
        visible = ((j * bs + r_ids)[None, None, :]
                   <= (pos[:, None] + s_ids[None, :])[:, :, None])
        visible = visible[:, None]                       # [B, 1, W, bs]
        sc = torch.where(visible, sc, torch.full_like(sc, _MASK))
        new_m = torch.maximum(m, sc.amax(dim=-1))
        pj = torch.exp(sc - new_m[..., None]) * visible.float()
        corr = torch.exp(m - new_m)
        new_l = l * corr + pj.sum(dim=-1)
        new_acc = acc * corr[..., None] \
            + torch.einsum("bhqk,bkhd->bhqd", pj, vb)
        walking = (j < n_live)[:, None, None]
        m = torch.where(walking, new_m, m)
        l = torch.where(walking, new_l, l)
        acc = torch.where(walking[..., None], new_acc, acc)
    ctx = (acc / l[..., None]).permute(0, 2, 1, 3)       # [B, W, H, hd]
    lane_live = (s_ids[None, :] < width[:, None])[:, :, None, None]
    ctx = torch.where(lane_live, ctx, torch.zeros_like(ctx))
    return ctx.to(q.dtype)


def _check(q, k_flat, v_flat, block_tables, pos, width, bs):
    tensors = dict(q=q, k_flat=k_flat, v_flat=v_flat,
                   block_tables=block_tables, pos=pos, width=width)
    dev = q.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"ragged_paged_attention: {name} is on "
                             f"{t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"ragged_paged_attention: {name} must be "
                             "contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"ragged_paged_attention: q dtype {q.dtype} not "
                        "supported (float32 or bfloat16)")
    if k_flat.dtype != q.dtype or v_flat.dtype != q.dtype:
        raise TypeError("ragged_paged_attention: q, k_flat and v_flat "
                        "must share one dtype")
    for name in ("block_tables", "pos", "width"):
        if tensors[name].dtype != torch.int32:
            raise TypeError(f"ragged_paged_attention: {name} must be "
                            "int32")
    if q.dim() != 4:
        raise ValueError("ragged_paged_attention: q must be [B, W, H, hd]")
    B, W, H, hd = q.shape
    if k_flat.dim() != 3 or tuple(k_flat.shape[1:]) != (H, hd) \
            or v_flat.shape != k_flat.shape:
        raise ValueError(
            f"ragged_paged_attention: k_flat/v_flat must be [NB*bs, {H}, "
            f"{hd}], got {tuple(k_flat.shape)} / {tuple(v_flat.shape)}")
    if bs < 1 or k_flat.shape[0] % bs:
        raise ValueError(f"ragged_paged_attention: pool rows "
                         f"{k_flat.shape[0]} are not whole blocks of {bs}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("ragged_paged_attention: block_tables must be "
                         f"[{B}, L/bs]")
    if tuple(pos.shape) != (B,) or tuple(width.shape) != (B,):
        raise ValueError(f"ragged_paged_attention: pos/width must be [{B}]")


def ragged_paged_attention(q, k_flat, v_flat, block_tables, pos, width,
                           *, block_size):
    """Ragged paged attention over a slot pool (module docstring).

    q : ``[B, W, H, hd]`` query window per slot (W = the engine's widest
        window; real lanes per slot are ``width[b]``).
    k_flat / v_flat : ``[NB * block_size, H, hd]`` — the paged pools
        flattened to physical rows, writes already scattered.
    block_tables : int32 ``[B, L // block_size]`` physical block per
        logical block (block 0 is the scratch block).
    pos : int32 ``[B]`` window start per slot.
    width : int32 ``[B]`` real query lanes (0 = parked; lanes at or past
        width come back as exact zeros).

    CPU tensors run ``ragged_paged_attention_ref``.  CUDA tensors launch
    the kernel on the current stream without synchronizing, and add one
    to ``ragged_paged_attention.launches``; anything the kernel does not
    take raises.  Block ids in the tables are trusted (the engine's
    block pool hands them out).  Returns ``[B, W, H, hd]`` in q's dtype.
    """
    bs = int(block_size)
    _check(q, k_flat, v_flat, block_tables, pos, width, bs)
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_flat, v_flat, block_tables,
                                          pos, width, block_size=bs)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: no kernel for device "
                         f"{q.device}")
    B, W, H, hd = q.shape
    nb = block_tables.shape[1]
    lib = _load()
    smem = lib.ragged_paged_attn_smem_bytes(W, hd, bs)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"ragged_paged_attention: W={W}, hd={hd}, bs={bs} needs "
            f"{smem} B of shared memory per block, over {_MAX_SMEM}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.ragged_paged_attn_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k_flat.data_ptr(),
            v_flat.data_ptr(), block_tables.data_ptr(), pos.data_ptr(),
            width.data_ptr(), out.data_ptr(), B, W, H, hd, bs, nb,
            1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention: kernel launch failed "
                           f"with CUDA error {rc}")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def _load():
    lib = _build.load("ragged_paged_attn")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ragged_paged_attn_launch.argtypes = [
            i, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        lib.ragged_paged_attn_launch.restype = i
        lib.ragged_paged_attn_smem_bytes.argtypes = [i, i, i]
        lib.ragged_paged_attn_smem_bytes.restype = ctypes.c_size_t
        lib._argtypes_set = True
    return lib
