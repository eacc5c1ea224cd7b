"""Ragged paged attention — the kernels behind every paged window.

Counterpart of ``paddle_tpu/ops/ragged_paged_attn.py``
(``ragged_paged_attention``: ``_stream_impl`` and ``_gather_impl``).  Per
slot, ``pos[b]`` (the window start), ``width[b]`` (real query lanes this
tick: 1 for a decode lane, the chunk length for a prefill chunk, 0 for a
parked slot) and the slot's block table are DATA, so a batch that mixes
decode lanes and prefill chunks is one launch.

One CUDA source, ``csrc/ragged_paged_attn.cu``, holds both bodies as
kernels of their own names; each wrapper counts its launches:

* ``ragged_paged_attention`` (B1, ``ragged_paged_attn_kernel``) — the
  streaming body over fp pools: each slot's blocks up to the causal
  horizon, flash online softmax in f32, lanes at or past ``width``
  zeroed.  The walk is split into pieces of ``PIECE_ROWS`` rows
  (``walk_pieces``), one CUDA block each, merged in order, in the same
  launch, by the last piece of each (slot, head) to finish, through an
  f32 workspace that the wrapper allocates from torch's caching allocator.
  Allclose to the gather-then-softmax oracle, not bitwise: the
  block-by-block accumulation sums in another order.
* ``ragged_paged_attention_int8`` (B2, the same kernel's int8 leg) — the
  streaming body over int8 code pools with f32 per-block per-head
  ``k_scale``/``v_scale`` ``[NB, H]``: each block is dequantized as it is
  streamed, never the whole pool.
* ``ragged_gather_attention`` (B3, ``ragged_gather_attn_kernel``) — the
  gather body (``attn_impl="ragged_gather"``), fp or int8: the same split
  walk over EVERY table entry of a slot with a real lane, not cut at the
  horizon (the TPU kernel's defined work: the whole row, one masked
  softmax over it).  No context ceiling of its own.
* ``sharded_ragged_paged_attention`` (B4) — the ``(mp, dp)`` serving
  mesh's form: one launch of B1, B2 or B3 for each group of ranks that
  share a card (``card_groups``), each rank over its slots, heads and pool
  shard, with the whole batch's tables of GLOBAL block ids localized to
  its shard inside the kernel.

``ragged_paged_attention(..., k_scale=None, v_scale=None,
variant="stream")`` takes the JAX function's contract and sends the call
to the right one.  A wrapper runs its plain PyTorch version
(``ragged_paged_attention_ref``, ``ragged_gather_attention_ref``,
``ragged_group_attention_ref``) only for CPU tensors; for CUDA tensors it
launches its kernel or raises.  The K/V writes happen before the call, in
the caller (``GPTAttention.ragged_window_paged``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..distributed.mesh import get_mesh
from . import _build

VARIANTS = ("stream", "gather")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' split walk (csrc/ragged_paged_attn.cu kPieceRows), the head
# dims they are compiled for, and the ranks one launch covers (kMaxRanks)
PIECE_ROWS = 128
HEAD_DIMS = (8, 16, 32, 64, 128)
MAX_GROUP_RANKS = 8
_LIB = "ragged_paged_attn"
_MAX_SMEM = 227 * 1024  # an H100 block's shared-memory ceiling
_MASK = -1e30


def causal_horizon(pos, width, block_size, blocks_per_slot):
    """Live blocks per slot: ``min(nb, (pos + max(width, 1) - 1) // bs
    + 1)``.  Blocks past it are fully masked, so skipping them is exact;
    a parked width-0 slot still walks block 0."""
    live = (pos + torch.clamp(width, min=1) - 1) // block_size + 1
    return torch.clamp(live, max=blocks_per_slot)


def walk_pieces(blocks_per_slot, block_size):
    """``(G, pieces)``: the paged blocks one piece of the kernels' walk
    covers (``PIECE_ROWS // block_size``, at least 1) and the pieces a
    table of ``blocks_per_slot`` entries splits into.  They depend on the
    table's shape alone, never on the batch, the heads, the ranks or the
    card, so a launch over some of a batch's slots or heads sums every
    (slot, head) in the same order as the whole batch."""
    g = max(1, PIECE_ROWS // int(block_size))
    return g, -(-int(blocks_per_slot) // g)


def workspace_floats(batch, window, heads, head_dim, blocks_per_slot,
                     block_size):
    """f32 words of the kernels' workspace: one partial ``(acc
    [head_dim], m, l)`` and its merge factor per slot, head, piece and
    lane; 0 when a table is one piece (every slot then writes its output
    directly).  ``batch`` counts every rank's slots in a group launch."""
    pieces = walk_pieces(blocks_per_slot, block_size)[1]
    if pieces == 1:
        return 0
    return batch * heads * pieces * window * (head_dim + 3)


def _dequant(codes, scale):
    """Gathered blocks ``[B, ..., bs, H, hd]`` as f32, times their
    per-head scales ``[B, ..., H]`` when the pool is int8."""
    if scale is None:
        return codes.float()
    return codes.float() * scale[..., None, :, None]


# -- plain versions -------------------------------------------------------
def ragged_paged_attention_ref(q, k_flat, v_flat, block_tables, pos,
                               width, *, block_size, k_scale=None,
                               v_scale=None):
    """Plain PyTorch version of the streaming kernels (B1, and B2 with
    scales): the same online-softmax recurrence over each slot's live
    blocks, batched over slots (a slot whose horizon is behind the loop
    keeps its carry unchanged).  With ``k_scale``/``v_scale`` each
    streamed block is dequantized in the loop as codes times that block's
    per-head scale.

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
        idx = tables[:, j]
        kb = _dequant(blocks_k[idx], None if k_scale is None
                      else k_scale[idx])                 # [B, bs, H, hd]
        vb = _dequant(blocks_v[idx], None if v_scale is None
                      else v_scale[idx])
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


def ragged_gather_attention_ref(q, k_flat, v_flat, block_tables, pos,
                                width, *, block_size, k_scale=None,
                                v_scale=None):
    """Plain PyTorch version of the gather kernel (B3): gather each
    slot's whole ``[L, H, hd]`` row through its table (dequantizing per
    block when int8), then one masked softmax over L in f32 and the value
    contraction; lanes at or past ``width`` are zeroed.

    Shapes as ``ragged_paged_attention``.  Returns ``[B, W, H, hd]`` in
    q's dtype."""
    B, W, H, hd = q.shape
    bs = int(block_size)
    tables = block_tables.long()
    L = tables.shape[1] * bs
    scale = 1.0 / math.sqrt(hd)

    def rows(pool, sc):
        blocks = pool.reshape(-1, bs, H, hd)[tables]     # [B, nb, bs, H, hd]
        return _dequant(blocks, None if sc is None else sc[tables]
                        ).reshape(B, L, H, hd)

    k_rows = rows(k_flat, k_scale)
    v_rows = rows(v_flat, v_scale)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_rows) * scale
    dev = q.device
    visible = (torch.arange(L, device=dev)[None, None, :]
               <= (pos.long()[:, None]
                   + torch.arange(W, device=dev)[None, :])[:, :, None])
    scores = torch.where(visible[:, None], scores,
                         torch.full_like(scores, _MASK))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v_rows)
    lane_live = (torch.arange(W, device=dev)[None, :]
                 < width.long()[:, None])[:, :, None, None]
    ctx = torch.where(lane_live, ctx, torch.zeros_like(ctx))
    return ctx.to(q.dtype)


def ragged_group_attention_ref(members, block_tables, pos, width, *,
                               block_size, nb_local=0, variant="stream"):
    """Plain version of one launch of the kernels over a group of ranks
    (B4's launch per card): ``members`` is ``[(q, k_flat, v_flat, k_scale,
    v_scale, d), ...]``, each rank's ``[B, W, H, hd]`` window, pool shard
    (``[nb_local * bs, H, hd]``, with scales ``[nb_local, H]`` for int8
    codes, else None) and dp index; ``block_tables`` ``[n_slots, nb]``
    (GLOBAL block ids), ``pos`` and ``width`` ``[n_slots]`` are the whole
    batch's.  Rank ``(.., d)``'s slot ``b`` is row ``d * B + b`` of them and
    each of its table entries is localized as ``entry - d * nb_local``, as
    the kernel reads them; the rank's rows then go through the plain
    version of the body (``ragged_paged_attention_ref`` or
    ``ragged_gather_attention_ref``).  An unsharded call is one rank with
    ``d = 0``.  Returns ``[R * B, W, H, hd]``, the ranks' rows in order."""
    ref = (ragged_gather_attention_ref if variant == "gather"
           else ragged_paged_attention_ref)
    outs = []
    for q, k, v, ks, vs, d in members:
        dev = q.device
        sl = slice(d * q.shape[0], (d + 1) * q.shape[0])
        outs.append(ref(q, k, v,
                        (block_tables[sl].to(dev) - d * nb_local).int(),
                        pos[sl].to(dev), width[sl].to(dev),
                        block_size=block_size, k_scale=ks, v_scale=vs))
    return torch.cat(outs)


# -- checks ---------------------------------------------------------------
def _check_tables(who, block_tables, pos, width, dev, slots):
    """``block_tables`` ``[slots, L/bs]``, ``pos`` and ``width``
    ``[slots]``: int32, contiguous, on ``dev``."""
    for name, t in (("block_tables", block_tables), ("pos", pos),
                    ("width", width)):
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{who}: {name} must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != slots:
        raise ValueError(f"{who}: block_tables must be [{slots}, L/bs]")
    if tuple(pos.shape) != (slots,) or tuple(width.shape) != (slots,):
        raise ValueError(f"{who}: pos/width must be [{slots}]")


def _check_operands(who, q, k_flat, v_flat, bs, k_scale, v_scale):
    """q ``[B, W, H, hd]`` in a kernel's dtype, its pools and scales:
    contiguous, on q's device, of matching dtypes and shapes."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{who}: pass both k_scale and v_scale "
                         "(quantized pools) or neither (fp pools)")
    tensors = dict(q=q, k_flat=k_flat, v_flat=v_flat)
    if k_scale is not None:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    dev = q.device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{who}: {name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{who}: q dtype {q.dtype} not supported "
                        "(float32 or bfloat16)")
    pool_dtype = q.dtype if k_scale is None else torch.int8
    if k_flat.dtype != pool_dtype or v_flat.dtype != pool_dtype:
        raise TypeError(
            f"{who}: k_flat/v_flat are {k_flat.dtype}/{v_flat.dtype}; "
            + (f"fp pools share q's dtype ({q.dtype})" if k_scale is None
               else "pools with scales are int8 codes"))
    if q.dim() != 4:
        raise ValueError(f"{who}: q must be [B, W, H, hd]")
    H, hd = q.shape[2:]
    if k_flat.dim() != 3 or tuple(k_flat.shape[1:]) != (H, hd) \
            or v_flat.shape != k_flat.shape:
        raise ValueError(
            f"{who}: k_flat/v_flat must be [NB*bs, {H}, {hd}], got "
            f"{tuple(k_flat.shape)} / {tuple(v_flat.shape)}")
    if bs < 1 or k_flat.shape[0] % bs:
        raise ValueError(f"{who}: pool rows {k_flat.shape[0]} are not "
                         f"whole blocks of {bs}")
    if k_scale is not None:
        want = (k_flat.shape[0] // bs, H)
        for name in ("k_scale", "v_scale"):
            t = tensors[name]
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{who}: {name} must be float32 "
                                 f"{list(want)}, got {t.dtype} "
                                 f"{list(t.shape)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{who}: no kernel for device {dev}")


# -- launches -------------------------------------------------------------
_smem_sizes = {}   # (W, hd, bs) -> bytes one block needs
_prepared = {}     # (dtype, quant, card) -> the limit set so far
_counters = {}     # (card, stream) -> the merge counters


def _prepare(lib, dtype_code, quant, dims, card):
    """Once per config: ask the library for the block's shared memory,
    raise above the card's ceiling, and raise the kernels' dynamic
    shared-memory limit — once per (dtype, quant, card), and again only
    when a config needs more than was set (the limit is a ceiling, so a
    smaller config launches under a larger one)."""
    smem = _smem_sizes.get(dims)
    if smem is None:
        smem = lib.ragged_paged_attn_smem_bytes(*dims)
        if smem > _MAX_SMEM:
            W, hd, bs = dims
            raise ValueError(
                f"ragged_paged_attention: W={W}, hd={hd}, bs={bs} needs "
                f"{smem} B of shared memory per block, over {_MAX_SMEM}")
        _smem_sizes[dims] = smem
    key = (dtype_code, quant, card)
    if _prepared.get(key, -1) >= smem:
        return
    rc = lib.ragged_paged_attn_prepare(dtype_code, quant, smem)
    if rc != 0:
        raise RuntimeError(f"{_LIB}: setting its shared-memory limit "
                           f"failed with CUDA error {rc}")
    _prepared[key] = smem


def _merge_counters(device, stream, n):
    """At least ``n`` int32 zeros on ``device`` for the kernels' merge
    counters, one set per (card, stream): each launch leaves its counters
    at 0, and launches on one stream run in order.  Allocated (zeroed)
    again only when a launch needs more than the set holds."""
    key = (device.index, stream)
    counters = _counters.get(key)
    if counters is None or counters.numel() < n:
        counters = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[key] = counters
    return counters


def _launch(who, gather, members, block_tables, pos, width, bs,
            nb_local=0):
    """One launch of the kernel over ``members``, ranks that share one
    card (``ragged_group_attention_ref``'s arguments, checked already;
    one rank with ``d = 0`` for an unsharded call), on that card's current
    stream.  Checks what only the kernel needs (its compiled head dims;
    pools on 16-byte boundaries for its cp.async copies).  Returns the
    output ``[R * B, W, H, hd]``."""
    q0 = members[0][0]
    B, W, H, hd = q0.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"{who}: head dim {hd} not supported by the "
                         f"kernel {HEAD_DIMS}")
    for _, k, v, *_ in members:
        if k.data_ptr() % 16 or v.data_ptr() % 16:
            raise ValueError(f"{who}: k_flat/v_flat must start on a "
                             "16-byte boundary")
    R, nb, dev = len(members), block_tables.shape[1], q0.device
    quant = int(members[0][3] is not None)
    lib = _load()
    ptrs = (ctypes.c_void_p * (5 * R))(*[
        None if m[i] is None else m[i].data_ptr()
        for i in range(5) for m in members])
    dp_index = (ctypes.c_int * R)(*[m[5] for m in members])
    out = torch.empty((R * B, W, H, hd), dtype=q0.dtype, device=dev)
    with torch.cuda.device(dev):
        _prepare(lib, _DTYPE_CODE[q0.dtype], quant, (W, hd, bs), dev.index)
        stream = torch.cuda.current_stream(dev).cuda_stream
        # the workspace (held in ws until the launch is enqueued: freed
        # earlier, the caching allocator could hand its memory to out) and
        # the merge counters, none for one-piece tables
        n = workspace_floats(R * B, W, H, hd, nb, bs)
        ws = counters = None
        if n:
            ws = torch.empty(n, dtype=torch.float32, device=dev)
            counters = _merge_counters(dev, stream, R * B * H)
        rc = lib.ragged_paged_attn_launch(
            _DTYPE_CODE[q0.dtype], int(gather), R, ptrs, dp_index,
            block_tables.data_ptr(), pos.data_ptr(), width.data_ptr(),
            out.data_ptr(), ws.data_ptr() if n else None,
            counters.data_ptr() if n else None, B, W, H, hd, bs, nb,
            nb_local, 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"{who}: kernel launch failed with CUDA error "
                           f"{rc}")
    return out


def _load():
    lib = _build.load(_LIB)
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        pp, pi = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        lib.ragged_paged_attn_launch.argtypes = (
            [i] * 3 + [pp, pi] + [p] * 6 + [i] * 7
            + [ctypes.c_float, p])
        lib.ragged_paged_attn_launch.restype = i
        lib.ragged_paged_attn_smem_bytes.argtypes = [i, i, i]
        lib.ragged_paged_attn_smem_bytes.restype = ctypes.c_size_t
        lib.ragged_paged_attn_prepare.argtypes = [i, i, i]
        lib.ragged_paged_attn_prepare.restype = i
        lib.ragged_paged_attn_pieces.argtypes = [i, i]
        lib.ragged_paged_attn_pieces.restype = i
        lib._argtypes_set = True
    return lib


# -- the wrappers -----------------------------------------------------------
def ragged_paged_attention(q, k_flat, v_flat, block_tables, pos, width,
                           *, block_size, k_scale=None, v_scale=None,
                           variant="stream"):
    """Ragged paged attention over a slot pool (module docstring).

    q : ``[B, W, H, hd]`` query window per slot (W = the engine's widest
        window; real lanes per slot are ``width[b]``), float32 or bf16.
    k_flat / v_flat : ``[NB * block_size, H, hd]`` — the paged pools
        flattened to physical rows, writes already scattered; q's dtype,
        or int8 codes with ``k_scale``/``v_scale``.
    block_tables : int32 ``[B, L // block_size]`` physical block per
        logical block (block 0 is the scratch block).
    pos : int32 ``[B]`` window start per slot.
    width : int32 ``[B]`` real query lanes (0 = parked; lanes at or past
        width come back as exact zeros).
    k_scale / v_scale : optional f32 ``[NB, H]`` per-block per-head
        dequantization multipliers of int8 pools (``Engine(kv_dtype=
        "int8")``).  Pass both or neither.
    variant : ``"stream"`` (default) — the online-softmax walk to the
        causal horizon (kernel B1, or B2 with scales); ``"gather"`` —
        every table entry, the whole row's softmax (kernel B3,
        ``attn_impl="ragged_gather"``).

    CPU tensors run the plain versions.  CUDA tensors launch the kernel
    on the current stream without synchronizing, and add one to that
    kernel's wrapper's ``launches`` (this function's own for B1); anything
    the kernel does not take raises.  Block ids in the tables are trusted
    (the engine's block pool hands them out).  Returns ``[B, W, H, hd]``
    in q's dtype.
    """
    if variant not in VARIANTS:
        raise ValueError(
            f"ragged_paged_attention: variant must be one of {VARIANTS}, "
            f"got {variant!r}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(
            "ragged_paged_attention: pass both k_scale and v_scale "
            "(quantized pools) or neither (fp pools)")
    if variant == "gather":
        return ragged_gather_attention(
            q, k_flat, v_flat, block_tables, pos, width,
            block_size=block_size, k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None:
        return ragged_paged_attention_int8(
            q, k_flat, v_flat, block_tables, pos, width, k_scale, v_scale,
            block_size=block_size)
    return _unsharded("ragged_paged_attention", ragged_paged_attention,
                      False, q, k_flat, v_flat, block_tables, pos, width,
                      block_size, None, None)


def _unsharded(who, op, gather, q, k_flat, v_flat, block_tables, pos,
               width, block_size, k_scale, v_scale):
    """A wrapper's call: checks, then the plain version for CPU tensors
    or one launch (a group of one rank) counted on ``op``."""
    bs = int(block_size)
    _check_operands(who, q, k_flat, v_flat, bs, k_scale, v_scale)
    _check_tables(who, block_tables, pos, width, q.device, q.shape[0])
    if q.device.type == "cpu":
        ref = (ragged_gather_attention_ref if gather
               else ragged_paged_attention_ref)
        return ref(q, k_flat, v_flat, block_tables, pos, width,
                   block_size=bs, k_scale=k_scale, v_scale=v_scale)
    out = _launch(who, gather, [(q, k_flat, v_flat, k_scale, v_scale, 0)],
                  block_tables, pos, width, bs)
    op.launches += 1
    return out


def ragged_paged_attention_int8(q, k_codes, v_codes, block_tables, pos,
                                width, k_scale, v_scale, *, block_size):
    """Kernel B2: the streaming body over int8 code pools ``[NB*bs, H,
    hd]`` with f32 scales ``[NB, H]`` (shapes otherwise as
    ``ragged_paged_attention``).  CPU tensors run
    ``ragged_paged_attention_ref`` with the scales; CUDA tensors launch the
    kernel and add one to ``ragged_paged_attention_int8.launches``."""
    return _unsharded("ragged_paged_attention_int8",
                      ragged_paged_attention_int8, False, q, k_codes,
                      v_codes, block_tables, pos, width, block_size, k_scale,
                      v_scale)


def ragged_gather_attention(q, k_flat, v_flat, block_tables, pos, width,
                            *, block_size, k_scale=None, v_scale=None):
    """Kernel B3: the gather body, over fp pools or int8 code pools with
    scales (shapes as ``ragged_paged_attention``).  CPU tensors run
    ``ragged_gather_attention_ref``; CUDA tensors launch the kernel and
    add one to ``ragged_gather_attention.launches``.  Every table entry of
    a slot with a real lane is read, whatever the context."""
    return _unsharded("ragged_gather_attention", ragged_gather_attention,
                      True, q, k_flat, v_flat, block_tables, pos, width,
                      block_size, k_scale, v_scale)


# -- the (mp, dp) mesh ----------------------------------------------------
def card_groups(mesh):
    """The mesh's ranks as B4 launches them: ``[(device, [rank, ...])]``,
    the ranks grouped by their device in rank order, at most
    ``MAX_GROUP_RANKS`` a group (more ranks on one device split into
    consecutive groups).  A ``(2, 2)`` mesh on one card is one group of
    four (dp indices 0, 0, 1, 1); over four cards, four groups of one."""
    by_device = {}
    for r, dev in enumerate(mesh.devices):
        by_device.setdefault(dev, []).append(r)
    return [(dev, ranks[i:i + MAX_GROUP_RANKS])
            for dev, ranks in by_device.items()
            for i in range(0, len(ranks), MAX_GROUP_RANKS)]


def _check_shards(who, q_shards, k_shards, v_shards, block_tables, pos,
                  width, bs, mesh, k_scale_shards, v_scale_shards):
    """Validate the sharded operands (as the JAX wrapper does, and every
    rank alike).  Returns ``(B/dp, NB/dp)``: a rank's slots and pool
    blocks."""
    if (k_scale_shards is None) != (v_scale_shards is None):
        raise ValueError(f"{who}: pass both k_scale_shards and "
                         "v_scale_shards (quantized pools) or neither")
    lists = dict(q_shards=q_shards, k_shards=k_shards, v_shards=v_shards)
    if k_scale_shards is not None:
        lists.update(k_scale_shards=k_scale_shards,
                     v_scale_shards=v_scale_shards)
    for name, parts in lists.items():
        if len(parts) != mesh.size:
            raise ValueError(f"{who}: {name} has {len(parts)} shards, the "
                             f"mesh {mesh.size} ranks")
    mp, dp = mesh.mp, mesh.dp
    if block_tables.dim() != 2 or tuple(pos.shape) != \
            (block_tables.shape[0],) or pos.shape != width.shape:
        raise ValueError(f"{who}: block_tables must be [B, L/bs] and "
                         "pos/width [B]")
    B = block_tables.shape[0]
    rows = k_shards[0].shape[0]
    if B % dp:
        raise ValueError(
            f"{who}: B={B} slots must divide by the mesh's dp degree ({dp})")
    q0, k0 = q_shards[0], k_shards[0]
    if q0.dim() != 4 or k0.dim() != 3:
        raise ValueError(f"{who}: q shards must be [B/dp, W, H/mp, hd] and "
                         "pool shards [rows, H/mp, hd]")
    want_q = (B // dp, q0.shape[1], q0.shape[2], q0.shape[3])
    want_kv = (rows, q0.shape[2], q0.shape[3])
    for r in range(mesh.size):
        if tuple(q_shards[r].shape) != want_q:
            raise ValueError(
                f"{who}: q shard {r} is {list(q_shards[r].shape)}, not "
                f"{list(want_q)} (B={B} slots over dp={dp}; every rank "
                f"{q0.shape[2]} of the H={q0.shape[2] * mp} heads over "
                f"mp={mp} — attention shards whole heads)")
        for name in ("k_shards", "v_shards"):
            if tuple(lists[name][r].shape) != want_kv:
                raise ValueError(
                    f"{who}: {name}[{r}] is {list(lists[name][r].shape)}, "
                    f"not {list(want_kv)}")
    if rows % bs:
        raise ValueError(f"{who}: pool shard rows {rows} are not whole "
                         f"blocks of {bs}")
    return B // dp, rows // bs


def _members(mesh, ranks, q_shards, k_shards, v_shards, k_scale_shards,
             v_scale_shards):
    """``ragged_group_attention_ref``'s members for these ranks, q made
    contiguous for the kernel."""
    dp_of = mesh.ranks()
    return [(q_shards[r].contiguous(), k_shards[r], v_shards[r],
             None if k_scale_shards is None else k_scale_shards[r],
             None if v_scale_shards is None else v_scale_shards[r],
             dp_of[r][1]) for r in ranks]


def _mesh_or_global(mesh, who):
    if mesh is None:
        mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"{who} needs a mesh: pass mesh=... or set the "
                         "process-global one (distributed.set_mesh)")
    return mesh


def sharded_ragged_paged_attention(q_shards, k_shards, v_shards,
                                   block_tables, pos, width, *, block_size,
                                   mesh=None, k_scale_shards=None,
                                   v_scale_shards=None, variant="stream"):
    """Kernel B4: ragged paged attention over an ``(mp, dp)`` serving
    mesh — the counterpart of ``paddle_tpu``'s
    ``sharded_ragged_paged_attention``, whose ``shard_map`` runs the
    unchanged kernel on every shard.  Here that is one launch of B1, B2
    or B3 for each group of ranks that share a card (``card_groups``):

    * ``q_shards[r]`` — rank ``(m, d)``'s ``[B/dp, W, H/mp, hd]`` slice of
      the window (its dp group's slots, its mp slice of the heads); a
      strided slice is made contiguous for the kernel;
    * ``k_shards[r]`` / ``v_shards[r]`` — its pool shard ``[NB/dp * bs,
      H/mp, hd]`` (q's dtype, or int8 codes with ``k_scale_shards`` /
      ``v_scale_shards`` ``[NB/dp, H/mp]``);
    * ``block_tables`` ``[B, L/bs]``, ``pos`` / ``width`` ``[B]`` — the
      whole batch, moved to each card once; tables carry GLOBAL block ids,
      and the kernel reads dp group ``d``'s rows and localizes each entry
      as ``entry - d * NB/dp`` (exact: the engine's admission gate gives
      a slot blocks of its own shard's range only).

    ``mesh`` is a ``distributed.ServingMesh`` (None: the one
    ``distributed.set_mesh`` set); rank order is its order.  Validation
    follows the JAX wrapper's.  Each group's launch runs on its card and
    adds one to this wrapper's ``launches`` and one to the launched
    kernel's own; a group on the CPU runs the plain form
    (``ragged_group_attention_ref``).  Each (slot, head) is computed as in
    the unsharded launch, so the result is bitwise the unsharded kernel's.
    Returns the per-rank outputs, shaped like ``q_shards``."""
    who = "sharded_ragged_paged_attention"
    if variant not in VARIANTS:
        raise ValueError(f"{who}: variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    mesh = _mesh_or_global(mesh, who)
    bs = int(block_size)
    gather = variant == "gather"
    with torch.profiler.record_function(who):
        bl, nb_local = _check_shards(who, q_shards, k_shards, v_shards,
                                     block_tables, pos, width, bs, mesh,
                                     k_scale_shards, v_scale_shards)
        outs = [None] * mesh.size
        for _, ranks in card_groups(mesh):
            members = _members(mesh, ranks, q_shards, k_shards, v_shards,
                               k_scale_shards, v_scale_shards)
            dev = members[0][0].device
            tables_d, pos_d, width_d = (
                t.to(dev) for t in (block_tables, pos, width))
            _check_tables(who, tables_d, pos_d, width_d, dev,
                          block_tables.shape[0])
            for q, k, v, ks, vs, _ in members:
                _check_operands(who, q, k, v, bs, ks, vs)
            if dev.type == "cpu":
                out = ragged_group_attention_ref(
                    members, tables_d, pos_d, width_d, block_size=bs,
                    nb_local=nb_local, variant=variant)
            else:
                out = _launch(who, gather, members, tables_d, pos_d,
                              width_d, bs, nb_local)
                op = (ragged_gather_attention if gather
                      else ragged_paged_attention if k_scale_shards is None
                      else ragged_paged_attention_int8)
                op.launches += 1
                sharded_ragged_paged_attention.launches += 1
            for r, o in zip(ranks, out.split(bl)):
                outs[r] = o
        return outs


def sharded_ragged_paged_attention_ref(q_shards, k_shards, v_shards,
                                       block_tables, pos, width, *,
                                       block_size, mesh=None,
                                       k_scale_shards=None,
                                       v_scale_shards=None,
                                       variant="stream"):
    """Plain version of B4: every rank on its own, its dp group's rows of
    the tables localized to its shard, through the plain version of
    B1/B2 (``ragged_paged_attention_ref``) or B3
    (``ragged_gather_attention_ref``), on any device."""
    who = "sharded_ragged_paged_attention_ref"
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    mesh = _mesh_or_global(mesh, who)
    bs = int(block_size)
    _, nb_local = _check_shards(who, q_shards, k_shards, v_shards,
                                block_tables, pos, width, bs, mesh,
                                k_scale_shards, v_scale_shards)
    return [ragged_group_attention_ref(
        _members(mesh, [r], q_shards, k_shards, v_shards, k_scale_shards,
                 v_scale_shards), block_tables, pos, width, block_size=bs,
        nb_local=nb_local, variant=variant) for r in range(mesh.size)]


ragged_paged_attention.launches = 0
ragged_paged_attention_int8.launches = 0
ragged_gather_attention.launches = 0
sharded_ragged_paged_attention.launches = 0
# every kernel's wrapper, by the name the smoke's report gives it
KERNEL_OPS = {"ragged_paged_attention": ragged_paged_attention,
              "ragged_paged_attention_int8": ragged_paged_attention_int8,
              "ragged_gather_attention": ragged_gather_attention,
              "sharded_ragged_paged_attention":
                  sharded_ragged_paged_attention}
