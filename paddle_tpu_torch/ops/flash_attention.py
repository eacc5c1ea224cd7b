"""Flash attention — forward, dK/dV and dQ kernels with a custom backward.

Counterpart of the upstream Pallas TPU kernel that
``paddle_tpu/nn/functional/attention.py`` reaches through
``_flash_attention`` (``jax/experimental/pallas/ops/tpu/flash_attention.py``:
``flash_attention``, its custom VJP ``_flash_attention_fwd`` /
``_flash_attention_bwd``, and the three ``pallas_call``s in
``_flash_attention_impl``, ``_flash_attention_bwd_dkv`` and
``_flash_attention_bwd_dq``).

Layout is the paddle one, ``[B, S, H, D]``, for q, k, v, o and their
gradients; the per-row log-sum-exp ``lse`` and ``di = sum(o * do)`` are
f32 ``[B, H, S]``.  The forward saves ``lse`` (the upstream saves ``l``
and ``m``; ``lse = m + log l`` carries the same information).  Masks:
``causal`` (query i sees keys j <= i; q and k have one length, so the
top-left and bottom-right diagonals agree) and optional ``segment_ids``
``[B, S]`` int32 (a query sees only keys of its own segment), combined.
Every row keeps its diagonal under either mask, so no row is empty.

Three wrappers, one per kernel: ``flash_fwd``, ``flash_bwd_dkv`` and
``flash_bwd_dq``.  Each runs its plain PyTorch version (``*_ref``, the
same FlashAttention-2 recurrence in f32) for CPU tensors, and for CUDA
tensors launches its kernel on the current stream without synchronizing
and adds one to its ``launches``.  ``route`` names the kernel a CUDA call
takes: bf16 and fp16 run on the tensor cores
(``csrc/flash_attention_sm90.cu``, one template instantiated for each;
the kernels round P and dS to the input dtype before their products, as
the TPU kernel does), float32 on the scalar kernels
(``csrc/flash_attention.cu``).  A dtype, head dim, length, alignment or
device no kernel takes raises; nothing falls back.

``flash_attention`` is differentiable through ``torch.autograd.Function``:
forward -> ``flash_fwd``; backward -> ``di`` in plain f32 torch (as the
upstream computes it outside Pallas), then ``flash_bwd_dkv``, then
``flash_bwd_dq``.  It takes segment ids of any integer dtype and layout
(as the reference takes any ``[B, S]`` integer array) and hands the
kernels int32 contiguous ones.  ``flash_attention_ref`` is the same
function over the plain versions on any device (the comparisons on the
card use it).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# the dtype codes of the C entry points: 0 the scalar kernels' f32, 1 and
# 2 the tensor-core kernels' bf16 and fp16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (64, 128)
BLOCK = 64               # the kernels' q and k tile rows
_MAX_SMEM = 227 * 1024   # an H100 block's shared-memory ceiling
_MASK = -1e30
_KERNEL_ID = {"fwd": 0, "bwd_dkv": 1, "bwd_dq": 2}
# the C entry points of each route, a dtype code first:
# csrc/flash_attention.cu (scalar) and csrc/flash_attention_sm90.cu
# (tensor cores, bf16 and fp16)
_ENTRY = {("scalar", "fwd"): "flash_fwd_launch",
          ("scalar", "bwd_dkv"): "flash_bwd_dkv_launch",
          ("scalar", "bwd_dq"): "flash_bwd_dq_launch",
          ("tensor_core", "fwd"): "flash_fwd_sm90_launch",
          ("tensor_core", "bwd_dkv"): "flash_bwd_dkv_sm90_launch",
          ("tensor_core", "bwd_dq"): "flash_bwd_dq_sm90_launch"}


def route(dtype, head_dim):
    """The kernels a CUDA call of ``flash_fwd``, ``flash_bwd_dkv`` or
    ``flash_bwd_dq`` takes for inputs of ``dtype`` and ``head_dim``:
    ``"tensor_core"`` (bf16 and fp16, the one ``auto_cast(dtype=
    "float16")`` gives q, k and v; wgmma, ``csrc/flash_attention_sm90.cu``)
    or ``"scalar"`` (float32; ``csrc/flash_attention.cu``).  Raises
    TypeError for another dtype and ValueError for a head dim outside
    ``HEAD_DIMS``.

    float32 stays on the scalar kernels on purpose: on the tensor cores
    float32 runs as TF32 (about three decimal digits), which breaks the
    float32 contract (o at atol 1e-5, gradients at 1e-4), and nothing on
    the main path runs flash in float32 (training casts the model to bf16).
    """
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash attention: dtype {dtype} not supported "
                        "(float32, bfloat16 or float16)")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {head_dim} not "
                         f"supported {HEAD_DIMS}")
    return "scalar" if dtype == torch.float32 else "tensor_core"


# -- plain versions -------------------------------------------------------
def _visible(q0, nq, k0, nk, causal, seg, device):
    """Bool ``[B or 1, 1, nq, nk]``: which (query, key) pairs of the
    query rows ``q0..q0+nq`` and key rows ``k0..k0+nk`` are visible."""
    vis = torch.ones(1, 1, nq, nk, dtype=torch.bool, device=device)
    if causal:
        qi = torch.arange(q0, q0 + nq, device=device)
        kj = torch.arange(k0, k0 + nk, device=device)
        vis = vis & (kj[None, :] <= qi[:, None])[None, None]
    if seg is not None:
        vis = vis & (seg[:, q0:q0 + nq, None]
                     == seg[:, None, k0:k0 + nk])[:, None]
    return vis


def _heads_first(t):
    """``[B, S, H, D]`` -> f32 ``[B, H, S, D]``."""
    return t.float().permute(0, 2, 1, 3)


def flash_fwd_ref(q, k, v, segment_ids=None, *, causal, sm_scale,
                  block_k=BLOCK):
    """Plain version of the forward kernel: online softmax over k-blocks
    of ``block_k`` rows, f32 throughout.  Returns ``(o [B, S, H, D]`` in
    q's dtype, ``lse [B, H, S]`` f32)."""
    B, S, H, D = q.shape
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    m = torch.full((B, H, S), _MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, k.shape[1], block_k):
        kb, vb = kf[:, :, k0:k0 + block_k], vf[:, :, k0:k0 + block_k]
        vis = _visible(0, S, k0, kb.shape[2], causal, segment_ids,
                       q.device)
        s = torch.where(vis, qf @ kb.transpose(-1, -2) * sm_scale,
                        torch.full((), _MASK, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(vis, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vb
        m = m_new
    o = (acc / l[..., None]).permute(0, 2, 1, 3).to(q.dtype)
    return o, m + torch.log(l)


def _bwd_blocks(q, k, v, do, lse, di, segment_ids, causal, sm_scale,
                block_q):
    """Yields, per q-block of ``block_q`` rows, ``(q0, qb, dob, p, ds)``:
    the block's f32 q and do ``[B, H, bq, D]``, its probabilities
    recomputed from ``lse`` and ``ds = p * (dp - di)`` ``[B, H, bq, S]``,
    both exactly 0 where masked."""
    S = q.shape[1]
    qf, kf, vf, dof = (_heads_first(t) for t in (q, k, v, do))
    for q0 in range(0, S, block_q):
        qb, dob = qf[:, :, q0:q0 + block_q], dof[:, :, q0:q0 + block_q]
        vis = _visible(q0, qb.shape[2], 0, kf.shape[2], causal,
                       segment_ids, q.device)
        s = qb @ kf.transpose(-1, -2) * sm_scale
        p = torch.where(vis, torch.exp(s - lse[:, :, q0:q0 + block_q,
                                                None]),
                        torch.zeros((), device=q.device))
        dp = dob @ vf.transpose(-1, -2)
        ds = p * (dp - di[:, :, q0:q0 + block_q, None])
        yield q0, qb, dob, p, ds


def flash_bwd_dkv_ref(q, k, v, do, lse, di, segment_ids=None, *, causal,
                      sm_scale, block_q=BLOCK):
    """Plain version of the dK/dV kernel: ``dv = sum_q p^T do`` and
    ``dk = sum_q ds^T q * scale``, accumulated over q-blocks in f32.
    Returns ``(dk, dv)`` ``[B, S, H, D]`` in q's dtype."""
    B, S, H, D = k.shape
    dk = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for _, qb, dob, p, ds in _bwd_blocks(q, k, v, do, lse, di, segment_ids,
                                         causal, sm_scale, block_q):
        dv += p.transpose(-1, -2) @ dob
        dk += ds.transpose(-1, -2) @ qb
    return ((dk * sm_scale).permute(0, 2, 1, 3).to(q.dtype),
            dv.permute(0, 2, 1, 3).to(q.dtype))


def flash_bwd_dq_ref(q, k, v, do, lse, di, segment_ids=None, *, causal,
                     sm_scale, block_q=BLOCK):
    """Plain version of the dQ kernel: ``dq = ds k * scale`` per
    q-block.  Returns ``dq`` ``[B, S, H, D]`` in q's dtype."""
    kf = _heads_first(k)
    parts = [ds @ kf for _, _, _, _, ds in _bwd_blocks(
        q, k, v, do, lse, di, segment_ids, causal, sm_scale, block_q)]
    dq = torch.cat(parts, dim=2) * sm_scale
    return dq.permute(0, 2, 1, 3).to(q.dtype)


# -- kernel wrappers ------------------------------------------------------
def _check(name, tensors, segment_ids, f32_tensors=()):
    """Device, dtype, layout and shape checks shared by the wrappers.
    ``tensors`` are ``[B, S, H, D]`` in one dtype; ``f32_tensors`` are
    ``[B, H, S]`` f32.  Returns ``(B, S, H, D)``."""
    q = tensors[0]
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, S, H, D], got "
                         f"{tuple(q.shape)}")
    B, S, H, D = q.shape
    for t in tensors:
        if tuple(t.shape) != (B, S, H, D):
            raise ValueError(f"{name}: q, k, v (and do) must share shape "
                             f"{(B, S, H, D)}, got {tuple(t.shape)} (the "
                             "kernels take one sequence length)")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v (and do) must share one "
                            "dtype")
    for t in f32_tensors:
        if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32:
            raise ValueError(f"{name}: lse / di must be f32 {(B, H, S)}")
    if segment_ids is not None and (
            tuple(segment_ids.shape) != (B, S)
            or segment_ids.dtype != torch.int32):
        raise ValueError(f"{name}: segment_ids must be int32 {(B, S)}")
    for t in (*tensors, *f32_tensors,
              *(() if segment_ids is None else (segment_ids,))):
        if t.device != dev:
            raise ValueError(f"{name}: every input must be on {dev}")
    if dev.type == "cpu":
        return B, S, H, D
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    route(q.dtype, D)
    if S % BLOCK:
        raise ValueError(f"{name}: sequence length {S} is not a multiple "
                         f"of the kernel's {BLOCK}-row tiles")
    for t in (*tensors, *f32_tensors,
              *(() if segment_ids is None else (segment_ids,))):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        # the tensor-core kernels' TMA and bulk copies take 16-byte
        # aligned addresses
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must start on a 16-byte "
                             "boundary")
    return B, S, H, D


def _seg_ptr(segment_ids):
    return 0 if segment_ids is None else segment_ids.data_ptr()


_prepared = set()   # (route, kernel, dtype, D, device index) already set up


def _prepare(lib, path, kernel, q):
    """Once per (route, kernel, dtype, head dim, card): check the block's
    shared memory against the ceiling and raise the kernel's limit to
    it."""
    D = q.shape[-1]
    key = (path, kernel, q.dtype, D, q.device.index)
    if key in _prepared:
        return
    if path == "tensor_core":
        smem = lib.flash_sm90_smem_bytes(_KERNEL_ID[kernel], D)
    else:
        smem = lib.flash_smem_bytes(_KERNEL_ID[kernel], D)
    if smem > _MAX_SMEM:
        raise ValueError(f"flash {kernel}: head dim {D} needs {smem} B of "
                         f"shared memory per block, over {_MAX_SMEM}")
    if path == "tensor_core":
        rc = lib.flash_sm90_prepare(_KERNEL_ID[kernel],
                                    _DTYPE_CODE[q.dtype], D)
    else:
        rc = lib.flash_prepare(_KERNEL_ID[kernel], _DTYPE_CODE[q.dtype], D)
    if rc != 0:
        raise RuntimeError(f"flash {kernel}: setting its shared-memory "
                           f"limit failed with CUDA error {rc}")
    _prepared.add(key)


def entry(kernel, dtype, head_dim):
    """``(route, C entry point)`` of a CUDA call of ``kernel`` ("fwd",
    "bwd_dkv" or "bwd_dq")."""
    path = route(dtype, head_dim)
    return path, _ENTRY[path, kernel]


def _launch(kernel, q, *args):
    """Launch ``kernel`` on q's card by its route; raise on a CUDA
    error."""
    path, name = entry(kernel, q.dtype, q.shape[-1])
    lib = _load_sm90() if path == "tensor_core" else _load()
    fn = getattr(lib, name)
    args = (_DTYPE_CODE[q.dtype], *args)
    with torch.cuda.device(q.device):
        _prepare(lib, path, kernel, q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"flash {kernel}: kernel launch failed with "
                           f"CUDA error {rc}")
    ROUTE_LAUNCHES[path] += 1
    DTYPE_LAUNCHES[q.dtype] += 1


def flash_fwd(q, k, v, segment_ids=None, *, causal, sm_scale):
    """Forward kernel: ``(o [B, S, H, D], lse [B, H, S] f32)``."""
    B, S, H, D = _check("flash_fwd", (q, k, v), segment_ids)
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, segment_ids, causal=causal,
                             sm_scale=sm_scale)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _launch("fwd", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), _seg_ptr(segment_ids), o.data_ptr(),
            lse.data_ptr(), B, H, S, D, int(bool(causal)),
            float(sm_scale))
    flash_fwd.launches += 1
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, di, segment_ids=None, *, causal,
                  sm_scale):
    """dK/dV kernel: ``(dk, dv)`` ``[B, S, H, D]`` in q's dtype."""
    B, S, H, D = _check("flash_bwd_dkv", (q, k, v, do), segment_ids,
                        (lse, di))
    if q.device.type == "cpu":
        return flash_bwd_dkv_ref(q, k, v, do, lse, di, segment_ids,
                                 causal=causal, sm_scale=sm_scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("bwd_dkv", q, q.data_ptr(),
            k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            di.data_ptr(), _seg_ptr(segment_ids), dk.data_ptr(),
            dv.data_ptr(), B, H, S, D, int(bool(causal)), float(sm_scale))
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, segment_ids=None, *, causal,
                 sm_scale):
    """dQ kernel: ``dq`` ``[B, S, H, D]`` in q's dtype."""
    B, S, H, D = _check("flash_bwd_dq", (q, k, v, do), segment_ids,
                        (lse, di))
    if q.device.type == "cpu":
        return flash_bwd_dq_ref(q, k, v, do, lse, di, segment_ids,
                                causal=causal, sm_scale=sm_scale)
    dq = torch.empty_like(q)
    _launch("bwd_dq", q, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
            _seg_ptr(segment_ids), dq.data_ptr(), B, H, S, D,
            int(bool(causal)), float(sm_scale))
    flash_bwd_dq.launches += 1
    return dq


flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
# launches of the three kernels by route, beside each wrapper's own count:
# what a caller reads to show which kernels (bf16 / fp16 tensor-core or
# fp32 scalar) a path took; DTYPE_LAUNCHES counts them by input dtype
ROUTE_LAUNCHES = {"tensor_core": 0, "scalar": 0}
DTYPE_LAUNCHES = {torch.float32: 0, torch.bfloat16: 0, torch.float16: 0}
KERNEL_OPS = {"fwd": flash_fwd, "bwd_dkv": flash_bwd_dkv,
              "bwd_dq": flash_bwd_dq}
PLAIN_OPS = {"fwd": flash_fwd_ref, "bwd_dkv": flash_bwd_dkv_ref,
             "bwd_dq": flash_bwd_dq_ref}


def _load():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, i, f, p]      # B, H, S, D, causal, scale, stream
        lib.flash_fwd_launch.argtypes = [i] + [p] * 6 + tail
        lib.flash_bwd_dkv_launch.argtypes = [i] + [p] * 9 + tail
        lib.flash_bwd_dq_launch.argtypes = [i] + [p] * 8 + tail
        for fn in (lib.flash_fwd_launch, lib.flash_bwd_dkv_launch,
                   lib.flash_bwd_dq_launch):
            fn.restype = i
        lib.flash_smem_bytes.argtypes = [i, i]
        lib.flash_smem_bytes.restype = ctypes.c_size_t
        lib.flash_prepare.argtypes = [i, i, i]
        lib.flash_prepare.restype = i
        lib._argtypes_set = True
    return lib


def _load_sm90():
    lib = _build.load("flash_attention_sm90")
    if not getattr(lib, "_argtypes_set", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        tail = [i, i, i, i, i, f, p]      # B, H, S, D, causal, scale, stream
        lib.flash_fwd_sm90_launch.argtypes = [i] + [p] * 6 + tail
        lib.flash_bwd_dkv_sm90_launch.argtypes = [i] + [p] * 9 + tail
        lib.flash_bwd_dq_sm90_launch.argtypes = [i] + [p] * 8 + tail
        for fn in (lib.flash_fwd_sm90_launch, lib.flash_bwd_dkv_sm90_launch,
                   lib.flash_bwd_dq_sm90_launch):
            fn.restype = i
        lib.flash_sm90_smem_bytes.argtypes = [i, i]
        lib.flash_sm90_smem_bytes.restype = ctypes.c_size_t
        lib.flash_sm90_prepare.argtypes = [i, i, i]
        lib.flash_sm90_prepare.restype = i
        lib._argtypes_set = True
    return lib


# -- differentiable op ----------------------------------------------------
class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); backward through the dK/dV and dQ ops.
    ``ops`` picks the three functions (``KERNEL_OPS`` or ``PLAIN_OPS``)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, sm_scale, ops):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32).contiguous()
        o, lse = ops["fwd"](q, k, v, segment_ids, causal=causal,
                            sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse, segment_ids)
        ctx.causal, ctx.sm_scale, ctx.ops = causal, sm_scale, ops
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, segment_ids = ctx.saved_tensors
        do = do.contiguous()
        di = (o.float() * do.float()).sum(dim=-1).transpose(1, 2) \
            .contiguous()                                   # [B, H, S]
        kw = dict(causal=ctx.causal, sm_scale=ctx.sm_scale)
        dk, dv = ctx.ops["bwd_dkv"](q, k, v, do, lse, di, segment_ids,
                                    **kw)
        dq = ctx.ops["bwd_dq"](q, k, v, do, lse, di, segment_ids, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, segment_ids=None, *, causal=True,
                    sm_scale=None):
    """Differentiable flash attention over ``[B, S, H, D]`` q, k, v of one
    length: the kernels on CUDA, their plain versions on the CPU.
    ``sm_scale`` defaults to ``1 / sqrt(D)``."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal), scale,
                                 KERNEL_OPS)


def flash_attention_ref(q, k, v, segment_ids=None, *, causal=True,
                        sm_scale=None):
    """``flash_attention`` through the plain versions on any device."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    return _FlashAttention.apply(q, k, v, segment_ids, bool(causal), scale,
                                 PLAIN_OPS)
