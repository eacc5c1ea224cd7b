"""Sequence ops over padded-dense tensors + lengths, and over
``RaggedTensor`` — counterpart of ``paddle_tpu/nn/functional/sequence.py``.

Reference parity: ``paddle/fluid/operators/sequence_ops/`` (sequence_pad,
sequence_unpad, sequence_pool, sequence_expand, sequence_softmax, ...)
and ``edit_distance_op.cc``.  The reference stores ragged batches as
LoDTensors; the JAX package's representation, kept here, is a padded
dense tensor plus a lengths vector, and a ``core.ragged.RaggedTensor``
(flat values + row splits), which ``sequence_pad``, ``sequence_pool``,
``sequence_softmax``, ``sequence_reverse`` and ``sequence_expand`` also
take (the segment ops of ``core/ragged.py``).

Every op runs in torch on its input's device and is differentiable in
its float inputs (the lengths, offsets and indices never are; the JAX
package's ``sequence_topk_avg_pooling`` and ``sequence_pad`` of a flat
tensor give no gradient at all); the gradient of a padded position is
zero wherever the op masks it.  Called
with a torch tensor first, an op returns torch tensors; with a handle,
a numpy array or a list, handles (``_io.api``).  Output extents that
depend on the lengths (``sequence_unpad``, ``sequence_expand``,
``sequence_slice``, ...) are read on the host, as the JAX package's are
concrete.  ``edit_distance`` runs its dynamic programme one hypothesis
step at a time over the whole batch (a running minimum along the
reference), where the JAX package loops over the cells in Python.
"""
from __future__ import annotations

import numpy as np
import torch

from ._io import api, as_torch, unwrap, wrap
from ...core.ragged import RaggedTensor
from ...core import ragged as R


def _lengths(x, lengths, dtype=torch.int32):
    """``lengths`` as a torch vector on ``x``'s device; every row full
    (``x.shape[1]``) when None."""
    if lengths is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=dtype,
                          device=x.device)
    return as_torch(lengths, like=x).to(x.device).reshape(-1)


def _valid(t, lengths):
    """[B, t] bool: the positions inside each row's length."""
    return torch.arange(t, device=lengths.device)[None, :] < \
        lengths.long()[:, None]


def _tail(mask, like):
    """``mask`` [B, T] broadcast over ``like`` [B, T, ...]."""
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - 2))


def _scalar(v):
    """A pad value (a number, an array or a tensor) as a Python float."""
    v = unwrap(v)
    if isinstance(v, torch.Tensor):
        return float(v.detach().cpu().reshape(()))
    return float(np.asarray(v).reshape(()))


def _reject_lengths(name, lengths):
    if lengths is not None:
        raise ValueError(
            f"{name}(RaggedTensor): lengths are carried by row_splits — "
            "passing a separate lengths argument would silently conflict")


# -- pad / unpad -------------------------------------------------------------

def sequence_pad(x, pad_value, maxlen=None, lengths=None, name=None):
    """Pad variable-length rows into ``[B, maxlen, ...]`` + lengths
    (reference sequence_pad_op).  ``x`` is a flat ``[sum(L), ...]``
    tensor with ``lengths``, a list of per-sequence arrays, or a
    ``RaggedTensor``; a nested (lod_level 2) one pads the bottom level
    per group (``to_padded_nested``)."""
    if isinstance(x, RaggedTensor):
        if lengths is not None:
            raise ValueError(
                "sequence_pad(RaggedTensor): lengths are carried by "
                "row_splits — do not pass them separately")
        pv = _scalar(pad_value)
        if x.outer_lods:
            if len(x.outer_lods) > 1:
                raise ValueError(
                    "sequence_pad: lod_level > 2 — pad per level with "
                    "to_padded_nested / to_padded explicitly (a single "
                    "dense result would silently flatten the outer "
                    "grouping)")
            rsl = x.recursive_sequence_lengths()
            if maxlen is None:
                maxlen = max(rsl[-1], default=0)
            return x.to_padded_nested(max(rsl[-2], default=0), int(maxlen),
                                      pv)
        if maxlen is None:
            maxlen = int(x.lengths().numpy().max())
        return x.to_padded(int(maxlen), pv)
    if isinstance(x, (list, tuple)):
        seqs = [np.asarray(s) for s in x]
        computed = np.asarray([len(s) for s in seqs], np.int64)
        if lengths is not None:
            given = np.asarray(lengths)
            if not np.array_equal(given, computed):
                raise ValueError(
                    f"lengths {given.tolist()} do not match the given "
                    f"sequences' lengths {computed.tolist()}")
        return _pad_flat(np.concatenate(seqs, axis=0), computed,
                         pad_value=pad_value, maxlen=maxlen)
    if lengths is None:
        raise ValueError("sequence_pad: lengths required for flat input")
    return _pad_flat(x, lengths, pad_value=pad_value, maxlen=maxlen)


@api
def _pad_flat(flat, lengths, pad_value=0.0, maxlen=None):
    ln = as_torch(lengths, like=flat).to(flat.device).long().reshape(-1)
    lens = ln.tolist()
    longest = max(lens, default=0)
    maxlen = longest if maxlen is None else int(maxlen)
    if maxlen < longest:
        raise ValueError(
            f"maxlen ({maxlen}) must be >= the longest sequence "
            f"({longest}) (reference sequence_pad_op enforce)")
    b = len(lens)
    starts = torch.cumsum(ln, 0) - ln
    pos = starts[:, None] + torch.arange(maxlen, device=flat.device)
    valid = _valid(maxlen, ln)
    src = pos.clamp(0, max(flat.shape[0] - 1, 0))
    gathered = flat[src.reshape(-1)].reshape((b, maxlen) +
                                             tuple(flat.shape[1:]))
    pv = torch.tensor(_scalar(pad_value), dtype=flat.dtype,
                      device=flat.device)
    return torch.where(_tail(valid, gathered), gathered, pv), ln


@api
def sequence_unpad(x, length, name=None):
    """Inverse of sequence_pad: [B, T, ...] + lengths -> flat [sum(L), ...]
    (reference sequence_unpad_op); gradients flow back into the padded
    input's valid positions."""
    lens = as_torch(length, like=x).reshape(-1).tolist()
    return torch.cat([x[i, :int(L)] for i, L in enumerate(lens)], dim=0)


# -- pool / softmax / reverse / expand ---------------------------------------

def sequence_pool(x, pool_type, lengths=None, pad_value=0.0, name=None):
    """Pool over the time axis honouring lengths: [B, T, D] -> [B, D]
    (reference sequence_pool: sum/average/max/min/sqrt/first/last).  A
    ``RaggedTensor`` pools by segment ops with no padding at all."""
    if isinstance(x, RaggedTensor):
        _reject_lengths("sequence_pool", lengths)
        return R.sequence_pool(x, pool_type, pad_value=pad_value)
    return _pool(x, pool_type, lengths, pad_value)


@api
def _pool(x, pool_type, lengths=None, pad_value=0.0):
    ln = _lengths(x, lengths)
    ptype = pool_type.lower()
    mask = _tail(_valid(x.shape[1], ln), x)
    ln_f = torch.clamp(ln, min=1).to(x.dtype)[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if ptype == "sum":
        out = torch.where(mask, x, zero).sum(dim=1)
    elif ptype in ("average", "avg", "mean"):
        out = torch.where(mask, x, zero).sum(dim=1) / ln_f
    elif ptype == "sqrt":
        out = torch.where(mask, x, zero).sum(dim=1) / torch.sqrt(ln_f)
    elif ptype == "max":
        out = torch.amax(torch.where(mask, x, torch.full_like(
            zero, -float("inf"))), dim=1)
    elif ptype == "min":
        out = torch.amin(torch.where(mask, x, torch.full_like(
            zero, float("inf"))), dim=1)
    elif ptype == "first":
        out = x[:, 0]
    elif ptype == "last":
        idx = (torch.clamp(ln, min=1) - 1).long()
        out = torch.take_along_dim(
            x, idx.reshape((-1, 1) + (1,) * (x.dim() - 2)), dim=1)[:, 0]
    else:
        raise ValueError(f"unknown pool_type {pool_type}")
    # reference: empty sequences emit pad_value, never +-inf/garbage
    return torch.where((ln > 0).reshape((-1,) + (1,) * (out.dim() - 1)),
                       out, torch.full_like(zero, pad_value))


def sequence_softmax(x, lengths=None, name=None):
    """Softmax over the valid timesteps only: [B, T] (reference
    sequence_softmax_op).  A ``RaggedTensor`` gives a ``RaggedTensor``."""
    if isinstance(x, RaggedTensor):
        _reject_lengths("sequence_softmax", lengths)
        return R.sequence_softmax(x)
    return _softmax(x, lengths)


@api
def _softmax(x, lengths=None):
    mask = _valid(x.shape[1], _lengths(x, lengths))
    mask = _tail(mask, x)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    p = torch.softmax(torch.where(mask, x, torch.full_like(
        zero, -float("inf"))), dim=1)
    return torch.where(mask, p, zero)


def sequence_reverse(x, lengths=None, name=None):
    """Reverse each sequence's valid prefix: [B, T, ...] (reference
    sequence_reverse_op); padding stays where it is."""
    if isinstance(x, RaggedTensor):
        _reject_lengths("sequence_reverse", lengths)
        return R.sequence_reverse(x)
    return _reverse(x, lengths)


@api
def _reverse(x, lengths=None):
    ln = _lengths(x, lengths).long()
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(idx < ln[:, None], ln[:, None] - 1 - idx, idx)
    return torch.take_along_dim(
        x, src.reshape(tuple(src.shape) + (1,) * (x.dim() - 2)), dim=1)


def sequence_expand(x, ref_lengths, ref_level=-1, name=None,
                    capacity=None, max_out_rows=None, one_step=None):
    """Repeat row i of x ``ref_lengths[i]`` times (reference
    sequence_expand with y's LoD); gradients accumulate per source row.
    A ``RaggedTensor`` x with a ``RaggedTensor`` ref repeats whole
    variable-length rows (``core.ragged.sequence_expand``)."""
    if isinstance(x, RaggedTensor):
        if not isinstance(ref_lengths, RaggedTensor):
            raise ValueError(
                "sequence_expand(RaggedTensor): pass the reference as a "
                "RaggedTensor (its LoD level ref_level supplies the "
                "repeat counts)")
        return R.sequence_expand(x, ref_lengths, ref_level=ref_level,
                                 capacity=capacity,
                                 max_out_rows=max_out_rows,
                                 one_step=one_step)
    return _expand(x, ref_lengths)


@api
def _expand(x, ref_lengths):
    reps = as_torch(ref_lengths, like=x).to(x.device).long().reshape(-1)
    return torch.repeat_interleave(x, reps, dim=0,
                                   output_size=int(reps.sum()))


# -- edit distance, row conv ------------------------------------------------

def edit_distance(input, label, normalized=True, input_length=None,
                  label_length=None, name=None):
    """Levenshtein distance per batch row over padded int sequences
    (reference edit_distance_op.cc).  Returns (distances [B, 1] float32,
    sequence_num [1] int64)."""
    return _edit_distance(input, label, normalized, input_length,
                          label_length)


@api
def _edit_distance(hyp, ref, normalized, input_length, label_length):
    ref = as_torch(ref, like=hyp).to(hyp.device)
    b = hyp.shape[0]
    hl = _lengths(hyp, input_length, torch.int64).long()
    rl = _lengths(ref, label_length, torch.int64).long()
    n = ref.shape[1]
    cols = torch.arange(n + 1, device=hyp.device, dtype=torch.float32)
    # dp[b, j]: the distance between hyp[b, :a] and ref[b, :j]
    dp = cols.expand(b, n + 1).clone()
    out = rl.to(torch.float32).clone()   # hypotheses of length 0
    for a in range(1, int(hl.max()) + 1 if b else 1):
        cost = (hyp[:, a - 1, None] != ref).to(torch.float32)   # [B, n]
        sub = torch.cat([torch.full((b, 1), float(a), dtype=torch.float32,
                                    device=hyp.device),
                         torch.minimum(dp[:, 1:] + 1, dp[:, :-1] + cost)],
                        dim=1)
        # dp_new[j] = min(sub[j], dp_new[j - 1] + 1): a running minimum
        dp = torch.cummin(sub - cols, dim=1).values + cols
        done = hl == a
        out = torch.where(done, dp.gather(1, rl[:, None])[:, 0], out)
    if normalized:
        out = out / torch.clamp(rl.to(torch.float32), min=1.0)
    return out[:, None], torch.tensor([b], dtype=torch.int64,
                                      device=hyp.device)


@api
def _row_conv(x, w):
    """x [B, T, D], w [future_context+1, D]: y[t] = sum_i w[i]*x[t+i]
    (reference: row_conv_op.cc — lookahead convolution for streaming
    speech models)."""
    ctx, t = w.shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, 0, ctx - 1))
    out = torch.zeros_like(x)
    for i in range(ctx):
        out = out + pad[:, i:i + t, :] * w[i][None, None, :]
    return out


def row_conv(x, weight, act=None, name=None):
    out = _row_conv(x, weight)
    if act:
        from . import activation as _act
        out = getattr(_act, act)(out)
    return out


def sequence_first_step(input, lengths=None, name=None):
    """First valid timestep per sequence (reference
    sequence_pool_op FIRST strategy)."""
    return sequence_pool(input, "first", lengths=lengths)


def sequence_last_step(input, lengths=None, name=None):
    """Last valid timestep per sequence (reference
    sequence_pool_op LAST strategy)."""
    return sequence_pool(input, "last", lengths=lengths)


# -- the rest of sequence_ops -------------------------------------------------

def sequence_concat(input, lengths=None, name=None):
    """Per-sequence concatenation of N (dense, lengths) batches
    (reference sequence_concat_op): row i of the output holds the valid
    prefixes of row i of each input, one after the other.  ``input`` is
    a list of [B, T_k, ...] tensors, ``lengths`` the matching list of
    [B] length vectors (None -> full).  Returns (dense [B, sum T_k, ...],
    lengths int32)."""
    handles = not isinstance(input[0], torch.Tensor)
    xs = [as_torch(v) for v in input]
    lens = [_lengths(x, L) for x, L in zip(
        xs, lengths if lengths is not None else [None] * len(xs))]
    b, total_t = xs[0].shape[0], sum(a.shape[1] for a in xs)
    feat = tuple(xs[0].shape[2:])
    dev = xs[0].device
    out = torch.zeros((b, total_t + 1) + feat, dtype=xs[0].dtype,
                      device=dev)
    acc = torch.zeros((b,), dtype=torch.int32, device=dev)
    for a, ln in zip(xs, lens):
        ln = ln.to(torch.int32)
        tpos = torch.arange(a.shape[1], device=dev, dtype=torch.int32)[None]
        dest = torch.where(tpos < ln[:, None], acc[:, None] + tpos,
                           torch.full_like(tpos, total_t))   # park invalid
        bidx = torch.arange(b, device=dev)[:, None].expand(dest.shape)
        out = out.index_put((bidx.reshape(-1), dest.reshape(-1).long()),
                            a.reshape((-1,) + feat))
        acc = acc + ln
    res = (out[:, :total_t], acc)
    return wrap(res) if handles else res


@api
def sequence_expand_as(x, y_lengths, name=None):
    """Expand each row of x to as many timesteps as y has (reference
    sequence_expand_as_op): x [B, ...] -> [B, T, ...], each row repeated
    along the new time axis and masked by ``y_lengths``."""
    ln = as_torch(y_lengths, like=x).to(x.device).reshape(-1)
    t = int(ln.max())
    rep = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    mask = _tail(_valid(t, ln), rep)
    return torch.where(mask, rep, torch.zeros((), dtype=x.dtype,
                                              device=x.device))


@api
def sequence_slice(input, offset, length, name=None):
    """Per-sequence slice (reference sequence_slice_op): row i takes
    ``length[i]`` steps from ``offset[i]``.  Returns padded dense
    [B, max(length), ...] + lengths int32."""
    x = input
    off = as_torch(offset, like=x).to(x.device).reshape(-1).long()
    ln = as_torch(length, like=x).to(x.device).reshape(-1).to(torch.int32)
    max_out = int(ln.max())
    tpos = torch.arange(max_out, device=x.device)[None, :]
    src = torch.clamp(off[:, None] + tpos, 0, x.shape[1] - 1)
    gathered = torch.take_along_dim(
        x, src.reshape(tuple(src.shape) + (1,) * (x.dim() - 2)), dim=1)
    mask = _tail(tpos < ln.long()[:, None], gathered)
    out = torch.where(mask, gathered, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    return out, ln


@api
def sequence_scatter(input, index, updates, lengths=None, name=None):
    """Scatter-add updates into per-sequence positions (reference
    sequence_scatter_op): out[i, index[i, j]] += updates[i, j] for the
    valid j < lengths[i]."""
    x = input
    idx = as_torch(index, like=x).to(x.device).long()
    upd = as_torch(updates, like=x).to(x.device)
    ln = _lengths(idx, lengths)
    mask = _tail(_valid(idx.shape[1], ln), upd)
    upd = torch.where(mask, upd, torch.zeros((), dtype=upd.dtype,
                                             device=upd.device))
    bidx = torch.arange(x.shape[0], device=x.device)[:, None].expand(
        idx.shape)
    return x.index_put((bidx, idx), upd.to(x.dtype), accumulate=True)


@api
def sequence_enumerate(input, win_size, pad_value=0, lengths=None,
                       name=None):
    """Sliding windows of ids (reference sequence_enumerate_op):
    [B, T] int -> [B, T, win_size], out[i, t] = input[i, t:t+win] (the
    pad value past the valid length)."""
    x = input
    ln = _lengths(x, lengths)
    t, win = x.shape[1], int(win_size)
    src = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(win, device=x.device)[None, :])     # [T, W]
    valid = src[None] < ln.long()[:, None, None]
    gathered = x[:, src.clamp(0, t - 1)]                    # [B, T, W]
    return torch.where(valid, gathered, torch.tensor(
        pad_value, dtype=x.dtype, device=x.device))


@api
def sequence_reshape(input, new_dim, lengths=None, name=None):
    """Reshape the feature dim by regrouping timesteps (reference
    sequence_reshape_op).  Dense form: T*D must divide by new_dim;
    lengths scale by D/new_dim (int32)."""
    x = input
    ln = _lengths(x, lengths)
    b, t, d = x.shape[0], int(x.shape[1]), int(x.shape[-1])
    nd = int(new_dim)
    if (t * d) % nd != 0:
        raise ValueError(
            f"sequence_reshape: T*D ({t}*{d}) not divisible by new_dim "
            f"{nd} (reference sequence_reshape_op enforce)")
    return (x.reshape(b, (t * d) // nd, nd),
            torch.div(ln.to(torch.int32) * d, nd, rounding_mode="floor"))


@api
def sequence_conv(input, weight, bias=None, context_length=3,
                  context_start=None, padding_value=0.0, lengths=None,
                  name=None):
    """Context-window conv over time (reference sequence_conv_op): each
    step concatenates ``context_length`` neighbouring frames from
    ``context_start`` (default -(len-1)//2), the frames outside the
    row's length taking ``padding_value``, and projects by ``weight``
    [context_length * D, M]; padded steps give 0."""
    x = input
    w = as_torch(weight, like=x)
    ln = _lengths(x, lengths).long()
    cl = int(context_length)
    cs = -((cl - 1) // 2) if context_start is None else int(context_start)
    bsz, t, d = x.shape
    src = (torch.arange(t, device=x.device)[:, None]
           + torch.arange(cl, device=x.device)[None, :] + cs)  # [T, CL]
    ctx = x[:, src.clamp(0, t - 1)]                           # [B, T, CL, D]
    in_seq = (src[None] >= 0) & (src[None] < ln[:, None, None])
    ctx = torch.where(in_seq[..., None], ctx, torch.tensor(
        padding_value, dtype=x.dtype, device=x.device))
    out = ctx.reshape(bsz, t, cl * d) @ w
    if bias is not None:
        out = out + as_torch(bias, like=x)
    valid = _valid(t, ln)
    return torch.where(valid[..., None], out, torch.zeros(
        (), dtype=out.dtype, device=out.device))


@api
def sequence_erase(input, tokens, lengths=None, name=None):
    """Remove listed tokens from each sequence (reference
    sequence_erase_op).  Dense form: the kept entries are compacted to
    the front in order, the tail is zero.  ``input`` [B, S] int,
    ``tokens`` a list of ids.  Returns (out [B, S], new_lengths [B]
    int32)."""
    x = input
    toks = tuple(int(t) for t in (tokens if isinstance(
        tokens, (list, tuple)) else [tokens]))
    s = x.shape[1]
    keep = _valid(s, _lengths(x, lengths))
    for t in toks:
        keep = keep & (x != t)
    # stable compaction: the kept entries first, in order
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    compacted = torch.take_along_dim(x, order, dim=1)
    new_len = keep.sum(dim=1).to(torch.int32)
    out = torch.where(_valid(s, new_len), compacted,
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return out, new_len


@api
def sequence_topk_avg_pooling(input, row_lengths, col_lengths, topks,
                              channel_num=1, name=None):
    """Per-row top-k average pooling over a [B, C, R, Cm] score map
    (reference sequence_topk_avg_pooling_op, used by match-matrix text
    models): the masked columns are left out; returns
    [B, R, C * len(topks)], the rows past ``row_lengths`` zero."""
    x = input
    b, c, r, cm = x.shape
    row_l = as_torch(row_lengths, like=x).to(x.device).long().reshape(-1)
    col_l = as_torch(col_lengths, like=x).to(x.device).long().reshape(-1)
    col_mask = torch.arange(cm, device=x.device)[None, None, None, :] < \
        col_l[:, None, None, None]
    masked = torch.where(col_mask, x, torch.tensor(
        torch.finfo(x.dtype).min, dtype=x.dtype, device=x.device))
    desc = torch.sort(masked, dim=-1, descending=True).values
    outs = []
    for k in topks:
        k = int(k)
        kk = torch.clamp(col_l, max=k)
        pos_ok = torch.arange(k, device=x.device)[None, None, None, :] < \
            kk[:, None, None, None]
        top = desc[..., :k]
        summed = torch.where(pos_ok[..., :top.shape[-1]], top,
                             torch.zeros((), dtype=x.dtype,
                                         device=x.device)).sum(-1)
        outs.append(summed / torch.clamp(kk, min=1).to(x.dtype)[
            :, None, None])
    out = torch.stack(outs, dim=-1)                       # [B, C, R, K]
    out = out.permute(0, 2, 1, 3).reshape(b, r, c * len(topks))
    row_mask = _valid(r, row_l)
    return torch.where(row_mask[:, :, None], out,
                       torch.zeros((), dtype=x.dtype, device=x.device))
