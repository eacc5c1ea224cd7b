"""RaggedTensor — counterpart of ``paddle_tpu/core/ragged.py``.

LoD semantics on a flat layout (reference ``lod_tensor.h``):

* ``values`` [capacity, ...]: the rows concatenated, zero-padded up to a
  fixed ``capacity``;
* ``row_splits`` [B+1]: the level-0 offsets;
* positions at or past ``row_splits[-1]`` belong to a trash segment, so
  every segment op runs over ``B + 1`` segments and drops the last.

Nested LoD is carried as ``outer_lods``: offset vectors, outermost
first, each indexing the rows of the next level; ``row_splits`` stays
the bottom level.

The sequence ops are segment reductions over the flat layout:
``index_add`` for sums and ``scatter_reduce`` for max / min, with the
JAX package's static capacity.  They run on the values' device and are
differentiable through torch.  The JAX package's jit-only arguments
(``sequence_expand``'s ``one_step`` under a trace) keep their meaning:
here every length is concrete, so the concrete checks always run.
"""
from __future__ import annotations

import numpy as np
import torch

from .tensor import Tensor
from .dispatch import ensure_tensor


def _bcast(mask, like):
    """``mask`` [N] reshaped to broadcast over ``like`` [N, ...]."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def _segment_sum(v, ids, n):
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype,
                      device=v.device)
    return out.index_add(0, ids, v)


def _segment_reduce(v, ids, n, how):
    """``segment_max`` / ``segment_min``: empty segments hold the dtype's
    identity (its lowest or highest value)."""
    info = torch.finfo if v.is_floating_point() else torch.iinfo
    fill = info(v.dtype).min if how == "amax" else info(v.dtype).max
    out = torch.full((n,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                     device=v.device)
    idx = ids.reshape(_bcast(ids, v).shape).expand_as(v)
    return out.scatter_reduce(0, idx, v, how, include_self=True)


class RaggedTensor:
    """Flat ``values`` + ``row_splits`` (+ static ``capacity``)."""

    __slots__ = ("values", "row_splits", "capacity", "outer_lods")

    def __init__(self, values, row_splits, outer_lods=()):
        self.values = ensure_tensor(values)
        self.row_splits = ensure_tensor(row_splits)
        self.capacity = int(self.values.shape[0])
        self.outer_lods = tuple(ensure_tensor(s) for s in outer_lods)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_padded(cls, dense, lengths, capacity=None):
        """[B, L, ...] + lengths -> ragged.  ``capacity`` defaults to B*L
        (lossless); a bucket size bounds the shapes."""
        d = ensure_tensor(dense)._data
        lens = ensure_tensor(lengths)._data.to(device=d.device,
                                               dtype=torch.int32)
        B, L = d.shape[0], d.shape[1]
        cap = int(capacity or B * L)
        total = int(lens.sum())
        if total > cap:
            raise ValueError(
                f"RaggedTensor.from_padded: capacity {cap} < total "
                f"tokens {total} — the scatter would silently drop data "
                "(pick the bucket like io/bucketing.py does)")
        splits = torch.cat([torch.zeros(1, dtype=torch.int32,
                                        device=d.device),
                            torch.cumsum(lens, 0).to(torch.int32)])
        ar = torch.arange(L, device=d.device)
        pos = splits[:-1, None] + ar[None, :]
        valid = ar[None, :] < lens[:, None]
        slot = torch.where(valid, pos, torch.full_like(pos, cap))
        flat = torch.zeros((cap + 1,) + tuple(d.shape[2:]), dtype=d.dtype,
                           device=d.device)
        flat = flat.index_put((slot.reshape(-1).long(),),
                              d.reshape((B * L,) + tuple(d.shape[2:])))
        return cls(Tensor._wrap(flat[:cap]), Tensor._wrap(splits))

    @staticmethod
    def pack_rows_numpy(rows, capacity=None):
        """Pure-numpy packing -> (flat [cap, ...], row_splits [B+1])."""
        rows = [np.asarray(r) for r in rows]
        lens = np.array([len(r) for r in rows], np.int32)
        total = int(lens.sum())
        cap = int(capacity or total)
        if cap < total:
            raise ValueError(
                f"RaggedTensor: capacity {cap} < total length {total}")
        tail = rows[0].shape[1:] if rows else ()
        flat = np.zeros((cap,) + tail, rows[0].dtype if rows
                        else np.float32)
        off = 0
        for r in rows:
            flat[off:off + len(r)] = r
            off += len(r)
        splits = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
        return flat, splits

    @classmethod
    def from_rows(cls, rows, capacity=None):
        """list of per-row numpy arrays -> ragged, on the current place."""
        flat, splits = cls.pack_rows_numpy(rows, capacity)
        return cls(Tensor(flat), Tensor(splits))

    @classmethod
    def from_nested_rows(cls, nested, capacity=None):
        """Nested lists of row arrays -> ragged with ``lod_level ==
        depth``.  Rows must be numpy arrays; grouping levels above them
        are lists or tuples."""
        lods = []
        level = list(nested)
        while level and isinstance(level[0], (list, tuple)):
            counts = np.array([len(g) for g in level], np.int64)
            lods.append(np.concatenate(
                [[0], np.cumsum(counts)]).astype(np.int32))
            level = [item for g in level for item in g]
        flat, splits = cls.pack_rows_numpy(level, capacity)
        return cls(Tensor(flat), Tensor(splits),
                   outer_lods=tuple(Tensor(s) for s in lods))

    # -- views ------------------------------------------------------------
    @property
    def lod_level(self):
        return len(self.outer_lods) + 1

    def lod(self):
        """Offset form, outermost level first."""
        return [[int(v) for v in s.numpy()] for s in self.outer_lods] + \
            [[int(v) for v in self.row_splits.numpy()]]

    def recursive_sequence_lengths(self):
        """Length form per level."""
        out = []
        for off in self.lod():
            a = np.asarray(off)
            out.append([int(v) for v in a[1:] - a[:-1]])
        return out

    @property
    def nrows(self):
        return int(self.row_splits.shape[0]) - 1

    def lengths(self):
        s = self.row_splits._data
        return Tensor._wrap(s[1:] - s[:-1])

    def _ids(self):
        """[capacity] int64: the row of each flat slot; trash slots get B
        (one past the last row)."""
        s = self.row_splits._data
        pos = torch.arange(self.capacity, device=s.device, dtype=s.dtype)
        ids = torch.searchsorted(s, pos, right=True) - 1
        live = pos < s[-1]
        return torch.where(live, ids, torch.full_like(ids, self.nrows))

    def segment_ids(self):
        """[capacity]: the row of each flat slot; trash slots get B."""
        return Tensor._wrap(self._ids())

    def to_padded(self, max_len, pad_value=0.0):
        """ragged -> ([B, max_len, ...], lengths); raises when a row is
        longer than ``max_len``."""
        v = self.values._data
        s = self.row_splits._data.to(v.device).long()
        B = self.nrows
        lens = s[1:] - s[:-1]
        if B and int(lens.max()) > max_len:
            raise ValueError(
                f"to_padded: a row has {int(lens.max())} tokens > "
                f"max_len {max_len} — raise max_len or slice rows upstream")
        ar = torch.arange(max_len, device=v.device)
        pos = s[:-1, None] + ar[None, :]
        valid = ar[None, :] < lens[:, None]
        gathered = v[pos.clamp(0, self.capacity - 1)]
        dense = torch.where(
            valid.reshape(valid.shape + (1,) * (v.dim() - 1)), gathered,
            torch.tensor(pad_value, dtype=v.dtype, device=v.device))
        return Tensor._wrap(dense), Tensor._wrap(
            lens.to(self.row_splits._data.dtype))

    def to_padded_nested(self, max_rows, max_len, pad_value=0.0):
        """Nested (lod_level >= 2) -> ([G, max_rows, max_len, ...],
        row_lengths [G, max_rows]) over the innermost outer level."""
        if not self.outer_lods:
            raise ValueError(
                "to_padded_nested: lod_level is 1 — use to_padded")
        dense, lens = self.to_padded(max_len, pad_value)
        d, ln = dense._data, lens._data
        so = self.outer_lods[-1]._data.to(d.device).long()
        B = self.nrows
        G = int(so.shape[0]) - 1
        grp_lens = so[1:] - so[:-1]
        if G and int(grp_lens.max()) > max_rows:
            raise ValueError(
                f"to_padded_nested: a group has {int(grp_lens.max())} "
                f"rows > max_rows {max_rows}")
        ar = torch.arange(max_rows, device=d.device)
        pos = so[:-1, None] + ar[None, :]
        valid = ar[None, :] < grp_lens[:, None]
        g = d[pos.clamp(0, B - 1)]
        mask = valid.reshape(valid.shape + (1,) * (g.dim() - 2))
        g = torch.where(mask, g, torch.tensor(pad_value, dtype=g.dtype,
                                              device=g.device))
        row_lens = torch.where(valid, ln[pos.clamp(0, B - 1)],
                               torch.zeros_like(ln[pos.clamp(0, B - 1)]))
        return Tensor._wrap(g), Tensor._wrap(row_lens)

    def rows(self):
        """Host-side list of per-row numpy arrays."""
        v = self.values.numpy()
        s = self.row_splits.numpy()
        return [v[s[i]:s[i + 1]] for i in range(len(s) - 1)]

    def nested_rows(self):
        """Host-side nested lists mirroring ``lod_level``."""
        out = self.rows()
        for s in reversed(self.outer_lods):
            off = s.numpy()
            out = [out[off[i]:off[i + 1]] for i in range(len(off) - 1)]
        return out


# ---------------------------------------------------------------------------
# segment-compute sequence ops (reference: operators/sequence_ops/*)

def _splits(rt, like):
    return rt.row_splits._data.to(like.device).long()


def _live(rt, like):
    """[capacity] bool: the slots holding data."""
    total = rt.row_splits._data[-1].to(like.device)
    return torch.arange(rt.capacity, device=like.device) < total


def sequence_pool(rt: RaggedTensor, pool_type: str, pad_value=0.0):
    """-> [B, ...] (reference: sequence_pool_op.h; SUM/MEAN/SQRT/MAX/MIN/
    LAST/FIRST).  Empty rows produce ``pad_value``."""
    v = rt.values._data
    ids = rt._ids().to(v.device).long()
    B = rt.nrows
    live = _live(rt, v)
    vm = v * _bcast(live, v).to(v.dtype)
    lens = rt.lengths()._data.to(device=v.device, dtype=v.dtype)
    ptype = pool_type.lower()
    ptype = {"average": "mean", "avg": "mean"}.get(ptype, ptype)
    if ptype in ("sum", "mean", "sqrt"):
        out = _segment_sum(vm, ids, B + 1)[:B]
        if ptype == "mean":
            out = out / _bcast(torch.clamp(lens, min=1), out)
        elif ptype == "sqrt":
            out = out / _bcast(torch.sqrt(torch.clamp(lens, min=1)), out)
    elif ptype in ("max", "min"):
        info = torch.finfo if v.is_floating_point() else torch.iinfo
        fill = info(v.dtype).min if ptype == "max" else info(v.dtype).max
        vr = torch.where(_bcast(ids < B, v), v,
                         torch.tensor(fill, dtype=v.dtype, device=v.device))
        out = _segment_reduce(vr, ids, B + 1,
                              "amax" if ptype == "max" else "amin")[:B]
    elif ptype in ("first", "last"):
        s = _splits(rt, v)
        idx = s[:-1] if ptype == "first" else torch.clamp(s[1:] - 1, min=0)
        out = v[idx.clamp(0, rt.capacity - 1)]
    else:
        raise ValueError(
            f"sequence_pool: unknown pool_type {pool_type!r} "
            "(sum/mean|average/sqrt/max/min/first/last)")
    empty = _bcast(rt.lengths()._data.to(v.device) == 0, out)
    out = torch.where(empty, torch.tensor(pad_value, dtype=out.dtype,
                                          device=out.device), out)
    if rt.outer_lods:
        # pooling consumes the bottom level; the result stays ragged over
        # the remaining levels
        return RaggedTensor(Tensor._wrap(out), rt.outer_lods[-1],
                            outer_lods=rt.outer_lods[:-1])
    return Tensor._wrap(out)


def sequence_softmax(rt: RaggedTensor):
    """Row-wise softmax over 1-D-per-step values (reference:
    sequence_softmax_op); trash slots give 0."""
    v = rt.values._data
    ids = rt._ids().to(v.device).long()
    B = rt.nrows
    live = ids < B
    neg = torch.finfo(v.dtype).min
    vm = torch.where(live, v, torch.tensor(neg, dtype=v.dtype,
                                           device=v.device))
    mx = _segment_reduce(vm, ids, B + 1, "amax")
    # mask inside the exp, so the trash slots' gradient stays finite
    ex = live.to(v.dtype) * torch.exp(
        torch.where(live, v - mx[ids], torch.zeros_like(v)))
    den = _segment_sum(ex, ids, B + 1)
    out = ex / torch.clamp(den[ids], min=1e-30)
    return RaggedTensor(Tensor._wrap(out), rt.row_splits,
                        outer_lods=rt.outer_lods)


def sequence_reverse(rt: RaggedTensor):
    """Reverse each row in place (reference: sequence_reverse_op)."""
    v = rt.values._data
    ids = rt._ids().to(v.device).long()
    B = rt.nrows
    s = _splits(rt, v)
    pos = torch.arange(rt.capacity, device=v.device)
    ids_c = ids.clamp(0, B - 1)
    src = s[ids_c] + (s[ids_c + 1] - 1) - pos
    src = torch.where(ids < B, src, pos)
    out = v[src.clamp(0, rt.capacity - 1)]
    return RaggedTensor(Tensor._wrap(out), rt.row_splits,
                        outer_lods=rt.outer_lods)


def _level_splits(rt: RaggedTensor, level):
    """Offset vector of a LoD level (0 = outermost, -1 = bottom)."""
    all_lods = rt.outer_lods + (rt.row_splits,)
    return all_lods[level]._data


def sequence_expand(rt: RaggedTensor, ref: RaggedTensor, ref_level=-1,
                    capacity=None, max_out_rows=None, one_step=None):
    """Reference ``sequence_expand_op.cc``: repeat x's row i
    ``ref_len[i]`` times, ``ref_len`` the lengths of ref's LoD level
    ``ref_level``.

    * every x row one step and ``ref_level`` the bottom level: x's step i
      is broadcast over ref's row i, and the output has ref's LoD;
    * otherwise each x row is copied ``ref_len[i]`` times, and the output
      gains an outer level grouping the copies (lod_level 2).
      ``capacity`` and ``max_out_rows`` bound the output (the exact
      totals by default; smaller bounds raise).
    """
    v = rt.values._data
    rl_splits = _level_splits(ref, ref_level).to(v.device).long()
    rl = rl_splits[1:] - rl_splits[:-1]
    N = int(rl.shape[0])
    if rt.nrows != N:
        raise ValueError(
            f"sequence_expand: x has {rt.nrows} rows but ref level "
            f"{ref_level} has {N} entries")
    concrete_one = bool((rt.lengths()._data == 1).all())
    if one_step and not concrete_one:
        raise ValueError(
            "sequence_expand: one_step=True but x has multi-step rows")
    sx = _splits(rt, v)
    if concrete_one and ref_level in (-1, ref.lod_level - 1):
        ids = ref._ids().to(v.device).long()
        B = ref.nrows
        x_first = v[sx[:-1].clamp(0, rt.capacity - 1)]
        out = x_first[ids.clamp(0, B - 1)]
        out = out * _bcast(ids < B, out).to(out.dtype)
        return RaggedTensor(Tensor._wrap(out), ref.row_splits,
                            outer_lods=ref.outer_lods)

    r_cum = torch.cumsum(rl, 0)
    r_total = int(r_cum[-1]) if N else 0
    if max_out_rows is None:
        max_out_rows = r_total
    elif r_total > max_out_rows:
        raise ValueError(
            f"sequence_expand: max_out_rows {max_out_rows} < actual "
            f"repeated row count {r_total} — the result would silently "
            "drop rows")
    r = torch.arange(max_out_rows, device=v.device)
    grp = torch.searchsorted(r_cum, r, right=True)
    grp_c = grp.clamp(0, N - 1)
    out_len = torch.where(r < r_total, sx[grp_c + 1] - sx[grp_c],
                          torch.zeros_like(grp_c))
    out_splits = torch.cat([torch.zeros(1, dtype=torch.long,
                                        device=v.device),
                            torch.cumsum(out_len, 0)])
    total_steps = int(out_splits[-1])
    if capacity is None:
        capacity = total_steps
    elif total_steps > capacity:
        raise ValueError(
            f"sequence_expand: capacity {capacity} < actual output step "
            f"count {total_steps} — the scatter would silently drop data "
            "(pick the bucket like io/bucketing.py)")
    p = torch.arange(capacity, device=v.device)
    row_of_p = torch.searchsorted(out_splits, p, right=True) - 1
    row_c = row_of_p.clamp(0, max(max_out_rows - 1, 0))
    local = p - out_splits[row_c]
    src = sx[grp[row_c].clamp(0, N - 1)] + local
    vals = v[src.clamp(0, rt.capacity - 1)]
    vals = vals * _bcast(p < total_steps, vals).to(vals.dtype)
    outer = torch.cat([torch.zeros(1, dtype=torch.long, device=v.device),
                       r_cum])
    return RaggedTensor(Tensor._wrap(vals),
                        Tensor._wrap(out_splits.to(torch.int32)),
                        outer_lods=(Tensor._wrap(outer.to(torch.int32)),))



def sequence_concat(a: RaggedTensor, b: RaggedTensor):
    """Row-wise concat: out row i = a row i ++ b row i (reference:
    sequence_concat_op).  Nested inputs must agree on their outer levels,
    which the output carries unchanged."""
    if a.nrows != b.nrows:
        raise ValueError("sequence_concat: row counts differ")
    if len(a.outer_lods) != len(b.outer_lods):
        raise ValueError("sequence_concat: lod_level mismatch")
    for sa_, sb_ in zip(a.outer_lods, b.outer_lods):
        da, db = sa_._data, sb_._data
        if da.shape != db.shape or not bool((da == db.to(da.device)).all()):
            raise ValueError(
                "sequence_concat: outer LoD levels differ between inputs")
    va, vb = a.values._data, b.values._data
    sa, sb = _splits(a, va), _splits(b, va)
    la, lb = sa[1:] - sa[:-1], sb[1:] - sb[:-1]
    splits = torch.cat([torch.zeros(1, dtype=torch.long, device=va.device),
                        torch.cumsum(la + lb, 0)])
    cap = a.capacity + b.capacity
    B = a.nrows

    def scatter(src_vals, src_splits, dst, base_off):
        n = src_vals.shape[0]
        pos = torch.arange(n, device=va.device)
        ids = torch.searchsorted(src_splits, pos, right=True) - 1
        live = pos < src_splits[-1]
        ids_c = ids.clamp(0, B - 1)
        local = pos - src_splits[ids_c]
        slot = splits[ids_c] + base_off[ids_c] + local
        slot = torch.where(live, slot, torch.full_like(slot, cap))
        return dst.index_put((slot,), src_vals)

    tail = tuple(va.shape[1:])
    dst = torch.zeros((cap + 1,) + tail, dtype=va.dtype, device=va.device)
    dst = scatter(va, sa, dst, torch.zeros_like(la))
    dst = scatter(vb.to(va.device), sb, dst, la)
    return RaggedTensor(Tensor._wrap(dst[:cap]),
                        Tensor._wrap(splits.to(torch.int32)),
                        outer_lods=a.outer_lods)
