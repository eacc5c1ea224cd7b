"""Shape, indexing and rearrangement ops — counterpart of
``paddle_tpu/ops/manipulation.py``.

Where Paddle's semantics differ from torch's function of the same name,
the port keeps Paddle's (the JAX package's):

* ``split(x, n)`` with an int makes ``n`` pieces (``n`` must divide the
  axis); a list of sizes may hold one -1.  torch's int is a piece size.
* ``gather(x, index, axis)`` is ``jnp.take`` along ``axis`` (an
  ``index_select``; an ``[N, 1]`` index is squeezed), not
  ``torch.gather``.
* ``scatter(..., overwrite=False)`` zeroes the indexed rows, then adds.
* ``max`` / ``min`` give values only, ``argmax`` int64, ``topk(axis=None)``
  the last axis; ``kthvalue`` breaks ties by a stable sort, ``mode``
  takes the smallest most frequent value and its last index, and
  ``unique`` / ``unique_consecutive`` give their extra outputs in numpy's
  order — as the JAX package computes them.
* Out-of-range indices raise (torch), where ``jnp.take`` fills.
"""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.tensor import Tensor
from ..core.dispatch import primitive, ensure_tensor
from ..core import dtype as dtypes


def _int(v):
    return int(v.item()) if isinstance(v, Tensor) else int(v)


@primitive(name="cast")
def _cast(x, dtype=None):
    return x.to(dtype)


def cast(x, dtype):
    x = ensure_tensor(x)
    tdt = dtypes.to_torch(dtype)
    if x._data.dtype == tdt:
        return x
    return _cast(x, dtype=tdt)


@primitive(name="reshape")
def _reshape(x, shape=None):
    return torch.reshape(x, shape)


def reshape(x, shape, name=None):
    x = ensure_tensor(x)
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    return _reshape(x, shape=tuple(_int(s) for s in shape))


def reshape_(x, shape, name=None):
    """In place: ``x`` rebinds to the reshaped tensor (the graph keeps its
    history)."""
    x._data = reshape(x, shape)._data
    return x


@primitive(name="transpose")
def _transpose(x, perm=None):
    if perm is None:
        perm = tuple(reversed(range(x.dim())))
    return x.permute(*perm)


def transpose(x, perm=None, name=None):
    return _transpose(ensure_tensor(x),
                      perm=tuple(perm) if perm is not None else None)


def t(x, name=None):
    x = ensure_tensor(x)
    if x.ndim < 2:
        return x
    return transpose(x, list(range(x.ndim - 2)) + [x.ndim - 1, x.ndim - 2])


def moveaxis(x, source, destination, name=None):
    return primitive(name="moveaxis")(
        lambda a: torch.movedim(a, source, destination))(ensure_tensor(x))


def swapaxes(x, axis1, axis2, name=None):
    x = ensure_tensor(x)
    perm = list(range(x.ndim))
    perm[axis1], perm[axis2] = perm[axis2], perm[axis1]
    return transpose(x, perm)


@primitive(name="squeeze")
def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, axis)


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)
    if isinstance(axis, (list, tuple)):
        axis = tuple(a for a in axis if x.shape[a] == 1)
        if not axis:
            axis = None
    elif isinstance(axis, int) and x.shape[axis] != 1:
        return x
    return _squeeze(x, axis=axis)


@primitive(name="unsqueeze")
def _unsqueeze(x, axis=None):
    if isinstance(axis, tuple):
        nd = x.dim() + len(axis)
        for a in sorted(d % nd for d in axis):
            x = x.unsqueeze(a)
        return x
    return x.unsqueeze(axis)


def unsqueeze(x, axis, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _unsqueeze(ensure_tensor(x), axis=axis)


@primitive(name="flatten")
def _flatten(x, start_axis=0, stop_axis=-1):
    return torch.flatten(x, start_axis, stop_axis)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    if x.ndim == 0:
        return reshape(x, [1])
    return _flatten(x, start_axis=start_axis, stop_axis=stop_axis)


def concat(x, axis=0, name=None):
    tensors = [ensure_tensor(t) for t in x]
    axis = _int(axis)
    return primitive(name="concat")(
        lambda *arrs: torch.cat(arrs, dim=axis))(*tensors)


def stack(x, axis=0, name=None):
    tensors = [ensure_tensor(t) for t in x]
    return primitive(name="stack")(
        lambda *arrs: torch.stack(arrs, dim=axis))(*tensors)


def split(x, num_or_sections, axis=0, name=None):
    x = ensure_tensor(x)
    axis = _int(axis)
    dim = x.shape[axis]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dim {dim} on axis {axis} is not divisible by "
                f"num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        if builtins.any(s < 0 for s in sizes):
            rest = dim - builtins.sum(s for s in sizes if s >= 0)
            sizes = [rest if s < 0 else s for s in sizes]
    out = primitive(name="split")(
        lambda a: tuple(torch.split(a, sizes, dim=axis)))(x)
    return list(out) if isinstance(out, tuple) else [out]


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(x, axis=0, name=None):
    x = ensure_tensor(x)
    outs = split(x, x.shape[axis], axis)
    return [squeeze(o, axis) for o in outs]


@primitive(name="tile")
def _tile(x, repeat_times=None):
    return torch.tile(x, repeat_times)


def tile(x, repeat_times, name=None):
    if isinstance(repeat_times, Tensor):
        repeat_times = repeat_times.tolist()
    return _tile(ensure_tensor(x),
                 repeat_times=tuple(_int(r) for r in repeat_times))


@primitive(name="expand_v2")
def _expand(x, shape=None):
    return torch.broadcast_to(x, shape)


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    if isinstance(shape, Tensor):
        shape = shape.tolist()
    shape = [_int(s) for s in shape]
    # -1 means keep the original extent
    offset = len(shape) - x.ndim
    for i, s in enumerate(shape):
        if s == -1:
            shape[i] = x.shape[i - offset]
    return _expand(x, shape=tuple(shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return expand(x, ensure_tensor(y).shape)


def broadcast_tensors(inputs, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    shape = torch.broadcast_shapes(*[tuple(t.shape) for t in ts])
    return [expand(t, list(shape)) for t in ts]


@primitive(name="flip")
def _flip(x, axis=None):
    if axis is None:
        axis = tuple(range(x.dim()))
    return torch.flip(x, axis if isinstance(axis, tuple) else (axis,))


def flip(x, axis, name=None):
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _flip(ensure_tensor(x), axis=axis)


@primitive(name="roll")
def _roll(x, shifts=None, axis=None):
    if axis is None:
        return torch.roll(x, shifts)
    return torch.roll(x, shifts, axis)


def roll(x, shifts, axis=None, name=None):
    if isinstance(shifts, (list, tuple)):
        shifts = tuple(shifts)
    if isinstance(axis, (list, tuple)):
        axis = tuple(axis)
    return _roll(ensure_tensor(x), shifts=shifts, axis=axis)


@primitive(name="rot90")
def _rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, axes)


def rot90(x, k=1, axes=(0, 1), name=None):
    return _rot90(ensure_tensor(x), k=k, axes=tuple(axes))


# ---- gather / scatter ----------------------------------------------------
def _take(x, index, axis):
    """``jnp.take(x, index, axis)``: the result's axis replaced by the
    index's shape."""
    axis = axis % x.dim()
    flat = torch.index_select(x, axis, index.reshape(-1).long())
    return flat.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                        + tuple(x.shape[axis + 1:]))


@primitive(name="gather", nondiff=(1,))
def _gather(x, index, axis=0):
    return _take(x, index, axis)


def gather(x, index, axis=0, name=None):
    axis = _int(axis)
    idx = ensure_tensor(index)._data
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    return _gather(ensure_tensor(x), Tensor._wrap(idx), axis=axis)


def _nd_index(index):
    return tuple(index.long().movedim(-1, 0))


@primitive(name="gather_nd", nondiff=(1,))
def _gather_nd(x, index):
    return x[_nd_index(index)]


def gather_nd(x, index, name=None):
    return _gather_nd(ensure_tensor(x), ensure_tensor(index))


@primitive(name="scatter", nondiff=(1,))
def _scatter(x, index, updates, overwrite=True):
    if index.dim() == 2 and index.shape[1] == 1:
        index = index[:, 0]
    index = (index.long(),)
    updates = updates.to(x.dtype)
    if overwrite:
        return x.index_put(index, updates)
    # paddle semantics: zero the rows then accumulate
    zeroed = x.index_put(index, torch.zeros_like(updates))
    return zeroed.index_put(index, updates, accumulate=True)


def scatter(x, index, updates, overwrite=True, name=None):
    return _scatter(ensure_tensor(x), ensure_tensor(index),
                    ensure_tensor(updates), overwrite=overwrite)


@primitive(name="scatter_nd_add", nondiff=(1,))
def _scatter_nd_add(x, index, updates):
    return x.index_put(_nd_index(index), updates.to(x.dtype),
                       accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return _scatter_nd_add(ensure_tensor(x), ensure_tensor(index),
                           ensure_tensor(updates))


def scatter_nd(index, updates, shape, name=None):
    updates = ensure_tensor(updates)
    u = updates._data
    zeros = Tensor._wrap(torch.zeros(tuple(shape), dtype=u.dtype,
                                     device=u.device))
    return scatter_nd_add(zeros, index, updates)


@primitive(name="index_select", nondiff=(1,))
def _index_select(x, index, axis=0):
    return _take(x, index, axis)


def index_select(x, index, axis=0, name=None):
    return _index_select(ensure_tensor(x), ensure_tensor(index), axis=axis)


@primitive(name="index_sample", nondiff=(1,))
def _index_sample(x, index):
    return torch.gather(x, 1, index.long())


def index_sample(x, index, name=None):
    return _index_sample(ensure_tensor(x), ensure_tensor(index))


@primitive(name="take_along_axis", nondiff=(1,))
def _take_along_axis(x, index, axis):
    return torch.take_along_dim(x, index.long(), dim=axis)


def take_along_axis(arr, indices, axis, name=None):
    return _take_along_axis(ensure_tensor(arr), ensure_tensor(indices),
                            axis=axis)


@primitive(name="put_along_axis", nondiff=(1,))
def _put_along_axis(x, index, value, axis, reduce="assign"):
    index = index.long()
    value = torch.broadcast_to(value.to(x.dtype), index.shape)
    if reduce == "add":
        return x.scatter_add(axis, index, value)
    if reduce in ("mul", "multiply"):
        return x.scatter_reduce(axis, index, value, "prod")
    return x.scatter(axis, index, value)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    arr = ensure_tensor(arr)
    return _put_along_axis(arr, ensure_tensor(indices),
                           ensure_tensor(values, ref=arr), axis=axis,
                           reduce=reduce)


@primitive(name="where")
def _where(cond, x, y):
    return torch.where(cond.bool(), x, y)


def where(condition, x=None, y=None, name=None):
    condition = ensure_tensor(condition)
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return _where(condition, ensure_tensor(x, ref=y),
                  ensure_tensor(y, ref=x))


def masked_select(x, mask, name=None):
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    return primitive(name="masked_select", nondiff=(1,))(
        lambda a, m: torch.masked_select(a, m.bool()))(x, mask)


def masked_fill(x, mask, value, name=None):
    x, mask = ensure_tensor(x), ensure_tensor(mask)
    v = value._data if isinstance(value, Tensor) else value
    return primitive(name="masked_fill", nondiff=(1,))(
        lambda a, m: torch.where(
            m.bool(), torch.as_tensor(v, dtype=a.dtype, device=a.device),
            a))(x, mask)


def nonzero(x, as_tuple=False, name=None):
    x = ensure_tensor(x)
    idx = torch.nonzero(x._data)
    if as_tuple:
        return tuple(Tensor._wrap(idx[:, i:i + 1])
                     for i in range(idx.shape[1]))
    return Tensor._wrap(idx)


# ---- search / sort -------------------------------------------------------
def _arg(fn):
    def run(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x.reshape(-1), 0)
            return out.reshape((1,) * x.dim()) if keepdims else out
        return fn(x, int(axis), keepdims)
    return run


@primitive(name="argmax")
def _argmax(x, axis=None, keepdims=False):
    return _arg(lambda a, d, k=False: torch.argmax(a, d, keepdim=k))(
        x, axis, keepdims)


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return cast(_argmax(ensure_tensor(x), axis=axis, keepdims=keepdim),
                dtype)


@primitive(name="argmin")
def _argmin(x, axis=None, keepdims=False):
    return _arg(lambda a, d, k=False: torch.argmin(a, d, keepdim=k))(
        x, axis, keepdims)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return cast(_argmin(ensure_tensor(x), axis=axis, keepdims=keepdim),
                dtype)


@primitive(name="argsort")
def _argsort(x, axis=-1, descending=False):
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def argsort(x, axis=-1, descending=False, name=None):
    return cast(_argsort(ensure_tensor(x), axis=axis, descending=descending),
                "int64")


@primitive(name="sort")
def _sort(x, axis=-1, descending=False):
    return torch.sort(x, dim=axis, descending=descending, stable=True)[0]


def sort(x, axis=-1, descending=False, name=None):
    return _sort(ensure_tensor(x), axis=axis, descending=descending)


@primitive(name="top_k_v2", has_aux=True)
def _topk(x, k=1, largest=True, axis=-1):
    vals, idx = torch.topk(x, k, dim=axis, largest=largest, sorted=True)
    return vals, idx.to(torch.int64)


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    x = ensure_tensor(x)
    return _topk(x, k=_int(k), largest=largest,
                 axis=-1 if axis is None else int(axis))


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    x = ensure_tensor(x)
    sorted_t = sort(x, axis=axis)
    idx_t = argsort(x, axis=axis)
    sel = [slice(None)] * x.ndim
    sel[axis] = int(k) - 1
    v = sorted_t[tuple(sel)]
    i = idx_t[tuple(sel)]
    if keepdim:
        v, i = unsqueeze(v, axis), unsqueeze(i, axis)
    return v, i


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its last occurrence, computed on the host as the JAX
    package does."""
    x = ensure_tensor(x)
    arr = x.numpy()
    moved = np.moveaxis(arr, axis, -1)
    orig = moved.reshape(-1, moved.shape[-1])
    vals = np.empty(orig.shape[0], dtype=arr.dtype)
    idxs = np.empty(orig.shape[0], dtype=np.int64)
    for i, row in enumerate(orig):
        uniq, counts = np.unique(row, return_counts=True)
        best = uniq[np.argmax(counts)]
        vals[i] = best
        idxs[i] = np.where(row == best)[0][-1]
    dev = x._data.device
    v = Tensor._wrap(torch.from_numpy(vals.reshape(moved.shape[:-1])).to(
        device=dev, dtype=x._data.dtype))
    i_t = Tensor._wrap(torch.from_numpy(idxs.reshape(moved.shape[:-1])).to(
        dev))
    if keepdim:
        v, i_t = unsqueeze(v, axis), unsqueeze(i_t, axis)
    return v, i_t


def _host(x, arr, dtype=None):
    """A numpy result back on the device of the handle ``x``."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    return Tensor._wrap(t.to(device=x._data.device, dtype=dtype))


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    res = np.unique(x.numpy(), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if not isinstance(res, tuple):
        return _host(x, res, x._data.dtype)
    return tuple([_host(x, res[0], x._data.dtype)]
                 + [_host(x, e.astype(np.int64)) for e in res[1:]])


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    arr = x.numpy()
    if axis is None:
        arr = arr.reshape(-1)
        n = arr.size
        change = np.concatenate([[True], arr[1:] != arr[:-1]]) \
            if n else np.zeros((0,), bool)
        out = arr[change]
    else:
        moved = np.moveaxis(arr, axis, 0)
        n = moved.shape[0]
        if n:
            flat = moved.reshape(n, -1)
            change = np.concatenate(
                [[True], np.any(flat[1:] != flat[:-1], axis=1)])
        else:
            change = np.zeros((0,), bool)
        out = np.moveaxis(moved[change], 0, axis)
    outs = [_host(x, out, x._data.dtype)]
    if return_inverse:
        outs.append(_host(x, np.cumsum(change).astype(np.int64) - 1))
    if return_counts:
        idx = np.flatnonzero(change)
        counts = np.diff(np.concatenate([idx, [n]]))
        outs.append(_host(x, counts.astype(np.int64)))
    return outs[0] if len(outs) == 1 else tuple(outs)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    ss, v = ensure_tensor(sorted_sequence), ensure_tensor(values)
    a = ss._data
    out = torch.searchsorted(a, v._data.to(a.dtype), right=right,
                             out_int32=out_int32)
    return Tensor._wrap(out)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


# ---- misc ---------------------------------------------------------------
def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """reference: operators/shard_index_op.cc (used by parallel
    embedding)."""
    a = ensure_tensor(input)._data
    shard_size = (index_num + nshards - 1) // nshards
    in_shard = torch.div(a, shard_size, rounding_mode="floor") == shard_id
    return Tensor._wrap(torch.where(
        in_shard, a % shard_size, torch.full_like(a, ignore_value)))


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    if isinstance(repeats, Tensor):
        repeats = repeats._data.to(x._data.device)
    return primitive(name="repeat_interleave")(
        lambda a: torch.repeat_interleave(a, repeats, dim=axis))(x)


def as_real(x, name=None):
    return primitive(name="as_real")(torch.view_as_real)(ensure_tensor(x))


def as_complex(x, name=None):
    return primitive(name="as_complex")(
        lambda a: torch.complex(a[..., 0], a[..., 1]))(ensure_tensor(x))


def tensordot(x, y, axes=2, name=None):
    dims = axes if isinstance(axes, int) else tuple(
        list(a) if isinstance(a, (list, tuple)) else [a] for a in axes)
    return primitive(name="tensordot")(
        lambda a, b: torch.tensordot(a, b, dims=dims))(
        ensure_tensor(x), ensure_tensor(y))


def einsum(equation, *operands):
    tensors = [ensure_tensor(t) for t in operands]
    return primitive(name="einsum")(
        lambda *arrs: torch.einsum(equation, *arrs))(*tensors)


def one_hot(x, num_classes, name=None):
    a = ensure_tensor(x)._data
    out = torch.nn.functional.one_hot(a.long(), int(num_classes))
    return Tensor._wrap(out.to(dtypes.to_torch(dtypes.get_default_dtype())))


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    pre = ensure_tensor(prepend, ref=x)._data if prepend is not None \
        else None
    app = ensure_tensor(append, ref=x)._data if append is not None else None
    return primitive(name="diff")(
        lambda a: torch.diff(a, n=n, dim=axis, prepend=pre, append=app))(x)


__all__ = [n for n, v in list(globals().items())
           if not n.startswith("_") and callable(v)
           and getattr(v, "__module__", None) == __name__]
