"""Serving layouts and tensor-parallel layers — counterpart of
``paddle_tpu/distributed/sharding.py`` (``SERVING_SPECS``,
``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``).

A spec is a tuple with one entry per leading dimension: ``"mp"`` or
``"dp"`` splits that dimension into equal contiguous parts over the
mesh axis, ``None`` keeps it whole; an axis the spec does not name is
replicated over.  ``shard(tensor, spec, mesh)`` returns the per-rank
list in the mesh's rank order, ``unshard`` puts it back together.

The layers hold their FULL logical weight in the JAX package's layout
(``[in, out]`` for the linears, ``[vocab, hidden]`` for the embedding),
so the weight bridge (``convert.py``) is a copy, and outside a mesh each
is an ordinary layer.  Each weight carries its spec as
``param.partition_spec``, which ``serving/sharded.py`` reads to slice
the weights per rank.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.functional.common import linear

# The serving engine's layouts on the (mp, dp) mesh, one table for the
# engine, the sharded ragged-attention wrapper and the tests:
# * kv — [NB, bs, H, hd] pools: block rows by dp shard (each shard a
#   contiguous range, BlockPool(shards=dp)), heads (index 2) over mp;
# * kv_scale — [NB, H] scale pools of int8 pools: rows over dp, heads
#   over mp;
# * state — [B]-leading cursor and sampling vectors: slot rows over dp;
# * table — [B, blocks_per_slot] block tables: slot rows over dp, the
#   entries GLOBAL pool rows (the kernel wrapper localizes them);
# * replicated — everything else.
SERVING_SPECS = {
    "kv": ("dp", None, "mp", None),
    "kv_scale": ("dp", "mp"),
    "state": ("dp",),
    "table": ("dp", None),
    "replicated": (),
}


def as_spec(kind_or_spec):
    """A ``SERVING_SPECS`` kind or a spec tuple, as a spec tuple."""
    if isinstance(kind_or_spec, str):
        try:
            return SERVING_SPECS[kind_or_spec]
        except KeyError:
            raise ValueError(
                f"unknown serving array kind {kind_or_spec!r}; expected one "
                f"of {sorted(SERVING_SPECS)}") from None
    spec = tuple(kind_or_spec)
    bad = [a for a in spec if a not in (None, "mp", "dp")]
    if bad or len(set(a for a in spec if a)) != len([a for a in spec if a]):
        raise ValueError(f"spec {spec}: entries must be 'mp', 'dp' or None, "
                         "each axis at most once")
    return spec


def _split(spec, shape, mesh, who):
    """``[(dim, axis size, chunk)]`` for every split dimension."""
    if len(spec) > len(shape):
        raise ValueError(f"{who}: spec {spec} has more entries than the "
                         f"tensor's {len(shape)} dimensions")
    out = []
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n = mesh.mp if ax == "mp" else mesh.dp
        if shape[dim] % n:
            raise ValueError(
                f"{who}: dimension {dim} ({shape[dim]}) does not divide "
                f"into {n} equal {ax} shards")
        out.append((dim, ax, shape[dim] // n))
    return out


def shard(tensor, kind_or_spec, mesh):
    """The per-rank shards of ``tensor`` (rank order of ``mesh``), each
    contiguous on its rank's device.  Ranks that hold the same slice on
    the same device share one tensor (a replicated weight is placed once
    per distinct device, not once per rank), and a shard needing no copy
    is the input itself or a view of it."""
    spec = as_spec(kind_or_spec)
    splits = _split(spec, tensor.shape, mesh, "shard")
    placed = {}
    out = []
    for m, d in mesh.ranks():
        idx = {"mp": m, "dp": d}
        key = (tuple(idx[ax] for _, ax, _ in splits), mesh.device(m, d))
        if key not in placed:
            part = tensor
            for dim, ax, c in splits:
                part = part.narrow(dim, idx[ax] * c, c)
            placed[key] = part.contiguous().to(mesh.device(m, d))
        out.append(placed[key])
    return out


def unshard(parts, kind_or_spec, mesh):
    """Inverse of ``shard``: the logical tensor, on the first rank's
    shard's device."""
    spec = as_spec(kind_or_spec)
    if len(parts) != mesh.size:
        raise ValueError(f"unshard: {len(parts)} parts for a mesh of "
                         f"{mesh.size} ranks")
    dev = parts[0].device
    dims = {ax: spec.index(ax) for ax in ("mp", "dp") if ax in spec}
    rows = []
    for d in range(mesh.dp if "dp" in dims else 1):
        cols = [parts[mesh.rank(m, d)].to(dev)
                for m in range(mesh.mp if "mp" in dims else 1)]
        rows.append(torch.cat(cols, dims["mp"]) if "mp" in dims
                    else cols[0])
    return torch.cat(rows, dims["dp"]) if "dp" in dims else rows[0]


def _normal(shape):
    w = nn.Parameter(torch.empty(shape))
    nn.init.normal_(w, 0.0, 0.02)
    return w


def _zeros(shape):
    return nn.Parameter(torch.zeros(shape))


class ColumnParallelLinear(nn.Module):
    """Megatron column-parallel linear: weight ``[in, out]`` split on
    ``out`` over mp, bias split with it; on a mesh each rank computes its
    columns of the output."""

    def __init__(self, in_features, out_features, has_bias=True):
        super().__init__()
        self.weight = _normal((in_features, out_features))
        self.weight.partition_spec = (None, "mp")
        if has_bias:
            self.bias = _zeros((out_features,))
            self.bias.partition_spec = ("mp",)
        else:
            self.bias = None

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """Row-parallel linear: weight ``[in, out]`` split on ``in`` over mp,
    the bias replicated; on a mesh each rank's partial product is summed
    over mp (``collective.all_reduce_sum``) before the bias."""

    def __init__(self, in_features, out_features):
        super().__init__()
        self.weight = _normal((in_features, out_features))
        self.weight.partition_spec = ("mp", None)
        self.bias = _zeros((out_features,))
        self.bias.partition_spec = ()

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``[vocab, hidden]`` split on vocab over mp: on a
    mesh a rank returns zeros for ids outside its rows, and the sum over
    mp gives every id its row."""

    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim))
        self.weight.partition_spec = ("mp", None)

    def forward(self, x):
        return F.embedding(x, self.weight)
