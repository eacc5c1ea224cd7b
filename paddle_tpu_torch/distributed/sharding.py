"""Sharding specs, serving layouts and tensor-parallel layers —
counterpart of ``paddle_tpu/distributed/sharding.py``
(``SERVING_SPECS``, ``shard_params_specs``, ``shard_tensor``, ``split``,
``ColumnParallelLinear``, ``RowParallelLinear``,
``VocabParallelEmbedding``).

A spec is a tuple with one entry per leading dimension: a mesh axis
(one of the six ``AXES``; the serving mesh has ``mp`` and ``dp``) or a
tuple of axes splits that dimension into equal contiguous parts over
them, ``None`` keeps it whole; an axis the spec does not name is
replicated over.  ``shard(tensor, spec, mesh)`` returns the per-rank
list in the mesh's rank order, ``unshard`` puts it back together, and
``piece_slices`` names one rank's piece.

The layers are built with their FULL logical weight in the JAX
package's layout (``[in, out]`` for the linears, ``[vocab, hidden]`` for
the embedding), so the weight bridge (``convert.py``) is a copy, and
outside a mesh each is an ordinary layer.  Each weight carries its spec
as ``param.partition_spec``, which ``serving/sharded.py`` and the train
step read to slice the weights per rank.  Run as a rank of a mesh
(``collective.run_ranks``, with the rank's shards bound in), a layer
computes its shard's part and meets the other mp ranks through the
group collectives: the Megatron split of the JAX package's GSPMD
program, whose math it keeps.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from ..nn.functional.common import linear
from . import collective
from .mesh import AXES
from ..nn.layer.base import torch_named_parameters

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


def _axes_of(entry):
    """A spec entry as a tuple of mesh axes (``None`` -> ``()``)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def as_spec(kind_or_spec):
    """A ``SERVING_SPECS`` kind or a spec tuple, as a spec tuple.  An
    entry is None, one of the six mesh ``AXES`` or a tuple of them (that
    dimension split over their product, row-major); each axis at most
    once."""
    if isinstance(kind_or_spec, str):
        try:
            return SERVING_SPECS[kind_or_spec]
        except KeyError:
            raise ValueError(
                f"unknown serving array kind {kind_or_spec!r}; expected one "
                f"of {sorted(SERVING_SPECS)}") from None
    spec = tuple(tuple(e) if isinstance(e, list) else e
                 for e in kind_or_spec)
    named = [a for e in spec for a in _axes_of(e)]
    if any(a not in AXES for a in named) or len(set(named)) != len(named):
        raise ValueError(f"spec {spec}: entries must be None, mesh axes "
                         f"{AXES} or tuples of them, each axis at most once")
    return spec


def _split(spec, shape, mesh, who):
    """``[(dim, axes, chunk)]`` for every split dimension."""
    if len(spec) > len(shape):
        raise ValueError(f"{who}: spec {spec} has more entries than the "
                         f"tensor's {len(shape)} dimensions")
    out = []
    for dim, entry in enumerate(spec):
        axes = _axes_of(entry)
        if not axes:
            continue
        n = math.prod(mesh.axis_size(a) for a in axes)
        if shape[dim] % n:
            raise ValueError(
                f"{who}: dimension {dim} ({shape[dim]}) does not divide "
                f"into {n} equal {'x'.join(axes)} shards")
        out.append((dim, axes, shape[dim] // n))
    return out


def _chunk_index(coords, axes, mesh):
    """Row-major index of a rank's chunk over ``axes``."""
    i = 0
    for a in axes:
        i = i * mesh.axis_size(a) + coords.get(a, 0)
    return i


def piece_slices(spec, shape, mesh, r):
    """``[(dim, start, length)]`` of rank ``r``'s piece of a tensor of
    ``shape`` under ``spec``."""
    coords = mesh.coords(r)
    return [(dim, _chunk_index(coords, axes, mesh) * c, c)
            for dim, axes, c in _split(as_spec(spec), shape, mesh, "shard")]


def shard(tensor, kind_or_spec, mesh):
    """The per-rank shards of ``tensor`` (rank order of ``mesh``), each
    contiguous on its rank's device.  Ranks that hold the same slice on
    the same device share one tensor (a replicated weight is placed once
    per distinct device, not once per rank), and a shard needing no copy
    is the input itself or a view of it."""
    spec = as_spec(kind_or_spec)
    splits = _split(spec, tensor.shape, mesh, "shard")
    devices = mesh.flat_devices
    placed = {}
    out = []
    for r in range(mesh.size):
        coords = mesh.coords(r)
        idx = tuple(_chunk_index(coords, axes, mesh) for _, axes, _ in splits)
        key = (idx, devices[r])
        if key not in placed:
            part = tensor
            for (dim, _, c), i in zip(splits, idx):
                part = part.narrow(dim, i * c, c)
            placed[key] = part.contiguous().to(devices[r])
        out.append(placed[key])
    return out


def unshard(parts, kind_or_spec, mesh, shape=None):
    """Inverse of ``shard``: the logical tensor, on the first rank's
    shard's device."""
    spec = as_spec(kind_or_spec)
    if len(parts) != mesh.size:
        raise ValueError(f"unshard: {len(parts)} parts for a mesh of "
                         f"{mesh.size} ranks")
    dev = parts[0].device
    full_shape = list(parts[0].shape)
    for dim, entry in enumerate(spec):
        full_shape[dim] *= math.prod(mesh.axis_size(a)
                                     for a in _axes_of(entry))
    if shape is not None:
        full_shape = list(shape)
    out = torch.empty(full_shape, dtype=parts[0].dtype, device=dev)
    done = set()
    for r in range(mesh.size):
        sl = piece_slices(spec, full_shape, mesh, r)
        key = tuple(s for _, s, _ in sl)
        if key in done:
            continue
        done.add(key)
        view = out
        for dim, start, c in sl:
            view = view.narrow(dim, start, c)
        view.copy_(parts[r].to(dev))
    return out


def _flipped_linear_weights(layer):
    """Names of torch ``nn.Linear`` weights (``[out, in]`` here, ``[in,
    out]`` in the JAX package)."""
    return {f"{n}.weight" if n else "weight"
            for n, m in layer.named_modules() if isinstance(m, nn.Linear)}


def _first_divisible_dim(shape, world):
    for i, s in enumerate(shape):
        if s % world == 0 and s >= world:
            return i
    return None


def shard_params_specs(layer, stage=2, axis="sharding", min_size=1024,
                       mesh=None):
    """FSDP parameter specs (``paddle_tpu``'s ``shard_params_specs``):
    stages 1/2 replicate every parameter (``()``: the optimizer state
    shards instead, in the train step); stage 3 splits a parameter of at
    least ``min_size`` elements on its first dimension that divides by
    the ``axis`` size.  An explicit ``partition_spec`` (the TP layers')
    wins.  The dimension is chosen in the JAX package's layout — a torch
    ``nn.Linear`` weight's ``[in, out]`` — and the spec given in this
    parameter's own, so both packages split the same elements."""
    from . import mesh as mesh_mod
    mesh = mesh if mesh is not None else mesh_mod.get_mesh()
    world = 1 if mesh is None else mesh.axis_size(axis)
    flipped = _flipped_linear_weights(layer)
    specs = {}
    for name, p in torch_named_parameters(layer):
        explicit = getattr(p, "partition_spec", None)
        if explicit is not None:
            specs[name] = tuple(explicit)
            continue
        if stage < 3 or world == 1 or p.numel() < min_size:
            specs[name] = ()
            continue
        shape = list(p.shape)
        if name in flipped:
            shape[-1], shape[-2] = shape[-2], shape[-1]
        dim = _first_divisible_dim(shape, world)
        if dim is None:
            specs[name] = ()
            continue
        spec = [None] * len(shape)
        spec[dim] = axis
        if name in flipped:
            spec[-1], spec[-2] = spec[-2], spec[-1]
        specs[name] = tuple(spec)
    return specs


def shard_tensor(x, *spec):
    """``paddle.distributed.shard_tensor``: inside a rank of a mesh run
    (``collective.run_ranks``) the rank's piece of ``x`` under ``spec``;
    outside, with a process mesh set, the per-rank pieces (``shard``); with
    neither, ``x``."""
    from . import collective
    from . import mesh as mesh_mod
    ctx = collective.current_rank()
    if ctx is not None:
        for dim, entry in enumerate(as_spec(spec)):
            if _axes_of(entry):
                x = collective.mesh_split(x, dim, _axes_of(entry))
        return x
    mesh = mesh_mod.get_mesh()
    return x if mesh is None else shard(x, spec, mesh)


def _normal(shape):
    w = nn.Parameter(torch.empty(shape))
    nn.init.normal_(w, 0.0, 0.02)
    return w


def _zeros(shape):
    return nn.Parameter(torch.zeros(shape))


class ColumnParallelLinear(nn.Module):
    """Megatron column-parallel linear: weight ``[in, out]`` split on
    ``out`` over mp, bias split with it.  On a mesh (a rank of
    ``collective.run_ranks``) each rank computes its columns, gathered
    over mp when ``gather_output`` (the JAX package's default), else left
    split for a ``RowParallelLinear(input_is_parallel=True)``."""

    def __init__(self, in_features, out_features, has_bias=True,
                 gather_output=True):
        super().__init__()
        self.gather_output = gather_output
        self.weight = _normal((in_features, out_features))
        self.weight.partition_spec = (None, "mp")
        if has_bias:
            self.bias = _zeros((out_features,))
            self.bias.partition_spec = ("mp",)
        else:
            self.bias = None

    def forward(self, x):
        y = linear(x, self.weight, self.bias)
        if self.gather_output:
            y = collective.mesh_all_gather(y, y.dim() - 1, "mp")
        return y


class RowParallelLinear(nn.Module):
    """Row-parallel linear: weight ``[in, out]`` split on ``in`` over mp,
    the bias replicated.  On a mesh each rank multiplies its rows (of its
    chunk of ``x`` unless ``input_is_parallel``), the partial products
    are summed over mp (``collective.mesh_all_reduce``) and the bias is
    added after the sum."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False):
        super().__init__()
        self.input_is_parallel = input_is_parallel
        self.weight = _normal((in_features, out_features))
        self.weight.partition_spec = ("mp", None)
        if has_bias:
            self.bias = _zeros((out_features,))
            self.bias.partition_spec = ()
        else:
            self.bias = None

    def forward(self, x):
        ctx, group = collective._group_of("mp")
        if group is None:
            return linear(x, self.weight, self.bias)
        if not self.input_is_parallel:
            x = collective.mesh_split(x, x.dim() - 1, "mp")
        y = collective.mesh_all_reduce(linear(x, self.weight), "mp")
        return y if self.bias is None else y + self.bias.to(y.dtype)


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``[vocab, hidden]`` split on vocab over mp: on a
    mesh a rank returns zeros for ids outside its rows, and the sum over
    mp gives every id its row."""

    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.weight = _normal((num_embeddings, embedding_dim))
        self.weight.partition_spec = ("mp", None)

    def forward(self, x):
        ctx, group = collective._group_of("mp")
        if group is None:
            return F.embedding(x, self.weight)
        rows = self.weight.shape[0]
        lo = group.index(ctx.rank) * rows
        local = x - lo
        mine = (local >= 0) & (local < rows)
        out = F.embedding(torch.where(mine, local, torch.zeros_like(local)),
                          self.weight)
        out = out * mine[..., None].to(out.dtype)
        return collective.mesh_all_reduce(out, "mp")


_split_registry = {}


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """``paddle.distributed.split`` (reference: collective.py:566): builds
    (and caches by ``name``) the parallel layer for ``operation``
    (``"linear"`` with ``axis`` 1 column-parallel / 0 row-parallel, or
    ``"embedding"``) over ``size`` and applies it to ``x``."""
    key = name or f"split_{operation}_{size}_{axis}"
    if key not in _split_registry:
        if operation == "linear":
            if axis == 1:
                layer = ColumnParallelLinear(size[0], size[1],
                                             has_bias=bias_attr is not False,
                                             gather_output=gather_out)
            else:
                layer = RowParallelLinear(size[0], size[1],
                                          has_bias=bias_attr is not False)
        elif operation == "embedding":
            layer = VocabParallelEmbedding(size[0], size[1])
        else:
            raise ValueError("unsupported split operation %r" % operation)
        _split_registry[key] = layer.to(x.device)
    return _split_registry[key](x)
