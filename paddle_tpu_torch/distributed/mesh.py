"""Device meshes — counterpart of ``paddle_tpu/distributed/mesh.py``
(``build_mesh``, ``serving_mesh``, ``set_mesh``, ``get_mesh``).

The JAX engine is a single controller: one host process drives GSPMD
over ``mp * dp`` devices.  The port keeps that shape.  A mesh is a list of
``mp * dp`` ranks, each with a ``torch.device``; a sharded tensor is held
as one shard per rank on that rank's device (``distributed/sharding.py``),
and the collectives GSPMD would insert are explicit functions
(``distributed/collective.py``).  Several ranks may share one device: on
a one-card machine a caller maps all four ranks of a ``(2, 2)`` mesh onto
``cuda:0`` with ``devices=[torch.device("cuda:0")] * 4``.  Nothing falls
back quietly: a mesh gets the devices it is given.

Rank order is the JAX ``build_mesh(mp=, dp=)`` order: the device list
reshapes to ``[dp, mp]`` (dp outer, mp inner), so rank ``(m, d)`` is
``devices[d * mp + m]`` in both packages and holds the same shard.

``build_mesh`` is the hybrid-parallel grid over the six axes of the JAX
package (``dp, sharding, pp, mp, sp, ep``, outer to inner), one device a
rank: a ``DeviceMesh``.  Its flat rank order is the JAX mesh's device
order (row-major over ``AXES``); ``coords`` / ``group`` name a rank's
place and the ranks it meets in a collective over some axes.  Sequence
parallelism (``distributed/ring.py``) runs over its ``sp`` axis, and
``TrainStep(mesh=...)`` (``parallel/train_step.py``) trains over all six.

``DATA_AXES`` are the axes a batch's leading dimension splits over
(``batch_partition_spec``); ``ensure_mesh`` sets the process mesh over
every card when none is set.

A mesh may span processes (``distributed/process.py``): after
``init_parallel_env``, ``build_mesh`` with no ``devices`` lays its ranks
over every process's local devices, process 0's first, as
``jax.devices()`` orders them, and ``devices=`` (``ProcessDevice``\\ s
from ``process.devices()``) may permute them.  ``DeviceMesh.procs``
names the process owning each rank; a process holds and runs only its
own ranks (``local_ranks``), and the collectives cross processes where a
group spans them.  Plain ``torch.device``\\ s make a mesh of this process
alone.  ``host_local_to_global`` and ``global_from_replicated`` are the
multi-process feed: each process hands its own ranks their rows, the
first from the process's local shard of the batch, the second cut out of
the global batch every process holds (``RankPieces``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import process

# canonical hybrid-parallel axis order (outer -> inner), as the JAX
# package's
AXES = ("dp", "sharding", "pp", "mp", "sp", "ep")

# the axes a data batch's leading dim shards over (dp + ZeRO sharding)
DATA_AXES = ("dp", "sharding")

_global_mesh = None


def _indexed(dev):
    """A bare ``cuda`` names the current card, so that device equality
    (which tells ranks sharing a card apart) compares like with like."""
    if isinstance(dev, process.ProcessDevice):
        dev = dev.device
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class ServingMesh:
    """``mp * dp`` ranks over the given devices, in JAX rank order.

    ``devices``: ``mp * dp`` devices (``torch.device`` or strings), rank
    ``(m, d)`` on ``devices[d * mp + m]``; repeats are allowed (several
    ranks on one card)."""

    def __init__(self, mp=1, dp=1, devices=None):
        mp, dp = int(mp), int(dp)
        if mp < 1 or dp < 1:
            raise ValueError(f"mp and dp must be >= 1, got mp={mp} dp={dp}")
        if devices is None:
            raise ValueError(
                f"ServingMesh(mp={mp}, dp={dp}) needs devices=: a list of "
                f"{mp * dp} devices (repeats allowed), or use serving_mesh() "
                "to take the first cards")
        devices = [_indexed(d) for d in devices]
        if len(devices) != mp * dp:
            raise ValueError(
                f"ServingMesh(mp={mp}, dp={dp}) needs {mp * dp} devices, "
                f"got {len(devices)}")
        self.mp = mp
        self.dp = dp
        self.devices = devices

    @property
    def shape(self):
        return {"mp": self.mp, "dp": self.dp}

    @property
    def size(self):
        return self.mp * self.dp

    def rank(self, m, d):
        """Flat rank index of ``(m, d)`` (the JAX device order)."""
        return int(d) * self.mp + int(m)

    def ranks(self):
        """``(m, d)`` of every rank, in flat rank order."""
        return [(m, d) for d in range(self.dp) for m in range(self.mp)]

    def device(self, m, d):
        return self.devices[self.rank(m, d)]

    @property
    def flat_devices(self):
        return list(self.devices)

    def axis_size(self, axis):
        return {"mp": self.mp, "dp": self.dp}.get(axis, 1)

    def coords(self, r):
        """``{"mp": m, "dp": d}`` of flat rank ``r``."""
        return {"mp": int(r) % self.mp, "dp": int(r) // self.mp}

    def mp_group(self, d):
        """Devices of dp group ``d``'s ranks ``(0..mp-1, d)``: the group
        a row-parallel sum or a vocab all-gather runs over."""
        return [self.device(m, d) for m in range(self.mp)]

    def __repr__(self):
        return (f"ServingMesh(mp={self.mp}, dp={self.dp}, devices="
                f"{[str(d) for d in self.devices]})")


def serving_mesh(mp=1, dp=1, devices=None):
    """``(mp, dp)`` mesh over the first ``mp * dp`` of ``devices``
    (default: every CUDA card, ``cuda:0`` first).  Fewer devices raise
    ``ValueError`` naming the ``devices=`` argument, the way to put
    several ranks on one card."""
    mp, dp = int(mp), int(dp)
    if mp < 1 or dp < 1:
        raise ValueError(f"mp and dp must be >= 1, got mp={mp} dp={dp}")
    need = mp * dp
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if len(devices) < need:
        shape = f"mp={mp}, dp={dp}" if dp > 1 else f"mp={mp}"
        raise ValueError(
            f"serving_mesh({shape}) needs {need} devices, have "
            f"{len(devices)} — to put several ranks on one device pass "
            f"them explicitly, e.g. ServingMesh({mp}, {dp}, "
            f"devices=[torch.device('cuda:0')] * {need})")
    return ServingMesh(mp, dp, devices[:need])


class DeviceMesh:
    """A grid of ranks over the six ``AXES``, one device a rank (repeats
    allowed: several ranks on one card).  ``shape`` maps every axis to its
    size; ``devices`` is the ``[dp, sharding, pp, mp, sp, ep]`` object
    array of ``torch.device``s, the JAX mesh's device order."""

    def __init__(self, sizes, devices, procs=None):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = devices
        self.devices = self.devices.reshape([self.shape[a] for a in AXES])
        me = process.index()
        self.procs = [me] * len(devices) if procs is None else \
            [int(p) for p in procs]
        self.process = me
        self.local_ranks = [r for r, p in enumerate(self.procs) if p == me]
        self.spans_processes = len(set(self.procs)) > 1

    def is_local(self, r):
        """Whether this process holds and runs rank ``r``."""
        return self.procs[int(r)] == self.process

    def procs_of(self, ranks):
        """The processes owning ``ranks``, sorted."""
        return tuple(sorted({self.procs[int(r)] for r in ranks}))

    @property
    def local_devices(self):
        devs = self.flat_devices
        return [devs[r] for r in self.local_ranks]

    @property
    def size(self):
        return int(self.devices.size)

    @property
    def flat_devices(self):
        """Every rank's device, in flat rank order."""
        return list(self.devices.flat)

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_devices(self, axis):
        """The devices along ``axis``, every other axis at index 0, in rank
        order."""
        return list(self.devices[tuple(slice(None) if a == axis else 0
                                       for a in AXES)])

    def coords(self, r):
        """``{axis: index}`` of flat rank ``r``."""
        idx = np.unravel_index(int(r), self.devices.shape)
        return {a: int(i) for a, i in zip(AXES, idx)}

    def rank_of(self, coords):
        """The flat rank at ``coords`` (missing axes at 0)."""
        return int(np.ravel_multi_index(
            tuple(int(coords.get(a, 0)) for a in AXES), self.devices.shape))

    def group(self, r, axes):
        """The flat ranks that differ from rank ``r`` only along ``axes``,
        in rank order: the ranks a collective over ``axes`` joins."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c = self.coords(r)
        idx = np.arange(self.size).reshape(self.devices.shape)
        return [int(x) for x in idx[tuple(
            slice(None) if a in axes else c[a] for a in AXES)].flat]

    def index_in(self, r, axes):
        """Rank ``r``'s position in its group over ``axes`` (row-major over
        them: ``dp * sharding_size + sharding`` for ``DATA_AXES``)."""
        return self.group(r, axes).index(int(r))

    def __repr__(self):
        shape = {a: n for a, n in self.shape.items() if n > 1}
        procs = (f", {len(set(self.procs))} processes"
                 if self.spans_processes else "")
        return f"DeviceMesh({shape or {'dp': 1}}, {self.size} ranks{procs})"


def build_mesh(dp=1, sharding=1, pp=1, mp=1, sp=1, ep=1, devices=None):
    """A hybrid-parallel ``DeviceMesh``, as the JAX package's
    ``build_mesh``: every axis exists (size 1 when not asked for); all
    sizes 1 puts every device on ``dp``; ``dp=-1`` fills dp with what the
    other axes leave.  ``devices``: the ranks' devices (default every
    CUDA card — ``PADDLE_DEVICES_PER_PROC`` CPU ranks when that is set —
    or after ``init_parallel_env`` every process's devices in
    job order); their count must be the axes' product.  ``ProcessDevice``
    entries (``process.devices()``) say which process owns each rank."""
    if devices is None:
        devices = (process.devices() if process.count() > 1 else
                   [d.device for d in process.devices()])
    devices = list(devices)
    procs = None
    if devices and all(isinstance(d, process.ProcessDevice)
                       for d in devices):
        procs = [d.process_index for d in devices]
    devices = [_indexed(d) for d in devices]
    n = len(devices)
    sizes = {"dp": dp, "sharding": sharding, "pp": pp, "mp": mp, "sp": sp,
             "ep": ep}
    used = math.prod(sizes.values())
    if used == 1:
        sizes["dp"] = n
        used = n
    elif sizes["dp"] == -1:
        rest = math.prod(v for k, v in sizes.items() if k != "dp")
        if rest == 0 or n % rest != 0:
            raise ValueError(
                f"cannot fill dp: {n} devices not divisible by {rest}")
        sizes["dp"] = n // rest
        used = math.prod(sizes.values())
    if used != n:
        raise ValueError(
            f"mesh axes {sizes} require {used} devices, have {n}")
    return DeviceMesh(sizes, devices, procs)


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh():
    return _global_mesh


def ensure_mesh():
    """The process mesh, built over every CUDA card (all on dp; after
    ``init_parallel_env`` every process's devices) when none is set;
    raises when there is no card and no mesh."""
    global _global_mesh
    if _global_mesh is None:
        if not process.devices():
            raise RuntimeError(
                "ensure_mesh: no mesh is set and no CUDA card is present — "
                "set_mesh(build_mesh(..., devices=[...])) first")
        _global_mesh = build_mesh()
    return _global_mesh


def axis_size(name):
    """Size of axis ``name`` on the process mesh (1 without one)."""
    return 1 if _global_mesh is None else _global_mesh.axis_size(name)


def data_parallel_size():
    """Combined data-sharding degree (dp x sharding) of the process
    mesh."""
    return axis_size("dp") * axis_size("sharding")


def data_axes_size(mesh=None):
    mesh = mesh if mesh is not None else ensure_mesh()
    return math.prod(mesh.axis_size(a) for a in DATA_AXES)


def batch_partition_spec(shape, mesh=None):
    """Leading-dim data sharding when divisible, replicated otherwise (the
    single source of the batch-spec policy; TrainStep reuses it)."""
    if shape and shape[0] % data_axes_size(mesh) == 0:
        return (DATA_AXES,) + (None,) * (len(shape) - 1)
    return ()


class RankPieces:
    """A global array as this process's ranks' pieces — the port's
    ``jax.Array`` over a mesh that may span processes: ``shape`` is the
    global shape, ``spec`` the partition spec, ``pieces`` ``{rank:
    tensor}`` for this process's ranks, each on its rank's device."""

    def __init__(self, shape, spec, mesh, pieces):
        self.shape = tuple(int(s) for s in shape)
        self.spec = tuple(spec)
        self.mesh = mesh
        self.pieces = dict(pieces)

    @property
    def split(self):
        return bool(self.spec)

    def __repr__(self):
        return (f"RankPieces(shape={self.shape}, spec={self.spec}, "
                f"ranks={sorted(self.pieces)})")


def _split_dim(spec):
    """``(dim, axes)`` of the one split entry of ``spec`` (or ``(None,
    ())``); more than one split dimension is refused."""
    from .sharding import _axes_of
    split = [(d, _axes_of(e)) for d, e in enumerate(spec) if e]
    if len(split) > 1:
        raise NotImplementedError(
            f"host_local_to_global: spec {spec} splits more than one "
            "dimension; the port's multi-process feed splits one")
    return split[0] if split else (None, ())


def _as_host_tensor(array):
    from ..core.tensor import Tensor
    if isinstance(array, Tensor):
        array = array._data
    if isinstance(array, torch.Tensor):
        return array
    return torch.as_tensor(np.asarray(array))


def host_local_to_global(array, mesh=None, *spec):
    """Assemble per-process local batches into one global array (each
    process feeds its shard, as each trainer reads its own data
    partition).  A no-op in a one-process job.

    Each of this process's ranks takes its rows of the local array: along
    the split dimension (default the leading one over ``DATA_AXES``) the
    local array holds the chunks of the distinct indices this process's
    ranks have on the split axes, in order.  A 0-d array is replicated
    (it must be identical on every process).  A local leading dim that
    does not divide across the per-process data degree is an error, as
    in the JAX package: a multi-process partial batch cannot fall back to
    replication (each process holds different rows); pad the batch or use
    ``drop_last=True``."""
    if process.count() == 1:
        return array
    arr = _as_host_tensor(array)
    mesh = mesh if mesh is not None else ensure_mesh()
    if not spec:
        if arr.dim() == 0:
            spec = ()
        else:
            local_per_host = data_axes_size(mesh) // process.count()
            if local_per_host and arr.shape[0] % local_per_host != 0:
                raise ValueError(
                    f"multi-host batch: local leading dim {arr.shape[0]} "
                    f"does not divide across the per-host data-parallel "
                    f"degree {local_per_host}; pad the batch or use "
                    "drop_last=True")
            spec = (DATA_AXES,) + (None,) * (arr.dim() - 1)
    dim, axes = _split_dim(spec)
    devs = mesh.flat_devices
    if dim is None:
        return RankPieces(arr.shape, spec, mesh, {
            r: arr.to(devs[r]) for r in mesh.local_ranks})
    from .sharding import _chunk_index
    idx = {r: _chunk_index(mesh.coords(r), axes, mesh)
           for r in mesh.local_ranks}
    mine = sorted(set(idx.values()))
    if arr.shape[dim] % len(mine):
        raise ValueError(
            f"host_local_to_global: local dim {dim} ({arr.shape[dim]}) "
            f"does not divide over this process's {len(mine)} indices on "
            f"{axes}")
    chunks = arr.chunk(len(mine), dim=dim)
    shape = list(arr.shape)
    shape[dim] = chunks[0].shape[dim] * math.prod(mesh.axis_size(a)
                                                  for a in axes)
    return RankPieces(shape, spec, mesh, {
        r: chunks[mine.index(i)].to(devs[r]) for r, i in idx.items()})


def global_from_replicated(array, mesh=None, *spec):
    """A mesh-sharded global array from a batch every process holds IN
    FULL: each process cuts its ranks' pieces out of the full copy.  The
    multi-process feed when the data axes do not split
    process-contiguously — a pipeline whose ``pp`` ring spans processes,
    where one dp row-block lives on several processes (Megatron
    semantics: ranks in one dp group read identical data).  Works for any
    device permutation."""
    from .sharding import piece_slices
    arr = _as_host_tensor(array)
    mesh = mesh if mesh is not None else ensure_mesh()
    spec = tuple(spec) if spec else batch_partition_spec(tuple(arr.shape),
                                                          mesh)
    devs = mesh.flat_devices
    pieces = {}
    for r in mesh.local_ranks:
        view = arr
        for d, start, n in piece_slices(spec, tuple(arr.shape), mesh, r):
            view = view.narrow(d, start, n)
        pieces[r] = view.to(devs[r])
    return RankPieces(arr.shape, spec, mesh, pieces)
