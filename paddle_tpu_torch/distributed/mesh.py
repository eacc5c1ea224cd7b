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
every card when none is set.  ``host_local_to_global`` and
``global_from_replicated`` assemble multi-process JAX arrays: the port
is one process and raises for them (ROADMAP Queue A 12).
"""
from __future__ import annotations

import math

import numpy as np
import torch

# canonical hybrid-parallel axis order (outer -> inner), as the JAX
# package's
AXES = ("dp", "sharding", "pp", "mp", "sp", "ep")

# the axes a data batch's leading dim shards over (dp + ZeRO sharding)
DATA_AXES = ("dp", "sharding")

_global_mesh = None


def _indexed(dev):
    """A bare ``cuda`` names the current card, so that device equality
    (which tells ranks sharing a card apart) compares like with like."""
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
        devices = [_indexed(torch.device(d)) for d in devices]
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

    def __init__(self, sizes, devices):
        self.shape = {a: int(sizes[a]) for a in AXES}
        self.devices = np.empty(len(devices), dtype=object)
        self.devices[:] = devices
        self.devices = self.devices.reshape([self.shape[a] for a in AXES])

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
        return f"DeviceMesh({shape or {'dp': 1}}, {self.size} ranks)"


def build_mesh(dp=1, sharding=1, pp=1, mp=1, sp=1, ep=1, devices=None):
    """A hybrid-parallel ``DeviceMesh``, as the JAX package's
    ``build_mesh``: every axis exists (size 1 when not asked for); all
    sizes 1 puts every device on ``dp``; ``dp=-1`` fills dp with what the
    other axes leave.  ``devices``: the ranks' devices (default every
    CUDA card); their count must be the axes' product."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
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
    return DeviceMesh(sizes, devices)


def set_mesh(mesh):
    global _global_mesh
    _global_mesh = mesh
    return mesh


def get_mesh():
    return _global_mesh


def ensure_mesh():
    """The process mesh, built over every CUDA card (all on dp) when none
    is set; raises when there is no card and no mesh."""
    global _global_mesh
    if _global_mesh is None:
        if torch.cuda.device_count() == 0:
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


def host_local_to_global(array, mesh=None, *spec):
    raise NotImplementedError(
        "host_local_to_global assembles a multi-process JAX array; the "
        "port drives every rank from one process (ROADMAP Queue A 12)")


def global_from_replicated(array, mesh=None, *spec):
    raise NotImplementedError(
        "global_from_replicated builds a multi-process JAX array; the "
        "port drives every rank from one process (ROADMAP Queue A 12)")
