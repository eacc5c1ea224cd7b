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
rank: a ``DeviceMesh``.  Sequence parallelism
(``distributed/ring.py``) runs over its ``sp`` axis.  Training over a
mesh (``TrainStep(mesh=...)``) is ROADMAP Queue A 10's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# canonical hybrid-parallel axis order (outer -> inner), as the JAX
# package's
AXES = ("dp", "sharding", "pp", "mp", "sp", "ep")

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

    def axis_devices(self, axis):
        """The devices along ``axis``, every other axis at index 0, in rank
        order."""
        return list(self.devices[tuple(slice(None) if a == axis else 0
                                       for a in AXES)])


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
