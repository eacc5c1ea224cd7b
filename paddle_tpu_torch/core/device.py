"""Places and the current device — counterpart of
``paddle_tpu/core/device.py``.

The default place is the CUDA card.  Without a card, every op that
needs a place raises ``RuntimeError`` naming ``set_device("cpu")``: the
tensor layer never creates CPU tensors unless asked to.

``set_device`` takes the JAX package's strings: ``gpu``, ``xpu`` and
``tpu`` all name the card, ``cpu`` the CPU.  The card's place is
``CUDAPlace(i)``; ``TPUPlace`` stays as its alias so that code written
against the JAX package runs.
"""
from __future__ import annotations

import torch

from ..device import resolve_device

_current = None  # a Place, or None for the card's default


class Place:
    """Device identity: ``kind`` is ``"gpu"`` (the card) or ``"cpu"``."""

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        if self.kind == "cpu":
            return "Place(cpu)"
        return f"Place(gpu:{self.index})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.kind == other.kind
                and self.index == other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    def is_gpu_place(self):
        return self.kind == "gpu"

    # code written against the JAX package asks for its accelerator
    is_tpu_place = is_gpu_place

    def is_cpu_place(self):
        return self.kind == "cpu"

    def get_device_id(self):
        return self.index


def CPUPlace():
    return Place("cpu", 0)


def CUDAPlace(idx: int = 0):
    return Place("gpu", int(idx))


TPUPlace = CUDAPlace

_KINDS = {"gpu": "gpu", "cuda": "gpu", "xpu": "gpu", "tpu": "gpu",
          "cpu": "cpu"}


def _parse(device) -> Place:
    """A Place from a Place, a torch device or a device string."""
    if isinstance(device, Place):
        return device
    kind, _, idx = str(device).partition(":")
    kind = _KINDS.get(kind.lower())
    if kind is None:
        raise ValueError(
            "unknown device %r (use 'gpu', 'gpu:N' or 'cpu')" % device)
    return Place(kind, int(idx) if idx else 0)


def set_device(device):
    """paddle.set_device — ``"gpu"``, ``"gpu:1"`` (also ``xpu`` / ``tpu``)
    or ``"cpu"``; a ``Place`` is taken as it is."""
    global _current
    place = _parse(device)
    torch_device(place)
    _current = place
    return place


def get_device() -> str:
    p = current_place()
    return f"{p.kind}:{p.index}"


def current_place() -> Place:
    return _current if _current is not None else Place("gpu", 0)


def place_of(t: torch.Tensor) -> Place:
    """The Place of a torch tensor's device."""
    if t.device.type == "cuda":
        return Place("gpu", t.device.index or 0)
    return Place("cpu", 0)


def torch_device(place=None) -> torch.device:
    """The torch device of ``place`` (default: the current place); the card
    without a card raises ``RuntimeError`` naming ``set_device("cpu")``."""
    place = current_place() if place is None else _parse(place)
    return resolve_device(
        "cpu" if place.kind == "cpu" else f"cuda:{place.index}",
        escape='call paddle_tpu_torch.set_device("cpu")')


def device_count() -> int:
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_tpu() -> bool:
    return False
