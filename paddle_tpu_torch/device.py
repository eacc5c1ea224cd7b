"""Device resolution for the port's entry points.

``None`` means the CUDA card.  Without a card that raises instead of
quietly running on the CPU: a caller that wants the CPU (the parity
tests) says so with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None, escape='pass device="cpu"'):
    """Return the ``torch.device`` an entry point runs on.

    ``None`` resolves to ``"cuda"``; asking for CUDA without a card
    raises ``RuntimeError`` naming ``escape``, the way to the CPU (the
    tensor layer's is ``set_device("cpu")``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; paddle_tpu_torch runs on the "
            f"card by default — {escape} to run on the CPU")
    return dev


def require_on(device, named_tensors, who):
    """Resolve ``device`` as ``resolve_device`` does (a bare ``"cuda"``
    becomes the current card) and raise ``ValueError`` when any of the
    ``(name, tensor)`` pairs lies elsewhere: entry points never move
    weights.  Returns the resolved ``torch.device``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    for name, t in named_tensors:
        if t.device != dev:
            raise ValueError(
                f"{who}: parameter {name} is on {t.device}, not on {dev} "
                "— move the model first (the port never moves weights)")
    return dev
