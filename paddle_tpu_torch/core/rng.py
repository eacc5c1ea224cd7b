"""Random state — counterpart of ``paddle_tpu/core/rng.py``.

The JAX package splits one counter-based key per draw.  The port keeps
its own explicit ``torch.Generator`` for each device, all seeded by
``seed``; the random ops of ``ops/creation.py`` draw from the generator
of the device they create on.  The same seed therefore repeats a stream
on one device; a stream on the card differs from the CPU's (torch's
Philox against its Mersenne Twister), and neither matches JAX's.

``seed(s)`` also calls ``torch.manual_seed(s)``, which seeds torch's
default generators: the dropout of the existing port modules
(``nn.Dropout`` in ``models/``) draws from those, so it follows
``seed`` as the JAX package's dropout follows its key.  The serving
sampler does not: it draws from each request's own generator, seeded
by the request's ``seed``.

The JAX package's ``rbg`` import-time config and its jit-trace key
plumbing (``push_trace_key``, ``op_key``, ``request_key``) have no
counterpart: there is no trace to thread a key through.
"""
from __future__ import annotations

import threading

import torch

_lock = threading.Lock()
_seed = 0
_gens: dict = {}


def seed(s: int):
    """paddle.seed — reset every generator of the tensor layer, and
    torch's default generators."""
    global _seed
    with _lock:
        _seed = int(s)
        _gens.clear()
    torch.manual_seed(_seed)
    return _seed


def get_seed() -> int:
    return _seed


def generator(device) -> torch.Generator:
    """The tensor layer's generator for ``device`` (created on first use,
    seeded with the current seed)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _gens.get(device)
        if gen is None:
            gen = _gens[device] = torch.Generator(device=device)
            gen.manual_seed(_seed)
    return gen


def generator_for(seed_val, device) -> torch.Generator:
    """A generator from an explicit seed, or the device's stream when the
    seed is None or 0 (the JAX package's ``key_for``)."""
    if seed_val:
        gen = torch.Generator(device=torch.device(device))
        gen.manual_seed(int(seed_val))
        return gen
    return generator(device)
