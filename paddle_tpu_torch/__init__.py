"""paddle_tpu_torch — the PyTorch + CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` stays the reference; this package mirrors
its module paths and class names (``models/gpt.py``,
``serving/engine.py``, ``ops/ragged_paged_attn.py``) so each piece has an
obvious counterpart.  It imports ``torch``, ``numpy`` and the standard
library only — never ``jax`` and nothing under ``paddle_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (the CPU tests do); there is no silent CPU fallback.
"""
from __future__ import annotations

from .device import resolve_device  # noqa: F401

__version__ = "0.1.0"
