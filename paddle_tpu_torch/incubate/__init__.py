"""Incubating APIs — counterpart of ``paddle_tpu/incubate``: the
job-level auto-checkpoint (``checkpoint``)."""
from __future__ import annotations

from . import checkpoint  # noqa: F401
