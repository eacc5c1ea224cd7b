"""Dtype system — counterpart of ``paddle_tpu/core/dtype.py``.

Paddle names its dtypes by string (``"float32"``, ``"int64"``, ...); the
port maps each name onto a torch dtype.  The default floating dtype is
float32, switchable with ``set_default_dtype``.

The JAX package runs without x64, so there ``int64`` and ``float64``
arrays become int32 and float32.  The port keeps them, as Paddle does.
"""
from __future__ import annotations

import numpy as np
import torch

# canonical name -> torch dtype
_DTYPE_MAP = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}
_NAME_OF = {v: k for k, v in _DTYPE_MAP.items()}

_ALIASES = {
    "float": "float32",
    "double": "float64",
    "half": "float16",
    "int": "int32",
    "long": "int64",
    "bfloat": "bfloat16",
}

bool_ = "bool"
uint8 = "uint8"
int8 = "int8"
int16 = "int16"
int32 = "int32"
int64 = "int64"
float16 = "float16"
bfloat16 = "bfloat16"
float32 = "float32"
float64 = "float64"
complex64 = "complex64"
complex128 = "complex128"

_default_dtype = "float32"


def set_default_dtype(d):
    """Set the default floating dtype (paddle.set_default_dtype)."""
    global _default_dtype
    name = canonical_name(d)
    if name not in ("float16", "bfloat16", "float32", "float64"):
        raise TypeError(
            "set_default_dtype only supports floating dtypes, got %s" % d)
    _default_dtype = name


def get_default_dtype():
    return _default_dtype


def canonical_name(d) -> str:
    """Normalize any dtype spec (str, numpy or torch dtype) to its
    canonical string."""
    if d is None:
        return _default_dtype
    if isinstance(d, torch.dtype):
        if d in _NAME_OF:
            return _NAME_OF[d]
        raise TypeError("unsupported dtype: %r" % (d,))
    if isinstance(d, str):
        name = _ALIASES.get(d, d)
        if name in _DTYPE_MAP:
            return name
        raise TypeError("unsupported dtype: %r" % (d,))
    try:
        name = np.dtype(d).name
    except TypeError:
        name = getattr(d, "__name__", None) or str(d)
    if "bfloat16" in str(d):
        return "bfloat16"
    name = _ALIASES.get(name, name)
    if name in _DTYPE_MAP:
        return name
    raise TypeError("unsupported dtype: %r" % (d,))


def to_torch(d):
    """Any dtype spec -> torch dtype."""
    return _DTYPE_MAP[canonical_name(d)]


def is_floating(d) -> bool:
    return canonical_name(d) in ("float16", "bfloat16", "float32", "float64")


def is_integer(d) -> bool:
    return canonical_name(d) in ("uint8", "int8", "int16", "int32", "int64")


def is_complex(d) -> bool:
    return canonical_name(d) in ("complex64", "complex128")
