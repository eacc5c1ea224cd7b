"""Global flag registry — counterpart of ``paddle_tpu/core/flags.py``.

Flags are set with ``set_flags`` or by the environment's ``FLAGS_*``
variables, read once at import.
"""
from __future__ import annotations

import os

_REGISTRY: dict[str, dict] = {}


def define_flag(name: str, default, doc: str = ""):
    env = os.environ.get("FLAGS_" + name)
    value = default
    if env is not None:
        if isinstance(default, bool):
            value = env.lower() in ("1", "true", "yes")
        elif isinstance(default, int):
            value = int(env)
        elif isinstance(default, float):
            value = float(env)
        else:
            value = env
    _REGISTRY[name] = {"value": value, "default": default, "doc": doc}


def set_flags(flags: dict):
    """paddle.set_flags({'FLAGS_check_nan_inf': True})"""
    for k, v in flags.items():
        name = k[6:] if k.startswith("FLAGS_") else k
        if name not in _REGISTRY:
            raise KeyError("unknown flag %r" % k)
        _REGISTRY[name]["value"] = v


def get_flags(flags):
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for k in flags:
        name = k[6:] if k.startswith("FLAGS_") else k
        out["FLAGS_" + name] = _REGISTRY[name]["value"]
    return out


def flag(name: str):
    return _REGISTRY[name]["value"]


# the JAX package's registry, the same names and defaults
define_flag("check_nan_inf", False,
            "After every eager op, scan outputs for NaN/Inf and raise.")
define_flag("sort_sum_gradient", False,
            "Deterministic gradient accumulation order.")
define_flag("eager_delete_tensor_gb", 0.0,
            "GC threshold; a no-op under torch's caching allocator.")
define_flag("allocator_strategy", "xla",
            "Informational: the allocator is torch's.")
define_flag("use_bf16_matmul", True,
            "Allow bf16 accumulation hints for matmul.")
define_flag("tpu_deterministic", False,
            "Force deterministic reductions where available.")
define_flag("log_level", 0, "VLOG-style verbosity for the package.")
