"""Automatic mixed precision — counterpart of ``paddle_tpu/amp``.

Reference parity: dygraph AMP (``imperative/amp_auto_cast.cc:27,130`` —
per-op white/black lists casting inputs) + ``paddle.amp.GradScaler``
(``fluid/dygraph/amp/loss_scaler.py:27`` — dynamic loss scaling driven by
``check_finite_and_unscale`` / ``update_loss_scaling`` ops).

The JAX package casts per primitive: its dispatcher hands each
primitive's input arrays to the amp hook under the primitive's name.
The port does the same at its own sites, which call
``cast_inputs(op_name, *tensors)`` under the JAX package's names
(``linear``, ``layer_norm``, ``scaled_dot_product_attention``, ``gelu``,
``fused_linear_cross_entropy``, ``softmax_with_cross_entropy``,
``einsum``).  ``torch.autocast`` is not used: its own op lists would
cast the matmuls inside the fused head + CE and run softmax and
layer_norm in f32, where the JAX package does neither.

* O1: an op on the white list gets its f32 inputs in the compute dtype
  (bf16 by default); every other op is left alone.
* O2 (``decorate`` casts the model): only the black list acts, its
  inputs in the compute dtype going up to f32.  A ``linear`` then meets
  an f32 activation beside bf16 weights; ``promote`` gives both the
  common dtype, as jnp promotes them (torch's matmuls do not promote).

``GradScaler`` keeps the fp16 API: under bf16 its scaling is an
identity up to rounding; under ``auto_cast(dtype="float16")`` its
dynamic scale guards against overflow, as ``update_loss_scaling_op.cc``.
"""
from __future__ import annotations

import contextlib

import torch

# reference: fluid/contrib/mixed_precision/fp16_lists.py
WHITE_LIST = {
    "matmul_v2", "matmul", "mul", "conv2d", "conv1d", "conv3d", "linear",
    "lstm_rnn", "gru_rnn", "rnn_rnn", "einsum", "bmm", "addmm",
    "scaled_dot_product_attention", "conv2d_transpose",
}
BLACK_LIST = {
    "exp", "square", "log", "mean", "sum", "cos_sim", "softmax",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "cross_entropy", "bce_loss", "layer_norm", "reduce_sum", "reduce_mean",
    "p_norm", "logsumexp", "cumsum",
}

_state = {"enable": False, "dtype": torch.bfloat16, "level": "O1",
          "custom_white": set(), "custom_black": set()}


def cast_inputs(op_name, *tensors):
    """The inputs of the op ``op_name`` as the JAX package's amp hook
    casts them (see the module docstring); non-tensors and None pass
    through.  Returns a tuple, one entry per input."""
    if not _state["enable"]:
        return tensors
    target = _state["dtype"]
    if _state["level"] == "O2":
        if op_name in BLACK_LIST or op_name in _state["custom_black"]:
            return tuple(t.float() if isinstance(t, torch.Tensor)
                         and t.dtype == target else t for t in tensors)
        return tensors
    if op_name in _state["custom_black"] or not (
            op_name in WHITE_LIST or op_name in _state["custom_white"]):
        return tensors
    return tuple(t.to(target) if isinstance(t, torch.Tensor)
                 and t.dtype == torch.float32 else t for t in tensors)


def promote(*tensors):
    """The floating tensors cast to their common dtype (jnp's promotion of
    a matmul's operands); None passes through."""
    dt = None
    for t in tensors:
        if t is not None:
            dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return tuple(t if t is None or t.dtype == dt else t.to(dt)
                 for t in tensors)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    """paddle.amp.auto_cast"""
    prev = dict(_state)
    _state["enable"] = enable
    _state["level"] = level
    _state["dtype"] = torch.bfloat16 if dtype == "bfloat16" \
        else torch.float16
    _state["custom_white"] = set(custom_white_list or ())
    _state["custom_black"] = set(custom_black_list or ())
    try:
        yield
    finally:
        _state.update(prev)


amp_guard = auto_cast


def current_state():
    """The ``auto_cast`` state in force (a copy), for ``restored``."""
    return {k: (set(v) if isinstance(v, set) else v)
            for k, v in _state.items()}


@contextlib.contextmanager
def restored(state):
    """Run a block under a state taken by ``current_state``: a forward
    recomputed in backward (``fleet.utils.recompute``) casts as the first
    forward did, though backward runs outside its ``auto_cast``."""
    prev = dict(_state)
    _state.update(state)
    try:
        yield
    finally:
        _state.update(prev)


def is_enabled():
    return _state["enable"]


class GradScaler:
    """paddle.amp.GradScaler (reference: fluid/dygraph/amp/loss_scaler.py:27).

    Enabled, it scales the loss and unscales the gradients whatever the
    compute dtype, as the JAX package's does: under bf16 that is an
    identity up to rounding; under fp16 the dynamic loss-scale update
    mirrors update_loss_scaling_op.cc.  The finite check over all
    gradients reads one flag back to the host a step, as the JAX
    package's does.
    """

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable:
            return
        inv = 1.0 / self._scale
        flags = []
        for p in optimizer._params():
            if p.grad is not None:
                # a sparse gradient scales through its values
                g = p.grad._values() if p.grad.is_sparse else p.grad
                g.mul_(inv)
                flags.append((~torch.isfinite(g)).any())
        self._found_inf = bool(torch.stack(flags).any()) if flags \
            else False

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not self._found_inf:
            optimizer.step()
        self._update()

    def minimize(self, optimizer, scaled_loss):
        self.step(optimizer)

    def update(self):
        pass  # paddle's GradScaler.update is folded into step()

    def _update(self):
        if not self._dynamic:
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("good_steps", 0)
        self._bad_steps = state.get("bad_steps", 0)


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """paddle.amp.decorate — O2 casts the models' parameters to the
    compute dtype (in place: ``Module.to``); O1 changes nothing."""
    if level == "O2":
        target = torch.bfloat16 if dtype == "bfloat16" else torch.float16
        for m in (models if isinstance(models, (list, tuple))
                  else [models]):
            m.to(dtype=target)
    if optimizers is None:
        return models
    return models, optimizers
