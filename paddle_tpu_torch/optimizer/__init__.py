"""Optimizers — counterpart of ``paddle_tpu/optimizer/__init__.py``
(``Optimizer``, ``Adam``, ``AdamW``) and of ``paddle_tpu/nn/clip.py``
``ClipGradByGlobalNorm``.

These are ``torch.optim.Optimizer`` subclasses with Paddle's semantics,
not torch's ``Adam``/``AdamW``:

* bf16 and fp16 parameters keep f32 moments (the reference's default
  ``multi_precision=True``) and no f32 master copy; the update is
  computed in f32 and cast back to the parameter's dtype.
* each parameter carries its own f32 ``beta1_pow`` / ``beta2_pow``.
* ``Adam(weight_decay=c)`` folds ``c * param`` into the gradient (L2);
  ``AdamW`` adds ``c * param`` to the update (``update += c * p``, then
  ``p -= lr * update``), where torch's AdamW scales ``p`` by
  ``1 - lr * c`` before the step.
* ``AdamW(apply_decay_param_fun=f)`` decays only the parameters whose
  NAME ``f`` accepts; names come from ``named_parameters()`` pairs passed
  as ``parameters``, or from the model a ``TrainStep`` binds.

``device=None`` is the CUDA card (raising without one); every parameter
must already lie on the optimizer's device, or the constructor raises,
so an optimizer runs on the CPU only when ``device="cpu"`` says so.  The
state lives on that device; a step makes no host sync.  Updates are
written into the parameters in place.
"""
from __future__ import annotations

import torch

from ..device import require_on

_LOW_PRECISION = (torch.bfloat16, torch.float16)


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm,
    clip_norm)``, the global norm taken in f32 over all gradients."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def __call__(self, grads):
        """Clip the list of gradient tensors ``grads`` in place."""
        grads = [g for g in grads if g is not None]
        if not grads:
            return
        sq = torch.stack([g.float().square().sum() for g in grads])
        global_norm = sq.sum().sqrt()
        scale = self.clip_norm / torch.clamp(global_norm,
                                             min=self.clip_norm)
        for g in grads:
            g.copy_((g * scale).to(g.dtype))


def _named(parameters):
    """``(params, names)`` from an iterable of tensors or of
    ``(name, tensor)`` pairs; a bare tensor's name is None."""
    params, names = [], []
    for item in parameters:
        if isinstance(item, tuple):
            name, p = item
        else:
            name, p = None, item
        params.append(p)
        names.append(name)
    return params, names


class Optimizer(torch.optim.Optimizer):
    """Base of the port's optimizers: learning rate, weight decay,
    gradient clipping and parameter names."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, device=None):
        if parameters is None:
            raise ValueError(
                f"{type(self).__name__}: pass parameters= (a model's "
                "parameters() or named_parameters())")
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError(
                f"{type(self).__name__}: learning-rate schedulers are not "
                "ported yet (ROADMAP Queue A 11: LR schedulers)")
        params, names = _named(parameters)
        self.device = require_on(
            device, [(n or f"#{i}", p) for i, (p, n) in
                     enumerate(zip(params, names))], type(self).__name__)
        self._param_names = {id(p): n for p, n in zip(params, names)
                             if n is not None}
        self._learning_rate = float(learning_rate)
        self._weight_decay = float(weight_decay or 0.0)
        self._grad_clip = grad_clip
        super().__init__(params, {})

    def get_lr(self):
        return self._learning_rate

    def bind_names(self, named_parameters):
        """Name the parameters the optimizer holds from ``(name, tensor)``
        pairs (a model's ``named_parameters()``); names already given
        stay."""
        for name, p in named_parameters:
            self._param_names.setdefault(id(p), name)

    def param_name(self, p):
        return self._param_names.get(id(p))

    def _params_with_grads(self):
        return [p for group in self.param_groups for p in group["params"]
                if p.grad is not None]

    def _init_state(self, p):
        return {}

    def _update(self, p, state, lr):
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError(
                f"{type(self).__name__}.step(closure) is not supported")
        params = self._params_with_grads()
        if self._grad_clip is not None:
            self._grad_clip([p.grad for p in params])
        lr = self.get_lr()
        for p in params:
            state = self.state[p]
            if not state:
                state.update(self._init_state(p))
            self._update(p, state, lr)


class Adam(Optimizer):
    """Adam with bias correction (reference: adam_op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         device)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)

    def _init_state(self, p):
        mdtype = torch.float32 if p.dtype in _LOW_PRECISION else p.dtype
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=mdtype),
                "moment2": torch.zeros_like(p, dtype=mdtype),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _l2_on(self, p):
        """Fold ``weight_decay * p`` into the gradient (Adam's L2)."""
        return bool(self._weight_decay)

    def _decay_on(self, p):
        """Add ``weight_decay * p`` to the update (AdamW's decay)."""
        return False

    def _update(self, p, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, v = state["moment1"], state["moment2"]
        g = p.grad.to(m.dtype)
        if self._l2_on(p):
            g = g + self._weight_decay * p.to(g.dtype)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        state["beta1_pow"].mul_(b1)
        state["beta2_pow"].mul_(b2)
        update = (m / (1 - state["beta1_pow"])) / (
            (v / (1 - state["beta2_pow"])).sqrt() + eps)
        if self._decay_on(p):
            update = update + self._weight_decay * p.to(update.dtype)
        p.copy_((p.to(update.dtype) - lr * update).to(p.dtype))


class AdamW(Adam):
    """Adam with decoupled weight decay (reference: adamw):
    ``update += weight_decay * param`` for the parameters
    ``apply_decay_param_fun(name)`` accepts (all of them without one)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 apply_decay_param_fun=None, grad_clip=None, device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, device)
        self._decay_param_fun = apply_decay_param_fun

    def _l2_on(self, p):
        return False

    def _decay_on(self, p):
        if not self._weight_decay:
            return False
        if self._decay_param_fun is None:
            return True
        name = self.param_name(p)
        if name is None:
            raise ValueError(
                "AdamW(apply_decay_param_fun=...) needs parameter names: "
                "pass named_parameters() as parameters, or train through "
                "a TrainStep, which binds the model's names")
        return bool(self._decay_param_fun(name))
