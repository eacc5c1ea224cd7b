"""Optimizers — counterpart of ``paddle_tpu/optimizer/__init__.py``
(``Optimizer``, ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adamax``,
``Adagrad``, ``RMSProp``, ``Adadelta``, ``Lamb``, ``LarsMomentum``), of
``paddle_tpu/optimizer/lr.py`` (``lr``, the port's copy); ``extras``
holds the long-tail rules and the parameter-averaging utilities.
``grad_clip`` is one of ``nn.clip``'s clips (``ClipGradByGlobalNorm`` is
re-exported here), or, when None, the one ``nn.clip.set_gradient_clip``
registered.

These are ``torch.optim.Optimizer`` subclasses with Paddle's semantics,
not torch's: each rule is the JAX package's ``_update`` written as
in-place torch ops, with its state keys and dtypes.

* ``learning_rate`` is a float or an ``lr.LRScheduler``.  ``get_lr()``
  reads the scheduler's Python float once a step, so a step makes no
  host sync; the user steps the scheduler, as in the JAX package.
  ``last_step_lr`` is the rate the last ``step`` applied.
* ``step()`` is the JAX package's eager step: each parameter's rate is
  ``get_lr()`` times its ``optimize_attr["learning_rate"]`` (an
  attribute a caller may set on a parameter; 1 without it), and
  ``Lamb``'s ``exclude_from_weight_decay_fn`` gets the parameter.
  ``TrainStep`` runs the compiled step's form instead
  (``apply_gradients``): one rate for every parameter, and the exclude
  function gets the parameter's NAME, as ``apply_gradients_tree`` gives
  it.
* bf16 and fp16 parameters keep f32 moments under ``Adam`` / ``AdamW`` /
  ``Lamb`` (``multi_precision=True``, the default) and no f32 master
  copy; ``multi_precision=False`` keeps ``Adam``'s moments in the
  parameter's dtype.  Where the JAX rule promotes to f32 (a bf16 moment
  divided by an f32 bias correction), so does the port.
* ``Adam(weight_decay=c)`` folds ``c * param`` into the gradient (L2);
  ``AdamW`` adds ``c * param`` to the update (``update += c * p``, then
  ``p -= lr * update``), where torch's AdamW scales ``p`` by
  ``1 - lr * c`` before the step.
* ``AdamW(apply_decay_param_fun=f)`` decays only the parameters whose
  NAME ``f`` accepts; names come from ``named_parameters()`` pairs passed
  as ``parameters``, or from the model a ``TrainStep`` binds.

Sparse gradients: a parameter looked up by ``nn.functional.embedding(...,
sparse=True)`` gets a sparse COO gradient.  ``step`` merges its rows
(sorted, duplicates summed) and applies ``_update_sparse``: ``SGD``,
``Momentum``, ``Adam`` and ``AdamW`` update row-wise (the JAX package's
rules; ``Adam(lazy_mode=True)`` touches the moments and the parameter at
the merged rows only, ``lazy_mode=False`` reproduces the dense rule, an
L2 decay is scoped to the touched rows); every other optimizer
densifies the gradient and runs its dense rule.  ``ClipGradByGlobalNorm``
takes the norm over the merged rows.

``parameters`` may hold tensor-layer handles (``core.Tensor``): the
optimizer updates their torch tensors, and without ``device`` it runs on
the current place (``set_device``).

State dicts: ``state_dict()`` / ``load_state_dict()`` are torch's format
(``load_state_dict`` keeps each state tensor's own dtype, where torch
would cast it to the parameter's).  ``paddle_state_dict()`` is the JAX
package's format: ``__step__``, ``LR_Scheduler`` and ``{parameter
name}__{state key}``; ``set_state_dict`` takes either format.
``convert.export_optimizer_state`` / ``load_optimizer_state`` carry the
JAX format across the packages as numpy arrays.

``device=None`` is the CUDA card (raising without one); every parameter
must already lie on the optimizer's device, or the constructor raises,
so an optimizer runs on the CPU only when ``device="cpu"`` says so.  The
state lives on that device; updates are written into the parameters in
place.
"""
from __future__ import annotations

import torch

from ..core import device as core_device
from ..core.tensor import Tensor
from ..device import require_on
from ..distributed import collective
from ..nn import clip as _clip_mod
from ..nn.clip import ClipGradByGlobalNorm  # noqa: F401
from . import lr  # noqa: F401
from .lr import LRScheduler

_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _norm(t):
    """The L2 norm of ``t`` in f32: of the whole parameter when ``t`` is
    a rank's piece of it in a train step over a mesh (the squares summed
    over the ranks holding the other pieces, ``RankContext.norm_axes``)."""
    ctx = collective.current_rank()
    if ctx is None or not ctx.norm_axes:
        return torch.linalg.vector_norm(t.float())
    sq = collective.mesh_all_reduce(t.float().square().sum(), ctx.norm_axes)
    return sq.sqrt()


def _named(parameters):
    """``(params, names, handles)`` from an iterable of tensors, of
    tensor-layer handles (their torch tensors, named by ``.name``) or of
    ``(name, tensor)`` pairs; a bare tensor's name is None.  ``handles``
    says whether any entry was a handle."""
    params, names, handles = [], [], False
    for item in parameters:
        if isinstance(item, tuple):
            name, p = item
        elif isinstance(item, Tensor):
            name, p = item.name, item
        else:
            name, p = None, item
        if isinstance(p, Tensor):
            p, handles = p._data, True
        params.append(p)
        names.append(name)
    return params, names, handles


def _parse_wd(weight_decay):
    """A float, or a regularizer object's ``_coeff`` / ``coeff``."""
    if weight_decay is None:
        return 0.0
    if isinstance(weight_decay, (int, float)):
        return float(weight_decay)
    return float(getattr(weight_decay, "_coeff",
                         getattr(weight_decay, "coeff", 0.0)))


def _wide(t):
    """The dtype an update computes in: ``t``'s promoted with f32 (the JAX
    rules' f32 scalars promote bf16 and fp16 operands)."""
    return torch.promote_types(t.dtype, torch.float32)


class Optimizer(torch.optim.Optimizer):
    """Base of the port's optimizers: learning rate or scheduler, weight
    decay, gradient clipping, parameter names and the JAX package's state
    format."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
        if parameters is None:
            raise ValueError(
                f"{type(self).__name__}: pass parameters= (a model's "
                "parameters() or named_parameters())")
        if not isinstance(learning_rate, (int, float, LRScheduler)):
            raise TypeError(
                f"{type(self).__name__}: learning_rate must be a float or "
                f"an optimizer.lr.LRScheduler, got "
                f"{type(learning_rate).__name__}")
        params, names, handles = _named(parameters)
        if device is None and handles:
            device = core_device.torch_device()
        self.device = require_on(
            device, [(n or f"#{i}", p) for i, (p, n) in
                     enumerate(zip(params, names))], type(self).__name__)
        self._param_names = {id(p): n for p, n in zip(params, names)
                             if n is not None}
        self._learning_rate = (learning_rate
                               if isinstance(learning_rate, LRScheduler)
                               else float(learning_rate))
        self._weight_decay = _parse_wd(weight_decay)
        self._grad_clip = (grad_clip if grad_clip is not None
                           else _clip_mod.get_gradient_clip())
        self._step_count = 0
        self._tree = False
        self.last_step_lr = None
        super().__init__(params, {})

    # -- learning rate -----------------------------------------------------
    def get_lr(self):
        """The rate as a Python float (the scheduler's current value)."""
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value):
        if isinstance(self._learning_rate, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def _get_param_lr(self, p):
        mult = 1.0
        attr = getattr(p, "optimize_attr", None)
        if attr:
            mult = attr.get("learning_rate", 1.0)
        return self.get_lr() * mult

    # -- names ---------------------------------------------------------------
    def bind_names(self, named_parameters):
        """Name the parameters the optimizer holds from ``(name, tensor)``
        pairs (a model's ``named_parameters()``); names already given
        stay."""
        for name, p in named_parameters:
            self._param_names.setdefault(id(p), name)

    def param_name(self, p):
        return self._param_names.get(id(p))

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def _params_with_grads(self):
        return [p for p in self._params() if p.grad is not None]

    # -- the rule (overridden per optimizer) -------------------------------
    def _init_state(self, p):
        return {}

    def _update(self, p, g, state, lr):
        """Write the new parameter into ``p`` and the new state into
        ``state``, in place, from the gradient ``g`` (``p``'s dtype)."""
        raise NotImplementedError

    def _update_sparse(self, p, rows, vals, state, lr):
        """The update from a sparse gradient: ``rows`` unique indices into
        ``p``'s first axis, ``vals`` their summed gradients.  This base
        rule densifies the gradient and runs ``_update`` (right for every
        rule); SGD, Momentum and Adam update row-wise."""
        g = torch.zeros_like(p, dtype=vals.dtype).index_add_(0, rows, vals)
        self._update(p, g, state, lr)

    # -- steps ----------------------------------------------------------------
    @torch.no_grad()
    def step(self, closure=None):
        """One eager step over the parameters that have a gradient."""
        if closure is not None:
            raise NotImplementedError(
                f"{type(self).__name__}.step(closure) is not supported")
        self._apply(tree=False)

    @torch.no_grad()
    def apply_gradients(self):
        """The compiled step's form of ``step`` (``TrainStep``'s): one rate
        for every parameter, name-keyed decay predicates."""
        self._apply(tree=True)

    def _apply(self, tree):
        self._step_count += 1
        params = self._params_with_grads()
        if self._grad_clip is not None:
            self._grad_clip.clip_([p.grad for p in params])
        lr = self.get_lr()
        self.last_step_lr = lr
        self._tree = tree
        try:
            for p in params:
                state = self.state[p]
                if not state:
                    state.update(self._init_state(p))
                p_lr = lr if tree else self._get_param_lr(p)
                if p.grad.is_sparse:
                    g = p.grad.coalesce()
                    self._update_sparse(p, g.indices()[0],
                                        g.values().to(p.dtype), state, p_lr)
                else:
                    self._update(p, p.grad.to(p.dtype), state, p_lr)
        finally:
            self._tree = False

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        """Backward (when no parameter has a gradient yet) and a step;
        returns ``(None, [(param, grad)])``."""
        params = self._params()
        if all(p.grad is None for p in params) and loss.requires_grad:
            loss.backward()
        self.step()
        return None, [(p, p.grad) for p in params]

    def clear_grad(self, set_to_zero=True):
        """Drop every gradient (the JAX package sets them to None)."""
        self.zero_grad(set_to_none=True)

    clear_gradients = clear_grad

    # -- state ------------------------------------------------------------
    def _state_names(self):
        """``[(name, param)]``: bound names, ``param_{i}`` for the rest."""
        return [(self.param_name(p) or f"param_{i}", p)
                for i, p in enumerate(self._params())]

    def paddle_state_dict(self):
        """The JAX package's format: ``__step__``, ``LR_Scheduler`` (with
        a scheduler) and ``{name}__{key}`` for every state tensor."""
        out = {"__step__": self._step_count}
        if isinstance(self._learning_rate, LRScheduler):
            out["LR_Scheduler"] = self._learning_rate.state_dict()
        for name, p in self._state_names():
            for k, v in self.state.get(p, {}).items():
                out[f"{name}__{k}"] = v
        return out

    @torch.no_grad()
    def set_state_dict(self, state):
        """Load the JAX package's format (``paddle_state_dict``; tensors or
        numpy arrays, each state tensor taking the dtype and device this
        optimizer would give it) or torch's (``state_dict()``)."""
        if "state" in state and "param_groups" in state:
            self.load_state_dict(state)
            return
        self._step_count = int(state.get("__step__", 0))
        if isinstance(self._learning_rate, LRScheduler) and \
                "LR_Scheduler" in state:
            self._learning_rate.set_state_dict(state["LR_Scheduler"])
        for name, p in self._state_names():
            prefix = f"{name}__"
            got = {k[len(prefix):]: v for k, v in state.items()
                   if isinstance(k, str) and k.startswith(prefix)}
            if not got:
                continue
            template = self._init_state(p)
            st = {}
            for k, v in got.items():
                v = torch.as_tensor(v)
                ref = template.get(k)
                if ref is None:
                    st[k] = v.to(p.device).clone()
                    continue
                if tuple(v.shape) != tuple(ref.shape):
                    raise ValueError(
                        f"set_state_dict: {name}__{k} has shape "
                        f"{tuple(v.shape)}, the optimizer keeps "
                        f"{tuple(ref.shape)}")
                st[k] = v.to(device=ref.device, dtype=ref.dtype).clone()
            self.state[p] = st

    set_dict = set_state_dict

    def load_state_dict(self, state_dict):
        """torch's ``load_state_dict``, keeping each state tensor's dtype
        (torch casts floating state to the parameter's dtype, which would
        turn the f32 moments of a bf16 parameter into bf16)."""
        super().load_state_dict(state_dict)
        saved = state_dict["state"]
        ids = [i for g in state_dict["param_groups"] for i in g["params"]]
        for i, p in zip(ids, self._params()):
            for k, v in saved.get(i, {}).items():
                if torch.is_tensor(v):
                    self.state[p][k] = v.to(p.device).clone()


class SGD(Optimizer):
    """reference: operators/optimizers/sgd_op.cc"""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)

    def _update(self, p, g, state, lr):
        if self._weight_decay:
            g = g + self._weight_decay * p
        p.copy_(p - lr * g)

    def _update_sparse(self, p, rows, vals, state, lr):
        # the touched rows only; a decay applies to them alone
        if self._weight_decay:
            vals = vals + self._weight_decay * p[rows]
        p.index_add_(0, rows, -lr * vals)


class Momentum(Optimizer):
    """reference: operators/optimizers/momentum_op.cc"""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._momentum = float(momentum)
        self._nesterov = bool(use_nesterov)

    def _init_state(self, p):
        return {"velocity": torch.zeros_like(p)}

    def _update(self, p, g, state, lr):
        if self._weight_decay:
            g = g + self._weight_decay * p
        v = state["velocity"]
        v.copy_(self._momentum * v + g)
        if self._nesterov:
            p.copy_(p - lr * (g + self._momentum * v))
        else:
            p.copy_(p - lr * v)

    def _update_sparse(self, p, rows, vals, state, lr):
        # the velocity decays everywhere (the missing rows carry a zero
        # gradient); gradients and decay land on the touched rows only
        if self._weight_decay:
            vals = vals + self._weight_decay * p[rows]
        v = state["velocity"]
        v.copy_(self._momentum * v)
        v.index_add_(0, rows, vals)
        if self._nesterov:
            p.copy_(p - lr * self._momentum * v)
            p.index_add_(0, rows, -lr * vals)
        else:
            p.copy_(p - lr * v)


class Adam(Optimizer):
    """Adam with bias correction (reference: adam_op).

    ``multi_precision`` (default True): bf16 / fp16 parameters keep f32
    moments; False keeps them in the parameter's dtype (half the state's
    memory), the update still computed in f32 as the JAX rule computes
    it.  ``lazy_mode`` changes only the sparse update (a gradient left by
    ``embedding(..., sparse=True)``): True updates the moments and the
    parameter at the merged rows only, False reproduces the dense rule.
    With dense gradients it is ignored, as in the JAX package."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._beta1 = float(beta1)
        self._beta2 = float(beta2)
        self._epsilon = float(epsilon)
        self._lazy = bool(lazy_mode)
        self._multi_precision = bool(multi_precision)

    def _init_state(self, p):
        mdtype = p.dtype
        if p.dtype in _LOW_PRECISION and self._multi_precision:
            mdtype = torch.float32
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=mdtype),
                "moment2": torch.zeros_like(p, dtype=mdtype),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _decay_on(self, p):
        """Add ``weight_decay * p`` to the update (AdamW's decay)."""
        return False

    def _update(self, p, g, state, lr):
        g = g.to(state["moment1"].dtype)
        if self._weight_decay and not isinstance(self, AdamW):
            g = g + self._weight_decay * p.to(g.dtype)
        self._dense_rule(p, g, state, lr)

    def _dense_rule(self, p, g, state, lr):
        """The update from the whole gradient ``g``, L2 decay folded in."""
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, v = state["moment1"], state["moment2"]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        b1p.mul_(b1)
        b2p.mul_(b2)
        wide = _wide(m)
        update = (m.to(wide) / (1 - b1p)) / (
            (v.to(wide) / (1 - b2p)).sqrt() + eps)
        if self._decay_on(p):
            update = update + self._weight_decay * p.to(wide)
        p.copy_((p.to(wide) - lr * update).to(p.dtype))

    def _update_sparse(self, p, rows, vals, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, v = state["moment1"], state["moment2"]
        g = vals.to(m.dtype)
        if self._weight_decay and not isinstance(self, AdamW):
            # L2 folds into the gradient of the touched rows only
            g = g + self._weight_decay * p[rows].to(g.dtype)
        if not self._lazy:
            self._dense_rule(p, torch.zeros_like(m).index_add_(0, rows, g),
                             state, lr)
            return
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        b1p.mul_(b1)
        b2p.mul_(b2)
        m_r = b1 * m[rows] + (1 - b1) * g
        v_r = b2 * v[rows] + (1 - b2) * g.square()
        wide = _wide(m_r)
        update = (m_r.to(wide) / (1 - b1p)) / (
            (v_r.to(wide) / (1 - b2p)).sqrt() + eps)
        p_r = p[rows].to(wide)
        if self._decay_on(p):
            update = update + self._weight_decay * p_r
        p.index_copy_(0, rows, (p_r - lr * update).to(p.dtype))
        m.index_copy_(0, rows, m_r)
        v.index_copy_(0, rows, v_r)


class AdamW(Adam):
    """Adam with decoupled weight decay (reference: adamw):
    ``update += weight_decay * param`` for the parameters
    ``apply_decay_param_fun(name)`` accepts (all of them without one).
    ``lr_ratio`` is accepted and ignored: the JAX package's ``AdamW``
    stores it nowhere."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=True, name=None,
                 device=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, lazy_mode,
                         multi_precision, name, device)
        self._decay_param_fun = apply_decay_param_fun

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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p),
                "inf_norm": torch.zeros_like(p),
                "beta1_pow": torch.ones((), dtype=torch.float32,
                                        device=p.device)}

    def _update(self, p, g, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        if self._weight_decay:
            g = g + self._weight_decay * p
        m, u, b1p = state["moment"], state["inf_norm"], state["beta1_pow"]
        m.copy_(b1 * m + (1 - b1) * g)
        u.copy_(torch.maximum(b2 * u, g.abs()))
        b1p.mul_(b1)
        wide = _wide(p)
        p.copy_((p.to(wide) - lr / (1 - b1p) * m.to(wide)
                 / (u + eps).to(wide)).to(p.dtype))


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._epsilon = float(epsilon)
        self._init_value = float(initial_accumulator_value)

    def _init_state(self, p):
        return {"moment": torch.full_like(p, self._init_value)}

    def _update(self, p, g, state, lr):
        if self._weight_decay:
            g = g + self._weight_decay * p
        m = state["moment"]
        m.copy_(m + g.square())
        p.copy_(p - lr * g / (m.sqrt() + self._epsilon))


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._rho, self._epsilon = float(rho), float(epsilon)
        self._momentum, self._centered = float(momentum), bool(centered)

    def _init_state(self, p):
        return {"mean_square": torch.zeros_like(p),
                "mean_grad": torch.zeros_like(p),
                "velocity": torch.zeros_like(p)}

    def _update(self, p, g, state, lr):
        if self._weight_decay:
            g = g + self._weight_decay * p
        rho, eps = self._rho, self._epsilon
        ms, mg, v = state["mean_square"], state["mean_grad"], \
            state["velocity"]
        ms.copy_(rho * ms + (1 - rho) * g.square())
        if self._centered:
            mg.copy_(rho * mg + (1 - rho) * g)
            denom = (ms - mg.square() + eps).sqrt()
        else:
            denom = (ms + eps).sqrt()
        v.copy_(self._momentum * v + lr * g / denom)
        p.copy_(p - v)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, device)
        self._rho, self._epsilon = float(rho), float(epsilon)

    def _init_state(self, p):
        return {"avg_squared_grad": torch.zeros_like(p),
                "avg_squared_update": torch.zeros_like(p)}

    def _update(self, p, g, state, lr):
        if self._weight_decay:
            g = g + self._weight_decay * p
        rho, eps = self._rho, self._epsilon
        asg, asu = state["avg_squared_grad"], state["avg_squared_update"]
        asg.copy_(rho * asg + (1 - rho) * g.square())
        update = g * (asu + eps).sqrt() / (asg + eps).sqrt()
        asu.copy_(rho * asu + (1 - rho) * update.square())
        p.copy_(p - lr * update)


class Lamb(Optimizer):
    """reference: operators/optimizers/lamb_op.cc (layer-wise adaptation).
    ``exclude_from_weight_decay_fn`` gets the parameter in ``step()`` (as
    paddle passes it) and the parameter's name under ``TrainStep`` (as
    the JAX package's compiled step passes it; a predicate that raises
    on a name keeps the decay)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name, device)
        self._beta1, self._beta2 = float(beta1), float(beta2)
        self._epsilon = float(epsilon)
        self._exclude_fn = exclude_from_weight_decay_fn

    def _decay_for(self, p):
        if self._exclude_fn is None:
            return True
        if not self._tree:
            return not bool(self._exclude_fn(p))
        try:
            return not bool(self._exclude_fn(self.param_name(p)))
        except Exception:
            return True

    def _init_state(self, p):
        mdtype = torch.float32 if p.dtype in _LOW_PRECISION else p.dtype
        one = torch.ones((), dtype=torch.float32, device=p.device)
        return {"moment1": torch.zeros_like(p, dtype=mdtype),
                "moment2": torch.zeros_like(p, dtype=mdtype),
                "beta1_pow": one.clone(), "beta2_pow": one.clone()}

    def _update(self, p, g, state, lr):
        b1, b2, eps = self._beta1, self._beta2, self._epsilon
        m, v = state["moment1"], state["moment2"]
        g = g.to(m.dtype)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g.square())
        b1p, b2p = state["beta1_pow"], state["beta2_pow"]
        b1p.mul_(b1)
        b2p.mul_(b2)
        wide = _wide(m)
        r = (m.to(wide) / (1 - b1p)) / ((v.to(wide) / (1 - b2p)).sqrt()
                                        + eps)
        if self._weight_decay and self._decay_for(p):
            r = r + self._weight_decay * p.to(r.dtype)
        w_norm = _norm(p)
        r_norm = _norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.copy_((p.to(r.dtype) - lr * trust * r).to(p.dtype))


class LarsMomentum(Momentum):
    """reference: operators/optimizers/lars_momentum_op.cc"""

    def __init__(self, learning_rate=0.001, momentum=0.9,
                 lars_coeff=0.001, lars_weight_decay=0.0005,
                 parameters=None, grad_clip=None, epsilon=1e-9, name=None,
                 device=None):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=None, grad_clip=grad_clip,
                         device=device)
        self._lars_coeff = float(lars_coeff)
        self._lars_wd = float(lars_weight_decay)
        self._eps = float(epsilon)

    def _update(self, p, g, state, lr):
        w_norm = _norm(p)
        g_norm = _norm(g)
        local_lr = torch.where(
            (w_norm > 0) & (g_norm > 0),
            lr * self._lars_coeff * w_norm
            / (g_norm + self._lars_wd * w_norm + self._eps),
            torch.full_like(w_norm, lr))
        g = g + self._lars_wd * p
        v = state["velocity"]
        v.copy_(self._momentum * v + local_lr * g)
        p.copy_(p - v)


Lars = LarsMomentum

from .extras import (DecayedAdagrad, Dpsgd, ExponentialMovingAverage,  # noqa: E402,F401
                     Ftrl, LookaheadOptimizer, ModelAverage)
