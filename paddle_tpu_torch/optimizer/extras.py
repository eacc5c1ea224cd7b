"""Long-tail optimizers and parameter-averaging utilities — counterpart
of ``paddle_tpu/optimizer/extras.py``.

Reference parity: ``python/paddle/fluid/optimizer.py`` hosts
ExponentialMovingAverage / ModelAverage / LookaheadOptimizer and the
DecayedAdagrad / Ftrl / Dpsgd update rules (kernels in
``operators/optimizers/``).  The update rules follow the base class's
in-place ``_update``; the averaging utilities write the parameters in
place (the JAX package swaps their arrays).

``Dpsgd``'s noise is a pure function of (seed, the parameter's step
counter, its size), as the JAX rule's counter-based key makes it: each
draw reseeds an explicit ``torch.Generator`` on the parameter's device
from a splitmix64 mix of the three.  The same seed gives the same
stream; it is not jax's stream.
"""
from __future__ import annotations

import contextlib

import torch

from . import Optimizer

_MASK64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def noise_seed(seed, t, size):
    """The generator seed of ``Dpsgd``'s draw for a parameter of ``size``
    elements at its step ``t``: 63 bits of splitmix64 over the three."""
    x = _splitmix64(int(seed) & _MASK64)
    x = _splitmix64(x ^ (int(t) & _MASK64))
    x = _splitmix64(x ^ (int(size) & _MASK64))
    return x >> 1


class DecayedAdagrad(Optimizer):
    """reference: operators/optimizers/decayed_adagrad_op.cc —
    m = decay*m + (1-decay)*g^2."""

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, device=None):
        super().__init__(learning_rate, parameters, weight_decay,
                         grad_clip, name, device)
        self._decay = float(decay)
        self._epsilon = float(epsilon)

    def _init_state(self, p):
        return {"moment": torch.zeros_like(p)}

    def _update(self, p, g, state, lr):
        if self._weight_decay:
            g = g + self._weight_decay * p
        m = state["moment"]
        m.copy_(self._decay * m + (1.0 - self._decay) * g.square())
        p.copy_(p - lr * g / (m.sqrt() + self._epsilon))


class Ftrl(Optimizer):
    """FTRL-proximal (reference: operators/optimizers/ftrl_op.cc with
    lr_power=-0.5)."""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 parameters=None, grad_clip=None, name=None, device=None):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         device)
        self._l1 = float(l1)
        self._l2 = float(l2)
        self._lr_power = float(lr_power)

    def _init_state(self, p):
        return {"squared": torch.zeros_like(p),
                "linear": torch.zeros_like(p)}

    def _update(self, p, g, state, lr):
        sq, lin = state["squared"], state["linear"]
        new_sq = sq + g.square()
        pw = -self._lr_power
        sigma = (new_sq ** pw - sq ** pw) / lr
        lin.copy_(lin + g - sigma * p)
        pre = -(lin - torch.sign(lin) * self._l1) / (
            new_sq ** pw / lr + self._l2)
        sq.copy_(new_sq)
        p.copy_(torch.where(lin.abs() > self._l1, pre,
                            torch.zeros_like(p)))


class Dpsgd(Optimizer):
    """Differentially-private SGD (reference:
    operators/optimizers/dpsgd_op.cc): per-update clip to ``clip`` then
    add N(0, sigma*clip/batch_size) noise.  Each parameter's step counter
    ``t`` is a host int32 tensor in its state (reading it is no device
    sync), and its noise is drawn from a generator reseeded with
    ``noise_seed(seed, t, numel)``."""

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0,
                 sigma=1.0, parameters=None, seed=0, name=None,
                 device=None):
        super().__init__(learning_rate, parameters, None, None, name,
                         device)
        self._clip = float(clip)
        self._batch = float(batch_size)
        self._sigma = float(sigma)
        self._seed = int(seed)
        self._gens = {}

    def _init_state(self, p):
        return {"t": torch.zeros((), dtype=torch.int32)}

    def _generator(self, device):
        gen = self._gens.get(device)
        if gen is None:
            gen = self._gens[device] = torch.Generator(device=device)
        return gen

    def _update(self, p, g, state, lr):
        t = state["t"]
        norm = g.square().sum().sqrt()
        scaled = g * (self._clip / torch.clamp(norm, min=self._clip))
        gen = self._generator(p.device)
        gen.manual_seed(noise_seed(self._seed, int(t), p.numel()))
        noise = torch.randn(p.shape, generator=gen, device=p.device,
                            dtype=p.dtype) * (
                                self._sigma * self._clip / self._batch)
        p.copy_(p - lr * (scaled + noise))
        t.add_(1)


def _param_list(layer_or_params):
    return (list(layer_or_params.parameters())
            if hasattr(layer_or_params, "parameters")
            else list(layer_or_params))


@contextlib.contextmanager
def _swapped_in(params, values, backup, restore):
    """Copy ``values[i]`` into ``params[i]`` (the originals saved into
    ``backup``) for the block's duration, then ``restore()`` when asked."""
    with torch.no_grad():
        for i, p in enumerate(params):
            backup[i] = p.detach().clone()
            p.copy_(values[i].to(p.dtype))
    try:
        yield
    finally:
        if restore is not None:
            restore()


class ExponentialMovingAverage:
    """reference: fluid/optimizer.py ExponentialMovingAverage —
    ``update()`` after each optimizer step; ``apply()`` as a context
    manager swaps the bias-corrected EMA weights in, restoring on exit."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = float(decay)
        self._shadow = {}
        self._backup = {}
        self._step = 0
        self._params = {}

    def _register(self, layer_or_params):
        for i, p in enumerate(_param_list(layer_or_params)):
            self._params[i] = p
            if i not in self._shadow:
                # zero-init as the reference (_create_ema_vars inits the
                # EMA var to 0.0), which is what justifies apply()'s
                # division by the bias-correction factor 1 - decay^t
                self._shadow[i] = torch.zeros_like(p.detach())

    @torch.no_grad()
    def update(self, layer_or_params=None):
        if layer_or_params is not None or not self._params:
            if layer_or_params is None:
                raise ValueError(
                    "ExponentialMovingAverage.update: pass the Layer (or "
                    "parameter list) on first use")
            self._register(layer_or_params)
        self._step += 1
        d = self._decay
        for i, p in self._params.items():
            self._shadow[i] = d * self._shadow[i] + (1.0 - d) * p.detach()

    def apply(self, executor=None, need_restore=True):
        bias = 1.0 - self._decay ** max(self._step, 1)
        keys = sorted(self._params)
        return _swapped_in([self._params[i] for i in keys],
                           [self._shadow[i] / bias for i in keys],
                           self._backup,
                           self.restore if need_restore else None)

    @torch.no_grad()
    def restore(self, executor=None):
        for i, p in self._params.items():
            if i in self._backup:
                p.copy_(self._backup.pop(i))


class ModelAverage:
    """reference: fluid/optimizer.py ModelAverage — accumulate parameter
    sums over a sliding window; ``apply()`` swaps in the window mean."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000, parameters=None, name=None):
        self._rate = float(average_window_rate)
        self._min_w = int(min_average_window)
        self._max_w = int(max_average_window)
        self._params = list(parameters or [])
        self._sum = [torch.zeros_like(p.detach()) for p in self._params]
        self._count = 0
        self._backup = {}

    @torch.no_grad()
    def update(self):
        window = max(self._min_w,
                     min(self._max_w, int(self._count * self._rate) or 1))
        if self._count >= window:
            self._sum = [torch.zeros_like(p.detach()) for p in self._params]
            self._count = 0
        for i, p in enumerate(self._params):
            self._sum[i] = self._sum[i] + p.detach()
        self._count += 1

    def apply(self, executor=None, need_restore=True):
        n = max(self._count, 1)
        return _swapped_in(self._params, [s / n for s in self._sum],
                           self._backup,
                           self.restore if need_restore else None)

    @torch.no_grad()
    def restore(self, executor=None):
        for i, p in enumerate(self._params):
            if i in self._backup:
                p.copy_(self._backup.pop(i))


class LookaheadOptimizer:
    """reference: fluid/optimizer.py LookaheadOptimizer — fast weights
    step with the inner optimizer; every k steps the slow weights move
    alpha toward the fast ones and the fast weights reset to them.  The
    slow weights start as the fast ones after the first step, as in the
    JAX package."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {alpha}")
        self.inner_optimizer = inner_optimizer
        self.alpha = float(alpha)
        self.k = int(k)
        self._slow = None
        self._steps = 0

    def _params(self):
        return self.inner_optimizer._params()

    @torch.no_grad()
    def _after_inner_step(self):
        if self._slow is None:
            self._slow = [p.detach().clone() for p in self._params()]
        self._steps += 1
        if self._steps % self.k == 0:
            for i, p in enumerate(self._params()):
                slow = self._slow[i]
                self._slow[i] = slow + self.alpha * (p.detach() - slow)
                p.copy_(self._slow[i])

    def step(self):
        self.inner_optimizer.step()
        self._after_inner_step()

    def clear_grad(self):
        self.inner_optimizer.clear_grad()

    clear_gradients = clear_grad

    def get_lr(self):
        return self.inner_optimizer.get_lr()

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        out = self.inner_optimizer.minimize(loss)
        self._after_inner_step()
        return out


__all__ = ["DecayedAdagrad", "Ftrl", "Dpsgd", "ExponentialMovingAverage",
           "ModelAverage", "LookaheadOptimizer", "noise_seed"]
