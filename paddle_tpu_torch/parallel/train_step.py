"""Training step — counterpart of ``paddle_tpu/parallel/train_step.py``
``TrainStep`` on one device.

``TrainStep(model, optimizer, loss_fn=None, device=None).step(inputs,
labels=())`` runs the forward (``model(*inputs)``; with a ``loss_fn``,
``loss_fn(out, *labels)``, else the model's output is the loss), the
backward, and the optimizer update (``optimizer.apply_gradients()``, the
compiled step's form: the rate read once as a Python float), and returns
the f32 loss tensor without reading it back: the step makes no host
sync.  Where the JAX package compiles one program and returns new
parameter arrays, the port runs eagerly and updates the model's
parameters in place, so ``sync_to_layer()`` has nothing to copy and
``donate`` changes nothing.

``device=None`` is the CUDA card (raising without one); the model's
parameters must already lie on the step's device, or the constructor
raises: the step never moves weights, and trains on the CPU only when
``device="cpu"`` says so.

* ``amp_level`` ("O1" / "O2") or ``strategy.amp`` (O2 when
  ``amp_configs["use_pure_fp16"]``, else O1) runs the forward and the
  loss under ``amp.auto_cast(level=...)`` in bf16, as the JAX step does;
  O2 expects the model already cast (``amp.decorate``).
* ``strategy.gradient_merge`` (``k_steps`` micro-batches) splits the
  batch along dim 0 and averages the micro-batch losses and gradients,
  as the reference's scan does.
* ``strategy.recompute`` is accepted and changes nothing: the JAX flat
  step ignores it too (only its pipeline reads it); a model recomputes
  through its own ``use_recompute``.
* A model with MoE layers (``GPTModel(moe_experts=...)``) gets the sum of
  their scaled load-balancing losses of this forward added to the loss
  (``distributed.moe.collect_moe_aux_loss``), as the JAX step's
  ``forward_loss`` adds it; each micro-batch adds its own.
* Each step adds one to the ``train.steps`` counter and observes its
  host time in the ``train.step_time_ms`` histogram of the port's
  ``monitor`` default registry.

Meshes, sharding, pipeline parallelism and the hybrid degrees raise
``NotImplementedError`` naming ROADMAP Queue A 10; ``metrics=`` names
A 12 (``paddle_tpu/metric`` is not ported).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import amp, monitor
from ..device import require_on
from ..distributed.moe import collect_moe_aux_loss


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(x), device=device)


class TrainStep:
    """One-device train step over a model and an optimizer of the port
    (see the module docstring)."""

    def __init__(self, model, optimizer, loss_fn=None, strategy=None,
                 mesh=None, amp_level=None, donate=True, train=True,
                 metrics=None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "TrainStep(mesh=...) is not ported yet (ROADMAP Queue A "
                "10: the mesh)")
        if metrics:
            raise NotImplementedError(
                "TrainStep(metrics=...) is not ported yet (ROADMAP Queue "
                "A 12: paddle_tpu/metric)")
        s = strategy
        self.grad_merge_k = 1
        if s is not None:
            self._check_strategy(s)
            if getattr(s, "gradient_merge", False):
                self.grad_merge_k = int(
                    s.gradient_merge_configs.get("k_steps", 1))
        self.use_amp = bool(amp_level) or bool(s and getattr(s, "amp",
                                                             False))
        amp_configs = (getattr(s, "amp_configs", None) or {}) if s else {}
        self.amp_level = amp_level or (
            "O2" if amp_configs.get("use_pure_fp16") else "O1")
        self.device = require_on(device, model.named_parameters(),
                                 "TrainStep")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.strategy = strategy
        self.training = train
        optimizer.bind_names(model.named_parameters())
        self._m_steps = monitor.counter("train.steps",
                                        "TrainStep.step calls")
        self._m_step_time = monitor.histogram(
            "train.step_time_ms",
            "host-side dispatch time per train step (ms)")

    @staticmethod
    def _check_strategy(s):
        unported = {
            "sharding": "Queue A 10 (the mesh: ZeRO sharding)",
            "pipeline": "Queue A 10 (the mesh: pipeline parallelism)",
        }
        for knob, item in unported.items():
            if getattr(s, knob, False):
                raise NotImplementedError(
                    f"TrainStep: strategy.{knob} is not ported yet "
                    f"(ROADMAP {item})")
        hybrid = getattr(s, "hybrid_configs", {}) or {}
        for knob in ("mp_degree", "pp_degree", "sharding_degree"):
            if int(hybrid.get(knob, 1) or 1) > 1:
                raise NotImplementedError(
                    f"TrainStep: strategy.hybrid_configs[{knob!r}] > 1 is "
                    "not ported yet (ROADMAP Queue A 10: the mesh)")

    def _loss(self, inputs, labels):
        ctx = (amp.auto_cast(enable=True, level=self.amp_level)
               if self.use_amp else contextlib.nullcontext())
        with ctx:
            out = self.model(*inputs)
            if isinstance(out, tuple):
                out = out[0]
            loss = out if self.loss_fn is None \
                else self.loss_fn(out, *labels)
            aux = collect_moe_aux_loss(self.model)
            if aux is not None:
                loss = loss + aux
        return loss.float()

    def step(self, inputs, labels=()):
        """One optimization step on a batch; returns the f32 loss."""
        t0 = time.perf_counter()
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        if not isinstance(labels, (list, tuple)):
            labels = [labels]
        inputs = [_as_tensor(x, self.device) for x in inputs]
        labels = [_as_tensor(x, self.device) for x in labels]
        self.model.train(self.training)
        self.optimizer.zero_grad(set_to_none=True)
        k = self.grad_merge_k
        if k == 1:
            loss = self._loss(inputs, labels)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=self.device)
            micro_in = [x.chunk(k) for x in inputs]
            micro_lab = [y.chunk(k) for y in labels]
            if any(len(c) != k for c in micro_in + micro_lab):
                raise ValueError(f"TrainStep: gradient_merge k_steps={k} "
                                 "must divide the batch")
            for i in range(k):
                part = self._loss([c[i] for c in micro_in],
                                  [c[i] for c in micro_lab]) / k
                part.backward()
                loss = loss + part.detach()
        self.optimizer.apply_gradients()
        self._m_steps.inc()
        self._m_step_time.observe((time.perf_counter() - t0) * 1e3)
        return loss

    def sync_to_layer(self):
        """No-op: the step updates the model's parameters in place."""
