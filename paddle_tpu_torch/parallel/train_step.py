"""Training step — counterpart of ``paddle_tpu/parallel/train_step.py``
``TrainStep`` on one device.

``TrainStep(model, optimizer, loss_fn=None, device=None).step(inputs,
labels=())`` runs the forward (``model(*inputs)``; with a ``loss_fn``,
``loss_fn(out, *labels)``, else the model's output is the loss), the
backward, and the optimizer update, and returns the f32 loss tensor
without reading it back: the step makes no host sync.  Where the JAX
package compiles one program and returns new parameter arrays, the port
runs eagerly and updates the model's parameters in place, so
``sync_to_layer()`` has nothing to copy.

``device=None`` is the CUDA card (raising without one); the model's
parameters must already lie on the step's device, or the constructor
raises: the step never moves weights, and trains on the CPU only when
``device="cpu"`` says so.

``strategy.gradient_merge`` (``k_steps`` micro-batches) splits the batch
along dim 0 and averages the micro-batch losses and gradients, as the
reference's scan does.  Meshes, sharding, tensor/pipeline parallelism,
recompute and AMP raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import require_on


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(x), device=device)


class TrainStep:
    """One-device train step over a model and an optimizer of the port
    (see the module docstring)."""

    def __init__(self, model, optimizer, loss_fn=None, strategy=None,
                 mesh=None, amp_level=None, train=True, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "TrainStep(mesh=...) is not ported yet (ROADMAP Queue A "
                "10: the mesh)")
        if amp_level is not None:
            raise NotImplementedError(
                "TrainStep(amp_level=...) is not ported yet (ROADMAP Queue "
                "A 11: amp O1/O2); cast the model to bfloat16 instead")
        self.grad_merge_k = 1
        if strategy is not None:
            self._check_strategy(strategy)
            if getattr(strategy, "gradient_merge", False):
                self.grad_merge_k = int(
                    strategy.gradient_merge_configs.get("k_steps", 1))
        self.device = require_on(device, model.named_parameters(),
                                 "TrainStep")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.strategy = strategy
        self.training = train
        optimizer.bind_names(model.named_parameters())

    @staticmethod
    def _check_strategy(s):
        unported = {
            "sharding": "Queue A 10 (the mesh: ZeRO sharding)",
            "pipeline": "Queue A 10 (the mesh: pipeline parallelism)",
            "recompute": "Queue A 11 (training: use_recompute)",
            "amp": "Queue A 11 (training: amp O1/O2)",
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
        out = self.model(*inputs)
        if isinstance(out, tuple):
            out = out[0]
        loss = out if self.loss_fn is None else self.loss_fn(out, *labels)
        return loss.float()

    def step(self, inputs, labels=()):
        """One optimization step on a batch; returns the f32 loss."""
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
        self.optimizer.step()
        return loss

    def sync_to_layer(self):
        """No-op: the step updates the model's parameters in place."""
