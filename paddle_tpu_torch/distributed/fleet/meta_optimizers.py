"""Communication-reducing meta-optimizers: LocalSGD, adaptive LocalSGD,
DGC, fp16 allreduce — counterpart of
``paddle_tpu/distributed/fleet/meta_optimizers.py``.

Reference parity: ``fleet/meta_optimizers/localsgd_optimizer.py`` (k
local steps then parameter averaging), ``dgc_optimizer.py`` +
``dgc_op.cc`` (Deep Gradient Compression: top-k sparsified,
momentum-corrected allreduce with local residuals),
``fp16_allreduce_optimizer.py`` (gradients cast to fp16 for the wire).

The JAX package makes the per-rank state explicit with a leading
``[dp]`` axis and ``vmap``\\ s the local step over it, ``dp`` the product
of the ``DATA_AXES`` sizes, its state at ``P(DATA_AXES)``: every other
axis holds replicas.  The port holds one state a data rank, as the
reference's processes do: each data rank (the mesh rank at index 0 of
every axis outside ``dp`` x ``sharding``, ``data_representatives``) has
its own parameter copy on its device, its own optimizer state, and
DGC's momentum ``u`` and residual ``v``; a rank that differs from it only
on ``mp``, ``pp``, ``sp`` or ``ep`` is a replica and reads the same
tensors (``rank_params``), so the port computes once a data rank what
the JAX program replicates over those axes.  The data rank's forward
and backward run on a replica of the model holding its tensors over its
rows of the batch (``[dp, -1]``, as the JAX package reshapes it), and
the cross-rank mean is the collective (``collective.reduce_parts``).
Steps are ``step(inputs, labels)`` -> the mean of the ranks' losses;
``sync_to_layer()`` writes the (averaged) parameters into the model.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import collective
from .. import mesh as mesh_mod
from ..mesh import DATA_AXES
from ...nn.layer.base import torch_named_buffers, torch_named_parameters


class _PerRankStep:
    """Shared machinery: one parameter copy, optimizer state and model
    replica a data rank."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None):
        from ...parallel.train_step import (bind, data_representatives,
                                            meta_replica)
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.mesh = mesh if mesh is not None else mesh_mod.ensure_mesh()
        self.data_ranks = data_representatives(self.mesh)
        self.dp = len(self.data_ranks)
        self.devs = [self.mesh.flat_devices[r] for r in self.data_ranks]
        optimizer.bind_names(torch_named_parameters(model))
        params = dict(torch_named_parameters(model))
        self.pnames = sorted(k for k in params if params[k].requires_grad)
        self.frozen = sorted(k for k in params if not params[k].requires_grad)
        self.params, self.opt_state, self.replicas = [], [], []
        for r in range(self.dp):
            dev = self.devs[r]
            mine = {}
            for k in self.pnames + self.frozen:
                p = params[k].detach()
                # rank 0 trains in the model's storage when it shares its
                # device; every other rank holds a copy
                t = p if r == 0 and p.device == dev else p.to(dev, copy=True)
                mine[k] = t.requires_grad_(k in self.pnames)
            rep = meta_replica(model)
            bind(rep, mine, {k: b.detach().to(dev, copy=True)
                             for k, b in torch_named_buffers(model)
                             if b is not None})
            self.params.append({k: mine[k] for k in self.pnames})
            self.opt_state.append({k: optimizer._init_state(mine[k])
                                   for k in self.pnames})
            self.replicas.append(rep)

    def rank_params(self, r):
        """Mesh rank ``r``'s parameters: those of its data rank, which
        every rank differing from it only outside the data axes shares."""
        return self.params[self.mesh.index_in(r, DATA_AXES)]

    # -- one rank's loss over its rows -----------------------------------
    def _rank_rows(self, arrays, r):
        out = []
        for a in arrays:
            a = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a))
            out.append(a.reshape((self.dp, -1) + tuple(a.shape[1:]))[r]
                       .to(self.devs[r]))
        return out

    def _loss(self, r, inputs, labels):
        rep = self.replicas[r]
        rep.train(True)
        out = rep(*inputs)
        if isinstance(out, tuple):
            out = out[0]
        loss = out if self.loss_fn is None else self.loss_fn(out, *labels)
        return loss.float()

    def _grads(self, r, inputs, labels):
        loss = self._loss(r, inputs, labels)
        grads = torch.autograd.grad(loss, [self.params[r][k]
                                           for k in self.pnames],
                                    allow_unused=True)
        return loss.detach(), {
            k: g if g is not None else torch.zeros_like(self.params[r][k])
            for k, g in zip(self.pnames, grads)}

    def _update(self, r, k, g, lr):
        p = self.params[r][k]
        self.optimizer._param_names[id(p)] = k
        try:
            with torch.no_grad():
                self.optimizer._update(p, g.to(p.dtype),
                                       self.opt_state[r][k], lr)
        finally:
            self.optimizer._param_names.pop(id(p), None)

    def _mean(self, losses):
        dev = self.devs[0]
        return sum(l.to(dev) for l in losses) / len(losses)

    @torch.no_grad()
    def _average_params(self):
        for k in self.pnames:
            parts = [self.params[r][k] for r in range(self.dp)]
            if not parts[0].is_floating_point():
                continue
            avg = collective.reduce_parts(parts, self.devs, "avg")
            for p, a in zip(parts, avg):
                p.copy_(a)

    def _begin(self):
        opt = self.optimizer
        lr = opt.get_lr()
        opt.last_step_lr = lr
        opt._step_count += 1
        opt._tree = True
        return lr

    def step(self, inputs, labels=()):
        inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
        labels = labels if isinstance(labels, (list, tuple)) else [labels]
        lr = self._begin()
        try:
            return self._step(list(inputs), list(labels), lr)
        finally:
            self.optimizer._tree = False

    @torch.no_grad()
    def sync_to_layer(self):
        named = dict(torch_named_parameters(self.model))
        for k in self.pnames:
            parts = [self.params[r][k].to(named[k].device)
                     for r in range(self.dp)]
            named[k].copy_(sum(parts) / len(parts)
                           if parts[0].is_floating_point() else parts[0])

    # -- checkpoint form (``checkpoint.save_train_state``) -----------------
    def _state_tree(self):
        stack = (lambda ts: np.stack([t.detach().float().cpu().numpy()
                                      if t.is_floating_point() else
                                      t.detach().cpu().numpy() for t in ts]))
        tree = {"params": {k: stack([self.params[r][k]
                                     for r in range(self.dp)])
                           for k in self.pnames},
                "opt_state": {k: {sk: stack([self.opt_state[r][k][sk]
                                             for r in range(self.dp)])
                                  for sk in self.opt_state[0][k]}
                              for k in self.pnames}}
        return tree

    @torch.no_grad()
    def _load_state_tree(self, tree):
        for k in self.pnames:
            for r in range(self.dp):
                self.params[r][k].copy_(torch.as_tensor(tree["params"][k][r]))
                for sk, v in tree["opt_state"][k].items():
                    self.opt_state[r][k][sk].copy_(torch.as_tensor(v[r]))


class LocalSGDStep(_PerRankStep):
    """``k_steps`` local optimizer steps a rank, each over its next
    ``1 / k_steps`` of its rows, then the parameters averaged over the
    ranks (reference: LocalSGDOptimizer)."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 k_steps=2):
        super().__init__(model, optimizer, loss_fn, mesh)
        self.k_steps = max(int(k_steps), 1)

    def _step(self, inputs, labels, lr):
        losses = []
        for r in range(self.dp):
            ins, labs = (self._rank_rows(inputs, r),
                         self._rank_rows(labels, r))
            for i in range(self.k_steps):
                c_in = [a.reshape((self.k_steps, -1) + tuple(a.shape[1:]))[i]
                        for a in ins]
                c_lab = [a.reshape((self.k_steps, -1)
                                   + tuple(a.shape[1:]))[i] for a in labs]
                loss, g = self._grads(r, c_in, c_lab)
                for k in self.pnames:
                    self._update(r, k, g[k], lr)
            losses.append(loss)
        self._average_params()
        return self._mean(losses)


class AdaptiveLocalSGDStep(_PerRankStep):
    """LocalSGD with an adaptive interval (reference:
    AdaptiveLocalSGDOptimizer, ``localsgd_optimizer.py:195``): one local
    step a rank every call; the parameters are averaged when ``step -
    last_sync >= k``, and after each sync ``k = clip(ceil(sqrt(lr_0 *
    loss / (lr * loss_0) * init_k_steps)), 1, max_k_steps)`` with
    ``lr_0`` / ``loss_0`` from the first step.  The interval is host
    control flow between steps, so it reads the loss back at the first
    step and at each sync, as the JAX package's does."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 init_k_steps=1, begin_step=1, max_k_steps=16):
        super().__init__(model, optimizer, loss_fn, mesh)
        self.init_k_steps = max(int(init_k_steps), 1)
        self.k_steps = self.init_k_steps
        self.begin_step = max(int(begin_step), 1)
        self.max_k_steps = max(int(max_k_steps), 1)
        self._iter = 0
        self._last_sync = 0
        self._loss0 = None
        self._lr0 = None

    def _step(self, inputs, labels, lr):
        losses = []
        for r in range(self.dp):
            loss, g = self._grads(r, self._rank_rows(inputs, r),
                                  self._rank_rows(labels, r))
            for k in self.pnames:
                self._update(r, k, g[k], lr)
            losses.append(loss)
        loss = self._mean(losses)
        self._iter += 1
        lr = max(float(lr), 1e-12)
        if self._loss0 is None:
            self._loss0 = max(float(loss), 1e-12)
            self._lr0 = lr
        if (self._iter >= self.begin_step
                and self._iter - self._last_sync >= self.k_steps):
            self._average_params()
            self._last_sync = self._iter
            ratio = (self._lr0 * max(float(loss), 0.0)) / (lr * self._loss0)
            self.k_steps = int(np.clip(
                np.ceil(np.sqrt(ratio * self.init_k_steps)),
                1, self.max_k_steps))
        return loss


class DGCStep(_PerRankStep):
    """Deep Gradient Compression (reference: dgc_op.cc,
    sparse_all_reduce_op_handle.cc): a rank's momentum ``u = m u + g``
    and residual ``v = v + u``; it sends the top ``1 - sparsity`` of
    ``|v|`` (its threshold the k-th largest) and keeps the rest in
    ``u`` and ``v``; the ranks' sent tensors are averaged (a dense mean,
    the semantics the reference's sparse allreduce computes) and every
    copy takes the update."""

    def __init__(self, model, optimizer, loss_fn=None, mesh=None,
                 sparsity=0.9, momentum=0.9):
        super().__init__(model, optimizer, loss_fn, mesh)
        self.sparsity = float(sparsity)
        self.momentum = float(momentum)
        self.dgc_state = [{k: {"u": torch.zeros_like(p, dtype=torch.float32),
                               "v": torch.zeros_like(p, dtype=torch.float32)}
                           for k, p in self.params[r].items()}
                          for r in range(self.dp)]

    def _mask(self, v):
        flat = v.abs().reshape(-1)
        keep = max(int(flat.numel() * (1.0 - self.sparsity)), 1)
        thresh = torch.topk(flat, keep).values[-1]
        return (v.abs() >= thresh).to(v.dtype)

    def _step(self, inputs, labels, lr):
        losses, sent = [], {k: [] for k in self.pnames}
        m = self.momentum
        for r in range(self.dp):
            loss, g = self._grads(r, self._rank_rows(inputs, r),
                                  self._rank_rows(labels, r))
            losses.append(loss)
            with torch.no_grad():
                for k in self.pnames:
                    st = self.dgc_state[r][k]
                    u = m * st["u"] + g[k].float()
                    v = st["v"] + u
                    mask = self._mask(v)
                    sent[k].append(v * mask)
                    st["u"] = u * (1 - mask)
                    st["v"] = v * (1 - mask)
        for k in self.pnames:
            with torch.no_grad():
                g_sync = collective.reduce_parts(sent[k], self.devs, "avg")
            for r in range(self.dp):
                self._update(r, k, g_sync[r], lr)
        return self._mean(losses)

    def _state_tree(self):
        tree = super()._state_tree()
        tree["dgc_state"] = {k: {n: np.stack([
            self.dgc_state[r][k][n].cpu().numpy() for r in range(self.dp)])
            for n in ("u", "v")} for k in self.pnames}
        return tree

    @torch.no_grad()
    def _load_state_tree(self, tree):
        super()._load_state_tree(tree)
        for k in self.pnames:
            for r in range(self.dp):
                for n in ("u", "v"):
                    self.dgc_state[r][k][n].copy_(torch.as_tensor(
                        tree["dgc_state"][k][n][r]))


class FP16AllReduceStep(_PerRankStep):
    """Each rank's gradients cast to fp16 before the cross-rank mean and
    back to f32 after (reference: fp16_allreduce_optimizer.py — half the
    wire bytes; the mean of the fp16 values as the reference computes
    it)."""

    def _step(self, inputs, labels, lr):
        losses, g16 = [], {k: [] for k in self.pnames}
        for r in range(self.dp):
            loss, g = self._grads(r, self._rank_rows(inputs, r),
                                  self._rank_rows(labels, r))
            losses.append(loss)
            for k in self.pnames:
                g16[k].append(g[k].to(torch.float16))
        for k in self.pnames:
            with torch.no_grad():
                g_sync = collective.reduce_parts(
                    [t.float() for t in g16[k]], self.devs, "avg")
            for r in range(self.dp):
                self._update(r, k, g_sync[r], lr)
        return self._mean(losses)
