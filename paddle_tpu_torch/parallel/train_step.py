"""Training step — counterpart of ``paddle_tpu/parallel/train_step.py``
``TrainStep``, on one device or over a mesh.

``TrainStep(model, optimizer, loss_fn=None, strategy=None, mesh=None,
device=None).step(inputs, labels=())`` runs the forward
(``model(*inputs)``; with a ``loss_fn``, ``loss_fn(out, *labels)``, else
the model's output is the loss), the backward, and the optimizer update
(the compiled step's form: the rate read once as a Python float, one
rate for every parameter), and returns the f32 loss tensor without
reading it back: the step makes no host sync.  Where the JAX package
compiles one program and returns new parameter arrays, the port runs
eagerly and updates tensors in place; ``sync_to_layer()`` writes a
mesh's shards back into the model (on one device the model's own
parameters are updated, and it has nothing to do); ``donate`` changes
nothing.  The model may be a Paddle ``nn.Layer`` (a ``torch.nn.Module``):
the step reads torch's own iteration over it
(``nn.layer.torch_named_parameters``), never the Layer's Paddle
``parameters()``, which gives tensor-layer handles.

The mesh is ``mesh``, else the process mesh (``distributed.set_mesh``,
``fleet.init``), as the JAX step takes ``mesh or ensure_mesh()``; with
neither the step runs on its one device: ``device=None`` is the CUDA
card (raising without one), and the model's parameters must already lie
there, or the constructor raises — it never moves weights, and trains on
the CPU only when ``device="cpu"`` says so.  A ``DataParallel`` model is
unwrapped, as in the JAX package.  A ``PipelineLayer`` over a mesh with
``pp > 1`` trains through ``parallel/pipeline.py`` (GPipe, or 1F1B with
``pipeline_configs["schedule_mode"] = "1F1B"``; ``accumulate_steps``
micro-batches).

Over a mesh (``_FlatMesh``) every rank holds its own pieces: its shard
of each parameter under the parameter's spec (``param_specs``), its own
gradients and its slice of the optimizer state (``opt_specs``), with the
JAX step's spec semantics:

* the batch's leading dim splits over ``DATA_AXES`` (``dp`` x
  ``sharding``), or is replicated when it does not divide
  (``mesh.batch_partition_spec``);
* stages 0-2 replicate the parameters, except explicit
  ``partition_spec``\\ s (the TP layers' over ``mp``, the MoE expert
  stacks' over ``ep``); stage 3 shards them over ``sharding``
  (``sharding.shard_params_specs``, ``sharding_configs["min_shard_size"]``
  default 1024), and a rank holds the whole of one unit's parameters at
  a time (below);
* stages >= 1 shard the moments of a replicated parameter over
  ``sharding`` on the JAX layout's first dimension, when it divides; each
  rank updates its slice, and the slices are gathered back;
* each rank runs the model's forward on a replica of the model's modules
  holding the rank's tensors, all ranks in lockstep
  (``collective.run_ranks``: the TP layers, the MoE router and experts
  and the sequence-parallel attention meet their groups there), and the
  loss is the mean of the data ranks' losses (one representative of each
  model-parallel group), so one backward covers every rank; the step
  names each rank's token-mean denominator (``_FlatMesh._token_count``,
  read by ``nn.functional.loss``), so that a masked token mean is the
  whole batch's, and the MoE aux loss covers the whole batch; the
  tensor-parallel head's CE is vocab-parallel (each mp rank its columns);
  a batch norm (the port's ``nn.layer.BatchNorm*``, or torch's, whose
  forward a replica swaps for ``nn.functional.norm.
  torch_batch_norm_forward``) normalizes each data rank's rows by the
  whole batch's statistics and advances its running ones once, from the
  whole batch;
* each gradient is summed over the ranks holding the same piece (every
  axis its spec does not name: the collectives' exact transposes leave
  each replica's share on it), then clipped by the global norm over the
  distinct pieces (``ClipGradByGlobalNorm``) and applied; ``Lamb``'s and
  ``LarsMomentum``'s norms cover the whole parameter.

* stage 3 gathers a unit at a time, as FSDP does: a unit is a child
  module of the model (a GPT block, the embeddings, the head; a
  ``ModuleList`` or ``ModuleDict`` is looked through) and the parameters
  the model owns itself are one more.  A replica's stage-3 slot is a
  parametrization that reads its rank's ``_UnitGather``: the first read
  of a unit's parameter all-gathers every stage-3 parameter of the unit
  over the rank's ``sharding`` group (``_GatherOne``) and drops the unit
  held before.  The rank's forward runs under saved-tensor hooks, so an
  op that saves a gathered parameter, its cast or a view of either for
  the backward saves its name instead, and the backward gathers it again
  from the shards (a pure function of them, never a replayed
  collective); a unit that recomputes itself (``use_recompute``) reads
  its parameters again in the recomputation.  Each gathered copy's
  gradient goes back to the shards it came from as soon as every op
  that read it has run its backward (the reduce-scatter).  A rank so
  holds at most one unit's gathered parameters and one unit's whole
  gradients beside its shards (``max_live_units`` counts them); a
  parameter that two units read (a tied embedding and head) keeps its
  whole gradient until the backward reaches the first of them;
* ``amp_level`` ("O1" / "O2") or ``strategy.amp`` (O2 when
  ``amp_configs["use_pure_fp16"]``, else O1) runs the forward and the
  loss under ``amp.auto_cast(level=...)`` in bf16, as the JAX step does;
  O2 expects the model already cast (``amp.decorate``).
* ``strategy.gradient_merge`` (``k_steps`` micro-batches) splits the
  batch along dim 0 and averages the micro-batch losses and gradients,
  as the reference's scan does (over a mesh each micro-batch splits over
  the data axes in turn).
* ``strategy.recompute`` is read by the pipeline only, as in the JAX
  package; a model recomputes through its own ``use_recompute``.
* A model with MoE layers gets the sum of their scaled load-balancing
  losses of this forward added to the loss
  (``distributed.moe.collect_moe_aux_loss``), as the JAX step's
  ``forward_loss`` adds it; each micro-batch adds its own.
* Each step adds one to the ``train.steps`` counter and observes its
  host time in the ``train.step_time_ms`` histogram of the port's
  ``monitor`` default registry.

* ``metrics=`` (``metric.Metric`` objects): after the forward each
  metric's ``compute(out, *labels)`` runs under ``no_grad`` on the
  step's output, and ``last_metric_outs`` holds what it returned (a
  list a metric: torch tensors on the step's device) for the caller's
  ``update``, as the JAX step returns them.  Under gradient merge the
  micro-batches' outputs are joined along the batch (stacked when 0-d);
  over a mesh the metric sees the whole batch's output, the data ranks'
  rows in order; under GPipe the ``post`` outputs of every micro-batch
  in the batch's row order; under 1F1B, whose outputs never exist
  whole, it warns and computes nothing, as the JAX step does.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import time
import types
import weakref

import numpy as np
import torch
from torch.nn.utils import parametrize

from .. import amp, monitor
from ..device import require_on
from ..distributed import collective
from ..distributed import mesh as mesh_mod
from ..distributed import process
from ..distributed.moe import collect_moe_aux_loss
from ..distributed.sharding import (_axes_of, _flipped_linear_weights,
                                    piece_slices, shard_params_specs)
from ..nn.functional.norm import torch_batch_norm_forward
from ..core.tensor import Tensor
from ..nn.layer import owner_of
from ..optimizer import ClipGradByGlobalNorm
from ..nn.layer.base import (torch_attributes, torch_buffers,
                              torch_named_buffers, torch_named_parameters,
                              torch_parameters)

DATA_AXES = mesh_mod.DATA_AXES


def _as_tensor(x, device):
    if isinstance(x, Tensor):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    return torch.as_tensor(np.asarray(x), device=device)


def _normalize(inputs, labels):
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    if not isinstance(labels, (list, tuple)):
        labels = [labels]
    return list(inputs), list(labels)


def compute_metrics(metrics, out, labels):
    """Each metric's ``compute(out, *labels)`` under ``no_grad``, as a
    list of lists of what it returned."""
    outs = []
    with torch.no_grad():
        for m in metrics:
            mo = m.compute(out, *labels)
            outs.append(list(mo) if isinstance(mo, (list, tuple))
                        else [mo])
    return outs


def join_metric_outs(parts):
    """Per-micro-batch metric outputs joined along the batch (0-d ones
    stacked), as the JAX step joins them under gradient merge."""
    if len(parts) == 1:
        return parts[0]
    return [[torch.cat([p[i][j] for p in parts]) if parts[0][i][j].dim()
             else torch.stack([p[i][j] for p in parts])
             for j in range(len(parts[0][i]))]
            for i in range(len(parts[0]))]


def meta_replica(module):
    """A structural copy of ``module`` whose parameters and buffers are
    placeholders on the meta device (no memory): the module a rank runs,
    once ``bind`` has put the rank's tensors in."""
    memo = {}
    for p in torch_parameters(module):
        memo[id(p)] = torch.nn.Parameter(torch.empty_like(p, device="meta"),
                                         requires_grad=p.requires_grad)
    for b in torch_buffers(module):
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(module, memo)


def bind(replica, params=None, buffers=None):
    """Put tensors into a replica's parameter / buffer slots by name; a
    tied parameter goes into every slot that shares it."""
    params = params or {}
    if params:
        first = {}
        for name, p in torch_named_parameters(replica, remove_duplicate=False):
            first.setdefault(id(p), name)
        for name, p in torch_named_parameters(replica, remove_duplicate=False):
            if first[id(p)] in params and name not in params:
                params = {**params, name: params[first[id(p)]]}
    for name, t in params.items():
        owner, leaf = owner_of(replica, name)
        owner._parameters[leaf] = t
    for name, t in (buffers or {}).items():
        prefix, _, leaf = name.rpartition(".")
        owner = replica.get_submodule(prefix) if prefix else replica
        owner._buffers[leaf] = t


def rank_pieces(full, spec, mesh, requires_grad=False):
    """One private tensor a rank of this process (None for another's):
    its piece of ``full`` under ``spec`` on its device.  The first rank on
    ``full``'s device whose piece is a contiguous view shares ``full``'s
    storage; every other piece is a copy."""
    devs = mesh.flat_devices
    out, aliased = [], False
    for r in range(mesh.size):
        if not mesh.is_local(r):
            out.append(None)
            continue
        view = full
        for dim, start, n in piece_slices(spec, full.shape, mesh, r):
            view = view.narrow(dim, start, n)
        if not aliased and devs[r] == full.device and view.is_contiguous():
            t = view.detach()
            aliased = True
        else:
            t = view.detach().to(devs[r], copy=True).contiguous()
        out.append(t.requires_grad_(requires_grad))
    return out


def gather_pieces(pieces, spec, mesh, device=None):
    """The logical tensor from each rank's piece (``rank_pieces``'s
    inverse), on ``device`` (default the first piece's).  Over a mesh
    spanning processes each piece comes from the process of its first
    holder, and one cross-process sum puts the disjoint pieces
    together."""
    first = next(p for p in pieces if p is not None)
    dev = device if device is not None else first.device
    shape = list(first.shape)
    for dim, entry in enumerate(spec):
        for a in _axes_of(entry):
            shape[dim] *= mesh.axis_size(a)
    out = (torch.zeros if mesh.spans_processes else torch.empty)(
        shape, dtype=first.dtype, device=dev)
    seen = set()
    for r in range(mesh.size):
        sl = piece_slices(spec, shape, mesh, r)
        key = tuple(s for _, s, _ in sl)
        if key in seen:
            continue
        seen.add(key)
        if pieces[r] is None:
            continue
        view = out
        for dim, start, n in sl:
            view = view.narrow(dim, start, n)
        view.copy_(pieces[r].detach())
    if mesh.spans_processes:
        out = process.all_reduce(out, key=("pieces",), name="gather_pieces")
    return out


def piece_groups(spec, shape, mesh):
    """The ranks grouped by the piece they hold under ``spec`` (rank
    order within a group, groups in order of their first rank)."""
    groups = {}
    for r in range(mesh.size):
        key = tuple(s for _, s, _ in piece_slices(spec, shape, mesh, r))
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def data_representatives(mesh):
    """One rank a data rank, in data order: the rank at index 0 of every
    axis outside ``DATA_AXES`` (its model-parallel group's first)."""
    return [r for r in range(mesh.size)
            if all(v == 0 for a, v in mesh.coords(r).items()
                   if a not in DATA_AXES)]


def split_batch(arrays, mesh):
    """``(per_rank, split)``: each rank's rows of each global batch tensor
    (the data rank's chunk when the leading dim divides over the data
    axes, else the whole tensor) on its device, and whether the first
    tensor split.  Over a mesh spanning processes each array is this
    process's local shard (``mesh.host_local_to_global``, or its
    ``RankPieces``), and only this process's ranks get rows."""
    if mesh.spans_processes:
        per_rank = [[] for _ in range(mesh.size)]
        split = None
        for a in arrays:
            if not isinstance(a, mesh_mod.RankPieces):
                a = mesh_mod.host_local_to_global(a, mesh)
            split = a.split if split is None else split
            for r in mesh.local_ranks:
                per_rank[r].append(a.pieces[r])
        return per_rank, bool(split)
    devs = mesh.flat_devices
    n = mesh_mod.data_axes_size(mesh)
    per_rank = [[] for _ in range(mesh.size)]
    split = None
    for a in arrays:
        spec = mesh_mod.batch_partition_spec(tuple(a.shape), mesh)
        split = bool(spec) if split is None else split
        chunks = a.chunk(n) if spec else None
        for r in range(mesh.size):
            part = chunks[mesh.index_in(r, DATA_AXES)] if spec else a
            per_rank[r].append(_as_tensor(part, devs[r]))
    return per_rank, bool(split)


def _unit_name(model, name):
    """The unit of the parameter ``name`` (module docstring): the path of
    the first module on its path below the root that is not a
    ``ModuleList`` / ``ModuleDict``, or ``""`` for one the root (or such
    a container) owns."""
    mod, path = model, []
    for part in name.split(".")[:-1]:
        mod = mod._modules[part]
        path.append(part)
        if not isinstance(mod, (torch.nn.ModuleList, torch.nn.ModuleDict)):
            return ".".join(path)
    return ""


class _GatherOne(torch.autograd.Function):
    """One rank's whole copy of a stage-3 parameter: its ``sharding``
    group's shards concatenated on ``dim`` on the rank's device, tagged
    with ``key`` (rank, name) for ``_UnitGather.pack``.  The backward
    hands each shard its piece of the rank's gradient at once; the shards
    sum every rank's piece, which is the reduce-scatter."""

    @staticmethod
    def forward(ctx, key, dim, device, *parts):
        ctx.stage3_key = key
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devices = [p.device for p in parts]
        with torch.profiler.record_function("mesh.all_gather"):
            return torch.cat([p.to(device) for p in parts], dim=dim)

    @staticmethod
    def backward(ctx, grad):
        with torch.profiler.record_function("mesh.all_gather.backward"):
            return (None, None, None) + tuple(
                piece.to(dev, copy=True).contiguous() for piece, dev in
                zip(grad.split(ctx.sizes, dim=ctx.dim), ctx.devices))


class _UnitGather:
    """A rank's stage-3 parameters, one unit's at a time: ``get`` returns
    the rank's whole copy of a parameter, gathering its unit first (and
    dropping the unit held before) when another is held.  ``pack`` /
    ``unpack`` are the rank's saved-tensor hooks over its forward: a
    gathered parameter that an op saves for the backward, its cast or a
    view of either, is saved as its name and view and gathered again from
    the shards when the backward reads it."""

    def __init__(self, engine, r):
        self.engine = engine
        self.r = r
        self.unit = None
        self.fulls = {}

    def get(self, k):
        eng = self.engine
        unit = eng.unit_of[k]
        if unit != self.unit:
            self.release()
            self.fulls = {n: eng._gather(self.r, n) for n in eng.units[unit]}
            self.unit = unit
            for n, t in self.fulls.items():
                eng._note_live(self.r, n, t)
        return self.fulls[k]

    def release(self):
        self.unit, self.fulls = None, {}

    def pack(self, t):
        base = t if t._base is None else t._base
        fn, dtype = base.grad_fn, None
        if fn is not None and fn.name() == "ToCopyBackward0" and \
                base.is_contiguous():
            fn, dtype = fn.next_functions[0][0], base.dtype
        key = getattr(fn, "stage3_key", None)
        if key is not None and key[0] == self.r:
            return key[1], dtype, t.size(), t.stride(), t.storage_offset()
        # saved as it is: counted alive while it is, if made of one
        # gathered parameter alone
        fn = t.grad_fn
        while fn is not None:
            key = getattr(fn, "stage3_key", None)
            if key is not None:
                self.engine._note_live(*key, t)
                break
            nxt = fn.next_functions
            fn = nxt[0][0] if len(nxt) == 1 else None
        return t

    def unpack(self, saved):
        if isinstance(saved, torch.Tensor):
            return saved
        k, dtype, size, stride, offset = saved
        with torch.no_grad():
            full = self.engine._gather(self.r, k)
            self.engine._note_live(self.r, k, full)
            if dtype is not None:
                full = full.to(dtype)
            return full.as_strided(size, stride, offset)


class _Stage3Slot(torch.nn.Module):
    """A replica's stage-3 parameter slot, read through its rank's
    ``_UnitGather`` (a parametrization: ``owner.<leaf>`` calls it)."""

    def __init__(self, gather, k):
        super().__init__()
        self.gather, self.k = gather, k

    def forward(self, _meta):
        return self.gather.get(self.k)


_BUCKET = 1 << 27     # elements a crossing of gradients carries at most


def _cross_sums(crossing, name):
    """``(sum, payload)`` for every entry of ``crossing`` — ``{(procs,
    dtype): [(tensor, payload)]}`` — each tensor summed over the
    processes ``procs``: the entries of a key go across flattened
    together in calls of at most ``_BUCKET`` elements, keys in sorted
    order, so every process of a set makes the same calls in the same
    order."""
    out = []
    for (procs, dtype), items in sorted(crossing.items(),
                                        key=lambda kv: (kv[0][0],
                                                        str(kv[0][1]))):
        dev = items[0][0].device
        start = 0
        while start < len(items):
            stop, n = start, 0
            while stop < len(items) and (stop == start or
                                         n + items[stop][0].numel()
                                         <= _BUCKET):
                n += items[stop][0].numel()
                stop += 1
            chunk = items[start:stop]
            flat = torch.cat([t.reshape(-1).to(dev) for t, _ in chunk])
            flat = process.all_reduce(flat, procs, key=(name,) + procs,
                                      name=name)
            off = 0
            for t, payload in chunk:
                out.append((flat[off:off + t.numel()].view(t.shape).to(
                    t.device), payload))
                off += t.numel()
            start = stop
    return out


class _MeshEngine:
    """What the flat and the pipeline engines share.  Each holds
    ``leaves[r]`` (rank ``r``'s tensors under the model's parameter
    names), ``opt_state[r]``, ``buffers[r]``, ``devs``, ``pnames`` and
    ``param_specs``, and says which ranks hold the same piece of a
    parameter (``_groups``), how rank ``r``'s piece of a logical tensor is
    cut (``_local_spec``) and how the pieces make it back
    (``_assemble``).  A step frees the last step's gradients first."""

    def __init__(self, step, mesh):
        self.step_ = step
        self.mesh = mesh
        self.keep_grads = False
        self.last_grads = None
        self.dev0 = mesh.flat_devices[mesh.local_ranks[0]]

    def _free_grads(self):
        for leaves in self.leaves:
            for t in leaves.values():
                t.grad = None

    # -- the update --------------------------------------------------------
    @torch.no_grad()
    def _reduce_and_clip(self):
        """``{name: {rank: gradient}}`` for this process's ranks: each
        trainable parameter's gradient summed over every group of ranks
        holding the same piece (one tensor a group and device; the
        leaves' ``.grad`` freed), then scaled by the optimizer's
        global-norm clip, each piece counted once.  The groups spanning
        processes sum their local parts first, then cross in one call a
        set of processes and dtype (``_cross_sums``)."""
        opt = self.step_.optimizer
        mesh = self.mesh
        red, counted, crossing = {}, [], collections.defaultdict(list)

        def place(k, group, local, tot):
            if mesh.procs[group[0]] == mesh.process:
                counted.append(tot)
            on = {tot.device: tot}
            for r in local:
                if self.devs[r] not in on:
                    on[self.devs[r]] = tot.to(self.devs[r])
                red[k][r] = on[self.devs[r]]

        for k, groups in self._groups().items():
            red[k] = {}
            for group in groups:
                local = [r for r in group if mesh.is_local(r)]
                if not local:
                    continue
                tot = collective._sum_on(
                    [self.leaves[r][k].grad for r in local],
                    self.devs[local[0]])
                if tot is None:
                    tot = torch.zeros_like(self.leaves[local[0]][k])
                for r in local:
                    self.leaves[r][k].grad = None
                if len(local) < len(group):
                    crossing[mesh.procs_of(group), tot.dtype].append(
                        (tot, (k, group, local)))
                else:
                    place(k, group, local, tot)
        for tot, args in _cross_sums(crossing, "grads"):
            place(*args, tot)
        clip = opt._grad_clip
        if clip is not None and (counted or mesh.spans_processes):
            if not isinstance(clip, ClipGradByGlobalNorm):
                raise NotImplementedError(
                    f"TrainStep over a mesh clips by the global norm only, "
                    f"not {type(clip).__name__}")
            sq = sum((g.float().square().sum().to(self.dev0)
                      for g in counted),
                     torch.zeros((), dtype=torch.float32, device=self.dev0))
            if mesh.spans_processes:
                sq = process.all_reduce(sq, key=("clip",), name="clip")
            scale = clip.scale(sq.sqrt())
            for t in {id(t): t for sub in red.values()
                      for t in sub.values()}.values():
                t.mul_(scale.to(t.device).to(t.dtype))
        return red

    @contextlib.contextmanager
    def _updating(self):
        """The step's rate (read once, as the one-device step reads it),
        with the optimizer's step count advanced and its tree form on."""
        opt = self.step_.optimizer
        lr = opt.get_lr()
        opt.last_step_lr = lr
        opt._step_count += 1
        opt._tree = True
        try:
            yield lr
        finally:
            opt._tree = False

    def _update_piece(self, k, target, g, state, lr):
        opt = self.step_.optimizer
        opt._param_names[id(target)] = k
        try:
            with torch.no_grad():
                opt._update(target, g.to(target.dtype), state, lr)
        finally:
            opt._param_names.pop(id(target), None)

    # -- reading the state back ---------------------------------------------
    def _holders(self, per_rank, k):
        return {r: d[k] for r, d in enumerate(per_rank) if k in d}

    def full_param(self, k, device=None):
        return self._assemble(k, self._holders(self.leaves, k),
                              self._local_spec(k), device)

    def full_params(self, device=None):
        return {k: self.full_param(k, device) for k in self.pnames}

    def full_grads(self, device=None):
        """The last step's reduced gradients as logical tensors (needs
        ``keep_grads`` set before the step)."""
        if self.last_grads is None:
            raise RuntimeError("set TrainStep.keep_grads = True before the "
                               "step whose gradients you read")
        return {k: self._assemble(k, sub, self._local_spec(k), device)
                for k, sub in self.last_grads.items()}

    def full_opt_state(self, device=None):
        out = {}
        for k in self.pnames:
            per = self._holders(self.opt_state, k)
            if per:
                out[k] = {sk: self._assemble(
                    k, {r: st[sk] for r, st in per.items()},
                    self._local_spec(k, sk), device)
                    for sk in next(iter(per.values()))}
        return out

    def _piece(self, r, full, spec):
        for dim, start, n in piece_slices(spec, full.shape, self.mesh, r):
            full = full.narrow(dim, start, n)
        return full

    @torch.no_grad()
    def load_full(self, params, opt_state, buffers=None):
        """Re-shard logical parameters, optimizer state and buffers onto
        the ranks."""
        for r, lv in enumerate(self.leaves):
            for k, t in lv.items():
                if k in params:
                    t.copy_(self._piece(r, torch.as_tensor(params[k]),
                                        self._local_spec(k)))
                for sk, v in (opt_state or {}).get(k, {}).items():
                    self.opt_state[r][k][sk].copy_(self._piece(
                        r, torch.as_tensor(v), self._local_spec(k, sk)))
        for k, v in (buffers or {}).items():
            for bufs in self.buffers:
                if k in bufs:
                    bufs[k].copy_(torch.as_tensor(v))

    @torch.no_grad()
    def sync_to_layer(self, model):
        named = dict(torch_named_parameters(model))
        for k in self.pnames:
            named[k].copy_(self.full_param(k, named[k].device))
        named_b = dict(torch_named_buffers(model))
        for k, t in self.full_buffers().items():
            named_b[k].copy_(t)


class _FlatMesh(_MeshEngine):
    """The flat (non-pipeline) step over a ``DeviceMesh`` (module
    docstring)."""

    def __init__(self, step, model, mesh):
        super().__init__(step, mesh)
        s = step.strategy
        opt = step.optimizer
        stage = 0
        if s is not None and getattr(s, "sharding", False):
            stage = int(s.sharding_configs.get("stage", 2))
        min_size = 1024
        if s is not None:
            min_size = int((getattr(s, "sharding_configs", None) or {}).get(
                "min_shard_size", 1024))
        self.stage = stage
        params = dict(torch_named_parameters(model))
        buffers = {k: v for k, v in torch_named_buffers(model)
                   if v is not None}
        self.pnames = sorted(params)
        self.bnames = sorted(buffers)
        spec_map = shard_params_specs(model, stage=stage if stage else 2,
                                      axis="sharding", min_size=min_size,
                                      mesh=mesh)
        if stage < 3:
            for k in self.pnames:
                if getattr(params[k], "partition_spec", None) is None:
                    spec_map[k] = ()
        self.param_specs = {k: tuple(spec_map.get(k, ())) for k in
                            self.pnames}
        flipped = _flipped_linear_weights(model)
        world = mesh.axis_size("sharding")
        self.opt_specs = {}
        self.update_specs = {}
        for k in self.pnames:
            p = params[k]
            pspec = self.param_specs[k]
            jdim0 = p.dim() - 1 if k in flipped and p.dim() >= 2 else 0
            template = opt._init_state(torch.empty_like(p, device="meta"))
            sub, uspec = {}, pspec
            for sk, leaf in template.items():
                if leaf.dim() == 0:
                    sub[sk] = ()
                elif stage >= 1 and world > 1 and pspec == () and \
                        leaf.shape[jdim0] % world == 0:
                    spec = [None] * leaf.dim()
                    spec[jdim0] = "sharding"
                    sub[sk] = uspec = tuple(spec)
                else:
                    sub[sk] = pspec
            self.opt_specs[k] = sub
            self.update_specs[k] = uspec
        self.trainable = {k: params[k].requires_grad for k in self.pnames}
        self.shapes = {k: tuple(params[k].shape) for k in self.pnames}
        self.devs = mesh.flat_devices
        # every rank's pieces, replicas and optimizer state
        self.leaves = [{} for _ in range(mesh.size)]
        for k in self.pnames:
            pieces = rank_pieces(params[k].detach(), self.param_specs[k],
                                 mesh, requires_grad=self.trainable[k])
            for r, t in enumerate(pieces):
                if t is not None:
                    self.leaves[r][k] = t
        self.gathered = [k for k in self.pnames
                         if "sharding" in [a for e in self.param_specs[k]
                                           for a in _axes_of(e)]]
        if self.gathered and mesh.spans_processes:
            raise NotImplementedError(
                "TrainStep: ZeRO stage 3 gathers a unit's parameters "
                "within one process; its sharding groups here span "
                "processes (use stage 2, or keep each sharding group on "
                "one process)")
        self.replicas = [None] * mesh.size
        self.buffers = [{} for _ in range(mesh.size)]
        for r in mesh.local_ranks:
            rep = meta_replica(model)
            bufs = {k: buffers[k].detach().to(self.devs[r], copy=True)
                    for k in self.bnames}
            bind(rep, {k: self.leaves[r][k] for k in self.pnames
                       if k not in self.gathered}, bufs)
            # a torch batch norm normalizes by the whole split batch's
            # statistics, as the port's own BatchNorm layers do
            for mod in rep.modules():
                if isinstance(mod, torch.nn.modules.batchnorm._BatchNorm):
                    mod.forward = types.MethodType(torch_batch_norm_forward,
                                                   mod)
            self.replicas[r] = rep
            self.buffers[r] = bufs
        self.opt_state = [{} for _ in range(mesh.size)]
        for r in mesh.local_ranks:
            for k in self.pnames:
                if self.trainable[k]:
                    self.opt_state[r][k] = opt._init_state(
                        self._target(r, k))
        self.reps = data_representatives(mesh)
        self._outs = {}   # rank -> its forward's output (metrics)
        if self.gathered:
            self._install_units(model)

    # -- pieces ----------------------------------------------------------
    def _target(self, r, k):
        """Rank ``r``'s update piece of parameter ``k``: its leaf, or the
        leaf's slice of the sharded moments."""
        leaf = self.leaves[r][k]
        uspec = self.update_specs[k]
        if uspec == self.param_specs[k]:
            return leaf
        return self._piece(r, leaf, uspec)

    # -- stage 3: a unit at a time (module docstring) ---------------------
    def _install_units(self, model):
        """Each rank's ``_UnitGather`` behind its replica's stage-3
        parameter slots."""
        self.unit_of = {k: _unit_name(model, k) for k in self.gathered}
        self.units = {}
        for k in self.gathered:
            self.units.setdefault(self.unit_of[k], []).append(k)
        self.held = [collections.Counter() for _ in range(self.mesh.size)]
        self.live = [0] * self.mesh.size
        self.max_live_units = {"forward": 0, "backward": 0}
        self._phase = "forward"
        self.gatherers = []
        for r, rep in enumerate(self.replicas):
            gather = _UnitGather(self, r)
            self.gatherers.append(gather)
            first, slots = {}, []
            for name, p in torch_named_parameters(rep, remove_duplicate=False):
                k = first.setdefault(id(p), name)
                if k in self.unit_of:
                    slots.append((name, k))
            with torch_attributes():
                for name, k in slots:
                    owner, leaf = owner_of(rep, name)
                    parametrize.register_parametrization(
                        owner, leaf, _Stage3Slot(gather, k), unsafe=True)

    def _gather(self, r, k):
        """Rank ``r``'s whole copy of the stage-3 parameter ``k``."""
        spec = self.param_specs[k]
        dim = next(i for i, e in enumerate(spec)
                   if "sharding" in _axes_of(e))
        group = self.mesh.group(r, "sharding")
        return _GatherOne.apply((r, k), dim, self.devs[r],
                                *[self.leaves[g][k] for g in group])

    def _note_live(self, r, k, t):
        """Count ``t`` (a gathered copy of ``k``) alive on rank ``r`` until
        it is freed: ``live[r]`` is the number of units with a copy alive;
        keep the most in this phase."""
        held, unit = self.held[r], self.unit_of[k]

        def count(n):
            held[unit] += n
            self.live[r] = sum(1 for c in held.values() if c)

        count(1)
        peak = self.max_live_units
        peak[self._phase] = max(peak[self._phase], self.live[r])
        weakref.finalize(t, count, -1)

    def _release_units(self):
        for gather in getattr(self, "gatherers", ()):
            gather.release()

    # -- the step --------------------------------------------------------
    def _token_count(self, kept):
        """A loss's token-mean denominator on a data rank of a split batch
        (``RankContext.token_count``): the kept tokens of every data rank
        over their number, so that the mean of the data ranks' losses the
        step takes is the whole batch's token mean, as the JAX step's
        one program over the global batch computes it, however unevenly
        the ranks' tokens are masked."""
        n = mesh_mod.data_axes_size(self.mesh)
        return collective.mesh_all_reduce(kept.detach(), DATA_AXES) / n

    def _forward(self, r, ins, labs, split):
        st = self.step_
        if split:
            collective.current_rank().token_count = self._token_count
        rep = self.replicas[r]
        rep.train(st.training)
        gather = self.gatherers[r] if self.gathered else None
        with (torch.autograd.graph.saved_tensors_hooks(gather.pack,
                                                       gather.unpack)
              if gather else contextlib.nullcontext()):
            out = rep(*ins)
            if isinstance(out, tuple):
                out = out[0]
            if st.metrics:
                self._outs[r] = out.detach()
            loss = out if st.loss_fn is None else st.loss_fn(out, *labs)
            aux = collect_moe_aux_loss(rep)
            if aux is not None:
                loss = loss + aux
        if gather:
            gather.release()
        return loss.float()

    def step(self, inputs, labels):
        st = self.step_
        mesh = self.mesh
        xp = mesh.spans_processes
        k = st.grad_merge_k
        self._free_grads()
        if xp:
            if k > 1:
                raise NotImplementedError(
                    "TrainStep: gradient_merge over a mesh spanning "
                    "processes (each process feeds its local shard, which "
                    "the global batch's micro-batches do not split along)")
            micro = [list(inputs) + list(labels)]
        else:
            chunks = [torch.as_tensor(a).chunk(k) for a in inputs + labels]
            if any(len(c) != k for c in chunks):
                raise ValueError(f"TrainStep: gradient_merge k_steps={k} "
                                 "must divide the batch")
            micro = [[c[i] for c in chunks] for i in range(k)]
        dev0 = self.dev0
        total = torch.zeros((), dtype=torch.float32, device=dev0)
        n_in = len(inputs)
        parts = []
        for arrays in micro:
            per_rank, split = split_batch(arrays, mesh)
            self._phase = "forward"
            self._outs = {}
            with st._amp():
                losses = collective.run_ranks(
                    mesh, {r: (lambda r=r: self._forward(
                        r, per_rank[r][:n_in], per_rank[r][n_in:], split))
                        for r in mesh.local_ranks}, batch_split=split)
            if st.metrics:
                parts.append(self._metric_parts(arrays[n_in:], per_rank,
                                                n_in, split))
            self._phase = "backward"
            try:
                if xp:
                    loss = self._local_backward(losses, k)
                else:
                    loss = sum(losses[r].to(dev0) for r in self.reps) / (
                        len(self.reps) * k)
                    loss.backward()
            finally:
                self._release_units()
            total = total + loss.detach()
        self._outs = {}
        st.last_metric_outs = join_metric_outs(parts) if parts else []
        self._apply()
        if xp:
            total = process.all_reduce(total, key=("loss",), name="loss")
        return total

    def _local_backward(self, losses, k):
        """This process's part of the step's backward over a mesh
        spanning processes: every local rank's loss, the data ranks'
        weighted as the one-process step weights them and the others by
        0, so that each local rank runs its backward (and meets its
        groups' cross-process collectives there); returns the local
        ranks' share of the loss."""
        w = 1.0 / (len(self.reps) * k)
        local = self.mesh.local_ranks
        torch.autograd.backward(
            [losses[r] for r in local],
            [torch.full_like(losses[r], w if r in self.reps else 0.0)
             for r in local])
        share = torch.zeros((), dtype=torch.float32, device=self.dev0)
        for r in local:
            if r in self.reps:
                share = share + losses[r].detach().to(self.dev0) * w
        return share

    def _metric_parts(self, labels, per_rank, n_in, split):
        """The metrics' outputs over the whole batch's output: the data
        ranks' rows in order (of every process, gathered, over a mesh
        spanning processes)."""
        st, mesh, dev0 = self.step_, self.mesh, self.dev0
        if not mesh.spans_processes:
            reps = self.reps if split else self.reps[:1]
            out = torch.cat([self._outs[r].to(dev0) for r in reps])
            return compute_metrics(st.metrics, out,
                                   [torch.as_tensor(y).to(dev0)
                                    for y in labels])
        reps = [r for r in self.reps if mesh.is_local(r)]
        if not split:
            r = next(iter(self._outs))
            return compute_metrics(st.metrics, self._outs[r].to(dev0),
                                   [y.to(dev0) for y in per_rank[r][n_in:]])
        mine = [torch.cat([self._outs[r].cpu() for r in reps])] + [
            torch.cat([per_rank[r][n_in + j].cpu() for r in reps])
            for j in range(len(labels))]
        every = process.all_gather_object(mine, key=("metrics",),
                                          name="metrics")
        cat = [torch.cat([e[j] for e in every]).to(dev0)
               for j in range(len(mine))]
        return compute_metrics(st.metrics, cat[0], cat[1:])

    def _groups(self):
        return {k: piece_groups(self.param_specs[k], self.shapes[k],
                                self.mesh)
                for k in self.pnames if self.trainable[k]}

    def _apply(self):
        red = self._reduce_and_clip()

        def update(r, lr):
            ctx = collective.current_rank()
            for k in self.pnames:
                if not self.trainable[k]:
                    continue
                uspec = self.update_specs[k]
                g = red[k][r]
                if uspec != self.param_specs[k]:
                    g = self._piece(r, g, uspec)
                ctx.norm_axes = tuple(a for e in uspec for a in _axes_of(e))
                try:
                    self._update_piece(k, self._target(r, k), g,
                                       self.opt_state[r][k], lr)
                finally:
                    ctx.norm_axes = ()

        with self._updating() as lr:
            collective.run_ranks(self.mesh, {
                r: (lambda r=r: update(r, lr))
                for r in self.mesh.local_ranks})
        self._gather_moments_back()
        self.last_grads = red if self.keep_grads else None

    @torch.no_grad()
    def _gather_moments_back(self):
        """Every rank's full copy of a moment-sharded parameter takes the
        slices its ``sharding`` group updated.  A group spanning processes
        puts its members' disjoint slices together in one cross-process
        sum of the zero-padded full tensor (``_cross_sums``): an all-gather
        of the slices alone crosses half the bytes, but gloo's all-gather
        made the step slower on the card (PERF.md, PR 20)."""
        mesh = self.mesh
        crossing = collections.defaultdict(list)
        for k in self.pnames:
            uspec = self.update_specs[k]
            if not self.trainable[k] or uspec == self.param_specs[k]:
                continue
            shape = self.leaves[mesh.local_ranks[0]][k].shape
            done = set()
            for r in mesh.local_ranks:
                group = tuple(mesh.group(r, "sharding"))
                local = [g for g in group if mesh.is_local(g)]
                if len(local) == len(group):
                    for r2 in group:
                        if r2 == r:
                            continue
                        for dim, start, n in piece_slices(uspec, shape,
                                                          mesh, r2):
                            self.leaves[r][k].narrow(dim, start, n).copy_(
                                self.leaves[r2][k].narrow(dim, start, n))
                elif group not in done:
                    done.add(group)
                    buf = torch.zeros_like(self.leaves[r][k])
                    for r2 in local:
                        for dim, start, n in piece_slices(uspec, shape,
                                                          mesh, r2):
                            buf.narrow(dim, start, n).copy_(
                                self.leaves[r2][k].narrow(dim, start, n))
                    crossing[mesh.procs_of(group), buf.dtype].append(
                        (buf, (k, local)))
        for full, (k, local) in _cross_sums(crossing, "moments"):
            for r in local:
                self.leaves[r][k].copy_(full)

    # -- reading the state back ---------------------------------------------
    def _local_spec(self, k, sk=None):
        return self.param_specs[k] if sk is None else self.opt_specs[k][sk]

    def _assemble(self, k, by_rank, spec, device=None):
        return gather_pieces([by_rank.get(r) for r in range(self.mesh.size)],
                             spec, self.mesh, device)

    def full_buffers(self):
        return dict(self.buffers[self.mesh.local_ranks[0]])


class TrainStep:
    """Train step over a model and an optimizer of the port, on one
    device or over a mesh (see the module docstring)."""

    def __init__(self, model, optimizer, loss_fn=None, strategy=None,
                 mesh=None, amp_level=None, donate=True, train=True,
                 metrics=None, device=None):
        from ..distributed.fleet.meta_parallel import PipelineLayer
        from ..distributed.parallel import DataParallel
        self.metrics = list(metrics or [])
        self.last_metric_outs = []
        if isinstance(model, DataParallel):
            model = model._layers
        s = strategy
        self.grad_merge_k = 1
        if s is not None and getattr(s, "gradient_merge", False):
            self.grad_merge_k = int(
                s.gradient_merge_configs.get("k_steps", 1))
        self.use_amp = bool(amp_level) or bool(s and getattr(s, "amp",
                                                             False))
        amp_configs = (getattr(s, "amp_configs", None) or {}) if s else {}
        self.amp_level = amp_level or (
            "O2" if amp_configs.get("use_pure_fp16") else "O1")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.strategy = strategy
        self.training = train
        self.mesh = mesh if mesh is not None else mesh_mod.get_mesh()
        optimizer.bind_names(torch_named_parameters(model))
        self._m_steps = monitor.counter("train.steps",
                                        "TrainStep.step calls")
        self._m_step_time = monitor.histogram(
            "train.step_time_ms",
            "host-side dispatch time per train step (ms)")
        self.is_pipeline = (self.mesh is not None
                            and isinstance(model, PipelineLayer)
                            and self.mesh.axis_size("pp") > 1)
        if self.is_pipeline:
            from .pipeline import PipelineEngine
            self.engine = PipelineEngine(self, model, self.mesh)
            self.device = self.engine.dev0
        elif self.mesh is not None:
            self.engine = _FlatMesh(self, model, self.mesh)
            self.device = self.engine.dev0
        else:
            self.engine = None
            self.device = require_on(device, torch_named_parameters(model),
                                     "TrainStep")

    # -- what the JAX step exposes -----------------------------------------
    @property
    def param_specs(self):
        """Each parameter's spec (in its own layout); on one device every
        parameter is whole, ``()``."""
        if self.engine is None:
            return {k: () for k, _ in torch_named_parameters(self.model)}
        return self.engine.param_specs

    @property
    def opt_specs(self):
        return self._mesh_engine("opt_specs").opt_specs

    def _mesh_engine(self, what):
        if self.engine is None:
            raise ValueError(f"TrainStep.{what} belongs to a step over a "
                             "mesh; on one device the model's own tensors "
                             "and .grad are the step's")
        return self.engine

    @property
    def keep_grads(self):
        return bool(self.engine and self.engine.keep_grads)

    @keep_grads.setter
    def keep_grads(self, value):
        self._mesh_engine("keep_grads").keep_grads = bool(value)

    def full_grads(self, device=None):
        """Over a mesh: the last step's reduced gradients, gathered to
        logical tensors (set ``keep_grads = True`` before that step)."""
        return self._mesh_engine("full_grads").full_grads(device)

    def _amp(self):
        return (amp.auto_cast(enable=True, level=self.amp_level)
                if self.use_amp else contextlib.nullcontext())

    def _loss(self, inputs, labels, parts=None):
        """The loss of one forward; with ``metrics`` the metrics' outputs
        of it are appended to ``parts``."""
        with self._amp():
            out = self.model(*inputs)
            if isinstance(out, tuple):
                out = out[0]
            loss = out if self.loss_fn is None \
                else self.loss_fn(out, *labels)
            aux = collect_moe_aux_loss(self.model)
            if aux is not None:
                loss = loss + aux
        if self.metrics:
            parts.append(compute_metrics(self.metrics, out, labels))
        return loss.float()

    def step(self, inputs, labels=()):
        """One optimization step on a global batch; returns the f32
        loss."""
        t0 = time.perf_counter()
        inputs, labels = _normalize(inputs, labels)
        if self.engine is not None:
            loss = self.engine.step(inputs, labels)
        else:
            loss = self._step_one_device(inputs, labels)
        self._m_steps.inc()
        self._m_step_time.observe((time.perf_counter() - t0) * 1e3)
        return loss

    def _step_one_device(self, inputs, labels):
        inputs = [_as_tensor(x, self.device) for x in inputs]
        labels = [_as_tensor(x, self.device) for x in labels]
        self.model.train(self.training)
        self.optimizer.zero_grad(set_to_none=True)
        k = self.grad_merge_k
        parts = []
        if k == 1:
            loss = self._loss(inputs, labels, parts)
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
                                  [c[i] for c in micro_lab], parts) / k
                part.backward()
                loss = loss + part.detach()
        self.last_metric_outs = join_metric_outs(parts) if parts else []
        self.optimizer.apply_gradients()
        return loss

    def sync_to_layer(self):
        """Write a mesh's shards (parameters, and buffers) back into the
        model; on one device the model's parameters are the step's, and
        there is nothing to do."""
        if self.engine is not None:
            self.engine.sync_to_layer(self.model)
