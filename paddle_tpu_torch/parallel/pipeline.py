"""Pipeline-parallel training: the GPipe and 1F1B schedules over a mesh's
``pp`` axis — counterpart of ``paddle_tpu/parallel/pipeline.py``.

The JAX package stacks the identical blocks' parameters on a leading
``pp``-sharded axis and runs ONE ``shard_map`` program that rotates
activations around the ring with ``ppermute``.  The port keeps the
schedule and drives the stages from one controller: stage ``s`` of a
pipeline (the mesh rank at ``pp = s`` of the pipeline's coordinates)
holds blocks ``s * bps .. (s + 1) * bps`` as its own modules (replicas
of the model's blocks holding the stage's tensors on its device), and an
activation or a cotangent moves to the next stage with ``.to`` (a copy
between cards, nothing on one).  ``pre`` and ``post`` are replicated:
every stage holds a copy, ``pre`` runs on stage 0 and ``post`` on the
last, and their gradients are summed over the stages (the others
contribute nothing) before every copy takes the same update.  A tick
whose calls may meet in a collective (below) runs them as ranks of the
mesh (``collective.run_ranks``); any other runs them in turn on the
controller (a rank thread costs milliseconds of host time a call).

* **GPipe** (``schedule_mode`` "F-then-B", the default): ``pre`` over the
  whole batch, then ``M + P - 1`` forward ticks, stage ``s`` running
  micro-batch ``t - s`` at tick ``t``; ``post`` and the loss over the
  whole batch's output; one ``backward`` through it all.  Under
  ``strategy.recompute`` each tick's stage forward is recomputed in
  backward (``fleet.utils.recompute``): live state O(M) stage inputs.
* **1F1B** (``build``: "1F1B"): each tick one forward (no graph; the
  stage's input is stored) and one backward: stage ``s`` runs the
  forward of micro-batch ``t - s`` and the backward of ``t - (2P - 1 -
  s)``, which recomputes the stage forward from the stored input and
  runs ``torch.autograd.backward(stage_out, cotangent from stage s +
  1)`` (on the last stage, of ``post`` + the micro-batch's loss / M).
  At most ``2P - 1`` inputs a stage are stored between ticks
  (``max_stored_inputs``, the most seen): live activations O(P), not
  O(M).  The loss is the mean of the micro-batch losses (GPipe's
  whole-batch loss for a mean criterion over equal micro-batches), and
  exactly one labels array is accepted, as in the JAX package.

Buffers (BN running statistics) advance once per real micro-batch: in
the forward tick, never in a recomputation (GPipe's restores them after
it; 1F1B's runs against them and restores them).  1F1B's recomputation
sees the buffers after every forward of the step, where its forward
saw them mid-step, which is sound only when the training forward never
READS a buffer's value (BN writes its statistics but normalizes with
the batch's): the first step checks that per stage of every pipeline,
running the forward once more with every buffer set to NaN, and refuses
a stage whose activation changes, as the JAX package's
``_check_recompute_buffer_safety`` refuses it.

Beside ``pp`` the JAX program runs the same pipeline on every coordinate
of the other axes, each over the whole global batch (its micro-batches
at ``P()``), every stage's blocks whole, ``pre`` and ``post`` under their
own ``partition_spec``.  The port keeps its numbers and splits the work:

* over the data axes (``dp`` x ``sharding``) one pipeline a data rank,
  numbered as ``mesh.index_in`` numbers them.  Micro-batch ``m`` stays
  the rows ``[m * mb, (m + 1) * mb)`` of the batch, and pipeline ``d``
  runs its ``d``-th equal share of every micro-batch's rows (when ``mb``
  divides over the data ranks; else pipeline 0 runs whole micro-batches
  and the others take its update).  A tick runs the same stage of every
  pipeline together with the batch split (``RankContext.batch_split``),
  so a batch norm normalizes by the whole micro-batch
  (``nn.functional.norm``), and a loss's token mean divides by the kept
  tokens of every pipeline's rows: the whole batch's under GPipe, the
  micro-batch's under 1F1B.  The step's loss is the mean of the
  pipelines' losses, and each gradient is summed over the pipelines;
* ``mp``: the blocks run whole once, on the rank at mp index 0.  A
  ``pre`` or ``post`` with a parameter whose ``partition_spec`` names
  ``mp`` (``VocabParallelEmbedding``, a column-parallel head) runs on
  every rank of its mp group with that rank's piece, through the
  tensor-parallel layers' collectives, as the flat step runs them; its
  update's norms (``Lamb``, ``LarsMomentum``) cover the whole parameter.
  Blocks with a parameter split over ``mp`` refuse a mesh with mp > 1
  (``ValueError``), as the JAX ``shard_map`` refuses their sharding
  constraints;
* ``sp``, ``ep`` (and ``mp`` around dense ends) hold replicas, which the
  port computes once.

Over a mesh spanning processes (``distributed/mesh.py``) every process
runs the same schedule and does the work of its own ranks: every process
feeds the identical global batch (``mesh.global_from_replicated``
semantics, checked once by a digest, ``ValueError`` on different
batches), and an activation or a cotangent whose next stage lives in
another process goes across by ``process.send`` / ``recv`` under a key
naming the step, pipeline, stage and micro-batch.  GPipe then cuts its
graph at every such boundary: the forward ticks hand activations over,
the local last stages run the loss's backward, and a loop from the last
stage down hands each received input's gradient back and runs each sent
output's backward against the cotangent that comes back.  1F1B hands its
activations and cotangents over at the end of each tick's forward and
backward sub-ticks.  Each receive waits only on a send of the same tick
(or an earlier one), so the schedule cannot deadlock; every process runs
each tick's rank calls, with or without work of its own there, so that
``run_ranks`` is called in step everywhere.  The gradients of
groups spanning processes (``pre`` and ``post``'s copies, a stage over
data ranks of several processes) sum across in the shared
``_reduce_and_clip``, and the step's loss is summed over the processes.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import warnings

import torch

from ..distributed import collective, process
from ..distributed.fleet.utils import recompute
from ..distributed.mesh import DATA_AXES, data_axes_size
from ..distributed.sharding import _axes_of, piece_slices
from .train_step import (_as_tensor, _MeshEngine, bind, compute_metrics,
                         meta_replica)
from ..nn.layer.base import (torch_named_buffers, torch_named_parameters,
                              torch_parameters)


def _owned(t, device, taken):
    """A private leaf for one stage: ``t``'s storage for the first taker
    on its device, else a copy on ``device``."""
    if device == t.device and id(t) not in taken:
        taken.add(id(t))
        return t.detach()
    return t.detach().to(device, copy=True)


def _names_mp(spec):
    return "mp" in [a for e in (spec or ()) for a in _axes_of(e)]


class PipelineEngine(_MeshEngine):
    """The pipeline path of ``TrainStep`` (module docstring)."""

    def __init__(self, step, model, mesh):
        super().__init__(step, mesh)
        pp = mesh.axis_size("pp")
        mp = mesh.axis_size("mp")
        nblocks = len(model.blocks)
        if nblocks % pp:
            raise ValueError(f"n_blocks {nblocks} must divide pp degree "
                             f"{pp}")
        for i, blk in enumerate(model.blocks):
            for n, p in torch_named_parameters(blk):
                spec = getattr(p, "partition_spec", None)
                if mp > 1 and _names_mp(spec):
                    raise ValueError(
                        f"TrainStep: a pipeline runs every stage's blocks "
                        f"whole, but blocks.{i}.{n} is split over mp "
                        f"({spec}) on a mesh with mp={mp}; the JAX "
                        "package's shard_map refuses that sharding "
                        "constraint too.  Keep the blocks dense (a "
                        "tensor-parallel pre or post is fine).")
        self.pp = pp
        self.bps = nblocks // pp
        s = step.strategy
        M, schedule = 1, "F-then-B"
        if s is not None and getattr(s, "pipeline", False):
            cfg = s.pipeline_configs
            M = int(cfg.get("accumulate_steps", 1))
            schedule = str(cfg.get("schedule_mode",
                                   cfg.get("schedule", "F-then-B")))
        self.num_microbatches = max(M, 1)
        self.schedule = "1F1B" if schedule.upper() == "1F1B" else "F-then-B"
        self.use_remat = bool(s is not None and getattr(s, "recompute",
                                                        False))
        self.n_data = data_axes_size(mesh)
        self.devs = mesh.flat_devices
        # each end's mp ranks: its mp group when it holds an mp piece
        self.end_mp = {}
        self.local_specs = {}
        for end in ("pre", "post"):
            mod = getattr(model, end)
            tp = mod is not None and mp > 1 and any(
                _names_mp(getattr(p, "partition_spec", None))
                for p in torch_parameters(mod))
            self.end_mp[end] = mp if tp else 1
            for n, p in (torch_named_parameters(mod) if mod is not None
                         else ()):
                spec = getattr(p, "partition_spec", None)
                self.local_specs[f"{end}.{n}"] = tuple(spec) if tp and \
                    _names_mp(spec) else ()
        self.xp = mesh.spans_processes
        if self.xp:
            for end, j in self.end_mp.items():
                for d in range(self.n_data):
                    for st in range(pp):
                        if len(mesh.procs_of([self.rank(d, st, i)
                                              for i in range(j)])) > 1:
                            raise NotImplementedError(
                                f"pipeline: {end}'s mp group of stage "
                                f"{st} spans processes; keep each "
                                "stage's mp ranks on one process")
        taken = set()
        self.leaves = [{} for _ in range(mesh.size)]
        self.buffers = [{} for _ in range(mesh.size)]
        self.stage_of, self.shapes = {}, {}
        # every rank holding each parameter (this process's or not)
        self.holds = collections.defaultdict(list)
        self.trainable = {}
        # stages[d][s]: pipeline d's stage s, a list of block replicas
        self.stages = [[[] for _ in range(pp)] for _ in range(self.n_data)]
        for i, blk in enumerate(model.blocks):
            st = i // self.bps
            for n, p in torch_named_parameters(blk):
                self.stage_of[f"blocks.{i}.{n}"] = st
                self.local_specs[f"blocks.{i}.{n}"] = ()
                self.shapes[f"blocks.{i}.{n}"] = tuple(p.shape)
                self.trainable[f"blocks.{i}.{n}"] = p.requires_grad
            for d in range(self.n_data):
                r = self.rank(d, st)
                for n, _ in torch_named_parameters(blk):
                    self.holds[f"blocks.{i}.{n}"].append(r)
                if not mesh.is_local(r):
                    continue
                rep = meta_replica(blk)
                params = {}
                for n, p in torch_named_parameters(blk):
                    t = _owned(p, self.devs[r], taken).requires_grad_(
                        p.requires_grad)
                    params[n] = t
                    self.leaves[r][f"blocks.{i}.{n}"] = t
                bufs = {n: b.detach().to(self.devs[r], copy=True)
                        for n, b in torch_named_buffers(blk) if b is not None}
                bind(rep, params, bufs)
                for n, b in bufs.items():
                    self.buffers[r][f"blocks.{i}.{n}"] = b
                self.stages[d][st].append(rep)
        # ends[end][d][s][j]: the replica on rank (d, s, mp j), or None
        self.ends = {}
        for end in ("pre", "post"):
            mod = getattr(model, end)
            if mod is None:
                self.ends[end] = None
                continue
            for n, p in torch_named_parameters(mod):
                self.stage_of[f"{end}.{n}"] = 0 if end == "pre" else pp - 1
                self.shapes[f"{end}.{n}"] = tuple(p.shape)
                self.trainable[f"{end}.{n}"] = p.requires_grad
                for d in range(self.n_data):
                    for st in range(pp):
                        for j in range(self.end_mp[end]):
                            self.holds[f"{end}.{n}"].append(
                                self.rank(d, st, j))
            self.ends[end] = [[[self._end_replica(mod, end, d, st, j, taken)
                                for j in range(self.end_mp[end])]
                               for st in range(pp)]
                              for d in range(self.n_data)]
        opt = step.optimizer
        self.opt_state = [{k: opt._init_state(t) for k, t in lv.items()
                           if t.requires_grad} for lv in self.leaves]
        self.holders = [r for r, lv in enumerate(self.leaves) if lv]
        self.pnames = sorted(self.stage_of)
        self.param_specs = {k: ("pp",) if k.startswith("blocks.")
                            else self.local_specs[k] for k in self.pnames}
        self.opt_specs = {}
        self._checked = set()
        self._fed = False
        self._steps = 0
        self.max_stored_inputs = 0
        self._post_outs = {}   # data rank -> post's output (metrics)

    def rank(self, d, s, j=0):
        """The mesh rank of pipeline ``d``'s stage ``s`` at mp index
        ``j``."""
        n_sh = self.mesh.axis_size("sharding")
        return self.mesh.rank_of({"dp": d // n_sh, "sharding": d % n_sh,
                                  "pp": s, "mp": j})

    def _end_replica(self, mod, end, d, st, j, taken):
        r = self.rank(d, st, j)
        if not self.mesh.is_local(r):
            return None
        rep = meta_replica(mod)
        params = {}
        for n, p in torch_named_parameters(mod):
            k = f"{end}.{n}"
            spec = self.local_specs[k]
            t = (self._piece(r, p.detach(), spec).to(
                self.devs[r], copy=True).contiguous() if spec
                 else _owned(p, self.devs[r], taken))
            params[n] = self.leaves[r][k] = t.requires_grad_(
                p.requires_grad)
        bind(rep, params, {n: b.detach().to(self.devs[r], copy=True)
                           for n, b in torch_named_buffers(mod)
                           if b is not None})
        return rep

    def _replicas(self):
        for pipe in self.stages:
            for reps in pipe:
                yield from reps
        for per_end in self.ends.values():
            for pipe in per_end or ():
                for reps in pipe:
                    yield from (r for r in reps if r is not None)

    def _local(self, d, s):
        return self.mesh.is_local(self.rank(d, s))

    def _proc(self, d, s):
        return self.mesh.procs[self.rank(d, s)]

    # -- stages ----------------------------------------------------------
    def _run(self, fns, n, mp=1):
        """``fns`` (rank -> function) run as ranks of the mesh, the batch
        split over the data axes, when ``n`` pipelines run or ``mp``
        ranks hold an end's pieces (the ranks then meet in the batch
        norm's or the loss's sums, or the tensor-parallel layers'
        collectives); else in turn, here."""
        if n == 1 and mp == 1:
            return {r: fn() for r, fn in fns.items()}
        return collective.run_ranks(self.mesh, fns, batch_split=n > 1)

    def _run_stage(self, d, s, h):
        for blk in self.stages[d][s]:
            h = blk(h)
        return h

    @contextlib.contextmanager
    def _frozen_buffers(self, r):
        """Rank ``r``'s buffers as they are now, restored on exit: a
        recomputation does not advance them again."""
        saved = [(b, b.clone()) for b in self.buffers[r].values()]
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in saved:
                    b.copy_(v)

    def _stage_call(self, d, s, x):
        if not self.use_remat:
            return self._run_stage(d, s, x)
        calls = [0]

        def body(h):
            calls[0] += 1
            if calls[0] == 1:
                return self._run_stage(d, s, h)
            with self._frozen_buffers(self.rank(d, s)):
                return self._run_stage(d, s, h)

        return recompute(body, x)

    def _check_buffer_reads(self, d, s, x):
        """1F1B's guard (module docstring), on each stage of each pipeline
        at its first forward, with that forward's input: refuse a stage
        whose training forward reads a buffer's value."""
        if (d, s) in self._checked or not self.step_.training:
            return
        if self.buffers[self.rank(d, s)]:
            self._check_stage(d, s, x.detach())
        self._checked.add((d, s))

    def _check_stage(self, d, s, xs):
        owners = []
        for rep in self.stages[d][s]:
            for mod in rep.modules():
                for leaf, b in mod._buffers.items():
                    if b is not None:
                        owners.append((mod, leaf, b))
        outs = []
        for poison in (False, True):
            for mod, leaf, b in owners:
                c = b.clone()
                if poison and c.is_floating_point():
                    c.fill_(float("nan"))
                elif poison:
                    c.add_(1)
                mod._buffers[leaf] = c
            with torch.no_grad(), torch.random.fork_rng(
                    devices=[dv.index for dv in set(self.devs)
                             if dv.type == "cuda"]):
                torch.manual_seed(0)
                outs.append(self._run_stage(d, s, xs))
        for mod, leaf, b in owners:
            mod._buffers[leaf] = b
        same = torch.equal(outs[0], outs[1]) if outs[0].dtype != \
            torch.bool else bool((outs[0] == outs[1]).all())
        if not same:
            raise NotImplementedError(
                f"1F1B: stage {s}'s TRAINING forward reads buffer "
                "values; the per-tick recompute would replay it against "
                "buffers other than the forward saw and silently diverge "
                "from the actual forward.  Use the GPipe schedule "
                "(schedule_mode='F-then-B') for buffer-READING training "
                "forwards.")

    # -- the step --------------------------------------------------------
    def _set_train(self):
        mode = self.step_.training
        for rep in self._replicas():
            rep.train(mode)

    def _loss(self, out, labels):
        fn = self.step_.loss_fn
        loss = out if fn is None else fn(out, *labels)
        return loss.float()

    def _rows(self, a, n, s):
        """Each running pipeline's rows of every micro-batch of ``a`` (its
        share of each, in micro-batch order), on its stage ``s``'s
        device (None where that stage is another process's)."""
        if n == 1:
            return [a.to(self.devs[self.rank(0, s)])
                    if self._local(0, s) else None]
        M = self.num_microbatches
        idx = torch.arange(a.shape[0], device=a.device).view(M, n, -1)
        return [a.index_select(0, idx[:, d].reshape(-1)).to(
            self.devs[self.rank(d, s)]) if self._local(d, s) else None
            for d in range(n)]

    def _check_feed(self, inputs, labels):
        """Over a mesh spanning processes, once: every process must feed
        the identical global batch (module docstring)."""
        if self._fed or not self.xp:
            return
        self._fed = True
        mine = process.digest(list(inputs) + list(labels))
        if len(set(process.all_gather_object(
                mine, key=("feed",), name="feed digest"))) > 1:
            raise ValueError(
                "multi-host pipeline: processes fed DIFFERENT batches. "
                "The pp ring spans hosts, so every process must feed the "
                "identical GLOBAL batch (not its local dp shard) — load "
                "the same data on all ranks of a dp group")

    def step(self, inputs, labels):
        st = self.step_
        self._free_grads()
        self._set_train()
        self._check_feed(inputs, labels)
        self._steps += 1
        P, M = self.pp, self.num_microbatches
        x = _as_tensor(inputs[0], self.dev0 if self.xp
                       else self.devs[self.rank(0, 0)])
        if x.shape[0] % M:
            raise ValueError(f"pipeline: accumulate_steps={M} must divide "
                             f"the batch ({x.shape[0]})")
        n = self.n_data if (x.shape[0] // M) % self.n_data == 0 else 1
        xs = self._rows(x, n, 0)
        last = self.dev0 if self.xp else self.devs[self.rank(0, P - 1)]
        ys = [self._rows(_as_tensor(y, last), n, P - 1) for y in labels]
        labs = [[y[d] for y in ys] for d in range(n)]
        self._post_outs = {}
        with st._amp():
            h = self._pre(xs, n)
            if self.schedule == "1F1B":
                loss = self._one_f_one_b(h, labs, n)
            else:
                loss = self._gpipe(h, labs, n)
        st.last_metric_outs = []
        if st.metrics and self.schedule == "1F1B":
            warnings.warn(
                "TrainStep(metrics=...) under the 1F1B schedule: the "
                "model output never materializes (loss is consumed "
                "per-microbatch inside the schedule), so metrics are not "
                "computed — use GPipe (schedule_mode='F-then-B') or "
                "evaluate() for metrics")
        elif st.metrics:
            if self.xp:
                raise NotImplementedError(
                    "TrainStep(metrics=...) over a pipeline spanning "
                    "processes: the last stage's outputs live on other "
                    "processes; evaluate() instead")
            st.last_metric_outs = compute_metrics(
                st.metrics, self._batch_rows(n, x.shape[0]),
                [_as_tensor(y, last) for y in labels])
        self._post_outs = {}
        self._apply()
        if self.xp:
            loss = process.all_reduce(loss.to(self.dev0), key=("loss",),
                                      name="loss")
        return loss

    def _batch_rows(self, n, rows):
        """The running pipelines' ``post`` outputs (``_rank_loss``) put
        back in the batch's row order: the inverse of ``_rows``."""
        outs = [self._post_outs[d] for d in range(n)]
        if n == 1:
            return outs[0]
        dev = outs[0].device
        idx = torch.arange(rows, device=dev).view(
            self.num_microbatches, n, -1)
        full = outs[0].new_empty((rows,) + tuple(outs[0].shape[1:]))
        for d in range(n):
            full[idx[:, d].reshape(-1)] = outs[d].to(dev)
        return full

    def _pre(self, xs, n):
        """``pre`` over each running pipeline's rows, on its mp group
        when it holds mp pieces; the activations of mp index 0."""
        pre = self.ends["pre"]
        if pre is None:
            return xs
        fns = {}
        for d in range(n):
            if xs[d] is None:
                continue
            for j in range(self.end_mp["pre"]):
                r = self.rank(d, 0, j)
                fns[r] = functools.partial(pre[d][0][j],
                                           xs[d].to(self.devs[r]))
        outs = self._run(fns, n, self.end_mp["pre"])
        return [outs.get(self.rank(d, 0)) for d in range(n)]

    def _token_count(self, n, kept):
        """A loss's token-mean denominator on a pipeline's last stage: the
        kept tokens of every running pipeline over their number
        (``RankContext.token_count``)."""
        return collective.mesh_all_reduce(kept.detach(), DATA_AXES) / n

    def _rank_loss(self, d, j, n, out, labels):
        if n > 1:
            collective.current_rank().token_count = functools.partial(
                self._token_count, n)
        post = self.ends["post"]
        if post is not None:
            out = post[d][self.pp - 1][j](out)
        if j == 0 and self.step_.metrics:
            self._post_outs[d] = out.detach()
        return self._loss(out, labels)

    def _post_loss(self, outs, labs, n):
        """The mean over the running pipelines of ``post`` and the loss
        over each one's rows (``post`` on its mp group when it holds mp
        pieces; the loss of mp index 0)."""
        P = self.pp
        fns = {}
        for d in range(n):
            if outs[d] is None:
                continue
            for j in range(self.end_mp["post"]):
                r = self.rank(d, P - 1, j)
                dev = self.devs[r]
                fns[r] = functools.partial(
                    self._rank_loss, d, j, n, outs[d].to(dev),
                    [y.to(dev) for y in labs[d]])
        res = self._run(fns, n, self.end_mp["post"])
        mine = [d for d in range(n) if outs[d] is not None]
        if not mine:
            return torch.zeros((), dtype=torch.float32, device=self.dev0)
        dev = self.devs[self.rank(mine[0], P - 1)]
        return sum(res[self.rank(d, P - 1)].to(dev) for d in mine) / n

    def _gpipe(self, h, labs, n):
        P, M = self.pp, self.num_microbatches
        carry = [list(hd.chunk(M)) if hd is not None else [None] * M
                 for hd in h]
        sent, recvd, works = {}, {}, []
        for t in range(M + P - 1):
            work = {}
            for s in range(P):
                m = t - s
                if 0 <= m < M:
                    for d in range(n):
                        r = self.rank(d, s)
                        if self.mesh.is_local(r):
                            work[r] = (d, s, m, functools.partial(
                                self._stage_call, d, s,
                                carry[d][m].to(self.devs[r])))
            outs = self._run({r: w[3] for r, w in work.items()}, n)
            for r, (d, s, m, _) in work.items():
                carry[d][m] = outs[r]
            if self.xp:
                works += self._hand_acts(t, n, carry, sent, recvd)
        loss = self._post_loss([torch.cat(c) if c[0] is not None else None
                                for c in carry], labs, n)
        if loss.requires_grad:
            loss.backward()
        if self.xp:
            for s in range(P - 2, -1, -1):
                for (d, s1, m), leaf in recvd.items():
                    if s1 == s + 1:
                        g = leaf.grad if leaf.grad is not None else \
                            torch.zeros_like(leaf)
                        works += process.send(g, self._proc(d, s),
                                              self._key("cot", d, s, m))
                outs, cots = [], []
                for (d, s0, m), out in sent.items():
                    if s0 == s:
                        outs.append(out)
                        cots.append(process.recv(
                            self._proc(d, s + 1), self._key("cot", d, s, m),
                            out.device))
                if outs:
                    torch.autograd.backward(outs, cots)
            process.wait(works)
        return loss.detach()

    def _key(self, kind, d, s, m):
        return (kind, self._steps, d, s, m)

    def _hand_acts(self, t, n, carry, sent, recvd):
        """GPipe's hand-over after forward tick ``t`` (module docstring):
        a local stage's output whose next stage is another process's goes
        across (kept in ``sent`` for the backward), and a local stage's
        input made by another process comes in as a leaf (``recvd``)."""
        P, M = self.pp, self.num_microbatches
        works = []
        for s in range(P - 1):
            m = t - s
            if not 0 <= m < M:
                continue
            for d in range(n):
                here, there = self._local(d, s), self._local(d, s + 1)
                if here and not there:
                    sent[d, s, m] = carry[d][m]
                    works += process.send(carry[d][m].detach(),
                                          self._proc(d, s + 1),
                                          self._key("act", d, s + 1, m))
                    carry[d][m] = None
                elif there and not here:
                    x = process.recv(self._proc(d, s),
                                     self._key("act", d, s + 1, m),
                                     self.devs[self.rank(d, s + 1)])
                    x.requires_grad_(torch.is_grad_enabled())
                    recvd[d, s + 1, m] = carry[d][m] = x
        return works

    def _hand_over(self, kind, t, items, into, step):
        """1F1B's hand-over at the end of tick ``t``'s forward (``step``
        +1, activations) or backward (-1, cotangents) sub-ticks: each item
        ``(d, s) -> tensor`` made here for a stage of this process moves
        to its device, one for another process goes across, and the items
        other processes made for this one come in."""
        P = self.pp
        works = []
        for (d, s), x in items.items():
            if self._local(d, s):
                into[d, s] = x.to(self.devs[self.rank(d, s)])
            else:
                works += process.send(x, self._proc(d, s),
                                      self._key(kind, d, s, t))
        if not self.xp:
            return works
        for src in range(P):
            dst = src + step
            if not 0 <= dst < P or not self._made(kind, t, src):
                continue
            for d in range(self._n):
                if self._local(d, dst) and not self._local(d, src):
                    into[d, dst] = process.recv(
                        self._proc(d, src), self._key(kind, d, dst, t),
                        self.devs[self.rank(d, dst)])
        return works

    def _made(self, kind, t, s):
        """Whether stage ``s`` runs a micro-batch in tick ``t``'s forward
        (``act``) or backward (``cot``) sub-tick."""
        P, M = self.pp, self.num_microbatches
        m = t - s if kind == "act" else t - (2 * P - 1 - s)
        return 0 <= m < M

    def _one_f_one_b(self, h, labs, n):
        P, M = self.pp, self.num_microbatches
        fn = self.step_.loss_fn
        if fn is not None and len(labs[0]) != 1:
            raise ValueError(
                "1F1B pipeline expects exactly one labels array "
                f"(got {len(labs[0])}); GPipe (schedule_mode='F-then-B') "
                "supports multi-label losses")
        hm = [[c.detach().requires_grad_(hd.requires_grad)
               for c in hd.chunk(M)] if hd is not None else None
              for hd in h]
        lab = [[y.chunk(M) for y in labs[d]] if self._local(d, P - 1)
               else None for d in range(n)]
        self._n = n
        stored, act_in, cot_in, works = {}, {}, {}, []
        total = torch.zeros((), dtype=torch.float32,
                            device=self.dev0 if self.xp
                            else self.devs[self.rank(0, P - 1)])
        for t in range(M + 2 * P - 1):
            acts, cots, work = {}, {}, {}
            for s in range(P):                      # forward sub-ticks
                m = t - s
                if 0 <= m < M:
                    for d in range(n):
                        if not self._local(d, s):
                            continue
                        inp = hm[d][m].detach() if s == 0 else \
                            act_in.pop((d, s))
                        if m == 0:
                            self._check_buffer_reads(d, s, inp)
                        stored[d, s, m] = inp
                        work[self.rank(d, s)] = (d, s, inp)
            if any(self._made("act", t, s) for s in range(P)):
                # every process runs the tick, with or without work of its
                # own, so that each draws run_ranks' seeds in step
                with torch.no_grad():
                    outs = self._run({r: functools.partial(
                        self._run_stage, d, s, inp)
                        for r, (d, s, inp) in work.items()}, n)
                for r, (d, s, _) in work.items():
                    if s + 1 < P:
                        acts[d, s + 1] = outs[r]
            works += self._hand_over("act", t, acts, act_in, 1)
            for s in range(P):                      # backward sub-ticks
                m = t - (2 * P - 1 - s)
                if 0 <= m < M:
                    total = total + self._backward_tick(
                        s, m, n, hm, lab, stored, cot_in, cots)
            works += self._hand_over("cot", t, cots, cot_in, -1)
            held = collections.Counter(key[:2] for key in stored)
            self.max_stored_inputs = max(self.max_stored_inputs,
                                         max(held.values(), default=0))
        for d in range(n):
            if h[d] is not None and h[d].requires_grad:
                torch.autograd.backward(h[d],
                                        torch.cat([c.grad for c in hm[d]]))
        process.wait(works)
        return total

    def _backward_tick(self, s, m, n, hm, lab, stored, cot_in, cots):
        """Stage ``s``'s backward of micro-batch ``m`` on every running
        pipeline: recompute from the stored input against frozen buffers,
        then one backward (of ``post`` + the loss / M on the last stage,
        else of the output against the next stage's cotangent).  Returns
        the micro-batch's loss share (0 off the last stage)."""
        P, M = self.pp, self.num_microbatches
        ds = [d for d in range(n) if self._local(d, s)]
        if not ds:
            # another process's stage: run the tick's (empty) rank calls
            # all the same (``_one_f_one_b``)
            self._run({}, n)
            if s == P - 1:
                self._post_loss([None] * n, [None] * n, n)
            return 0.0
        xin = {}
        for d in ds:
            inp = stored.pop((d, s, m))
            xin[d] = hm[d][m] if s == 0 else inp.requires_grad_(True)
        with contextlib.ExitStack() as frozen:
            for d in ds:
                frozen.enter_context(self._frozen_buffers(self.rank(d, s)))
            res = self._run({self.rank(d, s): functools.partial(
                self._run_stage, d, s, xin[d]) for d in ds}, n)
            outs = [res.get(self.rank(d, s)) for d in range(n)]
            if s == P - 1:
                loss_m = self._post_loss(
                    outs, [[y[m] for y in lab[d]] if lab[d] is not None
                           else None for d in range(n)], n) / M
                torch.autograd.backward(loss_m)
                share = loss_m.detach()
            else:
                torch.autograd.backward(
                    [outs[d] for d in ds], [cot_in.pop((d, s)) for d in ds])
                share = 0.0
        if s > 0:
            for d in ds:
                cots[d, s - 1] = xin[d].grad
        return share

    def _groups(self):
        """The ranks holding the same piece of each trainable parameter:
        a block's stage in every pipeline, every rank holding a copy of a
        dense ``pre`` or ``post`` parameter, or each mp piece's holders
        (the gradient lands on the ranks that ran it; all take the
        update)."""
        out = {}
        for k in self.pnames:
            if not self.trainable[k]:
                continue
            groups = {}
            for r in sorted(self.holds[k]):
                key = tuple(start for _, start, _ in piece_slices(
                    self.local_specs[k], self.shapes[k], self.mesh, r))
                groups.setdefault(key, []).append(r)
            out[k] = list(groups.values())
        return out

    def _apply(self):
        red = self._reduce_and_clip()

        def update(r, lr):
            ctx = collective.current_rank()
            for k in self.pnames:
                if r not in red.get(k, ()):
                    continue
                axes = tuple(a for e in self.local_specs[k]
                             for a in _axes_of(e))
                if axes:
                    ctx.norm_axes = axes
                try:
                    self._update_piece(k, self.leaves[r][k], red[k][r],
                                       self.opt_state[r][k], lr)
                finally:
                    if axes:
                        ctx.norm_axes = ()

        with self._updating() as lr:
            # the mp pieces' norms (Lamb, LarsMomentum) meet over mp
            self._run({r: functools.partial(update, r, lr)
                       for r in self.holders}, 1, max(self.end_mp.values()))
        self.last_grads = red if self.keep_grads else None

    # -- reading the state back ---------------------------------------------
    def _refs(self, k):
        """The ranks whose pieces make the reference copy of ``k``, in
        pipeline 0: a block's stage, ``pre``'s first, ``post``'s last (its
        mp group when ``k`` is split over it)."""
        js = range(self.mesh.axis_size("mp")) if self.local_specs[k] else (0,)
        return [self.rank(0, self.stage_of[k], j) for j in js]

    def _local_spec(self, k, sk=None):
        spec = self.local_specs[k]
        if spec and sk is not None:
            r = next(r for r in self.holds[k] if self.mesh.is_local(r))
            if self.opt_state[r][k][sk].dim() == 0:
                return ()
        return spec

    def _assemble(self, k, by_rank, spec, device=None):
        refs = self._refs(k)
        if self.xp:
            # every process hands in the reference pieces it holds
            mine = {r: by_rank[r].detach().cpu() for r in refs
                    if r in by_rank}
            by_rank = {r: t for got in process.all_gather_object(
                mine, key=("assemble",), name=f"assemble {k}")
                for r, t in got.items()}
            device = device or self.dev0
        first = by_rank[refs[0]].detach()
        dev = device or first.device
        if not spec:
            return first.to(dev)
        shape = list(first.shape)
        for dim, entry in enumerate(spec):
            for a in _axes_of(entry):
                shape[dim] *= self.mesh.axis_size(a)
        out = torch.empty(shape, dtype=first.dtype, device=dev)
        for r in refs:
            view = out
            for dim, start, n in piece_slices(spec, shape, self.mesh, r):
                view = view.narrow(dim, start, n)
            view.copy_(by_rank[r].detach())
        return out

    def full_buffers(self):
        mine = {k: v for s in range(self.pp) if self._local(0, s)
                for k, v in self.buffers[self.rank(0, s)].items()}
        if not self.xp:
            return mine
        got = process.all_gather_object(
            {k: v.cpu() for k, v in mine.items()}, key=("assemble",),
            name="buffers")
        return {k: v.to(self.dev0) for g in got for k, v in g.items()}

    def full_opt_state(self, device=None):
        if not self.xp:
            return super().full_opt_state(device)
        out = {}
        for k in self.pnames:
            if not self.trainable[k]:
                continue
            r = next((r for r in self.holds[k] if self.mesh.is_local(r)),
                     None)
            names = sorted(self.opt_state[r][k]) if r is not None else None
            names = next(n for n in process.all_gather_object(
                names, key=("assemble",), name=f"state names {k}")
                if n is not None)
            per = self._holders(self.opt_state, k)
            out[k] = {sk: self._assemble(
                k, {r: st[sk] for r, st in per.items()},
                self.local_specs[k], device) for sk in names}
        return out


def stack_block_params(blocks):
    """``(names, {name: [n_blocks, ...] stacked})`` of identical blocks'
    parameters (the JAX package's stacked form, for its checkpoints and
    the tests)."""
    names = [n for n, _ in torch_named_parameters(blocks[0])]
    return names, {n: torch.stack([dict(torch_named_parameters(b))[n].detach()
                                   for b in blocks]) for n in names}


def unstack_block_params(blocks, names, stacked):
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            params = dict(torch_named_parameters(blk))
            for n in names:
                params[n].copy_(torch.as_tensor(stacked[n][i]))


def stack_block_buffers(blocks):
    names = [n for n, b in torch_named_buffers(blocks[0]) if b is not None]
    return names, {n: torch.stack([dict(torch_named_buffers(b))[n]
                                   for b in blocks]) for n in names}


def unstack_block_buffers(blocks, names, stacked):
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            bufs = dict(torch_named_buffers(blk))
            for n in names:
                if bufs.get(n) is not None:
                    bufs[n].copy_(torch.as_tensor(stacked[n][i]))

