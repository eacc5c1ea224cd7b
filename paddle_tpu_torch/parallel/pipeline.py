"""Pipeline-parallel training: the GPipe and 1F1B schedules over a mesh's
``pp`` axis — counterpart of ``paddle_tpu/parallel/pipeline.py``.

The JAX package stacks the identical blocks' parameters on a leading
``pp``-sharded axis and runs ONE ``shard_map`` program that rotates
activations around the ring with ``ppermute``.  The port keeps the
schedule and drives the stages from one controller: stage ``s`` (the
mesh rank at ``pp = s``) holds blocks ``s * bps .. (s + 1) * bps`` as its
own modules (replicas of the model's blocks holding the stage's tensors
on its device), and an activation or a cotangent moves to the next stage
with ``.to`` (a copy between cards, nothing on one).  ``pre`` and
``post`` are replicated: every stage holds a copy, ``pre`` runs on stage
0 and ``post`` on the last, and their gradients are summed over the
stages (the others contribute nothing) before every copy takes the same
update.

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
  At most ``2P - 1`` inputs a stage are stored: live activations O(P),
  not O(M).  The loss is the mean of the micro-batch losses (GPipe's
  whole-batch loss for a mean criterion over equal micro-batches), and
  exactly one labels array is accepted, as in the JAX package.

Buffers (BN running statistics) advance once per real micro-batch: in
the forward tick, never in a recomputation (GPipe's restores them after
it; 1F1B's runs against them and restores them).  1F1B's recomputation
sees the buffers after every forward of the step, where its forward
saw them mid-step, which is sound only when the training forward never
READS a buffer's value (BN writes its statistics but normalizes with
the batch's): the first step checks that per stage, running the forward
once more with every buffer set to NaN, and refuses a stage whose
activation changes, as the JAX package's ``_check_recompute_buffer_
safety`` refuses it.

The pipeline path runs over a mesh whose other axes are 1; with data
or model parallelism beside ``pp`` it raises (ROADMAP Queue A 10, the
training remainder).
"""
from __future__ import annotations

import contextlib

import torch

from ..distributed.fleet.utils import recompute
from .train_step import _as_tensor, _MeshEngine, bind, meta_replica


def _owned(t, device, taken):
    """A private leaf for one stage: ``t``'s storage for the first taker
    on its device, else a copy on ``device``."""
    if device == t.device and id(t) not in taken:
        taken.add(id(t))
        return t.detach()
    return t.detach().to(device, copy=True)


class PipelineEngine(_MeshEngine):
    """The pipeline path of ``TrainStep`` (module docstring)."""

    def __init__(self, step, model, mesh):
        super().__init__(step, mesh)
        pp = mesh.axis_size("pp")
        others = {a: n for a, n in mesh.shape.items() if a != "pp" and n > 1}
        if others:
            raise NotImplementedError(
                f"TrainStep: a pipeline over a mesh with {others} beside pp "
                "is not ported yet (ROADMAP Queue A 10: a pipeline beside "
                "data or model parallelism)")
        nblocks = len(model.blocks)
        if nblocks % pp:
            raise ValueError(f"n_blocks {nblocks} must divide pp degree "
                             f"{pp}")
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
        self.devs = [mesh.flat_devices[mesh.rank_of({"pp": i})]
                     for i in range(pp)]
        taken = set()
        # leaves[s]: the model's parameter name -> stage s's leaf
        self.leaves = [{} for _ in range(pp)]
        self.stages = []
        self.buffers = [{} for _ in range(pp)]
        for i, blk in enumerate(model.blocks):
            st = i // self.bps
            rep = meta_replica(blk)
            params = {}
            for n, p in blk.named_parameters():
                t = _owned(p, self.devs[st], taken).requires_grad_(
                    p.requires_grad)
                params[n] = t
                self.leaves[st][f"blocks.{i}.{n}"] = t
            bufs = {n: b.detach().to(self.devs[st], copy=True)
                    for n, b in blk.named_buffers() if b is not None}
            bind(rep, params, bufs)
            for n, b in bufs.items():
                self.buffers[st][f"blocks.{i}.{n}"] = b
            if i % self.bps == 0:
                self.stages.append([])
            self.stages[st].append(rep)
        self.ends = {}
        for end in ("pre", "post"):
            mod = getattr(model, end)
            self.ends[end] = []
            for st in range(pp):
                if mod is None:
                    self.ends[end].append(None)
                    continue
                rep = meta_replica(mod)
                params = {}
                for n, p in mod.named_parameters():
                    t = _owned(p, self.devs[st], taken).requires_grad_(
                        p.requires_grad)
                    params[n] = t
                    self.leaves[st][f"{end}.{n}"] = t
                bind(rep, params, {n: b.detach().to(self.devs[st], copy=True)
                                   for n, b in mod.named_buffers()
                                   if b is not None})
                self.ends[end].append(rep)
        opt = step.optimizer
        self.opt_state = [{k: opt._init_state(t) for k, t in lv.items()
                           if t.requires_grad} for lv in self.leaves]
        self.pnames = sorted({k for lv in self.leaves for k in lv})
        self.param_specs = {k: ("pp",) if k.startswith("blocks.") else ()
                            for k in self.pnames}
        self.opt_specs = {}
        self._checked = False

    # -- stages ----------------------------------------------------------
    def _run_stage(self, s, h):
        for blk in self.stages[s]:
            h = blk(h)
        return h

    @contextlib.contextmanager
    def _frozen_buffers(self, s):
        """The stage's buffers as they are now, restored on exit: a
        recomputation does not advance them again."""
        saved = [(b, b.clone()) for b in self.buffers[s].values()]
        try:
            yield
        finally:
            with torch.no_grad():
                for b, v in saved:
                    b.copy_(v)

    def _stage_call(self, s, x):
        if not self.use_remat:
            return self._run_stage(s, x)
        calls = [0]

        def body(h):
            calls[0] += 1
            if calls[0] == 1:
                return self._run_stage(s, h)
            with self._frozen_buffers(s):
                return self._run_stage(s, h)

        return recompute(body, x)

    def _check_buffer_reads(self, x):
        """1F1B's guard (module docstring): refuse a stage whose training
        forward reads a buffer's value."""
        if self._checked or not self.step_.training:
            return
        for s in range(self.pp):
            if not self.buffers[s]:
                continue
            owners = []
            for rep in self.stages[s]:
                for mod in rep.modules():
                    for leaf, b in mod._buffers.items():
                        if b is not None:
                            owners.append((mod, leaf, b))
            xs = x.detach().to(self.devs[s])
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
                        devices=[d.index for d in self.devs
                                 if d.type == "cuda"]):
                    torch.manual_seed(0)
                    outs.append(self._run_stage(s, xs))
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
        self._checked = True

    # -- the step --------------------------------------------------------
    def _set_train(self):
        mode = self.step_.training
        for reps in self.stages:
            for rep in reps:
                rep.train(mode)
        for reps in self.ends.values():
            for rep in reps:
                if rep is not None:
                    rep.train(mode)

    def _loss(self, out, labels):
        fn = self.step_.loss_fn
        loss = out if fn is None else fn(out, *labels)
        return loss.float()

    def step(self, inputs, labels):
        st = self.step_
        self._free_grads()
        self._set_train()
        x = _as_tensor(inputs[0], self.devs[0])
        last = self.devs[-1]
        labels = [_as_tensor(y, last) for y in labels]
        M = self.num_microbatches
        if x.shape[0] % M:
            raise ValueError(f"pipeline: accumulate_steps={M} must divide "
                             f"the batch ({x.shape[0]})")
        with st._amp():
            pre = self.ends["pre"][0]
            h = pre(x) if pre is not None else x
            if self.schedule == "1F1B":
                loss = self._one_f_one_b(h, labels)
            else:
                loss = self._gpipe(h, labels)
        self._apply()
        return loss

    def _gpipe(self, h, labels):
        P, M = self.pp, self.num_microbatches
        carry = list(h.chunk(M))
        for t in range(M + P - 1):
            for s in range(P):
                m = t - s
                if 0 <= m < M:
                    carry[m] = self._stage_call(s, carry[m].to(self.devs[s]))
        out = torch.cat(carry)
        post = self.ends["post"][-1]
        if post is not None:
            out = post(out)
        loss = self._loss(out, labels)
        loss.backward()
        return loss.detach()

    def _one_f_one_b(self, h, labels):
        P, M = self.pp, self.num_microbatches
        fn = self.step_.loss_fn
        if fn is not None and len(labels) != 1:
            raise ValueError(
                "1F1B pipeline expects exactly one labels array "
                f"(got {len(labels)}); GPipe (schedule_mode='F-then-B') "
                "supports multi-label losses")
        hm = [c.detach().requires_grad_(h.requires_grad) for c in
              h.chunk(M)]
        lab = labels[0].chunk(M) if labels else [None] * M
        self._check_buffer_reads(hm[0])
        post = self.ends["post"][-1]
        stored = [dict() for _ in range(P)]
        act_in, cot_in = {}, {}
        total = torch.zeros((), dtype=torch.float32, device=self.devs[-1])
        for t in range(M + 2 * P - 1):
            acts, cots = {}, {}
            for s in range(P):                      # forward sub-ticks
                m = t - s
                if not 0 <= m < M:
                    continue
                inp = hm[m].detach() if s == 0 else act_in.pop(s)
                with torch.no_grad():
                    out = self._run_stage(s, inp)
                stored[s][m] = inp
                if s + 1 < P:
                    acts[s + 1] = out.to(self.devs[s + 1])
            for s in range(P):                      # backward sub-ticks
                m = t - (2 * P - 1 - s)
                if not 0 <= m < M:
                    continue
                inp = stored[s].pop(m)
                x_in = hm[m] if s == 0 else inp.requires_grad_(True)
                with self._frozen_buffers(s):
                    out = self._run_stage(s, x_in)
                    if s == P - 1:
                        y = post(out) if post is not None else out
                        loss_m = (y if fn is None else fn(y, lab[m])
                                  ).float() / M
                        torch.autograd.backward(loss_m)
                        total = total + loss_m.detach()
                    else:
                        torch.autograd.backward(out, cot_in.pop(s))
                if s > 0:
                    cots[s - 1] = x_in.grad.to(self.devs[s - 1])
            act_in.update(acts)
            cot_in.update(cots)
        if h.requires_grad:
            torch.autograd.backward(h, torch.cat([c.grad for c in hm]))
        return total

    def _groups(self):
        """A block's one stage, or every stage holding a copy of ``pre``
        or ``post`` (the gradient lands on one; all take the update)."""
        return {k: [[s for s in range(self.pp) if k in self.leaves[s]]]
                for k in self.pnames if self._leaf(k).requires_grad}

    def _apply(self):
        red = self._reduce_and_clip()
        with self._updating() as lr:
            for k, per in red.items():
                for s, g in per.items():
                    self._update_piece(k, self.leaves[s][k], g,
                                       self.opt_state[s][k], lr)
        self.last_grads = red if self.keep_grads else None

    # -- reading the state back ---------------------------------------------
    def _owner(self, k):
        """The stage whose copy of ``k`` is the reference one: a block's
        stage, ``pre``'s first, ``post``'s last."""
        owners = [s for s in range(self.pp) if k in self.leaves[s]]
        return owners[-1] if k.startswith("post.") else owners[0]

    def _leaf(self, k):
        return self.leaves[self._owner(k)][k]

    def _local_spec(self, k, sk=None):
        return ()           # each stage holds its tensors whole

    def _assemble(self, k, by_stage, spec, device=None):
        return by_stage[self._owner(k)].detach().to(device or self.devs[0])

    def full_buffers(self):
        return {k: v for b in self.buffers for k, v in b.items()}


def stack_block_params(blocks):
    """``(names, {name: [n_blocks, ...] stacked})`` of identical blocks'
    parameters (the JAX package's stacked form, for its checkpoints and
    the tests)."""
    names = [n for n, _ in blocks[0].named_parameters()]
    return names, {n: torch.stack([dict(b.named_parameters())[n].detach()
                                   for b in blocks]) for n in names}


def unstack_block_params(blocks, names, stacked):
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            params = dict(blk.named_parameters())
            for n in names:
                params[n].copy_(torch.as_tensor(stacked[n][i]))


def stack_block_buffers(blocks):
    names = [n for n, b in blocks[0].named_buffers() if b is not None]
    return names, {n: torch.stack([dict(b.named_buffers())[n]
                                   for b in blocks]) for n in names}


def unstack_block_buffers(blocks, names, stacked):
    with torch.no_grad():
        for i, blk in enumerate(blocks):
            bufs = dict(blk.named_buffers())
            for n in names:
                if bufs.get(n) is not None:
                    bufs[n].copy_(torch.as_tensor(stacked[n][i]))

