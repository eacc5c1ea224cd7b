"""Collectives over a mesh's ranks — counterpart of
``paddle_tpu/distributed/collective.py``.

The JAX package lowers its collectives to XLA ops on named mesh axes
inside ``shard_map``.  The port drives every rank of a process from that
process (see ``distributed/mesh.py``), so a collective is a function of
the ranks' parts, ``parts[i]`` on ``devices[i]``:

* the serving pair, ``all_reduce_sum`` / ``all_gather(parts, dim,
  devices)`` (rank order, one
  result a device, shared by the ranks on it; under ``torch.profiler``
  labels ``mesh.all_reduce_sum`` / ``mesh.all_gather``), which the
  serving tick runs under ``no_grad``;
* the training collectives ``reduce_parts``, ``gather_parts`` and
  ``scatter_reduce_parts``: ``torch.autograd.Function``s whose backward
  is the exact transpose (the all-reduce's sums the ranks' cotangents
  and hands the sum to every rank, the all-gather's is a reduce-scatter,
  the reduce-scatter's an all-gather), one private result a rank, under
  the labels ``mesh.all_reduce`` / ``mesh.all_gather`` /
  ``mesh.reduce_scatter`` (``.backward`` for the transposes).

Code that runs once per rank — a model's forward on a mesh, an
optimizer's update of a rank's shard — runs under ``run_ranks``: one
thread a rank, exactly one of them running at a time, handing over only
where a rank waits in a collective (a lockstep, deterministic order:
the lowest waiting rank runs next).  Inside, ``current_rank()`` is the
rank's ``RankContext`` and the group collectives ``mesh_all_reduce`` /
``mesh_all_gather`` / ``mesh_split`` meet the other ranks of the group
over some axes; the parts meet in whichever thread arrives last, which
applies the list collective, so one autograd graph spans every rank and
one ``backward`` runs them all.  Each rank draws from its own random
stream (seeded from the caller's), swapped in whenever it runs.

A forward recomputed in backward (``fleet.utils.recompute``) runs one
rank at a time, with no lockstep: the region records its collectives'
results when first run, and the recomputation takes them back in order
(a value with no exchange — the first run's graph carries the
collective's backward).  The parts meet outside any saved-tensor hook or
dispatch mode of the thread they meet in, so no recomputation owns them.

Over a mesh that spans processes (``distributed/mesh.py``) each process
runs only its own ranks.  Where an exchange meets a group that spans
processes, the local parts combine first, one call of the process
transport (``distributed/process.py``) then crosses processes, and the
result goes back to the local ranks.  The training collectives' cross
forms are ``torch.autograd.Function``\\ s whose backward crosses too: the
all-reduce's backward is an all-reduce, the all-gather's a
reduce-scatter, ``p2p_shift``'s the opposite shift (profiler labels
``process.all_reduce`` / ``process.all_gather`` /
``process.reduce_scatter`` / ``process.p2p``).  Any other exchange
crosses as its parts gathered to every process, which then runs the
one-process combine, and refuses a value that needs a gradient.  Every
process must run the same collectives in the same order, forward and
backward: each crossing carries its group's sequence number, checked on
both sides, so that a mismatch raises and names both calls.  Every
process calls ``run_ranks`` at the same points (with or without ranks of
its own to run), and over a mesh spanning processes the call's base seed
is the mesh's first process's: rank ``r``'s random stream comes from that
base and ``r`` alone, so it is the same whichever process runs ``r``.

The paddle API (``all_reduce``, ``all_gather``, ``broadcast``,
``reduce``, ``scatter``, ``reduce_scatter``, ``alltoall``, ``p2p_shift``,
``barrier``) acts over the ``group`` axis (default: the axis of the
enclosing ``parallel_region``) of the rank it runs on, and is the
identity outside any rank (a world of one), as the JAX package's is
outside a traced region.  ``parallel_region(fn, axis)`` is
``shard_map``: inputs split on their leading dim over ``axis``, ``fn``
run on every rank, outputs put back together.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import _disable_current_modes

from . import process


# -- the serving pair (no autograd: the serving tick runs under no_grad) --
def _scatter_back(out, group):
    placed = {out.device: out}
    for dev in group:
        if dev not in placed:
            placed[dev] = out.to(dev)
    return [placed[dev] for dev in group]


def all_reduce_sum(parts, group):
    """Sum of ``parts`` (rank order), on every rank's device."""
    if len(parts) != len(group):
        raise ValueError(f"all_reduce_sum: {len(parts)} parts for a group "
                         f"of {len(group)} ranks")
    with torch.profiler.record_function("mesh.all_reduce_sum"):
        dev = group[0]
        out = parts[0].to(dev)
        for p in parts[1:]:
            out = out + p.to(dev)
        return _scatter_back(out, group)


def _serving_all_gather(parts, dim, group):
    """``parts`` (rank order) concatenated on ``dim``, on every rank's
    device."""
    if len(parts) != len(group):
        raise ValueError(f"all_gather: {len(parts)} parts for a group of "
                         f"{len(group)} ranks")
    with torch.profiler.record_function("mesh.all_gather"):
        dev = group[0]
        out = (parts[0].to(dev) if len(parts) == 1
               else torch.cat([p.to(dev) for p in parts], dim=dim))
        return _scatter_back(out, group)


# -- list collectives with autograd -----------------------------------------
def _to(t, dev):
    return t if t.device == dev else t.to(dev)


def _per_rank(base, devices):
    """One private tensor a rank: ``base`` moved to each device, cloned
    for every further rank on a device already served."""
    out, seen = [], set()
    for dev in devices:
        t = _to(base, dev)
        if t.device in seen:
            t = t.clone()
        seen.add(t.device)
        out.append(t)
    return out


def _sum_on(tensors, dev):
    acc = None
    for t in tensors:
        if t is not None:
            acc = _to(t, dev) if acc is None else acc + _to(t, dev)
    return acc


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *parts):
        ctx.devices = [p.device for p in parts]
        with torch.profiler.record_function("mesh.all_reduce"):
            return tuple(_per_rank(_sum_on(parts, devices[0]), devices))

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function("mesh.all_reduce.backward"):
            acc = _sum_on(grads, ctx.devices[0])
            if acc is None:
                return (None,) * (1 + len(grads))
            return (None,) + tuple(_per_rank(acc, ctx.devices))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        ctx.devices = [p.device for p in parts]
        with torch.profiler.record_function("mesh.all_gather"):
            full = torch.cat([_to(p, devices[0]) for p in parts], dim=dim)
            return tuple(_per_rank(full, devices))

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function("mesh.all_gather.backward"):
            acc = _sum_on(grads, ctx.devices[0])
            if acc is None:
                return (None,) * (2 + len(ctx.devices))
            pieces = acc.split(ctx.sizes, dim=ctx.dim)
            return (None, None) + tuple(_to(p, d).clone() for p, d in
                                        zip(pieces, ctx.devices))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, devices, *parts):
        ctx.dim = dim
        ctx.devices = [p.device for p in parts]
        with torch.profiler.record_function("mesh.reduce_scatter"):
            acc = _sum_on(parts, devices[0])
            outs = tuple(_to(c, d).clone() for c, d in
                         zip(acc.chunk(len(parts), dim=dim), devices))
            ctx.like = [torch.zeros_like(o, device="meta") for o in outs]
            return outs

    @staticmethod
    def backward(ctx, *grads):
        with torch.profiler.record_function("mesh.reduce_scatter.backward"):
            return (None, None) + tuple(
                torch.cat([_to(g, d) if g is not None else
                           torch.zeros(m.shape, dtype=m.dtype, device=d)
                           for g, m in zip(grads, ctx.like)], dim=ctx.dim)
                for d in ctx.devices)


def reduce_parts(parts, devices=None, op="sum"):
    """The reduction of ``parts`` over the group, one private result a rank
    on ``devices[i]`` (default each part's device).  ``sum`` and ``avg``
    differentiate through ``_AllReduce``; ``max`` / ``min`` / ``prod``
    through torch's own ops."""
    devices = devices or [p.device for p in parts]
    if op in ("sum", "avg"):
        outs = list(_AllReduce.apply(devices, *parts))
        return [o / len(parts) for o in outs] if op == "avg" else outs
    stacked = torch.stack([_to(p, devices[0]) for p in parts])
    red = {"max": lambda s: s.amax(0), "min": lambda s: s.amin(0),
           "prod": lambda s: s.prod(0)}[op](stacked)
    return [_to(red, d) if i == 0 or d != devices[0] else red.clone()
            for i, d in enumerate(devices)]


def gather_parts(parts, dim, devices=None):
    """``parts`` concatenated on ``dim``, one private copy a rank; the
    backward is a reduce-scatter."""
    devices = devices or [p.device for p in parts]
    return list(_AllGather.apply(dim, devices, *parts))


def scatter_reduce_parts(parts, dim, devices=None):
    """Rank i's chunk ``i`` (on ``dim``) of the parts' sum; the backward
    is an all-gather."""
    devices = devices or [p.device for p in parts]
    return list(_ReduceScatter.apply(dim, devices, *parts))


# -- across processes ------------------------------------------------------
class _Span:
    """Where a group's ranks live: ``procs`` (sorted), ``positions[p]``
    the group positions of process ``p``'s ranks, ``local`` this
    process's; ``key`` names the group's sequence."""

    def __init__(self, mesh, group):
        self.group = tuple(group)
        self.procs = mesh.procs_of(group)
        self.positions = {p: [i for i, r in enumerate(group)
                              if mesh.procs[r] == p] for p in self.procs}
        self.local = self.positions[mesh.process]
        self.key = ("group",) + self.group


def _gather_group(parts, span, name):
    """Every rank's part of the group (equal shapes), in group order, on
    ``parts[0]``'s device: this process's parts go across in one call."""
    dev = parts[0].device
    width = max(len(v) for v in span.positions.values())
    flat = [p.reshape(-1).to(dev) for p in parts]
    numel = flat[0].numel()
    pad = width - len(flat)
    if pad:
        flat.append(flat[0].new_zeros(pad * numel))
    got = process.all_gather(torch.cat(flat), span.procs, key=span.key,
                             name=name)
    out = [None] * len(span.group)
    for p, buf in zip(span.procs, got):
        for j, pos in enumerate(span.positions[p]):
            out[pos] = buf[j * numel:(j + 1) * numel].view(parts[0].shape)
    return out


class _XAllReduce(torch.autograd.Function):
    """The sum over a group spanning processes: local parts summed, one
    cross-process all-reduce, one private result a local rank; the
    backward is the same."""

    @staticmethod
    def forward(ctx, span, devices, *parts):
        ctx.span, ctx.devices = span, devices
        acc = process.all_reduce(_sum_on(parts, devices[0]), span.procs,
                                 key=span.key, name="all_reduce[sum]")
        return tuple(_per_rank(acc, devices))

    @staticmethod
    def backward(ctx, *grads):
        span = ctx.span
        acc = process.all_reduce(_sum_on(grads, ctx.devices[0]), span.procs,
                                 key=span.key,
                                 name="all_reduce[sum].backward")
        return (None, None) + tuple(_per_rank(acc, ctx.devices))


class _XAllGather(torch.autograd.Function):
    """The group's parts concatenated on ``dim`` across processes; the
    backward is the reduce-scatter (the local cotangents summed, one
    cross-process sum, each local rank its piece)."""

    @staticmethod
    def forward(ctx, dim, span, devices, *parts):
        ctx.dim, ctx.span, ctx.devices = dim, span, devices
        ctx.sizes = [parts[0].shape[dim]] * len(span.group)
        full = torch.cat(_gather_group(parts, span, f"all_gather[{dim}]"),
                         dim=dim)
        return tuple(_per_rank(full, devices))

    @staticmethod
    def backward(ctx, *grads):
        span = ctx.span
        acc = process.all_reduce(_sum_on(grads, ctx.devices[0]), span.procs,
                                 key=span.key, kind="reduce_scatter",
                                 name=f"all_gather[{ctx.dim}].backward")
        pieces = acc.split(ctx.sizes, dim=ctx.dim)
        return (None, None, None) + tuple(
            _to(pieces[i], d).clone() for i, d in zip(span.local,
                                                      ctx.devices))


def _shift_group(parts, span, shift, name):
    """Position ``i``'s result is position ``i - shift``'s part, on the
    local parts' devices: a source in this process is copied, each other
    one crosses by ``process.p2p`` from its process to this one alone."""
    n = len(span.group)
    owner = {pos: p for p, ps in span.positions.items() for pos in ps}
    me = process.index()
    mine = dict(zip(span.local, parts))
    sends = [(t, owner[(j + shift) % n], (j, (j + shift) % n))
             for j, t in mine.items() if owner[(j + shift) % n] != me]
    recvs = [(owner[(i - shift) % n], ((i - shift) % n, i), t.device)
             for i, t in mine.items() if owner[(i - shift) % n] != me]
    got = iter(process.p2p(sends, recvs, span.procs, span.key, name))
    return [_to(mine[(i - shift) % n], t.device).clone()
            if owner[(i - shift) % n] == me else next(got)
            for i, t in mine.items()]


class _XShift(torch.autograd.Function):
    """Ring shift over a group spanning processes: the rank at position
    ``i`` gets position ``i - shift``'s part; the backward is the
    opposite shift."""

    @staticmethod
    def forward(ctx, shift, span, *parts):
        ctx.shift, ctx.span = shift, span
        return tuple(_shift_group(parts, span, shift,
                                  f"p2p_shift[{shift}]"))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_shift_group(
            grads, ctx.span, -ctx.shift,
            f"p2p_shift[{ctx.shift}].backward"))


def _devices_of(parts):
    return [p.device for p in parts]


def _cross_reduce(op):
    def cross(span, parts):
        devs = _devices_of(parts)
        if op in ("sum", "avg"):
            outs = list(_XAllReduce.apply(span, devs, *parts))
            n = len(span.group)
            return [o / n for o in outs] if op == "avg" else outs
        _no_grad(parts, f"all_reduce[{op}]")
        red = reduce_parts(parts, devs, op)[0]
        red = process.all_reduce(red, span.procs, op=op, key=span.key,
                                 name=f"all_reduce[{op}]")
        return [_to(red, d).clone() for d in devs]
    return cross


def _cross_gather(dim):
    def cross(span, parts):
        return list(_XAllGather.apply(dim, span, _devices_of(parts), *parts))
    return cross


def _cross_shift(shift):
    def cross(span, parts):
        return list(_XShift.apply(shift, span, *parts))
    return cross


def _no_grad(value, name):
    if any(t.requires_grad for t in _tensors(value)):
        raise NotImplementedError(
            f"{name} over a group spanning processes crosses without a "
            "gradient; this value needs one")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _moved(x, dev):
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(_moved(v, dev) for v in x)
    return x


def _cross_generic(combine, name):
    """Any other exchange across processes: every part gathered to every
    process (no gradient), the one-process ``combine`` run on them, each
    local rank its output."""
    def cross(span, parts):
        _no_grad(parts, name)
        got = process.all_gather_object(_moved(parts, "cpu"), span.procs,
                                        key=span.key, name=name)
        dev = next((t.device for t in _tensors(parts)),
                   torch.device("cpu"))
        every = [None] * len(span.group)
        for p, vals in zip(span.procs, got):
            for pos, v in zip(span.positions[p], vals):
                every[pos] = _moved(v, dev)
        outs = combine(every)
        return [outs[i] for i in span.local]
    return cross


# -- one thread a rank, in lockstep ---------------------------------------
_tls = threading.local()


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


class Region:
    """A recomputed segment's record of its collectives' results."""

    def __init__(self):
        self.stash = []
        self.calls = 0
        self.cursor = 0
        self.replay = False


class RankContext:
    """One rank of a ``run_ranks`` call: its mesh, flat index, coordinates
    and device, the default collective axis (``parallel_region``'s),
    whether the batch was split over the data axes (``batch_split``), and
    ``token_count``: None, or the function a train step sets that turns
    this rank's count of kept tokens into the denominator of a loss's
    token mean (``nn.functional.loss``)."""

    def __init__(self, mesh, rank, runner=None, axis=None,
                 batch_split=False):
        self.mesh = mesh
        self.rank = int(rank)
        self.coords = mesh.coords(rank)
        self.device = mesh.flat_devices[rank]
        self.runner = runner
        self.axis = axis
        self.batch_split = batch_split
        self.token_count = None
        self.regions = []
        self.norm_axes = ()

    def group(self, axes):
        return self.mesh.group(self.rank, axes)

    def devices(self, group):
        devs = self.mesh.flat_devices
        return [devs[r] for r in group]


def current_rank():
    """The ``RankContext`` of the rank this code runs as, or None."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def in_region(ctx, region):
    """Run a recomputed segment's body as ``ctx``'s rank: the first call
    records the collectives' results, every later call (a recomputation
    in backward, on whatever thread) replays them in order."""
    prev = current_rank()
    _tls.ctx = ctx
    region.calls += 1
    region.replay = region.calls > 1
    region.cursor = 0
    ctx.regions.append(region)
    try:
        yield
    finally:
        ctx.regions.pop()
        _tls.ctx = prev


@contextlib.contextmanager
def _bare():
    """No saved-tensor hook and no dispatch mode of the running thread
    (a rank's recompute region) may own the parts' meeting."""
    with torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                  lambda t: t), \
            _disable_current_modes():
        yield


class _Aborted(Exception):
    pass


def _freeze(x):
    if isinstance(x, torch.Tensor):
        return (x.detach(), x.requires_grad)
    if isinstance(x, (list, tuple)):
        return type(x)(_freeze(v) for v in x)
    return x


def _thaw(x):
    if isinstance(x, tuple) and len(x) == 2 and isinstance(
            x[0], torch.Tensor) and isinstance(x[1], bool):
        return x[0].detach().requires_grad_(x[1])
    if isinstance(x, (list, tuple)):
        return type(x)(_thaw(v) for v in x)
    return x


class _Lockstep:
    """The scheduler of ``run_ranks``: a turn passes between rank threads
    only where one waits for its group."""

    def __init__(self, ranks):
        self.cv = threading.Condition()
        self.waiting = set()        # ranks blocked in an exchange
        self.finished = set()
        self.ranks = sorted(ranks)
        self.turn = None
        self.slots = {}
        self.seq = {}
        self.error = None
        self.rng = {}
        self.spans = {}
        self.mesh = None

    # caller holds self.cv
    def _next(self):
        ready = [r for r in self.ranks
                 if r not in self.waiting and r not in self.finished]
        self.turn = ready[0] if ready else None
        if self.turn is None and len(self.finished) < len(self.ranks) \
                and self.error is None:
            self.error = RuntimeError(
                "run_ranks: every rank waits in a collective no other rank "
                f"joins (waiting {sorted(self.waiting)}; open "
                f"{[(k, s['name']) for k, s in self.slots.items()]})")
        self.cv.notify_all()

    def _wait_turn(self, rank):
        while self.turn != rank and self.error is None:
            self.cv.wait()
        if self.error is not None:
            raise _Aborted

    def exchange(self, rank, group, value, combine, name, cross=None):
        group = tuple(group)
        span = self.spans.get(group)
        if span is None:
            span = self.spans[group] = _Span(self.mesh, group)
        local = [group[i] for i in span.local]
        with self.cv:
            n = self.seq.get((rank, group), 0)
            self.seq[rank, group] = n + 1
            slot = self.slots.setdefault((group, n), {
                "name": name, "parts": {}, "out": None})
            if slot["name"] != name:
                self.error = RuntimeError(
                    f"run_ranks: rank {rank} calls {name} where group "
                    f"{group} meets in {slot['name']}")
                self.cv.notify_all()
                raise self.error
            slot["parts"][rank] = value
            if len(slot["parts"]) == len(local):
                parts = [slot["parts"][r] for r in local]
                with _bare():
                    if len(local) == len(group):
                        outs = combine(parts)
                    else:
                        outs = (cross or _cross_generic(combine, name))(
                            span, parts)
                slot["out"] = dict(zip(local, outs))
                slot["parts"] = None
                self.waiting.difference_update(local)
            else:
                self.waiting.add(rank)
                self._save_rng(rank)
                self._next()
                self._wait_turn(rank)
                self._load_rng(rank)
            out = slot["out"].pop(rank)
            if not slot["out"]:
                del self.slots[group, n]
            return out

    def _save_rng(self, rank):
        dev = self.devices[rank]
        self.rng[rank] = (torch.get_rng_state(),
                          torch.cuda.get_rng_state(dev)
                          if dev.type == "cuda" else None)

    def _load_rng(self, rank):
        cpu, cuda = self.rng[rank]
        torch.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda, self.devices[rank])

    def _body(self, rank, fn, ctx, grad, results):
        try:
            _tls.ctx = ctx
            dev = self.devices[rank]
            with torch.set_grad_enabled(grad), (
                    torch.cuda.device(dev) if dev.type == "cuda"
                    else contextlib.nullcontext()):
                with self.cv:
                    self._wait_turn(rank)
                    self._load_rng(rank)
                results[rank] = fn()
                with self.cv:
                    self._save_rng(rank)
                    self.finished.add(rank)
                    self._next()
        except _Aborted:
            pass
        except BaseException as e:  # noqa: BLE001 - re-raised by run
            with self.cv:
                if self.error is None:
                    self.error = e
                self.cv.notify_all()
        finally:
            _tls.ctx = None

    def run(self, mesh, fns, ctxs, seeds):
        self.mesh = mesh
        self.devices = {r: mesh.flat_devices[r] for r in fns}
        cuda_devs = sorted({d.index for d in self.devices.values()
                            if d.type == "cuda"})
        for r, seed in seeds.items():
            cpu = torch.Generator().manual_seed(seed).get_state()
            cuda = None
            dev = self.devices[r]
            if dev.type == "cuda":
                keep = torch.cuda.get_rng_state(dev)
                torch.cuda.default_generators[dev.index].manual_seed(seed)
                cuda = torch.cuda.get_rng_state(dev)
                torch.cuda.set_rng_state(keep, dev)
            self.rng[r] = (cpu, cuda)
        saved = (torch.get_rng_state(),
                 {i: torch.cuda.get_rng_state(i) for i in cuda_devs})
        grad = torch.is_grad_enabled()
        results = {}
        threads = [threading.Thread(target=self._body,
                                    args=(r, fns[r], ctxs[r], grad,
                                          results),
                                    name=f"rank-{r}", daemon=True)
                   for r in self.ranks]
        for t in threads:
            t.start()
        with self.cv:
            self._next()
        for t in threads:
            t.join()
        torch.set_rng_state(saved[0])
        for i, st in saved[1].items():
            torch.cuda.set_rng_state(st, i)
        if self.error is not None:
            raise self.error
        return results


def run_ranks(mesh, fns, axis=None, batch_split=False):
    """Run ``fns[r]()`` as rank ``r`` of ``mesh`` for every key ``r`` (a
    flat rank) this process holds, in lockstep (module docstring);
    returns ``{r: result}``.  Re-raises the first error of any rank."""
    fns = {r: f for r, f in fns.items() if mesh.is_local(r)}
    runner = _Lockstep(fns)
    ctxs = {r: RankContext(mesh, r, runner, axis=axis,
                           batch_split=batch_split) for r in fns}
    base = int(torch.randint(0, 2 ** 62, (1,)).item())
    if mesh.spans_processes:
        # the mesh's first process's base, so that a rank's stream is the
        # same whichever process runs it
        procs = mesh.procs_of(range(mesh.size))
        mine = torch.tensor([base if process.index() == procs[0] else 0])
        base = int(process.all_reduce(mine, procs, key=("run_ranks",),
                                      name="run_ranks seed").item())
    seeds = {r: (base + 7919 * r) % (2 ** 63) for r in fns}
    return runner.run(mesh, fns, ctxs, seeds)


def _collect(ctx, group, value, combine, name, cross=None):
    """``value`` meets the group's other parts (or, in a replayed region,
    the recorded result comes back); ``cross`` is the exchange's form
    across processes (default ``_cross_generic``)."""
    replaying = next((r for r in reversed(ctx.regions) if r.replay), None)
    if replaying is not None:
        out = _thaw(replaying.stash[replaying.cursor])
        replaying.cursor += 1
    else:
        if ctx.runner is None:
            raise RuntimeError(
                f"{name}: rank {ctx.rank} is not running under run_ranks")
        out = ctx.runner.exchange(ctx.rank, group, value, combine, name,
                                  cross)
    for r in ctx.regions:
        if not r.replay:
            r.stash.append(_freeze(out))
    return out


def _group_of(axes):
    """``(ctx, group)`` of the running rank over ``axes``; ``(None,
    None)`` outside a rank or for a group of one."""
    ctx = current_rank()
    if ctx is None:
        return None, None
    group = ctx.group(axes)
    return (ctx, group) if len(group) > 1 else (ctx, None)


def mesh_all_reduce(x, axes, op="sum"):
    """``x`` reduced over the running rank's group on ``axes`` (the
    identity outside a rank or for a group of one)."""
    ctx, group = _group_of(axes)
    if group is None:
        return x
    devs = ctx.devices(group)
    return _collect(ctx, group, x,
                    lambda parts: reduce_parts(parts, devs, op),
                    f"all_reduce[{op}]", _cross_reduce(op))


def mesh_all_gather(x, dim, axes):
    """The group's parts concatenated on ``dim``, in group order."""
    ctx, group = _group_of(axes)
    if group is None:
        return x
    devs = ctx.devices(group)
    return _collect(ctx, group, x,
                    lambda parts: gather_parts(parts, dim, devs),
                    "all_gather", _cross_gather(dim))


def mesh_split(x, dim, axes):
    """The running rank's equal chunk of ``x`` on ``dim`` among its group
    (no communication)."""
    ctx, group = _group_of(axes)
    if group is None:
        return x
    n = len(group)
    if x.shape[dim] % n:
        raise ValueError(f"mesh_split: dimension {dim} ({x.shape[dim]}) "
                         f"does not divide into {n} equal parts")
    return x.chunk(n, dim=dim)[group.index(ctx.rank)]


def mesh_exchange(value, axes, combine, name):
    """The general form: every rank of the group hands in ``value``;
    ``combine(values)`` (group order, run once) returns one result a
    rank.  None outside a rank or for a group of one."""
    ctx, group = _group_of(axes)
    if group is None:
        return None
    return _collect(ctx, group, value, combine, name)


# -- the paddle API ------------------------------------------------------
def _api_group(group):
    """``(ctx, ranks)`` over the ``group`` axis (or the region's)."""
    ctx = current_rank()
    if ctx is None:
        return None, None
    axis = group if isinstance(group, (str, tuple)) else ctx.axis
    if axis is None:
        raise ValueError("collective outside a parallel_region needs "
                         "group=<mesh axis name>")
    ranks = ctx.group(axis)
    return (ctx, ranks) if len(ranks) > 1 else (None, None)


def _set(t, value):
    """paddle's in-place result: written into ``t`` when that is legal
    for autograd; the result is returned either way."""
    if not t.requires_grad:
        with torch.no_grad():
            t.copy_(value)
        return t
    return value


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """reference: c_allreduce_op.h:109"""
    ctx, ranks = _api_group(group)
    if ctx is None:
        return tensor
    devs = ctx.devices(ranks)
    out = _collect(ctx, ranks, tensor,
                   lambda parts: reduce_parts(parts, devs, op),
                   f"all_reduce[{op}]", _cross_reduce(op))
    return _set(tensor, out)


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Appends the group's tensors (group order) to ``tensor_list``.  The
    serving form ``all_gather(parts, dim, devices)`` (an int second
    argument) is the serving pair's gather."""
    if isinstance(tensor, int):
        return _serving_all_gather(tensor_list, tensor, group)
    ctx, ranks = _api_group(group)
    if ctx is None:
        tensor_list.append(tensor)
        return tensor_list
    devs = ctx.devices(ranks)
    full = _collect(ctx, ranks, tensor[None],
                    lambda parts: gather_parts(parts, 0, devs),
                    "all_gather", _cross_gather(0))
    tensor_list.extend(full.unbind(0))
    return tensor_list


def all_gather_object(obj_list, obj, group=None):
    """Outside any rank, every process's ``obj`` (one process: ``obj``)."""
    if current_rank() is None and process.count() > 1:
        obj_list.extend(process.all_gather_object(obj))
        return obj_list
    obj_list.append(obj)
    return obj_list


def broadcast(tensor, src=0, group=None, sync_op=True):
    ctx, ranks = _api_group(group)
    if ctx is None:
        return tensor
    devs = ctx.devices(ranks)
    out = _collect(ctx, ranks, tensor,
                   lambda parts: [_to(parts[src], d) for d in devs],
                   "broadcast")
    return _set(tensor, out)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    ctx, ranks = _api_group(group)
    if ctx is None:
        return tensor
    devs = ctx.devices(ranks)
    red = _collect(ctx, ranks, tensor,
                   lambda parts: reduce_parts(parts, devs, op),
                   f"reduce[{op}]")
    return _set(tensor, red if ranks.index(ctx.rank) == dst else tensor)


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    ctx, ranks = _api_group(group)
    if ctx is None:
        if tensor_list:
            return _set(tensor, tensor_list[src])
        return tensor
    devs = ctx.devices(ranks)
    out = _collect(ctx, ranks, tensor_list,
                   lambda parts: [_to(parts[src][i], d)
                                  for i, d in enumerate(devs)],
                   "scatter")
    return _set(tensor, out)


def reduce_scatter(output, input_list, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    ctx, ranks = _api_group(group)
    if ctx is None:
        return _set(output, input_list[0])
    devs = ctx.devices(ranks)
    out = _collect(ctx, ranks, torch.stack(list(input_list)),
                   lambda parts: [o[0] for o in scatter_reduce_parts(
                       parts, 0, devs)], "reduce_scatter")
    return _set(output, out)


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True):
    ctx, ranks = _api_group(group)
    if ctx is None:
        out_tensor_list.extend(in_tensor_list)
        return out_tensor_list
    devs = ctx.devices(ranks)
    got = _collect(ctx, ranks, list(in_tensor_list),
                   lambda parts: [[_to(p[i], d) for p in parts]
                                  for i, d in enumerate(devs)], "alltoall")
    out_tensor_list.extend(got)
    return out_tensor_list


def send(tensor, dst=0, group=None, sync_op=True):
    raise NotImplementedError(
        "point-to-point send/recv: use p2p_shift inside a parallel_region "
        "or the pipeline schedules (parallel/pipeline.py)")


recv = send
isend = send
irecv = send


def p2p_shift(x, axis=None, shift=1):
    """Ring shift over ``axis``: rank i gets rank i - shift's ``x``."""
    ctx, ranks = _api_group(axis)
    if ctx is None:
        return x
    devs = ctx.devices(ranks)
    n = len(ranks)
    return _collect(ctx, ranks, x,
                    lambda parts: [_to(parts[(i - shift) % n], d)
                                   for i, d in enumerate(devs)],
                    f"p2p_shift[{shift}]", _cross_shift(shift))


def barrier(group=None):
    """Every process meets here (outside any rank); the lockstep orders
    the ranks of one process already."""
    if current_rank() is None:
        process.barrier()


def get_group(ring_id=0):
    return None


def parallel_region(fn, axis="dp", mesh=None, in_specs=None,
                    out_specs=None):
    """``shard_map`` of the JAX package: ``fn`` runs on every rank of
    ``mesh`` (default the process mesh) with the collective API above
    acting over ``axis``.  ``in_specs`` / ``out_specs``: one spec a
    positional input / the output, ``(axis,)`` (the default) splitting or
    concatenating the leading dim over ``axis``, ``()`` replicating (the
    output of the group's first rank).  Over a mesh spanning processes an
    input may be a ``RankPieces`` (``mesh.host_local_to_global``), each
    local rank taking its piece, and the output is the local ranks'
    ``RankPieces``."""
    from . import mesh as mesh_mod

    def wrapped(*arrays):
        m = mesh if mesh is not None else mesh_mod.ensure_mesh()
        ispec = in_specs if in_specs is not None else (axis,)
        ospec = out_specs if out_specs is not None else (axis,)
        specs = (ispec if isinstance(ispec, list)
                 else [ispec] * len(arrays))
        n = m.axis_size(axis)
        fns = {}
        for r in m.local_ranks:
            i = m.coords(r)[axis]
            dev = m.flat_devices[r]
            args = [a.pieces[r] if isinstance(a, mesh_mod.RankPieces)
                    else torch.as_tensor(a).chunk(n)[i].to(dev) if s
                    else torch.as_tensor(a).to(dev)
                    for a, s in zip(arrays, specs)]
            fns[r] = (lambda a=args: fn(*a))
        outs = run_ranks(m, fns, axis=axis)
        if m.spans_processes:
            one = next(iter(outs.values()))
            shape = ((one.shape[0] * n,) + tuple(one.shape[1:]) if ospec
                     else tuple(one.shape))
            return mesh_mod.RankPieces(shape, (axis,) if ospec else (), m,
                                       outs)
        row = m.group(0, axis)
        if ospec:
            return torch.cat([outs[r].to(m.flat_devices[0]) for r in row])
        return outs[0]

    return wrapped
