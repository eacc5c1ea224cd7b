"""Collectives over a mesh's ranks — counterpart of
``paddle_tpu/distributed/collective.py``.

The JAX package lowers its collectives to XLA ops on named mesh axes
inside ``shard_map``.  The port drives every rank from one process (see
``distributed/mesh.py``), so a collective is a function of the ranks'
parts, ``parts[i]`` on ``devices[i]``:

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

    def exchange(self, rank, group, value, combine, name):
        group = tuple(group)
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
            if len(slot["parts"]) == len(group):
                parts = [slot["parts"][r] for r in group]
                with _bare():
                    outs = combine(parts)
                slot["out"] = dict(zip(group, outs))
                slot["parts"] = None
                self.waiting.difference_update(group)
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
    flat rank), in lockstep (module docstring); returns ``{r: result}``.
    Re-raises the first error of any rank."""
    runner = _Lockstep(fns)
    ctxs = {r: RankContext(mesh, r, runner, axis=axis,
                           batch_split=batch_split) for r in fns}
    base = int(torch.randint(0, 2 ** 62, (1,)).item())
    seeds = {r: (base + 7919 * r) % (2 ** 63) for r in fns}
    return runner.run(mesh, fns, ctxs, seeds)


def _collect(ctx, group, value, combine, name):
    """``value`` meets the group's other parts (or, in a replayed region,
    the recorded result comes back)."""
    replaying = next((r for r in reversed(ctx.regions) if r.replay), None)
    if replaying is not None:
        out = _thaw(replaying.stash[replaying.cursor])
        replaying.cursor += 1
    else:
        if ctx.runner is None:
            raise RuntimeError(
                f"{name}: rank {ctx.rank} is not running under run_ranks")
        out = ctx.runner.exchange(ctx.rank, group, value, combine, name)
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
                    f"all_reduce[{op}]")


def mesh_all_gather(x, dim, axes):
    """The group's parts concatenated on ``dim``, in group order."""
    ctx, group = _group_of(axes)
    if group is None:
        return x
    devs = ctx.devices(group)
    return _collect(ctx, group, x,
                    lambda parts: gather_parts(parts, dim, devs),
                    "all_gather")


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
                   f"all_reduce[{op}]")
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
                    "all_gather")
    tensor_list.extend(full.unbind(0))
    return tensor_list


def all_gather_object(obj_list, obj, group=None):
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
                    f"p2p_shift[{shift}]")


def barrier(group=None):
    return None     # the lockstep orders every rank's work already


def get_group(ring_id=0):
    return None


def parallel_region(fn, axis="dp", mesh=None, in_specs=None,
                    out_specs=None):
    """``shard_map`` of the JAX package: ``fn`` runs on every rank of
    ``mesh`` (default the process mesh) with the collective API above
    acting over ``axis``.  ``in_specs`` / ``out_specs``: one spec a
    positional input / the output, ``(axis,)`` (the default) splitting or
    concatenating the leading dim over ``axis``, ``()`` replicating (the
    output of the group's first rank)."""
    from . import mesh as mesh_mod

    def wrapped(*arrays):
        m = mesh if mesh is not None else mesh_mod.ensure_mesh()
        ispec = in_specs if in_specs is not None else (axis,)
        ospec = out_specs if out_specs is not None else (axis,)
        specs = (ispec if isinstance(ispec, list)
                 else [ispec] * len(arrays))
        n = m.axis_size(axis)
        fns = {}
        for r in range(m.size):
            i = m.coords(r)[axis]
            dev = m.flat_devices[r]
            args = [torch.as_tensor(a).chunk(n)[i].to(dev) if s
                    else torch.as_tensor(a).to(dev)
                    for a, s in zip(arrays, specs)]
            fns[r] = (lambda a=args: fn(*a))
        outs = run_ranks(m, fns, axis=axis)
        row = m.group(0, axis)
        if ospec:
            return torch.cat([outs[r].to(m.flat_devices[0]) for r in row])
        return outs[0]

    return wrapped
