"""The processes of a job and the transport between them — the port's
counterpart of ``jax.distributed`` (``jax.process_index``,
``jax.process_count``, ``jax.devices`` over every process).

``init()`` joins the job the launcher's env contract names
(``PADDLE_TRAINERS_NUM``, ``PADDLE_TRAINER_ID``, and
``PADDLE_TRAINER_ENDPOINTS``, whose first entry is the TCP store's
address, as it is JAX's coordinator): it opens the store, publishes this
process's local devices (its visible cards, or ``PADDLE_DEVICES_PER_PROC``
CPU ranks, which ``launch --devices_per_proc`` sets) and calls
``torch.distributed.init_process_group`` with an explicit timeout
(``PADDLE_DIST_TIMEOUT_S``, 60 s by default), so that a hang fails
instead of waiting forever.  The backend follows the
topology and is never a retry after a failure: NCCL when every process's
cards are its own (no card UUID seen by two processes), gloo when
processes share a card or run on the CPU.

``devices()`` is every process's devices, process 0's first, as
``jax.devices()`` orders them: ``ProcessDevice``\\ s, which a mesh reads
to learn which process owns each rank (``distributed/mesh.py``).

The transport (``all_reduce``, ``all_gather``, ``send`` / ``recv`` and
``p2p`` over them, ``all_gather_object``) is what the collectives call where a group spans
processes (``distributed/collective.py``).  Every crossing of a group
first all-gathers a header — the group's key, its sequence number, the
call's name and its size — and raises, naming both calls, when the
processes disagree, instead of hanging or mixing two calls' data.  Under
gloo a CUDA tensor is staged through a pinned host buffer both ways
(gloo's own CUDA support differs by call); under NCCL it stays on the
card.  Each crossing runs under the profiler label ``process.<kind>``,
and ``stats()`` counts calls, bytes handed across, bytes staged between
card and host, and seconds, by kind.
"""
from __future__ import annotations

import collections
import datetime
import hashlib
import os
import pickle
import threading
import time
import zlib

import numpy as np
import torch
import torch.distributed as tdist

_world = None
_lock = threading.RLock()


class ProcessDevice:
    """One device of the job: the process that owns it, its index among
    the job's devices, and the ``torch.device`` it is in its process."""

    def __init__(self, process_index, id, device):
        self.process_index = int(process_index)
        self.id = int(id)
        self.device = torch.device(device)

    def __repr__(self):
        return (f"ProcessDevice(id={self.id}, process={self.process_index}, "
                f"{self.device})")


class _World:
    def __init__(self, rank, size, backend, devices, store):
        self.rank = rank
        self.size = size
        self.backend = backend
        self.devices = devices
        self.store = store
        self.seq = collections.Counter()
        self.groups = {}
        self.stats = collections.defaultdict(
            lambda: {"calls": 0, "bytes": 0, "staged_bytes": 0,
                     "seconds": 0.0})
        self.pinned = {}


def _local_devices():
    n = os.environ.get("PADDLE_DEVICES_PER_PROC")
    if n:
        return [torch.device("cpu")] * int(n)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _card_ids(devs):
    ids = []
    for d in devs:
        if d.type == "cuda":
            ids.append(str(getattr(torch.cuda.get_device_properties(d),
                                   "uuid", d.index)))
    return ids


def choose_backend(cards):
    """The backend for processes whose cards are ``cards`` (one list of
    card UUIDs a process): NCCL when every process has cards and no card
    is seen by two processes, else gloo (processes sharing a card, which
    NCCL refuses, or on the CPU)."""
    seen = [u for ids in cards for u in ids]
    own = all(cards) and len(seen) == len(set(seen))
    return "nccl" if own else "gloo"


def init():
    """Join the job of the env contract (module docstring); a job of one
    process needs nothing and sets nothing up.  ``PADDLE_DIST_TIMEOUT_S``
    (60 s by default) bounds the join and every later collective.
    Returns the world size.  Idempotent; a failed init raises."""
    global _world
    if _world is not None:
        return _world.size
    size = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if size <= 1 or not os.environ.get("PADDLE_TRAINER_ENDPOINTS"):
        return 1
    rank = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    host, port = os.environ["PADDLE_TRAINER_ENDPOINTS"].split(",")[0] \
        .rsplit(":", 1)
    timeout = datetime.timedelta(
        seconds=float(os.environ.get("PADDLE_DIST_TIMEOUT_S", "60")))
    store = tdist.TCPStore(host, int(port), size, is_master=rank == 0,
                           timeout=timeout)
    devs = _local_devices()
    if not devs:
        raise RuntimeError(
            "distributed.init_parallel_env: this process sees no CUDA card; "
            "launch with --devices_per_proc N to run N CPU ranks")
    store.set(f"ptt/devices/{rank}", pickle.dumps(
        ([str(d) for d in devs], _card_ids(devs))))
    per = [pickle.loads(store.get(f"ptt/devices/{p}")) for p in range(size)]
    backend = choose_backend([ids for _, ids in per])
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=size, timeout=timeout)
    owned = [(p, name) for p, (names, _) in enumerate(per)
             for name in names]
    devices = [ProcessDevice(p, i, name) for i, (p, name) in enumerate(owned)]
    _world = _World(rank, size, backend, devices, store)
    if backend == "nccl":
        torch.cuda.set_device(devs[0])
    return size


def index():
    """This process's index (``jax.process_index``); 0 alone."""
    return 0 if _world is None else _world.rank


def count():
    """The number of processes (``jax.process_count``)."""
    return 1 if _world is None else _world.size


def backend():
    return None if _world is None else _world.backend


def devices():
    """Every process's devices in job order (``jax.devices``); alone,
    this process's visible cards (``PADDLE_DEVICES_PER_PROC`` CPU ranks
    when set)."""
    if _world is not None:
        return list(_world.devices)
    return [ProcessDevice(0, i, d) for i, d in enumerate(_local_devices())]


def stats(reset=False):
    """``{kind: {"calls", "bytes", "staged_bytes", "seconds"}}`` of the
    crossings so far (``bytes``: what this process handed across;
    ``staged_bytes``: what moved between a card and pinned host memory
    for them)."""
    if _world is None:
        return {}
    out = {k: dict(v) for k, v in _world.stats.items()}
    if reset:
        _world.stats.clear()
    return out


# -- the transport -----------------------------------------------------------
def _group(procs):
    """The process group over ``procs`` (sorted): the default one for the
    whole job, else one made for that set and kept."""
    procs = tuple(sorted(procs))
    if len(procs) == _world.size:
        return None
    pg = _world.groups.get(procs)
    if pg is None:
        pg = tdist.new_group(list(procs), use_local_synchronization=True)
        _world.groups[procs] = pg
    return pg


def _wire_device():
    if _world.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _stage_out(t, kind, keep=True):
    """``t`` as the backend takes it: on the CPU under gloo (a CUDA
    tensor through a pinned buffer, kept for the next call of its size
    unless ``keep`` is false), on the card under NCCL."""
    t = t.contiguous()
    wire = _wire_device()
    if t.device == wire:
        return t
    if wire.type == "cpu":
        key = (t.dtype, t.numel())
        buf = _world.pinned.get(key) if keep else None
        if buf is None:
            buf = torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
            if keep:
                _world.pinned[key] = buf
        buf = buf.view(t.shape)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        _world.stats[kind]["staged_bytes"] += t.numel() * t.element_size()
        return buf
    return t.to(wire)


def _stage_in(t, device, kind):
    if t.device == device:
        return t
    if t.device.type == "cpu" and device.type == "cuda":
        _world.stats[kind]["staged_bytes"] += t.numel() * t.element_size()
    return t.to(device)


def _crc(s):
    return zlib.crc32(repr(s).encode()) & 0x7FFFFFFF


def _check(procs, key, name, size, kind):
    """The header exchange (module docstring): every process of ``procs``
    hands in (key, sequence, name, size) of the call it is making; a
    mismatch raises on every one of them, naming each process's call."""
    seq = _world.seq[key]
    _world.seq[key] = seq + 1
    head = torch.tensor([_crc(key), seq, _crc(name), int(size)],
                        dtype=torch.int64, device=_wire_device())
    outs = [torch.empty_like(head) for _ in procs]
    tdist.all_gather(outs, head, group=_group(procs))
    rows = [tuple(o.tolist()) for o in outs]
    if len(set(rows)) > 1:
        mine = (key, seq, name, int(size))
        calls = [None] * len(procs)
        tdist.all_gather_object(calls, mine, group=_group(procs))
        desc = "; ".join(
            f"process {p} calls {c[2]} #{c[1]} over {c[0]} ({c[3]} bytes)"
            for p, c in zip(procs, calls))
        raise RuntimeError(
            f"cross-process collectives out of order: {desc}.  Every "
            "process must run the same collectives in the same order")
    return seq


class _Timed:
    def __init__(self, kind, nbytes):
        self.kind, self.nbytes = kind, nbytes

    def __enter__(self):
        self.rf = torch.profiler.record_function(f"process.{self.kind}")
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        st = _world.stats[self.kind]
        st["calls"] += 1
        st["bytes"] += self.nbytes
        st["seconds"] += time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        return False


_OPS = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX,
        "min": tdist.ReduceOp.MIN, "prod": tdist.ReduceOp.PRODUCT}


def all_reduce(t, procs=None, op="sum", key="world", name="all_reduce",
               kind="all_reduce"):
    """``t`` reduced over the processes ``procs`` (default all), on
    ``t``'s device; a new tensor."""
    procs = tuple(range(_world.size)) if procs is None else tuple(procs)
    nbytes = t.numel() * t.element_size()
    with _lock, _Timed(kind, nbytes):
        _check(procs, key, name, nbytes, kind)
        w = _stage_out(t, kind)
        if w is t:
            w = t.clone()
        tdist.all_reduce(w, op=_OPS[op], group=_group(procs))
        return _stage_in(w, t.device, kind)


def all_gather(t, procs=None, key="world", name="all_gather",
               kind="all_gather"):
    """Every process's ``t`` (equal shapes), in ``procs`` order, on
    ``t``'s device."""
    procs = tuple(range(_world.size)) if procs is None else tuple(procs)
    nbytes = t.numel() * t.element_size()
    with _lock, _Timed(kind, nbytes):
        _check(procs, key, name, nbytes, kind)
        w = _stage_out(t, kind)
        outs = [torch.empty_like(w, device=w.device) for _ in procs]
        tdist.all_gather(outs, w, group=_group(procs))
        return [_stage_in(o, t.device, kind) for o in outs]


def all_gather_object(obj, procs=None, key="world", name="object"):
    """Every process's picklable ``obj``, in ``procs`` order."""
    procs = tuple(range(_world.size)) if procs is None else tuple(procs)
    with _lock, _Timed("all_gather", 0):
        _check(procs, key, name, 0, "all_gather")
        out = [None] * len(procs)
        tdist.all_gather_object(out, obj, group=_group(procs))
        return out


def barrier(key="barrier"):
    if _world is None:
        return
    all_gather_object(None, key=key, name="barrier")


def _tag(key):
    """An even tag for the header; the payload takes the odd one after."""
    return (_crc(key) & 0xFFFFFF) * 2


def send(t, dst, key):
    """Hand ``t`` to process ``dst`` under ``key`` (matched by ``recv``
    with the same key, in any order); returns the pending work, which
    the caller waits on (``wait``) before the step ends."""
    nbytes = t.numel() * t.element_size()
    with _lock, _Timed("p2p", nbytes):
        head = torch.tensor([_crc(key), t.dim(), *t.shape,
                             *([0] * (8 - t.dim())),
                             _DTYPES.index(t.dtype)],
                            dtype=torch.int64)
        w = _stage_out(t, "p2p", keep=False)
        tag = _tag(key)
        return [tdist.isend(head.to(_wire_device()), dst, tag=tag),
                tdist.isend(w if w is not t else t.clone(), dst,
                            tag=tag + 1)]


def recv(src, key, device):
    """The tensor process ``src`` sent under ``key``, on ``device``;
    raises when the sender's key differs."""
    with _lock, _Timed("p2p", 0) as timed:
        tag = _tag(key)
        head = torch.empty(11, dtype=torch.int64, device=_wire_device())
        tdist.recv(head, src, tag=tag)
        h = head.tolist()
        if h[0] != _crc(key):
            raise RuntimeError(
                f"cross-process p2p out of order: expected {key} from "
                f"process {src}")
        shape = h[2:2 + h[1]]
        buf = torch.empty(shape, dtype=_DTYPES[h[10]], device=_wire_device())
        tdist.recv(buf, src, tag=tag + 1)
        timed.nbytes = buf.numel() * buf.element_size()
        return _stage_in(buf, torch.device(device), "p2p")


def p2p(sends, recvs, procs, key, name):
    """One point-to-point crossing among the processes ``procs``, all of
    which make it: ``sends`` is ``[(tensor, dst, tag)]``, ``recvs``
    ``[(src, tag, device)]``, matched by ``tag``; returns the received
    tensors in ``recvs`` order.  The header exchange (``_check``) runs
    first, so that processes making different calls raise naming them,
    and every payload's key carries the call's sequence number."""
    procs = tuple(procs)
    with _lock:
        with _Timed("p2p", 0):
            seq = _check(procs, key, name, 0, "p2p")
        works = []
        for t, dst, tag in sends:
            works += send(t, dst, key + (seq, tag))
        got = [recv(src, key + (seq, tag), device)
               for src, tag, device in recvs]
        wait(works)
        return got


def wait(works):
    for w in works:
        w.wait()


_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
           torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool]


def digest(arrays):
    """An int64 digest of the bytes of ``arrays`` (numpy or tensors)."""
    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return int(np.frombuffer(h.digest()[:8], np.int64)[0])
