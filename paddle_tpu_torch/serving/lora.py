"""Multi-adapter (LoRA) serving: low-rank deltas as per-slot lanes (the
PyTorch counterpart of ``paddle_tpu/serving/lora.py``).

Anything that varies per request is DATA of one dispatch, never shape:
sampling parameters, positions, block tables, int8 codes, and LoRA
deltas.  An adapter contributes ``delta = (x @ A^T) @ B^T`` on the
attention output projection; stacking every adapter's zero-padded
factors into two dense banks on the engine's device

    a_bank : [n_lanes, n_layers, r_max, E]   (f32)
    b_bank : [n_lanes, n_layers, E, r_max]   (f32)

turns "which adapter" into a per-slot lane id that gathers its factors
out of the banks (``models/gpt.py`` ``_lora_scope`` and
``GPTAttention._out``).  Lane 0 is all zeros: the base model.  The bank
shapes are fixed at engine construction (``max_adapters`` lanes), so
hot-loading an adapter writes one lane in place and changes no shape.

Smaller ranks are zero-padded to ``r_max``, which is exact.  The
``alpha / rank`` scale is folded into the stored B factor once at
registration.

The merged-weights oracle (``LoRAAdapter.merged_delta`` / ``merge_into``)
is the ground truth the lanes are held to: folding ``scale * (B @ A)``
into ``out_proj.weight`` must give token-identical decodes.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..device import resolve_device


class UnknownAdapter(KeyError):
    """A request named an adapter this engine has not loaded."""


class AdapterInUse(RuntimeError):
    """unload_adapter refused: in-flight requests still pin the
    adapter (queued or decoding); retry after they drain."""


class RegistryFull(RuntimeError):
    """No free lane: the engine was built with ``max_adapters`` lanes
    and all of them hold live adapters."""


class LoRAAdapter:
    """One adapter's factors.

    A : [rank, E] or [n_layers, rank, E]  — the down-projection
    B : [E, rank] or [n_layers, E, rank]  — the up-projection
    2-D factors are broadcast to every layer.  ``alpha`` is the usual
    LoRA scaling numerator (effective scale ``alpha / rank``; default
    scale 1.0).  The delta applies to the attention output projection:
    ``y = out_proj(x) + scale * (x @ A^T) @ B^T``.
    """

    def __init__(self, rank, A, B, alpha=None, name=None):
        rank = int(rank)
        if rank < 1:
            raise ValueError(f"rank must be >= 1, got {rank}")
        A = np.asarray(A, np.float32)
        B = np.asarray(B, np.float32)
        if A.ndim == 2:
            A = A[None]
        if B.ndim == 2:
            B = B[None]
        if A.ndim != 3 or B.ndim != 3:
            raise ValueError(
                f"A/B must be [rank, E]/[E, rank] (optionally with a "
                f"leading n_layers axis), got {A.shape} / {B.shape}")
        if A.shape[-2] != rank or B.shape[-1] != rank:
            raise ValueError(
                f"factor shapes {A.shape} / {B.shape} disagree with "
                f"rank={rank} (want [..., {rank}, E] / [..., E, {rank}])")
        if A.shape[-1] != B.shape[-2]:
            raise ValueError(
                f"hidden dims disagree: A {A.shape} vs B {B.shape}")
        if A.shape[0] != B.shape[0]:
            raise ValueError(
                f"layer counts disagree: A {A.shape} vs B {B.shape}")
        self.rank = rank
        self.hidden = int(A.shape[-1])
        self.A = A
        self.B = B
        self.alpha = float(alpha) if alpha is not None else float(rank)
        self.scale = self.alpha / rank
        self.name = name

    @classmethod
    def random(cls, rank, hidden, n_layers=1, seed=0, scale=0.02,
               name=None):
        """Gaussian factors for tests/examples/benchmarks — ``scale``
        keeps the delta small enough that adapted decodes stay
        plausible but distinct from the base model."""
        rng = np.random.RandomState(seed)
        A = rng.normal(0.0, scale, (n_layers, rank, hidden))
        B = rng.normal(0.0, scale, (n_layers, hidden, rank))
        return cls(rank, A, B, name=name)

    def factors(self, n_layers, r_max):
        """(a, b) zero-padded to the bank slot shape:
        a [n_layers, r_max, E], b [n_layers, E, r_max] — the LoRA
        scale folded into b so the hot path never multiplies it."""
        if self.rank > r_max:
            raise ValueError(
                f"adapter rank {self.rank} exceeds the engine's "
                f"r_max={r_max} (fixed at construction)")
        A, B = self.A, self.B
        if A.shape[0] == 1 and n_layers > 1:
            A = np.broadcast_to(A, (n_layers,) + A.shape[1:])
            B = np.broadcast_to(B, (n_layers,) + B.shape[1:])
        if A.shape[0] != n_layers:
            raise ValueError(
                f"adapter has {A.shape[0]} layers of factors, model "
                f"has {n_layers}")
        E = self.hidden
        a = np.zeros((n_layers, r_max, E), np.float32)
        b = np.zeros((n_layers, E, r_max), np.float32)
        a[:, :self.rank, :] = A
        b[:, :, :self.rank] = B * self.scale
        return a, b

    def merged_delta(self, n_layers):
        """[n_layers, E, E] weight delta in the JAX package's Linear
        layout ([in, out], ``y = x W``): ``scale * (B @ A)^T`` per
        layer — the offline merged-weights oracle."""
        A, B = self.A, self.B
        if A.shape[0] == 1 and n_layers > 1:
            A = np.broadcast_to(A, (n_layers,) + A.shape[1:])
            B = np.broadcast_to(B, (n_layers,) + B.shape[1:])
        return np.stack([
            self.scale * (B[i] @ A[i]).T for i in range(n_layers)
        ]).astype(np.float32)

    def merge_into(self, model):
        """Fold this adapter into ``model``'s attention ``out_proj``
        weights in place: the oracle a lane-gathered engine must match
        token for token.  ``merged_delta`` is in the ``[in, out]`` layout
        of ``y = x W``; a torch ``nn.Linear`` keeps ``[out, in]``, so its
        weight takes the transpose.  Returns the model."""
        blocks = list(model.blocks)
        delta = self.merged_delta(len(blocks))
        with torch.no_grad():
            for i, blk in enumerate(blocks):
                w = blk.attn.out_proj.weight
                w.add_(torch.from_numpy(delta[i].T.copy()).to(w))
        return model


class _Loaded:
    __slots__ = ("adapter", "lane", "pins")

    def __init__(self, adapter, lane):
        self.adapter = adapter
        self.lane = lane
        self.pins = 0


class AdapterRegistry:
    """Name -> lane mapping plus the two banks, f32 tensors on ``device``
    (None = the CUDA card, as every entry point of the port).

    Built once per engine; lane 0 is the all-zeros base lane and is
    never assigned.  ``load`` / ``unload`` write one lane in place: the
    bank shapes never change.  Pin counts (one per in-flight request)
    guard unload; the engine pins at submit and unpins through the
    request's finish callback.

    Thread safety: name and pin bookkeeping take ``_lock`` (submits come
    from any thread); bank writes are the engine thread's, between ticks
    after the ring drains, so a dispatch reads a stable bank.
    """

    def __init__(self, n_layers, hidden, max_adapters, r_max,
                 device=None):
        if max_adapters < 1:
            raise ValueError(
                f"max_adapters must be >= 1, got {max_adapters}")
        if r_max < 1:
            raise ValueError(f"r_max must be >= 1, got {r_max}")
        self.n_layers = int(n_layers)
        self.hidden = int(hidden)
        self.max_adapters = int(max_adapters)
        self.r_max = int(r_max)
        self.n_lanes = self.max_adapters + 1  # +1: the base lane 0
        self.device = resolve_device(device)
        self.a_bank = torch.zeros(
            (self.n_lanes, self.n_layers, self.r_max, self.hidden),
            dtype=torch.float32, device=self.device)
        self.b_bank = torch.zeros(
            (self.n_lanes, self.n_layers, self.hidden, self.r_max),
            dtype=torch.float32, device=self.device)
        self._lock = threading.Lock()
        self._by_name = {}
        self._free = list(range(self.n_lanes - 1, 0, -1))  # pop() -> 1

    # -- inventory -------------------------------------------------------
    def names(self):
        with self._lock:
            return sorted(self._by_name)

    def __contains__(self, name):
        with self._lock:
            return name in self._by_name

    def __len__(self):
        with self._lock:
            return len(self._by_name)

    def lane(self, name):
        """Resolve a request's adapter name to its bank lane."""
        with self._lock:
            entry = self._by_name.get(name)
            if entry is None:
                raise UnknownAdapter(
                    f"unknown adapter {name!r}: loaded="
                    f"{sorted(self._by_name)}")
            return entry.lane

    def pins(self, name):
        with self._lock:
            entry = self._by_name.get(name)
            return 0 if entry is None else entry.pins

    def describe(self):
        """{name: {"lane", "rank", "pins"}} — the /debug surface."""
        with self._lock:
            return {n: {"lane": e.lane, "rank": e.adapter.rank,
                        "pins": e.pins}
                    for n, e in sorted(self._by_name.items())}

    # -- pinning (submit / finish) ---------------------------------------
    def pin(self, name):
        """Take a lane reference for an in-flight request; returns the
        lane.  Pinned adapters refuse unload — a mid-stream bank swap
        would silently change the request's model."""
        with self._lock:
            entry = self._by_name.get(name)
            if entry is None:
                raise UnknownAdapter(
                    f"unknown adapter {name!r}: loaded="
                    f"{sorted(self._by_name)}")
            entry.pins += 1
            return entry.lane

    def unpin(self, name):
        with self._lock:
            entry = self._by_name.get(name)
            if entry is not None and entry.pins > 0:
                entry.pins -= 1

    # -- bank mutation (engine thread, between ticks) --------------------
    def load(self, name, adapter):
        """Write ``adapter`` into a free lane under ``name``; returns
        the lane.  Shapes are validated against the banks: loading is
        pure data movement."""
        if not isinstance(adapter, LoRAAdapter):
            raise TypeError(
                f"expected LoRAAdapter, got {type(adapter).__name__}")
        if adapter.hidden != self.hidden:
            raise ValueError(
                f"adapter hidden={adapter.hidden} vs model "
                f"hidden={self.hidden}")
        a, b = adapter.factors(self.n_layers, self.r_max)
        with self._lock:
            if name in self._by_name:
                raise ValueError(
                    f"adapter {name!r} already loaded (unload first)")
            if not self._free:
                raise RegistryFull(
                    f"all {self.max_adapters} adapter lanes in use: "
                    f"{sorted(self._by_name)}")
            lane = self._free.pop()
            self._by_name[name] = _Loaded(adapter, lane)
        self.a_bank[lane] = torch.from_numpy(a).to(self.device)
        self.b_bank[lane] = torch.from_numpy(b).to(self.device)
        return lane

    def unload(self, name):
        """Zero ``name``'s lane and free it.  Refuses (AdapterInUse)
        while any in-flight request pins the adapter."""
        with self._lock:
            entry = self._by_name.get(name)
            if entry is None:
                raise UnknownAdapter(
                    f"unknown adapter {name!r}: loaded="
                    f"{sorted(self._by_name)}")
            if entry.pins > 0:
                raise AdapterInUse(
                    f"adapter {name!r} pinned by {entry.pins} "
                    f"in-flight request(s); drain them before unload")
            del self._by_name[name]
            lane = entry.lane
            self._free.append(lane)
        self.a_bank[lane] = 0.0
        self.b_bank[lane] = 0.0
        return lane
