"""Continuous-batching inference engine over a fixed slot pool — the
PyTorch counterpart of ``paddle_tpu/serving/engine.py``.

Each tick admits queued requests into free slots (the paged admission
gate adopts cached prompt prefixes and reserves every block a request
could need), prefills them, then runs ONE decode dispatch.  Two
dispatch families serve it:

* ``attn_impl="ragged"`` (the port's default) / ``"ragged_gather"``:
  ONE ragged window dispatch (``GPTModel._fused_ragged_tick_slots``)
  over the paged pools, through the ragged attention kernels: decoding
  slots ride as one-token lanes (``spec_k + 1``-token verify windows
  under speculative decoding, drafted by a ``serving.spec`` proposer),
  budgeted prefill chunks as lanes of up to ``prefill_chunk`` tokens.
* ``attn_impl="xla"`` (the JAX engine's default): the plain torch
  windows of the JAX package's XLA programs over contiguous slot rows
  (``kv_block_size=None``) or block pools — the fused decode or verify
  tick, and chunks as one dispatch each (``prefill.chunk``).

Either way sampling, the accept scan and the eos / max_new_tokens stop
condition run in the dispatch's epilogue on the device
(``sample_mode="device"``), or the logits come home and numpy samples
them on a per-request ``np.random.default_rng(seed)`` stream
(``sample_mode="host"``, the JAX engine's exact host numerics).
``prefill_chunk=None`` prefills each admitted prompt whole at
admission (``prefill``; on contiguous rows optionally right-padded to
``prefill_buckets``), on every path.

The loop is pipelined (``async_depth=2``, the default): a tick plans and
admits while the previous tick computes, dispatches tick N+1, and only
then consumes tick N.  A steady-state dispatch synchronizes nothing:
its inputs go up through pinned staging buffers with ``non_blocking``
copies, its picks, counts and done mask come home packed in one
``non_blocking`` download that a CUDA event marks, and the consume's
wait on that event (``decode.d2h_wait``) is the loop's one sync point.
Admission, eviction and preemption dirty the host mirrors of the
device-resident step state; the ring drains before they are uploaded
again.  ``async_depth=1`` dispatches and consumes in the same tick.

The engine serves on one device or over an ``(mp, dp)`` serving mesh
(``mesh=``: the tensor-parallel model's heads, FFN and vocab split over
mp, the batch slots and the KV block pool over dp; one controller drives
every rank, ``serving/sharded.py``), with fp or int8 KV pools
(``kv_dtype="int8"``: ``QuantKV`` codes plus per-block per-head scales,
``serving/quant.py``), fp or weight-only int8 block Linears
(``weight_dtype="int8"``), a pool sized by blocks or by a byte budget
(``kv_budget_mb``), and either ragged kernel body (``attn_impl="ragged"``
streams to the causal horizon, ``"ragged_gather"`` gathers the whole
row).  Requests carry priorities, tenants and deadlines: a higher
priority may preempt a running stream, which resumes token-identically.
Metrics go to a ``monitor.StatRegistry`` under the JAX engine's names,
spans to a ``monitor.Tracer`` (``Engine.chrome_trace()``).

Per-request LoRA adapters (``adapters=`` / ``max_adapters=``,
``serving/lora.py``) ride every window as per-slot lanes of two
fixed-shape banks, hot-loaded between ticks (``load_adapter``); adapter
lanes never share cached K/V.  The host-RAM offload tier
(``kv_host_mb=``, ``serving/offload.py``) keeps the blocks the prefix
cache evicts and restores them at admission.  A
``serving.stream.TokenStream`` attached to a request receives its tokens
as they are emitted.

A live decoding stream migrates between engines (``migrate_out`` /
``migrate_in``: its full KV blocks and its resume snapshot, in the JAX
package's payload format, live or JSON), and a cached prefix warms a
peer (``export_prefix`` / ``import_prefix``); every order is serviced by
the engine thread at a tick boundary after the ring drains.  A
``serving.faults.FaultInjector`` (``faults=``) fires seeded failures at
the JAX engine's sites; ``watchdog_s=`` arms a ``TickWatchdog`` that
turns a wedged tick into a recorded recovery; a failing tick leaves its
flight record in ``last_flight`` (and ``flight_dir``).  The XLA and
monolithic paths over a mesh, the host tier over a mesh, and migration
over a mesh raise ``NotImplementedError`` naming their ``ROADMAP.md``
item.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import nullcontext

import numpy as np
import torch

from .. import monitor
from ..device import require_on
from ..distributed.mesh import ServingMesh, serving_mesh
from ..models import gpt as gpt_mod
from .faults import TickWatchdog, WatchdogTimeout
from .kvcache import (BlockPool, KVDtypeMismatch, PrefixCache,
                      export_blocks, import_blocks, payload_from_json,
                      per_shard_block_bytes)
from .lora import AdapterRegistry, LoRAAdapter, UnknownAdapter
from .offload import HostBlockStore, prefix_key
from .quant import QuantKV, relayout_weights_int8
from .request import (MAX_SEED, DeadlineShed, QueueFull, RateLimited,
                      Request, RequestQueue, TenantPolicy, TokenBucket)
from .scheduler import Scheduler
from .sharded import ShardedServingModel
from .spec import PromptLookupProposer


class Migrated(RuntimeError):
    """The request was handed off to another replica mid-stream (KV block
    migration): the terminal verdict its waiter receives on the SOURCE
    engine.  ``emitted`` is the token prefix generated here before the
    handoff (a holder that cannot complete the migration can always fail
    over with prompt + emitted as context).  ``payload`` is the full
    migration payload when ``migrate_out(..., deliver="error")`` routed it
    through the waiter (the waiter owns the import), else None."""

    def __init__(self, msg, payload=None, emitted=None):
        super().__init__(msg)
        self.payload = payload
        self.emitted = list(emitted or [])


class _MigrateDemand:
    """One order registered from any thread and serviced by the engine
    thread at a tick boundary (a migration export or import, a prefix
    export or import, an adapter load or unload): the same single-writer
    rule as every other pool and slot mutation."""

    __slots__ = ("kind", "args", "done", "result", "error",
                 "registered_at", "waiting")

    def __init__(self, kind, **args):
        self.kind = kind  # "out" | "in" | "prefix_out" | "prefix_in" |
        #   "adapter_load" | "adapter_unload"
        self.args = args
        self.done = threading.Event()
        self.result = None
        self.error = None
        self.registered_at = time.monotonic()
        self.waiting = False  # an "out" whose target is not yet
        #   exportable: retried every tick, but it must not keep an idle
        #   loop spinning (the submit that makes it actionable wakes it)

    def complete(self, result):
        self.result = result
        self.done.set()

    def fail(self, error):
        self.error = error
        self.done.set()

    def wait(self, timeout=None):
        if not self.done.wait(timeout):
            raise TimeoutError(
                f"migration {self.kind} demand: no verdict after "
                f"{timeout}s (engine not stepping?)")
        if self.error is not None:
            raise self.error
        return self.result


def _softmax_np(x):
    x = x - x.max()
    e = np.exp(x)
    return e / e.sum()


def _filter_logits_np(row, temperature, top_k, top_p):
    """Host-mode sampling filters of one logits row, in float64 numpy:
    temperature, then top-k, then top-p over the already-masked row (the
    JAX engine's host numerics, op for op)."""
    row = row.astype(np.float64)
    if temperature != 1.0:
        row = row / temperature
    if top_k and top_k > 0:
        kth = np.sort(row)[-min(top_k, len(row))]
        row = np.where(row < kth, -1e9, row)
    if top_p < 1.0:
        p_eff = max(float(top_p), 1e-9)
        srt = np.sort(row)[::-1]
        probs = _softmax_np(srt)
        cum = np.cumsum(probs)
        keep = (cum - probs) < p_eff
        cutoff = srt[keep].min()
        row = np.where(row < cutoff, -1e9, row)
    return row


def _resolve_mesh(mesh):
    """``Engine(mesh=...)``: an int mp degree, an ``(mp,)`` / ``(mp, dp)``
    tuple (over the first ``mp * dp`` cards, ``distributed.serving_mesh``)
    or a ``ServingMesh``."""
    if isinstance(mesh, ServingMesh):
        return mesh
    if isinstance(mesh, (int, np.integer)):
        return serving_mesh(int(mesh))
    if isinstance(mesh, (tuple, list)):
        if len(mesh) not in (1, 2):
            raise ValueError(
                f"mesh shape must be (mp,) or (mp, dp), got {tuple(mesh)} "
                "— the serving engine shards over a tensor-parallel and a "
                "data-parallel axis")
        return serving_mesh(int(mesh[0]),
                            int(mesh[1]) if len(mesh) == 2 else 1)
    raise ValueError(
        f"mesh must be an int mp degree, an (mp,) / (mp, dp) tuple, or a "
        f"ServingMesh, got {type(mesh).__name__}")


class _Staging:
    """One ring entry's host buffers — pinned on a CUDA engine: the
    tick's uploads (``toks``, ``width``, ``mode``, ``lanes``) and the
    packed download of its picks, accept counts, emit counts and done
    mask (``out`` [B, E + 3]), plus the CUDA event recorded after that
    download.  A set goes back to the free list only when its tick has
    been consumed: until then an asynchronous copy may still read (or
    fill) it."""

    __slots__ = ("toks", "width", "mode", "lanes", "out", "event")

    def __init__(self, num_slots, window, emit_w, device):
        pin = device.type == "cuda"

        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int32, pin_memory=pin)

        self.toks = buf(num_slots, window)
        self.width = buf(num_slots)
        self.mode = buf(num_slots)
        self.lanes = buf(num_slots)
        self.out = buf(num_slots, emit_w + 3)
        self.event = torch.cuda.Event() if pin else None


class _InflightTick:
    """One dispatched tick (the ragged window, or an XLA decode or
    verify tick): its staging set (the download lands there), the slot
    -> request bindings as of dispatch (a slot may be evicted and even
    re-admitted before this tick is consumed; the identity check
    ``slot.request is req`` keeps a frozen lane out of a newer request's
    stream), and per listed slot the lane's (mode, width, draft lanes)
    as of dispatch; plus the flight recorder's view: the tick's kind and
    layout, when it was dispatched, and host copies of the cursors and
    budgets its dispatch chained from."""

    __slots__ = ("tick", "kind", "layout", "slots", "reqs", "meta_lanes",
                 "staging", "dispatched_at", "cursors")

    def __init__(self, tick, kind, layout, slots, meta_lanes, staging,
                 cursors):
        self.tick = tick
        self.kind = kind              # "decode" | "spec" | "ragged"
        self.layout = layout
        self.slots = slots
        self.reqs = [s.request for s in slots]
        self.meta_lanes = meta_lanes
        self.staging = staging
        self.dispatched_at = time.monotonic()
        self.cursors = cursors        # (pos, rem) numpy copies

    def meta(self):
        """JSON-able metadata for the flight recorder (host state only:
        a dump must never wait on a wedged dispatch)."""
        return {
            "tick": self.tick, "kind": self.kind, "batch": len(self.slots),
            "layout": self.layout,
            "slots": [s.index for s in self.slots],
            "requests": [r.id for r in self.reqs],
            "in_flight_ms": round(
                (time.monotonic() - self.dispatched_at) * 1e3, 3),
            "cursors": {"pos": self.cursors[0].tolist(),
                        "rem": self.cursors[1].tolist()},
        }


class Engine:
    """In-process continuous-batching engine for a ``GPTModel``.

    Parameters
    ----------
    model : ``paddle_tpu_torch`` GPTModel whose parameters already lie on
        ``device`` (the engine never moves them).
    num_slots : fixed batch-slot pool size (B of every dispatch).
    max_seq_len : per-slot KV length L (prompt + generated must fit);
        defaults to the model's position table.
    kv_block_size : paged KV block size (must divide max_seq_len); None
        keeps contiguous ``[B, L, H, hd]`` slot rows, which only
        ``attn_impl="xla"`` serves.
    kv_blocks : physical block count of the pool (default
        ``num_slots * max_seq_len / kv_block_size``), plus one reserved
        scratch block (one per dp shard on a mesh).
    kv_budget_mb : size the pool by bytes instead: as many blocks as
        ``kv_budget_mb`` MiB hold at one block's true footprint over all
        layers, K and V (codes plus scales when int8; ``kv_block_bytes``
        and ``kv_scale_bytes`` say what one block costs).  Exclusive with
        ``kv_blocks``.
    prefix_cache : keep finished prompts' full blocks in a token trie so
        later requests adopt them (default True).
    prefill_chunk : prompt tokens a slot prefills per tick (must divide
        max_seq_len); on the ragged path also the dispatch's window width
        W.  None prefills each admitted prompt whole at admission.
    tick_token_budget : prompt tokens one tick may spend on prefill
        chunks across slots (default: one chunk; must be >= it).
    prefill_buckets : contiguous whole-prompt prefill only: None, or
        ``"pow2"`` (powers of two from 8, plus max_seq_len) or a list of
        lengths: each prompt is right-padded to the first bucket that
        holds it (a bucket of 2048 tokens runs the flash kernel).
    attn_impl : ``"ragged"`` (default) — the streaming ragged kernel (B1,
        or B2 with int8 pools); ``"ragged_gather"`` — the gather body
        (B3), which walks every table entry: the A/B baseline; ``"xla"``
        — the JAX package's XLA windows in plain torch, the only path
        over contiguous rows.  JAX's ``attn_impl=None`` means ``"xla"``;
        here the default is the ragged kernel path.
    sample_mode : ``"device"`` — sampling in the dispatch's epilogue;
        ``"host"`` — the logits come home and numpy samples each request
        on its own ``np.random.default_rng(seed)`` stream (needs
        ``async_depth=1`` and fp pools, as in JAX).
    device : where the engine's pools and state live; None = the CUDA
        card (raises without one; the tests pass ``device="cpu"``), or
        with a mesh its first rank's device (the only one it takes).
    mesh : None (one device), an int mp degree, an ``(mp,)`` / ``(mp,
        dp)`` tuple over the first ``mp * dp`` cards, or a
        ``distributed.ServingMesh`` (which may map several ranks onto one
        device).  mp > 1 needs the tensor-parallel model form
        (``GPTModel(use_mp=True)`` or ``to_tensor_parallel()``);
        ``num_heads`` must divide by mp and ``num_slots`` by dp.  The
        model's weights are read from ``device`` and sliced per rank; the
        KV pools hold ``H/mp`` heads per rank, and dp shard ``d`` owns
        slots ``[d*B/dp, (d+1)*B/dp)`` and one contiguous pool range with
        its own scratch block.  ``kv_budget_mb`` is then a per-rank
        budget, and ``kv_blocks`` rounds up to a multiple of dp.
    weight_dtype : ``"int8"`` relayouts every transformer-block Linear of
        ``model`` (in place) to weight-only int8 at construction; None
        serves the checkpoint as it is.
    kv_dtype : ``"int8"`` stores the K/V pools as int8 codes with a f32
        scale per block and head; None stores them in the compute dtype.
    adapters / max_adapters / max_lora_rank : LoRA serving.
        ``adapters`` maps names to ``LoRAAdapter``s loaded at
        construction; ``max_adapters`` lanes (default: as many as
        ``adapters``, at least 1) and ``max_lora_rank`` (default: their
        largest rank, else 8) fix the bank shapes, so ``load_adapter``
        later writes a lane and changes no shape.  ``submit(adapter=)``
        picks a lane per request; adapter lanes never adopt or insert
        cached prefixes (the delta on ``out_proj`` changes every later
        layer's K/V).  Device sampling only, no mesh or tensor-parallel
        model, as in JAX.
    kv_host_mb : a host-RAM tier of this many MiB for the blocks the
        prefix cache evicts (paged layout and ``prefix_cache=True``
        only): an eviction gathers the block and downloads it behind an
        event, the next tick boundary parks it; an admission whose
        prompt continues past the device trie's match restores the
        stored blocks instead of prefilling them.
    async_depth : pipeline depth (default: 2).  At 2 a tick dispatches
        tick N+1 before it consumes tick N, so admission, chunk planning
        and tick N's emit loop run while the device computes (watch
        ``serving.tick_overlap_ms`` / ``serving.d2h_wait_ms`` and the
        ``host.overlap`` spans); greedy streams are token-identical to
        ``async_depth=1``, which dispatches and consumes in one tick.
    spec_k / proposer : speculative decoding.  ``spec_k=k`` widens every
        decode lane to a k+1 verify window whose lanes 1..k the
        ``proposer`` (default ``PromptLookupProposer()``) drafts; the
        epilogue accepts the longest matching prefix plus one bonus
        token.  Greedy streams equal the non-speculative engine's.  The
        ring drains before drafting (a draft reads the tokens the
        previous window accepted).
    max_queue : admission queue bound (0 = unbounded); a full queue
        sheds ``submit`` with ``QueueFull``.
    tenants : per-tenant policies, name -> ``TenantPolicy`` (or a dict
        of its kwargs): weighted-fair service within a priority tier,
        and an optional token bucket charged ``prompt +
        max_new_tokens`` at submit (``RateLimited`` when over rate).
    preemption : when the best queued priority outranks a running
        request and admission is blocked (no free slot, or the paged
        gate short on blocks), evict the lowest-priority running slot
        mid-stream (its computed full blocks go into the prefix cache)
        and requeue it with its emitted tokens; the resumed stream is
        token-identical, greedy and seeded (default True).
    shed_deadlines : once the drain rate is measured, reject a submit
        whose deadline (``timeout``) the estimated queue wait already
        blows, with ``DeadlineShed`` (default True).
    registry : the ``monitor.StatRegistry`` the engine's metrics live in
        (default: a registry of the engine's own; pass
        ``monitor.default_registry()`` to publish process-wide).
    tracing / trace_capacity / trace_annotations : keep a span tracer
        (``monitor.Tracer``, a bounded ring per thread of
        ``trace_capacity`` events) fed by every tick — ``tracing=False``
        swaps in a ``NullTracer``; ``trace_annotations=True`` also
        enters ``torch.profiler.record_function`` per span.  Export with
        ``chrome_trace()``.
    flight_dir : directory for flight-recorder dumps.  A failing
        ``step()`` snapshots the trace ring, the request states and the
        in-flight ring into ``last_flight`` (always, before recovery
        tears the slots down) and, with ``flight_dir``, also writes it
        there as ``flight_tick<N>_<pid>_<ms>.json``.
    faults : a ``serving.faults.FaultInjector``: seeded failure points
        (dispatch raise, d2h hang, pool exhaustion, slow host tick,
        proposer failure, migration export / import, adapter load,
        offload demote / promote) at the JAX engine's sites, on the tick
        counter ``tick_no``; None (default) costs one attribute read a
        site.
    watchdog_s : arm a ``TickWatchdog``: a tick running longer than this
        is flight-recorded by the watchdog thread and marked, and the
        consume's wait raises ``WatchdogTimeout`` into step recovery
        instead of hanging (the wait polls its CUDA event while a
        watchdog is armed).

    ``step()`` is single-threaded — run it from one loop
    (``run_until_idle`` or the ``start()`` background thread);
    ``submit()`` is thread-safe.
    """

    def __init__(self, model, num_slots=4, max_seq_len=None,
                 kv_block_size=None, kv_blocks=None,
                 prefix_cache=True, prefill_chunk=None,
                 tick_token_budget=None, prefill_buckets=None,
                 attn_impl="ragged",
                 sample_mode="device", async_depth=None, device=None,
                 spec_k=None, proposer=None, mesh=None, kv_dtype=None,
                 weight_dtype=None, adapters=None, max_adapters=None,
                 max_lora_rank=None, kv_host_mb=None,
                 kv_budget_mb=None, max_queue=0, registry=None,
                 tenants=None, preemption=True, shed_deadlines=True,
                 tracing=True, trace_capacity=16384,
                 trace_annotations=False, flight_dir=None, faults=None,
                 watchdog_s=None):
        if sample_mode not in ("device", "host"):
            raise ValueError(
                f"sample_mode must be 'device' or 'host', got "
                f"{sample_mode!r}")
        self.sample_mode = sample_mode
        if async_depth is None:
            async_depth = 2 if sample_mode == "device" else 1
        depth = int(async_depth)
        if depth < 1:
            raise ValueError(f"async_depth must be >= 1, got {depth}")
        if depth > 1 and sample_mode != "device":
            raise ValueError(
                "async_depth > 1 requires sample_mode='device': the host "
                "sampling path downloads the logits and samples on the "
                "host every tick, so there is no device-compute gap to "
                "overlap")
        self.async_depth = depth
        if attn_impl not in ("xla", "ragged", "ragged_gather"):
            raise ValueError(
                f"attn_impl must be 'xla', 'ragged' or 'ragged_gather', "
                f"got {attn_impl!r}")
        self._paged = kv_block_size is not None
        self._weight_quant = weight_dtype is not None
        if self._weight_quant and str(weight_dtype) != "int8":
            raise ValueError(
                f"weight_dtype must be 'int8' (or None to serve the "
                f"checkpoint's own dtype), got {weight_dtype!r}")
        self._kv_quant = kv_dtype is not None
        if self._kv_quant and str(kv_dtype) != "int8":
            raise ValueError(
                f"kv_dtype must be 'int8' (or None for the compute "
                f"dtype), got {kv_dtype!r}")
        if self._kv_quant and not self._paged:
            raise ValueError(
                "kv_dtype='int8' requires the paged KV layout "
                "(kv_block_size=...): quantization is per-block — the "
                "contiguous pools have no block granularity to hang a "
                "scale on")
        if self._kv_quant and sample_mode != "device":
            raise ValueError(
                "kv_dtype='int8' requires sample_mode='device': the host "
                "sampling paths run the fp decode windows, which have no "
                "dequantizing gather")
        if attn_impl != "xla":
            if not self._paged:
                raise ValueError(
                    f"attn_impl={attn_impl!r} (the port's default) requires "
                    "the paged KV layout: the ragged kernels read K/V "
                    "through per-slot block tables — pass "
                    "kv_block_size=..., or attn_impl='xla' to serve "
                    "contiguous slot rows (the JAX engine's default)")
            if sample_mode != "device":
                raise ValueError(
                    f"attn_impl={attn_impl!r} requires "
                    "sample_mode='device': sampling, the acceptance scan "
                    "and the stop condition run in the ragged dispatch's "
                    "epilogue")
        if mesh is not None and (attn_impl == "xla"
                                 or prefill_chunk is None):
            raise NotImplementedError(
                "Engine(mesh=..., attn_impl='xla') and Engine(mesh=..., "
                "prefill_chunk=None) are not ported yet: ROADMAP.md Queue "
                "A 10 (the XLA paths over a mesh); a mesh serves "
                "attn_impl='ragged' with prefill_chunk=C")
        if mesh is not None and kv_host_mb is not None:
            raise NotImplementedError(
                "Engine(mesh=..., kv_host_mb=...) is not ported yet: "
                "ROADMAP.md Queue A 10 (the host tier over per-shard "
                "pools)")
        if kv_budget_mb is not None and not self._paged:
            raise ValueError(
                "kv_budget_mb requires the paged KV layout "
                "(kv_block_size=...): the contiguous pools are sized by "
                "num_slots * max_seq_len, not by a block budget")
        if tick_token_budget is not None and prefill_chunk is None:
            raise ValueError(
                "tick_token_budget requires prefill_chunk (it bounds the "
                "chunked-prefill spend per tick)")
        self._spec_k = None
        self.proposer = None
        if spec_k is not None:
            k = int(spec_k)
            if k < 1:
                raise ValueError(f"spec_k must be >= 1, got {k}")
            L = int(max_seq_len or model.embeddings.position_embeddings
                    .weight.shape[0])
            if k + 2 > L:
                raise ValueError(
                    f"spec_k={k} leaves no room for any request in a "
                    f"{L}-position slot (the verify window needs prompt + "
                    "max_new_tokens + spec_k to fit)")
            proposer = PromptLookupProposer() if proposer is None \
                else proposer
            pv = getattr(proposer, "vocab_size", None)
            vocab = model.embeddings.word_embeddings.weight.shape[0]
            if pv is not None and int(pv) != vocab:
                raise ValueError(
                    f"proposer vocab ({pv}) != target model vocab "
                    f"({vocab}) — a draft from a different tokenizer can "
                    "never match and only burns the verify window")
            self._spec_k = k
            self.proposer = proposer
        elif proposer is not None:
            raise ValueError(
                "proposer requires spec_k (the draft window width)")
        # a decode lane's width: the k+1 verify window, or one token
        self._spec_w = self._spec_k + 1 if self._spec_k else 1
        attn0 = model.blocks[0].attn
        is_tp = getattr(attn0, "use_mp", False)
        if self._weight_quant and is_tp:
            raise ValueError(
                "weight_dtype='int8' cannot relayout the tensor-parallel "
                "einsum form (use_mp=True): its fused qkv/ffn weights are "
                "not nn.Linear layers — quantize the dense checkpoint "
                "before to_tensor_parallel(), or serve it dense")
        self.mesh = None
        self.mp = self.dp = 1
        self.mesh_axes = None
        if mesh is not None:
            mesh = _resolve_mesh(mesh)
            if mesh.mp > 1 and not is_tp:
                raise ValueError(
                    "mesh with mp > 1 requires the tensor-parallel model "
                    "form: build with GPTModel(use_mp=True) or convert a "
                    "dense checkpoint with model.to_tensor_parallel() — the "
                    "dense fused qkv layout cannot shard its head axis")
            if attn0.num_heads % mesh.mp:
                raise ValueError(
                    f"num_heads ({attn0.num_heads}) must divide by the "
                    f"mesh's mp degree ({mesh.mp}) — attention shards whole "
                    "heads")
            if int(num_slots) % mesh.dp:
                raise ValueError(
                    f"num_slots ({num_slots}) must divide by the mesh's dp "
                    f"degree ({mesh.dp}) — each dp shard owns an equal "
                    "contiguous range of batch slots")
            if self._weight_quant:
                raise NotImplementedError(
                    "Engine(mesh=..., weight_dtype='int8') is not ported "
                    "yet: ROADMAP.md Queue A 10 (the mesh: weight-only int8 "
                    "over a dense dp mesh)")
            first = mesh.devices[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(
                    f"Engine: device={device!r} is not the mesh's first "
                    f"rank's device ({first}), where the engine keeps its "
                    "step state and reads the model's weights")
            device = first
            self.mesh = mesh
            self.mp, self.dp = mesh.mp, mesh.dp
            self.mesh_axes = ({k: v for k, v in mesh.shape.items() if v > 1}
                              or {"mp": 1})
        self.device = require_on(
            device, [*model.named_parameters(), *model.named_buffers()],
            "Engine")
        self.adapters = None
        if adapters is not None or max_adapters is not None:
            self.adapters = self._adapter_registry(
                model, adapters, max_adapters, max_lora_rank, sample_mode,
                is_tp)
        if self._weight_quant:
            # before the dtype probe and the pools: the codes and scales
            # become buffers of the model's block Linears
            relayout_weights_int8(model)
        model.eval()
        self.model = model
        # what runs the tick: the model itself, or its per-rank shards
        self._runner = model
        if self.mesh is not None:
            self._runner = self._shard_model()
        max_position = model.embeddings.position_embeddings.weight.shape[0]
        self.max_seq_len = int(max_seq_len or max_position)
        if self.max_seq_len > max_position:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"position table ({max_position})")
        self.num_slots = int(num_slots)
        self.vocab_size = int(model.embeddings.word_embeddings.weight
                              .shape[0])
        # -- overload protection: tenants, priorities, shedding --------
        self._tenant_policies = {}
        self._buckets = {}
        for name, pol in (tenants or {}).items():
            if isinstance(pol, dict):
                pol = TenantPolicy(**pol)
            elif not isinstance(pol, TenantPolicy):
                raise ValueError(
                    f"tenants[{name!r}] must be a TenantPolicy or a dict "
                    f"of its kwargs, got {type(pol).__name__}")
            self._tenant_policies[str(name)] = pol
            if pol.rate is not None:
                self._buckets[str(name)] = TokenBucket(pol.rate, pol.burst)
        self.queue = RequestQueue(
            max_queue=max_queue,
            weights={n: p.weight for n, p in self._tenant_policies.items()})
        self.scheduler = Scheduler(self.num_slots, self.queue)
        self._preemption = bool(preemption)
        self._shed_deadlines = bool(shed_deadlines)
        self._preempt_log = deque(maxlen=64)  # recent preemptions
        self._gate_declined = False  # the paged gate turned the queue
        #   head away this tick (short on blocks): preemption's probe
        self._draining = False       # stop(drain=True) in progress
        self._rate_win = deque(maxlen=64)  # (t, emitted) per emitting
        #   tick: the measured drain rate behind deadline shedding
        self._ovl_lock = threading.Lock()  # guards _rate_win and
        #   _preempt_log against readers on other threads
        self.faults = faults
        self.watchdog_s = None if watchdog_s is None else float(watchdog_s)
        self._watchdog = None
        self._watchdog_fired = False
        self._tick_started_at = None  # watchdog heartbeat: set at tick
        #   entry, cleared at exit
        self._reshard = False  # refresh_params() on a mesh: re-cut the
        #   per-rank weight shards at the next tick boundary
        self._flight_dir = flight_dir
        self.last_flight = None       # chrome-trace dict of the latest
        self.last_flight_path = None  #   step failure (+ its file)
        self._max_context_len = 0     # prompt + generated high-water
        self._nh, self._hd = attn0.num_heads, attn0.head_dim
        self._kv_dtype = model._cache_dtype()
        # the dtype labels of /healthz and the migration wire, spelled as
        # the JAX package spells them ("float32", "int8")
        fp = str(self._kv_dtype).replace("torch.", "")
        self._kv_dtype_str = "int8" if self._kv_quant else fp
        self._weight_dtype_str = "int8" if self._weight_quant else fp
        self.attn_impl = attn_impl
        self._ragged = attn_impl != "xla"
        self._variant = "gather" if attn_impl == "ragged_gather" \
            else "stream"
        self._prefill_buckets = None
        if prefill_buckets == "pow2":
            bs, n = [], 8
            while n < self.max_seq_len:
                bs.append(n)
                n *= 2
            self._prefill_buckets = bs + [self.max_seq_len]
        elif prefill_buckets:
            bs = sorted({int(x) for x in prefill_buckets})
            if bs[0] < 1 or bs[-1] > self.max_seq_len:
                raise ValueError(
                    f"prefill_buckets must lie in [1, {self.max_seq_len}]"
                    f", got {bs}")
            if bs[-1] < self.max_seq_len:
                bs.append(self.max_seq_len)  # every legal prompt fits
            self._prefill_buckets = bs
        self._chunk = self._tick_budget = None
        if prefill_chunk is not None:
            c = int(prefill_chunk)
            if c < 1 or self.max_seq_len % c:
                raise ValueError(
                    f"prefill_chunk must be >= 1 and divide max_seq_len "
                    f"({self.max_seq_len}), got {c}")
            if self._prefill_buckets is not None:
                raise ValueError(
                    "prefill_chunk cannot combine with prefill_buckets: "
                    "the fixed chunk shape already bounds prefill shapes")
            b = int(tick_token_budget) if tick_token_budget is not None \
                else c
            if b < c:
                raise ValueError(
                    f"tick_token_budget ({b}) must cover at least one "
                    f"prefill_chunk ({c}), or no tick could ever make "
                    "prefill progress")
            self._chunk = c
            self._tick_budget = b
        # no block pool on contiguous rows: its gauges stay 0 (and the
        # per-shard byte labels None, as in JAX)
        self._kv_managed = 0
        self.kv_block_bytes = self.kv_scale_bytes = 0
        self._prefix_enabled = False
        if self._paged:
            if self._prefill_buckets is not None:
                raise ValueError(
                    "prefill_buckets cannot combine with kv_block_size: "
                    "the paged prefill runs per (context, tail) length "
                    "instead of per bucket")
            self._size_block_pool(model, int(kv_block_size), kv_blocks,
                                  kv_budget_mb, prefix_cache)
        # the ragged dispatch's window: wide enough for a prefill chunk
        # and the k+1 verify window (each slot's real width is data); an
        # XLA dispatch's is the verify window (chunks run on their own)
        self._wmax = (max(self._chunk or 1, self._spec_w) if self._ragged
                      else self._spec_w)
        # -- the host-RAM offload tier (serving/offload.py) ------------
        self.host_store = None
        if kv_host_mb is not None:
            if not self._paged:
                raise ValueError(
                    "kv_host_mb requires the paged KV layout "
                    "(kv_block_size=...): the host tier parks whole "
                    "blocks — the contiguous pools have none")
            if not self._prefix_enabled:
                raise ValueError(
                    "kv_host_mb requires prefix_cache=True: demotes are fed "
                    "by the trie's eviction and promotes by admission's "
                    "prefix match")
            self.host_store = HostBlockStore(
                kv_host_mb, self._bs, self._nh, self._hd,
                len(model.blocks), "int8" if self._kv_quant
                else str(self._kv_dtype).replace("torch.", ""))
        # cross-thread orders (_MigrateDemand) and the migration log
        self._migrate_demands = []
        self._migration_log = deque(maxlen=64)
        self._mig_lock = threading.Lock()
        self._rngs = {}  # request id -> host-mode np.random.Generator
        self.ragged_dispatches = 0  # ragged window dispatches
        self.ticks = 0
        self.tracer = (monitor.Tracer(capacity=trace_capacity,
                                      annotate=trace_annotations)
                       if tracing else monitor.NullTracer())
        self._init_metrics(monitor.StatRegistry() if registry is None
                           else registry)
        self._last_decode_end = None  # stall anchor: end of the last
        #   dispatch, cleared when nothing was dispatched
        self._evicted_in_tick = 0     # monotonic eviction counter; a
        #   tick reads deltas to keep the occupancy gauge exact
        self._overlap_acc = 0.0       # per-tick overlapped host work (s)
        self._thread = None
        self._stop = threading.Event()
        self._wake = threading.Event()  # submit() wakes an idle loop
        self._drain_on_exit = None    # a loop's stop event, when that
        #   loop must drain on exit
        self._reset_pools()

    def _shard_model(self):
        """The mesh's per-rank weight shards, cut from ``self.model`` (a
        dense model goes through its tensor-parallel form first)."""
        m = self.model
        if not getattr(m.blocks[0].attn, "use_mp", False):
            m = m.to_tensor_parallel()
        return ShardedServingModel(m, self.mesh)

    def _adapter_registry(self, model, adapters, max_adapters,
                          max_lora_rank, sample_mode, is_tp):
        """The LoRA banks on the engine's device, with ``adapters``
        loaded; refuses what the JAX engine refuses."""
        if sample_mode != "device":
            raise ValueError(
                "adapters require sample_mode='device': the host sampling "
                "paths do not thread the per-slot LoRA lanes")
        if self.mesh is not None or is_tp:
            raise ValueError(
                "adapters cannot combine with tensor-parallel serving "
                "(mesh=... / use_mp models): the LoRA delta rides the "
                "dense out_proj form")
        init = dict(adapters or {})
        for name, ad in init.items():
            if not isinstance(ad, LoRAAdapter):
                raise TypeError(
                    f"adapters[{name!r}] must be a LoRAAdapter, got "
                    f"{type(ad).__name__}")
        n_ad = (int(max_adapters) if max_adapters is not None
                else max(len(init), 1))
        if n_ad < len(init):
            raise ValueError(
                f"max_adapters={n_ad} cannot hold the {len(init)} adapters "
                "passed at construction")
        r_max = (int(max_lora_rank) if max_lora_rank is not None
                 else max([a.rank for a in init.values()] or [8]))
        reg = AdapterRegistry(
            len(model.blocks),
            int(model.embeddings.word_embeddings.weight.shape[1]), n_ad,
            r_max, device=self.device)
        for name in sorted(init):
            reg.load(name, init[name])
        return reg

    def _size_block_pool(self, model, bsz, kv_blocks, kv_budget_mb,
                         prefix_cache):
        """The paged layout's geometry: block size, blocks a slot, one
        block's bytes, and the pool's size in blocks (by count or by a
        byte budget)."""
        if bsz < 1 or self.max_seq_len % bsz:
            raise ValueError(
                f"kv_block_size must be >= 1 and divide max_seq_len "
                f"({self.max_seq_len}), got {bsz}")
        self._bs = bsz
        self._bps = self.max_seq_len // bsz  # blocks per full slot
        # one logical block's footprint over every layer, K and V, on ONE
        # rank (its H/mp heads): the codes (or rows), plus the scale
        # pool's rows when int8
        store_dtype = "int8" if self._kv_quant else self._kv_dtype
        n_layers = len(model.blocks)
        self.kv_block_bytes = per_shard_block_bytes(
            bsz, self._nh, self._hd, store_dtype, n_layers, self.mp)
        block_bytes = per_shard_block_bytes(
            bsz, self._nh, self._hd, store_dtype, n_layers, self.mp,
            scale_dtype="float32" if self._kv_quant else None)
        self.kv_scale_bytes = block_bytes - self.kv_block_bytes
        if kv_budget_mb is not None:
            if kv_blocks is not None:
                raise ValueError(
                    "kv_budget_mb and kv_blocks are two answers to one "
                    "question (pool size) — pass one")
            # a per-rank budget; every dp shard owns its own pool range
            managed = self.dp * int(float(kv_budget_mb) * 2 ** 20
                                    // block_bytes)
            src = (f"kv_budget_mb={float(kv_budget_mb):g} (-> "
                   f"{managed // self.dp} blocks at {block_bytes} B/block"
                   + ("/shard)" if self.dp > 1 else ")"))
        else:
            managed = (self.num_slots * self._bps if kv_blocks is None
                       else int(kv_blocks))
            src = f"kv_blocks={managed}" + (f" (/{self.dp} dp shards)"
                                            if self.dp > 1 else "")
            # the dp shard ranges must be equal: round UP, never less
            managed += -managed % self.dp
        if managed // self.dp < self._bps:
            raise ValueError(
                f"{src} cannot hold even one max-length request "
                f"({self._bps} blocks" + (" per dp shard)" if self.dp > 1
                                          else ")"))
        self._kv_managed = managed
        self._prefix_enabled = bool(prefix_cache)

    def _init_metrics(self, reg):
        """Register the engine's metrics in ``reg`` under the JAX
        engine's names (the subset the ported paths touch)."""
        self.registry = reg
        self._m_queue = reg.gauge(
            "serving.queue_depth", "requests waiting for a slot")
        self._m_occ = reg.gauge(
            "serving.slot_occupancy", "busy slots out of num_slots")
        reg.gauge("serving.slot_total", "configured slot pool size").set(
            self.num_slots)
        reg.gauge("serving.mesh_devices", "ranks in this engine's "
                  "serving mesh (mp x dp; 1 = unsharded)").set(
            self.mp * self.dp)
        self._m_tokens = reg.counter(
            "serving.tokens_total", "generated tokens")
        self._m_reqs = reg.counter(
            "serving.requests_total", "submitted requests")
        self._m_done = reg.counter(
            "serving.requests_completed", "finished requests")
        self._m_timeout = reg.counter(
            "serving.requests_timeout", "requests expired in queue")
        self._m_ttft = reg.histogram(
            "serving.ttft_ms", "time to first token (ms)")
        self._m_tpot = reg.histogram(
            "serving.tpot_ms", "time per output token after the first "
            "(ms, per finished request)")
        self._m_rate = monitor.RateMeter(reg.gauge(
            "serving.tokens_per_sec", "windowed decode throughput"))
        self._m_prefill_tokens = reg.counter(
            "serving.prefill_tokens", "prompt tokens actually computed in "
            "prefill (prefix-cache hits skip the shared span)")
        self._m_kv_blocks = reg.gauge(
            "serving.kv_blocks_in_use", "paged KV blocks referenced by "
            "slots or cached prefixes")
        reg.gauge("serving.kv_blocks_total",
                  "paged KV pool size in blocks").set(self._kv_managed)
        reg.gauge("serving.kv_block_bytes", "per-shard K/V row bytes of "
                  "one logical block across all layers (int8 code bytes "
                  "when kv_dtype='int8')").set(self.kv_block_bytes)
        reg.gauge("serving.kv_scale_bytes", "per-shard scale-pool bytes "
                  "of one logical block (0 unless kv_dtype='int8')").set(
            self.kv_scale_bytes)
        self._m_prefix_hits = reg.counter(
            "serving.prefix_hits", "admissions that adopted a cached "
            "prompt prefix")
        self._m_prefix_hit_tokens = reg.counter(
            "serving.prefix_hit_tokens", "prompt tokens served from cached "
            "prefix blocks (prefill skipped)")
        self._m_prefix_evictions = reg.counter(
            "serving.prefix_evictions", "cached prefix blocks evicted "
            "(LRU) under pool pressure")
        self._m_chunks = reg.counter(
            "serving.prefill_chunks", "prefill chunks dispatched (ragged "
            "chunk lanes, or XLA chunk dispatches)")
        self._m_stall = reg.histogram(
            "serving.decode_stall_ms", "gap between consecutive dispatches "
            "while slots were decoding (ms)")
        self._m_decode_batch = reg.gauge(
            "serving.decode_batch", "DECODING slots in the latest "
            "dispatch")
        self._m_spec_proposed = reg.counter(
            "serving.spec_proposed", "draft lanes proposed to the "
            "speculative verify window")
        self._m_spec_accepted = reg.counter(
            "serving.spec_accepted", "draft lanes accepted (their token "
            "emitted from a matched lane)")
        self._m_spec_windows = reg.counter(
            "serving.spec_windows", "per-slot verify windows dispatched")
        self._m_spec_rate = reg.gauge(
            "serving.spec_acceptance_rate", "accepted / proposed draft "
            "lanes, cumulative over this engine's lifetime")
        self._m_spec_tpt = reg.gauge(
            "serving.spec_tokens_per_tick", "tokens emitted per DECODING "
            "slot by the latest verify dispatch")
        self._m_proposer_failures = reg.counter(
            "serving.proposer_failures", "proposer calls that raised — "
            "degraded to an empty draft window")
        self._m_d2h = reg.gauge(
            "serving.d2h_bytes_per_tick", "bytes the latest dispatch "
            "downloaded to the host (device mode: picks + counts + done "
            "mask; host mode: the [B, V] or [B, W, V] logits)")
        self._m_sample_ms = reg.histogram(
            "serving.sample_ms", "host-side sampling + emit loop per tick "
            "(ms; sample_mode='host' only)")
        self._m_fused_ticks = reg.counter(
            "serving.fused_sample_ticks", "decode dispatches that sampled "
            "on the device (sample_mode='device')")
        self._m_kv_blocks_walked = reg.gauge(
            "serving.kv_blocks_walked_per_tick", "KV blocks the ragged "
            "kernel walked in the latest dispatch, summed over lanes")
        self._m_kv_walked_total = reg.counter(
            "serving.kv_blocks_walked", "KV blocks the ragged kernel "
            "walked, summed over dispatches and lanes")
        reg.gauge("serving.async_depth", "engine pipeline depth (1 = "
                  "synchronous tick, 2 = tick N+1 dispatched before tick "
                  "N is consumed)").set(self.async_depth)
        self._m_overlap = reg.histogram(
            "serving.tick_overlap_ms", "host work done per tick WHILE a "
            "dispatch was in flight (ms)")
        self._m_d2h_wait = reg.histogram(
            "serving.d2h_wait_ms", "blocking wait for a dispatched tick's "
            "download (ms): the loop's one sync point")
        self._m_preempt = reg.counter(
            "serving.preemptions_total", "mid-stream preemptions: a "
            "running lower-priority request evicted back to the queue")
        self._m_resumed = reg.counter(
            "serving.resumed_total", "re-admissions of preempted requests")
        self._m_shed_deadline = reg.counter(
            "serving.shed_deadline_total", "requests rejected at submit "
            "because the estimated queue wait blew their deadline")
        self._m_shed_rate = reg.counter(
            "serving.shed_rate_limited_total", "requests rejected at "
            "submit by a tenant token bucket")
        self._m_shed_queue = reg.counter(
            "serving.shed_queue_full_total", "requests rejected at submit "
            "because the queue was at max_queue")
        self._m_drain_tps = reg.gauge(
            "serving.drain_rate_tps", "measured drain rate (tokens/sec "
            "over the recent emitting ticks)")
        self._m_kv_host_blocks = reg.gauge(
            "serving.kv_host_blocks", "KV blocks resident in the host-RAM "
            "offload tier (kv_host_mb=...)")
        self._m_kv_host_bytes = reg.gauge(
            "serving.kv_host_bytes", "bytes the host-RAM offload tier "
            "holds (codes + scales for int8 pools)")
        self._m_offload_demotes = reg.counter(
            "serving.offload_demotes", "KV blocks demoted device -> host "
            "at eviction (parked at tick boundaries)")
        self._m_offload_promotes = reg.counter(
            "serving.offload_promotes", "KV blocks promoted host -> device "
            "at admission (restored instead of recomputed)")
        self._m_offload_hit_tokens = reg.counter(
            "serving.offload_hit_tokens", "prompt tokens whose prefill a "
            "host-tier restore skipped (the host share of "
            "prefix_hit_tokens)")
        self._m_watchdog = reg.counter(
            "serving.watchdog_fires", "ticks the watchdog declared wedged "
            "(flight-recorded; the consume's wait raises into recovery)")
        self._m_faults = reg.counter(
            "serving.faults_injected", "fault-injection sites fired "
            "(serving/faults.py; nonzero only under a chaos harness)")
        self._m_kv_migrated = reg.counter(
            "serving.kv_blocks_migrated", "paged KV blocks exported toward "
            "another replica (stream migration + prefix warming; counted "
            "on the export side only)")

    # the plain counters of earlier slices, read from the registry
    tokens_generated = property(lambda self: int(self._m_tokens.value))
    requests_completed = property(lambda self: int(self._m_done.value))
    prefill_tokens = property(
        lambda self: int(self._m_prefill_tokens.value))
    prefix_hits = property(lambda self: int(self._m_prefix_hits.value))
    prefix_hit_tokens = property(
        lambda self: int(self._m_prefix_hit_tokens.value))
    kv_blocks_walked = property(
        lambda self: int(self._m_kv_walked_total.value))
    # the JAX engine's name of the tick counter: the fault schedule's and
    # the watchdog's clock
    tick_no = property(lambda self: self.ticks)
    # the JAX engine's per-shard byte labels (``/healthz`` and the
    # flight recorder read them): None on contiguous rows
    _kv_code_bytes_per_shard = property(
        lambda self: self.kv_block_bytes if self._paged else None)
    _kv_block_bytes_per_shard = property(
        lambda self: self.kv_block_bytes + self.kv_scale_bytes
        if self._paged else None)
    _kv_scale_bytes_per_shard = property(
        lambda self: self.kv_scale_bytes if self._paged else None)

    def chrome_trace(self):
        """The trace ring as a Catapult JSON dict (chrome://tracing,
        Perfetto)."""
        return self.tracer.chrome_trace(
            process_name=f"paddle_tpu_torch-serving pid={os.getpid()}")

    def refresh_params(self):
        """After an external weight mutation: cached prefixes hold K/V
        computed under the OLD weights, so the prefix trie is flushed
        (blocks still referenced by live slots stay until their
        eviction), and a mesh engine's per-rank weight shards, the one
        derived copy of the weights the port keeps, are re-cut from the
        model at the next tick boundary."""
        if self._paged and self.prefix_cache is not None:
            self.prefix_cache.clear()
        if self.mesh is not None:
            self._reshard = True

    # ------------------------------------------------------------------
    def _reset_pools(self):
        """(Re)allocate the per-layer K/V pools — block pools with the
        block pool, prefix cache and block tables, or contiguous slot
        rows ``[B, L, H, hd]`` — and the per-slot step state; also the
        step-failure recovery path: cached prefixes die with the rows
        they described."""
        heads = self._nh // self.mp
        if self._paged:
            # +dp: each dp shard's pool range leads with a reserved
            # scratch block that its parked slots and masked lanes write
            # through (one block, row 0, without a mesh)
            nblocks = self._kv_managed + self.dp
            self.block_pool = BlockPool(
                nblocks, self._bs, reserved_blocks=1, shards=self.dp,
                fault_hook=lambda n: self._fault("pool_exhaust"))
            self.prefix_cache = (
                PrefixCache(self.block_pool, evict_hook=(
                    self._offload_demote_hook if self.host_store is not None
                    else None))
                if self._prefix_enabled else None)
            self._slot_scratch = np.asarray(
                [self.block_pool.scratch_row(self._slot_shard(i))
                 for i in range(self.num_slots)], np.int32)
            self._block_tables = np.repeat(
                self._slot_scratch[:, None], self._bps, axis=1).copy()
            self._slot_blocks = [[] for _ in range(self.num_slots)]
            shape = (nblocks // self.dp, self._bs, heads, self._hd)
        else:
            self.block_pool = self.prefix_cache = None
            shape = (self.num_slots, self.max_seq_len, heads, self._hd)

        def pool(dev):
            if self._kv_quant:
                return QuantKV(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros((shape[0], heads), dtype=torch.float32,
                                device=dev))
            return torch.zeros(shape, dtype=self._kv_dtype, device=dev)

        def layer_pools():
            if self.mesh is None:
                return pool(self.device)
            # one shard per rank, in rank order: [NB/dp, bs, H/mp, hd]
            return [pool(dev) for dev in self.mesh.devices]

        self.k_pools = [layer_pools() for _ in self.model.blocks]
        self.v_pools = [layer_pools() for _ in self.model.blocks]
        # host mirrors of the device-resident step state, re-uploaded
        # only when an admission / eviction / chunk dirties them
        self._pos = np.zeros(self.num_slots, np.int32)
        self._cur_tok = np.zeros((self.num_slots, 1), np.int32)
        # sampling lanes: temperature 0 is the greedy sentinel; the seed
        # words and the emitted-token counter derive each draw's key
        self._temp = np.zeros(self.num_slots, np.float32)
        self._topk = np.zeros(self.num_slots, np.int32)
        self._topp = np.ones(self.num_slots, np.float32)
        self._seed_lo = np.zeros(self.num_slots, np.int64)
        self._seed_hi = np.zeros(self.num_slots, np.int64)
        self._sctr = np.zeros(self.num_slots, np.int32)
        # device-side stop condition: eos id (-1 = none), remaining budget
        self._eos = np.full(self.num_slots, -1, np.int32)
        self._rem = np.zeros(self.num_slots, np.int32)
        self._aid = np.zeros(self.num_slots, np.int32)  # LoRA lane
        # demoted blocks whose download is in flight: (key, host data,
        # host scales or None, event); their content addresses
        self._offload_pending = []
        self._offload_pending_keys = set()
        self._dev_state = None
        self._state_dirty = True
        # dispatched-but-unconsumed ticks, oldest first, and the staging
        # sets no tick holds; recovery drops both (a set an asynchronous
        # copy may still touch is never handed out again)
        self._ring = []
        self._staging_free = []

    def _slot_shard(self, i):
        """The dp shard that owns batch slot ``i``: slots divide into
        ``dp`` contiguous ranges of ``num_slots/dp`` (always 0 without a
        dp mesh)."""
        return int(i) // (self.num_slots // self.dp)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_token_id=None,
               timeout=None, temperature=1.0, top_k=0, top_p=1.0,
               seed=None, priority=0, tenant=None, adapter=None):
        """Queue one generation request; returns its Request handle
        (block on ``request.result()``).  Greedy unless a sampling
        parameter is set; ``seed`` makes a sampled stream repeat.

        ``priority``: higher is served first and may preempt running
        lower-priority streams (``Engine(preemption=...)``).
        ``tenant``: the weighted-fair / rate-limit bucket
        (``Engine(tenants=...)``); None = the default tenant.
        ``timeout``: seconds the request may wait in the queue.
        ``adapter``: a loaded LoRA adapter's name (``UnknownAdapter``
        otherwise); the request pins it until it finishes.
        Overload sheds here: ``QueueFull``, ``RateLimited`` and
        ``DeadlineShed`` carry a ``retry_after`` estimate."""
        if self._draining:
            raise QueueFull(
                "engine draining: stop(drain=True) in progress — no new "
                "admissions", retry_after=None)
        if temperature <= 0:
            raise ValueError(
                f"temperature must be > 0, got {temperature} (greedy is "
                "the default when no sampling params are set)")
        if top_p <= 0 or top_p > 1:
            raise ValueError(f"top_p must be in (0, 1], got {top_p}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        try:
            eos_token_id = None if eos_token_id is None \
                else int(eos_token_id)
            seed = None if seed is None else int(seed)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"eos_token_id/seed must be ints or None: {e}") from None
        if seed is not None and not 0 <= seed < MAX_SEED:
            raise ValueError(f"seed must be in [0, 2**63), got {seed}")
        if adapter is not None:
            if self.adapters is None:
                raise UnknownAdapter(
                    f"adapter {adapter!r} requested but this engine serves "
                    "none (Engine(adapters=... / max_adapters=N))")
            adapter = str(adapter)
            self.adapters.lane(adapter)  # raises UnknownAdapter now, in
            #   the caller's thread, instead of failing mid-admit
        req = Request(prompt, max_new_tokens, eos_token_id=eos_token_id,
                      timeout=timeout, temperature=temperature,
                      top_k=top_k, top_p=top_p, seed=seed,
                      priority=priority, tenant=tenant, adapter=adapter)
        if int(req.prompt.max()) >= self.vocab_size \
                or int(req.prompt.min()) < 0:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.vocab_size})")
        total = len(req.prompt) + req.max_new_tokens
        margin = self._spec_k or 0
        if total + margin > self.max_seq_len:
            note = (f" + spec_k ({margin}) speculative window margin"
                    if margin else "")
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}){note} = {total + margin} exceeds "
                f"the slot cache length ({self.max_seq_len})")
        bucket = self._buckets.get(req.tenant)
        if bucket is not None:
            if req.cost_tokens > bucket.burst:
                self._m_shed_rate.inc()
                self.tracer.instant("req.shed", cat="request", req=req.id,
                                    reason="rate_limited",
                                    tenant=req.tenant)
                raise RateLimited(
                    f"request {req.id} costs {req.cost_tokens} tokens but "
                    f"tenant {req.tenant!r}'s bucket holds at most "
                    f"{bucket.burst:g} — it can never be admitted under "
                    "this rate limit", retry_after=None)
            wait = bucket.take(req.cost_tokens)
            if wait is not None:
                self._m_shed_rate.inc()
                self.tracer.instant("req.shed", cat="request", req=req.id,
                                    reason="rate_limited",
                                    tenant=req.tenant,
                                    retry_after_s=round(wait, 3))
                raise RateLimited(
                    f"tenant {req.tenant!r} over its token rate "
                    f"({self._tenant_policies[req.tenant].rate:g} tok/s): "
                    f"request {req.id} needs {req.cost_tokens} tokens, "
                    f"bucket refills in {wait:.2f}s",
                    retry_after=round(wait, 3))
        if self._shed_deadlines and req.deadline is not None:
            est = self.estimate_queue_wait(priority=req.priority)
            budget = req.deadline - req.submitted_at
            if est is not None and est > budget:
                if bucket is not None:
                    bucket.refund(req.cost_tokens)
                retry = round(est - budget, 3)
                self._m_shed_deadline.inc()
                self.tracer.instant("req.shed", cat="request", req=req.id,
                                    reason="deadline",
                                    est_wait_s=round(est, 3),
                                    retry_after_s=retry)
                raise DeadlineShed(
                    f"request {req.id} cannot meet its {budget:.2f}s "
                    f"deadline: estimated queue wait {est:.2f}s at the "
                    f"measured drain rate; retry after {retry:.2f}s",
                    retry_after=retry)
        # the instant before put: once queued, the engine thread may
        # admit the request concurrently
        self.tracer.instant("req.queued", cat="request", req=req.id,
                            prompt=int(len(req.prompt)),
                            max_new=req.max_new_tokens,
                            priority=req.priority, tenant=req.tenant,
                            adapter=req.adapter)
        if adapter is not None:
            # pinned after every shed check, unpinned by the request's
            # finish callback (every terminal path runs _finish)
            req._adapter_id = self.adapters.pin(adapter)
            req._finish_cbs.append(
                lambda _r, _n=adapter: self.adapters.unpin(_n))
        try:
            self.queue.put(req)
        except QueueFull as e:
            if adapter is not None:
                self.adapters.unpin(adapter)  # never queued: no finish
            if bucket is not None:
                bucket.refund(req.cost_tokens)
            self._m_shed_queue.inc()
            e.retry_after = self._queue_full_retry_after()
            self.tracer.instant("req.shed", cat="request", req=req.id,
                                reason="queue_full",
                                retry_after_s=e.retry_after)
            raise
        self._m_reqs.inc()
        self._m_queue.set(self.queue.depth())
        self._wake.set()
        return req

    # -- overload protection: drain estimate, preemption ------------------
    # entries older than this leave the drain-rate window: an idle gap
    # between bursts must not stretch the measured span
    _RATE_HORIZON_S = 10.0

    def drain_rate(self, now=None):
        """Measured drain rate (tokens/sec) over the recent emitting
        ticks; None until two emitting ticks lie inside the horizon."""
        now = time.monotonic() if now is None else now
        with self._ovl_lock:
            snap = list(self._rate_win)
        win = [w for w in snap if now - w[0] <= self._RATE_HORIZON_S]
        if len(win) < 2:
            return None
        span = win[-1][0] - win[0][0]
        if span <= 1e-3:
            return None
        # tokens after the window's first stamp, over the stamped span
        return sum(n for _, n in win[1:]) / span

    def estimate_queue_wait(self, priority=0):
        """Seconds until a request submitted now at ``priority`` reaches
        a slot, from the measured drain rate: (in-flight remaining +
        queued work at its priority or above) / rate.  None while the
        rate is unmeasured; 0.0 when nothing queues ahead and a slot is
        free or preemption would make one."""
        rate = self.drain_rate()
        if rate is None or rate <= 0:
            return None
        backlog = self.queue.backlog_tokens(min_priority=priority)
        reqs = [r for r in (s.request for s in self.scheduler.busy_slots())
                if r is not None]
        if backlog == 0:
            if len(reqs) < self.num_slots:
                return 0.0
            if self._preemption and any(r.priority < priority
                                        for r in reqs):
                return 0.0
        # with preemption on, lower-priority streams are not work this
        # request waits behind: it would evict them
        inflight = sum(r.remaining for r in reqs
                       if not self._preemption or r.priority >= priority)
        return (inflight + backlog) / rate

    def _queue_full_retry_after(self):
        """Backoff for a full queue: the measured time for one queue
        place to drain; 1.0 s while the rate is unmeasured."""
        rate = self.drain_rate()
        depth = self.queue.depth()
        if rate is None or rate <= 0 or depth == 0:
            return 1.0
        return round(max(self.queue.backlog_tokens() / rate / depth,
                         0.05), 3)

    def _fault(self, site):
        """Consult the fault injector at a named failure point: with no
        injector (or an unscheduled tick) one attribute read; a scheduled
        site counts, traces and performs its action (which may raise into
        step recovery)."""
        f = self.faults
        if f is not None and f.scheduled(site, self.ticks):
            self._m_faults.inc()
            self.tracer.instant("fault.injected", cat="fault", site=site,
                                tick=self.ticks)
            f.fire(site, self.ticks, self)

    def _preempt_history(self):
        """Locked snapshot of the preemption log (handler and watchdog
        threads read it while the engine thread appends)."""
        with self._ovl_lock:
            return list(self._preempt_log)

    def _post_admit(self, admitted, timed_out, tr):
        """Reconcile the admitted list against the preemption round (a
        slot admitted earlier this tick may since have been evicted or
        rebound: one entry per still-bound slot), emit the admitted /
        resumed instants, and count the timeouts.  Returns the
        reconciled list."""
        uniq = []
        for slot in admitted:
            if slot.request is not None and slot not in uniq:
                uniq.append(slot)
        for slot in uniq:
            req = slot.request
            tr.instant("req.admitted", cat="request", req=req.id,
                       slot=slot.index)
            if req.preemptions:
                self._m_resumed.inc()
                tr.instant("req.resumed", cat="request", req=req.id,
                           slot=slot.index, tokens=len(req.generated))
        if timed_out:
            self._m_timeout.inc(len(timed_out))
            self._m_done.inc(len(timed_out))
            for req in timed_out:
                self._rngs.pop(req.id, None)  # a preempted-then-expired
                #   request may hold a host rng stream
                tr.instant("req.evicted", cat="request", req=req.id,
                           reason="timeout")
        return uniq

    def _preempt(self, slot, tr):
        """Evict a RUNNING request mid-stream and requeue it with its
        emitted tokens.  Every full block of its computed history
        (``slot.pos`` rows: prompt + emitted-so-far) goes into the prefix
        cache first, so re-admission adopts the span and the resume
        skips re-prefill; the frozen ``req._ctx`` is what a re-admission
        prefills.  The resumed stream is token-identical: greedy
        trivially, seeded because the key folds the emitted-token
        counter.  The ring must be drained: an in-flight lane whose
        request vanished un-done would raise the consume's drift
        check."""
        req = slot.request
        i = slot.index
        ctx = (np.concatenate([req.prompt,
                               np.asarray(req.generated, np.int32)])
               if req.generated else req.prompt)
        if self.prefix_cache is not None and not req._adapter_id:
            # paged layouts only; adapter lanes never share cached K/V
            n_full = min(slot.pos // self._bs, len(self._slot_blocks[i]))
            if n_full:
                self.prefix_cache.insert(ctx, self._slot_blocks[i][:n_full])
        plan = getattr(req, "_kv_plan", None)
        if plan is not None:
            # admitted this tick but not yet bound (a higher-priority
            # submit landed in between): return the gate's reservation
            del req._kv_plan
            self.block_pool.decref(plan[0] + plan[1])
        self.scheduler.release(slot)
        self._release_slot_kv(i)
        self._park_state(i)
        req._ctx = ctx
        req.preemptions += 1
        self.queue.requeue(req)
        self._m_preempt.inc()
        with self._ovl_lock:
            self._preempt_log.append({
                "tick": self.ticks, "request": req.id, "slot": i,
                "priority": req.priority, "tenant": req.tenant,
                "generated": len(req.generated),
                "preemptions": req.preemptions})
        tr.instant("req.preempted", cat="request", req=req.id, slot=i,
                   tokens=len(req.generated), priority=req.priority)

    def _preempt_round(self, now, tr):
        """Admission-phase preemption: while the best queued priority
        outranks a running request and admission is blocked (every slot
        busy, or the paged gate just declined the head for blocks),
        evict the lowest-priority busy slot (tie: the most recently
        admitted) and admit again.  Returns (admitted, timed_out,
        emitted): emitted counts tokens of a ring drain it forced."""
        admitted, timed_out, emitted = [], [], 0
        if not self._preemption or self._draining:
            return admitted, timed_out, emitted
        for _ in range(2 * self.num_slots):
            pri = self.queue.best_priority()
            if pri is None:
                break
            if not (self.scheduler.free_count() == 0
                    or (self._paged and self._gate_declined)):
                break
            victims = [s for s in self.scheduler.busy_slots()
                       if s.request is not None
                       and s.request.priority < pri]
            if not victims:
                break
            victim = min(victims,
                         key=lambda s: (s.request.priority, -s.seq))
            if self._ring:
                # consume the in-flight ticks first: the victim's device
                # lane is not done
                emitted += self._drain_ring(tr)
                vr = victim.request
                if vr is None or vr.priority >= pri \
                        or self.scheduler.free_count() > 0:
                    # the drain finished the victim or freed another
                    # slot: admit into that capacity, then probe again
                    self._gate_declined = False
                    more, t2 = self.scheduler.admit(now, gate=self._gate)
                    admitted += more
                    timed_out += t2
                    continue
            self._preempt(victim, tr)
            self._gate_declined = False
            more, t2 = self.scheduler.admit(now, gate=self._gate)
            admitted += more
            timed_out += t2
        return admitted, timed_out, emitted

    # -- paged KV admission ------------------------------------------------
    def _kv_gate(self, req, slot):
        """Paged admission gate, consulted before a slot binds: adopt the
        prompt's longest cached prefix, then reserve every block the
        request could need UP FRONT, so decode never allocates.  Under
        pressure, LRU-evicts unreferenced cached prefixes; if the pool
        still cannot cover the rest, returns False and the request waits
        at the queue head.  Everything is scoped to the slot's dp shard:
        its trie, its free list, its eviction.

        Speculative decoding widens the worst case by ``spec_k``: the
        verify window writes rejected lanes' K/V up to spec_k positions
        past the cursor, into blocks the slot already owns.  A preempted
        request's context is its prompt + emitted snapshot and its
        remaining budget the unemitted rest: the same total, and the
        blocks its preemption cached match here.

        Adapter lanes never adopt a cached prefix (LoRA on ``out_proj``
        shifts the residual stream, so from layer 1 on the K/V depend on
        the adapter).  With a host tier, the consecutive blocks after the
        device trie's match are restored from host RAM into the leading
        fresh blocks (``_promote_blocks``)."""
        tokens = req.context
        shard = self._slot_shard(slot.index)
        s = len(tokens)
        n_total = -(-(s + req.remaining + (self._spec_k or 0)) // self._bs)
        ctx, m = ([], 0)
        if self.prefix_cache is not None and not req._adapter_id:
            ctx, m = self.prefix_cache.match(tokens, shard=shard)
        need = n_total - len(ctx)
        short = need - self.block_pool.free_count(shard)
        if short > 0 and self.prefix_cache is not None:
            evicted = self.prefix_cache.evict(short, shard=shard)
            if evicted:
                self._m_prefix_evictions.inc(len(evicted))
        if need > self.block_pool.free_count(shard):
            self.block_pool.decref(ctx)  # the cache keeps its own refs
            self._gate_declined = True   # blocks, not slots, hold the
            return False                 # head back: preemption's probe
        fresh = self.block_pool.alloc(need, shard=shard)
        if self.host_store is not None and not req._adapter_id:
            n_promo = self._promote_blocks(req, tokens, ctx, m, fresh)
            if n_promo:
                ctx = ctx + fresh[:n_promo]
                fresh = fresh[n_promo:]
                m += n_promo * self._bs
        req._kv_plan = (ctx, fresh, m)
        return True

    @property
    def _gate(self):
        """The admission gate: the paged one, or none over contiguous
        rows (a slot's row is all it needs)."""
        return self._kv_gate if self._paged else None

    def _release_slot_kv(self, i):
        """Return slot i's block references (eviction): cached prefix
        blocks fall back to the cache's reference, the rest free.
        Nothing to return on contiguous rows."""
        if not self._paged:
            return
        self.block_pool.decref(self._slot_blocks[i])
        self._slot_blocks[i] = []
        self._block_tables[i, :] = self._slot_scratch[i]

    def _bind_kv_plan(self, slot):
        """Install the gate's reservation (``req._kv_plan``) into the
        slot's table and count the prefix hit; returns (ctx, fresh, m)."""
        req = slot.request
        ctx, fresh, m = req._kv_plan
        del req._kv_plan
        i = slot.index
        blocks = ctx + fresh
        self._slot_blocks[i] = blocks
        row = np.full(self._bps, self._slot_scratch[i], np.int32)
        row[:len(blocks)] = blocks
        self._block_tables[i] = row
        if m:
            self._m_prefix_hits.inc()
            self._m_prefix_hit_tokens.inc(m)
            self.tracer.instant("req.prefix_adopted", cat="request",
                                req=req.id, tokens=m, blocks=len(ctx))
        if self._kv_quant and fresh:
            self._zero_fresh_scales(fresh, self._slot_shard(i))
        return ctx, fresh, m

    def _zero_fresh_scales(self, fresh, shard=0):
        """Zero the scale rows of freshly reserved int8 blocks, before
        their first write.  A recycled block's stale codes would
        otherwise enter the read-modify-write's amax (dequantized garbage
        raising the fresh block's scale); a zero scale turns them into
        zeros (``codes * 0``) without touching the code pool, and the
        first write re-quantizes the whole block.  On a mesh the blocks
        lie in dp shard ``shard``'s range: every mp rank of that shard
        zeroes them at their local ids."""
        if self.mesh is None:
            idx = self._upload(np.asarray(fresh, np.int64))
            for kp, vp in zip(self.k_pools, self.v_pools):
                kp.scale.index_fill_(0, idx, 0.0)
                vp.scale.index_fill_(0, idx, 0.0)
            return
        base = shard * self.block_pool.rows_per_shard
        ranks = [self.mesh.rank(m, shard) for m in range(self.mp)]
        idx = {}
        for kp, vp in zip(self.k_pools, self.v_pools):
            for r in ranks:
                dev = self.mesh.devices[r]
                if dev not in idx:
                    idx[dev] = self._upload(
                        np.asarray(fresh, np.int64) - base, dev)
                kp[r].scale.index_fill_(0, idx[dev], 0.0)
                vp[r].scale.index_fill_(0, idx[dev], 0.0)

    # -- per-slot step state -----------------------------------------------
    def _bind_sample_state(self, slot):
        """Install the admitted request's sampling and stop lanes into the
        mirrors: temperature 0 marks a greedy lane (its seed words are
        constant zeros), the counter starts at the tokens already emitted,
        and the dirty flag makes the next tick upload them."""
        req = slot.request
        i = slot.index
        if req.do_sample:
            self._temp[i] = req.temperature
            self._topk[i] = req.top_k
            self._topp[i] = req.top_p
            lo, hi = req.seed_words()
        else:
            self._temp[i] = 0.0
            self._topk[i] = 0
            self._topp[i] = 1.0
            lo, hi = 0, 0
        self._seed_lo[i] = lo
        self._seed_hi[i] = hi
        self._sctr[i] = len(req.generated)
        self._eos[i] = (-1 if req.eos_token_id is None
                        else int(req.eos_token_id))
        self._rem[i] = req.remaining
        self._aid[i] = req._adapter_id  # a resumed stream keeps its lane
        self._state_dirty = True

    def _park_state(self, i):
        """Park slot i's lanes (eviction): frozen zeros keep the parked
        row's discarded compute in bounds and greedy, rem 0 freezes it."""
        self._pos[i] = 0
        self._cur_tok[i, 0] = 0
        self._temp[i] = 0.0
        self._topk[i] = 0
        self._topp[i] = 1.0
        self._seed_lo[i] = 0
        self._seed_hi[i] = 0
        self._sctr[i] = 0
        self._eos[i] = -1
        self._rem[i] = 0
        self._aid[i] = 0
        self._state_dirty = True

    def _upload(self, a, device=None):
        """A host array as a new tensor on ``device`` (default: the
        engine's) without a synchronizing copy: on a CUDA device through
        a pinned copy and a ``non_blocking`` transfer (torch's pinned
        host allocator keeps the pinned block until the transfer is
        done); on the CPU a copy, never an alias of ``a``."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.clone()

    def _push_state(self):
        """Upload the mirrors as the device-resident step state.  Runs
        only when an admission / eviction / preemption dirtied them, and
        only over an empty ring: the mirrors reflect CONSUMED ticks, so
        an upload under an unconsumed dispatch would rewind every other
        slot's device cursor."""
        if self._ring:
            raise RuntimeError(
                "_push_state with ticks in flight: drain the ring first")
        self._dev_state = dict(
            tok=self._upload(self._cur_tok), pos=self._upload(self._pos),
            ctr=self._upload(self._sctr), temp=self._upload(self._temp),
            topk=self._upload(self._topk), topp=self._upload(self._topp),
            slo=self._upload(self._seed_lo), shi=self._upload(self._seed_hi),
            eos=self._upload(self._eos), rem=self._upload(self._rem))
        if self._paged:
            self._dev_state.update(
                tables=self._upload(self._block_tables),
                scratch=self._upload(self._slot_scratch))
        if self.adapters is not None:
            self._dev_state["aid"] = self._upload(self._aid)
        self._state_dirty = False

    def _lora(self, aid):
        """The ``models.gpt._lora_scope`` argument of a dispatch: the
        lane ids ``aid`` (a device tensor) and the banks, or () without
        adapters (the scope is then no scope at all)."""
        if self.adapters is None:
            return ()
        return (aid, self.adapters.a_bank, self.adapters.b_bank)

    def _lora_slot(self, req):
        """``_lora`` for one request's B=1 prefill: its lane as [1]."""
        if self.adapters is None:
            return ()
        return self._lora(self._upload(
            np.asarray([req._adapter_id], np.int64)))

    def _begin_chunked(self, slot):
        """Chunked admission: bind the block plan (the adopted prefix
        counts as already prefilled) and park the slot PREFILLING; the
        ragged dispatch, or the XLA chunk loop, spends the tick budget on
        its chunks.  The decode dispatch's discarded write for the slot
        lands on the next chunk's start row, which that chunk
        overwrites."""
        i = slot.index
        self._bind_sample_state(slot)
        slot.prefilled = self._bind_kv_plan(slot)[2] if self._paged else 0
        slot.pos = slot.prefilled
        self._pos[i] = slot.prefilled
        self._cur_tok[i, 0] = 0

    # -- admission prefill (prefill_chunk=None) and the XLA chunk loop ------
    def _prefill(self, slot):
        """Admission prefill of the whole context (the prompt, or a
        preempted request's prompt + emitted snapshot), then the first
        token's pick and emit.  Paged layouts adopt the cached prefix and
        store block-granular (``_prefill_paged``); contiguous rows take
        one whole-prompt forward (right-padded to a bucket under
        ``prefill_buckets``) written over the slot's whole row."""
        self._bind_sample_state(slot)
        if self._paged:
            return self._prefill_paged(slot)
        req = slot.request
        i = slot.index
        tokens = req.context
        s = len(tokens)
        if self._prefill_buckets is not None:
            S = next(b for b in self._prefill_buckets if b >= s)
            ids = np.zeros((1, S), np.int32)
            ids[0, :s] = tokens
        else:
            ids = np.asarray(tokens, np.int32)[None, :]
        with torch.no_grad(), gpt_mod._lora_scope(self._lora_slot(req)):
            last = self.model._prefill_slot(
                self._upload(ids.astype(np.int64)), self.k_pools,
                self.v_pools, i, true_len=s)
        self._m_prefill_tokens.inc(s)
        slot.pos = slot.prefilled = s
        self._pos[i] = s
        self._emit(slot, self._pick(req, last[0]))

    def _prefill_paged(self, slot):
        """Paged admission prefill: bind the gate's plan, run the
        context's non-shared tail against the adopted prefix blocks in
        one pass and store it block-granular into the fresh blocks; the
        context's full blocks then enter the prefix cache."""
        req = slot.request
        ctx, fresh, m = self._bind_kv_plan(slot)
        tokens = req.context
        s = len(tokens)
        n_tail = -(-s // self._bs) - len(ctx)
        with torch.no_grad(), gpt_mod._lora_scope(self._lora_slot(req)):
            last = self.model._prefill_paged(
                self._upload(np.asarray(tokens[m:], np.int64)[None, :]),
                self.k_pools, self.v_pools,
                self._upload(np.asarray(ctx, np.int64)),
                self._upload(np.asarray(fresh[:n_tail], np.int64)))
        if self.prefix_cache is not None and not req._adapter_id:
            self.prefix_cache.insert(tokens,
                                     (ctx + fresh)[:s // self._bs])
        self._m_prefill_tokens.inc(s - m)
        slot.pos = slot.prefilled = s
        self._pos[slot.index] = s
        self._emit(slot, self._pick(req, last[0]))

    def _run_chunk(self, slot, n):
        """One XLA chunk dispatch: K/V (and on the final chunk the
        first-token logits) for context positions ``[prefilled,
        prefilled + n)``, right-padded to ``prefill_chunk`` tokens.
        Dirties the step state (the slot's cursor moved).  Returns 1 when
        the final chunk emitted a token, else 0."""
        req = slot.request
        i = slot.index
        tokens = req.context
        s = len(tokens)
        p0 = slot.prefilled
        ids = np.zeros((1, self._chunk), np.int64)
        ids[0, :n] = tokens[p0:p0 + n]
        with torch.no_grad(), gpt_mod._lora_scope(self._lora_slot(req)), \
                self.tracer.span(
                    "prefill.chunk", req=req.id, pos=p0, n=n,
                    layout="paged" if self._paged else "contiguous"):
            if self._paged:
                last = self.model._chunk_prefill_tick_paged(
                    self._upload(ids), self.k_pools, self.v_pools,
                    self._upload(self._block_tables[i].astype(np.int64)),
                    p0, n, scratch=int(self._slot_scratch[i]))[0]
            else:
                last = self.model._chunk_prefill_slot(
                    self._upload(ids), self.k_pools, self.v_pools, i, p0,
                    n)
        slot.prefilled = slot.pos = p0 + n
        self._m_chunks.inc()
        self._m_prefill_tokens.inc(n)
        self._state_dirty = True
        if slot.prefilled < s:
            self._pos[i] = slot.prefilled
            return 0
        if self.prefix_cache is not None and not req._adapter_id:
            self.prefix_cache.insert(tokens,
                                     self._slot_blocks[i][:s // self._bs])
        self._pos[i] = s
        self._emit(slot, self._pick(req, last[0]))
        return 1

    def _prefill_chunked(self, prefilling):
        """The XLA chunk loop: spend at most ``tick_token_budget`` prompt
        tokens, round-robin over the PREFILLING slots in admission order,
        one chunk a slot a pass.  Returns the tokens final chunks
        emitted."""
        budget = self._tick_budget
        emitted = 0
        queue = deque(prefilling)
        while queue and budget > 0:
            slot = queue.popleft()
            n = min(self._chunk, len(slot.request.context) - slot.prefilled)
            if n > budget:
                break  # a tick's first chunk always fits (budget >= C)
            budget -= n
            if self._run_chunk(slot, n):
                emitted += 1
            else:
                queue.append(slot)
        return emitted

    def _pick(self, req, row):
        """The next token from one logits row ``row`` [V] (a tensor on any
        device): the argmax for a greedy request; else the device draw of
        ``GPTModel._sample_lanes`` with key(seed, tokens emitted), as the
        dispatch epilogues draw (``sample_mode="device"``), or numpy's
        draw from the filtered row on the request's own
        ``np.random.default_rng(seed)`` stream (``"host"``)."""
        if not req.do_sample:
            return int(torch.argmax(row))
        if self.sample_mode == "device":
            return self._pick_device(req, row)
        rng = self._rngs.get(req.id)
        if rng is None:
            rng = self._rngs[req.id] = np.random.default_rng(
                req.sample_seed)
        filt = _filter_logits_np(row.float().cpu().numpy(),
                                 req.temperature, req.top_k, req.top_p)
        return int(rng.choice(len(filt), p=_softmax_np(filt)))

    def _pick_device(self, req, row):
        """Device-mode pick of a prefill's first token: the same filters
        and key derivation as the fused dispatches, run where ``row``
        lies."""
        dev = row.device
        lo, hi = req.seed_words()
        ids = gpt_mod.sample_rows(
            row.float()[None, :],
            torch.tensor([req.temperature], dtype=torch.float32,
                         device=dev),
            torch.tensor([req.top_k], dtype=torch.int32, device=dev),
            torch.tensor([req.top_p], dtype=torch.float32, device=dev),
            torch.tensor([lo], dtype=torch.int64, device=dev),
            torch.tensor([hi], dtype=torch.int64, device=dev),
            torch.tensor([len(req.generated)], dtype=torch.int32,
                         device=dev))
        return int(ids[0])

    # -- emission -----------------------------------------------------------
    def _emit(self, slot, tok):
        """Record one generated token; finish + evict on EOS or
        max_new_tokens, else arm the slot for the next tick."""
        req = slot.request
        now = time.monotonic()
        if req._sinks:
            # live TokenStream consumers: the fan-out runs under the sink
            # lock, spanned so the trace prices it
            with self.tracer.span("stream.emit", cat="serving", req=req.id):
                req._emit_token(int(tok))
        else:
            req._emit_token(int(tok))
        if req.first_token_at is None:
            req.first_token_at = now
            ttft = (now - req.submitted_at) * 1e3
            self._m_ttft.observe(ttft)
            self.tracer.instant("req.first_token", cat="request",
                                req=req.id, ttft_ms=round(ttft, 3))
        self._m_tokens.inc()
        self._m_rate.add(1, now)
        ctx_len = len(req.prompt) + len(req.generated)
        if ctx_len > self._max_context_len:
            self._max_context_len = ctx_len
        finished = (len(req.generated) >= req.max_new_tokens or
                    (req.eos_token_id is not None
                     and int(tok) == int(req.eos_token_id)))
        i = slot.index
        if finished:
            n_after_first = len(req.generated) - 1
            if n_after_first > 0:
                self._m_tpot.observe(
                    (now - req.first_token_at) / n_after_first * 1e3)
            self._rngs.pop(req.id, None)
            self.scheduler.evict(slot)
            self._evicted_in_tick += 1
            self._release_slot_kv(i)
            self._park_state(i)
            self._m_done.inc()
            self.tracer.instant("req.finished", cat="request", req=req.id,
                                tokens=len(req.generated))
            return
        self._cur_tok[i, 0] = int(tok)
        self._pos[i] = slot.pos
        self._sctr[i] = len(req.generated)
        self._rem[i] = req.max_new_tokens - len(req.generated)

    def _emit_window_lane(self, slot, picks_row, acc_i, n_emit_dev_i,
                          done_i, tick):
        """Emit a decode lane's accepted picks plus the bonus token
        through ``_emit``; host-vs-device stop-condition drift raises
        into step recovery.  Returns (emitted, accepted)."""
        i = slot.index
        n_cnt = 0
        n_em = 0
        j = 0
        while True:
            tok = int(picks_row[j])
            matched = j < acc_i
            if matched:
                n_cnt += 1
            slot.pos += 1
            self._pos[i] = slot.pos
            self._emit(slot, tok)
            n_em += 1
            if slot.request is None or not matched:
                break
            j += 1
        if n_em != n_emit_dev_i or done_i != (slot.request is None):
            raise RuntimeError(
                f"stop-condition drift: slot {i} host emitted {n_em} "
                f"(finished={slot.request is None}) vs device "
                f"n_emit={n_emit_dev_i} done={done_i} at tick {tick}")
        return n_em, n_cnt

    # -- the ragged dispatch -------------------------------------------------
    def _plan_ragged_chunks(self, prefilling):
        """This tick's prefill-chunk lanes: admission order, one lane per
        slot of up to ``min(W, budget left)`` tokens, capped by
        ``tick_token_budget``.  Returns [(slot, n_tokens, is_final)]."""
        plan = []
        budget = self._tick_budget
        for slot in prefilling:
            req = slot.request
            n = min(self._wmax, budget, len(req.context) - slot.prefilled)
            if n <= 0:
                continue
            plan.append((slot, n, slot.prefilled + n >= len(req.context)))
            budget -= n
            if budget <= 0:
                break
        return plan

    def _draft_window(self, active):
        """The verify windows' tokens ``[num_slots, k + 1]``: lane 0 each
        slot's current token, lanes 1..k the proposer's drafts, pad lanes
        repeating the current token (filler: never counted as proposed,
        never accepted).  Sets ``slot.spec_lanes`` to the drafts the
        proposer really returned.  A proposer that raises degrades to
        zero drafts and counts ``serving.proposer_failures``."""
        k = self._spec_k
        toks = np.zeros((self.num_slots, k + 1), np.int32)
        toks[:, 0] = self._cur_tok[:, 0]
        for slot in active:
            i = slot.index
            req = slot.request
            # lanes past remaining - 1 could never be accepted: the
            # window emits at most lanes + 1 tokens before max_new_tokens
            n_lanes = min(k, req.max_new_tokens - len(req.generated) - 1)
            toks[i, 1:] = toks[i, 0]
            n_drafted = 0
            if n_lanes > 0:
                history = np.concatenate(
                    [req.prompt, np.asarray(req.generated, np.int32)])
                try:
                    self._fault("spec_draft")
                    d = np.asarray(self.proposer.propose(history, n_lanes),
                                   np.int32).reshape(-1)[:n_lanes]
                except Exception as e:
                    # a proposer outage costs the drafts, not the tick
                    self._m_proposer_failures.inc()
                    self.tracer.instant("spec.proposer_failed",
                                        cat="serving", req=req.id,
                                        error=repr(e))
                    d = np.zeros(0, np.int32)
                toks[i, 1:1 + len(d)] = d
                n_drafted = len(d)
            slot.spec_lanes = n_drafted
        return toks

    def _dispatch_ragged(self, active, plan, tr):
        """Dispatch one ragged window tick without consuming it: decoding
        slots as mode-0 lanes (width 1, or the k+1 verify window with
        proposed drafts), chunks as mode-1/2 lanes of their token count —
        one ``_fused_ragged_tick_slots`` call whatever the mix.  Nothing
        here waits for the device: the inputs go up from a pinned staging
        set, and the packed picks / counts / done mask go down into it
        behind a recorded event.  Chunk lanes advance the prefill cursor
        here (their tokens are known)."""
        W = self._wmax
        spec_w = self._spec_w
        stg = self._take_staging()
        toks, width = stg.toks.numpy(), stg.width.numpy()
        mode, lanes = stg.mode.numpy(), stg.lanes.numpy()
        for a in (toks, width, mode, lanes):
            a.fill(0)
        if self._spec_k is not None and active:
            with tr.span("spec.draft", batch=len(active),
                         spec_k=self._spec_k):
                toks[:, :spec_w] = self._draft_window(active)
        for slot in active:
            width[slot.index] = spec_w
            lanes[slot.index] = slot.spec_lanes
        chunk_toks = 0
        for slot, n, final in plan:
            i = slot.index
            p0 = slot.prefilled
            toks[i, :n] = slot.request.context[p0:p0 + n]
            width[i] = n
            mode[i] = 2 if final else 1
            chunk_toks += n
        # push BEFORE the chunk lanes' mirror advance: the upload carries
        # the pre-dispatch cursors (the dispatch advances them by width)
        if self._state_dirty or self._dev_state is None:
            self._push_state()
        # blocks the kernel walks, on the pre-dispatch cursors: the
        # streaming body stops at each lane's causal horizon, the gather
        # body walks the slot's whole table
        slots = list(active) + [s for s, _, _ in plan]
        walked = 0
        for s in slots:
            i = s.index
            if self._variant == "gather":
                walked += self._bps
            else:
                live = int(self._pos[i]) + max(int(width[i]), 1)
                walked += min(self._bps, (live - 1) // self._bs + 1)
        self._m_kv_blocks_walked.set(walked)
        self._m_kv_walked_total.inc(walked)
        for slot, n, _ in plan:
            slot.prefilled += n
            slot.pos = slot.prefilled
            self._pos[slot.index] = slot.prefilled
            self._m_chunks.inc()
            self._m_prefill_tokens.inc(n)
        st = self._dev_state
        dev = self.device

        def up(t):
            return t.to(dev, non_blocking=True, copy=True)

        span = ("decode.ragged_stream" if self._variant == "stream"
                else "decode.ragged")
        self._fault("dispatch")
        with torch.no_grad(), gpt_mod._lora_scope(self._lora(st.get("aid"))), \
                tr.span(span, batch=len(slots), w=W, chunks=len(plan),
                        chunk_tokens=chunk_toks, kv_blocks_walked=walked):
            (picks, n_acc, n_emit, done, new_tok, new_pos, new_ctr,
             new_rem, _, _) = self._runner._fused_ragged_tick_slots(
                up(stg.toks), self.k_pools, self.v_pools, st["tables"],
                up(stg.width), up(stg.mode), up(stg.lanes), st["tok"],
                st["pos"], st["temp"], st["topk"], st["topp"], st["slo"],
                st["shi"], st["ctr"], st["eos"], st["rem"],
                scratch=st["scratch"], emit_w=spec_w,
                variant=self._variant,
                # host facts: _temp changes only at admission or
                # eviction, both of which re-upload the state
                any_sampling=bool((self._temp > 0).any()),
                any_final=bool((mode == 2).any()))
            packed = torch.cat([picks, n_acc[:, None], n_emit[:, None],
                                done[:, None].to(torch.int32)], dim=1)
            stg.out.copy_(packed, non_blocking=True)
            if stg.event is not None:
                stg.event.record(torch.cuda.current_stream(dev))
        st["tok"], st["pos"], st["ctr"], st["rem"] = \
            new_tok, new_pos, new_ctr, new_rem
        self._m_fused_ticks.inc()
        self.ragged_dispatches += 1
        if self._spec_k is not None and active:
            self._m_spec_windows.inc(len(active))
        return _InflightTick(
            self.ticks, "ragged", "paged", slots,
            [(int(mode[s.index]), int(width[s.index]),
              int(lanes[s.index])) for s in slots], stg,
            (self._pos.copy(), self._rem.copy()))

    def _consume_lanes(self, inf, mats, tr):
        """Emit a downloaded tick, per lane mode: chunk lanes (mode 1,
        ragged) emit nothing; a final chunk (mode 2, ragged) registers
        the prompt's full blocks in the prefix cache and emits picks lane
        0; decode lanes (mode 0: the ragged window's, or an XLA decode or
        verify tick's) run ``_emit_window_lane`` (a pure decode lane is
        the zero-draft case of a verify window).  Drift between the
        host's and the device's stop condition raises."""
        picks = mats["picks"]
        n_acc = mats["n_acc"]
        n_emit_dev = mats["n_emit"]
        done = mats["done"]
        emitted = emitted_spec = n_spec = total_acc = 0
        with tr.span("decode.emit", batch=len(inf.slots)) as emit_sp:
            for slot, req, (mode_i, _, lanes_i) in zip(
                    inf.slots, inf.reqs, inf.meta_lanes):
                i = slot.index
                if slot.request is not req:
                    if not done[i]:
                        raise RuntimeError(
                            f"stop-condition drift: slot {i} was evicted "
                            f"on the host but tick {inf.tick}'s device "
                            "lane is not done")
                    continue
                if mode_i == 1:
                    if int(n_emit_dev[i]):
                        raise RuntimeError(
                            f"ragged drift: chunk lane {i} emitted "
                            f"{int(n_emit_dev[i])} on device at tick "
                            f"{inf.tick}")
                    continue
                if mode_i == 2:
                    ctxt = req.context
                    if self.prefix_cache is not None \
                            and not req._adapter_id:
                        self.prefix_cache.insert(
                            ctxt,
                            self._slot_blocks[i][:len(ctxt) // self._bs])
                    self._emit(slot, int(picks[i, 0]))
                    emitted += 1
                    if int(n_emit_dev[i]) != 1 or \
                            bool(done[i]) != (slot.request is None):
                        raise RuntimeError(
                            f"ragged drift: final-chunk lane {i} device "
                            f"n_emit={int(n_emit_dev[i])} "
                            f"done={bool(done[i])} vs host finished="
                            f"{slot.request is None} at tick {inf.tick}")
                    continue
                n_em, n_cnt = self._emit_window_lane(
                    slot, picks[i], int(n_acc[i]), int(n_emit_dev[i]),
                    bool(done[i]), inf.tick)
                if self._spec_k is not None:
                    self._m_spec_proposed.inc(lanes_i)
                    self._m_spec_accepted.inc(n_cnt)
                    total_acc += n_cnt
                    n_spec += 1
                    emitted_spec += n_em
                emitted += n_em
            emit_sp.args.update(emitted=emitted, accepted=total_acc)
        if n_spec:
            self._note_acceptance(emitted_spec, n_spec)
        return emitted

    # -- the XLA dispatches (attn_impl="xla") -------------------------------
    def _take_staging(self):
        """A free staging set, or a new one."""
        return (self._staging_free.pop() if self._staging_free
                else _Staging(self.num_slots, self._wmax, self._spec_w,
                              self.device))

    def _layout(self):
        return "paged" if self._paged else "contiguous"

    def _pack_download(self, stg, cols):
        """Queue the tick's one download: ``cols`` ([B] or [B, n] int
        tensors) packed into ``stg.out`` behind a recorded event."""
        packed = torch.cat([c.to(torch.int32).reshape(self.num_slots, -1)
                            for c in cols], dim=1)
        stg.out.copy_(packed, non_blocking=True)
        if stg.event is not None:
            stg.event.record(torch.cuda.current_stream(self.device))

    def _dispatch_decode(self, active, tr):
        """Dispatch one fused decode + sample tick without consuming it:
        the step state stays on the device between ticks (uploaded only
        when admission, eviction or a chunk dirtied the mirrors), the
        sample and the stop condition run in the dispatch, and the ids
        and done mask come home in the packed download.  Synchronizes
        nothing."""
        stg = self._take_staging()
        if self._state_dirty or self._dev_state is None:
            self._push_state()
        st = self._dev_state
        self._fault("dispatch")
        with torch.no_grad(), gpt_mod._lora_scope(self._lora(st.get("aid"))), \
                tr.span("decode.dispatch", batch=len(active),
                        layout=self._layout(), fused=True):
            # in_range: a cursor stays below L (the epilogue clamps it
            # at L - 1, admission keeps prompt + max_new_tokens <= L)
            (ids, done, new_tok, new_pos, new_ctr, new_rem, _, _) = \
                self.model._fused_decode_tick_slots(
                    st["tok"], self.k_pools, self.v_pools, st["pos"],
                    st["temp"], st["topk"], st["topp"], st["slo"],
                    st["shi"], st["ctr"], st["eos"], st["rem"],
                    any_sampling=bool((self._temp > 0).any()),
                    in_range=True, block_tables=st.get("tables"))
            # a decode lane: no draft accepted, one token emitted live
            self._pack_download(stg, [ids, torch.zeros_like(ids),
                                      new_ctr - st["ctr"], done])
        st["tok"], st["pos"], st["ctr"], st["rem"] = \
            new_tok, new_pos, new_ctr, new_rem
        self._m_fused_ticks.inc()
        return _InflightTick(self.ticks, "decode", self._layout(),
                             list(active), [(0, 1, 0)] * len(active), stg,
                             (self._pos.copy(), self._rem.copy()))

    def _dispatch_spec(self, active, tr):
        """Dispatch one fused speculative verify tick without consuming
        it: the proposer's draft window goes up through the staging set,
        and the picks, accept counts, emit counts and done mask come home
        in one packed download."""
        W = self._spec_w
        stg = self._take_staging()
        toks, lanes = stg.toks.numpy(), stg.lanes.numpy()
        lanes.fill(0)
        with tr.span("spec.draft", batch=len(active), spec_k=W - 1):
            toks[:, :W] = self._draft_window(active)
        for slot in active:
            lanes[slot.index] = slot.spec_lanes
        if self._state_dirty or self._dev_state is None:
            self._push_state()
        st = self._dev_state
        dev = self.device

        def up(t):
            return t.to(dev, non_blocking=True, copy=True)

        self._fault("dispatch")
        with torch.no_grad(), gpt_mod._lora_scope(self._lora(st.get("aid"))), \
                tr.span("decode.dispatch", batch=len(active),
                        layout=self._layout(), spec_w=W, fused=True):
            # in_range: the epilogue clamps a cursor at L - W, admission
            # keeps prompt + max_new_tokens + spec_k <= L
            (picks, n_acc, n_emit, done, new_tok, new_pos, new_ctr,
             new_rem, _, _) = self.model._fused_spec_verify_tick_slots(
                up(stg.toks), self.k_pools, self.v_pools, st["pos"],
                up(stg.lanes), st["temp"], st["topk"], st["topp"],
                st["slo"], st["shi"], st["ctr"], st["eos"], st["rem"],
                any_sampling=bool((self._temp > 0).any()), in_range=True,
                block_tables=st.get("tables"))
            self._pack_download(stg, [picks, n_acc, n_emit, done])
        st["tok"], st["pos"], st["ctr"], st["rem"] = \
            new_tok, new_pos, new_ctr, new_rem
        self._m_fused_ticks.inc()
        self._m_spec_windows.inc(len(active))
        return _InflightTick(
            self.ticks, "spec", self._layout(), list(active),
            [(0, W, int(lanes[s.index])) for s in active], stg,
            (self._pos.copy(), self._rem.copy()))

    def _note_acceptance(self, emitted, n_slots):
        """The acceptance gauges after a verify tick: the lifetime rate,
        and tokens emitted a verifying slot."""
        proposed = self._m_spec_proposed.value
        if proposed:
            self._m_spec_rate.set(self._m_spec_accepted.value / proposed)
        if n_slots:
            self._m_spec_tpt.set(emitted / n_slots)

    def _host_window(self, active, toks, tr):
        """Host mode's dispatch: the XLA window over this tick's
        uploaded cursors (a [B, 1] decode or a [B, k+1] verify window),
        its logits downloaded whole.  Returns the logits as a CPU tensor
        [B, V] or [B, W, V]."""
        m = self.model
        args = (self._upload(toks), self.k_pools, self.v_pools)
        pos = self._upload(self._pos)
        W = toks.shape[1]
        self._fault("dispatch")
        with torch.no_grad(), tr.span("decode.dispatch", batch=len(active),
                                      layout=self._layout(),
                                      **({"spec_w": W} if self._spec_k
                                         else {})):
            if self._paged:
                tick = (m._spec_verify_tick_slots_paged if self._spec_k
                        else m._decode_tick_slots_paged)
                last = tick(*args, self._upload(self._block_tables),
                            pos)[0]
            else:
                tick = (m._spec_verify_tick_slots if self._spec_k
                        else m._decode_tick_slots)
                last = tick(*args, pos, in_range=True)[0]
        with tr.span("decode.d2h") as d2h_sp:
            rows = last.float().cpu()
            d2h_sp.args["bytes"] = rows.numel() * 4
        self._m_d2h.set(rows.numel() * 4)
        return rows

    def _decode_tick(self, active, tr):
        """One host-mode tick (``sample_mode="host"``, depth 1): the
        decode or verify window, its logits home, and every live slot's
        picks drawn on the host (``_pick``) and emitted."""
        if self._spec_k is not None:
            return self._spec_decode_tick(active, tr)
        rows = self._host_window(active, self._cur_tok, tr)
        t0 = time.monotonic()
        emitted = 0
        with tr.span("decode.sample", batch=len(active),
                     layout=self._layout()) as sample_sp:
            for slot in active:
                slot.pos += 1
                self._pos[slot.index] = slot.pos
                self._emit(slot, self._pick(slot.request, rows[slot.index]))
                emitted += 1
            sample_sp.args["emitted"] = emitted
        self._m_sample_ms.observe((time.monotonic() - t0) * 1e3)
        return emitted

    def _spec_decode_tick(self, active, tr):
        """Host-mode speculative tick: draft, verify the k+1 window, then
        per slot pick lane j on the host and emit it while it matches the
        draft (plus the bonus token) — one host draw per emitted token,
        as the one-token tick draws."""
        with tr.span("spec.draft", batch=len(active), spec_k=self._spec_k):
            toks = self._draft_window(active)
        rows = self._host_window(active, toks, tr)
        self._m_spec_windows.inc(len(active))
        t0 = time.monotonic()
        emitted = total_acc = 0
        with tr.span("decode.sample", batch=len(active),
                     layout=self._layout()) as sample_sp:
            for slot in active:
                i = slot.index
                req = slot.request
                self._m_spec_proposed.inc(slot.spec_lanes)
                n_acc = j = 0
                while True:
                    tok = self._pick(req, rows[i, j])
                    matched = j < slot.spec_lanes \
                        and int(toks[i, j + 1]) == tok
                    n_acc += matched
                    slot.pos += 1
                    self._pos[i] = slot.pos
                    self._emit(slot, tok)
                    emitted += 1
                    if slot.request is None or not matched:
                        break
                    j += 1
                slot.spec_lanes = 0
                self._m_spec_accepted.inc(n_acc)
                total_acc += n_acc
            sample_sp.args.update(emitted=emitted, accepted=total_acc)
        self._m_sample_ms.observe((time.monotonic() - t0) * 1e3)
        self._note_acceptance(emitted, len(active))
        return emitted

    def _d2h_wait(self, stg):
        """The consume's one sync: wait for the event recorded after the
        tick's download (a CPU engine's download is already done).  With
        a watchdog armed the wait polls the event instead of blocking in
        ``synchronize()``, so a fired watchdog raises ``WatchdogTimeout``
        here, into step recovery."""
        ev = stg.event
        if ev is None:
            return
        if self.watchdog_s is None:
            ev.synchronize()
            return
        while not ev.query():
            if self._watchdog_fired:
                raise WatchdogTimeout(
                    f"watchdog converted a wedged d2h at tick "
                    f"{self.tick_no} into step recovery")
            time.sleep(0.0002)

    def _consume(self, inf, tr):
        """Wait for one dispatched tick's download (``decode.d2h_wait``;
        ``decode.d2h`` at ``async_depth=1``) and emit it.  When a newer
        tick is still in flight, the emit runs in a ``host.overlap`` span
        and counts into ``serving.tick_overlap_ms``.  The tick's staging
        set then returns to the free list."""
        stg = inf.staging
        wait_name = ("decode.d2h_wait" if self.async_depth > 1
                     else "decode.d2h")
        nbytes = stg.out.numel() * stg.out.element_size()
        # the injectable wedge: a scheduled d2h_hang blocks at the
        # engine's real sync point until the watchdog converts it
        self._fault("d2h_hang")
        t0 = time.monotonic()
        with tr.span(wait_name, tick=inf.tick, bytes=nbytes):
            self._d2h_wait(stg)
        self._m_d2h_wait.observe((time.monotonic() - t0) * 1e3)
        self._m_d2h.set(nbytes)
        out = stg.out.numpy()
        E = out.shape[1] - 3
        mats = {"picks": out[:, :E], "n_acc": out[:, E],
                "n_emit": out[:, E + 1], "done": out[:, E + 2] != 0}
        in_flight = bool(self._ring)
        t1 = time.monotonic()
        with (tr.span("host.overlap", tick=inf.tick) if in_flight
              else nullcontext()):
            emitted = self._consume_lanes(inf, mats, tr)
        if in_flight:
            self._overlap_acc += time.monotonic() - t1
        self._staging_free.append(stg)
        return emitted

    def _drain_ring(self, tr):
        """Consume every in-flight tick, oldest first (the barrier before
        the mirrors are uploaded again).  Returns tokens emitted."""
        emitted = 0
        while self._ring:
            emitted += self._consume(self._ring.pop(0), tr)
        return emitted

    def _note_dispatch_gap(self, n_active):
        """Pre-dispatch bookkeeping of both tick shapes: the stall
        histogram and the decode-batch gauge."""
        if self._last_decode_end is not None:
            self._m_stall.observe(
                (time.monotonic() - self._last_decode_end) * 1e3)
        self._m_decode_batch.set(n_active)

    # -- cross-thread orders: KV migration, prefix warming, adapters -------
    # Migration hands a LIVE decoding stream to another engine: the
    # slot's full KV blocks (every layer, K and V, int8 codes with their
    # scales) plus the request's resume snapshot (prompt, emitted tokens,
    # sampling parameters, the effective seed, the host rng state), in the
    # JAX package's payload format.  The destination adopts the blocks
    # into its pool and prefix trie and queues an equivalent request;
    # admission prefix-matches the adopted blocks and binds the sample
    # state at counter len(generated): the preemption-resume path, so the
    # resumed stream is token-identical.  Every entry point registers a
    # _MigrateDemand that the ENGINE THREAD services at the next tick
    # boundary (``_service_migrations``), after draining the ring.  Fault
    # sites: ``migrate_export`` declines an export with the stream
    # untouched, ``migrate_import`` rolls the destination's allocation
    # back to refcount 0; ``migrate_wire`` is the transports'.

    def _register_demand(self, demand):
        with self._mig_lock:
            self._migrate_demands.append(demand)
        self._wake.set()
        return demand

    def _migrate_pending(self):
        with self._mig_lock:
            return len(self._migrate_demands)

    def _migrate_actionable(self):
        """True when a registered order can make progress on the next
        tick (the idle loop's wake condition); a waiting export is left
        out: whatever makes it actionable wakes the loop itself."""
        with self._mig_lock:
            return any(not d.waiting for d in self._migrate_demands)

    def _migration_history(self):
        """Locked snapshot of the migration log."""
        with self._mig_lock:
            return list(self._migration_log)

    def _await_demand(self, d, wait, timeout):
        if not wait:
            return d
        try:
            return d.wait(timeout)
        except TimeoutError:
            # withdraw the order if the engine has not picked it up yet
            with self._mig_lock:
                if d in self._migrate_demands:
                    self._migrate_demands.remove(d)
            raise

    def _no_mesh(self, what):
        if self.mesh is not None:
            raise NotImplementedError(
                f"Engine.{what} over a serving mesh is not ported yet: "
                "ROADMAP.md Queue A 10 (migration, prefix warming and the "
                "drain over per-shard pools)")

    def live_request_ids(self):
        """Ids of the requests bound to slots (prefilling included), in
        slot order: the SIGTERM drain's worklist.  Queued requests are
        absent: a draining engine admits nothing, so they have emitted
        nothing and fail over with no lost work."""
        return [s.request.id for s in self.scheduler.busy_slots()
                if s.request is not None]

    def migrate_out(self, request_id=None, min_tokens=1,
                    deliver="return", wait=True, timeout=30.0):
        """Export a LIVE decoding stream off this engine.  With
        ``request_id=None`` the engine picks a victim (lowest priority,
        most work remaining); otherwise the named request is exported
        once it is decoding with ``min_tokens`` emitted.  The stream's
        waiter unblocks with ``Migrated`` (its ``emitted`` carries the
        tokens generated here).  ``deliver="return"``: the payload is
        this call's result (``{"payload", "generated", "completed":
        False}``); ``"error"``: the payload rides inside the waiter's
        ``Migrated`` and this call's payload is None.  A request that
        finishes first returns ``{"completed": True, "generated": [...],
        "payload": None}``; a scheduled ``migrate_export`` fault raises
        here and leaves the stream running."""
        self._no_mesh("migrate_out")
        if deliver not in ("return", "error"):
            raise ValueError(f"deliver must be 'return' or 'error', "
                             f"got {deliver!r}")
        d = self._register_demand(_MigrateDemand(
            "out", request_id=request_id, min_tokens=int(min_tokens),
            deliver=deliver))
        return self._await_demand(d, wait, timeout)

    def migrate_in(self, payload, wait=True, timeout=30.0):
        """Adopt a migrated stream: its KV blocks into this engine's pool
        and prefix trie (all-or-nothing), then an equivalent request that
        resumes the stream token-identically.  Takes the live payload
        (``kv["data"]`` an ndarray) or the JSON wire form
        (``kv["data_b64"]``, decoded here on the caller's thread under
        the ``migrate.wire`` span).  Returns ``{"request": Request,
        "blocks": n}``.  Raises ValueError (geometry / malformed),
        ``KVDtypeMismatch``, QueueFull (draining or full), or an injected
        ``migrate_import`` fault; on any failure this engine owns
        nothing."""
        self._no_mesh("migrate_in")
        kv = payload.get("kv") if isinstance(payload, dict) else None
        with self.tracer.span(
                "migrate.wire", cat="serving",
                blocks=int(kv.get("n_blocks") or 0) if kv else 0):
            if not isinstance(payload, dict) \
                    or not isinstance(payload.get("request"), dict):
                raise ValueError(
                    "migration payload must carry a 'request' dict (see "
                    "Engine.migrate_out)")
            if kv is not None and "data_b64" in kv:
                payload = payload_from_json(payload)
                kv = payload.get("kv")
            if not payload["request"].get("prompt"):
                raise ValueError("migration payload request has no prompt")
            if kv is not None and kv.get("n_blocks") \
                    and kv.get("data") is None:
                raise ValueError(
                    "migration payload kv names n_blocks but carries no "
                    "data")
        d = self._register_demand(_MigrateDemand("in", payload=payload))
        return self._await_demand(d, wait, timeout)

    def export_prefix(self, tokens, wait=True, timeout=30.0):
        """Cross-replica prefix warming, export side: gather the longest
        cached prefix of ``tokens`` (device trie, then the host tier's
        continuation).  Returns a payload with ``request=None`` and a
        ``prefix`` token list, or None when nothing is cached."""
        self._no_mesh("export_prefix")
        d = self._register_demand(_MigrateDemand(
            "prefix_out", tokens=[int(t) for t in tokens]))
        return self._await_demand(d, wait, timeout)

    def import_prefix(self, payload, wait=True, timeout=30.0):
        """Cross-replica prefix warming, import side: adopt a peer's
        exported blocks into this engine's prefix trie, so the next
        admission sharing the prefix skips its prefill.  Returns
        ``{"blocks": n, "tokens": n * block_size}``.  Live or JSON wire
        form, as ``migrate_in``."""
        self._no_mesh("import_prefix")
        if payload is None:
            return {"blocks": 0, "tokens": 0}
        kv = payload.get("kv") if isinstance(payload, dict) else None
        with self.tracer.span(
                "migrate.wire", cat="serving",
                blocks=int(kv.get("n_blocks") or 0) if kv else 0):
            if kv is not None and "data_b64" in kv:
                payload = payload_from_json(payload)
        d = self._register_demand(_MigrateDemand(
            "prefix_in", payload=payload))
        return self._await_demand(d, wait, timeout)

    # -- hot adapter load / unload (serving/lora.py) -----------------------
    def load_adapter(self, name, adapter, wait=True, timeout=30.0):
        """Hot-load a LoRA adapter under ``name`` while serving.  The
        engine thread writes the lane at the next tick boundary after
        draining the ring, so no dispatched tick straddles the write (with
        no loop thread running, the caller's thread services it at once).
        The bank shapes are fixed, so this is pure data movement.  Raises
        ``RegistryFull`` (no free lane), ``ValueError`` (shape mismatch,
        duplicate name), or an injected ``adapter_load`` fault (banks and
        inventory untouched).  ``wait=False`` returns the pending
        order."""
        if self.adapters is None:
            raise RuntimeError(
                "this engine serves no adapters: construct with "
                "Engine(adapters=...) or max_adapters=N to reserve bank "
                "lanes")
        if not isinstance(adapter, LoRAAdapter):
            raise TypeError(
                f"expected LoRAAdapter, got {type(adapter).__name__}")
        return self._adapter_await(self._register_demand(_MigrateDemand(
            "adapter_load", name=str(name), adapter=adapter)), wait, timeout)

    def unload_adapter(self, name, wait=True, timeout=30.0):
        """Unload adapter ``name``: refused (``AdapterInUse``) while an
        in-flight request pins it, else its lane is zeroed and freed.
        Serviced as ``load_adapter`` is."""
        if self.adapters is None:
            raise RuntimeError("this engine serves no adapters")
        return self._adapter_await(self._register_demand(_MigrateDemand(
            "adapter_unload", name=str(name))), wait, timeout)

    def _adapter_await(self, d, wait, timeout):
        t = self._thread
        if t is None or not t.is_alive():
            # nothing else is stepping: service it on this thread
            self._service_migrations(self.tracer)
        return self._await_demand(d, wait, timeout)

    def _service_adapter(self, d, tr):
        """Engine-thread half of load / unload: drain the ring first (a
        dispatched tick read the old banks and is consumed against
        them), then write the lane; a failure is the order's verdict.
        Returns the tokens the drain emitted."""
        emitted = self._drain_ring(tr) if self._ring else 0
        name = d.args["name"]
        try:
            with tr.span("lora.swap", cat="serving", op=d.kind,
                         adapter=name):
                self._fault("adapter_load")
                if d.kind == "adapter_load":
                    lane = self.adapters.load(name, d.args["adapter"])
                    tr.instant("adapter.loaded", cat="serving",
                               adapter=name, lane=lane)
                else:
                    lane = self.adapters.unload(name)
                    tr.instant("adapter.unloaded", cat="serving",
                               adapter=name, lane=lane)
            d.complete({"name": name, "lane": lane})
        except Exception as e:  # the order's verdict channel
            d.fail(e)
        return emitted

    def _service_migrations(self, tr):
        """Engine-thread service point at the top of every tick: act on
        each registered order (an export whose target is not yet
        exportable waits for a later tick); a per-order failure is that
        order's verdict, never the tick's.  Returns the tokens emitted by
        the ring drains the orders forced (and by a re-shard's)."""
        emitted = 0
        if self._reshard:
            emitted += self._drain_ring(tr) if self._ring else 0
            self._runner = self._shard_model()
            self._reshard = False
        with self._mig_lock:
            if not self._migrate_demands:
                return emitted
            demands = list(self._migrate_demands)
            self._migrate_demands = []
        keep = []
        for d in demands:
            try:
                if d.kind == "out":
                    verdict, n = self._service_migrate_out(d, tr)
                    emitted += n
                    if verdict == "wait":
                        d.waiting = True
                        keep.append(d)
                elif d.kind == "in":
                    emitted += self._service_migrate_in(d, tr)
                elif d.kind in ("adapter_load", "adapter_unload"):
                    emitted += self._service_adapter(d, tr)
                elif d.kind == "prefix_out":
                    emitted += self._service_prefix_out(d, tr)
                else:
                    emitted += self._service_prefix_in(d, tr)
            except Exception as e:  # the order's verdict channel
                d.fail(e)
        if keep:
            with self._mig_lock:
                # orders registered while servicing went to the emptied
                # list; the waiting ones go back ahead of them
                self._migrate_demands = keep + self._migrate_demands
        return emitted

    def _find_out_candidate(self, d):
        """Resolve an export order to its current (slot, request).  An
        unpinned order picks a victim among decoding slots past
        ``min_tokens``: lowest priority, then most work remaining, then
        lowest slot; the request handle is pinned so later ticks track
        the same stream across its eviction.  (None, req) when the
        request exists off a slot, (None, None) when unknown."""
        req = d.args.get("req")
        if req is not None:
            return self.scheduler.find(req.id), req
        rid = d.args["request_id"]
        if rid is None:
            cands = [s for s in self.scheduler.busy_slots()
                     if s.request is not None and s.decoding
                     and not s.request._adapter_id
                     and len(s.request.generated) >= d.args["min_tokens"]]
            if not cands:
                return None, None
            victim = min(cands, key=lambda s: (s.request.priority,
                                               -s.request.remaining,
                                               s.index))
            d.args["req"] = victim.request
            return victim, victim.request
        slot = self.scheduler.find(rid)
        if slot is not None:
            d.args["req"] = slot.request
            return slot, slot.request
        for r in self.queue.pending():
            if r.id == rid:
                d.args["req"] = r
                return None, r
        return None, None

    @staticmethod
    def _finish_out_done(d, req):
        """The export target ended before the export landed: a clean
        finish completes the order (nothing to migrate), a failed or
        already-migrated stream fails it with that verdict."""
        if req.error is not None:
            d.fail(req.error)
        else:
            d.complete({"completed": True, "payload": None,
                        "generated": [int(t) for t in req.generated]})

    def _service_migrate_out(self, d, tr):
        """One export attempt.  Returns (verdict, emitted): "wait"
        re-registers the order for the next tick, "done" has completed
        or failed it."""
        slot, req = self._find_out_candidate(d)
        if req is None:
            if d.args["request_id"] is not None:
                d.fail(KeyError(
                    f"no live request {d.args['request_id']} to migrate"))
                return "done", 0
            return "wait", 0  # no eligible victim yet
        if req.done():
            self._finish_out_done(d, req)
            return "done", 0
        if req._adapter_id:
            # the payload carries no adapter identity: a destination
            # would resume on its base lane, changing the model mid-stream
            d.fail(RuntimeError(
                f"request {req.id} decodes through adapter "
                f"{req.adapter!r}: KV migration does not carry adapter "
                "lanes — drain it, or let the caller fail over with "
                "prompt+emitted"))
            return "done", 0
        if slot is None or not slot.decoding \
                or len(req.generated) < d.args["min_tokens"]:
            return "wait", 0
        emitted = 0
        if self._ring:
            # freeze point: the slot's host mirrors must be the consumed
            # view before its rows are gathered, and no in-flight lane may
            # outlive its request (the preemption discipline)
            emitted += self._drain_ring(tr)
            if req.done():
                self._finish_out_done(d, req)
                return "done", emitted
            slot = self.scheduler.find(req.id)
            if slot is None or not slot.decoding:
                return "wait", emitted
        try:
            self._fault("migrate_export")
        except Exception as e:  # an injected decline: the stream stays
            d.fail(e)
            return "done", emitted
        payload = self._export_slot(slot, tr, deliver=d.args["deliver"])
        d.complete({
            "completed": False,
            "generated": list(payload["request"]["generated"]),
            "payload": payload if d.args["deliver"] == "return" else None})
        return "done", emitted

    def _export_slot(self, slot, tr, deliver):
        """Gather and tear down one decoding slot (ring drained, fault
        site consulted).  The slot's full blocks are gathered on the
        engine's stream and downloaded BEFORE the slot releases them: the
        pools are written in place, so a block released first could be
        rewritten by a newer request before the gather ran.  The
        teardown is preemption-shaped (full blocks into the trie, release,
        park) but terminal: the waiter unblocks with ``Migrated``."""
        req = slot.request
        i = slot.index
        ctx = (np.concatenate([req.prompt,
                               np.asarray(req.generated, np.int32)])
               if req.generated else req.prompt)
        kv = None
        n_full = 0
        with tr.span("migrate.export", cat="serving", req=req.id) as sp:
            if self._paged:
                # a decoding slot holds slot.pos computed rows (the last
                # emitted token's row is pending): only full blocks below
                # that travel, the destination recomputes the tail
                n_full = min(slot.pos // self._bs,
                             len(self._slot_blocks[i]))
                blocks = self._slot_blocks[i][:n_full]
                if n_full:
                    data = export_blocks(self.k_pools, self.v_pools, blocks)
                    kv = {"block_size": self._bs, "num_heads": self._nh,
                          "head_dim": self._hd,
                          "n_layers": len(self.k_pools),
                          "dtype": self._kv_dtype_str, "n_blocks": n_full}
                    if self._kv_quant:
                        kv["data"], kv["scales"] = data
                    else:
                        kv["data"] = data
                if self.prefix_cache is not None and n_full:
                    self.prefix_cache.insert(ctx, blocks)
            rng = self._rngs.pop(req.id, None)
            # a numpy Generator's state is a JSON-able dict of ints: the
            # destination rebuilds the exact host-sampling stream
            rng_state = rng.bit_generator.state if rng is not None else None
            payload = {
                "version": 1,
                "request": {
                    "source_id": req.id,
                    "prompt": [int(t) for t in req.prompt],
                    "generated": [int(t) for t in req.generated],
                    "max_new_tokens": req.max_new_tokens,
                    "eos_token_id": req.eos_token_id,
                    "temperature": req.temperature,
                    "top_k": req.top_k, "top_p": req.top_p,
                    # the EFFECTIVE seed: an unseeded sampled stream draws
                    # from its request id, and the destination mints a new
                    # id
                    "seed": (int(req.sample_seed) if req.do_sample
                             else req.seed),
                    "priority": req.priority, "tenant": req.tenant,
                    "preemptions": req.preemptions,
                    "rng_state": rng_state,
                },
                "kv": kv,
            }
            sp.args.update(blocks=n_full, tokens=len(req.generated))
        self.scheduler.release(slot)
        self._release_slot_kv(i)
        self._park_state(i)
        self._m_kv_migrated.inc(n_full)
        self._m_done.inc()  # terminal here, like a timeout
        with self._mig_lock:
            self._migration_log.append({
                "tick": self.tick_no, "dir": "out", "request": req.id,
                "blocks": n_full, "tokens": len(req.generated)})
        tr.instant("req.migrated_out", cat="request", req=req.id,
                   blocks=n_full, tokens=len(req.generated))
        req._finish(Migrated(
            f"request {req.id} migrated out after {len(req.generated)} "
            "token(s)",
            payload=payload if deliver == "error" else None,
            emitted=req.generated))
        return payload

    def _adopt_blocks(self, kv, ctx, tr):
        """Check, allocate, write and trie-adopt a payload's KV blocks
        (engine thread).  Returns the adopted block ids, or [] when the
        payload carries none or this engine cannot hold them (contiguous
        rows, no trie: the request still imports and re-prefills).
        All-or-nothing: a dtype or geometry mismatch, a scheduled
        ``migrate_import`` fault or a failed write returns the fresh
        blocks to refcount 0 and raises."""
        if kv is None or not kv.get("n_blocks"):
            return []
        if not self._paged or self.prefix_cache is None:
            return []
        n = int(kv["n_blocks"])
        # dtype first, as its own refusal: int8 codes in fp pools (or fp
        # rows in quantized ones) would be garbage
        peer_dtype = str(kv.get("dtype"))
        if peer_dtype != self._kv_dtype_str:
            raise KVDtypeMismatch(
                f"migration payload kv dtype {peer_dtype!r} does not match "
                f"this engine's {self._kv_dtype_str!r}: adopting nothing "
                "(peers must serve the same kv_dtype)")
        want = {"block_size": self._bs, "num_heads": self._nh,
                "head_dim": self._hd, "n_layers": len(self.k_pools)}
        got = {k: kv.get(k) for k in want}
        if got != want:
            raise ValueError(
                f"migration payload geometry {got} does not match this "
                f"engine ({want}): adopting nothing")
        # the adopted run lands in ONE dp shard (the emptiest)
        shard = max(range(self.dp),
                    key=lambda d: self.block_pool.free_count(d))
        short = n - self.block_pool.free_count(shard)
        if short > 0:
            evicted = self.prefix_cache.evict(short, shard=shard)
            if evicted:
                self._m_prefix_evictions.inc(len(evicted))
        blocks = self.block_pool.alloc(n, shard=shard)  # may raise
        try:
            self._fault("migrate_import")
            with tr.span("migrate.import", cat="serving", blocks=n):
                import_blocks(self.k_pools, self.v_pools, blocks,
                              kv["data"], scales=kv.get("scales"))
            # the trie takes one reference per new node, then the alloc
            # reference drops: the blocks are the cache's, as a finished
            # request's are
            self.prefix_cache.insert(ctx, blocks)
        except BaseException:
            self.block_pool.decref(blocks)  # refcount 0, freed
            raise
        self.block_pool.decref(blocks)
        return blocks

    def _service_migrate_in(self, d, tr):
        """Adopt one migrated stream: blocks into pool and trie, then an
        equivalent request through the queue, resumed as a preempted
        request resumes.  Returns 0 (no tokens emitted)."""
        if self._draining:
            raise QueueFull("engine is draining: not accepting migrations")
        payload = d.args["payload"]
        rq = payload["request"]
        generated = [int(t) for t in rq.get("generated") or []]
        ctx = [int(t) for t in rq["prompt"]] + generated
        blocks = self._adopt_blocks(payload.get("kv"), ctx, tr)
        req = Request(
            rq["prompt"], rq["max_new_tokens"],
            eos_token_id=rq.get("eos_token_id"),
            temperature=rq.get("temperature", 1.0),
            top_k=rq.get("top_k", 0), top_p=rq.get("top_p", 1.0),
            seed=rq.get("seed"), priority=rq.get("priority", 0),
            tenant=rq.get("tenant"))
        req.generated = generated
        req._ctx = np.asarray(ctx, np.int32)
        req.preemptions = int(rq.get("preemptions") or 0) + 1
        #   counts the handoff; admission emits req.resumed for it
        state = rq.get("rng_state")
        if state is not None and self.sample_mode == "host":
            g = np.random.default_rng(req.sample_seed)
            g.bit_generator.state = state
            self._rngs[req.id] = g
        self.queue.put(req)
        self._m_reqs.inc()
        with self._mig_lock:
            self._migration_log.append({
                "tick": self.tick_no, "dir": "in", "request": req.id,
                "source": rq.get("source_id"), "blocks": len(blocks),
                "tokens": len(generated)})
        tr.instant("req.migrated_in", cat="request", req=req.id,
                   source=rq.get("source_id"), blocks=len(blocks),
                   tokens=len(generated))
        d.complete({"request": req, "blocks": len(blocks)})
        return 0

    def _service_prefix_out(self, d, tr):
        """Prefix-warming export: gather the trie's longest cached prefix
        of the order's tokens, then the host tier's consecutive
        continuation blocks.  Completes with None when nothing is cached.
        Returns 0."""
        tokens = d.args["tokens"]
        if not self._paged or self.prefix_cache is None:
            d.complete(None)
            return 0
        try:
            self._fault("migrate_export")
        except Exception as e:  # an injected decline
            d.fail(e)
            return 0
        blocks, m = self.prefix_cache.match(tokens)
        host_parts = []
        if self.host_store is not None:
            i = m // self._bs
            limit = (len(tokens) - 1) // self._bs
            while i < limit:
                ent = self.host_store.get(
                    prefix_key(tokens, (i + 1) * self._bs))
                if ent is None:
                    break
                host_parts.append(ent)
                i += 1
        if not blocks and not host_parts:
            d.complete(None)
            return 0
        data = scales = None
        if blocks:
            try:
                with tr.span("migrate.export", cat="serving",
                             blocks=len(blocks), prefix=True):
                    data = export_blocks(self.k_pools, self.v_pools, blocks)
            finally:
                self.block_pool.decref(blocks)  # drop match's references
            if self._kv_quant:
                data, scales = data
        if host_parts:
            hd = np.stack([p[0] for p in host_parts], axis=2)
            hs = (np.stack([p[1] for p in host_parts], axis=2)
                  if host_parts[0][1] is not None else None)
            data = hd if data is None else np.concatenate((data, hd), axis=2)
            if hs is not None:
                scales = (hs if scales is None
                          else np.concatenate((scales, hs), axis=2))
        n_blocks = len(blocks) + len(host_parts)
        m_total = m + len(host_parts) * self._bs
        tier = ("mixed" if blocks and host_parts
                else "host" if host_parts else "device")
        kv = {"block_size": self._bs, "num_heads": self._nh,
              "head_dim": self._hd, "n_layers": len(self.k_pools),
              "dtype": self._kv_dtype_str, "n_blocks": n_blocks}
        if self._kv_quant:
            kv["data"], kv["scales"] = data, scales
        else:
            kv["data"] = data
        payload = {"version": 1, "request": None,
                   "prefix": [int(t) for t in tokens[:m_total]],
                   "tier": tier, "kv": kv}
        self._m_kv_migrated.inc(n_blocks)
        with self._mig_lock:
            self._migration_log.append({
                "tick": self.tick_no, "dir": "prefix_out",
                "blocks": n_blocks, "tokens": m_total, "tier": tier})
        d.complete(payload)
        return 0

    def _service_prefix_in(self, d, tr):
        """Prefix-warming import: adopt a peer trie's blocks (the prefix
        covers exactly n_blocks * block_size tokens).  Returns 0."""
        payload = d.args["payload"]
        tokens = [int(t) for t in payload.get("prefix") or []]
        blocks = self._adopt_blocks(payload.get("kv"), tokens, tr)
        if blocks:
            with self._mig_lock:
                self._migration_log.append({
                    "tick": self.tick_no, "dir": "prefix_in",
                    "blocks": len(blocks),
                    "tokens": len(blocks) * self._bs})
            tr.instant("prefix.warmed", cat="serving", blocks=len(blocks))
        d.complete({"blocks": len(blocks),
                    "tokens": len(blocks) * self._bs if blocks else 0})
        return 0

    def streams_active(self):
        """Live ``TokenStream`` sinks across slot-bound and queued
        requests."""
        n = 0
        for s in self.scheduler.busy_slots():
            if s.request is not None:
                n += len(s.request._sinks)
        for r in self.queue.pending():
            n += len(r._sinks)
        return n

    def debug_requests(self):
        """Slot and request states, the queue, and the recent preemption
        and migration logs as plain JSON-able dicts: the
        ``/debug/requests`` payload and the flight recorder's context.
        Readable from any thread while the engine ticks: host state only
        (one locked scheduler pass; the request fields it reads are
        single-writer ints), no device tensor is read."""
        now = time.monotonic()
        # the newest in-flight tick each slot's device cursor belongs to
        # (None: the consumed host view is current)
        ring = list(self._ring)
        cursor_tick = {}
        for inf in ring:
            for s in inf.slots:
                cursor_tick[s.index] = inf.tick
        slots = []
        streams_active = 0
        for view in self.scheduler.debug_view():
            view["cursor_tick"] = cursor_tick.get(view["slot"])
            req = view.pop("request")
            if req is not None:
                view["request_id"] = req.id
                view["prompt_len"] = int(len(req.prompt))
                view["generated"] = len(req.generated)
                view["max_new_tokens"] = req.max_new_tokens
                view["do_sample"] = bool(req.do_sample)
                view["first_token"] = req.first_token_at is not None
                view["age_ms"] = round((now - req.submitted_at) * 1e3, 3)
                view["preemptions"] = req.preemptions
                view["adapter"] = req.adapter
                view["streams"] = len(req._sinks)
                view["restored_from_host"] = getattr(
                    req, "_host_restored", 0)
                streams_active += len(req._sinks)
            if self._paged:
                view["kv_blocks"] = len(self._slot_blocks[view["slot"]])
            slots.append(view)
        queued = []
        for r in self.queue.pending():
            streams_active += len(r._sinks)
            queued.append({
                "request_id": r.id, "prompt_len": int(len(r.prompt)),
                "max_new_tokens": r.max_new_tokens,
                "priority": r.priority, "tenant": r.tenant,
                "preemptions": r.preemptions, "adapter": r.adapter,
                "queued_ms": round((now - r.submitted_at) * 1e3, 3),
                "deadline_in_s": (None if r.deadline is None
                                  else round(r.deadline - now, 3)),
            })
        return {
            "tick": self.tick_no, "slots": slots, "queue": queued,
            "streams_active": streams_active,
            "in_flight_ticks": [inf.tick for inf in ring],
            "preemptions": self._preempt_history()[-16:],
            "migrations": self._migration_history()[-16:],
            "migrations_pending": self._migrate_pending(),
            "offload": (None if self.host_store is None
                        else self.host_store.stats()),
            "engine": {
                "num_slots": self.num_slots,
                "max_seq_len": self.max_seq_len,
                "layout": self._layout(),
                "prefill_chunk": self._chunk,
                "spec_k": self._spec_k,
                "sample_mode": self.sample_mode,
                "attn_impl": self.attn_impl,
                "max_context_len": self._max_context_len,
                "mesh_shape": self.mesh_axes,
                "mp": self.mp,
                "dp": self.dp,
                "kv_block_bytes_per_shard": self._kv_block_bytes_per_shard,
                "weight_dtype": self._weight_dtype_str,
                "kv_dtype": self._kv_dtype_str,
                "kv_block_bytes": self._kv_code_bytes_per_shard,
                "kv_scale_bytes": self._kv_scale_bytes_per_shard,
                "async_depth": self.async_depth,
                "tracing": bool(self.tracer.enabled),
                "preemption": self._preemption,
                "draining": self._draining,
                "watchdog_s": self.watchdog_s,
                "adapters_loaded": (0 if self.adapters is None
                                    else len(self.adapters)),
                "adapters": (None if self.adapters is None
                             else self.adapters.describe()),
            }}

    def _record_flight(self, exc):
        """Flight recorder: snapshot the trace ring, the request states
        and the in-flight ring at a step failure, BEFORE recovery tears
        the slots down, into ``last_flight`` (and ``flight_dir`` when
        set).  Host state only, so the watchdog thread can dump a tick
        whose kernel is wedged; never masks the real failure."""
        try:
            trace = self.chrome_trace()
            trace["metadata"] = {
                "flight-recorder": {
                    "error": repr(exc),
                    "tick": self.tick_no,
                    "dumped_at_unix": round(time.time(), 3),
                    "requests": self.debug_requests(),
                    "preemptions": self._preempt_history(),
                    # the pipeline at the failure: the host mirrors (the
                    # buffer admissions and evictions dirty) and, per
                    # unconsumed tick, the cursors its dispatch chained
                    # from
                    "async": {
                        "async_depth": self.async_depth,
                        "state_dirty": bool(self._state_dirty),
                        "in_flight": [inf.meta() for inf in list(self._ring)],
                        "next_buffer": {
                            "pos": self._pos.tolist(),
                            "cur_tok": self._cur_tok[:, 0].tolist(),
                            "rem": self._rem.tolist(),
                            "eos": self._eos.tolist(),
                            "ctr": self._sctr.tolist(),
                        },
                    },
                }}
            self.last_flight = trace
            if self._flight_dir:
                os.makedirs(self._flight_dir, exist_ok=True)
                path = os.path.join(
                    self._flight_dir,
                    f"flight_tick{self.tick_no}_{os.getpid()}_"
                    f"{int(time.time() * 1e3)}.json")
                with open(path, "w") as f:
                    json.dump(trace, f)
                self.last_flight_path = path
        except Exception:
            pass

    # -- the host-RAM offload tier (serving/offload.py) ---------------------
    def _to_host(self, t):
        """Queue ``t``'s download: into pinned memory with a
        ``non_blocking`` copy on a card (read after the event recorded
        behind it), or ``t`` itself on the CPU."""
        if t is None or t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    def _offload_demote_hook(self, tokens, block):
        """``PrefixCache`` evict hook, called before the block's reference
        drops: LAUNCH the gather of the dying block's rows (every layer,
        K and V; codes and scales when int8) into a fresh tensor now, on
        the engine's stream, and queue its download behind an event.  The
        pools are written in place, so a gather launched at the next tick
        would read whatever a newer request wrote into the recycled
        block.  ``_service_offload`` parks it at the next tick boundary.
        A prefix already stored or pending is skipped (content-addressed
        dedup).  Nothing here synchronizes."""
        try:
            self._fault("offload_demote")
        except Exception:
            return  # a scheduled demote failure: free without spilling
        key = prefix_key(tokens)
        if key in self.host_store or key in self._offload_pending_keys:
            return
        b = int(block)
        pools = [p for kp, vp in zip(self.k_pools, self.v_pools)
                 for p in (kp, vp)]
        if self._kv_quant:
            data = torch.stack([p.codes[b] for p in pools])
            scales = torch.stack([p.scale[b] for p in pools])
        else:
            data = torch.stack([p[b] for p in pools])
            scales = None
        data, scales = self._to_host(data), self._to_host(scales)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._offload_pending_keys.add(key)
        self._offload_pending.append((key, data, scales, event))

    def _service_offload(self, tr):
        """Tick-boundary demote drain: wait on each pending download's
        event (it has had a dispatch of device time to finish) and park
        a numpy copy of the block in the host store."""
        if self.host_store is None or not self._offload_pending:
            return
        pending = self._offload_pending
        self._offload_pending = []
        self._offload_pending_keys = set()
        store = self.host_store
        L, H = len(self.k_pools), self._nh
        for key, data, scales, event in pending:
            with tr.span("offload.demote", cat="serving", key=key) as sp:
                try:
                    if event is not None:
                        event.synchronize()
                    d = data.numpy().reshape(L, 2, *data.shape[1:]).copy()
                    sc = (None if scales is None
                          else scales.numpy().reshape(L, 2, H).copy())
                    ok = store.put(key, d, sc)
                except Exception:
                    ok = False  # a failed demote must not fail the tick
                if ok:
                    self._m_offload_demotes.inc()
                sp.args.update(stored=bool(ok))
        self._m_kv_host_blocks.set(len(store))
        self._m_kv_host_bytes.set(store.bytes_used)

    def _flush_offload(self):
        """Land pending demotes at idle boundaries (``run_until_idle``'s
        exit, the loop's idle branch, ``_drain``): an eviction in the
        last tick before idle must not wait for the next burst."""
        try:
            self._service_offload(self.tracer)
        except Exception:
            self._offload_pending = []
            self._offload_pending_keys = set()

    def _promote_blocks(self, req, tokens, ctx, m, fresh):
        """Host-tier leg of paged admission: after the device trie matched
        ``m`` tokens, probe the store for the consecutive continuation
        blocks and restore them into the leading ``fresh`` blocks (a
        pinned upload through ``import_blocks``), seed the device trie
        with them, and count them.  Returns the promoted block count; 0
        on a miss or an import failure, and the fresh blocks stay plain
        prefill targets."""
        store = self.host_store
        if not fresh:
            return 0
        bs = self._bs
        first = m // bs
        limit = (len(tokens) - 1) // bs  # leave >= 1 token to prefill
        keys = []
        for i in range(first, min(limit, first + len(fresh))):
            key = prefix_key(tokens, (i + 1) * bs)
            if key not in store:  # a presence probe: no LRU touch
                break
            keys.append(key)
        if not keys:
            return 0
        try:
            self._fault("offload_promote")
        except Exception:
            return 0  # a scheduled promote failure: recompute instead;
            #   the store entries stay
        ents = []
        for key in keys:
            ent = store.get(key)
            if ent is None:
                break
            ents.append(ent)
        n = len(ents)
        if not n:
            return 0
        blocks = fresh[:n]
        with self.tracer.span("offload.promote", cat="serving", req=req.id,
                              blocks=n) as sp:
            data = np.stack([e[0] for e in ents], axis=2)
            scales = (np.stack([e[1] for e in ents], axis=2)
                      if ents[0][1] is not None else None)
            try:
                import_blocks(self.k_pools, self.v_pools, blocks, data,
                              scales)
            except Exception:
                return 0  # checked before any write: pools untouched
            self.prefix_cache.insert(tokens[:(first + n) * bs],
                                     ctx + blocks)
            sp.args.update(tokens=n * bs)
        self._m_offload_promotes.inc(n)
        self._m_offload_hit_tokens.inc(n * bs)
        req._host_restored = getattr(req, "_host_restored", 0) + n * bs
        self.tracer.instant("req.host_restored", cat="request", req=req.id,
                            blocks=n, tokens=n * bs)
        self._m_kv_host_blocks.set(len(store))
        self._m_kv_host_bytes.set(store.bytes_used)
        return n

    # -- the tick -------------------------------------------------------------
    def step(self):
        """One engine tick; returns the tokens emitted.  A tick that
        raises fails every bound request loudly (their waiters unblock),
        drops the ring, rebuilds the pools, and re-raises, so the engine
        works again afterwards.  The flight recorder snapshots the
        failure first (``last_flight``), before the evictions."""
        if self.watchdog_s is not None and self._watchdog is None:
            self._watchdog = TickWatchdog(self, self.watchdog_s).start()
        try:
            return self._step_inner()
        except Exception as e:
            self._record_flight(e)
            for slot in self.scheduler.busy_slots():
                req = self.scheduler.evict(slot, RuntimeError(
                    f"engine step failed: {e!r}"))
                if req is not None:
                    self._rngs.pop(req.id, None)
                    self._m_done.inc()
                    self.tracer.instant("req.evicted", cat="request",
                                        req=req.id, reason="step_failure")
            self._reset_pools()
            self._last_decode_end = None
            self._m_occ.set(0)
            raise

    def _step_inner(self):
        self.ticks += 1
        tr = self.tracer
        # watchdog heartbeat, stamped for the whole tick: a stale stamp is
        # how the watchdog sees a wedged tick
        self._watchdog_fired = False
        self._tick_started_at = time.monotonic()
        try:
            self._fault("host_slow")
            with tr.span("tick", cat="tick", tick=self.ticks) as tick_sp:
                if self.async_depth > 1:
                    emitted = self._tick_async(tr, tick_sp)
                else:
                    emitted = self._tick(tr, tick_sp)
        finally:
            self._tick_started_at = None
        if emitted:
            now = time.monotonic()
            with self._ovl_lock:
                self._rate_win.append((now, emitted))
            rate = self.drain_rate()
            if rate is not None:
                self._m_drain_tps.set(round(rate, 1))
        return emitted

    def _admit(self, tr, in_flight=False):
        """The admission phase of both tick shapes: queue deadlines and
        admission (through the paged gate on block pools; in a
        ``host.overlap`` span when a tick is in flight), then the
        preemption round (outside it: it may have to drain the ring),
        then each admitted slot's prefill — whole at admission
        (``prefill``, emitting its first token) or bound PREFILLING for
        chunks — and the XLA chunk loop.  Returns the tokens emitted."""
        now = time.monotonic()
        self._gate_declined = False
        with (tr.span("host.overlap", phase="plan") if in_flight
              else nullcontext()):
            with tr.span("admit") as admit_sp:
                timed_out = self.queue.expire(now)
                admitted = []
                if not self._draining:
                    admitted, t2 = self.scheduler.admit(now,
                                                        gate=self._gate)
                    timed_out = timed_out + t2
                admit_sp.args.update(admitted=len(admitted),
                                     timed_out=len(timed_out))
        if in_flight:
            self._overlap_acc += time.monotonic() - now
        p_admitted, p_timed, emitted = self._preempt_round(now, tr)
        for slot in self._post_admit(admitted + p_admitted,
                                     timed_out + p_timed, tr):
            if self._chunk is not None:
                self._begin_chunked(slot)
                continue
            req = slot.request  # read first: an eos first token evicts
            with tr.span("prefill", req=req.id, prompt=int(len(req.prompt))):
                self._prefill(slot)
            emitted += 1
        if self._chunk is not None and not self._ragged:
            # XLA chunks are dispatches of their own, each dirtying the
            # step state (ragged chunks ride as lanes of the tick's
            # window instead)
            prefilling = self.scheduler.snapshot()[2]
            if prefilling:
                emitted += self._prefill_chunked(prefilling)
        return emitted

    def _finish_tick(self, tick_sp, active, occ, emitted):
        self._m_queue.set(self.queue.depth())
        self._m_occ.set(occ)
        tick_sp.args.update(batch=len(active), emitted=emitted,
                            occupancy=occ, queue=self.queue.depth())
        if self._paged:
            self._m_kv_blocks.set(self.block_pool.in_use())
            tick_sp.args["kv_blocks_in_use"] = self.block_pool.in_use()

    def _dispatch(self, active, plan, tr):
        """Dispatch this tick without consuming it: the ragged window, or
        the XLA fused verify or decode tick."""
        if self._ragged:
            return self._dispatch_ragged(active, plan, tr)
        if self._spec_k is not None:
            return self._dispatch_spec(active, tr)
        return self._dispatch_decode(active, tr)

    def _tick(self, tr, tick_sp):
        """One synchronous tick (``async_depth=1``): admit and prefill ->
        one dispatch -> consume it (host mode: the window, its logits
        home, host picks).  Adapter orders and the demote drain come
        first, at the tick boundary."""
        emitted = self._service_migrations(tr)
        self._service_offload(tr)
        emitted += self._admit(tr)
        occ, active, prefilling = self.scheduler.snapshot()
        plan = (self._plan_ragged_chunks(prefilling)
                if self._ragged and self._chunk is not None else [])
        if active or plan:
            self._note_dispatch_gap(len(active))
            n_before = self._evicted_in_tick
            if self.sample_mode == "host":
                emitted += self._decode_tick(active, tr)
            else:
                emitted += self._consume(self._dispatch(active, plan, tr),
                                         tr)
            occ -= self._evicted_in_tick - n_before
            self._last_decode_end = time.monotonic()
        else:
            self._m_decode_batch.set(0)
            self._last_decode_end = None
        self._finish_tick(tick_sp, active, occ, emitted)
        return emitted

    def _tick_async(self, tr, tick_sp):
        """One PIPELINED tick (``async_depth`` > 1): admit and plan while
        the previous tick computes, dispatch tick N+1, then consume tick
        N.  Admission, eviction, preemption and XLA chunks dirty the host
        mirrors; the ring drains before they are uploaded, so greedy
        streams equal the synchronous tick's."""
        self._overlap_acc = 0.0
        # tick-boundary service first: adapter orders (they drain the
        # ring), then last tick's demote downloads
        emitted = self._service_migrations(tr)
        self._service_offload(tr)
        emitted += self._admit(tr, in_flight=bool(self._ring))
        # spec barrier: a draft reads the tokens the previous window
        # accepted, so speculative ticks consume before they dispatch
        if self._spec_k is not None and self._ring:
            emitted += self._drain_ring(tr)
        # dirty barrier: consumed evictions must leave the dispatch set,
        # and _push_state runs only over an empty ring
        if self._ring and (self._state_dirty or self._dev_state is None):
            emitted += self._drain_ring(tr)
        occ, active, prefilling = self.scheduler.snapshot()
        if active and self._ring and not (self._ragged and prefilling) \
                and all(self._rem[s.index] <= len(self._ring)
                        for s in active):
            # bursty-tail cutoff: every active slot exhausts its budget
            # within the ticks already in flight, so one more dispatch
            # would compute only frozen lanes.  Pending ragged chunk
            # lanes veto it: their dispatch still does real work
            emitted += self._drain_ring(tr)
            occ, active, prefilling = self.scheduler.snapshot()
        n_before = self._evicted_in_tick
        plan = (self._plan_ragged_chunks(prefilling)
                if self._ragged and self._chunk is not None else [])
        if active or plan:
            self._note_dispatch_gap(len(active))
            self._ring.append(self._dispatch(active, plan, tr))
            self._last_decode_end = time.monotonic()
        else:
            self._m_decode_batch.set(0)
            self._last_decode_end = None
        # consume tick N while N+1 computes; with nothing dispatched,
        # drain the tail
        keep = (self.async_depth - 1) if (active or plan) else 0
        while len(self._ring) > keep:
            emitted += self._consume(self._ring.pop(0), tr)
        occ -= self._evicted_in_tick - n_before
        if self._ring and occ == 0:
            # every slot freed while the newest dispatch was in flight:
            # its lanes are all frozen; an idle engine holds no ticks
            emitted += self._drain_ring(tr)
        self._m_overlap.observe(self._overlap_acc * 1e3)
        tick_sp.args.update(overlap_ms=round(self._overlap_acc * 1e3, 3),
                            in_flight=len(self._ring))
        self._finish_tick(tick_sp, active, occ, emitted)
        return emitted

    def run_until_idle(self, max_steps=100000):
        """Drive ticks until queue and slots are empty; returns the total
        tokens emitted."""
        total = 0
        for _ in range(max_steps):
            if self.scheduler.idle() and not self._migrate_actionable():
                self._flush_offload()  # the last tick's demotes land
                return total
            total += self.step()
        raise RuntimeError(
            f"engine still busy after {max_steps} steps "
            f"(occupancy={self.scheduler.occupancy()}, "
            f"queue={self.queue.depth()})")

    # -- background loop ----------------------------------------------------
    def start(self):
        """Run the tick loop on a daemon thread; an idle loop waits for a
        submit instead of spinning.  Safe after a timed-out ``stop()``:
        the new loop joins the old one before its first tick."""
        prev = self._thread
        if prev is not None and prev.is_alive() \
                and not self._stop.is_set():
            return prev  # loop already running
        if prev is not None and not prev.is_alive():
            prev = None
        self._drain_on_exit = None
        self._draining = False
        # each loop carries its own stop event: a stop-pending loop keeps
        # honoring the one it was born with
        stop_evt = self._stop = threading.Event()

        def loop():
            if prev is not None:
                prev.join()  # never two loops in step()
            if self.device.type == "cuda" and self.device.index is not None:
                # the current device is per thread: launch where the
                # engine's pools live
                torch.cuda.set_device(self.device.index)
            try:
                while not stop_evt.is_set():
                    if self.scheduler.idle() \
                            and not self._migrate_actionable():
                        self._m_rate.refresh()
                        self._flush_offload()  # going idle: land demotes
                        # clear, then check again: a submit between the
                        # idle check and the clear is caught here, one
                        # after it sets the event again
                        self._wake.clear()
                        if self.scheduler.idle() \
                                and not self._migrate_actionable() \
                                and not stop_evt.is_set():
                            self._wake.wait(timeout=0.5)
                        continue
                    try:
                        self.step()  # step() already recovered state
                    except Exception:  # keep the loop alive
                        time.sleep(0.05)
            finally:
                if self._drain_on_exit is stop_evt:
                    self._drain_on_exit = None
                    self._drain()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="paddle_tpu_torch-engine")
        self._thread.start()
        return self._thread

    def _drain(self):
        """Fail every queued and in-flight request and adapter order
        (shutdown); pending demotes land first (the host tier outlives
        the loop)."""
        self._flush_offload()
        # unconsumed ticks die with their requests; every eviction parks
        # its lanes, so a later start() uploads clean cursors
        self._ring = []
        self._staging_free = []
        with self._mig_lock:
            demands, self._migrate_demands = self._migrate_demands, []
        for d in demands:
            d.fail(RuntimeError("engine stopped"))
        for req in self.queue.drain():
            self._rngs.pop(req.id, None)
            self._m_done.inc()
        for slot in self.scheduler.busy_slots():
            req = self.scheduler.evict(slot, RuntimeError("engine stopped"))
            self._release_slot_kv(slot.index)
            self._park_state(slot.index)
            if req is not None:
                self._m_done.inc()
                self.tracer.instant("req.evicted", cat="request",
                                    req=req.id, reason="shutdown")
        self._m_queue.set(0)
        self._m_occ.set(0)

    def stop(self, drain=True, join_timeout=30.0, drain_timeout=None):
        """Stop the background loop.  ``drain=True``: submission closes
        (``submit`` sheds with ``QueueFull``), no queued request is
        admitted, and the loop keeps ticking until the in-flight streams
        finish or ``drain_timeout`` (default ``join_timeout``) passes;
        whatever is left, and every queued request, is then failed.
        ``drain=False`` halts the loop and fails nothing (requests wait
        for a later ``start()``)."""
        evt = self._stop
        t = self._thread
        if drain and t is not None and t.is_alive() and not evt.is_set():
            self._draining = True
            self._wake.set()
            limit = join_timeout if drain_timeout is None \
                else drain_timeout
            deadline = time.monotonic() + max(float(limit), 0.0)
            while time.monotonic() < deadline \
                    and self.scheduler.busy_slots():
                time.sleep(0.002)
        if drain:
            # before set + join: a loop that exits inside the join
            # window drains in its finally
            self._drain_on_exit = evt
        evt.set()
        self._wake.set()
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None  # a later step() re-arms it
        if t is not None:
            t.join(timeout=join_timeout)
            if t.is_alive():
                # mid-tick: the loop drains on exit instead; the handle
                # stays so a later start() joins it first
                self._draining = False
                return
            self._thread = None
        if drain:
            self._drain_on_exit = None
            self._drain()
        self._draining = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
