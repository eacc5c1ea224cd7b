"""Continuous-batching inference engine over a fixed slot pool — the
PyTorch counterpart of ``paddle_tpu/serving/engine.py`` on its
``attn_impl="ragged"`` path.

Each tick admits queued requests into free slots (the paged admission
gate adopts cached prompt prefixes and reserves every block a request
could need), then runs ONE ragged window dispatch
(``GPTModel._fused_ragged_tick_slots``): decoding slots ride as
one-token lanes, budgeted prefill chunks as lanes of up to
``prefill_chunk`` tokens, and sampling plus the eos / max_new_tokens stop
condition run in the dispatch's epilogue on the device.  The tick then
downloads the per-slot picks and counts and emits them.

The engine serves at ``async_depth=1`` (each tick is dispatched and
consumed before the next), on one device or over an ``(mp, dp)`` serving
mesh (``mesh=``: the tensor-parallel model's heads, FFN and vocab split
over mp, the batch slots and the KV block pool over dp; one controller
drives every rank, ``serving/sharded.py``), with fp or int8 KV pools
(``kv_dtype="int8"``: ``QuantKV`` codes plus per-block per-head scales,
``serving/quant.py``), fp or weight-only int8 block Linears
(``weight_dtype="int8"``), a pool sized by blocks or by a byte budget
(``kv_budget_mb``), and either ragged kernel body (``attn_impl="ragged"``
streams to the causal horizon, ``"ragged_gather"`` gathers the whole
row).  The JAX engine's other knobs — speculative decoding, LoRA
adapters, the host-RAM offload tier, the pipelined loop, the XLA
attention paths, monolithic prefill — raise ``NotImplementedError``
naming their ``ROADMAP.md`` item.  Tracing,
faults and migration wait too; plain integer counters stand in for the
metrics (``prefix_hits``, ``ticks``, ``kv_blocks_walked``, ...).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import require_on
from ..distributed.mesh import ServingMesh, serving_mesh
from .kvcache import BlockPool, PrefixCache, per_shard_block_bytes
from .quant import QuantKV, relayout_weights_int8
from .request import MAX_SEED, Request, RequestQueue
from .scheduler import Scheduler
from .sharded import ShardedServingModel

_NOT_PORTED = {
    "spec_k": "Queue A 6 (speculative decode)",
    "adapters": "Queue A 8 (LoRA adapters)",
    "kv_host_mb": "Queue A 8 (host-RAM offload)",
}


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


class _InflightTick:
    """One dispatched ragged tick: the device tensors its consume
    downloads, and the slot -> request bindings and per-slot lane modes
    as of dispatch."""

    __slots__ = ("tick", "slots", "reqs", "arrays", "modes")

    def __init__(self, tick, slots, arrays, modes):
        self.tick = tick
        self.slots = slots
        self.reqs = [s.request for s in slots]
        self.arrays = arrays
        self.modes = modes


class Engine:
    """In-process continuous-batching engine for a ``GPTModel``.

    Parameters
    ----------
    model : ``paddle_tpu_torch`` GPTModel whose parameters already lie on
        ``device`` (the engine never moves them).
    num_slots : fixed batch-slot pool size (B of every dispatch).
    max_seq_len : per-slot KV length L (prompt + generated must fit);
        defaults to the model's position table.
    kv_block_size : paged KV block size (required; must divide
        max_seq_len).
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
    prefill_chunk : prompt tokens a slot prefills per tick (required; must
        divide max_seq_len); also the dispatch's window width W.
    tick_token_budget : prompt tokens one tick may spend on prefill
        chunks across slots (default: one chunk; must be >= it).
    attn_impl : ``"ragged"`` — the streaming ragged kernel (B1, or B2
        with int8 pools); ``"ragged_gather"`` — the gather body (B3),
        which walks every table entry: the A/B baseline.
    sample_mode : ``"device"`` — sampling in the dispatch's epilogue.
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
    """

    def __init__(self, model, num_slots=4, max_seq_len=None,
                 kv_block_size=None, kv_blocks=None,
                 prefix_cache=True, prefill_chunk=None,
                 tick_token_budget=None, attn_impl="ragged",
                 sample_mode="device", async_depth=None, device=None,
                 spec_k=None, mesh=None, kv_dtype=None,
                 weight_dtype=None, adapters=None, kv_host_mb=None,
                 kv_budget_mb=None):
        knobs = dict(spec_k=spec_k, mesh=mesh, adapters=adapters,
                     kv_host_mb=kv_host_mb)
        for name, item in _NOT_PORTED.items():
            if knobs[name] is not None:
                raise NotImplementedError(
                    f"Engine({name}=...) is not ported yet: ROADMAP.md "
                    f"{item}")
        if async_depth not in (None, 1):
            raise NotImplementedError(
                f"async_depth={async_depth} is not ported yet: ROADMAP.md "
                "Queue A 5 (the pipelined engine loop); this slice runs "
                "async_depth=1")
        if attn_impl == "xla":
            raise NotImplementedError(
                "attn_impl='xla' is not ported yet: ROADMAP.md Queue A 5 "
                "(the XLA paged paths)")
        if attn_impl not in ("ragged", "ragged_gather"):
            raise ValueError(f"attn_impl must be 'ragged' or "
                             f"'ragged_gather', got {attn_impl!r}")
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
        if self._kv_quant and kv_block_size is None:
            raise ValueError(
                "kv_dtype='int8' requires the paged KV layout "
                "(kv_block_size=...): quantization is per-block — the "
                "contiguous pools have no block granularity to hang a "
                "scale on")
        if self._kv_quant and sample_mode != "device":
            raise ValueError(
                "kv_dtype='int8' requires sample_mode='device': only the "
                "fused device-sampling dispatch threads QuantKV pools")
        if sample_mode != "device":
            raise ValueError(
                f"sample_mode must be 'device', got {sample_mode!r}: "
                "sampling and the stop condition run in the ragged "
                "dispatch's epilogue")
        if prefill_chunk is None:
            raise NotImplementedError(
                "prefill_chunk=None (monolithic prefill) is not ported "
                "yet: ROADMAP.md Queue A 5; pass prefill_chunk=C")
        if kv_block_size is None:
            raise ValueError("kv_block_size is required: the ragged "
                             "kernel reads K/V through block tables")
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
        if self._weight_quant:
            # before the dtype probe and the pools: the codes and scales
            # become buffers of the model's block Linears
            relayout_weights_int8(model)
        model.eval()
        self.model = model
        # what runs the tick: the model itself, or its per-rank shards
        self._runner = model
        if self.mesh is not None:
            self._runner = ShardedServingModel(
                model if is_tp else model.to_tensor_parallel(), self.mesh)
        max_position = model.embeddings.position_embeddings.weight.shape[0]
        self.max_seq_len = int(max_seq_len or max_position)
        if self.max_seq_len > max_position:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} exceeds the model's "
                f"position table ({max_position})")
        self.num_slots = int(num_slots)
        self.vocab_size = int(model.embeddings.word_embeddings.weight
                              .shape[0])
        self.queue = RequestQueue()
        self.scheduler = Scheduler(self.num_slots, self.queue)
        self._nh, self._hd = attn0.num_heads, attn0.head_dim
        # compute_dtype first: a weight-only int8 projection's .weight
        # would materialize the dequantized matrix
        self._kv_dtype = attn0.qkv_weight.dtype if is_tp else (
            getattr(attn0.qkv_proj, "compute_dtype", None)
            or attn0.qkv_proj.weight.dtype)
        self.attn_impl = attn_impl
        self._variant = "gather" if attn_impl == "ragged_gather" \
            else "stream"

        c = int(prefill_chunk)
        if c < 1 or self.max_seq_len % c:
            raise ValueError(
                f"prefill_chunk must be >= 1 and divide max_seq_len "
                f"({self.max_seq_len}), got {c}")
        b = int(tick_token_budget) if tick_token_budget is not None else c
        if b < c:
            raise ValueError(
                f"tick_token_budget ({b}) must cover at least one "
                f"prefill_chunk ({c}), or no tick could ever make "
                "prefill progress")
        self._chunk = c
        self._tick_budget = b
        bsz = int(kv_block_size)
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
        # the ragged dispatch's window: wide enough for a prefill chunk;
        # each slot's real width is data
        self._wmax = self._chunk

        # plain counters in place of the JAX engine's metrics registry
        self.ticks = 0
        self.ragged_dispatches = 0
        self.tokens_generated = 0
        self.requests_completed = 0
        self.prefill_tokens = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.kv_blocks_walked = 0   # summed over dispatches and slots
        self._reset_pools()

    # ------------------------------------------------------------------
    def _reset_pools(self):
        """(Re)allocate the per-layer K/V pools, the block pool, prefix
        cache and block tables, and the per-slot step state — also the
        step-failure recovery path: cached prefixes die with the rows
        they described."""
        # +dp: each dp shard's pool range leads with a reserved scratch
        # block that its parked slots and masked lanes write through (one
        # block, row 0, without a mesh)
        nblocks = self._kv_managed + self.dp
        self.block_pool = BlockPool(nblocks, self._bs, reserved_blocks=1,
                                    shards=self.dp)
        self.prefix_cache = (PrefixCache(self.block_pool)
                             if self._prefix_enabled else None)
        self._slot_scratch = np.asarray(
            [self.block_pool.scratch_row(self._slot_shard(i))
             for i in range(self.num_slots)], np.int32)
        self._block_tables = np.repeat(
            self._slot_scratch[:, None], self._bps, axis=1).copy()
        self._slot_blocks = [[] for _ in range(self.num_slots)]
        rows = nblocks // self.dp
        heads = self._nh // self.mp

        def pool(dev):
            shape = (rows, self._bs, heads, self._hd)
            if self._kv_quant:
                return QuantKV(
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros((rows, heads), dtype=torch.float32,
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
        self._dev_state = None
        self._state_dirty = True

    def _slot_shard(self, i):
        """The dp shard that owns batch slot ``i``: slots divide into
        ``dp`` contiguous ranges of ``num_slots/dp`` (always 0 without a
        dp mesh)."""
        return int(i) // (self.num_slots // self.dp)

    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens=16, eos_token_id=None,
               temperature=1.0, top_k=0, top_p=1.0, seed=None):
        """Queue one generation request; returns its Request handle
        (block on ``request.result()``).  Greedy unless a sampling
        parameter is set; ``seed`` makes a sampled stream repeat."""
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
        req = Request(prompt, max_new_tokens, eos_token_id=eos_token_id,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      seed=seed)
        if int(req.prompt.max()) >= self.vocab_size \
                or int(req.prompt.min()) < 0:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.vocab_size})")
        total = len(req.prompt) + req.max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}) = {total} exceeds the slot "
                f"cache length ({self.max_seq_len})")
        self.queue.put(req)
        return req

    # -- paged KV admission ------------------------------------------------
    def _kv_gate(self, req, slot):
        """Paged admission gate, consulted before a slot binds: adopt the
        prompt's longest cached prefix, then reserve every block the
        request could need UP FRONT, so decode never allocates.  Under
        pressure, LRU-evicts unreferenced cached prefixes; if the pool
        still cannot cover the rest, returns False and the request waits
        at the queue head.  Everything is scoped to the slot's dp shard:
        its trie, its free list, its eviction."""
        tokens = req.context
        shard = self._slot_shard(slot.index)
        s = len(tokens)
        n_total = -(-(s + req.remaining) // self._bs)
        ctx, m = ([], 0)
        if self.prefix_cache is not None:
            ctx, m = self.prefix_cache.match(tokens, shard=shard)
        need = n_total - len(ctx)
        short = need - self.block_pool.free_count(shard)
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short, shard=shard)
        if need > self.block_pool.free_count(shard):
            self.block_pool.decref(ctx)  # the cache keeps its own refs
            return False
        fresh = self.block_pool.alloc(need, shard=shard)
        req._kv_plan = (ctx, fresh, m)
        return True

    def _release_slot_kv(self, i):
        """Return slot i's block references (eviction): cached prefix
        blocks fall back to the cache's reference, the rest free."""
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
            self.prefix_hits += 1
            self.prefix_hit_tokens += m
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
            idx = torch.tensor(fresh, dtype=torch.long, device=self.device)
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
                    idx[dev] = torch.tensor([b - base for b in fresh],
                                            dtype=torch.long, device=dev)
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
        self._state_dirty = True

    def _push_state(self):
        """Upload the mirrors as the device-resident step state.  Copies:
        a CPU tensor made with ``from_numpy`` would alias the mirror the
        host keeps editing."""
        def put(a):
            return torch.tensor(a, device=self.device)

        self._dev_state = dict(
            tok=put(self._cur_tok), pos=put(self._pos),
            ctr=put(self._sctr), temp=put(self._temp),
            topk=put(self._topk), topp=put(self._topp),
            slo=put(self._seed_lo), shi=put(self._seed_hi),
            eos=put(self._eos), rem=put(self._rem),
            tables=put(self._block_tables),
            scratch=put(self._slot_scratch))
        self._state_dirty = False

    def _begin_chunked(self, slot):
        """Chunked admission: bind the block plan (the adopted prefix
        counts as already prefilled) and park the slot PREFILLING; the
        ragged dispatch spends the tick budget on its chunks."""
        i = slot.index
        self._bind_sample_state(slot)
        _, _, m = self._bind_kv_plan(slot)
        slot.prefilled = m
        slot.pos = slot.prefilled
        self._pos[i] = slot.prefilled
        self._cur_tok[i, 0] = 0

    # -- emission -----------------------------------------------------------
    def _emit(self, slot, tok):
        """Record one generated token; finish + evict on EOS or
        max_new_tokens, else arm the slot for the next tick."""
        req = slot.request
        now = time.monotonic()
        req._emit_token(int(tok))
        if req.first_token_at is None:
            req.first_token_at = now
        self.tokens_generated += 1
        finished = (len(req.generated) >= req.max_new_tokens or
                    (req.eos_token_id is not None
                     and int(tok) == int(req.eos_token_id)))
        i = slot.index
        if finished:
            self.scheduler.evict(slot)
            self._release_slot_kv(i)
            self._park_state(i)
            self.requests_completed += 1
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

    def _dispatch_ragged(self, active, plan):
        """Dispatch one ragged window tick: decoding slots as mode-0 lanes
        of width 1, chunks as mode-1/2 lanes of their token count — one
        ``_fused_ragged_tick_slots`` call whatever the mix.  Chunk lanes
        advance the prefill cursor here (their tokens are known)."""
        W = self._wmax
        B = self.num_slots
        toks = np.zeros((B, W), np.int32)
        width = np.zeros(B, np.int32)
        mode = np.zeros(B, np.int32)
        lanes = np.zeros(B, np.int32)   # draft lanes: none without spec
        for slot in active:
            width[slot.index] = 1
        for slot, n, final in plan:
            i = slot.index
            p0 = slot.prefilled
            toks[i, :n] = slot.request.context[p0:p0 + n]
            width[i] = n
            mode[i] = 2 if final else 1
        # push BEFORE the chunk lanes' mirror advance: the upload carries
        # the pre-dispatch cursors (the dispatch advances them by width)
        if self._state_dirty or self._dev_state is None:
            self._push_state()
        # blocks the kernel walks, on the pre-dispatch cursors: the
        # streaming body stops at each lane's causal horizon, the gather
        # body walks the slot's whole table
        walked = 0
        for s in list(active) + [sl for sl, _, _ in plan]:
            i = s.index
            if self._variant == "gather":
                walked += self._bps
            else:
                live = int(self._pos[i]) + max(int(width[i]), 1)
                walked += min(self._bps, (live - 1) // self._bs + 1)
        self.kv_blocks_walked += walked
        for slot, n, _ in plan:
            slot.prefilled += n
            slot.pos = slot.prefilled
            self._pos[slot.index] = slot.prefilled
            self.prefill_tokens += n
        st = self._dev_state
        dev = self.device
        with torch.no_grad():
            (picks, n_acc, n_emit, done, new_tok, new_pos, new_ctr,
             new_rem, _, _) = self._runner._fused_ragged_tick_slots(
                torch.tensor(toks, device=dev), self.k_pools, self.v_pools,
                st["tables"], torch.tensor(width, device=dev),
                torch.tensor(mode, device=dev),
                torch.tensor(lanes, device=dev), st["tok"], st["pos"],
                st["temp"], st["topk"], st["topp"], st["slo"], st["shi"],
                st["ctr"], st["eos"], st["rem"], scratch=st["scratch"],
                emit_w=1, variant=self._variant)
        st["tok"], st["pos"], st["ctr"], st["rem"] = \
            new_tok, new_pos, new_ctr, new_rem
        self.ragged_dispatches += 1
        slots = list(active) + [s for s, _, _ in plan]
        return _InflightTick(
            self.ticks, slots,
            {"picks": picks, "n_acc": n_acc, "n_emit": n_emit,
             "done": done},
            [int(mode[s.index]) for s in slots])

    def _consume_ragged(self, inf, mats, done):
        """Emit a downloaded ragged tick, per lane mode: chunk lanes
        (mode 1) emit nothing; a final chunk (mode 2) registers the
        prompt's full blocks in the prefix cache and emits picks lane 0;
        decode lanes (mode 0) run ``_emit_window_lane``.  Drift between
        the host's and the device's stop condition raises."""
        picks = mats["picks"]
        n_acc = mats["n_acc"]
        n_emit_dev = mats["n_emit"]
        emitted = 0
        for slot, req, mode_i in zip(inf.slots, inf.reqs, inf.modes):
            i = slot.index
            if slot.request is not req:
                if not done[i]:
                    raise RuntimeError(
                        f"stop-condition drift: slot {i} was evicted on "
                        f"the host but tick {inf.tick}'s device lane is "
                        "not done")
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
                if self.prefix_cache is not None:
                    self.prefix_cache.insert(
                        ctxt, self._slot_blocks[i][:len(ctxt) // self._bs])
                self._emit(slot, int(picks[i, 0]))
                emitted += 1
                if int(n_emit_dev[i]) != 1 or \
                        bool(done[i]) != (slot.request is None):
                    raise RuntimeError(
                        f"ragged drift: final-chunk lane {i} device "
                        f"n_emit={int(n_emit_dev[i])} done={bool(done[i])}"
                        f" vs host finished={slot.request is None} at "
                        f"tick {inf.tick}")
                continue
            n_em, _ = self._emit_window_lane(
                slot, picks[i], int(n_acc[i]), int(n_emit_dev[i]),
                bool(done[i]), inf.tick)
            emitted += n_em
        return emitted

    def _consume(self, inf):
        """Download one dispatched tick's picks, counts and done mask (the
        tick's sync point) and emit them."""
        mats = {k: v.cpu().numpy() for k, v in inf.arrays.items()}
        return self._consume_ragged(inf, mats, mats["done"])

    # -- the tick -------------------------------------------------------------
    def step(self):
        """One engine tick: admit -> one ragged dispatch -> emit.  Returns
        the tokens emitted.  A tick that raises fails every bound request
        loudly (their waiters unblock), rebuilds the pools, and
        re-raises, so the engine works again afterwards."""
        try:
            return self._tick()
        except Exception as e:
            for slot in self.scheduler.busy_slots():
                if self.scheduler.evict(slot, RuntimeError(
                        f"engine step failed: {e!r}")) is not None:
                    self.requests_completed += 1
            self._reset_pools()
            raise

    def _tick(self):
        self.ticks += 1
        # submit() takes no deadline, so no queued request can time out
        admitted, _ = self.scheduler.admit(time.monotonic(),
                                           gate=self._kv_gate)
        for slot in admitted:
            self._begin_chunked(slot)
        _, active, prefilling = self.scheduler.snapshot()
        plan = self._plan_ragged_chunks(prefilling)
        if not (active or plan):
            return 0
        inf = self._dispatch_ragged(active, plan)
        return self._consume(inf)

    def run_until_idle(self, max_steps=100000):
        """Drive ticks until queue and slots are empty; returns the total
        tokens emitted."""
        total = 0
        for _ in range(max_steps):
            if self.scheduler.idle():
                return total
            total += self.step()
        raise RuntimeError(
            f"engine still busy after {max_steps} steps "
            f"(occupancy={self.scheduler.occupancy()}, "
            f"queue={self.queue.depth()})")
