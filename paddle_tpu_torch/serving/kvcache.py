"""Paged KV cache: block pool, refcounts, prefix reuse (a copy of the host
half of ``paddle_tpu/serving/kvcache.py``).

The engine's K/V pools are carved into fixed-size blocks; a slot's
logical cache row is the gather of its BLOCK TABLE, identical prompt
prefixes share physical blocks (refcounted), and finished prompts stay
resident in a token-trie ``PrefixCache`` so later requests skip prefill
for the shared span, with LRU eviction returning blocks under pool
pressure.

Host-side METADATA only: the engine owns the device tensors, and block
ids here are row indices into its per-layer ``[num_blocks, block_size,
H, hd]`` pools (one id indexes every layer).  Everything is driven from
the single engine loop thread, so no locking.

Reference protocol (who holds how many refs on a block):

* ``alloc`` hands blocks out at refcount 1 — the allocating slot's ref.
* ``PrefixCache.insert`` takes ONE extra ref per newly registered
  block (the cache's own); already-cached spans are left alone.
* ``PrefixCache.match`` takes one ref per matched block ON BEHALF OF
  the adopting slot.
* Slot eviction decrefs every block in the slot's table exactly once;
  blocks that were cached drop to the cache's ref and stay resident,
  decode-span blocks drop to 0 and return to the free list.
* ``evict`` drops cache refs (LRU, unreferenced leaves first) until
  enough blocks free up.

Scratch block: every window lane at or past a slot's ``width`` (and
every lane of a parked slot) writes into the slot's reserved scratch
block — physical row 0 on one card — which no live request ever reads
(``GPTAttention.ragged_window_paged``).

Block export and import (``export_blocks`` / ``import_blocks``, the
data half of KV migration) move a set of blocks' rows, every layer, K
and V, between the pools and one host array; the host-RAM offload tier
(``serving/offload.py``) restores through ``import_blocks``, and the
engine's ``migrate_out`` / ``migrate_in`` and ``export_prefix`` /
``import_prefix`` carry them in the JAX package's payload format
(``payload_to_json`` / ``payload_from_json`` are its wire form).
"""
from __future__ import annotations

import base64

import numpy as np
import torch


class KVDtypeMismatch(ValueError):
    """A block payload and the destination pools disagree about KV
    quantization (int8 codes against fp rows): the import adopts
    nothing.  A ValueError, so callers that catch geometry errors catch
    it too."""


def _is_quant_pool(pool):
    return hasattr(pool, "codes") and hasattr(pool, "scale")


def export_blocks(k_pools, v_pools, block_ids):
    """The rows of ``block_ids`` from every layer's pools as ONE host
    array ``(n_layers, 2, n_blocks, block_size, H, hd)`` (axis 1: K, V),
    in table order; the rows are gathered on the pools' device, so only
    the exported blocks come home.  Quantized pools (``QuantKV``) return
    ``(codes, scales)``: the int8 codes in that shape and their per-block
    per-head scales ``(n_layers, 2, n_blocks, H)``."""
    dev = (k_pools[0].codes if _is_quant_pool(k_pools[0])
           else k_pools[0]).device
    ids = torch.as_tensor([int(b) for b in block_ids], dtype=torch.long,
                          device=dev)

    def gather(field):
        return torch.stack([
            torch.stack((field(kp).index_select(0, ids),
                         field(vp).index_select(0, ids)))
            for kp, vp in zip(k_pools, v_pools)]).cpu().numpy()

    if _is_quant_pool(k_pools[0]):
        return (gather(lambda p: p.codes), gather(lambda p: p.scale))
    return gather(lambda p: p)


def _to_device(a, dtype, device):
    """A host array as a ``dtype`` tensor on ``device``: through a pinned
    staging copy and a ``non_blocking`` transfer on a card (the caching
    host allocator keeps the pinned block until the copy is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def import_blocks(k_pools, v_pools, block_ids, data, scales=None):
    """Write an ``export_blocks`` array into rows ``block_ids`` of every
    layer's pools, in place (``index_copy_``), and return the same
    ``(k_pools, v_pools)``.  Everything is checked before anything is
    written: ``KVDtypeMismatch`` when payload and pools disagree about
    quantization (checked first: int8 codes must never land in fp pools,
    nor fp rows without scales in quantized ones), ``ValueError`` when
    the geometry (layers, block size, heads, head dim) or the scale shape
    does not match.  ``scales`` ``(n_layers, 2, n_blocks, H)`` is needed
    exactly when the pools are ``QuantKV``."""
    quant = _is_quant_pool(k_pools[0])
    if quant and scales is None:
        raise KVDtypeMismatch(
            "destination pools are int8-quantized (kv_dtype='int8') "
            "but the payload carries no scales: refusing to adopt fp "
            "rows into a quantized pool")
    if not quant and scales is not None:
        raise KVDtypeMismatch(
            "the payload carries int8 codes + scales but the destination "
            "pools are fp (kv_dtype mismatch): refusing to adopt")
    data = np.asarray(data)
    ids = [int(b) for b in block_ids]
    want = (len(k_pools), 2, len(ids)) + tuple(k_pools[0].shape[1:])
    if tuple(data.shape) != want:
        raise ValueError(
            f"block payload shape {tuple(data.shape)} does not match the "
            f"destination pools (want {want}: layers x (K,V) x blocks x "
            "block_size x heads x head_dim)")
    if quant:
        scales = np.asarray(scales)
        want_s = (len(k_pools), 2, len(ids), k_pools[0].shape[2])
        if tuple(scales.shape) != want_s:
            raise ValueError(
                f"block scale shape {tuple(scales.shape)} does not match "
                f"the destination scale pools (want {want_s}: layers x "
                "(K,V) x blocks x heads)")
    if not ids:
        return k_pools, v_pools
    codes0 = k_pools[0].codes if quant else k_pools[0]
    dev = codes0.device
    idx = _to_device(np.asarray(ids, np.int64), torch.long, dev)
    rows = _to_device(data, codes0.dtype, dev)
    if quant:
        srows = _to_device(scales, k_pools[0].scale.dtype, dev)
    for li, (kp, vp) in enumerate(zip(k_pools, v_pools)):
        if quant:
            kp.codes.index_copy_(0, idx, rows[li, 0])
            vp.codes.index_copy_(0, idx, rows[li, 1])
            kp.scale.index_copy_(0, idx, srows[li, 0])
            vp.scale.index_copy_(0, idx, srows[li, 1])
        else:
            kp.index_copy_(0, idx, rows[li, 0])
            vp.index_copy_(0, idx, rows[li, 1])
    return k_pools, v_pools


def payload_to_json(payload):
    """JSON-encode a block payload for the wire: ``kv["data"]`` (and a
    quantized payload's ``kv["scales"]``) become base64 bytes plus dtype
    and shape (``data_b64`` / ``data_dtype`` / ``data_shape``); the rest
    of the payload is already JSON-shaped.  ``payload_from_json`` inverts
    it exactly."""
    out = {k: v for k, v in payload.items() if k != "kv"}
    kv = payload.get("kv")
    if kv is not None:
        kv = dict(kv)
        for field in ("data", "scales"):
            arr = kv.pop(field, None)
            if arr is not None:
                arr = np.ascontiguousarray(arr)
                kv[f"{field}_b64"] = base64.b64encode(
                    arr.tobytes()).decode("ascii")
                kv[f"{field}_dtype"] = str(arr.dtype)
                kv[f"{field}_shape"] = list(arr.shape)
        out["kv"] = kv
    return out


def payload_from_json(obj):
    """Decode a ``payload_to_json`` dict back into the in-memory payload
    (``kv["data"]``, and ``kv["scales"]`` when quantized, as writable
    numpy arrays)."""
    out = {k: v for k, v in obj.items() if k != "kv"}
    kv = obj.get("kv")
    if kv is not None:
        kv = dict(kv)
        for field in ("data", "scales"):
            b64 = kv.pop(f"{field}_b64", None)
            if b64 is not None:
                dtype = np.dtype(kv.pop(f"{field}_dtype"))
                shape = tuple(kv.pop(f"{field}_shape"))
                kv[field] = np.frombuffer(
                    base64.b64decode(b64), dtype=dtype).reshape(shape).copy()
        out["kv"] = kv
    return out


def per_shard_block_bytes(block_size, num_heads, head_dim, dtype,
                          n_layers, mp=1, scale_dtype=None):
    """PER-SHARD HBM cost of ONE logical KV block across every layer:
    ``n_layers * 2 (K and V) * block_size * (num_heads/mp) * head_dim
    * itemsize``.  Under a tensor-parallel mesh (Engine(mesh=...))
    the pools shard on the head axis, so each device stores only its
    ``num_heads/mp`` heads' slice of every block — which is why a
    fixed per-chip budget (``Engine(kv_budget_mb=...)``) buys ``mp``x
    the logical blocks: KV capacity, the HBM ceiling on concurrent
    slots, scales with the mesh.  ``num_heads`` must divide by ``mp``
    (attention shards whole heads).

    ``dtype`` is the STORED row dtype — int8 for a quantized pool
    (``Engine(kv_dtype="int8")``), in which case ``scale_dtype``
    (f32) adds the parallel scale pool's ``n_layers * 2 *
    (num_heads/mp)`` per-block per-head multipliers, so the quoted
    cost is the block's TRUE footprint and the int8/f32 capacity
    ratio works out to ``4 / (1 + 4/(block_size*head_dim))`` (~3.8x
    for the small test geometries, ~4x at real ones) instead of a
    flattering byte-only 4x."""
    mp = int(mp)
    itemsize = (torch.empty((), dtype=dtype).element_size()
                if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    if mp < 1 or num_heads % mp:
        raise ValueError(
            f"num_heads ({num_heads}) must divide by mp ({mp})")
    total = (int(n_layers) * 2 * int(block_size) * (num_heads // mp)
             * int(head_dim) * itemsize)
    if scale_dtype is not None:
        total += (int(n_layers) * 2 * (num_heads // mp)
                  * np.dtype(scale_dtype).itemsize)
    return total


class NoFreeBlocks(RuntimeError):
    """The pool cannot satisfy an allocation (even after eviction)."""


def _as_ids(blocks):
    if isinstance(blocks, int):
        return (blocks,)
    return blocks


class BlockPool:
    """Fixed-size-block allocator over the engine's K/V pool rows.

    ``reserved_blocks`` low ids are never handed out — the engine pins
    row 0 as the scratch block that parked (inactive) slots harmlessly
    read and write through.

    ``fault_hook`` (optional): called with the request size before
    every ``alloc`` — the deterministic chaos harness
    (serving/faults.py) threads its "pool_exhaust" site through it,
    raising ``NoFreeBlocks`` on scheduled ticks so recovery paths are
    exercised against pool pressure that composes with other
    failures.  None (default) costs nothing.

    ``shards`` (data-parallel serving, ``Engine(mesh=(mp, dp))``): the
    pool rows divide into ``shards`` CONTIGUOUS equal ranges, one per
    'dp' mesh shard — shard ``d`` owns global rows ``[d*rps,
    (d+1)*rps)`` where ``rps = num_blocks // shards`` — and every
    range reserves its own ``reserved_blocks`` leading rows (shard
    ``d``'s scratch row is ``scratch_row(d) = d*rps``), so a parked
    slot's masked writes stay INSIDE its own shard's pool slice (the
    shard_map kernel instance cannot address another shard's rows).
    ``alloc(n, shard=d)`` draws only from shard ``d``'s free list and
    ``decref`` returns a freed block to its OWN shard; a block never
    migrates between shards because the device pool is physically
    split at exactly these row boundaries.  ``shards=1`` (default) is
    bit-identical to the unsharded pool.
    """

    def __init__(self, num_blocks, block_size, reserved_blocks=0,
                 fault_hook=None, shards=1):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        shards = int(shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        if num_blocks % shards:
            raise ValueError(
                f"num_blocks ({num_blocks}) must divide into {shards} "
                "equal dp shard ranges")
        rps = num_blocks // shards
        if rps - reserved_blocks < 1:
            raise ValueError(
                f"pool needs at least one allocatable block per shard "
                f"({num_blocks} total / {shards} shard(s), "
                f"{reserved_blocks} reserved each)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.reserved_blocks = int(reserved_blocks)
        self.shards = shards
        self.rows_per_shard = rps
        # pop() from the tail hands out low ids first (stable tests)
        self._free = [list(range(d * rps + rps - 1,
                                 d * rps + reserved_blocks - 1, -1))
                      for d in range(shards)]
        self._ref = [0] * self.num_blocks
        self._fault_hook = fault_hook

    @property
    def managed_blocks(self):
        return self.num_blocks - self.shards * self.reserved_blocks

    def shard_of(self, block):
        """The dp shard whose pool range holds global row ``block``."""
        return int(block) // self.rows_per_shard

    def scratch_row(self, shard=0):
        """Global row id of ``shard``'s reserved scratch block (the
        first row of its range) — parked slots' tables point here."""
        if not self.reserved_blocks:
            raise ValueError("pool has no reserved scratch rows")
        return int(shard) * self.rows_per_shard

    def free_count(self, shard=None):
        if shard is None:
            return sum(len(f) for f in self._free)
        return len(self._free[shard])

    def in_use(self):
        return self.managed_blocks - self.free_count()

    def refcount(self, block):
        return self._ref[block]

    def alloc(self, n, shard=0):
        """Take ``n`` blocks off ``shard``'s free list at refcount 1."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if self._fault_hook is not None:
            self._fault_hook(n)  # chaos harness: may raise NoFreeBlocks
        free = self._free[shard]
        if n > len(free):
            raise NoFreeBlocks(
                f"need {n} blocks, only {len(free)} free of "
                f"{self.managed_blocks // self.shards} on dp shard "
                f"{shard} (evict cached prefixes first)")
        out = [free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def incref(self, blocks):
        for b in _as_ids(blocks):
            if self._ref[b] < 1:
                raise RuntimeError(
                    f"incref on free block {b} — a reference can only "
                    "be shared from a live one")
            self._ref[b] += 1

    def decref(self, blocks):
        """Drop one reference per block; blocks reaching refcount 0
        return to the free list.  Returns the freed ids."""
        freed = []
        for b in _as_ids(blocks):
            if self._ref[b] < 1:
                raise RuntimeError(f"double free of block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free[self.shard_of(b)].append(b)
                freed.append(b)
        return freed

    def cow(self, block):
        """Copy-on-write: make the caller's reference to ``block``
        privately writable.  Sole owner -> the block itself (no copy).
        Shared -> the caller's ref moves to a fresh block and the
        caller must copy the device rows; returns ``(writable_block,
        needs_copy)``.  Raises NoFreeBlocks with the original ref
        intact if the pool is empty (evict, then retry).

        The serving engine adopts cached prefixes at FULL-block
        granularity and writes only into freshly allocated blocks, so
        its steady state never needs the copy — this is the general
        primitive (partial-block adoption, future mutation paths).
        """
        if self._ref[block] < 1:
            raise RuntimeError(f"cow of free block {block}")
        if self._ref[block] == 1:
            return block, False
        # before decref: failure leaves the shared ref untouched; the
        # replacement comes from the block's OWN shard range
        new = self.alloc(1, shard=self.shard_of(block))[0]
        self._ref[block] -= 1
        return new, True


class _TrieNode:
    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent, last_used):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = {}
        self.last_used = last_used


class PrefixCache:
    """Token-trie over FULL blocks of previously-seen prompts.

    Each node covers one block's worth of token ids; node depth i
    means "positions [i*bs, (i+1)*bs) of some prompt", and its block
    holds the K/V computed for exactly that token prefix — so an
    adopter walking the trie from the root gets blocks whose content
    is what its own prefill would have produced for the shared span.
    Partial blocks are never cached (the engine trims matches to block
    boundaries), which keeps adoption pure sharing: writes always land
    in the adopter's own fresh blocks (``BlockPool.cow`` degenerates
    to the no-copy case).

    ``evict_hook`` (optional): called as ``hook(tokens, block)`` for
    every node ``evict`` is about to drop, BEFORE the pool reference
    — ``tokens`` is the node's full token prefix (root through the
    dying block, reconstructed from the parent chain), so the hook can
    demote the block's device rows to a content-addressed host tier
    (serving/offload.py) while they are still resident.  Exceptions
    are swallowed: a failed demote must free the block normally, never
    wedge eviction mid-walk (``clear`` — the engine-reset path whose
    device pools may already be gone — never calls it).

    Data-parallel pools (``BlockPool(shards=dp)``) get ONE TRIE PER
    SHARD: a slot can only gather blocks inside its own dp shard's
    pool range, so a cached prefix is only adoptable by slots of the
    shard that computed it.  ``match(tokens, shard=d)`` walks shard
    ``d``'s trie; ``match(tokens)`` (shard=None) probes every shard
    and adopts from the one with the longest cached span (the
    cross-shard lookup the prefix-warm service uses).  ``insert``
    routes to the trie of the shard that owns ``blocks[0]``.
    """

    def __init__(self, pool, evict_hook=None):
        self.pool = pool
        self.block_size = pool.block_size
        self.evict_hook = evict_hook
        # one root per dp pool shard: key tuple -> _TrieNode
        self._roots = [dict()
                       for _ in range(getattr(pool, "shards", 1))]
        self._clock = 0       # LRU stamp (monotonic counter)

    def _tick(self):
        self._clock += 1
        return self._clock

    @staticmethod
    def _iter_root(root):
        stack = list(root.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _iter_nodes(self):
        for root in self._roots:
            yield from self._iter_root(root)

    def cached_blocks(self):
        return sum(1 for _ in self._iter_nodes())

    def _walk(self, tokens, root, limit, stamp=None):
        blocks = []
        children = root
        for i in range(limit):
            key = tuple(int(x) for x in
                        tokens[i * self.block_size:
                               (i + 1) * self.block_size])
            node = children.get(key)
            if node is None:
                break
            if stamp is not None:
                node.last_used = stamp
            blocks.append(node.block)
            children = node.children
        return blocks

    def match(self, tokens, shard=None):
        """Longest cached prefix of ``tokens`` in full blocks, capped
        so at least ONE token is left for the adopter's own prefill
        (admission still needs a last-position logit to sample from).
        Takes one pool reference per returned block on behalf of the
        caller — release with ``pool.decref`` at slot eviction.
        ``shard`` names the dp shard whose trie to walk (the adopting
        slot's); None probes every shard and adopts from the longest.
        Returns ``(block_ids, matched_token_count)``."""
        limit = (len(tokens) - 1) // self.block_size
        if shard is None:
            shard = 0
            if len(self._roots) > 1:
                shard = max(
                    range(len(self._roots)),
                    key=lambda d: len(self._walk(tokens,
                                                 self._roots[d],
                                                 limit)))
        blocks = self._walk(tokens, self._roots[shard], limit,
                            stamp=self._tick())
        self.pool.incref(blocks)
        return blocks, len(blocks) * self.block_size

    def insert(self, tokens, blocks):
        """Register ``blocks[i]`` as the cached K/V of ``tokens``'s
        i-th FULL block.  Existing nodes win (a duplicate block —
        two same-prefix requests prefilled in the same tick — stays
        slot-private and frees at eviction); each NEW node takes the
        cache's own pool reference.  The target trie is the one of
        the dp shard that owns the blocks (all of one slot's blocks
        live in one shard range by construction)."""
        bs = self.block_size
        if not blocks:
            return
        children = self._roots[self.pool.shard_of(blocks[0])
                               if len(self._roots) > 1 else 0]
        parent = None
        t = self._tick()
        n = min(len(blocks), len(tokens) // bs)
        for i in range(n):
            key = tuple(int(x) for x in tokens[i * bs:(i + 1) * bs])
            node = children.get(key)
            if node is None:
                node = _TrieNode(key, blocks[i], parent, t)
                self.pool.incref(blocks[i])
                children[key] = node
            node.last_used = t
            parent = node
            children = node.children

    @staticmethod
    def _prefix_of(node):
        """The full token prefix ``node``'s block encodes — every
        ancestor's key plus its own, root-first — i.e. the content a
        demote hook must hash to address the block."""
        keys = []
        while node is not None:
            keys.append(node.key)
            node = node.parent
        out = []
        for key in reversed(keys):
            out.extend(key)
        return tuple(out)

    def evict(self, n, shard=None):
        """Free at least ``n`` blocks by dropping least-recently-used
        UNREFERENCED cached prefixes, deepest first (a node with live
        children or an active adopter — pool refcount > 1 — is never
        evicted; evicting a leaf exposes its parent as the next
        candidate).  One trie walk + a heap, not a rescan per freed
        block — eviction runs inside the engine's step loop and must
        not stall decode ticks under sustained pressure.  ``shard``
        restricts the walk to one dp shard's trie (pressure on shard
        ``d`` can only be relieved by shard ``d``'s blocks); None
        evicts across all shards.  Returns the freed block ids (may
        be shorter than ``n`` when nothing evictable remains)."""
        import heapq
        freed = []
        roots = (self._roots if shard is None
                 else [self._roots[shard]])
        heap = [(node.last_used, id(node), node, root)
                for root in roots
                for node in self._iter_root(root)
                if not node.children
                and self.pool.refcount(node.block) == 1]
        heapq.heapify(heap)
        while heap and len(freed) < n:
            _, _, node, root = heapq.heappop(heap)
            if node.children or self.pool.refcount(node.block) != 1:
                continue              # state changed since enqueue
            owner = (node.parent.children if node.parent else root)
            if owner.get(node.key) is not node:
                continue              # already detached
            owner.pop(node.key)
            if self.evict_hook is not None:
                try:
                    self.evict_hook(self._prefix_of(node), node.block)
                except Exception:
                    pass  # failed demote: free normally, never wedge
            freed.extend(self.pool.decref(node.block))
            parent = node.parent
            if parent is not None and not parent.children \
                    and self.pool.refcount(parent.block) == 1:
                heapq.heappush(
                    heap,
                    (parent.last_used, id(parent), parent, root))
        return freed

    def clear(self):
        """Drop every cached prefix (engine reset); returns freed ids."""
        freed = []
        for node in list(self._iter_nodes()):
            freed.extend(self.pool.decref(node.block))
        self._roots = [dict() for _ in self._roots]
        return freed
