"""Hierarchical KV cache: the host-RAM offload tier (a copy of
``paddle_tpu/serving/offload.py``).

When ``PrefixCache.evict`` frees cached blocks under pool pressure, the
K/V they held would be recomputed by the next request that shares the
prefix.  Host RAM is ~10-50x the device's memory, so this module gives
evicted blocks a second, larger home:

* ``HostBlockStore``: a capacity-bounded, byte-accounted,
  LRU-within-budget map from CONTENT ADDRESS to one block's host
  payload.  The address is the blake2b hash of the full token prefix the
  block's K/V encodes (``prefix_key``), so two requests sharing a system
  prompt demote and promote the SAME entries.  Geometry and dtype are
  checked as ``kvcache.import_blocks`` checks them: int8 codes must carry
  their scales (``KVDtypeMismatch`` otherwise), and a wrong block shape
  is refused before any byte is adopted.

* The DEMOTE path (``serving/engine.py``): the trie's evict hook
  launches a device gather of the dying block's rows on the engine's
  stream BEFORE the block returns to the free list (the pools are
  written in place, so a gather launched later would read whatever a
  newer request wrote there), and queues its download into pinned host
  memory behind a CUDA event; the next tick boundary
  (``Engine._service_offload``) waits on the event and parks the numpy
  copy here.

* The PROMOTE path: the paged admission gate consults the device trie
  first, then this store; a host hit writes the payload into fresh
  blocks (``import_blocks``), seeds the device trie, and skips prefill
  for the restored span exactly like a device prefix hit.

Host-side only: nothing here touches a device tensor.  Single-writer
(the engine loop thread) like the rest of the KV metadata.  The fault
injector's ``offload_demote`` site fires in the engine's evict hook (the
block frees without spilling) and ``offload_promote`` in its admission
consult (the span is recomputed, the entries stay).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np

from .kvcache import KVDtypeMismatch


def prefix_key(tokens, n_tokens=None):
    """Content address of the KV block whose trie node covers token
    positions ``[n - block_size, n)`` of ``tokens`` — the blake2b hash
    of the FULL prefix ``tokens[:n]`` (``n = n_tokens`` or all of
    ``tokens``).  Hashing the whole prefix, not just the block's own
    span, is what makes the address a content address: a block's K/V
    depends on every token before it, so two blocks are interchangeable
    iff their full prefixes match — exactly the prefix trie's node
    identity, flattened."""
    arr = np.asarray(tokens, np.int32)
    if n_tokens is not None:
        arr = arr[:int(n_tokens)]
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


class HostBlockStore:
    """Capacity-bounded host-RAM tier for demoted KV blocks.

    One entry per content address (``prefix_key``): the block's K/V
    rows for every layer as ONE numpy array ``(n_layers, 2,
    block_size, num_heads, head_dim)`` (axis 1 = K, V — the
    per-block slice of ``kvcache.export_blocks``' layout), plus, for
    int8 pools, the parallel per-head scales ``(n_layers, 2,
    num_heads)``.  Entries are byte-accounted (codes + scales both
    count) and evicted LRU-within-budget on ``put`` — the store never
    exceeds ``capacity_mb``.

    Geometry/dtype discipline mirrors the migration wire: the store is
    constructed with the engine's block geometry and kv dtype label,
    ``put`` refuses a mismatched payload (``KVDtypeMismatch`` for the
    quantization disagreement, ``ValueError`` for shape) so a bug can
    never park garbage that a later promote would scatter into live
    pools.

    Single-writer (the engine loop thread) like BlockPool/PrefixCache;
    ``stats()`` is safe to read from handler threads (plain int
    fields)."""

    def __init__(self, capacity_mb, block_size, num_heads, head_dim,
                 n_layers, dtype="float32"):
        capacity_mb = float(capacity_mb)
        if capacity_mb <= 0:
            raise ValueError(
                f"kv_host_mb must be > 0, got {capacity_mb:g}")
        self.capacity_bytes = int(capacity_mb * 2 ** 20)
        self.capacity_mb = capacity_mb
        self.block_size = int(block_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.n_layers = int(n_layers)
        self.dtype = str(dtype)
        self.quant = self.dtype == "int8"
        # the expected per-entry shapes, fixed at construction like
        # the migration wire's `want` geometry
        self._want = (self.n_layers, 2, self.block_size,
                      self.num_heads, self.head_dim)
        self._want_scales = (self.n_layers, 2, self.num_heads)
        self._entries = OrderedDict()  # key -> (data, scales|None)
        self.bytes_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.refusals = 0    # oversize puts turned away
        self.dedup_puts = 0  # puts whose key was already resident

    def __len__(self):
        return len(self._entries)

    def __contains__(self, key):
        """Presence probe WITHOUT touching the LRU order (the
        admission gate probes every continuation block before it
        commits to a restore — probes must not age out colder
        entries' recency)."""
        return key in self._entries

    @staticmethod
    def _nbytes(data, scales):
        return int(data.nbytes) + (int(scales.nbytes)
                                   if scales is not None else 0)

    def _check(self, data, scales):
        if self.quant and scales is None:
            raise KVDtypeMismatch(
                "host store holds int8 blocks (kv_dtype='int8') but "
                "the demoted payload carries no scales — refusing to "
                "park fp rows in a quantized tier")
        if not self.quant and scales is not None:
            raise KVDtypeMismatch(
                "demoted payload carries int8 codes + scales but the "
                "host store is fp (kv_dtype mismatch) — refusing")
        if tuple(data.shape) != self._want:
            raise ValueError(
                f"demoted block shape {tuple(data.shape)} does not "
                f"match the store geometry (want {self._want}: layers "
                "x (K,V) x block_size x heads x head_dim)")
        if scales is not None \
                and tuple(scales.shape) != self._want_scales:
            raise ValueError(
                f"demoted scale shape {tuple(scales.shape)} does not "
                f"match the store geometry (want {self._want_scales}: "
                "layers x (K,V) x heads)")

    def put(self, key, data, scales=None):
        """Park one demoted block under its content address.  Returns
        True when the entry is resident afterwards (including the
        dedup case — the key was already stored, its recency just
        refreshes: same prefix means same content, re-copying would
        buy nothing), False when the entry alone exceeds the whole
        budget (refused; the block simply frees, like a failed
        demote).  Evicts LRU entries until the budget holds.  Raises
        on geometry/dtype mismatch — see ``_check``."""
        data = np.asarray(data)
        if scales is not None:
            scales = np.asarray(scales)
        self._check(data, scales)
        if key in self._entries:
            self._entries.move_to_end(key)
            self.dedup_puts += 1
            return True
        nb = self._nbytes(data, scales)
        if nb > self.capacity_bytes:
            self.refusals += 1
            return False
        while self.bytes_used + nb > self.capacity_bytes:
            _, (d, s) = self._entries.popitem(last=False)
            self.bytes_used -= self._nbytes(d, s)
            self.evictions += 1
        # own copies: the caller's arrays may be views over a larger
        # materialized gather it is about to drop
        self._entries[key] = (np.ascontiguousarray(data),
                              None if scales is None
                              else np.ascontiguousarray(scales))
        self.bytes_used += nb
        return True

    def get(self, key):
        """The entry for ``key`` as ``(data, scales)`` — ``scales`` is
        None for fp stores — or None on a miss.  A hit refreshes the
        entry's LRU recency (a promoted prefix is warm again)."""
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return ent

    def discard(self, key):
        """Drop one entry (returns True if it existed)."""
        ent = self._entries.pop(key, None)
        if ent is None:
            return False
        self.bytes_used -= self._nbytes(*ent)
        return True

    def clear(self):
        """Drop every entry (engine teardown); returns how many."""
        n = len(self._entries)
        self._entries = OrderedDict()
        self.bytes_used = 0
        return n

    def keys(self):
        """Resident content addresses, LRU-oldest first (tests +
        debug surfaces)."""
        return list(self._entries)

    def stats(self):
        """JSON-able snapshot for /healthz and /debug/requests."""
        return {
            "blocks": len(self._entries),
            "bytes": self.bytes_used,
            "capacity_mb": self.capacity_mb,
            "dtype": self.dtype,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "refusals": self.refusals,
            "dedup_puts": self.dedup_puts,
        }
