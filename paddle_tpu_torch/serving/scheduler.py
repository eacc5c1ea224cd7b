"""Slot scheduler: maps queued requests onto fixed batch slots (a copy of
``paddle_tpu/serving/scheduler.py``).

Continuous batching over a FIXED pool: slot count and cache length are
fixed per engine, so one window shape serves every tick.  The scheduler
owns only slot METADATA; the engine owns the device tensors.  Admission =
bind request to a free slot; eviction = free the slot on EOS /
max_new_tokens / error.

Slot lifecycle (budgeted chunked prefill, serving/engine.py
``prefill_chunk``): a bound slot whose ``prefilled`` has not reached
its prompt length is PREFILLING — it holds cache rows but is excluded
from the decode set (``snapshot().decoding``) and from sampling until
its final chunk emits the first token.
"""
from __future__ import annotations

import threading


class Slot:
    __slots__ = ("index", "request", "pos", "prefilled", "seq",
                 "spec_lanes")

    def __init__(self, index):
        self.index = index
        self.request = None
        self.pos = 0        # next cache write position (= tokens cached)
        self.prefilled = 0  # prompt tokens whose K/V is computed; a
        #                     bound slot with prefilled < len(prompt) is
        #                     PREFILLING (chunked mode), else DECODING
        self.seq = 0        # admission order stamp: chunked prefill
        #                     resumes earlier-admitted (partially done)
        #                     prompts before starting fresh ones
        self.spec_lanes = 0  # REAL draft lanes in flight in the
        #                      current speculative verify dispatch
        #                      (the engine's accept loop consumes at
        #                      most this many — pad lanes never
        #                      match); reset on admit/evict, so a slot
        #                      that failed mid-verify re-binds clean —
        #                      the rejected lanes' K/V needs no other
        #                      cleanup (cursor never advanced over
        #                      them)

    @property
    def free(self):
        return self.request is None

    @property
    def decoding(self):
        """Bound AND fully prefilled — eligible for the decode tick.
        Measured against ``req.context`` (prompt, or the frozen
        prompt+emitted resume snapshot after a preemption): a resumed
        request is only DECODING once its whole interrupted history
        has K/V again."""
        req = self.request
        return req is not None and self.prefilled >= len(req.context)


class Scheduler:
    """Admits queued requests into free slots; evicts finished ones."""

    def __init__(self, num_slots, queue):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        self.queue = queue
        self.slots = [Slot(i) for i in range(self.num_slots)]
        self._lock = threading.Lock()
        self._admit_seq = 0

    # -- accounting ------------------------------------------------------
    def occupancy(self):
        with self._lock:
            return sum(1 for s in self.slots if not s.free)

    def free_count(self):
        # one acquisition, not occupancy() through a second one
        with self._lock:
            return sum(1 for s in self.slots if s.free)

    def active_slots(self):
        """Decode-eligible slots (bound and fully prefilled) —
        half-prefilled chunked slots are excluded until their final
        chunk emits the first token."""
        with self._lock:
            return [s for s in self.slots if s.decoding]

    def busy_slots(self):
        """Every bound slot, PREFILLING included — the eviction set for
        failure recovery and shutdown drain (a half-prefilled request's
        waiter must unblock too)."""
        with self._lock:
            return [s for s in self.slots if not s.free]

    def debug_view(self):
        """ONE locked pass over the pool for the debug surface
        (``/debug/requests``, flight recorder): per-slot metadata as
        plain dicts, request handle included — the engine enriches
        and serializes.  Read-only; safe from any thread."""
        with self._lock:
            out = []
            for s in self.slots:
                req = s.request
                state = ("free" if req is None else
                         "decoding" if s.prefilled >= len(req.context)
                         else "prefilling")
                out.append({"slot": s.index, "state": state,
                            "request": req, "pos": s.pos,
                            "prefilled": s.prefilled,
                            "spec_lanes": s.spec_lanes,
                            "priority": (None if req is None
                                         else req.priority),
                            "tenant": (None if req is None
                                       else req.tenant)})
        return out

    def snapshot(self):
        """ONE locked pass over the pool: (occupancy, decoding slots,
        prefilling slots ordered by admission).  The engine's per-tick
        view — replaces the separate ``occupancy()`` /
        ``active_slots()`` acquisitions the tick used to pay."""
        with self._lock:
            busy = [s for s in self.slots if not s.free]
            decoding = [s for s in busy if s.decoding]
            prefilling = sorted((s for s in busy if not s.decoding),
                                key=lambda s: s.seq)
        return len(busy), decoding, prefilling

    def find(self, request_id):
        """The slot a request is bound to, or None (queued / unknown /
        finished).  One locked scan — the migration service point
        re-resolves its target after every ring drain, since a drain
        can finish or evict any slot."""
        with self._lock:
            for s in self.slots:
                if s.request is not None and s.request.id == request_id:
                    return s
        return None

    def idle(self):
        return self.occupancy() == 0 and self.queue.depth() == 0

    def admissible(self):
        """True when an admission attempt could make progress: at
        least one queued request AND at least one free slot.  The
        async engine tick's cheap planning probe — admission is a
        structural (pipeline-draining) event, so the pipelined loop
        only pays ``admit()`` when this says it could bind."""
        if self.queue.depth() == 0:
            return False
        with self._lock:
            return any(s.free for s in self.slots)

    # -- admission / eviction -------------------------------------------
    def admit(self, now=None, gate=None):
        """Fill free slots from the queue.  Returns (admitted_slots,
        timed_out_requests) — the engine prefills each admitted slot
        and counts the timeouts.

        ``gate``: optional resource check consulted per request BEFORE
        the slot binds, called as ``gate(req, slot)`` with the slot
        the request WOULD bind to (the engine's paged-KV admission
        gate: prefix cache lookup + up-front block reservation — under
        a data-parallel mesh the reservation must come from the
        binding slot's own dp shard, hence the slot).  A False verdict
        puts the request back at the queue head and stops this round's
        admission — FIFO order is preserved and later ticks retry once
        eviction/completion frees resources.

        Locking: two acquisitions per call (free-slot scan + one batch
        bind), however many slots admit — admission runs only on the
        engine loop thread, so deferring the binds cannot race another
        writer; concurrent readers (``/healthz``) just see the slots
        bind a moment later."""
        timed_out, binds = [], []
        with self._lock:
            free = [s for s in self.slots if s.free]
        for slot in free:
            req, expired = self.queue.pop_ready(now)
            timed_out.extend(expired)
            if req is None:
                break
            if gate is not None:
                try:
                    admit_ok = gate(req, slot)
                except BaseException:
                    # a gate that RAISES (e.g. pool failure mid-
                    # reservation) must not lose popped requests: put
                    # this one and every not-yet-bound earlier pop
                    # back in order, so their waiters survive the
                    # step-failure recovery and later ticks retry
                    # (stale _kv_plan reservations are overwritten by
                    # the re-admission gate after the pool rebuilds)
                    self.queue.push_front(req)
                    for _, r in reversed(binds):
                        self.queue.push_front(r)
                    raise
                if not admit_ok:
                    self.queue.push_front(req)
                    break
            binds.append((slot, req))
        if binds:
            with self._lock:
                for slot, req in binds:
                    slot.request = req
                    slot.pos = 0
                    slot.prefilled = 0
                    slot.spec_lanes = 0
                    self._admit_seq += 1
                    slot.seq = self._admit_seq
        return [s for s, _ in binds], timed_out

    def release(self, slot):
        """Unbind a slot WITHOUT completing its request — the
        PREEMPTION path: the caller (engine) requeues the request with
        its emitted tokens preserved, so its waiter stays blocked and
        the stream resumes on re-admission.  Returns the request."""
        with self._lock:
            req = slot.request
            slot.request = None
            slot.pos = 0
            slot.prefilled = 0
            slot.spec_lanes = 0
        return req

    def evict(self, slot, error=None):
        """Free a slot and complete its request."""
        with self._lock:
            req = slot.request
            slot.request = None
            slot.pos = 0
            slot.prefilled = 0
            slot.spec_lanes = 0
        if req is not None:
            req._finish(error)
        return req
