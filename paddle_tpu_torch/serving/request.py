"""Serving requests and the admission queue (a copy of
``paddle_tpu/serving/request.py``; the port keeps its own so it never
imports the JAX package).

A ``Request`` is one generation job: prompt ids in, generated ids out,
with a threading.Event completion handle so HTTP handler threads (or
any caller thread) can block on ``result()`` while the engine thread
decodes.  The ``RequestQueue`` is the admission buffer in front of the
slot pool; it orders service by PRIORITY CLASS (strict tiers — an
interactive request never waits behind a batch job) and, within a
tier, by WEIGHTED-FAIR share across tenants (start-time fair queuing
over token cost, so a flooding tenant cannot starve another past its
configured weight), while still enforcing per-request deadlines: a
request that waits longer than its ``timeout`` is failed loudly
instead of silently decoding after its caller gave up.

Load-shedding vocabulary (the overload-protection edge): every
rejection carries an honest ``retry_after`` hint —

* ``QueueFull``     — the admission queue is at ``max_queue``.
* ``RateLimited``   — the tenant's token bucket is empty
  (``TenantPolicy(rate=...)``).
* ``DeadlineShed``  — the estimated queue-drain time already blows the
  request's deadline, so admitting it would only burn slot time on a
  result nobody is still waiting for.

Preemption support: the engine may REQUEUE a running request under
priority pressure (``requeue()`` — it re-enters at the head of its own
lane, its fairness cost already charged).  The request keeps its
emitted tokens; ``context`` is the frozen prompt+emitted snapshot a
re-admission must prefill so the resumed stream continues exactly
where it stopped.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np


class RequestTimeout(RuntimeError):
    """The request exceeded its queue deadline before a slot freed up."""


class Rejected(RuntimeError):
    """Base of the submit-time load-shedding rejections; carries the
    honest backoff hint (``retry_after`` seconds, None when the edge
    has no estimate)."""

    def __init__(self, msg, retry_after=None):
        super().__init__(msg)
        self.retry_after = retry_after


class QueueFull(Rejected):
    """The admission queue is at max_queue; shed load at the edge."""


class RateLimited(Rejected):
    """The tenant's token bucket cannot cover this request's cost."""


class DeadlineShed(Rejected):
    """The estimated queue-drain time already exceeds the request's
    deadline — admitted, it would time out anyway; shed at submit with
    a computed Retry-After instead."""


# Largest admissible sampling seed (exclusive): the device sampling key
# derivation takes the seed as two 32-bit words (lo | hi << 32,
# ``models/gpt.py`` ``GPTModel._slot_sample_keys``), so a seed must be a
# non-negative int below 2**63.
MAX_SEED = 2 ** 63

DEFAULT_TENANT = "default"

_req_ids = itertools.count()


class TenantPolicy:
    """Per-tenant admission policy.

    weight : weighted-fair share of queue service within a priority
        tier (tokens served in proportion ``weight / sum(weights of
        backlogged tenants)``).
    rate : token-bucket refill in tokens/sec charged at submit
        (``prompt + max_new_tokens`` per request); None = unlimited.
    burst : bucket depth in tokens (default ``4 * rate`` — one burst
        of a few requests rides through, sustained traffic is held to
        ``rate``).  Requires ``rate``.
    """

    __slots__ = ("weight", "rate", "burst")

    def __init__(self, weight=1.0, rate=None, burst=None):
        weight = float(weight)
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        if rate is not None and float(rate) <= 0:
            raise ValueError(f"rate must be > 0 tokens/sec, got {rate}")
        if burst is not None and rate is None:
            raise ValueError("burst requires rate (it is the bucket "
                             "depth of the rate limiter)")
        self.weight = weight
        self.rate = None if rate is None else float(rate)
        self.burst = (None if self.rate is None
                      else float(burst) if burst is not None
                      else 4.0 * self.rate)


class TokenBucket:
    """Classic token bucket (tokens/sec refill, bounded depth) — the
    per-tenant rate limiter consulted at ``Engine.submit``.  Thread
    safe: submits arrive from HTTP handler threads."""

    def __init__(self, rate, burst):
        self.rate = float(rate)
        self.burst = float(burst)
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self, cost, now=None):
        """Consume ``cost`` tokens.  Returns None on success, else the
        seconds until the bucket could cover the cost (the honest
        Retry-After)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last)
                               * self.rate)
            self._last = now
            if cost <= self._tokens:
                self._tokens -= cost
                return None
            return (cost - self._tokens) / self.rate

    def refund(self, cost):
        """Return a charge taken for a request that was then rejected
        for an unrelated reason (queue full, deadline shed): the
        request did no work, so it must not count against the rate —
        otherwise one shedding class cascades into RateLimited
        lockout."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + cost)


class Request:
    """One generation job moving through queue -> slot -> done."""

    def __init__(self, prompt, max_new_tokens, eos_token_id=None,
                 timeout=None, temperature=1.0, top_k=0, top_p=1.0,
                 seed=None, priority=0, tenant=None, adapter=None):
        self.id = next(_req_ids)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.eos_token_id = eos_token_id
        self.temperature = float(temperature)
        self.top_k = int(top_k or 0)
        self.top_p = float(top_p)
        self.seed = seed
        self.priority = int(priority)   # higher = more urgent; the
        #   scheduler may PREEMPT a running lower-priority request to
        #   admit this one
        self.tenant = (DEFAULT_TENANT if tenant is None
                       else str(tenant))
        self.adapter = None if adapter is None else str(adapter)
        self._adapter_id = 0         # LoRA lane (0 = base model);
        #   resolved by Engine.submit against its adapter registry
        self.generated = []          # ints, appended by the engine
        # Streaming sinks: TokenStream consumers attached by the HTTP
        # edge (or any caller).  The lock makes append+fan-out vs
        # attach-with-replay atomic, so a sink attached between two
        # emits sees every token exactly once.  _finish_cbs fire once
        # on completion (adapter unpin, server-side accounting).
        self._sink_lock = threading.Lock()
        self._sinks = []
        self._finish_cbs = []
        self.submitted_at = time.monotonic()
        self.deadline = (self.submitted_at + float(timeout)
                         if timeout is not None else None)
        self.first_token_at = None   # TTFT anchor
        self.finished_at = None
        self.error = None
        self.preemptions = 0         # times evicted mid-stream and
        self._ctx = None             # requeued; the frozen resume
        #   context (prompt + emitted-so-far) a re-admission prefills
        self._fair_charged = False   # weighted-fair cost charged once
        #   at first pop; a preempted requeue must not pay twice
        self._done = threading.Event()

    @property
    def do_sample(self):
        return (self.top_k > 0 or self.temperature != 1.0
                or self.top_p < 1.0)

    @property
    def context(self):
        """Token ids a (re)admission must prefill: the prompt, or —
        after a preemption — the frozen prompt + emitted-so-far
        snapshot, so the resumed stream continues from exactly the
        state the eviction interrupted (frozen at preemption time;
        tokens emitted after resume do not grow it)."""
        return self._ctx if self._ctx is not None else self.prompt

    @property
    def remaining(self):
        """Tokens this request may still emit (its share of queue
        drain work)."""
        return max(self.max_new_tokens - len(self.generated), 0)

    @property
    def cost_tokens(self):
        """Slot work the request still represents: context to prefill
        plus tokens left to decode — the unit of fairness charging,
        backlog estimates, and token buckets."""
        return len(self.context) + self.remaining

    @property
    def sample_seed(self):
        """Effective sampling seed: the submitted seed, or the request
        id when none was given (reproducible across engine restarts
        only for explicit seeds — ids are a process-global counter)."""
        return self.seed if self.seed is not None else self.id

    def seed_words(self):
        """(lo, hi) 32-bit words of the effective seed — the transport
        format of the device sampling key derivation
        (``GPTModel._slot_sample_keys`` folds them back with the
        emitted-token counter)."""
        s = self.sample_seed
        return s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF

    def expired(self, now=None):
        if self.deadline is None:
            return False
        return (time.monotonic() if now is None else now) > self.deadline

    # -- engine side -----------------------------------------------------
    def _emit_token(self, tok):
        """Record one generated token and fan it out to any attached
        streams — atomically, so a stream attaching concurrently
        replays exactly the tokens it will not be fed live."""
        with self._sink_lock:
            self.generated.append(tok)
            idx = len(self.generated) - 1
            for s in self._sinks:
                s.feed(tok, idx)

    def _finish(self, error=None):
        self.error = error
        self.finished_at = time.monotonic()
        with self._sink_lock:
            sinks, self._sinks = self._sinks, []
            cbs, self._finish_cbs = self._finish_cbs, []
        self._done.set()
        for s in sinks:
            s.close(error)
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass  # completion hooks must not mask the result

    # -- caller side -----------------------------------------------------
    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block until the engine finishes this request; returns the
        full id sequence (prompt + generated) as int32 numpy.  Raises
        the engine-recorded error (e.g. RequestTimeout) on failure."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.id}: no result after {timeout}s "
                "(engine not stepping?)")
        if self.error is not None:
            raise self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])

    def __repr__(self):
        state = ("error" if self.error else
                 "done" if self.done() else "pending")
        return (f"Request(id={self.id}, prompt_len={len(self.prompt)}, "
                f"generated={len(self.generated)}, "
                f"priority={self.priority}, tenant={self.tenant!r}, "
                f"{state})")


class RequestQueue:
    """Thread-safe admission queue: strict priority tiers, weighted-
    fair tenant service within a tier, per-request deadlines.

    Ordering = start-time fair queuing (SFQ) over token cost: each
    tenant carries a virtual finish tag; popping serves, within the
    highest backlogged priority tier, the tenant whose virtual START
    (max of the global virtual clock and its own finish tag) is
    smallest, then advances that tenant's tag by ``cost / weight``.
    Equal weights degrade to round-robin by token volume; a tenant
    with weight w gets a w-proportional share of service while
    backlogged and banks nothing while idle (the max() forfeits
    unused virtual time).  Within one tenant+priority lane, order is
    FIFO.  All-default traffic (one tenant, one priority) behaves
    exactly like the old FIFO queue.
    """

    def __init__(self, max_queue=0, weights=None):
        self.max_queue = int(max_queue)  # 0 = unbounded
        self._lock = threading.Lock()
        # priority -> tenant -> deque of requests (FIFO per lane)
        self._tiers = {}
        self._n = 0
        self._backlog = {}  # priority -> queued token total, kept
        #   incrementally: backlog_tokens() runs on the SUBMIT hot
        #   path (deadline shedding), so it must not walk a deep
        #   queue under the lock the engine's admission also needs
        self._weights = dict(weights or {})
        self._vclock = 0.0
        self._vfin = {}   # tenant -> virtual finish tag

    def _weight(self, tenant):
        return float(self._weights.get(tenant, 1.0))

    def _lane(self, req):
        tier = self._tiers.setdefault(req.priority, {})
        return tier.setdefault(req.tenant, deque())

    def _prune(self, pri, tenant):
        tier = self._tiers.get(pri)
        if tier is None:
            return
        lane = tier.get(tenant)
        if lane is not None and not lane:
            del tier[tenant]
        if not tier:
            del self._tiers[pri]

    def _add_backlog_locked(self, req):
        # cost is frozen while queued (generated only grows in a
        # slot), so charge once on entry and release the SAME number
        # on exit — _queued_cost remembers it across the stay
        req._queued_cost = req.cost_tokens
        self._backlog[req.priority] = (
            self._backlog.get(req.priority, 0) + req._queued_cost)

    def _sub_backlog_locked(self, req):
        left = (self._backlog.get(req.priority, 0)
                - getattr(req, "_queued_cost", 0))
        if left > 0:
            self._backlog[req.priority] = left
        else:
            self._backlog.pop(req.priority, None)

    def put(self, req):
        with self._lock:
            if self.max_queue and self._n >= self.max_queue:
                raise QueueFull(
                    f"admission queue full ({self.max_queue}); request "
                    f"{req.id} shed at the edge")
            self._lane(req).append(req)
            self._n += 1
            self._add_backlog_locked(req)

    def requeue(self, req):
        """Return a popped request to the HEAD of its own lane — the
        gate-declined and PREEMPTION paths (the request already held a
        queue place, so this is exempt from max_queue; its fairness
        cost stays charged, so a resumed request is not billed twice).
        """
        with self._lock:
            self._lane(req).appendleft(req)
            self._n += 1
            self._add_backlog_locked(req)

    # old name, same contract (scheduler gate-decline path)
    push_front = requeue

    def _select_locked(self):
        """(pri, tenant, lane) of the next lane to serve, or None."""
        if not self._tiers:
            return None
        pri = max(self._tiers)
        tier = self._tiers[pri]
        best = None
        for tenant, lane in tier.items():
            if not lane:
                continue
            start = max(self._vclock, self._vfin.get(tenant, 0.0))
            key = (start, tenant)
            if best is None or key < best[0]:
                best = (key, tenant, lane, start)
        if best is None:
            # empty lanes only (pruned lazily): drop and retry
            self._tiers.pop(pri)
            return self._select_locked()
        _, tenant, lane, start = best
        return pri, tenant, lane, start

    def _charge_locked(self, req, start):
        self._vclock = start
        if not req._fair_charged:
            req._fair_charged = True
            self._vfin[req.tenant] = start + (req.cost_tokens
                                              / self._weight(req.tenant))
        self._prune_vfin_locked()

    def _prune_vfin_locked(self):
        """Bound the finish-tag map: tenant names arrive from the
        network edge, so it must not grow with every name ever seen.
        A tag is droppable once its tenant has nothing queued and the
        tag sits at or behind the virtual clock — ``max(vclock, tag)``
        would reproduce it as ``vclock`` anyway, so dropping it
        changes no scheduling decision."""
        if len(self._vfin) <= 128:
            return
        queued = set()
        for tier in self._tiers.values():
            queued.update(tier)
        for t in [t for t, v in self._vfin.items()
                  if t not in queued and v <= self._vclock]:
            del self._vfin[t]
        if len(self._vfin) > 256:
            # drive-by regime (a flood of one-shot tenant names can
            # stall the virtual clock, so the tag-behind-clock rule
            # above never fires): drop EVERY idle tenant's tag.  An
            # idle flow resetting its tag is standard SFQ semantics —
            # it forfeits banked debt exactly like it forfeits banked
            # credit — and a backlogged tenant is never touched.
            for t in [t for t in self._vfin if t not in queued]:
                del self._vfin[t]

    def pop_ready(self, now=None):
        """Pop the next request in service order that has not expired;
        expired requests are failed in place (RequestTimeout) and
        returned via the second element so the caller can count them.

        Returns (request | None, list_of_timed_out_requests).
        """
        now = time.monotonic() if now is None else now
        timed_out = []
        with self._lock:
            while True:
                sel = self._select_locked()
                if sel is None:
                    return None, timed_out
                pri, tenant, lane, start = sel
                req = lane.popleft()
                self._n -= 1
                self._sub_backlog_locked(req)
                self._prune(pri, tenant)
                if req.expired(now):
                    req._finish(RequestTimeout(
                        f"request {req.id} spent "
                        f"{now - req.submitted_at:.3f}s queued, over "
                        f"its "
                        f"{req.deadline - req.submitted_at:.3f}s "
                        "timeout"))
                    timed_out.append(req)
                    continue
                self._charge_locked(req, start)
                return req, timed_out

    def expire(self, now=None):
        """Sweep out every expired request (full-pool case: nothing is
        being popped, but deadlines must still fire).  Returns the
        timed-out requests, already failed."""
        now = time.monotonic() if now is None else now
        timed_out = []
        with self._lock:
            for pri, tier in list(self._tiers.items()):
                for tenant, lane in list(tier.items()):
                    live = deque(r for r in lane if not r.expired(now))
                    timed_out.extend(r for r in lane if r.expired(now))
                    if live:
                        tier[tenant] = live
                    else:
                        del tier[tenant]
                if not tier:
                    del self._tiers[pri]
            self._n -= len(timed_out)
            for req in timed_out:
                self._sub_backlog_locked(req)
        for req in timed_out:
            req._finish(RequestTimeout(
                f"request {req.id} spent {now - req.submitted_at:.3f}s "
                f"queued, over its "
                f"{req.deadline - req.submitted_at:.3f}s timeout"))
        return timed_out

    def depth(self):
        with self._lock:
            return self._n

    def best_priority(self):
        """Highest priority among queued requests (None when empty) —
        the engine's preemption probe."""
        with self._lock:
            return max(self._tiers) if self._tiers else None

    def backlog_tokens(self, min_priority=None):
        """Queued work in tokens (context + remaining decode), summed
        over requests at ``min_priority`` or above (all when None) —
        the deadline-shedding drain estimate's numerator.  O(distinct
        priorities), not O(depth): the totals are kept incrementally
        so the submit hot path never walks a deep queue under the
        lock the engine's admission needs."""
        with self._lock:
            return sum(v for pri, v in self._backlog.items()
                       if min_priority is None or pri >= min_priority)

    def pending(self):
        """Snapshot of the queued requests in approximate service
        order — priority tiers descending, tenants grouped, FIFO
        within a lane (the ``/debug/requests`` surface; the queue
        keeps its entries)."""
        with self._lock:
            out = []
            for pri in sorted(self._tiers, reverse=True):
                for tenant in sorted(self._tiers[pri]):
                    out.extend(self._tiers[pri][tenant])
        return out

    def drain(self, error=None):
        """Fail every queued request (engine shutdown)."""
        with self._lock:
            pending = [r for pri in self._tiers
                       for lane in self._tiers[pri].values()
                       for r in lane]
            self._tiers = {}
            self._n = 0
            self._backlog = {}
        for req in pending:
            req._finish(error or RuntimeError("engine stopped"))
        return pending
