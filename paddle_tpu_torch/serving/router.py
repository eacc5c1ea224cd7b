"""Resilient multi-replica router: the scale-OUT half of serving (a
copy of ``paddle_tpu/serving/router.py``; ``InProcessReplica`` drives
the port's ``Engine``).

One ``Engine`` scales up (paged KV, chunked prefill, speculation,
async ticks); this module scales out: a ``Router`` owns a REGISTRY of
engine replicas, probes each one's health on a jittered interval, and
spreads traffic over the live ones.  At fleet scale a replica being
slow, draining, or dead is the steady state, not the exception — so
robustness is the design center, not an afterthought:

* **Prefix-affinity routing.**  The first ``kv_block_size``-aligned
  span of the prompt is hashed (``affinity_key``) and mapped to a
  replica by highest-random-weight (rendezvous) hashing — shared
  system prompts land on the replica whose prefix cache already holds
  their blocks, and replica churn only remaps the keys that touched
  the changed replica.  When the affinity target is sick, breaker-
  open, or its probed ``queue_depth`` crosses a threshold, the pick
  falls back to LEAST-LOADED over the healthy set.

* **Health-probed registry.**  ``probe_once()`` (or the background
  prober ``start()`` runs) hits every replica's ``/healthz``-shaped
  probe and classifies it ``healthy`` / ``degraded`` / ``draining`` /
  ``dead``: one failed probe degrades, ``dead_after`` consecutive
  failures kill, a replica reporting ``draining`` stops receiving new
  requests (mirroring ``Engine.stop(drain=True)`` — it is finishing,
  not dying), and a ``watchdog_fired`` replica is degraded until its
  next clean probe.  Probes also double as the circuit breaker's
  half-open trial: a clean probe against an OPEN breaker re-admits
  real traffic through half-open.

* **Retry / hedge / circuit-break.**  Submit-side failures are
  CLASSIFIED: connection refused, black-hole timeouts (idempotent
  requests only — a lost response may mean executed work), 5xx, and
  probe-declared-dead replicas retry with exponential backoff + seeded
  jitter, honoring a 503's computed ``Retry-After``; 4xx never retry.
  Each replica carries a ``CircuitBreaker`` (consecutive-failure trip
  -> OPEN; after a cooldown, HALF_OPEN admits one trial request whose
  outcome closes or re-opens it).  Optional tail-latency HEDGING for
  idempotent requests dispatches a second copy to the next-best
  replica after a p99-derived delay; the first winner cancels the
  loser.

* **Failover with context.**  A mid-body disconnect carries the
  tokens already received: a GREEDY request resumes on another replica
  with ``prompt + emitted`` as its context (the resumed stream is
  token-identical to the uninterrupted one); sampled requests restart
  from scratch (a seeded stream re-drawn from token 0 is identical —
  resuming mid-stream would shift the device sampling counter).  A
  request still QUEUED on a replica the prober declares dead is
  abandoned and re-routed without losing anything.  Either way each
  logical request is delivered exactly once — orphaned work on a
  half-dead replica is discarded, never double-served.

* **KV block migration & disaggregated prefill/decode.**  Replicas
  advertise a ROLE (``prefill`` / ``decode`` / ``mixed``) in their
  probes.  With ``RouterPolicy(disaggregate=True)`` a new prompt is
  chunked-prefilled on a prefill-role replica, its warm KV blocks are
  exported block-granular and imported into a decode-role replica,
  and the stream finishes there — token-identical to a single mixed
  replica serving it whole.  ``rebalance()`` preempts a LIVE stream
  off a hot replica the same way: the victim's blocked waiter catches
  the migration payload (``StreamMigrated``) and the router re-lands
  it on a peer — the same logical request continues, delivered
  exactly once.  On an affinity miss, ``prefix_warm=True`` pulls the
  affinity target's cached prefix blocks into the chosen replica
  before dispatching (cross-replica prefix warming).  The
  ``migrate_export`` / ``migrate_import`` transport ops carry the
  ``migrate_wire`` fault site on the same per-replica operation
  counter as the ``net_*`` sites — a seeded wire loss mid-migration
  replays exactly like every other injected fault.

Everything is observable: ``route.pick`` / ``route.retry`` /
``route.hedge`` / ``probe`` spans in the router's own tracer,
``router.*`` metrics (retries, failovers, hedges, affinity hits,
per-replica health and breaker-state gauges) in the monitor registry,
and a bounded structured ``route_log()`` whose entries are a pure
function of the seed + the replica fault schedule — seeded chaos
storms replay the same routing decisions (tests assert it).

* **Model routing & token streaming.**  Replicas advertise their
  loaded LoRA adapter inventory (``adapters``) in probes;
  ``generate(model=...)`` restricts the pick to replicas serving that
  adapter (``UnknownModel`` — the front door's 404 — when nobody
  does).  ``generate(on_token=...)`` streams: the transport forwards
  each token the moment the replica emits it, hedging is disabled
  (two live streams cannot both win), and a mid-stream failover
  resumes on a peer with the continuation SPLICED into the same
  callback — every global token index is delivered exactly once even
  across disconnects and migrations.

Transports: ``HttpReplicaClient`` speaks to a real ``serving.httpd``
endpoint; ``InProcessReplica`` wraps a local ``Engine`` directly (the
tier-1 test / bench / single-host fleet transport) and threads the
``net_*`` fault sites of ``serving.faults`` through its own
deterministic per-replica operation counter.  ``serving.routerd``
puts an HTTP front door on the router itself.
"""
from __future__ import annotations

import hashlib
import itertools
import threading
import time
from collections import deque

from .. import monitor
from .faults import NetDisconnect, NetRefused, NetTimeout
from .kvcache import KVDtypeMismatch
from .lora import UnknownAdapter
from .request import Rejected
from .stream import TokenStream, parse_sse

# -- replica health states (the probe classifier's vocabulary) ----------
HEALTHY = "healthy"      # probing clean; full routing weight
DEGRADED = "degraded"    # one failed probe / watchdog_fired: routable
#   only when no healthy replica can take the request
DRAINING = "draining"    # replica reported draining (stop(drain=True)
#   in progress): finishing its streams, gets NO new requests
DEAD = "dead"            # dead_after consecutive probe failures: not
#   routable; in-flight waiters abandon and fail over

# numeric codes for the per-replica health gauge (alert on < 3)
HEALTH_CODE = {DEAD: 0, DRAINING: 1, DEGRADED: 2, HEALTHY: 3}

# circuit breaker states + gauge codes (alert on > 0)
CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"
BREAKER_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class RouterError(RuntimeError):
    """Base of router-side request failures."""


class NoReplicasAvailable(RouterError):
    """Every registered replica is dead, draining, or breaker-open."""


class UnknownModel(RouterError):
    """``generate(model=...)`` named an adapter NO registered replica
    advertises in its probed inventory — the caller's fault (the HTTP
    front door maps it to 404 ``{"reason": "unknown_adapter"}``),
    never retried."""


class RequestFailed(RouterError):
    """The request exhausted its retries (or hit a non-retryable
    replica error); ``cause`` is the last replica-side exception."""

    def __init__(self, msg, cause=None):
        super().__init__(msg)
        self.cause = cause


class ReplicaUnavailable(RuntimeError):
    """Replica-side load shed (HTTP 503/429 shaped): retryable, with
    the replica's own computed ``retry_after`` honored by the backoff.
    """

    def __init__(self, msg, status=503, retry_after=None, reason=None):
        super().__init__(msg)
        self.status = int(status)
        self.retry_after = retry_after
        self.reason = reason


class ReplicaHTTPError(RuntimeError):
    """Non-shed replica HTTP error; 4xx are the CALLER's fault and
    never retried, 5xx retry."""

    def __init__(self, msg, status, reason=None):
        super().__init__(msg)
        self.status = int(status)
        self.reason = reason


class ReplicaAbandoned(RuntimeError):
    """The transport abandoned a QUEUED-BUT-UNSTARTED request because
    the prober declared its replica dead (or the router is stopping):
    nothing was emitted, so the failover re-dispatches it whole."""


class StreamMigrated(RuntimeError):
    """The replica MIGRATED this stream out mid-decode (a rebalance
    landed on it): ``payload`` is the block-granular KV + resume
    snapshot the router re-lands on a peer, ``emitted`` is everything
    the stream had produced (the salvage fallback when no peer will
    take the payload).  NOT a failure — the replica did exactly what
    it was told."""

    def __init__(self, msg, payload=None, emitted=None):
        super().__init__(msg)
        self.payload = payload
        self.emitted = [int(t) for t in (emitted or [])]


def affinity_key(prompt, block_size):
    """Stable hash of the first ``block_size``-aligned span of the
    prompt — the prefix-cache granularity: two prompts sharing their
    aligned head (a system prompt) hash equal and route together,
    landing on the replica whose ``PrefixCache`` holds those blocks.
    Prompts shorter than one block hash whole (they still benefit from
    co-locating identical short prompts)."""
    ids = [int(t) for t in prompt]
    bs = max(int(block_size), 1)
    n = (len(ids) // bs) * bs
    span = ids[:n] if n else ids
    return hashlib.blake2b(",".join(map(str, span)).encode(),
                           digest_size=16).digest()


def _u01(seed, *parts):
    """Deterministic uniform draw in [0, 1) from (seed, parts) — the
    same blake2b construction as faults.FaultInjector, so every jitter
    the router applies (backoff spread, probe stagger, random-routing
    picks) is a pure function of its seed."""
    h = hashlib.blake2b(
        ":".join(str(p) for p in (seed,) + parts).encode(),
        digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class CircuitBreaker:
    """Per-replica circuit breaker.

    CLOSED counts consecutive failures; ``threshold`` of them TRIP to
    OPEN (all traffic skips the replica).  After ``cooldown_s`` the
    next admission probe moves to HALF_OPEN, which admits exactly ONE
    trial request: success closes the breaker, failure re-opens it
    (fresh cooldown).  A clean HEALTH PROBE against an elapsed OPEN
    breaker also moves it to HALF_OPEN — probe-driven recovery, so a
    replica that came back is re-admitted even with no traffic to
    spend on trials.  Thread-safe; ``on_transition`` (state str) fires
    outside the decision itself but under the breaker lock, so
    transition ORDER is exact."""

    def __init__(self, threshold=3, cooldown_s=1.0, on_transition=None):
        self.threshold = max(int(threshold), 1)
        self.cooldown_s = float(cooldown_s)
        self.state = CLOSED
        self.failures = 0          # consecutive, CLOSED state only
        self.opened_at = None
        self.trips = 0
        self._trial_inflight = False
        self._lock = threading.Lock()
        self._on_transition = on_transition

    def _set(self, state, now=None):
        if state == self.state:
            return
        self.state = state
        if state == OPEN:
            self.opened_at = time.monotonic() if now is None else now
            self.trips += 1
        if self._on_transition is not None:
            self._on_transition(state)

    def _cooled(self, now):
        return (self.opened_at is None
                or now - self.opened_at >= self.cooldown_s)

    def peek(self, now=None):
        """Would a request be admitted right now? (pure — no
        half-open slot is consumed)"""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                return self._cooled(now)
            return not self._trial_inflight  # HALF_OPEN: one trial

    def acquire(self, now=None):
        """Admit a request (consumes the half-open trial slot when in
        recovery).  Returns False when the breaker blocks it."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == CLOSED:
                return True
            if self.state == OPEN:
                if not self._cooled(now):
                    return False
                self._set(HALF_OPEN, now)
            if self._trial_inflight:
                return False
            self._trial_inflight = True
            return True

    def record_success(self):
        with self._lock:
            self.failures = 0
            self._trial_inflight = False
            if self.state != CLOSED:
                self._set(CLOSED)

    def record_failure(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trial_inflight = False
            if self.state == HALF_OPEN:
                self._set(OPEN, now)   # failed trial: fresh cooldown
                return
            self.failures += 1
            if self.state == CLOSED and self.failures >= self.threshold:
                self._set(OPEN, now)

    def release_trial(self):
        """Hand back an admitted HALF_OPEN trial slot without judging
        the replica: the attempt was cancelled by the ROUTER (hedge
        loser, shutdown), so its outcome says nothing — the next
        request becomes the trial instead of the state wedging."""
        with self._lock:
            self._trial_inflight = False

    def on_probe_success(self, now=None):
        """A clean health probe: if the breaker is OPEN and cooled,
        move to HALF_OPEN so the next real request is the trial —
        probe-driven recovery (an idle replica would otherwise stay
        tripped forever)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state == OPEN and self._cooled(now):
                self._set(HALF_OPEN, now)


class RouterPolicy:
    """Router tuning knobs (every default is production-shaped; tests
    shrink the time constants).

    probe_interval_s / probe_jitter : background prober period and its
        +/- fractional seeded jitter (probes from N routers must not
        synchronize into thundering herds).
    dead_after : consecutive failed probes before a replica is DEAD
        (the first failure only degrades it).
    retry_max : re-dispatch attempts after the first (so a request
        touches at most ``retry_max + 1`` replicas).
    backoff_base_s / backoff_cap_s / backoff_jitter : exponential
        backoff ``min(cap, base * 2^n)`` with +/- ``jitter`` fraction
        of seeded spread; a replica's ``Retry-After`` hint raises the
        wait when larger.  Failovers off a DEAD replica skip the
        backoff — the work is not failing, the host is.
    hedge / hedge_after_s : tail-latency hedging for IDEMPOTENT
        requests (greedy, or explicitly seeded).  ``None`` derives the
        delay from the router's own request-latency p99 (falling back
        to ``hedge_floor_s`` until enough samples exist).
    breaker_threshold / breaker_cooldown_s : CircuitBreaker knobs.
    affinity : True = prefix-affinity with least-loaded fallback;
        False = seeded RANDOM routing (the bench's baseline arm).
    affinity_queue_threshold : probed queue_depth beyond which the
        affinity target is considered overloaded and the pick falls
        back to least-loaded (cache locality must not create a hot
        shard).
    disaggregate : route each NEW prompt through a prefill-role
        replica (chunked prefill + first token), migrate its warm KV
        blocks to a decode-role replica, and finish the stream there.
        Fleets with no prefill/decode split fall back to normal
        routing per-request — the knob degrades, it never strands.
    prefix_warm : on an affinity MISS, pull the affinity target's
        cached prefix blocks into the chosen replica before
        dispatching (cross-replica prefix warming; best-effort).
    request_timeout_s : per-attempt transport timeout.
    seed : the determinism root for every jitter draw.
    """

    def __init__(self, probe_interval_s=1.0, probe_jitter=0.5,
                 dead_after=3, retry_max=3, backoff_base_s=0.05,
                 backoff_cap_s=2.0, backoff_jitter=0.5, hedge=False,
                 hedge_after_s=None, hedge_floor_s=0.1,
                 breaker_threshold=3, breaker_cooldown_s=1.0,
                 affinity=True, affinity_queue_threshold=8,
                 disaggregate=False, prefix_warm=False,
                 request_timeout_s=60.0, seed=0):
        if dead_after < 1:
            raise ValueError(f"dead_after must be >= 1, got {dead_after}")
        if retry_max < 0:
            raise ValueError(f"retry_max must be >= 0, got {retry_max}")
        if breaker_cooldown_s < 0:
            raise ValueError("breaker_cooldown_s must be >= 0, got "
                             f"{breaker_cooldown_s}")
        self.probe_interval_s = float(probe_interval_s)
        self.probe_jitter = float(probe_jitter)
        self.dead_after = int(dead_after)
        self.retry_max = int(retry_max)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.backoff_jitter = float(backoff_jitter)
        self.hedge = bool(hedge)
        self.hedge_after_s = hedge_after_s
        self.hedge_floor_s = float(hedge_floor_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.affinity = bool(affinity)
        self.affinity_queue_threshold = int(affinity_queue_threshold)
        self.disaggregate = bool(disaggregate)
        self.prefix_warm = bool(prefix_warm)
        self.request_timeout_s = float(request_timeout_s)
        self.seed = int(seed)


class Replica:
    """One registry entry: transport client + probed state + breaker.
    ``signals`` is the latest probe's load view (queue_depth,
    slots_free, kv_blocks_free, drain_rate_tps, ...)."""

    def __init__(self, name, client, breaker):
        self.name = str(name)
        self.client = client
        self.breaker = breaker
        self.state = HEALTHY     # optimistic until the first probe —
        #   a router must route before its prober's first sweep
        self.signals = {}
        self.probe_failures = 0  # consecutive
        self.last_probe_at = None
        self.incarnation = None  # supervisor restart generation from
        #   the last applied probe: a LOWER probe is a stale read from
        #   a dead predecessor on the same URL and is discarded; a
        #   HIGHER one resets breaker + health history atomically
        self.inflight = 0        # guarded: handler + hedge threads
        self._inflight_lock = threading.Lock()

    def track(self, delta):
        with self._inflight_lock:
            self.inflight += delta

    @property
    def role(self):
        """Probed serving role: ``prefill`` / ``decode`` / ``mixed``.
        Unprobed replicas default to mixed — routable everywhere, so
        a fleet with no role split behaves exactly as before."""
        return self.signals.get("role") or "mixed"

    def load_key(self):
        """Least-loaded ordering: probed queue depth first, then the
        fewest free slots LAST (more headroom wins), name as the
        deterministic tiebreak."""
        q = self.signals.get("queue_depth")
        free = self.signals.get("slots_free")
        return (q if q is not None else 0,
                -(free if free is not None else 0), self.name)

    def view(self):
        """JSON-shaped registry row (the routerd /replicas surface)."""
        return {
            "name": self.name, "state": self.state, "role": self.role,
            "breaker": self.breaker.state,
            "breaker_trips": self.breaker.trips,
            "probe_failures": self.probe_failures,
            "incarnation": self.incarnation,
            "inflight": self.inflight,
            "address": getattr(self.client, "address", None),
            "signals": dict(self.signals),
        }


class Router:
    """Front-door tier spreading requests over N engine replicas with
    health probing, prefix affinity, retries, hedging, circuit
    breaking, and failover (module docstring has the full story).

    Parameters
    ----------
    replicas : dict name -> client, or iterable of (name, client).  A
        client implements ``probe() -> dict`` (a ``/healthz``-shaped
        health+load view) and ``generate(payload, should_abort=None)
        -> dict`` raising the classified transport errors
        (NetRefused/NetTimeout/NetDisconnect, ReplicaUnavailable,
        ReplicaHTTPError, ReplicaAbandoned).
    policy : RouterPolicy.
    kv_block_size : the affinity hash alignment.  None adopts the
        first probed replica's ``kv_block_size`` (falling back to 16)
        — the router should agree with the fleet's prefix-cache
        granularity without being told twice.
    registry : monitor.StatRegistry (default: the process default).
    tracing : keep a router-side span tracer (route.pick/route.retry/
        route.hedge/probe + request lifecycle instants).
    """

    def __init__(self, replicas=None, policy=None, kv_block_size=None,
                 registry=None, tracing=True, trace_capacity=16384):
        self.policy = policy or RouterPolicy()
        self._kv_bs = (None if kv_block_size is None
                       else int(kv_block_size))
        self.registry = registry or monitor.default_registry()
        self.tracer = (monitor.Tracer(capacity=trace_capacity)
                       if tracing else monitor.NullTracer())
        self._lock = threading.Lock()
        self._replicas = {}
        self._rids = itertools.count()
        self._probe_no = itertools.count()
        self.log = deque(maxlen=4096)   # structured routing decisions;
        #   entry ORDER is deterministic for sequential traffic, and
        #   per-request subsequences are deterministic always
        self._stopping = False
        self._probe_thread = None
        self._probe_stop = threading.Event()
        reg = self.registry
        self._m_reqs = reg.counter(
            "router.requests_total", "requests accepted by the router")
        self._m_served = reg.counter(
            "router.served_total", "requests completed and delivered")
        self._m_failed = reg.counter(
            "router.failed_total", "requests failed after classification")
        self._m_retries = reg.counter(
            "router.retries_total", "re-dispatch attempts (all causes)")
        self._m_failovers = reg.counter(
            "router.failovers_total",
            "re-dispatches caused by a dying/dead replica (abandoned "
            "queued requests + mid-stream disconnects)")
        self._m_hedges = reg.counter(
            "router.hedges_total", "hedge dispatches armed and fired")
        self._m_hedge_wins = reg.counter(
            "router.hedge_wins_total",
            "requests where the hedge finished before the primary")
        self._m_picks = reg.counter(
            "router.picks_total", "routing decisions made")
        self._m_affinity = reg.counter(
            "router.affinity_hits_total",
            "picks that landed on the prefix-affinity target")
        self._m_breaker_trips = reg.counter(
            "router.breaker_trips_total",
            "circuit breakers tripped open (all replicas)")
        self._m_migrations = reg.counter(
            "router.migrations_total",
            "streams moved between replicas by KV block migration "
            "(disaggregated prefill handoffs + rebalance re-lands)")
        self._m_probes = reg.counter(
            "router.probes_total", "health probes sent")
        self._m_lat = reg.histogram(
            "router.request_ms",
            "end-to-end request latency through the router (ms)")
        for name, client in (dict(replicas or {})).items():
            self.add_replica(name, client)

    # -- registry ------------------------------------------------------
    def add_replica(self, name, client):
        name = str(name)
        breaker = CircuitBreaker(
            threshold=self.policy.breaker_threshold,
            cooldown_s=self.policy.breaker_cooldown_s,
            on_transition=lambda st, n=name: self._breaker_event(n, st))
        rep = Replica(name, client, breaker)
        with self._lock:
            if name in self._replicas:
                raise ValueError(f"replica {name!r} already registered")
            self._replicas[name] = rep
        self._gauge_health(rep)
        self._gauge_breaker(name, CLOSED)
        return rep

    def remove_replica(self, name):
        with self._lock:
            rep = self._replicas.pop(str(name), None)
        return rep

    def replicas(self):
        """Registry snapshot: list of ``Replica.view()`` rows."""
        with self._lock:
            reps = list(self._replicas.values())
        return [r.view() for r in reps]

    def _reps(self):
        with self._lock:
            return list(self._replicas.values())

    def _gauge_health(self, rep):
        self.registry.gauge(
            f"router.replica_health.{rep.name}",
            "replica health (0 dead / 1 draining / 2 degraded / "
            "3 healthy)").set(HEALTH_CODE[rep.state])

    def _gauge_breaker(self, name, state):
        self.registry.gauge(
            f"router.breaker_state.{name}",
            "circuit breaker (0 closed / 1 half-open / 2 open)"
        ).set(BREAKER_CODE[state])

    def _breaker_event(self, name, state):
        self._gauge_breaker(name, state)
        if state == OPEN:
            self._m_breaker_trips.inc()
        self.log.append(("breaker", name, state))
        self.tracer.instant("router.breaker", cat="router",
                            replica=name, state=state)

    # -- health probing ------------------------------------------------
    def _probe_is_stale(self, rep, info):
        """True when a probe body carries a LOWER incarnation than the
        registry already applied for this replica — a read that left
        the dead predecessor before it died, arriving after the
        supervisor already respawned a successor on the same URL.
        Applying it would poison the successor's state."""
        inc = info.get("incarnation")
        if inc is None or rep.incarnation is None:
            return False
        if int(inc) >= rep.incarnation:
            return False
        self.log.append(("stale_probe", rep.name, int(inc)))
        self.tracer.instant("router.stale_probe", cat="router",
                            replica=rep.name, incarnation=int(inc),
                            current=rep.incarnation)
        return True

    def _apply_incarnation(self, rep, inc):
        """Record a probed incarnation.  A replica returning on the
        same URL as a NEW incarnation gets its circuit breaker and
        health history reset ATOMICALLY — a fresh CircuitBreaker is
        swapped in (attribute assignment: atomic under the GIL), so
        the successor starts CLOSED with zero failures instead of
        inheriting half-open/open state, while in-flight attempts
        still hold the predecessor's breaker object and their stale
        failures land there harmlessly."""
        if rep.incarnation is not None and inc > rep.incarnation:
            rep.breaker = CircuitBreaker(
                threshold=self.policy.breaker_threshold,
                cooldown_s=self.policy.breaker_cooldown_s,
                on_transition=lambda st, n=rep.name:
                    self._breaker_event(n, st))
            rep.probe_failures = 0
            self._gauge_breaker(rep.name, CLOSED)
            self.log.append(("incarnation", rep.name, inc))
            self.tracer.instant("router.incarnation", cat="router",
                                replica=rep.name, incarnation=inc)
        if rep.incarnation != inc:
            rep.incarnation = inc
            self.registry.gauge(
                f"router.replica_incarnation.{rep.name}",
                "supervisor restart generation from the last applied "
                "probe").set(inc)

    def classify_probe(self, info):
        """Map a ``/healthz``-shaped probe body to a health state —
        the liveness/readiness split made routable: ``draining`` is
        FINISHING (stop routing, let it land its streams),
        ``watchdog_fired`` is possibly WEDGED (degrade until a clean
        probe), anything else answering at all is healthy."""
        if info.get("draining") or info.get("state") == DRAINING:
            # InProcessReplica reports a "draining" bool; httpd's
            # /healthz reports it via "state" — both mean FINISHING
            return DRAINING
        if info.get("watchdog_fired") or info.get("state") == \
                "watchdog_fired" or info.get("ready") is False:
            return DEGRADED
        return HEALTHY

    def probe_once(self, now=None):
        """One sweep: probe every replica, update state + signals +
        gauges.  Returns {name: state}.  Probes are SENT concurrently
        — one hung replica must not head-of-line block health
        detection for the whole fleet — but results are APPLIED
        serially in registry order, so the state transitions and the
        routing log stay deterministic given the probe outcomes.
        Deterministic tests call this directly; production runs it on
        the jittered prober thread."""
        reps = self._reps()
        results = [None] * len(reps)

        def _probe(i, rep):
            try:
                results[i] = (True, rep.client.probe())
            except Exception as e:
                results[i] = (False, e)

        if len(reps) == 1:
            _probe(0, reps[0])
        else:
            threads = [threading.Thread(target=_probe, args=(i, rep),
                                        daemon=True)
                       for i, rep in enumerate(reps)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        out = {}
        for rep, (answered, info) in zip(reps, results):
            self._m_probes.inc()
            with self.tracer.span("probe", cat="router",
                                  replica=rep.name) as sp:
                if not answered:
                    rep.probe_failures += 1
                    new = (DEAD if rep.probe_failures
                           >= self.policy.dead_after else DEGRADED)
                    if sp is not None and hasattr(sp, "args"):
                        sp.args["error"] = type(info).__name__
                elif self._probe_is_stale(rep, info):
                    # a probe stamped with a LOWER incarnation is the
                    # dead predecessor's last answer arriving late on
                    # the same URL: discard it WHOLE — state, signals
                    # and breaker stay the successor's
                    new = rep.state
                else:
                    inc = info.get("incarnation")
                    if inc is not None:
                        self._apply_incarnation(rep, int(inc))
                    rep.probe_failures = 0
                    rep.signals.update(
                        {k: info.get(k) for k in
                         ("queue_depth", "slots_free",
                          "kv_blocks_free", "drain_rate_tps",
                          "slots_total", "kv_block_size",
                          # mesh-sharded replicas advertise their
                          # full (mp, dp) shape: the /replicas
                          # registry rows (and timeline.py --router)
                          # label sharded replicas without a second
                          # probe protocol
                          "mesh_shape", "mp", "dp",
                          # quantized serving: dtype labels + block
                          # byte split, so migration can pre-filter
                          # kv_dtype-mismatched peers from the
                          # registry instead of burning an import
                          # round-trip on a guaranteed 400
                          "weight_dtype", "kv_dtype",
                          "kv_block_bytes", "kv_scale_bytes",
                          # disaggregated fleets advertise each
                          # replica's serving role the same way,
                          # and supervised ones their restart
                          # generation
                          "role", "incarnation",
                          # multi-LoRA serving: the adapter inventory
                          # is what pick(model=...) routes on, and
                          # live stream counts label the fleet in
                          # timeline.py --router
                          "adapters", "streams_active",
                          # kernel variant + long-context exposure:
                          # which ragged kernel body the replica
                          # serves (stream vs gather A/B) and the max
                          # context length it has actually reached
                          "attn_impl", "max_context_len",
                          # host-RAM offload tier: how much warm KV a
                          # replica holds PAST its device pool — the
                          # warmth prefix_warm taps before recompute
                          "kv_host_blocks", "kv_host_bytes",
                          "kv_host_capacity_mb",
                          "offload_hit_tokens_total")})
                    if self._kv_bs is None \
                            and info.get("kv_block_size"):
                        self._kv_bs = int(info["kv_block_size"])
                    new = self.classify_probe(info)
                    # probe-driven breaker recovery: the replica
                    # answers again, so an elapsed OPEN breaker may
                    # move to HALF_OPEN and trial real traffic
                    if new in (HEALTHY, DEGRADED):
                        rep.breaker.on_probe_success()
                if sp is not None and hasattr(sp, "args"):
                    sp.args["state"] = new
            rep.last_probe_at = time.monotonic() if now is None else now
            if new != rep.state:
                self.log.append(("probe", rep.name, new))
                self.tracer.instant("router.replica_state",
                                    cat="router", replica=rep.name,
                                    state=new, was=rep.state)
            rep.state = new
            self._gauge_health(rep)
            out[rep.name] = new
        return out

    def mark_dead(self, name):
        """Operator/test override: declare a replica dead NOW (its
        queued-but-unstarted requests abandon and fail over on their
        next poll)."""
        with self._lock:
            rep = self._replicas.get(str(name))
        if rep is None:
            raise KeyError(f"no replica {name!r}")
        if rep.state != DEAD:
            self.log.append(("probe", rep.name, DEAD))
        rep.state = DEAD
        rep.probe_failures = max(rep.probe_failures,
                                 self.policy.dead_after)
        self._gauge_health(rep)

    def start(self):
        """Run the prober on a daemon thread (jittered interval)."""
        if self._probe_thread is not None \
                and self._probe_thread.is_alive():
            return self
        self._stopping = False
        self._probe_stop = threading.Event()
        stop = self._probe_stop

        def loop():
            while not stop.is_set():
                try:
                    self.probe_once()
                except Exception:
                    pass  # the prober must outlive any one bad client
                n = next(self._probe_no)
                j = self.policy.probe_jitter
                scale = 1.0 + j * (_u01(self.policy.seed, "probe", n)
                                   - 0.5)
                stop.wait(self.policy.probe_interval_s * scale)

        self._probe_thread = threading.Thread(
            target=loop, daemon=True,
            name="paddle_tpu_torch-router-prober")
        self._probe_thread.start()
        return self

    def stop(self):
        """Stop the prober and abandon in-flight waits (their
        transports see ``should_abort`` fire)."""
        self._stopping = True
        self._probe_stop.set()
        if self._probe_thread is not None:
            self._probe_thread.join(timeout=5.0)
            self._probe_thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- routing -------------------------------------------------------
    def block_size(self):
        return self._kv_bs or 16

    def _affinity_target(self, key, reps):
        """Rendezvous (HRW) hash: every replica scores the key, the
        max wins — adding/removing a replica only remaps the keys that
        scored it highest, so the fleet's prefix caches stay warm
        through churn."""
        best = None
        for r in reps:
            h = hashlib.blake2b(key + r.name.encode(),
                                digest_size=8).digest()
            score = int.from_bytes(h, "big")
            if best is None or score > best[0]:
                best = (score, r)
        return best[1] if best else None

    def pick(self, prompt, exclude=(), rid=None, attempt=0,
             phase=None, model=None):
        """One routing decision: (replica, how) where how is
        ``affinity`` / ``load`` / ``random`` / ``last_resort``.
        ``phase`` (``prefill`` / ``decode``) restricts the candidate
        set to replicas of that ROLE — exact-role replicas when any
        exist, else role-or-mixed; a phase slice with nothing
        routable falls back to the whole fleet (disaggregation
        degrades before it fails).  ``model`` restricts it to
        replicas whose probed adapter inventory lists that LoRA
        adapter — UnknownModel when NO replica advertises it (the
        fleet genuinely cannot serve it), NoReplicasAvailable when
        some do but none is routable right now (retryable).  Raises
        NoReplicasAvailable when nothing at all is routable."""
        key = affinity_key(prompt, self.block_size())
        exclude = set(exclude)
        reps = self._reps()
        if model is not None:
            have = [r for r in reps
                    if model in (r.signals.get("adapters") or ())]
            if not have:
                raise UnknownModel(
                    f"no replica among {len(reps)} advertises "
                    f"adapter {model!r}")
            reps = have
        if phase is not None:
            exact = [r for r in reps if r.role == phase]
            reps = exact or [r for r in reps
                             if r.role in (phase, "mixed")] or reps
        healthy = [r for r in reps if r.name not in exclude
                   and r.state == HEALTHY and r.breaker.peek()]
        degraded = [r for r in reps if r.name not in exclude
                    and r.state == DEGRADED and r.breaker.peek()]
        pool, how = healthy, None
        if not pool:
            pool, how = degraded, "last_resort"
        if not pool:
            # everything routable was excluded by earlier failed
            # attempts: retrying a suspect replica beats failing the
            # request outright
            pool = [r for r in reps
                    if r.state in (HEALTHY, DEGRADED)
                    and r.breaker.peek()]
            how = "last_resort"
        if not pool:
            if phase is not None:
                # the role slice is unroutable: degrade to whole-
                # fleet routing before failing the request outright
                return self.pick(prompt, exclude, rid, attempt,
                                 model=model)
            raise NoReplicasAvailable(
                f"no routable replica among {len(reps)}: "
                + ", ".join(f"{r.name}={r.state}/{r.breaker.state}"
                            for r in reps))
        if not self.policy.affinity:
            # seeded random (the bench's baseline arm): deterministic
            # per (seed, request, attempt)
            pool = sorted(pool, key=lambda r: r.name)
            idx = int(_u01(self.policy.seed, "random", rid, attempt)
                      * len(pool)) % len(pool)
            return pool[idx], (how or "random")
        target = self._affinity_target(key, reps)
        if how is None and target is not None and target in pool:
            q = target.signals.get("queue_depth")
            if q is None or q <= self.policy.affinity_queue_threshold:
                return target, "affinity"
        chosen = min(pool, key=lambda r: r.load_key())
        return chosen, (how or "load")

    # -- the request path ----------------------------------------------
    def _classify(self, exc, idempotent):
        """(kind, retryable, retry_after, emitted) for a replica-side
        exception — the retry policy's one decision table."""
        if isinstance(exc, ReplicaAbandoned):
            return "abandoned", True, None, None
        if isinstance(exc, NetDisconnect):
            return "disconnect", True, None, exc.emitted
        if isinstance(exc, NetRefused):
            return "refused", True, None, None
        if isinstance(exc, NetTimeout):
            # the request may have EXECUTED (loss on the response
            # path): only idempotent work is blindly re-sent
            return "timeout", idempotent, None, None
        if isinstance(exc, ReplicaUnavailable):
            return "unavailable", True, exc.retry_after, None
        if isinstance(exc, ReplicaHTTPError):
            return (f"http_{exc.status}", exc.status >= 500, None,
                    None)
        return type(exc).__name__, False, None, None

    def _backoff(self, rid, n, hint=None):
        d = min(self.policy.backoff_cap_s,
                self.policy.backoff_base_s * (2.0 ** n))
        j = self.policy.backoff_jitter
        d *= 1.0 + j * (_u01(self.policy.seed, "backoff", rid, n) - 0.5)
        if hint is not None:
            d = max(d, float(hint))
        return d

    def _hedge_delay(self):
        if self.policy.hedge_after_s is not None:
            return float(self.policy.hedge_after_s)
        if self._m_lat.count >= 20:
            return max(self._m_lat.percentile(99) / 1e3,
                       self.policy.hedge_floor_s)
        return self.policy.hedge_floor_s

    def _attempt(self, rep, payload, rid, abort_extra=None,
                 op="generate", on_token=None):
        """One dispatch against one replica: inflight accounting,
        breaker bookkeeping, abandon hook.  ``op`` names the client
        method (``generate`` / ``migrate_export`` /
        ``migrate_import``) — all share the transport contract.
        ``on_token`` (generate only) asks the transport to STREAM:
        it fires per token as the replica emits it."""

        def should_abort():
            return (self._stopping or rep.state == DEAD
                    or (abort_extra is not None and abort_extra()))

        kw = {"should_abort": should_abort}
        if on_token is not None and op == "generate":
            kw["on_token"] = on_token
        rep.track(+1)
        try:
            resp = getattr(rep.client, op)(payload, **kw)
        except Exception as e:
            if self._stopping \
                    or (abort_extra is not None and abort_extra()):
                # a CANCELLED attempt (hedge loser, router shutdown)
                # is the router's own doing — it must not poison the
                # replica's breaker; just hand back any trial slot so
                # a HALF_OPEN breaker cannot wedge
                rep.breaker.release_trial()
            elif isinstance(e, StreamMigrated):
                # a rebalance the ROUTER itself ordered: the replica
                # did exactly what it was told — a health signal
                rep.breaker.record_success()
            elif isinstance(e, ReplicaHTTPError) and e.status < 500:
                # a 4xx is the CALLER's fault and PROVES the replica
                # is answering: a health signal, not a failure — a
                # bad client must not blackball a healthy replica
                rep.breaker.record_success()
            else:
                rep.breaker.record_failure()
            raise
        else:
            rep.breaker.record_success()
            return resp
        finally:
            rep.track(-1)

    def _hedged_attempt(self, rep, payload, rid, prompt, exclude):
        """Primary + optional delayed hedge; first SUCCESS wins and
        cancels the loser (abort flag -> the transport abandons or
        disconnects it; orphaned replica work is discarded).  Returns
        ``(winner, response, hedged)`` — ``hedged`` True when the
        second dispatch actually fired, so "attempts" can keep
        counting DISPATCHES — or raises the primary's error (hedge
        errors never mask a primary success and vice versa)."""
        delay = self._hedge_delay()
        results = {}
        done = threading.Condition()
        cancel = {"primary": False, "hedge": False}

        def run(slot, r, pl):
            try:
                res = self._attempt(r, pl, rid,
                                    abort_extra=lambda: cancel[slot])
            except Exception as e:  # delivered as a value
                res = e
            with done:
                results[slot] = (r, res)
                done.notify_all()

        t1 = threading.Thread(target=run,
                              args=("primary", rep, payload),
                              daemon=True)
        t1.start()
        with done:
            done.wait_for(lambda: "primary" in results, timeout=delay)
        if "primary" not in results:
            try:
                hedge_rep, how = self.pick(
                    prompt, exclude=exclude | {rep.name}, rid=rid,
                    attempt=-1)
            except NoReplicasAvailable:
                hedge_rep = None
            if hedge_rep is not None \
                    and not hedge_rep.breaker.acquire():
                # the hedge must respect the half-open single-trial
                # invariant like any other dispatch; a hedge is never
                # worth racing a recovery trial
                hedge_rep = None
            if hedge_rep is not None:
                self._m_hedges.inc()
                self.log.append(("hedge", rid, hedge_rep.name))
                with self.tracer.span("route.hedge", cat="router",
                                      req=rid, primary=rep.name,
                                      hedge=hedge_rep.name,
                                      delay_ms=round(delay * 1e3, 3)):
                    t2 = threading.Thread(
                        target=run,
                        args=("hedge", hedge_rep, dict(payload)),
                        daemon=True)
                    t2.start()
                    with done:
                        done.wait_for(
                            lambda: self._hedge_settled(results))
                win_slot = self._hedge_winner(results)
                lose_slot = ("hedge" if win_slot == "primary"
                             else "primary")
                cancel[lose_slot] = True
                if win_slot == "hedge":
                    self._m_hedge_wins.inc()
                    self.log.append(
                        ("hedge_win", rid, results["hedge"][0].name))
                r, res = results[win_slot]
                if isinstance(res, Exception):
                    raise res
                return r, res, True
        with done:
            done.wait_for(lambda: "primary" in results)
        r, res = results["primary"]
        if isinstance(res, Exception):
            raise res
        return r, res, False

    @staticmethod
    def _hedge_settled(results):
        """Wait is over once anyone SUCCEEDED or everyone failed."""
        succ = [s for s, (_, res) in results.items()
                if not isinstance(res, Exception)]
        return bool(succ) or len(results) == 2

    @staticmethod
    def _hedge_winner(results):
        succ = [s for s, (_, res) in results.items()
                if not isinstance(res, Exception)]
        if succ:
            # primary wins ties (it was dispatched first)
            return "primary" if "primary" in succ else "hedge"
        return "primary"

    # -- KV block migration ---------------------------------------------
    def _disagg_split(self, exclude):
        """True when the routable fleet (minus ``exclude``) still has
        BOTH a prefill-role and a decode-role replica — the
        precondition for a disaggregated dispatch."""
        roles = {r.role for r in self._reps()
                 if r.name not in exclude
                 and r.state in (HEALTHY, DEGRADED)
                 and r.breaker.peek()}
        return "prefill" in roles and "decode" in roles

    def _import_stream(self, mig_payload, rid, prompt, exclude,
                       timeout_s, phase="decode"):
        """Land a migration payload on a routable replica (decode
        role preferred) and block until the resumed stream completes.
        Returns ``(replica, resp, dispatches)``; ``resp`` is None
        when every candidate refused the payload.  Safe to retry the
        SAME payload across candidates: a failed import adopts
        nothing (the engine rolls its blocks back to refcount 0), and
        a destination that died mid-resume never delivered — re-
        importing replays the identical continuation from the
        migration point, so nothing is duplicated."""
        body = dict(mig_payload)
        body["timeout_s"] = timeout_s
        tried = set(exclude)
        # quantized serving: a peer whose probed kv_dtype disagrees
        # with the payload's would reject the import with a
        # kv_dtype_mismatch 400 anyway — pre-filter it from the
        # candidate set (unknown signals pass: the import's own
        # validation stays the source of truth)
        want_dtype = (mig_payload.get("kv") or {}).get("dtype")
        if want_dtype is not None:
            for r in self._reps():
                have = r.signals.get("kv_dtype")
                if have is not None and str(have) != str(want_dtype):
                    tried.add(r.name)
        n = 0
        for k in range(self.policy.retry_max + 1):
            try:
                with self.tracer.span("route.pick", cat="router",
                                      req=rid, attempt=k,
                                      phase=phase) as sp:
                    rep, how = self.pick(prompt, exclude=tried,
                                         rid=rid, attempt=k,
                                         phase=phase)
                    if not rep.breaker.acquire():
                        raise ReplicaUnavailable(
                            f"{rep.name} breaker trial already in "
                            "flight")
                    if sp is not None and hasattr(sp, "args"):
                        sp.args.update(replica=rep.name, how=how)
            except (NoReplicasAvailable, ReplicaUnavailable):
                break
            self._m_picks.inc()
            self.log.append(("pick", rid, rep.name,
                             f"{phase}/{how}", k))
            n += 1
            try:
                resp = self._attempt(rep, body, rid,
                                     op="migrate_import")
            except Exception as e:
                kind, _, _, _ = self._classify(e, True)
                self.log.append(("failover", rid, rep.name,
                                 f"import_{kind}"))
                self._m_retries.inc()
                tried.add(rep.name)
                continue
            return rep, resp, n
        return None, None, n

    def _disagg_attempt(self, payload, rid, prompt, exclude,
                        emitted_sink):
        """One disaggregated dispatch: chunked prefill + first token
        on a PREFILL-role replica, migrate the warm KV blocks, finish
        the stream on a DECODE-role replica.  Returns ``(served_by,
        resp, dispatches)`` on success or None on failure — the
        caller's normal path then takes over (``exclude`` and the
        greedy ``emitted_sink`` are updated in place, so a resumed
        stream picks up exactly where the wreckage left it)."""
        try:
            with self.tracer.span("route.pick", cat="router", req=rid,
                                  phase="prefill") as sp:
                pre, how = self.pick(prompt, exclude=exclude, rid=rid,
                                     attempt=0, phase="prefill")
                if not pre.breaker.acquire():
                    raise ReplicaUnavailable(
                        f"{pre.name} breaker trial already in flight")
                if sp is not None and hasattr(sp, "args"):
                    sp.args.update(replica=pre.name, how=how)
        except (NoReplicasAvailable, ReplicaUnavailable):
            return None
        self._m_picks.inc()
        if how == "affinity":
            self._m_affinity.inc()
        self.log.append(("pick", rid, pre.name, f"prefill/{how}", 0))
        body = dict(payload)
        body["min_tokens"] = 1
        try:
            res = self._attempt(pre, body, rid, op="migrate_export")
        except Exception as e:
            kind, _, _, got = self._classify(e, True)
            self.log.append(("failover", rid, pre.name,
                             f"export_{kind}"))
            exclude.add(pre.name)
            if got and emitted_sink is not None:
                emitted_sink.extend(int(t) for t in got)
            return None
        gen0 = [int(t) for t in res.get("generated") or []]
        if res.get("completed") or res.get("payload") is None:
            # the stream finished on the prefill replica (EOS inside
            # the budget, or the export declined and it served the
            # request whole): nothing left to migrate
            resp = {k: v for k, v in res.items()
                    if k in ("ttft_ms", "id")}
            resp["generated"] = gen0
            return pre, resp, 1
        mig = res["payload"]
        dec, resp, n = self._import_stream(
            mig, rid, prompt, set(exclude) | {pre.name},
            payload.get("timeout_s"))
        if resp is not None:
            self._m_migrations.inc()
            self.log.append(("migrate", rid, pre.name, dec.name,
                             resp.get("migrated_blocks")))
            self.tracer.instant(
                "route.migrated", cat="router", req=rid,
                source=pre.name, dest=dec.name,
                blocks=resp.get("migrated_blocks"))
            return dec, resp, 1 + n
        # every decode replica refused the payload; the source stream
        # is already terminated, so salvage the prefill tokens — a
        # greedy stream resumes from them on the normal path, a
        # seeded one restarts from scratch (identical either way)
        if gen0 and emitted_sink is not None:
            emitted_sink.extend(gen0)
        exclude.add(pre.name)
        return None

    def _warm_prefix(self, chosen, prompt, rid):
        """Cross-replica prefix warming: on an affinity MISS, pull
        the affinity target's cached prefix blocks for this prompt
        into the replica about to serve it — its chunked prefill then
        skips the warmed span.  Best-effort by design: any failure
        just means a cold prefill."""
        reps = self._reps()
        target = self._affinity_target(
            affinity_key(prompt, self.block_size()), reps)
        if target is None or target is chosen \
                or target.state not in (HEALTHY, DEGRADED):
            return
        try:
            res = target.client.migrate_export(
                {"prefix_only": True,
                 "tokens": [int(t) for t in prompt]})
            payload = res.get("payload")
            if not payload or not payload.get("kv"):
                return
            got = chosen.client.migrate_import(payload)
            # "device" = trie blocks only; "host"/"mixed" = the
            # source's host-RAM offload tier contributed blocks the
            # destination would otherwise have recomputed
            tier = payload.get("tier", "device")
            self.log.append(("warm", rid, target.name, chosen.name,
                             got.get("blocks"), tier))
            self.tracer.instant(
                "route.prefix_warmed", cat="router", req=rid,
                source=target.name, dest=chosen.name,
                blocks=got.get("blocks"), tier=tier)
        except Exception:
            pass

    def rebalance(self, source, request_id=None, min_tokens=1,
                  timeout=10.0):
        """Preempt-and-migrate: export one LIVE stream off ``source``
        (the engine picks its lowest-priority victim when
        ``request_id`` is None), delivering the payload through the
        victim's own blocked waiter — the router thread serving that
        stream catches ``StreamMigrated`` and re-lands it on a peer,
        so the stream moves without ever being double-served.
        In-process transports only: an HTTP replica's waiter is its
        remote client, which the router cannot hand a payload to.
        Returns the export verdict dict."""
        with self._lock:
            rep = self._replicas.get(str(source))
        if rep is None:
            raise KeyError(f"no replica {source!r}")
        body = {"request_id": request_id, "deliver": "error",
                "min_tokens": int(min_tokens),
                "timeout_s": float(timeout)}
        res = rep.client.migrate_export(body)
        self.log.append(("rebalance", source,
                         bool(res.get("completed")),
                         len(res.get("generated") or [])))
        self.tracer.instant("route.rebalance", cat="router",
                            replica=source,
                            completed=bool(res.get("completed")))
        return res

    def generate(self, prompt, max_new_tokens=16, eos_token_id=None,
                 temperature=1.0, top_k=0, top_p=1.0, seed=None,
                 priority=0, tenant=None, timeout=None, model=None,
                 on_token=None):
        """Route one generation request; blocks until a replica
        delivers it (HTTP handler threads are the expected callers —
        the router is I/O-bound, not compute-bound).  Returns a dict:
        ``ids`` (prompt + generated), ``generated``, ``replica`` (the
        serving one), ``attempts``, ``req`` (router-side id), plus the
        replica's reported fields.  Raises RequestFailed /
        NoReplicasAvailable after classification + retries.

        ``model`` routes to replicas advertising that LoRA adapter
        (UnknownModel when none does).  ``on_token`` streams: it
        fires once per generated token, BY GLOBAL INDEX exactly once,
        even across failovers — a resumed greedy stream forwards only
        its continuation, a seeded restart suppresses the re-played
        prefix, and a migrated stream splices the resumed tokens in
        seamlessly.  Streaming disables hedging (two live streams
        cannot both win) and the disaggregated split (its tokens
        arrive via migration responses, not a live stream)."""
        rid = next(self._rids)
        self._m_reqs.inc()
        prompt = [int(t) for t in prompt]
        sent = 0              # tokens DELIVERED to on_token, by index

        def _deliver(toks, base):
            # exactly-once by global token index: forward only the
            # indices the caller has not seen yet (salvaged prefixes
            # and seeded replays are suppressed, gaps are impossible
            # because every source is a contiguous run from its base)
            nonlocal sent
            if on_token is None:
                return
            for i, tok in enumerate(toks):
                g = base + i
                if g >= sent:
                    on_token(int(tok))
                    sent = g + 1
        do_sample = (int(top_k or 0) > 0 or float(temperature) != 1.0
                     or float(top_p) < 1.0)
        idempotent = (not do_sample) or seed is not None
        greedy = not do_sample
        deadline = (None if timeout is None
                    else time.monotonic() + float(timeout))
        self.tracer.instant("route.accepted", cat="router", req=rid,
                            prompt=len(prompt), max_new=max_new_tokens)
        t0 = time.monotonic()
        emitted = []          # tokens salvaged across disconnects
        exclude = set()       # replicas that failed THIS request
        attempt = 0
        last_exc = None
        while True:
            if deadline is not None and time.monotonic() > deadline:
                self._m_failed.inc()
                raise RequestFailed(
                    f"request {rid} ran out its {timeout}s budget "
                    f"after {attempt} attempt(s)", cause=last_exc)
            remaining = max_new_tokens - len(emitted)
            if remaining <= 0 or (eos_token_id is not None and emitted
                                  and emitted[-1] == int(eos_token_id)):
                # the disconnect arrived AFTER the final token (budget
                # spent, or the salvaged tail already ends in EOS):
                # the stream is whole, nothing to re-dispatch — a
                # resumed attempt would generate PAST the EOS.
                # ``attempt`` was already bumped past the disconnect,
                # so hand _serve the index of the LAST dispatch made —
                # "attempts" must count dispatches, not loop turns
                _deliver(emitted, 0)
                return self._serve(rid, prompt, emitted, [], None,
                                   attempt - 1, t0)
            attempt_timeout = self.policy.request_timeout_s
            if deadline is not None:
                # one slow attempt must not overrun the caller's
                # budget: the transport deadline shrinks with it
                attempt_timeout = min(
                    attempt_timeout,
                    max(deadline - time.monotonic(), 0.001))
            payload = {
                "prompt": prompt + emitted,
                "max_new_tokens": remaining,
                "eos_token_id": eos_token_id,
                "temperature": temperature, "top_k": top_k,
                "top_p": top_p, "seed": seed, "priority": priority,
                "tenant": tenant,
                "timeout_s": attempt_timeout,
            }
            if model is not None:
                payload["adapter"] = model
            fwd = None
            if on_token is not None:
                # catch the caller up on anything salvaged since the
                # last dispatch, then hand the transport a forwarder
                # anchored at this attempt's resume point — its
                # attempt-local token i is global index base + i
                _deliver(emitted, 0)
                _base = len(emitted)
                _ctr = itertools.count()

                def fwd(tok, _b=_base, _c=_ctr):
                    _deliver([tok], _b + next(_c))
            if self.policy.disaggregate and on_token is None \
                    and model is None \
                    and self._disagg_split(exclude):
                out = self._disagg_attempt(
                    payload, rid, prompt, exclude,
                    emitted if greedy else None)
                if out is not None:
                    served_by, resp, n = out
                    return self._serve(rid, prompt, emitted,
                                       resp.get("generated", []),
                                       served_by, attempt + n - 1,
                                       t0, resp)
                # the disaggregated attempt burned out (exclude and
                # any greedy salvage were updated in place): next
                # turn retries — another split if one is still
                # routable, the normal path otherwise
                self._m_retries.inc()
                attempt += 1
                continue
            try:
                with self.tracer.span("route.pick", cat="router",
                                      req=rid, attempt=attempt) as sp:
                    rep, how = self.pick(prompt, exclude=exclude,
                                         rid=rid, attempt=attempt,
                                         model=model)
                    if not rep.breaker.acquire():
                        # raced a concurrent half-open trial: treat as
                        # a retryable miss
                        raise ReplicaUnavailable(
                            f"{rep.name} breaker trial already in "
                            "flight", retry_after=None)
                    if sp is not None and hasattr(sp, "args"):
                        sp.args.update(replica=rep.name, how=how)
                self._m_picks.inc()
                if how == "affinity":
                    self._m_affinity.inc()
                self.log.append(("pick", rid, rep.name, how, attempt))
                if self.policy.prefix_warm and how != "affinity" \
                        and not emitted:
                    self._warm_prefix(rep, prompt, rid)
                use_hedge = (self.policy.hedge and idempotent
                             and attempt == 0 and on_token is None)
                hedged = False
                if use_hedge:
                    served_by, resp, hedged = self._hedged_attempt(
                        rep, payload, rid, prompt, exclude)
                else:
                    resp = self._attempt(rep, payload, rid,
                                         on_token=fwd)
                    served_by = rep
            except (NoReplicasAvailable, UnknownModel):
                self._m_failed.inc()
                raise
            except StreamMigrated as e:
                # a rebalance kicked this stream off its replica mid-
                # decode: the payload IS the stream (KV blocks +
                # resume snapshot) — land it on a peer and the SAME
                # logical request continues there, exactly once
                self.log.append(("migrate_out", rid, rep.name,
                                 len(e.emitted)))
                dest, resp, n = None, None, 0
                if e.payload is not None:
                    dest, resp, n = self._import_stream(
                        e.payload, rid, prompt,
                        exclude | {rep.name}, attempt_timeout)
                if resp is not None:
                    self._m_migrations.inc()
                    self.log.append(
                        ("migrate", rid, rep.name, dest.name,
                         resp.get("migrated_blocks")))
                    self.tracer.instant(
                        "route.migrated", cat="router", req=rid,
                        source=rep.name, dest=dest.name,
                        blocks=resp.get("migrated_blocks"))
                    # the import's response carries the stream's FULL
                    # token history: splice the unseen tail into the
                    # live stream (indices already forwarded before
                    # the migration are suppressed by _deliver)
                    _deliver(emitted
                             + [int(x) for x in
                                resp.get("generated", [])], 0)
                    return self._serve(rid, prompt, emitted,
                                       resp.get("generated", []),
                                       dest, attempt + n, t0, resp)
                # nobody took the payload; the source stream is
                # already terminated, so salvage what it had emitted
                # and fail over like a disconnect (greedy resumes,
                # seeded restarts — token-identical either way)
                if greedy and e.emitted:
                    emitted.extend(e.emitted)
                self.log.append(("failover", rid, rep.name,
                                 "migrate_lost"))
                self._m_retries.inc()
                exclude.add(rep.name)
                attempt += 1
                continue
            except Exception as e:
                last_exc = e
                kind, retryable, hint, got = self._classify(
                    e, idempotent)
                replica_died = kind in ("abandoned", "disconnect",
                                        "refused", "timeout")
                if got:
                    if greedy:
                        # greedy failover RESUMES: prompt + emitted is
                        # the next attempt's context, the continuation
                        # is token-identical to the uninterrupted run
                        emitted.extend(int(t) for t in got)
                    # sampled streams restart from scratch instead: a
                    # seeded re-run from token 0 is identical, while
                    # resuming mid-stream would shift the device
                    # sampling counter and fork the stream
                self.log.append(("retry" if not replica_died
                                 else "failover", rid, rep.name, kind))
                self.tracer.instant("route.failover" if replica_died
                                    else "route.retry", cat="router",
                                    req=rid, replica=rep.name,
                                    kind=kind, attempt=attempt)
                if replica_died:
                    self._m_failovers.inc()
                if not retryable or attempt >= self.policy.retry_max:
                    self._m_failed.inc()
                    raise RequestFailed(
                        f"request {rid} failed on {rep.name} after "
                        f"{attempt + 1} attempt(s): [{kind}] {e}",
                        cause=e) from e
                self._m_retries.inc()
                exclude.add(rep.name)
                # dead-replica failovers skip the backoff (the work is
                # fine, the host is not); transient failures back off
                # exponentially with seeded jitter, honoring a
                # replica's own Retry-After when it is larger
                if not replica_died or hint is not None:
                    wait = self._backoff(rid, attempt, hint)
                    if deadline is not None:
                        wait = min(wait,
                                   max(deadline - time.monotonic(),
                                       0.0))
                    with self.tracer.span(
                            "route.retry", cat="router", req=rid,
                            attempt=attempt, kind=kind,
                            backoff_ms=round(wait * 1e3, 3)):
                        time.sleep(wait)
                attempt += 1
                continue
            # a fired hedge was a real second dispatch: "attempts"
            # counts dispatches, whichever slot won
            _deliver(emitted
                     + [int(x) for x in resp.get("generated", [])], 0)
            return self._serve(rid, prompt, emitted,
                               resp.get("generated", []),
                               served_by, attempt + (1 if hedged
                                                     else 0),
                               t0, resp)

    def _serve(self, rid, prompt, emitted, new_tokens, rep, attempts,
               t0, resp=None):
        generated = [int(t) for t in emitted] \
            + [int(t) for t in new_tokens]
        ms = (time.monotonic() - t0) * 1e3
        self._m_lat.observe(ms)
        self._m_served.inc()
        name = rep.name if rep is not None else None
        self.log.append(("serve", rid, name, attempts))
        self.tracer.instant("route.served", cat="router", req=rid,
                            replica=name, attempts=attempts,
                            ms=round(ms, 3))
        out = {
            "req": rid, "replica": name, "attempts": attempts + 1,
            "ids": prompt + generated, "generated": generated,
        }
        if resp:
            for k in ("ttft_ms", "id"):
                if k in resp:
                    out[f"replica_{k}" if k == "id" else k] = resp[k]
        return out

    # -- observability -------------------------------------------------
    def route_log(self):
        """Snapshot of the structured routing log (bounded ring)."""
        return list(self.log)

    def chrome_trace(self):
        return self.tracer.chrome_trace(process_name="router")


class InProcessReplica:
    """Replica transport wrapping a LOCAL ``Engine`` — the tier-1
    fake-network layer: tests, benches, the example fleet, and
    single-host multi-replica serving all use it, and the ``net_*``
    fault sites of ``serving.faults`` thread through it with a
    deterministic per-replica OPERATION counter as the schedule tick
    (op 0, 1, 2, ... in submission order — wall-clock free, so a
    seeded storm replays exactly).

    Mid-body disconnects are deterministic: when ``net_disconnect`` is
    scheduled for an op, the engine is allowed to finish the stream
    and the transport then "delivers" only the first
    ``disconnect_after`` tokens before raising — exactly what a
    client sees when the peer dies mid-response, with a schedule-
    stable emitted count (the orphaned tail is discarded, never
    double-served).

    ``kill()`` flips a hard-down switch (every op and probe refuses,
    like a dead process) — the example's replica-kill demo;
    ``revive()`` brings it back.
    """

    def __init__(self, name, engine, faults=None,
                 disconnect_after=2, poll_s=0.002, role="mixed"):
        if role not in ("mixed", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        self.name = str(name)
        self.engine = engine
        self.faults = faults
        self.disconnect_after = int(disconnect_after)
        self.poll_s = float(poll_s)
        self.role = role     # advertised in probes; the router's
        #   disaggregated pick() is what makes it binding
        self.killed = False
        self.incarnation = 0  # supervisor restart generation: bumped
        #   by revive(bump_incarnation=True) to model a supervised
        #   respawn on the same address
        self._ops = itertools.count()
        self._probe_ops = itertools.count()
        self.served = []     # router-delivered op ids (test surface)

    # the router's /replicas view shows where the replica lives
    address = "in-process"

    def kill(self):
        self.killed = True

    def revive(self, bump_incarnation=False):
        """Bring a killed replica back.  Default models the SAME
        process answering again (probe-driven breaker recovery walks
        OPEN -> HALF_OPEN -> trial); ``bump_incarnation=True`` models
        a supervised RESPAWN — a new process on the old address whose
        first probe makes the router reset breaker + health history
        instead of trialing through half-open."""
        self.killed = False
        if bump_incarnation:
            self.incarnation += 1

    def _maybe(self, site, tick, **kw):
        if self.faults is not None \
                and self.faults.scheduled(site, tick):
            self.faults.fire(site, tick, **kw)

    def probe(self):
        t = next(self._probe_ops)
        if self.killed:
            raise NetRefused(
                f"replica {self.name} is down (probe {t})")
        self._maybe("net_refuse", t)
        self._maybe("net_blackhole", t)
        self._maybe("net_slow", t)
        eng = self.engine
        paged = getattr(eng, "_paged", False)
        rate = getattr(eng, "drain_rate", lambda: None)()
        return {
            "status": "ok",
            "queue_depth": eng.queue.depth(),
            "slots_total": eng.num_slots,
            "slots_free": eng.scheduler.free_count(),
            "kv_blocks_free": (eng.block_pool.free_count()
                               if paged else None),
            "kv_block_size": (eng._bs if paged else None),
            "mesh_shape": getattr(eng, "mesh_axes", None),
            "mp": getattr(eng, "mp", 1),
            "dp": getattr(eng, "dp", 1),
            "weight_dtype": getattr(eng, "_weight_dtype_str", None),
            "kv_dtype": getattr(eng, "_kv_dtype_str", None),
            "kv_block_bytes": getattr(eng, "_kv_code_bytes_per_shard",
                                      None),
            "kv_scale_bytes": getattr(
                eng, "_kv_scale_bytes_per_shard", None),
            "drain_rate_tps": rate,
            "draining": bool(getattr(eng, "_draining", False)),
            "watchdog_fired": bool(getattr(eng, "_watchdog_fired",
                                           False)),
            "role": self.role,
            "incarnation": self.incarnation,
            "adapters": (eng.adapters.names()
                         if getattr(eng, "adapters", None) is not None
                         else []),
            "streams_active": (eng.streams_active()
                               if hasattr(eng, "streams_active")
                               else 0),
            "attn_impl": getattr(eng, "attn_impl", "xla"),
            "max_context_len": getattr(eng, "_max_context_len", 0),
        } | (
            # host-RAM offload tier signals, matching /healthz: only
            # advertised when the tier exists (probers key off
            # presence)
            {"kv_host_blocks": len(eng.host_store),
             "kv_host_bytes": eng.host_store.bytes_used,
             "kv_host_capacity_mb": eng.host_store.capacity_mb,
             "offload_hit_tokens_total": int(
                 eng._m_offload_hit_tokens.value)}
            if getattr(eng, "host_store", None) is not None else {})

    def generate(self, payload, should_abort=None, on_token=None):
        t = next(self._ops)
        if self.killed:
            raise NetRefused(f"replica {self.name} is down (op {t})")
        self._maybe("net_refuse", t)
        self._maybe("net_blackhole", t, abort=should_abort)
        self._maybe("net_slow", t)
        disconnect = (self.faults is not None
                      and self.faults.scheduled("net_disconnect", t))
        try:
            req = self.engine.submit(
                payload["prompt"],
                max_new_tokens=payload.get("max_new_tokens", 16),
                eos_token_id=payload.get("eos_token_id"),
                temperature=payload.get("temperature", 1.0),
                top_k=payload.get("top_k", 0),
                top_p=payload.get("top_p", 1.0),
                seed=payload.get("seed"),
                priority=payload.get("priority", 0),
                tenant=payload.get("tenant"),
                adapter=payload.get("adapter"))
        except UnknownAdapter as e:
            # same machine-readable 404 as httpd: the adapter was
            # unloaded between the router's probe and this dispatch —
            # the caller's model name is wrong HERE, not a failure
            raise ReplicaHTTPError(
                f"replica {self.name} rejected the request: {e}",
                404, reason="unknown_adapter") from e
        except Rejected as e:
            raise ReplicaUnavailable(
                str(e), status=503,
                retry_after=getattr(e, "retry_after", None),
                reason=type(e).__name__) from e
        except (TypeError, ValueError) as e:
            # the engine REJECTED the arguments — the caller's fault,
            # exactly what httpd surfaces as a 400: map it the same so
            # a bad client cannot poison this replica's breaker (the
            # router treats 4xx as a health signal, not a failure)
            raise ReplicaHTTPError(
                f"replica {self.name} rejected the request: {e}",
                400, reason="bad_request") from e
        budget = payload.get("timeout_s")
        if on_token is not None:
            return self._stream_generate(req, payload, t, budget,
                                         should_abort, disconnect,
                                         on_token)
        deadline = (None if budget is None
                    else time.monotonic() + float(budget))
        while not req.done():
            if should_abort is not None and should_abort():
                if req.first_token_at is None:
                    # queued-but-unstarted on a dying replica: clean
                    # failover, nothing emitted, nothing lost
                    raise ReplicaAbandoned(
                        f"replica {self.name} abandoned queued "
                        f"request (op {t})")
                raise NetDisconnect(
                    f"replica {self.name} died mid-stream (op {t})",
                    emitted=list(req.generated))
            if deadline is not None and time.monotonic() > deadline:
                raise NetTimeout(
                    f"replica {self.name} exceeded the "
                    f"{budget}s attempt budget (op {t})")
            req._done.wait(self.poll_s)
        if req.error is not None:
            from .engine import Migrated  # lazy: HTTP-only routers
            #   never import the (torch-heavy) engine module
            if isinstance(req.error, Migrated):
                # the stream was MIGRATED out from under this waiter
                # (a rebalance): hand the payload up — the router
                # re-lands it and the same logical request continues
                raise StreamMigrated(
                    f"replica {self.name} migrated the stream out "
                    f"(op {t})", payload=req.error.payload,
                    emitted=req.error.emitted)
            # an engine-side death mid-request IS the failover case:
            # deliver the salvageable prefix as a disconnect
            raise NetDisconnect(
                f"replica {self.name} failed the request: "
                f"{req.error} (op {t})", emitted=list(req.generated))
        gen = [int(x) for x in req.generated]
        if disconnect:
            k = min(self.disconnect_after, len(gen))
            self.faults.fire("net_disconnect", t, emitted=gen[:k])
        self.served.append(t)
        ttft = None
        if req.first_token_at is not None:
            ttft = round((req.first_token_at - req.submitted_at)
                         * 1e3, 3)
        return {
            "id": req.id,
            "ids": [int(x) for x in payload["prompt"]] + gen,
            "generated": gen, "ttft_ms": ttft,
        }

    def _stream_generate(self, req, payload, t, budget, should_abort,
                         disconnect, on_token):
        """The live half of ``generate``: attach a ``TokenStream`` to
        the submitted request and forward every token through
        ``on_token`` the moment the engine emits it.  A scheduled
        ``net_disconnect`` cuts the stream after ``disconnect_after``
        FORWARDED tokens (the client's view of a peer dying mid-SSE);
        every failure carries ``emitted`` = exactly the tokens this
        transport forwarded, so the router's splice resumes without
        a gap or a duplicate."""
        stream = TokenStream(req, heartbeat_s=self.poll_s)
        deadline = (None if budget is None
                    else time.monotonic() + float(budget))
        sent = []
        limit = self.disconnect_after if disconnect else None
        for ev in stream:
            if ev.kind == "token":
                if limit is not None and len(sent) >= limit:
                    # the scheduled mid-stream client death: the cut
                    # tail is orphaned on the replica, never delivered
                    self.faults.fire("net_disconnect", t,
                                     emitted=list(sent))
                on_token(int(ev.token))
                sent.append(int(ev.token))
                continue
            if ev.kind == "heartbeat":
                if should_abort is not None and should_abort():
                    if not sent and req.first_token_at is None:
                        raise ReplicaAbandoned(
                            f"replica {self.name} abandoned queued "
                            f"request (op {t})")
                    raise NetDisconnect(
                        f"replica {self.name} died mid-stream "
                        f"(op {t})", emitted=list(sent))
                if deadline is not None \
                        and time.monotonic() > deadline:
                    raise NetTimeout(
                        f"replica {self.name} exceeded the "
                        f"{budget}s attempt budget (op {t})")
                continue
            break                      # terminal done / error
        if stream.error is not None:
            from .engine import Migrated  # lazy: HTTP-only routers
            #   never import the (torch-heavy) engine module
            if isinstance(stream.error, Migrated):
                raise StreamMigrated(
                    f"replica {self.name} migrated the stream out "
                    f"(op {t})", payload=stream.error.payload,
                    emitted=stream.error.emitted)
            raise NetDisconnect(
                f"replica {self.name} failed the request: "
                f"{stream.error} (op {t})", emitted=list(sent))
        self.served.append(t)
        ttft = None
        if req.first_token_at is not None:
            ttft = round((req.first_token_at - req.submitted_at)
                         * 1e3, 3)
        return {
            "id": req.id,
            "ids": [int(x) for x in payload["prompt"]] + sent,
            "generated": sent, "ttft_ms": ttft,
            "streamed": len(sent),
        }

    def _wait_out(self, req, t, budget, should_abort):
        """Block until ``req`` completes (the shared tail of generate
        / migrate flows): abort, per-attempt budget, and engine-side
        error mapping all behave exactly like ``generate()``."""
        deadline = (None if budget is None
                    else time.monotonic() + float(budget))
        while not req.done():
            if should_abort is not None and should_abort():
                raise NetDisconnect(
                    f"replica {self.name} died mid-stream (op {t})",
                    emitted=list(req.generated))
            if deadline is not None and time.monotonic() > deadline:
                raise NetTimeout(
                    f"replica {self.name} exceeded the "
                    f"{budget}s attempt budget (op {t})")
            req._done.wait(self.poll_s)
        if req.error is not None:
            raise NetDisconnect(
                f"replica {self.name} failed the request: "
                f"{req.error} (op {t})", emitted=list(req.generated))
        return [int(x) for x in req.generated]

    def migrate_export(self, body, should_abort=None):
        """KV block export (the in-process `/migrate/export`).  Three
        shapes: ``prefix_only`` exports the trie's cached blocks for
        a token span; ``deliver=error`` preempts a live stream and
        hands the payload to its own waiter (the rebalance path —
        this transport returns no payload); otherwise submit-then-
        export: run the prompt to ``min_tokens`` and export the warm
        stream (the disaggregated prefill leg).  The ``migrate_wire``
        fault site fires AFTER a successful export, on this replica's
        operation counter — the payload vanishes in flight with the
        source stream already terminated, the worst-case loss the
        chaos tests replay."""
        t = next(self._ops)
        if self.killed:
            raise NetRefused(f"replica {self.name} is down (op {t})")
        self._maybe("net_refuse", t)
        self._maybe("net_blackhole", t, abort=should_abort)
        self._maybe("net_slow", t)
        eng = self.engine
        budget = body.get("timeout_s")
        timeout = 30.0 if budget is None else float(budget)
        if body.get("prefix_only"):
            try:
                payload = eng.export_prefix(body.get("tokens") or [],
                                            timeout=timeout)
            except Exception as e:
                raise ReplicaUnavailable(
                    f"replica {self.name} declined the prefix "
                    f"export: {e} (op {t})",
                    reason="migrate_declined") from e
            self._maybe("migrate_wire", t, emitted=[])
            return {"completed": False, "generated": [],
                    "payload": payload}
        if body.get("deliver") == "error":
            # rebalance: the payload rides the victim's Migrated
            # error to its waiter, never over this return path
            try:
                res = eng.migrate_out(
                    request_id=body.get("request_id"),
                    min_tokens=int(body.get("min_tokens", 1)),
                    deliver="error", timeout=timeout)
            except KeyError as e:
                raise ReplicaHTTPError(
                    f"replica {self.name}: {e} (op {t})", 404,
                    reason="not_found") from e
            except TimeoutError as e:
                raise NetTimeout(
                    f"replica {self.name} export timed out "
                    f"(op {t})") from e
            except Exception as e:
                raise ReplicaUnavailable(
                    f"replica {self.name} declined the export: {e} "
                    f"(op {t})", reason="migrate_declined") from e
            return {"completed": bool(res["completed"]),
                    "generated": [int(x) for x in res["generated"]],
                    "payload": None}
        req = None
        if body.get("request_id") is None:
            try:
                req = eng.submit(
                    body["prompt"],
                    max_new_tokens=body.get("max_new_tokens", 16),
                    eos_token_id=body.get("eos_token_id"),
                    temperature=body.get("temperature", 1.0),
                    top_k=body.get("top_k", 0),
                    top_p=body.get("top_p", 1.0),
                    seed=body.get("seed"),
                    priority=body.get("priority", 0),
                    tenant=body.get("tenant"))
            except Rejected as e:
                raise ReplicaUnavailable(
                    str(e), status=503,
                    retry_after=getattr(e, "retry_after", None),
                    reason=type(e).__name__) from e
            except (TypeError, ValueError) as e:
                raise ReplicaHTTPError(
                    f"replica {self.name} rejected the request: {e}",
                    400, reason="bad_request") from e
            rid = req.id
        else:
            rid = body["request_id"]
        try:
            res = eng.migrate_out(
                request_id=rid,
                min_tokens=int(body.get("min_tokens", 1)),
                deliver="return", timeout=timeout)
        except KeyError as e:
            raise ReplicaHTTPError(
                f"replica {self.name} has no request {rid!r} "
                f"(op {t})", 404, reason="not_found") from e
        except TimeoutError as e:
            raise NetTimeout(
                f"replica {self.name} export timed out (op {t})") \
                from e
        except Exception as e:
            if req is None:
                raise ReplicaUnavailable(
                    f"replica {self.name} declined the export: {e} "
                    f"(op {t})", reason="migrate_declined") from e
            # the engine declined the export of OUR OWN submission
            # (e.g. an injected migrate_export fault): the stream
            # stays on the source — serve it whole right here
            gen = self._wait_out(req, t, budget, should_abort)
            self.served.append(t)
            return {"completed": True, "generated": gen,
                    "payload": None}
        gen = [int(x) for x in res["generated"]]
        # the wire crossing: the source stream is ALREADY terminated
        # when this fires, so the payload is genuinely lost in flight
        self._maybe("migrate_wire", t, emitted=gen)
        if res["completed"]:
            self.served.append(t)
        return {"completed": bool(res["completed"]),
                "generated": gen, "payload": res["payload"]}

    def migrate_import(self, body, should_abort=None):
        """KV block import (the in-process `/migrate/import`): adopt
        the payload's blocks, resume the stream, and block until it
        completes — the response is ``generate()``-shaped plus
        ``migrated_blocks``.  A body with no ``request`` is a prefix
        warm (adopt into the trie, nothing to resume).  The
        ``migrate_wire`` site here fires BEFORE the engine sees the
        payload: the caller still holds it and re-imports elsewhere."""
        t = next(self._ops)
        if self.killed:
            raise NetRefused(f"replica {self.name} is down (op {t})")
        self._maybe("net_refuse", t)
        self._maybe("net_blackhole", t, abort=should_abort)
        self._maybe("net_slow", t)
        self._maybe("migrate_wire", t)
        eng = self.engine
        budget = body.get("timeout_s")
        timeout = 30.0 if budget is None else float(budget)
        if body.get("request") is None:
            try:
                res = eng.import_prefix(body, timeout=timeout)
            except Exception as e:
                raise ReplicaUnavailable(
                    f"replica {self.name} declined the prefix "
                    f"import: {e} (op {t})",
                    reason="migrate_failed") from e
            return dict(res)
        try:
            res = eng.migrate_in(body, timeout=timeout)
        except Rejected as e:
            raise ReplicaUnavailable(
                str(e), status=503,
                retry_after=getattr(e, "retry_after", None),
                reason=type(e).__name__) from e
        except KVDtypeMismatch as e:
            # same machine-readable reason as httpd's 400: the
            # pairing is wrong, not the payload — the router's
            # pre-filter keys off this via the probed kv_dtype
            raise ReplicaHTTPError(
                f"replica {self.name} rejected the payload: {e} "
                f"(op {t})", 400, reason="kv_dtype_mismatch") from e
        except (TypeError, ValueError) as e:
            # a geometry/shape mismatch is NON-retryable against any
            # identically-configured replica — surface it as a 400
            raise ReplicaHTTPError(
                f"replica {self.name} rejected the payload: {e} "
                f"(op {t})", 400, reason="bad_request") from e
        except TimeoutError as e:
            raise NetTimeout(
                f"replica {self.name} import timed out (op {t})") \
                from e
        except Exception as e:
            # injected migrate_import fault and friends: the engine
            # ADOPTED NOTHING (blocks rolled back to refcount 0), so
            # the caller's payload is safe to retry elsewhere
            raise ReplicaUnavailable(
                f"replica {self.name} failed the import: {e} "
                f"(op {t})", reason="migrate_failed") from e
        req = res["request"]
        gen = self._wait_out(req, t, budget, should_abort)
        self.served.append(t)
        ttft = None
        if req.first_token_at is not None:
            ttft = round((req.first_token_at - req.submitted_at)
                         * 1e3, 3)
        rq = body.get("request") or {}
        prompt = [int(x) for x in rq.get("prompt") or []]
        return {
            "id": req.id, "ids": prompt + gen, "generated": gen,
            "ttft_ms": ttft, "migrated_blocks": res["blocks"],
        }


class HttpReplicaClient:
    """Replica transport over HTTP (``serving.httpd`` endpoints):
    ``probe()`` = GET /healthz, ``generate()`` = POST /generate.
    Failure mapping mirrors the injected ``net_*`` vocabulary so the
    router's classifier has ONE decision table: connection refused ->
    NetRefused, socket timeout -> NetTimeout, truncated body ->
    NetDisconnect (no emitted context — the whole-completion API
    cannot say how far it got), 503/429 -> ReplicaUnavailable with
    the Retry-After header honored, other HTTP errors ->
    ReplicaHTTPError carrying the machine-readable ``reason`` the
    error body now always includes.

    ``should_abort`` cannot interrupt a blocking socket read; a dead
    replica surfaces as NetTimeout after ``timeout_s`` instead (the
    in-process transport is the one that abandons instantly)."""

    def __init__(self, address, probe_timeout_s=2.0, timeout_s=60.0):
        self.address = address.rstrip("/")
        self.probe_timeout_s = float(probe_timeout_s)
        self.timeout_s = float(timeout_s)

    def _error_body(self, e):
        try:
            import json
            return json.loads(e.read())
        except Exception:
            return {}

    @staticmethod
    def _retry_after_s(ra):
        """A Retry-After header is delta-seconds OR an HTTP-date (RFC
        7231 — proxies in front of a replica emit the date form);
        unparseable values degrade to None, never to a crash in the
        error handler."""
        if not ra:
            return None
        try:
            return float(ra)
        except ValueError:
            pass
        try:
            import datetime
            from email.utils import parsedate_to_datetime
            dt = parsedate_to_datetime(ra)
            now = datetime.datetime.now(dt.tzinfo)
            return max((dt - now).total_seconds(), 0.0)
        except Exception:
            return None

    def probe(self):
        import json
        import urllib.error
        import urllib.request
        try:
            with urllib.request.urlopen(
                    self.address + "/healthz",
                    timeout=self.probe_timeout_s) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            body = self._error_body(e)
            raise ReplicaHTTPError(
                f"probe {self.address}: HTTP {e.code}", e.code,
                reason=body.get("reason")) from e
        except Exception as e:
            raise self._map_net(e, "probe") from e

    def _map_net(self, e, what):
        import socket
        import urllib.error
        if isinstance(e, urllib.error.URLError):
            reason = getattr(e, "reason", None)
            if isinstance(reason, ConnectionRefusedError) \
                    or isinstance(reason, OSError) \
                    and getattr(reason, "errno", None) in (111, 61):
                return NetRefused(
                    f"{what} {self.address}: connection refused")
            if isinstance(reason, socket.timeout):
                return NetTimeout(
                    f"{what} {self.address}: timed out")
            if isinstance(reason, (ConnectionResetError,
                                   ConnectionError)) \
                    or isinstance(reason, OSError) \
                    and getattr(reason, "errno", None) == 104:
                # connect-phase reset (replica died mid-handshake):
                # retryable like any other transport death
                return NetDisconnect(
                    f"{what} {self.address}: connection reset")
        if isinstance(e, socket.timeout) \
                or isinstance(e, TimeoutError):
            return NetTimeout(f"{what} {self.address}: timed out")
        if isinstance(e, (ConnectionResetError, ConnectionError)):
            return NetDisconnect(
                f"{what} {self.address}: connection reset")
        return e

    def _post(self, path, payload, what=None):
        """POST one JSON body and map every transport failure into
        the router's classified vocabulary (the shared tail of
        ``generate`` / ``migrate_export`` / ``migrate_import``)."""
        import http.client
        import json
        import urllib.error
        import urllib.request
        what = what or path.strip("/")
        body = {k: v for k, v in payload.items() if k != "timeout_s"}
        timeout = float(payload.get("timeout_s") or self.timeout_s)
        data = json.dumps(body).encode()
        req = urllib.request.Request(
            self.address + path, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            bodyj = self._error_body(e)
            ra = e.headers.get("Retry-After")
            if e.code in (503, 429):
                raise ReplicaUnavailable(
                    bodyj.get("error", f"HTTP {e.code}"),
                    status=e.code,
                    retry_after=self._retry_after_s(ra),
                    reason=bodyj.get("reason")) from e
            raise ReplicaHTTPError(
                bodyj.get("error", f"HTTP {e.code}"), e.code,
                reason=bodyj.get("reason")) from e
        except http.client.IncompleteRead as e:
            raise NetDisconnect(
                f"{what} {self.address}: response truncated "
                "mid-body") from e
        except (json.JSONDecodeError, ValueError) as e:
            raise NetDisconnect(
                f"{what} {self.address}: unparseable partial "
                f"response ({e})") from e
        except Exception as e:
            raise self._map_net(e, what) from e

    def generate(self, payload, should_abort=None, on_token=None):
        if on_token is None:
            return self._post("/generate", payload)
        return self._stream_generate(payload, on_token)

    def _stream_generate(self, payload, on_token):
        """POST /generate ``{"stream": true}`` and follow the
        replica's SSE frames (the client half of httpd's
        ``_stream_response``): every ``token`` frame fires
        ``on_token`` immediately, ``done`` returns its /generate-
        shaped payload, a terminal ``error`` frame maps into the
        classified vocabulary (shed -> ReplicaUnavailable with its
        retry_after, result_timeout -> NetTimeout, replica-side death
        -> NetDisconnect carrying exactly the tokens this socket
        delivered, so a greedy failover resumes without a gap)."""
        import http.client
        import json
        import urllib.error
        import urllib.request
        body = {k: v for k, v in payload.items() if k != "timeout_s"}
        body["stream"] = True
        timeout = float(payload.get("timeout_s") or self.timeout_s)
        req = urllib.request.Request(
            self.address + "/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        sent = []
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                for event, dstr in parse_sse(resp):
                    try:
                        d = json.loads(dstr)
                    except ValueError:
                        continue
                    if event == "token":
                        tok = int(d["token"])
                        on_token(tok)
                        sent.append(tok)
                    elif event == "done":
                        return d
                    elif event == "error":
                        reason = d.get("reason")
                        msg = (f"generate {self.address}: terminal "
                               f"stream error [{reason}] "
                               f"{d.get('error')}")
                        if reason == "result_timeout":
                            raise NetTimeout(msg)
                        if reason in ("internal", "drain_failed",
                                      None):
                            raise NetDisconnect(
                                msg, emitted=list(sent))
                        raise ReplicaUnavailable(
                            msg, status=503,
                            retry_after=d.get("retry_after"),
                            reason=reason)
                raise NetDisconnect(
                    f"generate {self.address}: stream ended without "
                    "a terminal event", emitted=list(sent))
        except (NetTimeout, NetDisconnect, ReplicaUnavailable):
            raise
        except urllib.error.HTTPError as e:
            # pre-stream rejection: shed (503/429, Retry-After
            # honored), unknown_adapter (404), bad_request (400)
            bodyj = self._error_body(e)
            ra = e.headers.get("Retry-After")
            if e.code in (503, 429):
                raise ReplicaUnavailable(
                    bodyj.get("error", f"HTTP {e.code}"),
                    status=e.code,
                    retry_after=self._retry_after_s(ra),
                    reason=bodyj.get("reason")) from e
            raise ReplicaHTTPError(
                bodyj.get("error", f"HTTP {e.code}"), e.code,
                reason=bodyj.get("reason")) from e
        except http.client.IncompleteRead as e:
            raise NetDisconnect(
                f"generate {self.address}: stream truncated "
                "mid-frame", emitted=list(sent)) from e
        except Exception as e:
            mapped = self._map_net(e, "generate")
            if isinstance(mapped, NetDisconnect):
                # re-raise with the delivered-token context a
                # mid-stream reset salvages
                raise NetDisconnect(str(mapped),
                                    emitted=list(sent)) from e
            if mapped is e:
                raise
            raise mapped from e

    def migrate_export(self, payload, should_abort=None):
        """POST /migrate/export — the returned ``payload`` (when one
        exists) is wire-form (``data_b64``), which the importing
        engine decodes itself; it round-trips straight into
        ``migrate_import`` unchanged."""
        return self._post("/migrate/export", payload,
                          what="migrate_export")

    def migrate_import(self, payload, should_abort=None):
        return self._post("/migrate/import", payload,
                          what="migrate_import")
