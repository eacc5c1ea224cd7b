"""Deterministic fault injection + tick watchdog for the engine (a
copy of ``paddle_tpu/serving/faults.py``: the same blake2b schedule, so
a seed fires the same site on the same tick in both packages).

The engine's recovery paths (step-failure eviction, pool rebuild,
flight recorder, async ring drop) were each built against ONE
hand-injected failure.  Production failures compose: a dispatch error
lands while a tick is in flight, the pool runs dry during the
recovery re-admission, the host stalls mid-consume.  This module makes
that composition testable and REPRODUCIBLE:

* ``FaultInjector`` — named failure points (``SITES``) threaded
  through engine / kvcache / spec.  Whether a site fires at a given
  engine tick is a PURE FUNCTION of ``(seed, site, tick)`` (a blake2b
  hash against the site's configured rate), so a storm's schedule is
  reproducible from its seed alone, independent of wall-clock timing,
  thread interleaving, or how many times a site is consulted — plus
  explicit one-shot entries via ``at(tick, site)`` for targeted tests.
  The injector records every fired (tick, site) in ``log``; the chaos
  tests assert the same seed replays the same log.

* ``TickWatchdog`` — a daemon thread that watches the engine's
  tick-start heartbeat.  A tick that exceeds ``timeout_s`` (a wedged
  in-flight dispatch, a hung d2h) gets flight-recorded IMMEDIATELY
  (``Engine.last_flight`` snapshots the in-flight state while it is
  still observable) and the engine is marked ``_watchdog_fired`` —
  cooperative blocking points (the injected d2h hang, and any real
  wait loop that polls the flag) convert the wedge into a
  ``WatchdogTimeout`` raise, which lands in the EXISTING
  step-failure recovery path: waiters unblock, pools rebuild, the
  engine serves on.  A truly uninterruptible wedge (real hardware
  hang) still gets the flight dump and an unhealthy mark instead of
  a silent freeze.

Fault sites (who checks them, what firing does):

====================  ===============================  ==============
site                  checked at                        action
====================  ===============================  ==============
``dispatch``          decode / spec-verify dispatch     raises
                      (engine)                          InjectedFault
``d2h_hang``          consume-side materialize          hangs
                      (engine)                          ``hang_s``
                                                        (watchdog
                                                        converts to
                                                        a raise)
``pool_exhaust``      BlockPool.alloc (kvcache hook)    raises
                                                        NoFreeBlocks
``host_slow``         tick start (engine)               sleeps
                                                        ``slow_s``
``spec_draft``        proposer call (engine spec        raises inside
                      draft loop)                       the draft
                                                        try — the
                                                        engine
                                                        degrades to
                                                        zero drafts
====================  ===============================  ==============

Network-layer sites (the ROUTER tier's chaos vocabulary — checked by
a replica TRANSPORT, e.g. ``serving.router.InProcessReplica`` or a
test fake, with the transport's own per-replica operation counter as
the ``tick``; the schedule stays a pure function of (seed, site,
tick) so a seeded replica-kill storm replays exactly):

====================  ===============================  ==============
site                  checked at                        action
====================  ===============================  ==============
``net_refuse``        connection open (transport)       raises
                                                        NetRefused —
                                                        the replica's
                                                        port is
                                                        closed
``net_blackhole``     request dispatch (transport)      waits
                                                        ``blackhole_s``
                                                        cooperatively,
                                                        then raises
                                                        NetTimeout —
                                                        packets
                                                        vanish, the
                                                        client's
                                                        socket
                                                        timeout fires
``net_slow``          request dispatch (transport)      sleeps
                                                        ``net_slow_s``
                                                        and PROCEEDS
                                                        (degraded,
                                                        not dead)
``net_disconnect``    response body (transport)         raises
                                                        NetDisconnect
                                                        mid-body; the
                                                        transport
                                                        attaches the
                                                        tokens
                                                        emitted so
                                                        far, so a
                                                        failover can
                                                        resume with
                                                        context
====================  ===============================  ==============

Migration sites (KV block migration between replicas — checked on the
SOURCE engine's tick for export, the transport's op counter for the
wire, and the DESTINATION engine's tick for import, so a single seeded
schedule can kill a migration at any of its three stages):

====================  ===============================  ==============
site                  checked at                        action
====================  ===============================  ==============
``migrate_export``    source engine, before the slot    raises
                      is frozen and its blocks          InjectedFault
                      gathered (the stream keeps        — migration
                      running on the source)            declined
``migrate_wire``      transport, payload in flight      raises
                      (the bytes may be lost; the       NetDisconnect
                      HOLDER of the payload re-sends
                      or falls back to failover)
``migrate_import``    destination engine, before the    raises
                      gathered blocks are adopted       InjectedFault
                      into its pool/trie (fresh         — destination
                      allocation rolls back to          owns NOTHING
                      refcount 0)
====================  ===============================  ==============

Process-level sites (the SUPERVISOR tier's chaos vocabulary —
checked by the kill-storm driver that owns the replica processes,
with its own storm step counter as the ``tick``; the supervisor
itself never consults the schedule, it only observes and heals the
damage, so supervisor-on and supervisor-off runs of the same seed
see the IDENTICAL fault sequence):

====================  ===============================  ==============
site                  checked at                        action
====================  ===============================  ==============
``proc_kill9``        storm driver, per storm step      SIGKILL to the
                      (``fire(..., proc=popen)``)       target replica
                                                        process — the
                                                        supervisor
                                                        sees the exit
                                                        and restarts
                                                        it with
                                                        backoff
``proc_stop``         storm driver, per storm step      SIGSTOP — a
                      (``fire(..., proc=popen)``)       WEDGE: the
                                                        process stays
                                                        alive but
                                                        /livez times
                                                        out; the
                                                        supervisor
                                                        declares it
                                                        wedged after
                                                        ``wedge_after``
                                                        failed probes,
                                                        SIGKILLs, and
                                                        restarts
``proc_crashloop``    storm driver, per storm step      calls ``arm()``
                      (``fire(..., arm=callable)``)     — the driver's
                                                        hook makes the
                                                        replica's NEXT
                                                        boots exit
                                                        immediately
                                                        (httpd
                                                        ``--fail-boot-
                                                        below``); the
                                                        supervisor's
                                                        crash-loop
                                                        window trips
                                                        and the
                                                        replica ends
                                                        QUARANTINED
====================  ===============================  ==============

Front-end sites (the LoRA + streaming tier — ``adapter_load`` is
checked by the engine while servicing a hot load/unload demand with
the servicing tick as the ``tick``; ``stream_disconnect`` by a
streaming consumer with its per-server stream ordinal as the
``tick``):

====================  ===============================  ==============
site                  checked at                        action
====================  ===============================  ==============
``adapter_load``      engine, servicing a               raises
                      load_adapter / unload_adapter     InjectedFault
                      demand (before touching the       — the demand
                      banks)                            fails, banks
                                                        and inventory
                                                        untouched
``stream_disconnect`` streaming consumer (TokenStream   raises
                      / SSE edge), mid-iteration        StreamDisconnect
                                                        after a
                                                        schedule-
                                                        derived number
                                                        of tokens —
                                                        the client
                                                        vanished; the
                                                        request keeps
                                                        decoding,
                                                        delivered
                                                        tokens stay
                                                        delivered
====================  ===============================  ==============

Offload sites (the host-RAM KV tier, serving/offload.py — both
checked on the OWNING engine's tick, so one seeded schedule covers a
demote and the promote that would have consumed it):

====================  ===============================  ==============
site                  checked at                        action
====================  ===============================  ==============
``offload_demote``    engine, inside the prefix trie's  raises
                      evict hook, BEFORE the gather is  InjectedFault
                      enqueued                          — the block
                                                        frees without
                                                        spilling, the
                                                        host store
                                                        never sees a
                                                        partial entry
``offload_promote``   engine admission gate, after the  raises
                      host probe matched but BEFORE     InjectedFault
                      any entry is read or imported     — admission
                                                        falls back to
                                                        recompute; the
                                                        fresh device
                                                        blocks stay
                                                        plain prefill
                                                        targets, host
                                                        entries stay
                                                        resident
====================  ===============================  ==============
"""
from __future__ import annotations

import hashlib
import signal as _signal
import threading
import time
import weakref


class InjectedFault(RuntimeError):
    """A FaultInjector site fired (the simulated transient failure)."""


class WatchdogTimeout(RuntimeError):
    """The tick watchdog declared an in-flight tick wedged."""


class NetFault(InjectedFault):
    """Base of the injected network-layer failures (router transport
    sites) — subclasses tell the router's retry classifier WHICH
    failure mode it is looking at."""


class NetRefused(NetFault):
    """Injected connection-refused: the replica's port is closed
    (process dead or not yet listening).  Instant and retryable."""


class NetTimeout(NetFault):
    """Injected black hole: the request went out, nothing came back,
    and the client's socket timeout fired.  Retryable — but the
    request MAY have been executed (the loss could be on the response
    path), so only idempotent work should be blindly re-sent."""


class StreamDisconnect(NetFault):
    """Injected streaming-client death: the SSE consumer vanished
    mid-response.  Server side this is indistinguishable from a TCP
    reset — the handler stops writing and releases the stream; the
    tokens already delivered stay delivered (exactly-once), the
    request itself keeps decoding to completion."""


class NetDisconnect(NetFault):
    """Injected mid-body disconnect: the response stream died after
    ``emitted`` tokens were already received.  A failover can resume
    with prompt + emitted as the new context instead of recomputing
    (and for greedy/seeded traffic, the resumed stream is identical
    to the uninterrupted one)."""

    def __init__(self, msg, emitted=None):
        super().__init__(msg)
        self.emitted = list(emitted or [])


ENGINE_SITES = ("dispatch", "d2h_hang", "pool_exhaust", "host_slow",
                "spec_draft")
NET_SITES = ("net_refuse", "net_blackhole", "net_slow",
             "net_disconnect")
MIGRATE_SITES = ("migrate_export", "migrate_wire", "migrate_import")
PROC_SITES = ("proc_kill9", "proc_stop", "proc_crashloop")
# Front-end sites (LoRA + streaming tier): ``adapter_load`` is checked
# by the engine while servicing a load/unload demand (tick = the
# engine tick servicing it) — firing fails THAT demand only, banks and
# inventory untouched; ``stream_disconnect`` is checked by a streaming
# consumer (TokenStream / the SSE edge) with its per-server stream
# ordinal as the tick — firing simulates the client vanishing
# mid-response, which the server loop sees as a dead socket.
FRONTEND_SITES = ("adapter_load", "stream_disconnect")
# Host-RAM offload tier sites (serving/offload.py): ``offload_demote``
# is checked by the prefix trie's evict hook — firing drops the spill,
# the block frees WITHOUT entering the host store (pre-offload
# behavior, store untouched); ``offload_promote`` is checked by the
# admission gate's host-tier consult — firing falls back to recompute,
# the fresh device blocks stay plain prefill targets and the host
# entries stay resident.  Neither firing can corrupt either tier.
OFFLOAD_SITES = ("offload_demote", "offload_promote")
SITES = (ENGINE_SITES + NET_SITES + MIGRATE_SITES + PROC_SITES
         + FRONTEND_SITES + OFFLOAD_SITES)


class FaultInjector:
    """Seeded, schedulable failure points.

    Parameters
    ----------
    seed : storm seed.  ``scheduled(site, tick)`` hashes
        ``(seed, site, tick)`` against ``rates[site]`` — a pure
        function, so the same seed always yields the same schedule.
    rates : dict site -> fire probability per (site, tick).  Sites
        absent from the dict never fire stochastically (explicit
        ``at()`` entries still do).
    hang_s : simulated d2h hang duration.  The hang is COOPERATIVE:
        it sleeps in small increments polling the engine's
        ``_watchdog_fired`` flag, so an armed watchdog converts it
        into a WatchdogTimeout raise mid-hang; without a watchdog it
        is just a bounded slow consume.
    slow_s : host_slow sleep per firing.
    first_tick / last_tick : stochastic firing window (inclusive;
        None = unbounded on that side).  A chaos storm bounds it so
        the engine warms up and drains to idle cleanly around the
        storm, leaving the invariants checkable — explicit ``at()``
        entries ignore the window.
    """

    def __init__(self, seed=0, rates=None, hang_s=0.05, slow_s=0.01,
                 blackhole_s=0.02, net_slow_s=0.005,
                 first_tick=None, last_tick=None):
        self.seed = int(seed)
        rates = dict(rates or {})
        unknown = set(rates) - set(SITES)
        if unknown:
            raise ValueError(
                f"unknown fault sites {sorted(unknown)}; known: {SITES}")
        self.rates = rates
        self.hang_s = float(hang_s)
        self.slow_s = float(slow_s)
        self.blackhole_s = float(blackhole_s)
        self.net_slow_s = float(net_slow_s)
        self.first_tick = first_tick
        self.last_tick = last_tick
        self._explicit = set()   # (site, tick) one-shot entries
        self.log = []            # fired (tick, site), in firing order

    def at(self, tick, site):
        """Schedule an explicit one-shot firing of ``site`` at engine
        ``tick`` (exempt from ``last_tick``).  Returns self."""
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}")
        self._explicit.add((site, int(tick)))
        return self

    def _u01(self, site, tick):
        h = hashlib.blake2b(f"{self.seed}:{site}:{tick}".encode(),
                            digest_size=8).digest()
        return int.from_bytes(h, "big") / 2.0 ** 64

    def scheduled(self, site, tick):
        """Pure schedule query: does ``site`` fire at ``tick``?"""
        if (site, tick) in self._explicit:
            return True
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        if self.first_tick is not None and tick < self.first_tick:
            return False
        if self.last_tick is not None and tick > self.last_tick:
            return False
        return self._u01(site, tick) < rate

    def fire(self, site, tick, engine=None, emitted=None, abort=None,
             proc=None, arm=None):
        """Record the firing and perform the site's action (may raise;
        the record lands FIRST so the log is complete even for raising
        sites).  ``emitted``: the transport's tokens-received-so-far
        snapshot, attached to a ``net_disconnect`` raise so a failover
        can resume with context.  ``abort``: optional callable polled
        during the cooperative ``net_blackhole`` wait (a router that
        already declared this replica dead need not sit out the full
        simulated timeout).  ``proc``: the target replica's Popen-like
        handle for the ``proc_kill9`` / ``proc_stop`` sites (the storm
        driver owns the processes; without a handle the firing is
        record-only).  ``arm``: the storm driver's make-the-next-boots-
        fail hook for ``proc_crashloop``."""
        self.log.append((tick, site))
        if site == "dispatch":
            raise InjectedFault(
                f"injected dispatch failure at tick {tick}")
        if site == "pool_exhaust":
            from .kvcache import NoFreeBlocks
            raise NoFreeBlocks(
                f"injected pool exhaustion at tick {tick}")
        if site == "host_slow":
            time.sleep(self.slow_s)
            return
        if site == "d2h_hang":
            deadline = time.monotonic() + self.hang_s
            while time.monotonic() < deadline:
                if engine is not None and getattr(
                        engine, "_watchdog_fired", False):
                    raise WatchdogTimeout(
                        f"watchdog converted a wedged d2h at tick "
                        f"{tick} into step recovery")
                time.sleep(0.002)
            return
        if site == "spec_draft":
            raise InjectedFault(
                f"injected proposer failure at tick {tick}")
        if site == "net_refuse":
            raise NetRefused(
                f"injected connection refused at op {tick}")
        if site == "net_blackhole":
            # cooperative: poll the abort hook so a caller that has
            # other ways of learning the replica is dead (a probe
            # verdict) converts the black hole into an instant raise
            deadline = time.monotonic() + self.blackhole_s
            while time.monotonic() < deadline:
                if abort is not None and abort():
                    break
                time.sleep(0.002)
            raise NetTimeout(
                f"injected black hole at op {tick}: no response "
                f"within the simulated {self.blackhole_s * 1e3:.0f} ms "
                "client timeout")
        if site == "net_slow":
            time.sleep(self.net_slow_s)
            return
        if site == "net_disconnect":
            n = len(emitted or [])
            raise NetDisconnect(
                f"injected mid-body disconnect at op {tick} after "
                f"{n} emitted tokens", emitted=emitted)
        if site == "migrate_export":
            raise InjectedFault(
                f"injected export failure at tick {tick}: migration "
                "declined, the stream stays on the source")
        if site == "migrate_wire":
            raise NetDisconnect(
                f"injected wire loss at op {tick}: the migration "
                "payload vanished in flight", emitted=emitted)
        if site == "migrate_import":
            raise InjectedFault(
                f"injected import failure at tick {tick}: the "
                "destination adopted nothing")
        if site == "proc_kill9":
            # hard process death: the supervisor sees the exit on its
            # next sweep and restarts with backoff
            if proc is not None:
                try:
                    proc.send_signal(_signal.SIGKILL)
                except (ProcessLookupError, OSError):
                    pass  # already dead: the record still stands
            return
        if site == "proc_stop":
            # SIGSTOP wedge: the process stays alive (poll() is None)
            # but stops answering — only /livez timeouts reveal it
            if proc is not None:
                try:
                    proc.send_signal(_signal.SIGSTOP)
                except (ProcessLookupError, OSError):
                    pass
            return
        if site == "proc_crashloop":
            # exit-on-boot: the driver's hook arms the replica's next
            # restarts to fail immediately (httpd --fail-boot-below),
            # driving the supervisor's crash-loop quarantine
            if arm is not None:
                arm()
            return
        if site == "adapter_load":
            raise InjectedFault(
                f"injected adapter load/unload failure at tick {tick}: "
                "the demand fails, banks and inventory untouched")
        if site == "stream_disconnect":
            raise StreamDisconnect(
                f"injected streaming-client death at stream {tick}: "
                "the SSE consumer vanished mid-response")
        if site == "offload_demote":
            raise InjectedFault(
                f"injected demote failure at tick {tick}: the evicted "
                "block frees without spilling to the host tier")
        if site == "offload_promote":
            raise InjectedFault(
                f"injected promote failure at tick {tick}: admission "
                "falls back to recompute, host entries untouched")



class TickWatchdog:
    """Daemon thread converting a wedged engine tick into a recorded,
    observable failure.

    The engine stamps ``_tick_started_at`` on tick entry and clears it
    on exit; the watchdog polls the stamp and, when one tick exceeds
    ``timeout_s``:

    1. flight-records the in-flight state NOW (``Engine.last_flight``
       — the dump never materializes device futures, so a wedged
       dispatch cannot block it),
    2. sets ``engine._watchdog_fired`` so cooperative blocking points
       raise ``WatchdogTimeout`` into the step-failure recovery path,
    3. bumps ``serving.watchdog_fires``.

    It holds only a weakref: a collected engine ends the thread.  One
    firing per wedged tick (the flag clears at the next tick start).
    """

    def __init__(self, engine, timeout_s):
        self.timeout_s = float(timeout_s)
        if self.timeout_s <= 0:
            raise ValueError(
                f"watchdog timeout must be > 0, got {timeout_s}")
        self._engine = weakref.ref(engine)
        self._stop = threading.Event()
        self._fired_for = None   # tick id already handled
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="paddle_tpu_torch-serving-watchdog")

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    def _run(self):
        poll = max(self.timeout_s / 4.0, 0.002)
        while not self._stop.wait(poll):
            eng = self._engine()
            if eng is None:
                return
            started = eng._tick_started_at
            if started is None:
                continue
            tick = eng.tick_no
            if tick == self._fired_for:
                continue
            if time.monotonic() - started > self.timeout_s:
                self._fired_for = tick
                ms = round(self.timeout_s * 1e3, 1)
                exc = WatchdogTimeout(
                    f"tick {tick} exceeded the {ms} ms watchdog — "
                    "in-flight dispatch wedged")
                try:
                    eng._record_flight(exc)
                    eng._m_watchdog.inc()
                    eng.tracer.instant(
                        "engine.watchdog", cat="engine", tick=tick,
                        timeout_ms=round(self.timeout_s * 1e3, 3))
                except Exception:
                    pass  # the watchdog must never kill itself
                eng._watchdog_fired = True
