"""Self-healing fleet supervisor: the tier that brings replicas BACK
(a copy of ``paddle_tpu/serving/supervisor.py``).

The router tier (``serving.router``) detects a dead replica and routes
around it; nothing in the stack ever restarted one, so every kill
permanently shrank capacity.  ``FleetSupervisor`` closes the loop: it
owns a set of replica process handles (a ``distributed.launch``
``ServingFleet`` in production, any duck-typed fake in tests) and
keeps the fleet at target size:

* **death by exit** — ``handle.alive()`` false (the process
  terminated, e.g. a ``proc_kill9`` chaos firing or an OOM kill);
* **death by wedge** — the process is alive but ``/livez`` probes
  time out ``wedge_after`` times in a row, or a probe answers with
  ``watchdog_fired`` (the engine's tick watchdog declared a wedged
  dispatch).  A SIGSTOP'd process (``proc_stop``) is the canonical
  wedge: ``poll()`` says alive, the socket never answers.  The
  supervisor SIGKILLs the wedged process — SIGKILL terminates even
  stopped processes — and treats it as a death;
* **restart with exponential backoff + seeded jitter** — the k-th
  restart inside the crash-loop window waits
  ``min(cap, base * 2^k)`` scaled by a deterministic jitter drawn
  from ``blake2b(seed:replica:incarnation)`` (the fault injector's
  pure-hash idiom), so a storm replay restarts on the same schedule;
* **crash-loop quarantine** — ``crashloop_threshold`` restarts inside
  ``crashloop_window_s`` trips a supervisor-level breaker: the
  replica is QUARANTINED (no further restarts burn capacity on a
  replica that exits on boot) until an operator ``release()``\\ s it;
* **incarnation ids** — every restart stamps the successor process
  with ``incarnation + 1`` (httpd's ``--incarnation`` flag, surfaced
  on ``/healthz``).  The router registry keys its circuit breaker and
  health history on the incarnation: a probe from a dead incarnation
  can never poison its successor, and a successor never inherits the
  predecessor's half-open breaker state.

The supervisor NEVER consults the fault schedule — chaos is the storm
driver's job (``faults.PROC_SITES``); the supervisor only observes
and heals, so supervised and unsupervised runs of the same seed see
the identical fault sequence and the ``restart_log`` is a pure
consequence of it (same seed => same death/restart/quarantine log,
asserted by the kill-storm tests).

Metrics (in the supplied registry): ``supervisor.restarts_total``,
``supervisor.deaths_total``, ``supervisor.quarantined`` (gauge).
Spans: ``supervisor.restart`` around each respawn (broken out by
``tools/trace_view.py --wall``), instants for death / wedge /
quarantine / release.
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.request

from .. import monitor

UP = "up"
BACKOFF = "backoff"
QUARANTINED = "quarantined"


def _u01(seed, *parts):
    """Deterministic uniform in [0, 1) from a blake2b hash — the
    FaultInjector's pure-schedule idiom, reused for restart jitter so
    a replayed storm restarts on the identical schedule."""
    key = ":".join([str(seed)] + [str(p) for p in parts])
    h = hashlib.blake2b(key.encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


class SupervisorPolicy:
    """FleetSupervisor tuning knobs (defaults are production-shaped;
    tests shrink the time constants).

    poll_interval_s : background sweep period.
    livez_timeout_s : per-probe timeout; an unanswered probe counts
        toward the wedge verdict.
    wedge_after : consecutive failed/watchdog probes before a live
        process is declared wedged and killed.
    boot_grace_s : after a (re)spawn, probe failures are forgiven for
        this long (a replica importing its ML stack answers nothing
        for many seconds; killing it for that would be a crash loop
        of the supervisor's own making).  Process EXIT still counts
        immediately.
    backoff_base_s / backoff_cap_s / backoff_jitter : restart delay
        ``min(cap, base * 2^k)`` for the k-th restart in the window,
        scaled by ``1 + jitter * (2u - 1)`` with the seeded draw u.
    crashloop_window_s / crashloop_threshold : this many restarts
        inside the window quarantines the replica.
    wedge_on_watchdog : count a probe that answers with
        ``watchdog_fired`` as a wedge strike (the engine itself says
        its tick is stuck); off, only unanswered probes count.
    seed : determinism root for the jitter draws.
    """

    def __init__(self, poll_interval_s=0.5, livez_timeout_s=1.0,
                 wedge_after=3, boot_grace_s=120.0,
                 backoff_base_s=0.25, backoff_cap_s=10.0,
                 backoff_jitter=0.5, crashloop_window_s=60.0,
                 crashloop_threshold=3, wedge_on_watchdog=True,
                 seed=0):
        if wedge_after < 1:
            raise ValueError(
                f"wedge_after must be >= 1, got {wedge_after}")
        if crashloop_threshold < 1:
            raise ValueError(f"crashloop_threshold must be >= 1, got "
                             f"{crashloop_threshold}")
        if backoff_base_s < 0 or backoff_cap_s < 0:
            raise ValueError("backoff must be >= 0, got "
                             f"{backoff_base_s}/{backoff_cap_s}")
        if not 0 <= backoff_jitter <= 1:
            raise ValueError(f"backoff_jitter must be in [0, 1], got "
                             f"{backoff_jitter}")
        self.poll_interval_s = float(poll_interval_s)
        self.livez_timeout_s = float(livez_timeout_s)
        self.wedge_after = int(wedge_after)
        self.boot_grace_s = float(boot_grace_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.backoff_jitter = float(backoff_jitter)
        self.crashloop_window_s = float(crashloop_window_s)
        self.crashloop_threshold = int(crashloop_threshold)
        self.wedge_on_watchdog = bool(wedge_on_watchdog)
        self.seed = int(seed)


class ProcessReplica:
    """Supervisor handle over one ``ServingFleet`` slot — the real-
    process driver.  The handle contract (duck-typed; tests fake it):

    * ``alive() -> bool`` — the process exists and has not exited;
    * ``exit_code()`` — returncode once dead (None while alive);
    * ``kill()`` — SIGKILL + reap (works on SIGSTOP-wedged children);
    * ``spawn(incarnation)`` — (re)start the process advertising that
      incarnation; must not block on readiness (the supervisor's
      ``boot_grace_s`` owns that wait);
    * ``probe_live(timeout_s) -> dict`` — liveness probe; raises when
      the process does not answer within the timeout.  The returned
      dict MAY carry ``watchdog_fired``.

    ``probe_live`` fetches ``/healthz`` (one round trip covers both
    wedge conditions: an unanswered fetch IS the ``/livez`` timeout —
    the same HTTP thread serves both paths — and the body carries the
    engine's ``watchdog_fired`` flag)."""

    def __init__(self, fleet, index, name=None):
        self.fleet = fleet
        self.index = int(index)
        self.name = (str(name) if name is not None
                     else f"replica{int(index)}")
        self.url = fleet.urls[self.index]

    def alive(self):
        return self.fleet.procs[self.index].poll() is None

    def exit_code(self):
        return self.fleet.procs[self.index].poll()

    def kill(self):
        self.fleet.kill(self.index)

    def spawn(self, incarnation):
        self.fleet.respawn(self.index, incarnation=int(incarnation))

    def probe_live(self, timeout_s):
        with urllib.request.urlopen(self.url + "/healthz",
                                    timeout=float(timeout_s)) as r:
            return json.loads(r.read())


class _SupState:
    """Per-replica supervision record."""

    def __init__(self, handle, incarnation=0):
        self.handle = handle
        self.incarnation = int(incarnation)
        self.state = UP
        self.restart_at = None    # monotonic deadline while BACKOFF
        self.recent = []          # restart stamps in the window
        self.live_fails = 0       # consecutive wedge strikes
        self.boot_until = None    # probe-forgiveness deadline
        self.confirmed = False    # answered a probe since (re)spawn


class FleetSupervisor:
    """Keep a replica fleet at target size (module docstring has the
    full story).  ``replicas``: dict name -> handle, or an iterable
    of handles with ``.name``.  Deterministic tests drive
    ``poll_once(now=...)`` directly; production runs ``start()``'s
    daemon sweep thread."""

    def __init__(self, replicas, policy=None, registry=None,
                 tracing=True, trace_capacity=8192):
        self.policy = policy or SupervisorPolicy()
        self.registry = registry or monitor.default_registry()
        self.tracer = (monitor.Tracer(capacity=trace_capacity)
                       if tracing else monitor.NullTracer())
        if isinstance(replicas, dict):
            items = list(replicas.items())
        else:
            items = [(getattr(h, "name"), h) for h in replicas]
        self._states = {str(n): _SupState(h) for n, h in items}
        if len(self._states) != len(items):
            raise ValueError("replica names must be unique")
        self.restart_log = []   # ("death"|"restart"|"quarantine"|
        #   "release", name, incarnation[, reason]) — wall-clock free,
        #   so the same seed + fault schedule replays the same log
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        reg = self.registry
        self._m_restarts = reg.counter(
            "supervisor.restarts_total",
            "replica processes restarted by the supervisor")
        self._m_deaths = reg.counter(
            "supervisor.deaths_total",
            "replica deaths observed (process exit + wedge kills)")
        self._m_quarantined = reg.gauge(
            "supervisor.quarantined",
            "replicas currently quarantined by the crash-loop breaker")

    # -- views ---------------------------------------------------------
    def target_size(self):
        return len(self._states)

    def quarantined(self):
        """Names currently behind the crash-loop breaker."""
        return sorted(n for n, s in self._states.items()
                      if s.state == QUARANTINED)

    def incarnation(self, name):
        return self._states[str(name)].incarnation

    def status(self):
        """JSON-shaped fleet view (the bench / examples surface)."""
        rows = {}
        for n, s in sorted(self._states.items()):
            rows[n] = {
                "state": s.state,
                "incarnation": s.incarnation,
                "alive": bool(s.handle.alive()),
                "confirmed": s.confirmed,
                "recent_restarts": len(s.recent),
                "live_fails": s.live_fails,
            }
        return {"target": self.target_size(), "replicas": rows,
                "quarantined": self.quarantined()}

    def chrome_trace(self):
        return self.tracer.chrome_trace(process_name="supervisor")

    # -- the sweep -----------------------------------------------------
    def poll_once(self, now=None):
        """One supervision sweep over every replica, in name order
        (deterministic).  Returns {name: state} after the sweep."""
        now = time.monotonic() if now is None else float(now)
        p = self.policy
        out = {}
        for name in sorted(self._states):
            s = self._states[name]
            if s.state == QUARANTINED:
                out[name] = s.state
                continue
            if s.state == BACKOFF:
                if now >= s.restart_at:
                    self._restart(name, s, now)
                out[name] = s.state
                continue
            # state == UP
            if not s.handle.alive():
                self._on_death(
                    name, s, f"exit:{s.handle.exit_code()}", now)
                out[name] = s.state
                continue
            wedged = False
            info = None
            try:
                info = s.handle.probe_live(p.livez_timeout_s)
            except Exception:
                wedged = True
            if info is not None and p.wedge_on_watchdog \
                    and info.get("watchdog_fired"):
                wedged = True
            in_boot = s.boot_until is not None and now < s.boot_until
            if wedged and not in_boot:
                s.live_fails += 1
            elif not wedged:
                s.live_fails = 0
                s.boot_until = None   # first clean probe ends boot
                s.confirmed = True
            if s.live_fails >= p.wedge_after:
                # alive-but-unresponsive: SIGKILL (terminates even a
                # SIGSTOP'd process) and walk the normal death path
                self.tracer.instant("supervisor.wedge",
                                    cat="supervisor", replica=name,
                                    incarnation=s.incarnation)
                try:
                    s.handle.kill()
                except Exception:
                    pass
                self._on_death(name, s, "wedge", now)
            out[name] = s.state
        return out

    def _on_death(self, name, s, reason, now):
        self._m_deaths.inc()
        self.restart_log.append(
            ("death", name, s.incarnation, reason))
        self.tracer.instant("supervisor.death", cat="supervisor",
                            replica=name, incarnation=s.incarnation,
                            reason=reason)
        p = self.policy
        s.live_fails = 0
        s.boot_until = None
        s.confirmed = False
        s.recent = [t for t in s.recent
                    if now - t <= p.crashloop_window_s]
        if len(s.recent) >= p.crashloop_threshold:
            s.state = QUARANTINED
            self.restart_log.append(
                ("quarantine", name, s.incarnation))
            self.tracer.instant("supervisor.quarantine",
                                cat="supervisor", replica=name,
                                incarnation=s.incarnation)
            self._m_quarantined.set(len(self.quarantined()))
            return
        k = len(s.recent)
        delay = min(p.backoff_cap_s, p.backoff_base_s * (2 ** k))
        u = _u01(p.seed, "restart", name, s.incarnation + 1)
        delay *= 1.0 + p.backoff_jitter * (2.0 * u - 1.0)
        s.restart_at = now + delay
        s.state = BACKOFF

    def _restart(self, name, s, now):
        s.incarnation += 1
        with self.tracer.span("supervisor.restart", cat="supervisor",
                              replica=name,
                              incarnation=s.incarnation):
            try:
                s.handle.spawn(s.incarnation)
            except Exception:
                # the spawn itself failed (exec error, port bind):
                # treat like an instant death — backoff grows and the
                # crash-loop breaker eventually quarantines
                s.recent.append(now)
                self._on_death(name, s, "spawn_failed", now)
                return
        s.recent.append(now)
        s.state = UP
        s.live_fails = 0
        s.boot_until = now + self.policy.boot_grace_s
        self.restart_log.append(("restart", name, s.incarnation))
        self._m_restarts.inc()

    def release(self, name):
        """Operator override: lift a quarantine.  The crash-loop
        window resets and the replica restarts on the next sweep."""
        s = self._states[str(name)]
        if s.state != QUARANTINED:
            raise ValueError(f"replica {name!r} is not quarantined "
                             f"(state={s.state})")
        s.recent = []
        s.live_fails = 0
        s.restart_at = -float("inf")   # due immediately
        s.state = BACKOFF
        self.restart_log.append(("release", str(name), s.incarnation))
        self.tracer.instant("supervisor.release", cat="supervisor",
                            replica=str(name),
                            incarnation=s.incarnation)
        self._m_quarantined.set(len(self.quarantined()))

    # -- waiting helpers ----------------------------------------------
    def wait_fleet_up(self, timeout_s=60.0, poll_s=None):
        """Sweep until every non-quarantined replica is UP, alive AND
        probe-confirmed (the storm tests' convergence wait).  The
        confirmation requirement matters for crash-loopers: an armed
        exit-on-boot child is briefly alive after every respawn, so
        "alive" alone flickers true mid-loop — a replica only counts
        once it has answered a live probe since its last (re)spawn,
        which a crash-looper never does.  Returns True on success,
        False on timeout."""
        poll_s = (self.policy.poll_interval_s if poll_s is None
                  else float(poll_s))
        deadline = time.monotonic() + float(timeout_s)
        while time.monotonic() < deadline:
            states = self.poll_once()
            if all(st == QUARANTINED
                   or (st == UP and self._states[n].confirmed
                       and self._states[n].handle.alive())
                   for n, st in states.items()):
                return True
            time.sleep(poll_s)
        return False

    # -- background sweep ----------------------------------------------
    def start(self):
        """Run the sweep on a daemon thread."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop = threading.Event()
        stop = self._stop

        def loop():
            while not stop.wait(self.policy.poll_interval_s):
                try:
                    self.poll_once()
                except Exception:
                    pass  # the supervisor must outlive one bad sweep

        self._thread = threading.Thread(
            target=loop, daemon=True,
            name="paddle_tpu_torch-serving-supervisor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def supervise_fleet(fleet, policy=None, registry=None, names=None):
    """FleetSupervisor over a spawned ``ServingFleet``: one
    ``ProcessReplica`` handle per slot (respawn-on-same-URL via
    ``ServingFleet.respawn``).  ``names`` optionally labels the
    slots; default ``replica0..N-1``."""
    handles = [ProcessReplica(
        fleet, i, name=(names[i] if names else None))
        for i in range(len(fleet.procs))]
    return FleetSupervisor(handles, policy=policy, registry=registry)
