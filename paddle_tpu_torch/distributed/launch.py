"""The launcher — a copy of ``paddle_tpu/distributed/launch.py``.

Reference parity: ``python -m paddle.distributed.launch``
(``fleet/launch.py:334``), which spawns one process per GPU and wires the
PADDLE_* env contract, with abort-on-failure monitoring
(``launch_utils.py:526``).  Usage:

    python -m paddle_tpu_torch.distributed.launch --nnodes N \
        --node_rank I --master ADDR:PORT train.py [args...]

One process a node drives every local card; the launcher sets the env
contract, joins the job (``distributed/process.py``:
``torch.distributed.init_process_group``, where the JAX package calls
``jax.distributed.initialize``) and runs the training script.
``--nproc_per_node`` > 1 spawns that many local worker processes
instead (processes sharing a card, CPU meshes, the reference's
multi-process test idiom — test_dist_base.py:668), each re-entering this
module in single-process mode, with ``--log_dir`` giving each its
``workerlog.N`` file and ``--devices_per_proc N`` giving each N CPU ranks
(``PADDLE_DEVICES_PER_PROC``), and watches them with the reference's
abort-all loop: the first worker that exits non-zero terminates every
other and the launcher exits with its code.

The serving half spawns an N-process fleet of
``paddle_tpu_torch.serving.httpd`` replicas on local ports and keeps a
handle over it (``spawn_serving_fleet`` / ``ServingFleet``).
"""
from __future__ import annotations

import argparse
import os
import runpy
import signal
import socket
import subprocess
import sys
import time


def _reserve_port():
    """Bind an OS-assigned port and KEEP the socket open so no
    concurrent process can grab it while the launcher prepares the
    job.  The caller closes it at the last moment before spawning (the
    coordinator bind lives in a child, and two sockets cannot hold one
    port, so a residual close-to-child-bind window remains — narrowed,
    not closed; concurrent multi-launch jobs should pass an explicit
    --master).  SO_REUSEADDR lets the child's bind succeed immediately
    despite the just-closed probe.  Returns the bound socket (port via
    ``sock.getsockname()[1]``)."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s


def _worker_env(devices_per_proc=None):
    """Per-worker env for spawned processes: the parent's environment,
    with the directory holding ``paddle_tpu_torch`` first on
    ``PYTHONPATH`` so ``python -m paddle_tpu_torch...`` resolves from any
    working directory, and ``PADDLE_DEVICES_PER_PROC`` when a worker runs
    that many CPU ranks."""
    env = dict(os.environ)
    if devices_per_proc:
        env["PADDLE_DEVICES_PER_PROC"] = str(int(devices_per_proc))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parts = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    if root not in parts:
        env["PYTHONPATH"] = os.pathsep.join([root] + parts)
    return env


class ServingFleet:
    """Handle over a spawned N-process serving fleet (one
    ``paddle_tpu_torch.serving.httpd`` replica per process, each replica itself
    mesh-sharded when ``mp > 1``).  ``urls`` index-aligns with
    ``procs``; ``stop()`` terminates everything (idempotent).

    A fleet spawned by ``spawn_serving_fleet`` also remembers each
    replica's spawn command, env, and log path, so ``respawn(i)`` can
    bring a dead replica back ON THE SAME URL — the supervisor tier's
    restart primitive (httpd's HTTPServer binds with SO_REUSEADDR, so
    the port is immediately rebindable after the old process dies)."""

    def __init__(self, procs, urls, logs, cmds=None, env=None,
                 log_paths=None):
        self.procs = procs
        self.urls = urls
        # index-aligned with procs when per-replica logs exist (None
        # entries once a kill() released them); empty otherwise
        self._logs = list(logs)
        self._cmds = list(cmds) if cmds is not None else None
        self._env = dict(env) if env is not None else None
        self._log_paths = (list(log_paths) if log_paths is not None
                           else [None] * len(procs))

    def alive_count(self):
        """Replicas whose process is currently up (poll() is None) —
        the supervisor's capacity view."""
        return sum(1 for p in self.procs if p.poll() is None)

    def kill(self, i, sig=signal.SIGKILL):
        """Hard-kill replica ``i`` (failover tests / chaos): the
        router sees a refused socket, not a graceful drain.  The
        child is REAPED here (waited on) and its log handle closed
        immediately — a chaos storm that kills half the fleet must
        not accumulate zombies or leaked file descriptors while the
        surviving replicas keep serving.  A SIGSTOP-wedged child is
        killable too: SIGKILL terminates even stopped processes."""
        p = self.procs[i]
        if p.poll() is None:
            try:
                p.send_signal(sig)
            except ProcessLookupError:
                pass
        p.wait()
        if i < len(self._logs) and self._logs[i] is not None:
            self._logs[i].close()
            self._logs[i] = None

    def respawn(self, i, incarnation=None, extra_args=()):
        """Restart replica ``i`` on its ORIGINAL port/URL with a fresh
        process.  The old process must already be dead (``kill(i)``
        it first if not — respawning over a live child would orphan
        it).  ``incarnation`` replaces (or appends) the child's
        ``--incarnation`` flag so the new process advertises its
        identity on ``/healthz`` and the router registry can tell a
        successor from its dead predecessor.  The log file reopens in
        APPEND mode at the same path, so one file tells the replica's
        whole multi-incarnation story.  Does NOT wait for readiness —
        the caller (supervisor) owns the boot-grace policy."""
        if self._cmds is None:
            raise RuntimeError(
                "this fleet was not built by spawn_serving_fleet: "
                "no recorded spawn command to respawn from")
        p = self.procs[i]
        if p.poll() is None:
            raise RuntimeError(
                f"replica {i} is still alive (pid {p.pid}); kill it "
                "before respawning")
        p.wait()  # reap (idempotent) — never leave a zombie behind
        cmd = list(self._cmds[i])
        if incarnation is not None:
            if "--incarnation" in cmd:
                k = cmd.index("--incarnation")
                cmd[k + 1] = str(int(incarnation))
            else:
                cmd += ["--incarnation", str(int(incarnation))]
            self._cmds[i] = list(cmd)
        cmd += list(extra_args)
        if i < len(self._logs) and self._logs[i] is not None:
            self._logs[i].close()
            self._logs[i] = None
        path = (self._log_paths[i]
                if i < len(self._log_paths) else None)
        if path:
            f = open(path, "a")
            while len(self._logs) <= i:
                self._logs.append(None)
            self._logs[i] = f
            self.procs[i] = subprocess.Popen(
                cmd, env=self._env, stdout=f,
                stderr=subprocess.STDOUT)
        else:
            self.procs[i] = subprocess.Popen(
                cmd, env=self._env, stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL)
        return self.urls[i]

    def stop(self, grace=5.0):
        """Escalating shutdown: SIGTERM every live child (a drain-
        aware replica flips ``/readyz`` to draining and migrates its
        live streams out), wait up to ``grace`` for voluntary exits,
        then SIGKILL whatever remains — including SIGSTOP-wedged
        children, which never see the SIGTERM (it stays pending while
        they are stopped) but die to SIGKILL regardless — and REAP
        every child unconditionally.  Log handles close in a finally:
        after a storm there must be no zombies and no leaked fds even
        if a wait() raises.  Idempotent."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.terminate()          # SIGTERM: drain deadline
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace
        try:
            for p in self.procs:
                while p.poll() is None \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
                if p.poll() is None:
                    try:
                        p.kill()           # escalation: SIGKILL
                    except ProcessLookupError:
                        pass
                p.wait()   # reap even the already-dead children
        finally:
            for f in self._logs:
                if f is not None:
                    f.close()
            self._logs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


def spawn_serving_fleet(n, config="tiny", mp=1, dp=1, device="cuda",
                        seed=0, num_slots=4, max_seq_len=64,
                        kv_block_size=None, spec_k=None,
                        prefill_chunk=None, roles=None, log_dir=None,
                        ready_timeout_s=120.0, peers=False,
                        extra_args=()):
    """Spawn an N-process serving replica fleet and wait until every
    replica answers ``/healthz`` — the real-process twin of the
    in-process router tests.  Each worker is
    ``python -m paddle_tpu_torch.serving.httpd --device <device>`` with:

    * a port reserved HERE via ``_reserve_port`` and held until the
      moment of spawn — so the returned URLs are race-free against
      concurrent launches, modulo the unavoidable close-to-child-bind
      window;
    * the parent's environment (``_worker_env``), the package root on
      ``PYTHONPATH``; replicas on the card build the CUDA kernels at
      first use, and the kernel loader's lock file (``ops/_build.py``)
      makes a second replica wait for the first one's ``nvcc`` instead
      of racing it on the same files;
    * the SAME ``--seed``, so greedy failover across replicas is
      token-identical (``from_config`` draws every weight from one
      generator on the model's device).

    ``roles`` optionally assigns each replica a serving role — an
    index-aligned list of ``mixed`` / ``prefill`` / ``decode`` passed
    through as ``--role`` (the disaggregated fleet shape; the router
    reads it back from each replica's ``/healthz``).

    ``peers=True`` passes every OTHER replica's URL as ``--peer`` to
    each child (all ports are reserved up front, so the full URL set
    is known before any spawn) — the SIGTERM drain wiring: a replica
    told to exit migrates its live decoding streams to a healthy peer
    instead of dropping them.

    Returns a ``ServingFleet``; raises RuntimeError (after killing
    the partial fleet) if any replica fails to become ready."""
    import urllib.request

    if roles is not None and len(roles) != int(n):
        raise ValueError(
            f"roles must have one entry per replica: got "
            f"{len(roles)} for n={n}")
    procs, urls, logs, cmds, log_paths = [], [], [], [], []
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
    env = _worker_env()
    reserved = [_reserve_port() for _ in range(int(n))]
    all_urls = [f"http://127.0.0.1:{s.getsockname()[1]}"
                for s in reserved]
    try:
        for i, sock in enumerate(reserved):
            port = sock.getsockname()[1]
            cmd = [sys.executable, "-m", "paddle_tpu_torch.serving.httpd",
                   "--config", str(config), "--device", str(device),
                   "--mp", str(int(mp)),
                   "--dp", str(int(dp)),
                   "--port", str(port), "--seed", str(int(seed)),
                   "--num-slots", str(int(num_slots)),
                   "--max-seq-len", str(int(max_seq_len))]
            if kv_block_size is not None:
                cmd += ["--kv-block-size", str(int(kv_block_size))]
            if spec_k is not None:
                cmd += ["--spec-k", str(int(spec_k))]
            if prefill_chunk is not None:
                cmd += ["--prefill-chunk", str(int(prefill_chunk))]
            if roles is not None:
                cmd += ["--role", str(roles[i])]
            if peers:
                for j, peer_url in enumerate(all_urls):
                    if j != i:
                        cmd += ["--peer", peer_url]
            cmd += list(extra_args)
            cmds.append(list(cmd))
            # release the reservation at the last moment (httpd's
            # HTTPServer binds with SO_REUSEADDR, so the just-closed
            # probe never blocks the child's bind)
            sock.close()
            if log_dir:
                path = os.path.join(log_dir, f"replica.{i}.log")
                f = open(path, "w")
                logs.append(f)
                log_paths.append(path)
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=f,
                    stderr=subprocess.STDOUT))
            else:
                log_paths.append(None)
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL))
            urls.append(f"http://127.0.0.1:{port}")
    except BaseException:
        for s in reserved:
            try:
                s.close()
            except OSError:
                pass
        for p in procs:
            p.kill()
            p.wait()  # reap now; the parent may be long-lived
        for f in logs:
            f.close()
        raise
    fleet = ServingFleet(procs, urls, logs, cmds=cmds, env=env,
                         log_paths=log_paths)
    deadline = time.monotonic() + float(ready_timeout_s)
    pending = dict(enumerate(urls))
    while pending:
        for i, url in list(pending.items()):
            if procs[i].poll() is not None:
                fleet.stop()
                raise RuntimeError(
                    f"replica {i} ({url}) exited rc="
                    f"{procs[i].returncode} before becoming ready"
                    + (f"; see {log_dir}/replica.{i}.log"
                       if log_dir else ""))
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=1.0):
                    pending.pop(i)
            except Exception:
                pass
        if pending:
            if time.monotonic() > deadline:
                fleet.stop()
                raise RuntimeError(
                    f"fleet not ready after {ready_timeout_s}s: "
                    f"replicas {sorted(pending)} never answered "
                    "/healthz")
            time.sleep(0.2)
    return fleet


def _spawn_and_watch(args):
    """Spawn ``nproc_per_node`` local workers and watch them (reference
    launch_utils.py:526 ``watch_local_trainers``): any child failure
    aborts the whole job; the launcher's exit code is the first failing
    child's."""
    world = args.nnodes * args.nproc_per_node
    reserved = None
    if args.master:
        master = args.master
    else:
        # hold the probed port until the workers are spawning, so that a
        # concurrent launch cannot take it in between
        reserved = _reserve_port()
        master = f"127.0.0.1:{reserved.getsockname()[1]}"
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)
    procs, logs = [], []
    if reserved is not None:
        # released as late as possible: rank 0's store binds the port in
        # the first child (SO_REUSEADDR on the probe keeps that instant)
        reserved.close()
    for local in range(args.nproc_per_node):
        rank = args.node_rank * args.nproc_per_node + local
        env = _worker_env(args.devices_per_proc)
        env["PADDLE_TRAINERS_NUM"] = str(world)
        env["PADDLE_TRAINER_ID"] = str(rank)
        env["PADDLE_TRAINER_ENDPOINTS"] = master
        env["PADDLE_LOCAL_RANK"] = str(local)
        # children re-enter this module in single-process mode (the env
        # contract above carries the topology)
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nnodes", str(world), "--node_rank", str(rank),
               "--master", master, args.script] + list(args.script_args)
        if args.log_dir:
            f = open(os.path.join(args.log_dir, f"workerlog.{rank}"), "w")
            logs.append(f)
            procs.append(subprocess.Popen(cmd, env=env, stdout=f,
                                          stderr=subprocess.STDOUT))
        else:
            procs.append(subprocess.Popen(cmd, env=env))

    def _terminate_all(sig=signal.SIGTERM, grace=10.0):
        for p in procs:
            if p.poll() is None:
                try:
                    p.send_signal(sig)
                except ProcessLookupError:
                    pass
        deadline = time.monotonic() + grace
        for p in procs:
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                p.kill()
            p.wait()

    def _forward(signum, frame):
        _terminate_all()
        sys.exit(128 + signum)

    signal.signal(signal.SIGTERM, _forward)
    signal.signal(signal.SIGINT, _forward)
    try:
        while True:
            alive = False
            for p in procs:
                code = p.poll()
                if code is None:
                    alive = True
                elif code != 0:
                    # reference abort-all: one dead trainer kills the job
                    sys.stderr.write(
                        f"launch: local worker pid {p.pid} exited with "
                        f"code {code}; aborting all workers\n")
                    _terminate_all()
                    return code
            if not alive:
                return 0
            time.sleep(0.2)
    finally:
        for f in logs:
            f.close()


def launch_main(argv=None):
    parser = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    parser.add_argument("--nnodes", type=int,
                        default=int(os.environ.get("PADDLE_TRAINERS_NUM",
                                                   "1")))
    parser.add_argument("--node_rank", type=int,
                        default=int(os.environ.get("PADDLE_TRAINER_ID",
                                                   "0")))
    parser.add_argument("--master",
                        default=os.environ.get("MASTER_ADDR_PORT", ""))
    parser.add_argument("--nproc_per_node", type=int, default=1,
                        help="local worker processes; 1 = one process "
                             "driving every local card")
    parser.add_argument("--log_dir", default=None,
                        help="per-rank workerlog.N files (reference "
                             "launch_utils.py log naming)")
    parser.add_argument("--devices_per_proc", type=int, default=None,
                        help="run each worker on this many CPU ranks "
                             "(PADDLE_DEVICES_PER_PROC)")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.nproc_per_node > 1:
        sys.exit(_spawn_and_watch(args))

    os.environ["PADDLE_TRAINERS_NUM"] = str(args.nnodes)
    os.environ["PADDLE_TRAINER_ID"] = str(args.node_rank)
    if args.master:
        os.environ["PADDLE_TRAINER_ENDPOINTS"] = args.master
    if args.devices_per_proc:
        os.environ["PADDLE_DEVICES_PER_PROC"] = str(args.devices_per_proc)
    if args.nnodes > 1:
        from . import process
        process.init()
    sys.argv = [args.script] + list(args.script_args)
    runpy.run_path(args.script, run_name="__main__")


if __name__ == "__main__":
    launch_main()
