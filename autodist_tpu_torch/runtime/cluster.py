"""Multi-host cluster runtime: launcher, coordinator, failure watcher.

The port's copy of ``autodist_tpu/runtime/cluster.py``.  Every process
of a job runs the same user script, joined in one ``torch.distributed``
job; what the runtime adds is:

* the chief-launches-workers process model (:class:`Cluster`,
  :class:`Coordinator`) with the env plane (``AUTODIST_TPU_WORKER``,
  ``AUTODIST_TPU_STRATEGY_ID``, ``AUTODIST_TPU_PROCESS_ID``,
  ``AUTODIST_TPU_NUM_PROCESSES``, ``AUTODIST_TPU_COORDINATOR``, the
  coordination service's address and token, and torchrun's
  ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``): a worker's
  ``ResourceSpec({}).bootstrap()`` joins the chief's job from it, and
  its ``AutoDist`` loads the strategy the chief published under
  ``strategy/<id>`` on the coordination service;
* fail-fast watchers per worker (a worker exiting non-zero stops the
  others and ``join`` raises) with teardown at exit, and opt-in
  supervision (:class:`SupervisionConfig`): restarts with backoff up to
  a budget, heartbeat hang detection over the coordination service
  (:class:`HeartbeatMonitor`, :func:`heartbeat`), and escalation of the
  survivor set (e.g. to :meth:`~autodist_tpu_torch.elastic
  .ElasticController.resume`).  With supervision off, fail-fast is
  untouched and records nothing;
* :func:`make_global_batch`: this process's placed part of a global
  batch.

Remote transport is plain ``ssh`` (the environment travels on its
standard input, never on the command line); :class:`LocalCluster`
spawns every worker on this machine.
"""
from __future__ import annotations

import atexit
import dataclasses
import os
import random
import shlex
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Optional, Sequence

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.runtime.retry import RetryPolicy
from autodist_tpu_torch.utils import logging

# The line the remote bootstrap prints before it execs the worker, so
# that the chief knows the remote pid (killing the local ssh client
# only drops the tunnel and leaves the remote process running).
_REMOTE_PID_MARKER = "__AUTODIST_TPU_REMOTE_PID__="
_LOCAL_HOSTS = ("localhost", "127.0.0.1")


class WorkerHandle:
    """One launched worker process and its watcher thread.  ``spec`` is
    the launch request (argv, env, host, cwd), so that a supervising
    coordinator can restart it verbatim; ``superseded`` marks a handle
    whose failure a restart or an escalation already consumed."""

    def __init__(self, name: str, proc: subprocess.Popen,
                 on_failure: Callable[["WorkerHandle", int], None],
                 *, host: Optional[str] = None,
                 spec: Optional[dict] = None):
        self.name = name
        self.proc = proc
        self.host = host
        self.spec = spec
        self.remote_pid: Optional[int] = None
        self.superseded = False
        self.declared_fault: Optional[str] = None   # set by declare_dead
        self.started_s = time.monotonic()
        self._on_failure = on_failure
        if host and proc.stdout is not None:
            self._pid_thread = threading.Thread(
                target=self._read_remote_pid, daemon=True)
            self._pid_thread.start()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self):
        rc = self.proc.wait()
        if rc != 0:
            self._on_failure(self, rc)

    def _read_remote_pid(self):
        """The bootstrap's pid marker off the ssh client's output, then
        the worker's remaining output relayed to ours."""
        try:
            for raw in self.proc.stdout:
                line = raw.decode(errors="replace")
                if self.remote_pid is None \
                        and line.startswith(_REMOTE_PID_MARKER):
                    try:
                        self.remote_pid = int(
                            line[len(_REMOTE_PID_MARKER):].strip())
                    except ValueError:
                        logging.warning(
                            "worker %s: unparseable remote pid marker %r",
                            self.name, line.strip())
                    continue
                sys.stdout.write(line)
        except (OSError, ValueError):
            pass   # the ssh client went away mid-read

    @property
    def running(self) -> bool:
        return self.proc.poll() is None

    def _remote_kill(self, sig_name: str):
        """The kill sent to the remote process group over a second ssh
        exec (fire and forget: teardown never blocks on a dead host)."""
        pid = self.remote_pid
        if pid is None:
            logging.warning(
                "worker %s on %s: no remote pid captured; killing only "
                "the local ssh client", self.name, self.host)
            return
        cmd = (f"kill -{sig_name} -- -{pid} 2>/dev/null "
               f"|| kill -{sig_name} {pid}")
        try:
            subprocess.Popen(
                ["ssh", "-o", "BatchMode=yes", self.host, cmd],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        except OSError as e:
            logging.warning("worker %s: remote kill on %s failed: %s",
                            self.name, self.host, e)

    def terminate(self):
        if not self.running:
            return
        if self.host:
            self._remote_kill("TERM")
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            self.proc.terminate()

    def kill(self):
        """SIGKILL the worker's process group: the one signal a stopped
        (hung) worker still honours."""
        if not self.running:
            return
        if self.host:
            self._remote_kill("KILL")
        try:
            os.killpg(os.getpgid(self.proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            self.proc.kill()


@dataclasses.dataclass
class SupervisionConfig:
    """Opt-in supervised recovery for a :class:`Coordinator`.

    A worker exiting non-zero restarts up to ``max_restarts`` times,
    ``restart_backoff`` apart; a worker whose heartbeat counter stalls
    past ``heartbeat_timeout_s`` (``heartbeat_startup_grace_s`` before
    its first beat) is declared dead and takes the same path; one dead
    beyond its budget escalates: the survivors go to ``on_escalate``
    instead of a teardown.  ``saver`` is the store an escalation
    resumes from (lint ADT080 refuses escalation without one);
    ``step_time_estimate_s`` is the SSP context of ADT082.  Lint a
    config with :func:`autodist_tpu_torch.analysis.lint_supervision`
    before launch."""

    max_restarts: int = 2
    restart_backoff: RetryPolicy = dataclasses.field(
        default_factory=lambda: RetryPolicy(
            max_attempts=8, base_delay_s=0.5, cap_delay_s=30.0))
    heartbeat_interval_s: Optional[float] = None
    heartbeat_timeout_s: Optional[float] = None
    heartbeat_startup_grace_s: float = 60.0
    escalate: bool = False
    saver: Any = None
    on_escalate: Optional[Callable[[list], None]] = None
    step_time_estimate_s: float = 1.0

    def to_dict(self) -> dict:
        return {
            "max_restarts": self.max_restarts,
            "restart_backoff": {
                "max_attempts": self.restart_backoff.max_attempts,
                "base_delay_s": self.restart_backoff.base_delay_s,
                "cap_delay_s": self.restart_backoff.cap_delay_s,
            },
            "heartbeat_interval_s": self.heartbeat_interval_s,
            "heartbeat_timeout_s": self.heartbeat_timeout_s,
            "heartbeat_startup_grace_s": self.heartbeat_startup_grace_s,
            "escalate": self.escalate,
            "has_saver": self.saver is not None,
            "step_time_estimate_s": self.step_time_estimate_s,
        }


class Coordinator:
    """The chief's process manager.  :meth:`launch` starts one worker;
    a worker exiting non-zero stops every worker (``fail_fast``) and
    :meth:`join` raises.  With ``supervision``, failures restart and
    escalate instead (:class:`SupervisionConfig`), each restart or
    escalation recorded as a ``kind="fault"`` event."""

    def __init__(self, fail_fast: bool = True,
                 supervision: Optional[SupervisionConfig] = None):
        self.fail_fast = fail_fast
        self.supervision = supervision
        self.workers: list = []
        self._terminated = False
        self._first_failure: Optional[tuple] = None
        self._restarts: dict = {}
        self._escalated = threading.Event()
        self._lock = threading.Lock()
        atexit.register(self.terminate)

    def _worker_failed(self, worker: WorkerHandle, rc: int):
        with self._lock:
            if self._terminated or worker.superseded:
                return  # we stopped it ourselves: not a failure
        if self.supervision is not None:
            self._supervise_failure(worker, rc)
            return
        with self._lock:
            if self._first_failure is None:
                self._first_failure = (worker.name, rc)
        logging.error("worker %s exited with %d", worker.name, rc)
        if self.fail_fast:
            self.terminate()

    def _supervise_failure(self, worker: WorkerHandle, rc: int):
        """Restart with backoff, then escalate (on the dead worker's
        watcher thread)."""
        sup = self.supervision
        fault = worker.declared_fault or "worker_crash"
        n = self._restarts.get(worker.name, 0)
        telemetry.counter("runtime/worker_failures").inc()
        logging.error("worker %s exited with %d (restart %d/%d used)",
                      worker.name, rc, n, sup.max_restarts)
        if n < sup.max_restarts and worker.spec is not None:
            delay = sup.restart_backoff._jittered(
                n + 1, random.Random(sup.restart_backoff.seed))
            logging.info("restarting worker %s in %.2fs", worker.name, delay)
            time.sleep(delay)
            with self._lock:
                if self._terminated:
                    return
                self._restarts[worker.name] = n + 1
                worker.superseded = True
            spec = dict(worker.spec)
            env = dict(spec.get("env") or {})
            # A restarted worker knows it is incarnation n + 1 (a fault
            # plan's self-injected fault must not fire again).
            env["AUTODIST_TPU_WORKER_INCARNATION"] = str(n + 1)
            self.launch(worker.name, spec["argv"], env=env,
                        host=spec.get("host"), cwd=spec.get("cwd"))
            telemetry.counter("runtime/worker_restarts").inc()
            telemetry.record_event(
                "fault", fault=fault, target=worker.name,
                phase="recovered", action="restart", restart=n + 1, rc=rc)
            return
        survivors = [w for w in self.workers
                     if w.running and not w.superseded and w is not worker]
        if sup.escalate or sup.on_escalate is not None:
            with self._lock:
                # The escalation consumes the death: join() must not
                # raise a failure the shrink recovered.
                worker.superseded = True
            self._escalated.set()
            telemetry.counter("runtime/escalations").inc()
            telemetry.record_event(
                "fault", fault=fault, target=worker.name,
                phase="escalated", action="shrink_to_survivors",
                survivors=[w.name for w in survivors], rc=rc)
            logging.error("worker %s dead beyond its restart budget; "
                          "escalating with %d survivor(s)", worker.name,
                          len(survivors))
            if sup.on_escalate is not None:
                try:
                    sup.on_escalate(survivors)
                except Exception as e:  # noqa: BLE001 — a watcher thread
                    logging.error("escalation callback failed: %s", e)
            return
        with self._lock:
            if self._first_failure is None:
                self._first_failure = (worker.name, rc)
        telemetry.record_event(
            "fault", fault=fault, target=worker.name, phase="teardown",
            action="fail_fast", rc=rc)
        if self.fail_fast:
            self.terminate()

    @property
    def escalated(self) -> bool:
        """Whether a worker died beyond its budget and the survivors
        were handed to escalation; the training loop checks it between
        steps."""
        return self._escalated.is_set()

    def declare_dead(self, worker: WorkerHandle, reason: str,
                     fault: str = "worker_hang"):
        """Kill a live but unresponsive worker (hang detection); its
        watcher then runs the supervised failure path."""
        if not worker.running or worker.superseded:
            return
        logging.error("declaring worker %s dead: %s", worker.name, reason)
        telemetry.counter("runtime/workers_declared_dead").inc()
        telemetry.record_event("fault", fault=fault, target=worker.name,
                               phase="detected", reason=reason)
        worker.declared_fault = fault
        worker.kill()

    def _failures(self) -> list:
        """Every failed worker's ``(name, rc)``, but those stopped by our
        own teardown and those a restart or escalation consumed; the
        first failure is always reported."""
        out = []
        for w in self.workers:
            rc = w.proc.poll()
            if rc is not None and rc != 0 and not w.superseded \
                    and not (self._terminated and rc < 0):
                out.append((w.name, rc))
        if self._first_failure is not None and self._first_failure not in out:
            out.insert(0, self._first_failure)
        return out

    def launch(self, name: str, argv: Sequence[str], *,
               env: Optional[dict] = None, host: Optional[str] = None,
               cwd: Optional[str] = None) -> WorkerHandle:
        """Launch one worker here, or on ``host`` over ssh.  A remote
        worker's environment travels on ssh's standard input (a
        ``/bin/sh -s`` bootstrap that also reports the remote pid),
        never on a command line ``ps`` shows."""
        spec = {"argv": list(argv), "env": dict(env or {}), "host": host,
                "cwd": cwd}
        full_env = dict(os.environ)
        full_env.update(env or {})
        stdin_script = None
        if host:
            lines = [f"export {k}={shlex.quote(v)}"
                     for k, v in (env or {}).items()]
            lines.append(f'echo "{_REMOTE_PID_MARKER}$$"')
            lines.append("exec " + " ".join(shlex.quote(a) for a in argv))
            stdin_script = "\n".join(lines) + "\n"
            argv = ["ssh", "-o", "BatchMode=yes", host, "/bin/sh -s"]
        proc = subprocess.Popen(
            list(argv), env=full_env, cwd=cwd, start_new_session=True,
            stdin=subprocess.PIPE if stdin_script else None,
            stdout=subprocess.PIPE if host else None)
        if stdin_script:
            proc.stdin.write(stdin_script.encode())
            proc.stdin.close()
        handle = WorkerHandle(name, proc, self._worker_failed, host=host,
                              spec=spec)
        self.workers.append(handle)
        logging.info("launched worker %s (pid %d)%s", name, proc.pid,
                     f" on {host}" if host else "")
        return handle

    def join(self, timeout: Optional[float] = None):
        """Wait for every worker; raise if any failed.  The
        ``TimeoutError`` and the ``RuntimeError`` list every failure,
        not the first one polled."""
        deadline = time.time() + timeout if timeout is not None else None
        timed_out: list = []
        for w in self.workers:
            remaining = None if deadline is None \
                else max(deadline - time.time(), 0.01)
            try:
                w.proc.wait(timeout=remaining)
                # The watcher consumes the exit first: a supervised
                # restart appends the replacement this loop waits on.
                w.thread.join(timeout=None if deadline is None
                              else max(deadline - time.time(), 0.01))
                if w.thread.is_alive():
                    raise subprocess.TimeoutExpired(w.name, timeout)
            except subprocess.TimeoutExpired:
                timed_out = [v.name for v in self.workers
                             if v.proc.poll() is None and not v.superseded]
                if not timed_out:
                    timed_out = [f"{w.name} (supervision in progress)"]
                break
        if timed_out:
            failures = self._failures()
            self.terminate()
            detail = f"; workers failed: {failures}" if failures else ""
            raise TimeoutError(f"worker(s) {timed_out} timed out after "
                               f"{timeout}s{detail}")
        failures = self._failures()
        if failures:
            raise RuntimeError(f"workers failed: {failures}")

    def terminate(self):
        with self._lock:
            self._terminated = True
        for w in self.workers:
            w.terminate()


class HeartbeatMonitor(threading.Thread):
    """The chief's hang detection over the coordination service: workers
    bump ``hb/<name>`` every interval (:func:`heartbeat`); a worker
    whose counter has not moved for ``timeout_s`` (``startup_grace_s``
    before its first beat) is declared dead through
    :meth:`Coordinator.declare_dead`.  Freshness is the chief's receive
    time, so that a remote clock's skew cannot fake a hang."""

    def __init__(self, coordinator: Coordinator,
                 client_factory: Callable[[], Any],
                 interval_s: float, timeout_s: float,
                 startup_grace_s: float = 60.0):
        super().__init__(daemon=True)
        self.coordinator = coordinator
        self._client_factory = client_factory
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        self.startup_grace_s = startup_grace_s
        self._stop = threading.Event()
        # handle -> [count, last change (monotonic), beaten since start]:
        # keyed by handle, so that a restarted worker starts afresh.
        self._last: dict = {}

    def stop(self):
        self._stop.set()

    def run(self):
        client = None
        while not self._stop.wait(self.interval_s):
            if client is None:
                try:
                    client = self._client_factory()
                except OSError:
                    continue
                if client is None:
                    continue
            client = self.poll_once(client)

    def poll_once(self, client):
        """One freshness sweep over the live workers; returns the client
        for the next (``None`` after a control-plane error: no death is
        declared on a blind sample)."""
        for w in list(self.coordinator.workers):
            if not w.running or w.superseded:
                self._last.pop(w, None)
                continue
            try:
                count = client.counter_add(f"hb/{w.name}", 0)
            except OSError:
                return None
            now = time.monotonic()
            last = self._last.get(w)
            if last is None:
                self._last[w] = [count, max(now, w.started_s), False]
            elif count != last[0]:
                self._last[w] = [count, now, True]
            else:
                limit = self.timeout_s if last[2] \
                    else max(self.startup_grace_s, self.timeout_s)
                if now - last[1] > limit:
                    self._last.pop(w, None)
                    self.coordinator.declare_dead(
                        w, reason=f"no heartbeat for {now - last[1]:.1f}s "
                                  f"(timeout {limit}s)")
        return client


def heartbeat(client, name: str, interval_s: float,
              stop: Optional[threading.Event] = None) -> threading.Event:
    """A worker's heartbeat (a daemon thread): bump ``hb/<name>`` every
    ``interval_s`` through ``client``; returns the stop event.  An
    unreachable service only logs: the heartbeat never kills the worker
    it reports for."""
    stop = stop or threading.Event()

    def loop():
        while not stop.wait(interval_s):
            try:
                client.counter_add(f"hb/{name}", 1)
            except OSError as e:
                logging.warning("heartbeat for %s not delivered: %s", name, e)

    threading.Thread(target=loop, daemon=True,
                     name=f"heartbeat-{name}").start()
    return stop


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class Cluster:
    """The launch plan of a job: the chief (process 0, this process)
    starts the same user script on every host of ``hosts`` with the env
    plane, publishes the strategy to the coordination service it runs,
    and sets the job's ``torch.distributed`` rendezvous.

    Where ``resource_spec`` leaves its ``multihost`` block unset, the
    chief's spec gets the job's at construction: ``num_processes`` (the
    hosts plus the chief), ``process_id`` 0, a ``coordinator`` on a free
    port of this machine and, where undeclared, ``topology.num_devices``
    (one device a process, so that a builder plans before the job
    forms); ``cluster.resource_spec.bootstrap()`` and each worker's
    ``ResourceSpec({}).bootstrap()`` then form one job.
    """

    def __init__(self, resource_spec=None,
                 hosts: Optional[Sequence[str]] = None, *,
                 coord_service: bool = True,
                 coord_host: Optional[str] = None,
                 supervision: Optional[SupervisionConfig] = None):
        from autodist_tpu_torch.resource import ResourceSpec

        if not isinstance(resource_spec, ResourceSpec):
            resource_spec = ResourceSpec(resource_spec)
        self.resource_spec = resource_spec
        self.hosts = list(hosts or [])
        self.coordinator = Coordinator(supervision=supervision)
        self._monitor: Optional[HeartbeatMonitor] = None
        self._use_coord_service = coord_service
        self._coord_host = coord_host or self._default_coord_host()
        self._coord_server = None
        self._exported: dict = {}
        self._locals = self._job_plan() if self.is_chief else []
        atexit.register(self.terminate)

    @property
    def _remote(self) -> bool:
        return any(h not in _LOCAL_HOSTS for h in self.hosts)

    def _default_coord_host(self) -> str:
        """Where workers reach the chief: the rendezvous's host when
        set, the chief's name when a worker is remote, else loopback."""
        coordinator = getattr(self.resource_spec, "coordinator", "")
        if coordinator:
            return coordinator.rpartition(":")[0] or coordinator
        return socket.getfqdn() if self._remote else "127.0.0.1"

    @property
    def is_chief(self) -> bool:
        return not const.ENV.AUTODIST_TPU_WORKER.val

    def _export(self, key: str, value: str):
        """Set ``key`` in this process's environment, remembering what
        to put back at :meth:`terminate`."""
        self._exported.setdefault(key, os.environ.get(key))
        os.environ[key] = value

    def _start_coord_service(self) -> str:
        """The coordination server (the chief's); its address and token
        exported to this process's environment for its own clients."""
        if self._coord_server is None:
            from autodist_tpu_torch.runtime.coordination import (
                CoordServer, reserve_coord_port)

            self._exported.setdefault(
                "AUTODIST_TPU_COORD_TOKEN",
                os.environ.get("AUTODIST_TPU_COORD_TOKEN"))
            self._coord_server = CoordServer(listen_sock=reserve_coord_port())
            addr = f"{self._coord_host}:{self._coord_server.port}"
            self._export("AUTODIST_TPU_COORD_SERVICE", addr)
            logging.info("coordination service at %s", addr)
        return f"{self._coord_host}:{self._coord_server.port}"

    def _job_plan(self) -> list:
        """Fill the chief's multihost block where unset; returns each
        worker's ``(LOCAL_RANK, LOCAL_WORLD_SIZE)``."""
        spec, n = self.resource_spec, len(self.hosts) + 1
        if not spec.is_multihost:
            spec.num_processes, spec.process_id = n, 0
        elif spec.num_processes != n:
            raise ValueError(
                f"the spec's job has {spec.num_processes} processes; this "
                f"cluster launches {len(self.hosts)} worker(s) beside the "
                "chief")
        if not spec.coordinator:
            spec.coordinator = f"{self._coord_host}:{_free_port()}"
        if spec._requested_devices is None:
            spec._requested_devices = n
        names = ["localhost" if h in _LOCAL_HOSTS else h
                 for h in ["localhost"] + self.hosts]
        seen: dict = {}
        local_ranks = []
        for h in names:
            local_ranks.append(seen.get(h, 0))
            seen[h] = local_ranks[-1] + 1
        spec.local_rank, spec.local_processes = 0, seen["localhost"]
        return [(r, seen[h]) for h, r in zip(names[1:], local_ranks[1:])]

    def launch_clients(self, strategy=None,
                       argv: Optional[Sequence[str]] = None,
                       extra_env: Optional[dict] = None):
        """Chief: start the user script on every worker host.

        ``strategy`` is a built Strategy (published to the coordination
        service as ``strategy/<id>``, where each worker's ``AutoDist``
        loads it), a bare id string (the env hand-off alone), or
        ``None``.  Returns the workers' handles."""
        if not self.is_chief:
            return []
        strategy_id = ("" if strategy is None
                       else strategy if isinstance(strategy, str)
                       else strategy.id)
        coord_addr = ""
        if self._use_coord_service:
            try:
                coord_addr = self._start_coord_service()
            except OSError as e:
                logging.warning("coordination service unavailable (%s); "
                                "workers cannot load a published strategy",
                                e)
        if coord_addr and strategy is not None \
                and not isinstance(strategy, str):
            from autodist_tpu_torch.runtime.coordination import service_client

            client = service_client()
            if client is not None:
                client.put(f"strategy/{strategy_id}",
                           strategy.to_json().encode())
        argv = list(argv or [sys.executable, os.path.abspath(sys.argv[0]),
                             *sys.argv[1:]])
        handles = []
        for i, host in enumerate(self.hosts):
            env = {
                "AUTODIST_TPU_WORKER": host,
                "AUTODIST_TPU_STRATEGY_ID": strategy_id,
                "AUTODIST_TPU_PROCESS_ID": str(i + 1),
                "AUTODIST_TPU_NUM_PROCESSES": str(len(self.hosts) + 1),
                "AUTODIST_TPU_COORDINATOR": self.resource_spec.coordinator,
                "LOCAL_RANK": str(self._locals[i][0]),
                "LOCAL_WORLD_SIZE": str(self._locals[i][1]),
            }
            if coord_addr:
                env["AUTODIST_TPU_COORD_SERVICE"] = coord_addr
                token = os.environ.get("AUTODIST_TPU_COORD_TOKEN", "")
                if token:
                    env["AUTODIST_TPU_COORD_TOKEN"] = token
            env.update(extra_env or {})
            handles.append(self.coordinator.launch(
                f"worker-{i + 1}", argv, env=env,
                host=None if host in _LOCAL_HOSTS else host))
        return handles

    def start_heartbeat_monitor(self) -> Optional[HeartbeatMonitor]:
        """Start the chief's hang detection (needs a supervision config
        with heartbeat knobs and the running coordination service);
        workers opt in with :func:`heartbeat`."""
        sup = self.coordinator.supervision
        if sup is None or sup.heartbeat_interval_s is None \
                or sup.heartbeat_timeout_s is None:
            return None
        if self._monitor is None:
            from autodist_tpu_torch.runtime.coordination import service_client

            self._monitor = HeartbeatMonitor(
                self.coordinator, service_client,
                interval_s=sup.heartbeat_interval_s,
                timeout_s=sup.heartbeat_timeout_s,
                startup_grace_s=sup.heartbeat_startup_grace_s)
            self._monitor.start()
        return self._monitor

    def bounce_coord_service(self, down_s: float = 0.5) -> str:
        """Stop the coordination server, wait ``down_s`` and restart it
        on the same port (the ``coord_drop`` fault): every client's
        socket drops and reconnects; the server's state is lost, as in
        a real chief bounce.  Returns the (unchanged) address."""
        if self._coord_server is None:
            raise RuntimeError("no coordination server running")
        from autodist_tpu_torch.runtime.coordination import CoordServer

        port = self._coord_server.port
        self._coord_server.stop()
        time.sleep(down_s)
        # Sockets lingering in FIN-WAIT-2 can hold the port briefly.
        deadline = time.monotonic() + 10.0
        while True:
            try:
                self._coord_server = CoordServer(port=port)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.1)
        return f"{self._coord_host}:{port}"

    def join(self, timeout: Optional[float] = None):
        self.coordinator.join(timeout)

    def terminate(self):
        """Stop the monitor, the workers and the coordination server,
        and put back the environment this cluster exported."""
        if self._monitor is not None:
            self._monitor.stop()
            self._monitor = None
        self.coordinator.terminate()
        if self._coord_server is not None:
            from autodist_tpu_torch.runtime import coordination

            coordination.reset_service_client()
            self._coord_server.stop()
            self._coord_server = None
        for key, value in self._exported.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        self._exported = {}


class LocalCluster(Cluster):
    """``num_workers`` workers on this machine: the launcher, env
    hand-off, coordination service, watchers and supervision of a real
    fleet, every process here."""

    def __init__(self, num_workers: int, resource_spec=None, **kwargs):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        super().__init__(resource_spec,
                         hosts=["localhost"] * num_workers, **kwargs)


def make_global_batch(batch, mesh, device=None):
    """This process's placed part of a global batch: each leaf's dim 0
    cut over the mesh's replica group, ``dcn x data`` (a leaf without
    one whole), on
    ``device`` (``None``: the card).  With one process, the batch on the
    device."""
    from autodist_tpu_torch.device import resolve_device
    from autodist_tpu_torch.runner import cut_leaf

    dev = resolve_device(device)
    cuts = ((0, mesh.replica_axis()),)
    return {name: cut_leaf(name, x, cuts).to(dev)
            for name, x in batch.items()}
