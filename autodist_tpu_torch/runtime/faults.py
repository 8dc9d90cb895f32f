"""Deterministic fault injection for the runtime planes.

The port's copy of ``autodist_tpu/runtime/faults.py``.  Every
supervised-recovery path is proven by an injected fault:

* :class:`FaultSpec`: one fault, a ``kind`` from :data:`FAULT_KINDS`, a
  ``target`` (a worker name, ``"chief"`` or ``"coord"``) and one trigger,
  ``at_step`` (when the target's loop reaches that step) or ``at_s``
  (wall-clock seconds after the injector starts);
* :class:`FaultPlan`: a seedable, JSON-serializable list of specs,
  which the chief ships to its workers in ``AUTODIST_TPU_FAULT_PLAN``
  (inline JSON, or ``@/path/to/plan.json``) for self-injection;
  process-level faults (kill or stop another process, bounce the
  coordination server) run on the chief;
* :class:`FaultInjector`: polled from a step loop
  (``injector.maybe_fire(step)``), fires each due spec once.

Every injection emits its ``kind="fault"`` record through
:func:`autodist_tpu_torch.telemetry.record_event` *before* it executes
(a crash must not lose its own record); the supervision, checkpoint and
elastic layers emit the ``detected`` / ``recovered`` / ``degraded`` /
``escalated`` / ``teardown`` outcomes.  The serving kinds
(:data:`SERVING_FAULT_KINDS`) stay in the vocabulary; firing one needs
a bound serving fleet, which the port does not have yet (ROADMAP Queue
1, item 6), so it raises.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Any, Callable, Optional

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.utils import logging

FAULT_KINDS = ("worker_crash", "worker_hang", "slow_host", "coord_drop",
               "ckpt_write_fail", "preempt_signal")
SERVING_FAULT_KINDS = ("replica_crash", "replica_hang", "replica_slow")
ALL_FAULT_KINDS = FAULT_KINDS + SERVING_FAULT_KINDS

# The lifecycle of kind="fault" records: injected -> a terminal phase.
FAULT_PHASES = ("injected", "detected", "recovered", "degraded",
                "escalated", "teardown")
TERMINAL_PHASES = ("recovered", "degraded", "escalated", "teardown")

ENV_VAR = "AUTODIST_TPU_FAULT_PLAN"


def fault_target() -> str:
    """This process's name in fault records: a worker's host marker
    (``$AUTODIST_TPU_WORKER``), else ``"chief"``."""
    return const.ENV.AUTODIST_TPU_WORKER.val or "chief"


@dataclasses.dataclass
class FaultSpec:
    """One fault to inject.  ``duration_s`` scopes the transient kinds
    (hang, slow, coord_drop); ``exit_code`` the crash; ``times`` how
    many checkpoint writes fail before the store heals."""

    kind: str
    target: str = "chief"
    at_step: Optional[int] = None
    at_s: Optional[float] = None
    duration_s: float = 0.5
    exit_code: int = 17
    times: int = 1

    def __post_init__(self):
        if self.kind not in ALL_FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {list(ALL_FAULT_KINDS)}")
        if (self.at_step is None) == (self.at_s is None):
            raise ValueError(
                f"{self.kind} needs exactly one trigger: at_step "
                f"(loop step) or at_s (wall-clock seconds)")

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    @classmethod
    def from_dict(cls, d: dict) -> "FaultSpec":
        return cls(**d)


@dataclasses.dataclass
class FaultPlan:
    """A seedable set of faults, shippable through the env plane."""

    faults: list = dataclasses.field(default_factory=list)
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps({"kind": "fault_plan", "seed": self.seed,
                           "faults": [f.to_dict() for f in self.faults]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        d = json.loads(text)
        if d.get("kind") not in (None, "fault_plan"):
            raise ValueError(f"not a fault plan: kind={d.get('kind')!r}")
        return cls(faults=[FaultSpec.from_dict(f)
                           for f in d.get("faults", [])],
                   seed=int(d.get("seed", 0)))

    def for_target(self, target: str) -> list:
        return [f for f in self.faults if f.target == target]

    def ship(self, env: Optional[dict] = None) -> dict:
        """``env`` (or a new dict) with the plan on
        ``AUTODIST_TPU_FAULT_PLAN``: the chief adds it to every worker
        launch so that workers self-inject their own faults."""
        env = env if env is not None else {}
        env[ENV_VAR] = self.to_json()
        return env


def load_fault_plan(value: Optional[str] = None) -> Optional[FaultPlan]:
    """The plan in ``AUTODIST_TPU_FAULT_PLAN`` (or ``value``): inline
    JSON, or ``@/path`` to a JSON file.  ``None`` when unset: faults are
    strictly opt-in."""
    if value is None:
        value = const.ENV.AUTODIST_TPU_FAULT_PLAN.val
    if not value:
        return None
    if value.startswith("@"):
        with open(value[1:]) as f:
            value = f.read()
    return FaultPlan.from_json(value)


def install_ckpt_write_fail(saver, times: int = 1,
                            where: str = "save") -> dict:
    """Arm a ``Saver`` so its next ``times`` checkpoint operations raise
    an injected ``OSError``: ``where="save"`` fails the write itself
    (the path the retry policy wraps), ``where="commit"`` fails the join
    of an async write (the path that must surface with the failed step).
    Returns the countdown (``{"left": n}``)."""
    store = saver._store
    countdown = {"left": int(times)}
    if where not in ("save", "commit"):
        raise ValueError(f"where={where!r}; expected 'save' or 'commit'")
    name = "write" if where == "save" else "join"
    orig = getattr(store, name)

    def failing(*args, **kwargs):
        if countdown["left"] > 0:
            countdown["left"] -= 1
            raise OSError(f"injected ckpt_write_fail ({where}, "
                          f"{countdown['left']} more to come)")
        return orig(*args, **kwargs)

    setattr(store, name, failing)
    return countdown


class FaultInjector:
    """Executes a :class:`FaultPlan` from a step loop.

    One injector a process.  ``self_target`` names this process in the
    plan; specs targeting it are self-injected.  A chief also passes
    ``workers`` (name -> :class:`~autodist_tpu_torch.runtime.cluster
    .WorkerHandle`, or a zero-argument callable returning that mapping)
    to run process-level faults on its workers, ``saver`` to arm
    checkpoint faults, and ``coord_bounce`` (``fn(down_s)``, e.g.
    :meth:`~autodist_tpu_torch.runtime.cluster.Cluster
    .bounce_coord_service`) for ``coord_drop``.

    Call :meth:`maybe_fire` once a loop iteration; each due spec fires
    exactly once and records its ``kind="fault"`` event before it
    executes.
    """

    def __init__(self, plan: FaultPlan, self_target: str = "chief", *,
                 workers: Any = None, saver: Any = None,
                 coord_bounce: Optional[Callable[[float], None]] = None,
                 fleet: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        self.plan = plan
        self.self_target = self_target
        self._workers = workers
        self._saver = saver
        self._coord_bounce = coord_bounce
        self._fleet = fleet
        self._clock = clock
        self._t0 = clock()
        self._pending = list(plan.faults)
        self.fired: list = []

    def _worker_map(self) -> dict:
        w = self._workers
        if w is None:
            return {}
        if callable(w):
            w = w()
        return dict(w)

    def _due(self, spec: FaultSpec, step: Optional[int],
             elapsed: float) -> bool:
        if spec.at_step is not None:
            return step is not None and step >= spec.at_step
        return elapsed >= spec.at_s

    def _owns(self, spec: FaultSpec) -> bool:
        if spec.kind in SERVING_FAULT_KINDS:
            return self._fleet is not None \
                and self._fleet.has_replica(spec.target)
        if spec.target == self.self_target:
            return True
        if spec.kind == "coord_drop" and self._coord_bounce is not None:
            return True
        return spec.target in self._worker_map()

    def maybe_fire(self, step: Optional[int] = None) -> list:
        """Fire every due spec this process owns; returns them."""
        elapsed = self._clock() - self._t0
        due = [s for s in self._pending
               if self._owns(s) and self._due(s, step, elapsed)]
        for spec in due:
            self._pending.remove(spec)
            self.fired.append(spec)
            self._fire(spec, step, elapsed)
        return due

    def drain_pending(self, step: Optional[int] = None):
        """Block until every wall-clock spec this process owns has
        fired: a short loop must not skip a late ``at_s`` trigger (a
        skipped injection would pass a recovery that never ran)."""
        while any(self._owns(s) and s.at_s is not None
                  for s in self._pending):
            time.sleep(0.05)
            self.maybe_fire(step)

    def _record(self, spec: FaultSpec, phase: str, step: Optional[int],
                elapsed: float, **extra):
        telemetry.counter(f"fault/{spec.kind}").inc()
        telemetry.record_event(
            "fault", fault=spec.kind, target=spec.target, phase=phase,
            step=step, t_s=round(elapsed, 3), seed=self.plan.seed, **extra)

    def _fire(self, spec: FaultSpec, step: Optional[int], elapsed: float):
        logging.warning("fault plan: injecting %s on %s (step=%s, t=%.2fs)",
                        spec.kind, spec.target, step, elapsed)
        self._record(spec, "injected", step, elapsed)
        getattr(self, f"_fire_{spec.kind}")(spec, step, elapsed)

    # ---- the six training kinds -------------------------------------- #
    def _fire_worker_crash(self, spec, step, elapsed):
        if spec.target == self.self_target:
            os._exit(spec.exit_code)
        self._worker_map()[spec.target].kill()

    def _fire_worker_hang(self, spec, step, elapsed):
        if spec.target == self.self_target:
            os.kill(os.getpid(), signal.SIGSTOP)
            return   # resumed only by a SIGCONT
        handle = self._worker_map()[spec.target]
        os.killpg(os.getpgid(handle.proc.pid), signal.SIGSTOP)

    def _fire_slow_host(self, spec, step, elapsed):
        if spec.target == self.self_target:
            time.sleep(spec.duration_s)
            self._record(spec, "recovered", step, self._clock() - self._t0,
                         action="resumed", slow_s=spec.duration_s)
            return
        # On the chief: stop the worker, continue it after the window.
        handle = self._worker_map()[spec.target]
        pgid = os.getpgid(handle.proc.pid)
        os.killpg(pgid, signal.SIGSTOP)

        def resume():
            time.sleep(spec.duration_s)
            try:
                os.killpg(pgid, signal.SIGCONT)
                self._record(spec, "recovered", step,
                             self._clock() - self._t0, action="resumed",
                             slow_s=spec.duration_s)
            except ProcessLookupError:
                pass   # supervision already reaped it as a hang

        threading.Thread(target=resume, daemon=True).start()

    def _fire_coord_drop(self, spec, step, elapsed):
        if self._coord_bounce is None:
            raise RuntimeError(
                "coord_drop fired on a process with no coord_bounce "
                "hook (only the chief owns the coordination server)")
        self._coord_bounce(spec.duration_s)
        self._record(spec, "recovered", step, self._clock() - self._t0,
                     action="server_restarted", down_s=spec.duration_s)

    def _fire_ckpt_write_fail(self, spec, step, elapsed):
        if self._saver is None:
            raise RuntimeError(
                "ckpt_write_fail fired on a process with no saver "
                "attached (pass saver= to the FaultInjector)")
        install_ckpt_write_fail(self._saver, times=spec.times)

    def _fire_preempt_signal(self, spec, step, elapsed):
        os.kill(os.getpid(), signal.SIGTERM)

    # ---- the serving kinds (a fleet's replicas) ----------------------- #
    def _require_fleet(self, spec):
        if self._fleet is None:
            raise RuntimeError(
                f"{spec.kind} fired with no fleet attached (pass "
                "fleet= to the FaultInjector)")
        return self._fleet

    def _fire_replica_crash(self, spec, step, elapsed):
        self._require_fleet(spec).inject(spec.target, "crash")

    def _fire_replica_hang(self, spec, step, elapsed):
        self._require_fleet(spec).inject(spec.target, "hang")

    def _fire_replica_slow(self, spec, step, elapsed):
        self._require_fleet(spec).inject(spec.target, "slow",
                                         duration_s=spec.duration_s)
