"""The port's fault plans and injector against the JAX package's, on the
CPU.

The cases of ``tests/unit/test_chaos.py``: ``FaultSpec`` validation
raises on the same bad inputs with the same words; ``FaultPlan.to_json``
is the JAX package's string byte for byte, and reads back from the env
plane (inline and ``@path``); the injector fires once on a step trigger
and once on a wall-clock trigger (each record before its execution,
each ``slow_host`` paired with its recovery), ignores other targets and
drains a late wall-clock spec; the ``ckpt_write_fail`` countdown.  Then
the kinds a chief runs on others: ``worker_crash`` and ``slow_host`` on
a launched worker, ``coord_drop`` through ``Cluster
.bounce_coord_service``, ``preempt_signal`` on this process; the
serving kinds raise without a fleet.
"""
import os
import signal
import sys
import time

import pytest

from autodist_tpu.runtime import faults as jfaults
from autodist_tpu_torch import telemetry
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.runtime import faults
from autodist_tpu_torch.runtime.cluster import Coordinator, LocalCluster
from autodist_tpu_torch.runtime.faults import (FaultInjector, FaultPlan,
                                               FaultSpec,
                                               install_ckpt_write_fail,
                                               load_fault_plan)


def _faults():
    return [r for r in telemetry.get().events if r["kind"] == "fault"]


def test_vocabulary_is_the_jax_packages():
    for name in ("FAULT_KINDS", "SERVING_FAULT_KINDS", "ALL_FAULT_KINDS",
                 "FAULT_PHASES", "TERMINAL_PHASES", "ENV_VAR"):
        assert getattr(faults, name) == getattr(jfaults, name), name


@pytest.mark.parametrize("kw", [dict(kind="disk_melt", at_step=1),
                                dict(kind="worker_crash"),
                                dict(kind="worker_crash", at_step=1,
                                     at_s=1.0)])
def test_fault_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        jfaults.FaultSpec(**kw)
    with pytest.raises(ValueError) as got:
        FaultSpec(**kw)
    assert str(got.value) == str(want.value)


def _plan(mod):
    return mod.FaultPlan(faults=[
        mod.FaultSpec("worker_crash", target="worker-1", at_s=1.0,
                      exit_code=3),
        mod.FaultSpec("ckpt_write_fail", target="chief", at_step=4, times=2),
        mod.FaultSpec("preempt_signal", target="localhost", at_step=2)],
        seed=99)


def test_plan_json_is_jax_byte_for_byte_and_ships(tmp_path, monkeypatch):
    plan = _plan(faults)
    assert plan.to_json() == _plan(jfaults).to_json()
    back = FaultPlan.from_json(_plan(jfaults).to_json())
    assert back.seed == 99 and [f.kind for f in back.faults] == \
        ["worker_crash", "ckpt_write_fail", "preempt_signal"]
    assert back.faults[0].exit_code == 3
    assert back.for_target("chief")[0].times == 2
    env = plan.ship({})
    monkeypatch.setenv("AUTODIST_TPU_FAULT_PLAN",
                       env["AUTODIST_TPU_FAULT_PLAN"])
    assert load_fault_plan().seed == 99
    path = tmp_path / "plan.json"
    path.write_text(plan.to_json())
    assert load_fault_plan(f"@{path}").faults[1].at_step == 4
    monkeypatch.delenv("AUTODIST_TPU_FAULT_PLAN")
    assert load_fault_plan() is None
    with pytest.raises(ValueError, match="not a fault plan"):
        FaultPlan.from_json('{"kind": "strategy"}')


def test_injector_triggers_once_on_step_and_walltime():
    telemetry.reset()
    t = {"now": 0.0}
    plan = FaultPlan(faults=[
        FaultSpec("slow_host", target="chief", at_step=3, duration_s=0.0),
        FaultSpec("slow_host", target="chief", at_s=5.0, duration_s=0.0)])
    inj = FaultInjector(plan, self_target="chief", clock=lambda: t["now"])
    assert inj.maybe_fire(0) == []
    t["now"] = 1.0
    assert [s.at_step for s in inj.maybe_fire(3)] == [3]
    assert inj.maybe_fire(3) == []                       # fires once
    t["now"] = 6.0
    assert [s.at_s for s in inj.maybe_fire(4)] == [5.0]
    assert inj.maybe_fire(99) == []
    recs = _faults()
    assert [r["phase"] for r in recs] == ["injected", "recovered"] * 2
    assert all(r["seed"] == 0 and r["target"] == "chief" for r in recs)


def test_injector_ignores_other_targets_and_drains_late_specs():
    plan = FaultPlan(faults=[FaultSpec("worker_crash", target="worker-2",
                                       at_step=0)])
    assert FaultInjector(plan, self_target="chief").maybe_fire(10) == []
    t = {"now": 0.0}

    def clock():
        t["now"] += 0.5
        return t["now"]

    late = FaultInjector(FaultPlan(faults=[FaultSpec(
        "slow_host", target="chief", at_s=2.0, duration_s=0.0)]),
        clock=clock)
    late.drain_pending()
    assert [s.at_s for s in late.fired] == [2.0]


def test_ckpt_write_fail_injection_counts_down(tmp_path):
    saver = Saver(str(tmp_path))
    countdown = install_ckpt_write_fail(saver, times=2)
    for _ in range(2):
        with pytest.raises(OSError, match="injected ckpt_write_fail"):
            saver._store.write(0, "x.pt", {}, {"rank": 0})
    assert countdown["left"] == 0
    inj = FaultInjector(FaultPlan(faults=[FaultSpec(
        "ckpt_write_fail", target="chief", at_step=1, times=1)]),
        saver=saver)
    inj.maybe_fire(1)
    with pytest.raises(OSError, match="injected"):
        saver._store.write(0, "x.pt", {}, {"rank": 0})
    with pytest.raises(RuntimeError, match="no saver"):
        FaultInjector(FaultPlan(faults=[FaultSpec(
            "ckpt_write_fail", at_step=0)])).maybe_fire(0)


def test_chief_side_kinds_on_a_launched_worker():
    """``slow_host`` stops a worker for its window and continues it (a
    recovery record after), ``worker_crash`` kills it: the fail-fast
    coordinator reports the death."""
    telemetry.reset()
    c = Coordinator(fail_fast=False)
    handle = c.launch("worker-1", [sys.executable, "-c",
                                   "import time; time.sleep(30)"])
    plan = FaultPlan(faults=[
        FaultSpec("slow_host", target="worker-1", at_step=1,
                  duration_s=0.2),
        FaultSpec("worker_crash", target="worker-1", at_step=2)])
    inj = FaultInjector(plan, workers=lambda: {w.name: w for w in c.workers})
    inj.maybe_fire(1)
    deadline = time.time() + 10
    while len(_faults()) < 2 and time.time() < deadline:
        time.sleep(0.05)
    assert [r["phase"] for r in _faults()] == ["injected", "recovered"]
    inj.maybe_fire(2)
    with pytest.raises(RuntimeError, match="worker-1"):
        c.join(timeout=30)
    assert handle.proc.returncode == -signal.SIGKILL


def test_coord_drop_bounces_the_service():
    from autodist_tpu_torch.runtime.coordination import service_client

    telemetry.reset()
    cluster = LocalCluster(1)
    try:
        addr = cluster._start_coord_service()
        client = service_client()
        client.put("k", b"v")
        inj = FaultInjector(FaultPlan(faults=[FaultSpec(
            "coord_drop", target="coord", at_step=0, duration_s=0.1)]),
            coord_bounce=cluster.bounce_coord_service)
        inj.maybe_fire(0)
        assert cluster.bounce_coord_service(0.0) == addr
        client.put("k", b"w")                # reconnected and retried
        assert client.get("k", 1000) == b"w"
        assert [r["phase"] for r in _faults()] == ["injected", "recovered"]
    finally:
        cluster.terminate()
    assert "AUTODIST_TPU_COORD_SERVICE" not in os.environ


def test_preempt_signal_and_serving_kinds():
    got = []
    previous = signal.signal(signal.SIGTERM, lambda *a: got.append(a[0]))
    try:
        FaultInjector(FaultPlan(faults=[FaultSpec(
            "preempt_signal", target="chief", at_step=2)])).maybe_fire(2)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert got == [signal.SIGTERM]
    spec = FaultSpec("replica_crash", target="r0", at_step=0)
    inj = FaultInjector(FaultPlan(faults=[spec]))
    assert inj.maybe_fire(0) == []       # no fleet owns the replica
    with pytest.raises(RuntimeError, match="no fleet attached"):
        inj._fire_replica_crash(spec, 0, 0.0)
