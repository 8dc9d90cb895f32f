"""The port's runtime against the JAX package's, on the CPU.

The cases of ``tests/unit/test_runtime.py``'s process plane: the
coordinator's success, fail-fast and timeout; the env plane and a
``LocalCluster`` of 2; supervised restarts, escalation, supervision off,
every concurrent failure reported, a join timeout naming hung and
crashed workers, the heartbeat monitor declaring a stalled worker dead,
and remote teardown through a fake ``ssh``.  Then what the port adds:

* a 2-process job that a chief subprocess launches through ``Cluster``:
  both ranks ``bootstrap()`` from the ``multihost`` env into one gloo
  job, the worker loads the chief's ``AllReduce(chunk_size=256)`` from
  the coordination service, and the published JSON equals the JAX
  package's ``strategy.to_json()`` for the same builder and model;
* ``lint_supervision`` gives the JAX package's codes on the same
  configs; the resource spec's ``multihost`` and ``topology`` keys;
* axis scopes that interleave on two threads leave no axis bound.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import AllReduce as JAllReduce
from autodist_tpu.analysis import lint_supervision as jlint_supervision
from autodist_tpu.resource import ResourceSpec as JResourceSpec
from autodist_tpu.runtime.cluster import SupervisionConfig as JSupervision
from autodist_tpu.runtime.retry import RetryPolicy as JRetryPolicy
from autodist_tpu_torch import telemetry
from autodist_tpu_torch.analysis import lint_supervision
from autodist_tpu_torch.parallel.axis import Axis, axis_scope, bound_axis
from autodist_tpu_torch.runtime.cluster import (Cluster, Coordinator,
                                                HeartbeatMonitor,
                                                LocalCluster,
                                                SupervisionConfig,
                                                make_global_batch)
from autodist_tpu_torch.runtime.retry import RetryPolicy
from tests.unit.test_end_to_end import make_trainable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _faults():
    return [r for r in telemetry.get().events if r["kind"] == "fault"]


def test_coordinator_success_join():
    c = Coordinator()
    c.launch("ok-1", [sys.executable, "-c", "print('hi')"])
    c.launch("ok-2", [sys.executable, "-c", "import time; time.sleep(0.2)"])
    c.join(timeout=30)


def test_coordinator_fail_fast_kills_siblings():
    c = Coordinator()
    slow = c.launch("slow", [sys.executable, "-c",
                             "import time; time.sleep(60)"])
    c.launch("bad", [sys.executable, "-c", "import sys; sys.exit(3)"])
    with pytest.raises(RuntimeError, match="bad.*3"):
        c.join(timeout=30)
    deadline = time.time() + 10
    while slow.running and time.time() < deadline:
        time.sleep(0.1)
    assert not slow.running


def test_coordinator_timeout():
    c = Coordinator()
    c.launch("hang", [sys.executable, "-c", "import time; time.sleep(60)"])
    with pytest.raises(TimeoutError):
        c.join(timeout=1)


def test_cluster_launch_env_plane(tmp_path):
    out = tmp_path / "env.txt"
    script = tmp_path / "w.py"
    script.write_text(
        "import os\n"
        "e = os.environ.get\n"
        "open(%r, 'w').write('|'.join(e(k, '') for k in (\n"
        "    'AUTODIST_TPU_WORKER', 'AUTODIST_TPU_STRATEGY_ID',\n"
        "    'AUTODIST_TPU_PROCESS_ID', 'AUTODIST_TPU_NUM_PROCESSES',\n"
        "    'LOCAL_RANK', 'LOCAL_WORLD_SIZE')))\n" % str(out))
    cluster = Cluster(port.ResourceSpec({}), hosts=["localhost"])
    try:
        cluster.launch_clients("strat-42", argv=[sys.executable, str(script)])
        cluster.join(timeout=30)
    finally:
        cluster.terminate()
    assert out.read_text() == "localhost|strat-42|1|2|1|2"
    spec = cluster.resource_spec
    assert (spec.num_processes, spec.process_id, spec.num_devices()) == \
        (2, 0, 2)
    assert "AUTODIST_TPU_COORD_SERVICE" not in os.environ


def test_local_cluster_launches_n_workers(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(
        "import os\n"
        "pid = os.environ['AUTODIST_TPU_PROCESS_ID']\n"
        f"open(os.path.join({str(tmp_path)!r}, 'w%s.txt' % pid), "
        "'w').write(os.environ.get('AUTODIST_TPU_STRATEGY_ID', ''))\n")
    cluster = LocalCluster(2)
    try:
        cluster.launch_clients("strat-7", argv=[sys.executable, str(script)])
        cluster.join(timeout=60)
    finally:
        cluster.terminate()
    assert [(tmp_path / f"w{i}.txt").read_text() for i in (1, 2)] == \
        ["strat-7", "strat-7"]
    with pytest.raises(ValueError, match="num_workers"):
        LocalCluster(0)


def _crash_once_script():
    """Exit 3 on the first incarnation, 0 after a supervised restart."""
    return [sys.executable, "-c",
            "import os, sys; sys.exit(0 if os.environ.get("
            "'AUTODIST_TPU_WORKER_INCARNATION') else 3)"]


def test_supervised_restart_within_budget():
    telemetry.reset()
    sup = SupervisionConfig(max_restarts=1, restart_backoff=RetryPolicy(
        max_attempts=2, base_delay_s=0.05, cap_delay_s=0.05, seed=0))
    c = Coordinator(supervision=sup)
    c.launch("w1", _crash_once_script())
    c.join(timeout=30)          # the restart consumed the crash
    assert c._restarts == {"w1": 1}
    assert telemetry.counter("runtime/worker_restarts").value == 1
    assert any(r["phase"] == "recovered" and r["action"] == "restart"
               and r["target"] == "w1" for r in _faults())


def test_supervised_escalation_hands_over_survivors():
    telemetry.reset()
    seen = {}
    sup = SupervisionConfig(max_restarts=0, escalate=True, saver=object(),
                            on_escalate=lambda s: seen.update(
                                names=[w.name for w in s]))
    c = Coordinator(supervision=sup)
    c.launch("survivor", [sys.executable, "-c", "import time; time.sleep(2)"])
    c.launch("doomed", [sys.executable, "-c", "import sys; sys.exit(9)"])
    deadline = time.time() + 10
    while not c.escalated and time.time() < deadline:
        time.sleep(0.05)
    assert c.escalated and seen["names"] == ["survivor"]
    c.join(timeout=30)          # the escalated death is consumed
    assert any(r["phase"] == "escalated" and r["target"] == "doomed"
               for r in _faults())


def test_supervision_off_keeps_fail_fast_and_records_nothing():
    telemetry.reset()
    c = Coordinator()
    c.launch("bad", [sys.executable, "-c", "import sys; sys.exit(3)"])
    with pytest.raises(RuntimeError, match="bad.*3"):
        c.join(timeout=30)
    assert not _faults()


def test_join_reports_all_concurrent_failures():
    c = Coordinator(fail_fast=False)
    c.launch("bad-a", [sys.executable, "-c", "import sys; sys.exit(3)"])
    c.launch("bad-b", [sys.executable, "-c", "import sys; sys.exit(5)"])
    with pytest.raises(RuntimeError) as ei:
        c.join(timeout=30)
    msg = str(ei.value)
    assert "bad-a" in msg and "3" in msg and "bad-b" in msg and "5" in msg


def test_join_timeout_lists_hung_and_crashed_workers():
    c = Coordinator(fail_fast=False)
    c.launch("crashed", [sys.executable, "-c", "import sys; sys.exit(7)"])
    c.launch("hung-a", [sys.executable, "-c", "import time; time.sleep(60)"])
    c.launch("hung-b", [sys.executable, "-c", "import time; time.sleep(60)"])
    time.sleep(1.0)
    with pytest.raises(TimeoutError) as ei:
        c.join(timeout=2)
    msg = str(ei.value)
    assert "hung-a" in msg and "hung-b" in msg
    assert "crashed" in msg and "7" in msg


class _StallingClient:
    """A heartbeat source that beats a few times, then stalls."""

    def __init__(self, beats=5):
        self.n, self.beats = 0, beats

    def counter_add(self, key, delta=0):
        self.n += 1
        return min(self.n, self.beats)


def test_heartbeat_monitor_declares_hung_worker_dead():
    telemetry.reset()
    sup = SupervisionConfig(max_restarts=0, escalate=True, saver=object())
    c = Coordinator(supervision=sup)
    c.launch("wedged", [sys.executable, "-c", "import time; time.sleep(60)"])
    mon = HeartbeatMonitor(c, lambda: _StallingClient(), interval_s=0.05,
                           timeout_s=0.4, startup_grace_s=0.4)
    mon.start()
    try:
        deadline = time.time() + 10
        while not c.escalated and time.time() < deadline:
            time.sleep(0.05)
        assert c.escalated, "the hang was never detected"
    finally:
        mon.stop()
        c.terminate()
    recs = _faults()
    assert any(r["phase"] == "detected" and r["fault"] == "worker_hang"
               for r in recs)
    assert any(r["phase"] == "escalated" and r["fault"] == "worker_hang"
               for r in recs)
    assert telemetry.counter("runtime/workers_declared_dead").value == 1


_FAKE_SSH = """#!%(python)s
import subprocess, sys
args = sys.argv[1:]
while args and args[0].startswith("-"):
    args = args[2:]
host, rest = args[0], args[1:]
if rest == ["/bin/sh -s"]:
    proc = subprocess.Popen(["/bin/sh", "-s"], stdin=sys.stdin,
                            start_new_session=True)
    sys.exit(proc.wait())
sys.exit(subprocess.call(["/bin/sh", "-c", " ".join(rest)]))
"""


def test_remote_worker_teardown_kills_the_remote_process(tmp_path,
                                                         monkeypatch):
    """``terminate()`` on an ssh-launched worker kills the remote process
    (its captured pid, over a second ssh exec), not just the local ssh
    client; the fake ssh runs the remote side as a detached group."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    ssh = bin_dir / "ssh"
    ssh.write_text(_FAKE_SSH % {"python": sys.executable})
    ssh.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ['PATH']}")
    pidfile = tmp_path / "pid"
    c = Coordinator()
    h = c.launch("remote-1", [sys.executable, "-c",
                              f"import os, time; open({str(pidfile)!r}, 'w')"
                              ".write(str(os.getpid())); time.sleep(60)"],
                 host="fakehost", env={"SOME_SECRET": "s3cret"})
    deadline = time.time() + 15
    while (h.remote_pid is None or not pidfile.exists()) \
            and time.time() < deadline:
        time.sleep(0.05)
    assert h.remote_pid is not None, "remote pid never captured"
    worker_pid = int(pidfile.read_text())
    assert h.remote_pid == worker_pid
    c.terminate()
    deadline = time.time() + 15
    while time.time() < deadline:
        try:
            os.kill(worker_pid, 0)
            time.sleep(0.05)
        except ProcessLookupError:
            break
    with pytest.raises(ProcessLookupError):
        os.kill(worker_pid, 0)


# --------------------------------------------------------------------- #
# A 2-process job through Cluster
# --------------------------------------------------------------------- #
_JOB = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import autodist_tpu_torch as port
    from autodist_tpu_torch.kernel.common import flatten_with_names

    out = sys.argv[1]
    rng = np.random.RandomState(0)
    params = {"dense": {"w": torch.tensor(rng.randn(6, 3),
                                          dtype=torch.float32),
                        "b": torch.zeros(3)},
              "scale": torch.ones(())}

    def loss_fn(p, batch):
        pred = (batch["x"] @ p["dense"]["w"] + p["dense"]["b"]) * p["scale"]
        return ((pred - batch["y"]) ** 2).mean()

    tr = port.Trainable.from_loss_fn(loss_fn, params, port.optim.sgd(0.1))
    rng = np.random.RandomState(1)
    batch = {"x": rng.randn(16, 6).astype(np.float32),
             "y": rng.randn(16, 3).astype(np.float32)}
    chief = not os.environ.get("AUTODIST_TPU_WORKER")
    if chief:
        cluster = port.LocalCluster(1)
        spec = cluster.resource_spec
        ad = port.AutoDist(spec, port.AllReduce(chunk_size=256), device="cpu")
        strategy = ad.build_or_load_strategy(tr)
        cluster.launch_clients(strategy, argv=[sys.executable, __file__, out])
    else:
        spec = port.ResourceSpec({})
        ad = port.AutoDist(spec, device="cpu")    # loads the chief's
        strategy = ad.build_or_load_strategy(tr)
    runner = ad.build(tr, strategy)
    loss = float(runner.step(batch)["loss"])
    rank = dist.get_rank()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"strategy": strategy.to_json(), "loss": loss,
                   "world": dist.get_world_size(),
                   "backend": dist.get_backend(),
                   "params": {n: t.tolist() for n, t in
                              flatten_with_names(runner.get_params())}}, f)
    dist.barrier()
    dist.destroy_process_group()
    if chief:
        cluster.join(timeout=120)
        cluster.terminate()
""")


def test_cluster_job_bootstraps_and_hands_off_the_strategy(tmp_path):
    script = tmp_path / "job.py"
    script.write_text(_JOB)
    proc = subprocess.run(
        [sys.executable, str(script), str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in (0, 1)]
    assert ranks[0]["strategy"] == ranks[1]["strategy"]
    assert [r["world"] for r in ranks] == [2, 2]
    assert {r["backend"] for r in ranks} == {"gloo"}
    assert ranks[0]["params"] == ranks[1]["params"]
    assert ranks[0]["loss"] == ranks[1]["loss"]
    jtext = JAllReduce(chunk_size=256).build(
        make_trainable(), JResourceSpec({"topology": {"num_devices": 2}})
    ).to_json()
    mine = ranks[0]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(jtext)["id"],
                        1) == jtext


# --------------------------------------------------------------------- #
# Lint, the resource spec, batches, axis scopes
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw,stale", [
    (dict(escalate=True), 0),
    (dict(heartbeat_interval_s=2.0, heartbeat_timeout_s=1.0), 0),
    (dict(max_restarts=3), 2),
    (dict(escalate=True, saver=object(), heartbeat_interval_s=0.5,
          heartbeat_timeout_s=3.0), 0)])
def test_lint_supervision_codes_match_jax(kw, stale):
    from autodist_tpu.strategy.ir import (GraphConfig as JGraphConfig,
                                          NodeConfig as JNodeConfig,
                                          PSSynchronizer as JPSSync,
                                          Strategy as JStrategy)
    from autodist_tpu_torch.strategy.ir import (NodeConfig, PSSynchronizer,
                                                Strategy)

    backoff = dict(max_attempts=6, base_delay_s=1.0, cap_delay_s=8.0)
    mine = SupervisionConfig(restart_backoff=RetryPolicy(**backoff), **kw)
    theirs = JSupervision(restart_backoff=JRetryPolicy(**backoff), **kw)
    strategy = Strategy([NodeConfig("w", PSSynchronizer(staleness=stale))])
    jstrategy = JStrategy([JNodeConfig("w", JPSSync(staleness=stale))],
                          JGraphConfig())
    got = lint_supervision(mine, strategy)
    want = jlint_supervision(theirs, jstrategy)
    assert [(d.code, d.where, d.message) for d in got] == \
        [(d.code, d.where, d.message) for d in want]


def test_resource_spec_multihost_and_topology_keys():
    spec = {"topology": {"platform": "cpu", "generation": "h100",
                         "num_devices": 4},
            "mesh": {"data": 2, "model": 2},
            "multihost": {"coordinator": "10.0.0.2:8476",
                          "num_processes": 4, "process_id": 1}}
    mine = port.ResourceSpec(spec)
    assert mine.to_dict() == JResourceSpec(spec).to_dict()
    assert mine.is_multihost and mine.backend() == "gloo"
    assert mine.num_devices() == 4            # planned before bootstrap
    assert mine.three_d() == (2, 1, 2)
    assert mine.with_mesh({"data": 4}).resolved_mesh_shape() == {"data": 4}
    assert mine.chip.name == "h100"
    with pytest.raises(ValueError, match="explicit device inventory"):
        port.ResourceSpec({"multihost": {"num_processes": 2}}).num_devices()
    with pytest.raises(ValueError, match="not a .data, pipe, model"):
        mine.with_mesh({"data": 2, "seq": 2}).three_d()
    # Multi-slice: the dcn axis and topology.num_slices are the JAX
    # package's (to_dict as it writes them, dp folding dcn in).
    for sliced in ({"topology": {"num_devices": 4, "num_slices": 2}},
                   {"topology": {"num_devices": 4},
                    "mesh": {"dcn": 2, "data": 1, "model": 2}}):
        mine, theirs = port.ResourceSpec(sliced), JResourceSpec(sliced)
        assert mine.to_dict() == theirs.to_dict()
        assert mine.resolved_mesh_shape() == theirs.resolved_mesh_shape()
        assert mine.three_d() == theirs.three_d()


@pytest.mark.parametrize("mh,cards,want", [
    ({"num_processes": 16, "process_id": 3}, 8, "raises"),
    ({"num_processes": 16, "process_id": 3, "local_processes": 8,
      "local_rank": 3}, 8, "nccl"),
    ({"num_processes": 2, "process_id": 1}, 1, "raises"),
    ({"num_processes": 2, "process_id": 1, "local_processes": 2,
      "local_rank": 1}, 1, "gloo"),
    ({"num_processes": 4, "process_id": 2}, 8, "nccl")])
def test_backend_reads_the_ranks_on_the_host(monkeypatch, mh, cards, want):
    """NCCL one rank a card, gloo where ranks share a card; a job larger
    than this host's cards whose ranks on the host are not given (two
    hosts of 8 launched by hand, or ranks sharing a card) raises rather
    than guessing."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    spec = port.ResourceSpec({"multihost": dict(mh, coordinator="h0:1")})
    if want == "raises":
        with pytest.raises(ValueError, match="local_processes"):
            spec.backend()
    else:
        assert spec.backend() == want
        assert spec.card_index == mh.get("local_rank", mh["process_id"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "3")
    torchrun = port.ResourceSpec({"multihost": {"num_processes": 16,
                                                "process_id": 11}})
    assert (torchrun.backend(), torchrun.card_index) == (
        "nccl" if cards >= 8 else "gloo", 3)


def test_worker_takes_the_strategy_hand_off_once(monkeypatch):
    """A worker's first build loads the chief's published strategy
    whatever builder it names; a later build (a resume or a hot swap)
    builds from its own builder."""
    from autodist_tpu_torch import autodist as facade
    from autodist_tpu_torch.runtime import coordination
    from tests.test_torch_checkpoint import port_trainable

    trainable = port_trainable()
    published = port.PS().build(trainable, port.ResourceSpec({}))

    class Service:
        def get(self, key, timeout_ms):
            assert key == f"strategy/{published.id}"
            return published.to_json().encode()

    monkeypatch.setattr(facade, "_HANDED_OFF", set())
    monkeypatch.setattr(coordination, "service_client", Service)
    monkeypatch.setenv("AUTODIST_TPU_WORKER", "w1")
    monkeypatch.setenv("AUTODIST_TPU_STRATEGY_ID", published.id)
    first = port.AutoDist({}, port.AllReduce(), device="cpu")
    assert first.build_or_load_strategy(trainable).to_json() == \
        published.to_json()
    later = port.AutoDist({}, port.AllReduce(), device="cpu").build(
        trainable)

    def body(strategy):
        record = json.loads(strategy.to_json())
        del record["id"]
        return record

    assert body(later.strategy) == body(port.AllReduce().build(
        trainable, port.ResourceSpec({})))
    assert body(later.strategy) != body(published)
    later.close()


def test_worker_without_a_service_raises(monkeypatch):
    monkeypatch.setenv("AUTODIST_TPU_WORKER", "w1")
    monkeypatch.setenv("AUTODIST_TPU_STRATEGY_ID", "s-1")
    monkeypatch.delenv("AUTODIST_TPU_COORD_SERVICE", raising=False)
    from tests.test_torch_checkpoint import port_trainable

    with pytest.raises(RuntimeError, match="no coordination service"):
        port.AutoDist({}, device="cpu").build_or_load_strategy(
            port_trainable())


def test_make_global_batch_single_process():
    mesh = port.ResourceSpec({}).make_mesh()
    batch = {"x": np.arange(16.0).reshape(16, 1)}
    got = make_global_batch(batch, mesh, device="cpu")
    assert got["x"].shape == (16, 1) and got["x"].device.type == "cpu"
    np.testing.assert_array_equal(got["x"].numpy(), batch["x"])


def test_axis_scopes_interleaved_on_two_threads_leave_nothing_bound():
    """Thread A enters, B enters, A exits, B exits: neither exit puts
    back the other's binding, and the name is unbound after both
    (a snapshot restored on exit used to leave A's axis bound)."""
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    errors = []

    def thread_a():
        with axis_scope({"data": Axis("data", size=2)}):
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def thread_b():
        a_in.wait(10)
        with axis_scope({"data": Axis("data", size=3)}):
            b_in.set()
            a_out.wait(10)
            try:
                assert bound_axis("data").size == 3
            except AssertionError as e:      # pragma: no cover
                errors.append(e)

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
        assert not t.is_alive()
    assert not errors
    with pytest.raises(NameError, match="unbound axis name"):
        bound_axis("data")
    with axis_scope({"data": Axis("data", size=2)}):
        with axis_scope({"data": Axis("data", size=4)}):
            assert bound_axis("data").size == 4
        assert bound_axis("data").size == 2
    with pytest.raises(NameError):
        bound_axis("data")
