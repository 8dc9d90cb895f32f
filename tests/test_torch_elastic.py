"""The port's elastic layer against the JAX package's, on the CPU.

The cases of ``tests/unit/test_elastic.py`` on its linear model
(``tests/unit/test_end_to_end.py``'s ``make_trainable``: the same numpy
weights and batches):

* the recipe ops (``apply_ops``, ``invert_ops``) bit-equal to the JAX
  package's on the same arrays, and their round trip; ``parse_dtype``;
* the state manifests of the collective (``AllReduce``, ``PS``,
  ``PartitionedPS``, ``AllReduce(bf16_ef)``), ``replicated_spmd``
  (``SequenceParallel`` at ZeRO-1 and ZeRO-3) and ``simple``
  (``FSDPSharded``) families on 2 gloo ranks equal the JAX package's at
  2 devices once the port's ``split`` is dropped, optimizer leaves
  matched by the JAX suffix rule;
* shrink: a 2-rank ``PS`` job with Adam, preempted by a fault plan's
  ``preempt_signal`` on both ranks at step 2, resumes at 1 rank under
  ``AllReduce`` (the staged route) and ends within the JAX test's
  tolerance (rtol 2e-4, atol 1e-5) of the JAX single-device reference;
* grow: a 1-rank checkpoint restored on 2 ranks is bit-equal, and the
  fast route's hot swap (``AllReduce`` -> ``PS`` on 2 ranks) continues
  the unswapped trajectory;
* ADT070 raises a coded ``ReshardError``; ``bf16_ef`` rows ride a
  same-degree restore bit for bit and are re-seeded with ADT071 on a
  degree change; a checkpoint without a sidecar demands ``strategy=``;
  the controller's hook follows ``resume``, and a preemption whose save
  fails still hands off.
"""
import json
import os
import signal
import textwrap

import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import AllReduce as JAllReduce
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import PartitionedPS as JPartitionedPS
from autodist_tpu import PS as JPS
from autodist_tpu.elastic import apply_ops as japply_ops
from autodist_tpu.kernel.lowering import (_op_flat_slice, _op_index0,
                                          _op_reshape, _op_slice)
from autodist_tpu.strategy.gspmd_builders import FSDPSharded as JFSDP
from autodist_tpu.strategy.parallel_builders import \
    SequenceParallel as JSequenceParallel
from autodist_tpu_torch import telemetry, testing
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.export import parse_dtype
from autodist_tpu_torch.elastic import (ElasticController, ReshardError,
                                        apply_ops, invert_ops, plan_reshard,
                                        reshard_state, shard_budget)
from autodist_tpu_torch.elastic.reshard import meta_template
from autodist_tpu_torch.kernel.common import flatten_with_names, state_leaves
from tests.test_torch_checkpoint import port_trainable
from tests.unit.test_end_to_end import make_batch, make_trainable
from tests.unit.test_end_to_end import single_device_reference

JAX_TOL = dict(rtol=2e-4, atol=1e-5)      # tests/unit/test_elastic.py:93-117


def _adam():
    return port.optim.adam(1e-2)


def _momentum():
    return port.optim.sgd(0.1, momentum=0.9)


def build(builder, seed=0, opt=None):
    return port.AutoDist({}, builder, device="cpu").build(
        port_trainable(seed, opt or _adam()))


def flat(tree) -> dict:
    return {n: torch.as_tensor(t) for n, t in flatten_with_names(tree)}


def assert_equal(a, b):
    a, b = flat(a), flat(b)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def close_to_jax(got, jparams, tol=JAX_TOL):
    want = {n: np.asarray(v) for n, v in flatten_with_names(
        {"dense": dict(jparams["dense"]), "scale": jparams["scale"]})}
    for n, t in flat(got).items():
        np.testing.assert_allclose(t.numpy(), want[n], **tol, err_msg=n)


# --------------------------------------------------------------------- #
# Recipe ops and dtypes
# --------------------------------------------------------------------- #
def test_parse_dtype_rebuilds_exact_dtypes():
    assert parse_dtype("bfloat16") == torch.bfloat16
    assert parse_dtype("float32") == torch.float32
    assert parse_dtype(np.dtype("int32")) == torch.int32
    with pytest.raises(ValueError, match="wavelet16"):
        parse_dtype("wavelet16")


def test_recipe_ops_equal_jax_and_invert():
    """The JAX test's chain (slice, index0, reshape, flat_slice) on the
    same array: the port's result is the JAX package's bit for bit, and
    the inverse chain rebuilds the stored form (padding lanes zero)."""
    stored = np.zeros((6, 8), np.float32)
    stored[:6, :5] = np.arange(30, dtype=np.float32).reshape(6, 5)
    stored[5, :] = 0.0
    perm = [3, 1, 5, 0, 2, 4]
    permuted = stored[perm]
    ops = [_op_slice((6, 8), (6, 5)), _op_index0((6, 5), np.argsort(perm)),
           _op_reshape((6, 5), (30,)), _op_flat_slice((30,), 25)]
    want = japply_ops(permuted, ops, np)
    got = apply_ops(torch.from_numpy(permuted), ops)
    assert got.shape == (25,)
    np.testing.assert_array_equal(got.numpy(), want)
    back = apply_ops(got, invert_ops(ops))
    np.testing.assert_array_equal(back.numpy(), permuted)


# --------------------------------------------------------------------- #
# The 2-rank jobs
# --------------------------------------------------------------------- #
_PREAMBLE = """
import json, os, sys
import torch
import autodist_tpu_torch as port
from autodist_tpu_torch import telemetry, testing
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.elastic import ElasticController
from autodist_tpu_torch.kernel.common import flatten_with_names
import numpy as np


def port_trainable(seed=0, opt=None):
    # tests/test_torch_checkpoint.py's model (no JAX import in a rank)
    rng = np.random.RandomState(seed)
    params = {"dense": {"w": torch.tensor(rng.randn(6, 3),
                                          dtype=torch.float32),
                        "b": torch.zeros(3)},
              "scale": torch.ones(())}

    def loss_fn(p, batch):
        pred = (batch["x"] @ p["dense"]["w"] + p["dense"]["b"]) * p["scale"]
        return ((pred - batch["y"]) ** 2).mean()

    return port.Trainable.from_loss_fn(loss_fn, params, opt)


def make_batch(seed=1):
    # tests/unit/test_end_to_end.py's batches
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(16, 6).astype(np.float32),
            "y": rng.randn(16, 3).astype(np.float32)}


rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
testing.init_rank(rank, world, store)


def build(builder, spec=None, seed=0, opt=None):
    return port.AutoDist(spec or {}, builder, device="cpu").build(
        port_trainable(seed, opt or port.optim.adam(1e-2)))


def params(runner):
    return {n: t.tolist() for n, t in flatten_with_names(runner.get_params())}
"""

# Manifests of every family, the grow restore and the live hot swap.
_TWO_RANKS = _PREAMBLE + textwrap.dedent("""
    result = {"manifests": {}}
    for label, spec, builder in (
            ("AllReduce", {}, port.AllReduce()), ("PS", {}, port.PS()),
            ("PartitionedPS", {}, port.PartitionedPS()),
            ("bf16_ef", {}, port.AllReduce(compressor="bf16_ef")),
            ("seq_zero1", {"mesh": {"seq": 2}},
             port.SequenceParallel(zero_stage=1)),
            ("seq_zero3", {"mesh": {"seq": 2}},
             port.SequenceParallel(zero_stage=3)),
            ("fsdp", {"mesh": {"data": 2}}, port.FSDPSharded(min_size=1))):
        runner = build(builder, spec)
        result["manifests"][label] = runner.lowered.state_manifest(
            runner.state)
        runner.close()
    # grow: the 1-rank checkpoint restored on 2 ranks
    grown = build(port.AllReduce(), seed=9, opt=port.optim.sgd(0.1, 0.9))
    Saver(os.path.join(out, "grow")).restore_elastic(grown)
    result["grown"] = params(grown)
    result["grown_step"] = grown.step_count
    result["grown_loss"] = float(grown.step(make_batch(5))["loss"])
    # hot swap: AllReduce -> PS on these ranks, against no swap
    swapped = build(port.AllReduce())
    plain = build(port.AllReduce())
    for s in range(2):
        swapped.step(make_batch(s))
        plain.step(make_batch(s))
    ctl = ElasticController(swapped.trainable, None, device="cpu")
    swapped = ctl.hot_swap(swapped, strategy=port.PS(), spec={})
    for s in range(2, 4):
        swapped.step(make_batch(s))
        plain.step(make_batch(s))
    result["swapped"], result["plain"] = params(swapped), params(plain)
    result["swap_routes"] = [r["route"] for r in telemetry.get().events
                             if r["kind"] == "reshard"]
    result["swap_update"] = swapped.lowered.plan.var_plans["dense/w"].update
    if rank == 0:
        with open(os.path.join(out, "two_ranks.json"), "w") as f:
            json.dump(result, f)
    testing.end_rank()
""")

# The preempted PS job: both ranks take preempt_signal at step 2 from
# a shipped fault plan, save, rank 1 departs, rank 0 resumes alone.
_SHRINK = _PREAMBLE + textwrap.dedent("""
    from autodist_tpu_torch.runtime.faults import (FaultInjector,
                                                   fault_target,
                                                   load_fault_plan)

    from autodist_tpu_torch.elastic.reshard import LiveSource, apply_ops

    def logical_state(runner):
        # every leaf at its logical shape (a collective), the seed
        # stream and the host step: what a restore must give back
        m = runner.lowered.state_manifest(runner.state)
        read = LiveSource(runner.lowered, runner.state, m)
        leaves = {n: apply_ops(read(n), rec["ops"])
                  for n, rec in m["leaves"].items()
                  if n not in m.get("sync", {})}
        return leaves, runner._seeds.get_state(), runner._host_step

    def same_state(a, b):
        (la, sa, ha), (lb, sb, hb) = a, b
        return (la.keys() == lb.keys() and ha == hb
                and all(la[n].dtype == lb[n].dtype
                        and torch.equal(la[n], lb[n]) for n in la)
                and sa[0] == sb[0] and np.array_equal(sa[1], sb[1])
                and tuple(sa[2:]) == tuple(sb[2:]))

    if rank == 1:
        os.environ["AUTODIST_TPU_WORKER"] = "worker-1"
    ckpt = os.path.join(out, "shrink")
    runner = build(port.PS())
    saver = Saver(ckpt)
    ctl = ElasticController(runner.trainable, saver, device="cpu")
    ctl.install(runner)
    injector = FaultInjector(load_fault_plan(), fault_target())
    step = 0
    while not ctl.preempted:
        injector.maybe_fire(step)
        if ctl.preempted:
            break
        runner.step(make_batch(step))
        step += 1
    result = {"preempted_at": step,
              "sidecar": saver.read_sidecar(step) is not None}
    saved = logical_state(runner)          # gathered on both ranks
    # 2-rank checkpoints of bf16_ef and PartitionedPS for the tests
    for label, builder in (("bf16_ef", port.AllReduce(compressor="bf16_ef")),
                           ("pps", port.PartitionedPS())):
        other = build(builder, opt=port.optim.sgd(0.1))
        other.step(make_batch(0))
        Saver(os.path.join(out, label)).save(other)
        result[label] = {"params": params(other),
                         "strategy": other.strategy.to_json()}
        other.close()
    if rank == 1:
        ctl.depart()
    else:
        resumed = ctl.resume(strategy=port.AllReduce(), spec={})
        result["resumed_step"] = resumed.step_count
        result["restore_exact"] = same_state(logical_state(resumed), saved)
        result["reshards"] = [r for r in telemetry.get().events
                              if r["kind"] == "reshard"]
        for s in (2, 3):
            resumed.step(make_batch(s))
        result["params"] = params(resumed)
        result["faults"] = [r for r in telemetry.get().events
                            if r["kind"] == "fault"]
        with open(os.path.join(out, "shrink.json"), "w") as f:
            json.dump(result, f)
""")


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two_ranks")
    one = build(port.PS(), opt=_momentum())
    for s in range(2):
        one.step(make_batch(s))
    Saver(str(tmp / "grow")).save(one)
    testing.launch(_TWO_RANKS, 2, (tmp,), tmp=tmp / "job", timeout=180)()
    with open(tmp / "two_ranks.json") as f:
        return json.load(f), one.get_params()


@pytest.fixture(scope="module")
def shrunk(tmp_path_factory):
    from autodist_tpu_torch.runtime.faults import FaultPlan, FaultSpec

    tmp = tmp_path_factory.mktemp("shrink")
    plan = FaultPlan([FaultSpec("preempt_signal", target="chief", at_step=2),
                      FaultSpec("preempt_signal", target="worker-1",
                                at_step=2)], seed=5)
    os.environ.update(plan.ship())        # the ranks inherit the plan
    try:
        testing.launch(_SHRINK, 2, (tmp,), tmp=tmp / "job", timeout=180)()
    finally:
        del os.environ["AUTODIST_TPU_FAULT_PLAN"]
    with open(tmp / "shrink.json") as f:
        return json.load(f), tmp


def _jax_manifest(builder, mesh=None):
    spec = {"topology": {"num_devices": 2}}
    if mesh:
        spec["mesh"] = mesh
    jr = JAutoDist(spec, builder).build(make_trainable(
        optimizer=optax.adam(1e-2)))
    return jr.lowered.state_manifest(jr.state)


def _jax_name(name: str, jleaves) -> str:
    """The JAX leaf of a port leaf: the same name, or for an optimizer
    leaf the JAX one whose path past its optax chain index is the
    port's (the suffix rule)."""
    if name in jleaves or not name.startswith("opt_state/"):
        return name
    rest = name[len("opt_state/"):]
    found = [j for j in jleaves if j.startswith("opt_state/")
             and j.split("/", 2)[-1] == rest]
    assert len(found) == 1, (name, found)
    return found[0]


@pytest.mark.parametrize("label", ["AllReduce", "PS", "PartitionedPS",
                                   "bf16_ef", "seq_zero1", "seq_zero3",
                                   "fsdp"])
def test_manifest_matches_jax(two_ranks, label):
    jbuilder, mesh = {
        "AllReduce": (JAllReduce(), None), "PS": (JPS(), None),
        "PartitionedPS": (JPartitionedPS(), None),
        "bf16_ef": (JAllReduce(compressor="bf16_ef"), None),
        "seq_zero1": (JSequenceParallel(zero_stage=1), {"seq": 2}),
        "seq_zero3": (JSequenceParallel(zero_stage=3), {"seq": 2}),
        "fsdp": (JFSDP(min_size=1), {"data": 2})}[label]
    mine = two_ranks[0]["manifests"][label]
    want = _jax_manifest(jbuilder, mesh)
    assert mine["family"] == want["family"]
    assert mine["sync"] == want["sync"]
    jleaves = want["leaves"]
    matched = set()
    for name, rec in mine["leaves"].items():
        jname = _jax_name(name, jleaves)
        matched.add(jname)
        jrec = jleaves[jname]
        if name.startswith("opt_state/"):
            assert rec["logical_shape"] == jrec["logical_shape"], name
            assert rec["dtype"] == jrec["dtype"], name
        else:
            assert {k: v for k, v in rec.items() if k != "split"} == jrec, \
                name
    assert matched == set(jleaves)
    if label in ("PS", "seq_zero3"):
        assert mine["leaves"]["opt_state/mu/dense/w"]["split"]["ranks"] == 2


def test_grow_one_rank_to_two_bit_exact(two_ranks):
    result, before = two_ranks
    assert result["grown_step"] == 2
    assert_equal({n: torch.tensor(v) for n, v in result["grown"].items()},
                 flat(before))
    assert np.isfinite(result["grown_loss"])


def test_hot_swap_continues_the_unswapped_trajectory(two_ranks):
    result, _ = two_ranks
    assert result["swap_routes"] == ["staged", "fast"]    # grow, swap
    assert result["swap_update"] == "flat"           # PS's update space
    for n, v in result["plain"].items():
        np.testing.assert_allclose(result["swapped"][n], v, rtol=1e-6,
                                   atol=1e-7, err_msg=n)


def test_shrink_ps2_to_allreduce1_matches_jax(shrunk):
    """PS on 2 ranks, preempted at step 2, resumed under AllReduce at 1
    rank with its Adam moments: the 4-step trajectory matches the JAX
    single-device reference."""
    result, _ = shrunk
    assert result["resumed_step"] == 2
    batches = [make_batch(s) for s in range(4)]
    want = single_device_reference(make_trainable(optimizer=optax.adam(1e-2)),
                                   batches)
    close_to_jax({n: torch.tensor(v) for n, v in result["params"].items()},
                 want)


def test_sigterm_preempted_job_resumes_at_one_rank(shrunk):
    """The acceptance run: a shipped fault plan preempts both ranks at
    step 2; each saved (the sidecar exists), rank 1 left, rank 0 restored
    by the staged route and trained on; every injection is paired."""
    result, _ = shrunk
    assert result["preempted_at"] == 2 and result["sidecar"]
    assert result["restore_exact"]    # params, mu, nu, count, seeds, step
    assert [r["route"] for r in result["reshards"]] == ["staged"]
    assert result["reshards"][0]["peak_host_bytes"] > 0
    phases = [(r["fault"], r["phase"]) for r in result["faults"]]
    assert phases == [("preempt_signal", "injected"),
                      ("preempt_signal", "recovered")]


# --------------------------------------------------------------------- #
# Compatibility, compressor rows, pre-elastic checkpoints
# --------------------------------------------------------------------- #
def test_reshard_mismatch_is_coded_error():
    src = build(port.PS(), opt=port.optim.sgd(0.1))
    dst = build(port.PS())
    with pytest.raises(ReshardError) as e:
        reshard_state(src.lowered, src.state, dst.lowered,
                      meta_template(dst.state))
    assert "ADT070" in str(e.value)


def test_bf16_ef_rows_ride_a_same_degree_restore(tmp_path):
    def make(seed=0):
        return build(port.AllReduce(compressor="bf16_ef"), seed,
                     port.optim.sgd(0.1))

    a = make()
    for s in range(2):
        a.step(make_batch(s))
    saver = Saver(str(tmp_path))
    saver.save(a)
    b = make(seed=9)
    saver.restore_elastic(b)
    for s in (2, 3):
        a.step(make_batch(s))
        b.step(make_batch(s))
    assert_equal(a.get_params(), b.get_params())
    assert_equal(a.state["sync_state"], b.state["sync_state"])


def test_bf16_ef_degree_change_reseeds_with_warning(shrunk):
    _, tmp = shrunk
    saver = Saver(str(tmp / "bf16_ef"))
    target = build(port.AllReduce(compressor="bf16_ef"), 3,
                   port.optim.sgd(0.1))
    plan = plan_reshard(saver.read_sidecar(1)["manifest"],
                        target.lowered.state_manifest(target.state))
    assert plan.ok
    assert {d.code for d in plan.report.warnings} == {"ADT071"}
    assert plan.sync_reinit
    saver.restore_elastic(target)
    assert np.isfinite(float(target.step(make_batch(1))["loss"]))


def test_pre_elastic_checkpoint_demands_strategy(shrunk):
    result, tmp = shrunk
    saver = Saver(str(tmp / "pps"))
    os.remove(saver._store.sidecar_path(1))        # a checkpoint of PR 17's format
    target = build(port.PS(), seed=9, opt=port.optim.sgd(0.1))
    with pytest.raises(ValueError, match="layout-unknown"):
        saver.restore_elastic(target)
    with pytest.raises(ValueError, match="strategy="):
        saver.restore_elastic(target)
    saver.restore_elastic(target, strategy=port.Strategy.from_json(
        result["pps"]["strategy"]))
    assert_equal(target.get_params(),
                 {n: torch.tensor(v)
                  for n, v in result["pps"]["params"].items()})


@pytest.mark.parametrize("damage", ["missing", "truncated"])
def test_restore_elastic_checks_every_writer_before_dropping_state(
        shrunk, tmp_path, damage):
    """A writer's rank file that is gone or cannot be read is found
    before the runner's state is dropped: the restore raises naming it,
    and the runner keeps its state."""
    import shutil

    _, tmp = shrunk
    shutil.copytree(tmp / "shrink", tmp_path / "ckpt")
    saver = Saver(str(tmp_path / "ckpt"))
    path = os.path.join(saver._store.step_dir(2), "rank1.pt")
    if damage == "missing":
        os.remove(path)
    else:
        with open(path, "r+b") as f:
            f.truncate(64)
    target = build(port.AllReduce(), seed=9)
    before = dict(state_leaves(target.state))
    with pytest.raises(ValueError, match="rank1.pt"):
        saver.restore_elastic(target)
    assert target.state is not None
    assert_equal(dict(state_leaves(target.state)), before)


def test_portable_checkpoint_is_refused_toward_restore_portable(tmp_path):
    runner = build(port.PS())
    runner.step(make_batch(0))
    saver = Saver(str(tmp_path))
    saver.save(runner, portable=True)
    with pytest.raises(ValueError, match="restore_portable"):
        saver.restore_elastic(build(port.PS(), seed=9),
                              strategy=runner.strategy)


def test_sync_transfer_requires_same_compressor():
    from autodist_tpu_torch.analysis import lint_reshard

    def manifest(comp):
        return {"leaves": {"sync_state/g0:x": {
                    "stored_shape": [4, 16], "logical_shape": [4, 16],
                    "dtype": "float32", "ops": [], "split": None}},
                "sync": {"sync_state/g0:x": {
                    "rows": 4, "width": 16, "compressor": comp}}}

    same = plan_reshard(manifest("bf16_ef"), manifest("bf16_ef"))
    assert same.sync_transfer and not same.sync_reinit
    crossed = plan_reshard(manifest("bf16_ef"), manifest("int8_ef"))
    assert crossed.sync_reinit and not crossed.sync_transfer
    assert "ADT071" in lint_reshard(manifest("bf16_ef"),
                                    manifest("int8_ef")).codes()


def test_reshard_record_and_out_of_slice_raise():
    telemetry.reset()
    src, dst = build(port.AllReduce()), build(port.PartitionedPS(), seed=9)
    dst.state = reshard_state(src.lowered, src.state, dst.lowered,
                              meta_template(dst.state))
    (rec,) = [r for r in telemetry.get().events if r["kind"] == "reshard"]
    assert rec["route"] == "fast" and rec["peak_host_bytes"] == 0
    assert {"leaves", "recoded", "bytes_moved", "sync_reinit",
            "duration_ms"} <= set(rec)
    assert telemetry.gauge("reshard/bytes_moved").value == rec["bytes_moved"]
    assert shard_budget((src.lowered, src.state)) == 18      # dense/w
    back = reshard_state(dst.lowered, dst.state, src.lowered,
                         meta_template(src.state))
    got, want = (dict(state_leaves(back)), dict(state_leaves(src.state)))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    with pytest.raises(NotImplementedError, match="item 10"):
        ElasticController(src.trainable, None).elect(4)


# --------------------------------------------------------------------- #
# The controller
# --------------------------------------------------------------------- #
def _restore_handlers(previous):
    for sig, prev in previous.items():
        signal.signal(sig, prev if callable(prev)
                      or prev in (signal.SIG_IGN, signal.SIG_DFL)
                      else signal.SIG_DFL)


def test_controller_hook_follows_resume(tmp_path):
    runner = build(port.AllReduce(), opt=_momentum())
    saver = Saver(str(tmp_path))
    ctl = ElasticController(runner.trainable, saver, device="cpu")
    previous = ctl.install(runner)
    try:
        for s in range(2):
            runner.step(make_batch(s))
        os.kill(os.getpid(), signal.SIGTERM)
        assert ctl.preempted and saver.latest_step() == 2
        resumed = ctl.resume(strategy=port.PS(), spec={})
        # the old runner's state went before the new build
        assert runner.state is None and resumed.step_count == 2
        resumed.step(make_batch(2))
        os.kill(os.getpid(), signal.SIGTERM)     # a second preemption
        assert saver.latest_step() == 3          # the resumed runner's
    finally:
        _restore_handlers(previous)


def test_preemption_save_failure_still_hands_off(tmp_path):
    runner = build(port.AllReduce(), opt=_momentum())
    saver = Saver(str(tmp_path))
    ctl = ElasticController(runner.trainable, saver, device="cpu")
    previous = ctl.install(runner)
    try:
        runner.step(make_batch(0))
        saver.save(runner)                   # the last good checkpoint
        runner.step(make_batch(1))

        def broken_save(*a, **k):
            raise OSError("disk full")

        saver.save = broken_save
        os.kill(os.getpid(), signal.SIGTERM)     # must not raise here
        assert ctl.preempted
        del saver.save
        resumed = ctl.resume(strategy=port.AllReduce(), spec={})
        assert resumed.step_count == 1           # the last good step
    finally:
        _restore_handlers(previous)
