"""The port's ``Saver`` against the JAX package's, on the CPU.

The cases of ``tests/unit/test_checkpoint.py`` on its linear model
(``tests/unit/test_end_to_end.py``'s ``make_trainable``, the same numpy
weights and batches, Adam so that a resume must carry optimizer state):

* a full save restores into a fresh runner that continues bit for bit,
  and both sides end within 1e-5 of the JAX package's run of the same
  steps;
* a portable save from ``PartitionedPS`` restores under ``AllReduce``
  (and its ``restore_params`` are the logical, unpadded host tensors);
* on 2 gloo ranks: a full ``ZeRO(stage=3)`` save restores each rank's
  own shard bit for bit, and the restored job steps on as the original;
  portable saves from ``ZeRO-3`` and ``PartitionedPS`` restore under
  ``AllReduce`` on one rank to the JAX package's parameters after the
  same steps on a data axis of 2 within 1e-6; an ``AllReduce`` portable
  save restores under ``PartitionedPS`` on 2 ranks;
* the async snapshot is the state at save time although steps follow at
  once; ``latest_step`` and the missing-checkpoint error; the SIGTERM
  hook writes a checkpoint before the process dies; an injected write
  failure is retried, degrades (counter and ``kind="fault"`` event), or
  raises ``CheckpointSaveError`` with its step, an async one at the next
  join; ``restore_elastic`` with no checkpoint raises as ``restore``
  does (``tests/test_torch_elastic.py`` holds the elastic restore).
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import PS as JPS
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu.strategy import builders as jbuilders
from autodist_tpu_torch import telemetry, testing
from autodist_tpu_torch.checkpoint import CheckpointSaveError, Saver
from autodist_tpu_torch.runtime.faults import install_ckpt_write_fail
from autodist_tpu_torch.runtime.retry import RetryPolicy
from tests.unit.test_end_to_end import make_batch
from tests.unit.test_end_to_end import make_trainable as jax_trainable

TOL = dict(rtol=1e-5, atol=1e-5)


def port_trainable(seed=0, opt=None):
    rng = np.random.RandomState(seed)
    params = {"dense": {"w": torch.tensor(rng.randn(6, 3),
                                          dtype=torch.float32),
                        "b": torch.zeros(3)},
              "scale": torch.ones(())}

    def loss_fn(p, batch):
        pred = (batch["x"] @ p["dense"]["w"] + p["dense"]["b"]) * p["scale"]
        return ((pred - batch["y"]) ** 2).mean()

    return port.Trainable.from_loss_fn(loss_fn, params,
                                       opt or port.optim.adam(1e-2))


def build(builder, seed=0, opt=None):
    return port.AutoDist({}, builder, device="cpu").build(
        port_trainable(seed, opt))


def train_some(builder, steps=2, seed=0):
    runner = build(builder, seed)
    for s in range(steps):
        runner.step(make_batch(s))
    return runner


def equal_trees(a, b):
    fa, fb = dict(port.kernel.common.flatten_with_names(a)), \
        dict(port.kernel.common.flatten_with_names(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k])), k


def close_to_jax(got, jparams, tol=TOL):
    np.testing.assert_allclose(got["dense"]["w"].numpy(),
                               np.asarray(jparams["dense"]["w"]), **tol)
    np.testing.assert_allclose(got["dense"]["b"].numpy(),
                               np.asarray(jparams["dense"]["b"]), **tol)
    np.testing.assert_allclose(float(got["scale"]),
                               float(np.asarray(jparams["scale"])), **tol)


def test_full_save_restore_exact_resume(tmp_path):
    runner = train_some(port.PS())
    saver = Saver(str(tmp_path))
    assert saver.save(runner) == 2
    runner2 = build(port.PS(), seed=9)
    saver.restore(runner2)
    assert runner2.step_count == 2
    b = make_batch(7)
    assert float(runner.step(dict(b))["loss"]) == \
        float(runner2.step(dict(b))["loss"])
    equal_trees(runner.get_params(), runner2.get_params())
    equal_trees(runner.state["opt_state"], runner2.state["opt_state"])
    jr = JAutoDist({}, JPS()).build(jax_trainable(optax.adam(1e-2)))
    for s in (0, 1, 7):
        jr.step(make_batch(s))
    close_to_jax(runner2.get_params(), jr.get_params())
    # another state layout (SGD keeps no optimizer state) refuses it
    with pytest.raises(ValueError, match="restore_portable"):
        saver.restore(build(port.PS(), opt=port.optim.sgd(0.1)))


def test_portable_restores_across_strategies(tmp_path):
    runner = train_some(port.PartitionedPS(), steps=3)
    before = runner.get_params()
    saver = Saver(str(tmp_path))
    saver.save(runner, portable=True)
    payload = saver.restore_params()
    assert payload["params"]["dense"]["w"].shape == (6, 3)
    equal_trees(payload["params"], before)
    runner2 = build(port.AllReduce(), seed=9)
    saver.restore_portable(runner2)
    equal_trees(runner2.get_params(), before)
    assert runner2.step_count == 3
    assert np.isfinite(float(runner2.step(make_batch(11))["loss"]))
    with pytest.raises(ValueError, match="portable checkpoint"):
        saver.restore(runner2)


def test_latest_step_and_missing(tmp_path):
    saver = Saver(str(tmp_path))
    assert saver.latest_step() is None
    with pytest.raises(FileNotFoundError):
        saver.restore_params()
    with pytest.raises(FileNotFoundError):
        saver.restore_elastic(build(port.PS()))


def test_async_save_snapshot(tmp_path):
    runner = train_some(port.AllReduce(), steps=2)
    snapshot = runner.get_params()
    saver = Saver(str(tmp_path), async_save=True)
    assert saver.save(runner) == 2            # returns with the write queued
    for s in range(3):
        runner.step(make_batch(10 + s))
    runner2 = build(port.AllReduce())
    saver.restore(runner2, step=2)             # joins the write first
    assert saver.latest_step() == 2
    equal_trees(runner2.get_params(), snapshot)
    assert runner2.step_count == 2
    saver.close()


def test_max_to_keep(tmp_path):
    runner = build(port.AllReduce())
    saver = Saver(str(tmp_path))
    for s in range(7):
        runner.step(make_batch(s))
        saver.save(runner)
    assert saver.all_steps() == [3, 4, 5, 6, 7]
    with pytest.raises(ValueError, match="force=True"):
        saver.save(runner)
    assert saver.save(runner, force=True) == 7


def _fast_retry():
    return RetryPolicy(max_attempts=2, base_delay_s=0.01, cap_delay_s=0.01,
                       seed=0)


def test_save_retries_through_injected_write_failure(tmp_path):
    runner = train_some(port.PS())
    saver = Saver(str(tmp_path), retry=_fast_retry())
    countdown = install_ckpt_write_fail(saver, times=1)
    assert saver.save(runner) == 2 and countdown["left"] == 0
    runner2 = build(port.PS())
    saver.restore(runner2)
    equal_trees(runner.get_params(), runner2.get_params())


def test_save_degrades_on_persistent_write_failure(tmp_path):
    tel = telemetry.reset()
    runner = train_some(port.PS())
    saver = Saver(str(tmp_path), retry=_fast_retry(),
                  degrade_on_failure=True)
    good = saver.save(runner)
    runner.step(make_batch(5))
    install_ckpt_write_fail(saver, times=3)
    assert saver.save(runner) is None
    assert tel.counter("ckpt/save_failures").value == 1
    assert any(r["kind"] == "fault" and r["fault"] == "ckpt_write_fail"
               and r["phase"] == "degraded" and r["last_good_step"] == good
               for r in tel.step_records())
    assert saver.latest_step() == good


def test_save_failure_without_degrade_is_typed(tmp_path):
    runner = train_some(port.PS())
    saver = Saver(str(tmp_path), retry=_fast_retry())
    install_ckpt_write_fail(saver, times=3)
    with pytest.raises(CheckpointSaveError) as ei:
        saver.save(runner)
    assert ei.value.step == runner.step_count


def test_async_save_failure_surfaces_with_step_at_next_join(tmp_path):
    tel = telemetry.reset()
    runner = train_some(port.PS())
    saver = Saver(str(tmp_path), async_save=True)
    staged = saver.save(runner)
    install_ckpt_write_fail(saver, times=1, where="commit")
    with pytest.raises(CheckpointSaveError) as ei:
        saver.wait()
    assert ei.value.step == staged and f"step {staged}" in str(ei.value)
    assert tel.counter("ckpt/async_save_failures").value == 1
    saver.wait()                               # consumed: the next is clean
    saver.close()


def test_async_save_failure_degrades_when_opted_in(tmp_path):
    tel = telemetry.reset()
    runner = train_some(port.PS())
    saver = Saver(str(tmp_path), async_save=True, degrade_on_failure=True)
    staged = saver.save(runner)
    install_ckpt_write_fail(saver, times=1, where="commit")
    runner.step(make_batch(9))
    assert saver.save(runner) is not None      # joins, degrades, saves
    assert any(r["kind"] == "fault" and r["phase"] == "degraded"
               and r["step"] == staged for r in tel.step_records())
    saver.close()


_PREEMPT = textwrap.dedent("""
    import os, signal, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[2])
    from tests.test_torch_checkpoint import build, make_batch
    import autodist_tpu_torch as port
    runner = build(port.PS())
    runner.step(make_batch(0))
    runner.step(make_batch(1))
    saver = port.Saver(sys.argv[1])
    saver.install_preemption_hook(runner)
    os.kill(os.getpid(), signal.SIGTERM)
    raise SystemExit("signal did not terminate the process")
""")


def test_preemption_hook_checkpoints_on_sigterm(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _PREEMPT, str(tmp_path / "ckpt"), repo],
        cwd=repo, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "signal did not terminate" not in proc.stdout + proc.stderr
    saver = Saver(str(tmp_path / "ckpt"))
    assert saver.latest_step() == 2
    runner2 = build(port.PS())
    saver.restore(runner2)
    assert runner2.step_count == 2


_WORKER = textwrap.dedent("""
    import sys
    import time
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    sys.path.insert(0, sys.argv[5])
    from tests.test_torch_checkpoint import build, make_batch
    rank, world, store, tmp = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)

    def leaves(tree):
        return port.kernel.common.flatten_with_names(
            {"p": tree["params"], "o": tree["opt_state"]})

    out = {}
    # ZeRO-3: a full save gives back this rank's own shards bit for bit.
    zero = build(port.ZeRO(stage=3))
    for s in range(3):
        zero.step(make_batch(s))
    saver = port.Saver(f"{tmp}/zero_full")
    saver.save(zero)
    again = build(port.ZeRO(stage=3), seed=9)
    saver.restore(again)
    out["zero_shards"] = all(torch.equal(a, b) for (_, a), (_, b) in
                             zip(leaves(zero.state), leaves(again.state)))
    out["zero_shard_shape"] = tuple(zero.state["params"]["dense/w"].shape)
    out["zero_next"] = (float(zero.step(make_batch(3))["loss"]),
                        float(again.step(make_batch(3))["loss"]))
    # portable saves for the one-rank AllReduce restore, in the test
    for name, builder in (("zero", port.ZeRO(stage=3)),
                          ("pps", port.PartitionedPS())):
        r = build(builder)
        for s in range(3):
            r.step(make_batch(s))
        port.Saver(f"{tmp}/{name}_portable").save(r, portable=True)
    # AllReduce -> PartitionedPS on 2 ranks
    ar = build(port.AllReduce())
    for s in range(3):
        ar.step(make_batch(s))
    if rank == 1:
        time.sleep(0.5)    # rank 0 (no gather to wait in) saves first
    port.Saver(f"{tmp}/ar_portable").save(ar, portable=True)
    pps = build(port.PartitionedPS(), seed=9)
    port.Saver(f"{tmp}/ar_portable").restore_portable(pps)
    out["ar_to_pps"] = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        port.kernel.common.flatten_with_names(ar.get_params()),
        port.kernel.common.flatten_with_names(pps.get_params())))
    out["pps_step"] = pps.step_count
    torch.save(out, f"{tmp}/out.{rank}")
    testing.end_rank()
""")


def test_two_rank_zero3_and_portable_restores(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    testing.launch(_WORKER, 2, (tmp_path, repo), tmp=tmp_path / "logs",
                   timeout=240)()
    for rank in range(2):
        out = torch.load(tmp_path / f"out.{rank}", weights_only=False)
        assert out["zero_shards"]
        assert out["zero_shard_shape"] == (3, 3)     # 6 rows over 2
        assert out["zero_next"][0] == out["zero_next"][1]
        assert out["ar_to_pps"] and out["pps_step"] == 3
    spec = {"topology": {"platform": "cpu", "num_devices": 2},
            "mesh": {"data": 2}}
    for name, jb in (("zero", jbuilders.create("ZeRO", stage=3)),
                     ("pps", jbuilders.create("PartitionedPS"))):
        jr = JAutoDist(spec, jb).build(jax_trainable(optax.adam(1e-2)))
        for s in range(3):
            jr.step(make_batch(s))
        runner = build(port.AllReduce(), seed=9)
        Saver(str(tmp_path / f"{name}_portable")).restore_portable(runner)
        assert runner.step_count == 3
        close_to_jax(runner.get_params(), jax.device_get(jr.get_params()),
                     tol=dict(rtol=1e-6, atol=1e-6))
