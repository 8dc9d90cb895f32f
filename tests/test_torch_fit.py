"""``fit`` in the port against ``fit`` in the JAX package, on the CPU.

The cases of ``tests/unit/test_fit.py``, each run by both packages on
the same weights (numpy-made, fp32) and the same numpy batches: the JAX
package on its simulated 8-device data axis, the port in one process
(``AllReduce`` averages the shards' gradients, so one process computes
the same step).  The logged losses, the eval history and the final
parameters agree within 1e-5 (atol = rtol); the cadences fire at the
same steps; a resumed job sees source steps ``[5, 6, 7]``;
``steps_per_loop`` windows equal the per-step loop, with a ragged last
batch as a window of its own; the pipeline runner checkpoints and
resumes (the port at one pipe device with 4 virtual stages, the JAX
package on a pipe axis of 4: the same schedule's arithmetic).
``runner.run``, ``summary``, ``eval_step`` and ``evaluate`` are held to
the JAX runner's too.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import AllReduce as JAllReduce
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import PipelineTrainable as JPipelineTrainable
from autodist_tpu import Trainable as JTrainable
from autodist_tpu import fit as jfit
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.strategy.parallel_builders import Pipeline as JPipeline

TOL = dict(rtol=1e-5, atol=1e-5)
W0 = np.random.RandomState(42).randn(32, 8).astype(np.float32) * 0.1


def jax_trainable():
    def loss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    return JTrainable.from_loss_fn(loss_fn, {"w": jnp.asarray(W0)},
                                   optax.adamw(1e-2))


def port_trainable():
    def loss_fn(p, batch):
        return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()

    return port.Trainable.from_loss_fn(
        loss_fn, {"w": torch.tensor(W0)}, port.optim.adamw(1e-2))


def jrunner():
    return JAutoDist({}, JAllReduce()).build(jax_trainable())


def prunner():
    return port.AutoDist({}, port.AllReduce(), device="cpu").build(
        port_trainable())


def source(step):
    r = np.random.RandomState(step)
    return {"x": r.randn(16, 32).astype(np.float32),
            "y": r.randn(16, 8).astype(np.float32)}


def close_params(got, want):
    np.testing.assert_allclose(np.asarray(got["w"]), np.asarray(want["w"]),
                               **TOL)


def close_history(got, want):
    assert [s for s, _ in got["loss"]] == [s for s, _ in want["loss"]]
    np.testing.assert_allclose([v for _, v in got["loss"]],
                               [v for _, v in want["loss"]], **TOL)
    assert [s for s, _ in got["eval"]] == [s for s, _ in want["eval"]]
    for (_, g), (_, w) in zip(got["eval"], want["eval"]):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], np.asarray(w[k]), **TOL)


FIT = dict(steps=12, log_every=4, eval_source=source, eval_every=6,
           eval_batches=2)


@pytest.fixture(scope="module")
def jax_fit():
    runner = jrunner()
    hist = jfit(runner, source, **FIT)
    return hist, runner.get_params()


def test_fit_trains_and_reports(jax_fit):
    runner = prunner()
    hist = port.fit(runner, source, **FIT)
    assert runner.step_count == 12
    assert hist["examples_per_sec"] > 0
    assert set(dict(hist["loss"])) == {4, 8, 12}
    assert [s for s, _ in hist["eval"]] == [6, 12]
    evals = dict(hist["eval"])
    assert float(evals[12]["loss"]) < float(evals[6]["loss"])
    close_history(hist, jax_fit[0])
    close_params(runner.get_params(), jax_fit[1])
    records = [r for r in port.telemetry.get().step_records()
               if r["kind"] == "step"]
    assert records and records[-1]["step"] == 11


def test_fit_resumes_from_saver(tmp_path):
    jsaver = JSaver(str(tmp_path / "jax"))
    jfit(jrunner(), source, steps=5, saver=jsaver, log_every=0)
    jr2 = jrunner()
    jfit(jr2, source, steps=8, saver=jsaver, log_every=0)
    jsaver.close()

    saver = port.Saver(str(tmp_path / "port"))
    port.fit(prunner(), source, steps=5, saver=saver, log_every=0)
    assert saver.latest_step() == 5
    seen = []

    def tracking_source(step):
        seen.append(step)
        return source(step)

    runner2 = prunner()
    port.fit(runner2, tracking_source, steps=8, saver=saver, log_every=0)
    assert runner2.step_count == 8 and saver.latest_step() == 8
    assert seen == [5, 6, 7]
    close_params(runner2.get_params(), jr2.get_params())
    # an already-done target is a no-op
    port.fit(runner2, source, steps=8, saver=saver, log_every=0)
    assert runner2.step_count == 8
    saver.close()


def test_fit_steps_per_loop_matches_per_step(jax_fit):
    runner = prunner()
    hist = port.fit(runner, source, steps_per_loop=5, **FIT)
    assert runner.step_count == 12
    close_history(hist, jax_fit[0])
    close_params(runner.get_params(), jax_fit[1])
    per_step = prunner()
    port.fit(per_step, source, **FIT)
    close_params(runner.get_params(), per_step.get_params())


def test_fit_steps_per_loop_saves_on_cadence(tmp_path):
    runner = prunner()
    saver = port.Saver(str(tmp_path))
    port.fit(runner, source, steps=9, saver=saver, save_every=3,
             log_every=0, steps_per_loop=4)
    assert saver.all_steps() == [3, 6, 9]
    assert saver.latest_step() == 9 and runner.step_count == 9


def test_fit_steps_per_loop_ragged_final_batch():
    batches = [source(i) for i in range(5)]
    batches.append({k: v[:8] for k, v in source(5).items()})  # ragged
    jr = jrunner()
    jfit(jr, list(batches), steps=6, log_every=0)
    runner = prunner()
    port.fit(runner, list(batches), steps=6, log_every=0, steps_per_loop=4)
    assert runner.step_count == 6
    close_params(runner.get_params(), jr.get_params())


STACKED = np.random.RandomState(0).randn(4, 8, 8).astype(np.float32) * 0.3


def pipe_source(step):
    x = np.random.RandomState(100 + step).randn(8, 8).astype(np.float32)
    return {"x": x, "y": x * 0.5}


def test_fit_with_pipeline_runner(tmp_path):
    """Prefetch, periodic checkpoints and a resume through the pipeline
    lowering, against the JAX ``Pipeline`` runner."""
    import jax

    def jmake():
        return JPipelineTrainable(
            lambda p, x: jax.nn.relu(x @ p["w"]),
            {"w": jnp.asarray(STACKED)},
            lambda o, b: (jnp.mean((o - b["y"]) ** 2), {}),
            optax.sgd(0.05), num_stages=4)

    def pmake():
        return port.PipelineTrainable(
            lambda p, x: torch.relu(x @ p["w"]), {"w": torch.tensor(STACKED)},
            lambda o, b: (((o - b["y"]) ** 2).mean(), {}),
            port.optim.sgd(0.05), num_stages=4)

    spec = {"topology": {"platform": "cpu", "num_devices": 4},
            "mesh": {"pipe": 4}}
    jsaver = JSaver(str(tmp_path / "jax"))
    jfit(JAutoDist(spec, JPipeline(num_microbatches=2)).build(jmake()),
         pipe_source, steps=4, saver=jsaver, save_every=2, log_every=0)
    jr2 = JAutoDist(spec, JPipeline(num_microbatches=2)).build(jmake())
    jfit(jr2, pipe_source, steps=6, saver=jsaver, log_every=0)
    jsaver.close()

    def build():
        return port.AutoDist({"mesh": {"pipe": 1}}, port.Pipeline(
            num_microbatches=2, virtual_stages=4), device="cpu").build(
                pmake())

    saver = port.Saver(str(tmp_path / "port"))
    runner = build()
    port.fit(runner, pipe_source, steps=4, saver=saver, save_every=2,
             log_every=0)
    assert runner.step_count == 4 and saver.all_steps() == [2, 4]
    runner2 = build()
    hist = port.fit(runner2, pipe_source, steps=6, saver=saver,
                    log_every=2, eval_source=pipe_source, eval_every=6,
                    eval_batches=1)
    assert runner2.step_count == 6 and saver.latest_step() == 6
    assert [s for s, _ in hist["loss"]] == [6]
    np.testing.assert_allclose(runner2.get_params()["w"].numpy(),
                               np.asarray(jr2.get_params()["w"]), **TOL)
    # eval: the forward schedule and the head, no update
    ev = runner2.eval_step(pipe_source(0))
    want = np.mean((np.asarray(jr2.eval_step(pipe_source(0))["loss"])))
    np.testing.assert_allclose(float(ev["loss"]), want, **TOL)
    assert runner2.step_count == 6
    saver.close()


def test_run_summary_and_eval_match_jax():
    """``runner.run`` (a wait a step, a telemetry record a step) and
    ``summary``; ``eval_step`` / ``evaluate`` leave the state alone and
    equal the JAX runner's; ``run(drift_monitor=)`` is not ported."""
    jr, runner = jrunner(), prunner()
    data = [source(i) for i in range(3)]
    want = jr.run(data)
    got = runner.run(data)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               **TOL)
    summary = runner.summary()
    assert summary["steps"] == 3 and summary["examples_per_sec"] > 0
    assert summary["p50_ms"] is not None
    assert runner.step_count == 3
    ev = runner.evaluate([source(10), source(11)])
    jev = jr.evaluate([source(10), source(11)])
    np.testing.assert_allclose(ev["loss"], np.asarray(jev["loss"]), **TOL)
    assert runner.step_count == 3
    close_params(runner.get_params(), jr.get_params())
    with pytest.raises(NotImplementedError,
                       match="telemetry and program lint"):
        runner.run(data, drift_monitor=object())
