"""Asynchronous PS and the SSP gate in the port, against the JAX package.

The cases of ``tests/unit/test_async_ssp.py`` and
``tests/unit/test_run_steps.py``'s SSP case, each run on the port's
runner with ``device="cpu"`` and, where the result is deterministic,
held to the JAX package's runner on the same weights and batches (made
from a seed with numpy): a single async worker that waits for each apply
equals JAX's ``AsyncPSRunner`` and the single-device loop (1e-6, JAX's
tolerance); the lowering refuses ``sync=False`` in JAX's words; the SSP
gate times ``runner.step`` by the reference's c9 rule; a 24-deep burst
is applied with at most 4 publishes; ``run_steps`` under the gate
honours the caller's seeds; ``fit`` drives an ``AsyncPSRunner``; a
2-layer BERT trains alike in both packages through ``AutoDist(spec,
PS(sync=False))``; and a worker in another process pushes to the chief's
PS.

JAX's async worker takes the ``pmean`` of its local devices' gradients
(8 simulated CPU devices here); the port's takes the whole local
batch's gradient on its one device.  The two are equal where every
shard's loss has the same normalizer, as these batches' do (an MSE over
equal shards; BERT's ``masked_weights`` all ones).
"""
import copy
import os
import subprocess
import sys
import textwrap
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import telemetry
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.runner import _pack_tree, _unpack_tree
from autodist_tpu_torch.runtime import coordination

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = dict(rtol=1e-6, atol=1e-6)


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 3).astype(np.float32),
            "b": np.zeros((3,), np.float32)}


def make_trainable(optimizer=None, seed=0):
    params = {k: torch.as_tensor(v) for k, v in _init(seed).items()}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return ((pred - batch["y"]) ** 2).mean()

    return port.Trainable.from_loss_fn(
        loss_fn, params, optimizer or port.optim.sgd(0.1))


def make_jax_trainable(optimizer=None, seed=0):
    from autodist_tpu import Trainable

    params = {k: jnp.asarray(v) for k, v in _init(seed).items()}

    def loss_fn(p, batch):
        pred = batch["x"] @ p["w"] + p["b"]
        return jnp.mean((pred - batch["y"]) ** 2)

    return Trainable.from_loss_fn(loss_fn, params,
                                  optimizer or optax.sgd(0.1))


def make_batch(seed=1):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(16, 6).astype(np.float32),
            "y": rng.randn(16, 3).astype(np.float32)}


def single_device_reference(batches):
    """The port's plain loop: the loss's gradient and SGD(0.1)."""
    t = make_trainable()
    params = dict(flatten_with_names(t.params))
    for b in batches:
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _, _ = t.loss(leaves, None,
                            {k: torch.as_tensor(v) for k, v in b.items()},
                            None)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        params = {k: params[k] - 0.1 * g for k, g in zip(leaves, grads)}
    return params


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_with_names(tree)}


@pytest.fixture()
def service(monkeypatch):
    """A coordination server advertised to this process (and its
    children) through ``AUTODIST_TPU_COORD_SERVICE``."""
    server = coordination.CoordServer()
    monkeypatch.setenv("AUTODIST_TPU_COORD_SERVICE",
                       f"127.0.0.1:{server.port}")
    monkeypatch.setenv("AUTODIST_TPU_COORD_TOKEN", server.token)
    coordination.reset_service_client()
    yield server
    coordination.reset_service_client()
    server.stop()


def test_async_ps_single_worker_matches_sync_and_jax():
    """One async worker that waits for each apply is synchronous SGD:
    the port's params equal the single-device loop's and JAX's
    ``AsyncPSRunner``'s after 3 steps (1e-6)."""
    from autodist_tpu import PS as JaxPS
    from autodist_tpu import AutoDist as JaxAutoDist

    batches = [make_batch(s) for s in range(3)]
    runner = port.AutoDist({}, port.PS(sync=False),
                           device="cpu").build(make_trainable())
    assert isinstance(runner, port.AsyncPSRunner)
    assert runner.strategy is not None
    try:
        for i, b in enumerate(batches):
            runner.step(b)
            runner.wait_applied(i + 1)
        got = _flat(runner.get_params())
    finally:
        runner.close()
    jr = JaxAutoDist({}, JaxPS(sync=False)).build(make_jax_trainable())
    try:
        for i, b in enumerate(batches):
            jr.step(b)
            jr.wait_applied(i + 1)
        want_jax = {k: np.asarray(v) for k, v in jr.get_params().items()}
    finally:
        jr.close()
    want = {k: v.numpy() for k, v in single_device_reference(batches).items()}
    assert set(got) == set(want) == set(want_jax)
    for k in got:
        np.testing.assert_allclose(got[k], want[k], **JAX_TOL, err_msg=k)
        np.testing.assert_allclose(got[k], want_jax[k], **JAX_TOL,
                                   err_msg=k)
    # The runner served the coordination service itself and has stopped
    # advertising it.
    assert "AUTODIST_TPU_COORD_SERVICE" not in os.environ


def test_async_ps_metrics_and_progress():
    """Losses fall over 6 steps, the step count follows, and each step
    moves the push, pull and apply counters."""
    tel = telemetry.get()
    before = {k: tel.counter(f"asyncps/{k}").value
              for k in ("push", "pull", "apply", "publish")}
    runner = port.AutoDist({}, port.PS(sync=False),
                           device="cpu").build(make_trainable())
    try:
        b = make_batch()
        losses = []
        for i in range(6):
            m = runner.step(b)
            runner.wait_applied(i + 1)
            losses.append(float(m["loss"]))
        assert runner.step_count == 6
        assert losses[-1] < losses[0]
    finally:
        runner.close()
    moved = {k: tel.counter(f"asyncps/{k}").value - v
             for k, v in before.items()}
    assert moved["push"] == 6 and moved["apply"] == 6
    assert moved["pull"] >= 6 and moved["publish"] >= 6
    assert {"asyncps/pack", "asyncps/push", "asyncps/apply",
            "asyncps/publish", "asyncps/pull"} <= {s["name"]
                                                   for s in tel.spans}


def test_sync_lowering_rejects_async_config():
    """Lowering ``sync=False`` directly fails loudly, in the JAX
    package's words (``AutoDist.build`` takes it to the
    ``AsyncPSRunner``)."""
    from autodist_tpu_torch.kernel.lowering import lower

    t = make_trainable()
    rs = port.ResourceSpec({})
    strategy = port.PS(sync=False).build(t, rs)
    with pytest.raises(NotImplementedError, match="sync=False") as ei:
        lower(t, strategy, rs.make_mesh(), "cpu")
    assert "AsyncPSRunner" in str(ei.value)
    assert "ROADMAP" not in str(ei.value)


def test_stale_ps_lowers_with_its_bound(caplog, monkeypatch):
    """``PS(staleness=2)`` lowers to the synchronous step with the bound
    on the lowered program; without a coordination service the runner
    warns and trains in lockstep, as the JAX runner does."""
    monkeypatch.delenv("AUTODIST_TPU_COORD_SERVICE", raising=False)
    ad = port.AutoDist({}, port.PS(staleness=2), device="cpu")
    t = make_trainable()
    lowered = ad.lower(t)
    assert lowered.ssp_staleness == 2 and lowered.plan.ssp_staleness == 2
    with caplog.at_level("WARNING"):
        runner = ad.build(t)
    assert runner._ssp is None
    assert "running in lockstep" in caplog.text
    assert np.isfinite(float(runner.step(make_batch())["loss"]))


def test_ssp_gate_through_runner_step(service):
    """c9 timing through ``runner.step``: at staleness 1 the fast runner
    reaches step 2 at once, and step 2 + k waits for the slow runner's
    step k."""
    ad = port.AutoDist({}, port.PS(sync=True, staleness=1), device="cpu")
    b = make_batch()
    starts, t0_box = {}, {}
    errors = []
    # Each worker builds and steps on its own thread: the coordination
    # client is one a thread, and the registration barrier needs both.
    ready = threading.Barrier(2, timeout=60)

    def fast():
        try:
            runner = ad.build(make_trainable(), ssp_worker="fast",
                              ssp_num_workers=2)
            assert isinstance(runner, port.DistributedRunner)
            assert runner._ssp is not None
            runner.step(b)          # SSP cannot block at step 0
            ready.wait()
            t0_box["t0"] = time.monotonic()
            for step in range(1, 5):
                runner.step(b)      # the gate waits inside step()
                starts[step] = time.monotonic()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    def slow():
        try:
            runner = ad.build(make_trainable(), ssp_worker="slow",
                              ssp_num_workers=2)
            runner.step(b)
            ready.wait()
            for _ in range(1, 5):
                time.sleep(0.3)
                runner.step(b)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=fast), threading.Thread(target=slow)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors, errors
    assert not any(th.is_alive() for th in threads), "threads hung"
    t0 = t0_box["t0"]
    assert starts[2] - t0 < 0.29, starts
    assert starts[3] - t0 > 0.29, starts
    assert starts[4] - t0 > 0.59, starts


def test_async_ps_burst_publishes_fewer_than_applies(service):
    """Publish gating: a backlog of 24 queued gradients (enqueued before
    the PS exists) is applied with at most one serialization every 8
    updates, plus the drain's; every update is SGD with the constant
    gradient, so the result is exact."""
    t = make_trainable()
    client = coordination.service_client()
    g = {k: torch.full(v.shape, 0.01) for k, v in t.params.items()}
    for i in range(24):
        client.queue_put(port.AsyncPSRunner.GRADS_QUEUE, _pack_tree(i, g))
    runner = port.AsyncPSRunner(t, device="cpu", publish_max_lag=8,
                                publish_max_interval_s=3600.0)
    try:
        runner.wait_applied(24, timeout_s=60.0)
        # lag publishes at 8, 16, 24 (the drain adds none); one more is
        # allowed for scheduling skew.
        assert runner.ps_publish_count <= 4, runner.ps_publish_count
        got = _flat(runner.get_params())
        for k, v in _init().items():
            np.testing.assert_allclose(got[k], v - 0.1 * 24 * 0.01,
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    finally:
        runner.close()


def test_async_ps_exactness_survives_publish_gating():
    """The one-worker exactness under gating: a pull after
    ``wait_applied`` sees the drain's publish."""
    runner = port.AsyncPSRunner(make_trainable(), device="cpu",
                                publish_max_lag=8,
                                publish_max_interval_s=3600.0)
    try:
        bs = [make_batch(seed=i) for i in range(4)]
        for i, b in enumerate(bs):
            runner.step(b)
            runner.wait_applied(i + 1, timeout_s=30.0)
        got = _flat(runner.get_params())
    finally:
        runner.close()
    for k, v in single_device_reference(bs).items():
        np.testing.assert_allclose(got[k], v.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_run_steps_under_the_gate_honors_rngs(service):
    """Under an active SSP gate ``run_steps`` is a loop of ``step`` calls
    that uses the caller's seeds (a seed-dependent loss shows a loop
    that draws its own), and captures nothing."""

    def make_noisy():
        def loss_fn(p, batch, rng):
            gen = torch.Generator().manual_seed(int(rng))
            keep = (torch.rand(batch["x"].shape, generator=gen)
                    < 0.8).float()
            return (((batch["x"] * keep) @ p["w"] - batch["y"]) ** 2).mean()

        return port.Trainable.from_loss_fn(
            loss_fn, {"w": torch.ones(6, 3)}, port.optim.sgd(0.1),
            with_rng=True)

    bs = [make_batch(s) for s in range(3)]
    rngs = [11, 22, 33]
    ad = port.AutoDist({}, port.PS(sync=True, staleness=1), device="cpu")
    seq = ad.build(make_noisy(), ssp_worker="a", ssp_num_workers=1)
    assert seq._ssp is not None
    for b, r in zip(bs, rngs):
        seq.step(b, rng=r)
    fused = ad.build(make_noisy(), ssp_worker="b", ssp_num_workers=1)
    m = fused.run_steps(port.stack_steps(bs), rngs=rngs)
    assert m["loss"].shape[0] == 3 and fused.captures == 0
    assert fused.step_count == 3
    for k, v in _flat(fused.get_params()).items():
        np.testing.assert_allclose(v, _flat(seq.get_params())[k],
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    other = ad.build(make_noisy(), ssp_worker="c", ssp_num_workers=1)
    other.run_steps(port.stack_steps(bs))          # its own seeds
    assert not np.allclose(_flat(other.get_params())["w"],
                           _flat(seq.get_params())["w"])


def test_fit_drives_an_async_ps_runner():
    """``fit`` takes a runner without ``run_steps`` or ``lowered``
    through its per-step loop (``steps_per_loop`` notwithstanding), as
    the JAX package's ``fit`` does: the same log steps, every update
    applied."""
    from autodist_tpu import PS as JaxPS
    from autodist_tpu import AutoDist as JaxAutoDist
    from autodist_tpu.train import fit as jax_fit

    runner = port.AutoDist({}, port.PS(sync=False),
                           device="cpu").build(make_trainable())
    try:
        hist = port.fit(runner, make_batch, steps=4, log_every=2,
                        steps_per_loop=2)
        assert runner.step_count == 4
        runner.wait_applied(4)
        assert runner.ps_publish_count >= 1
    finally:
        runner.close()
    jr = JaxAutoDist({}, JaxPS(sync=False)).build(make_jax_trainable())
    try:
        jhist = jax_fit(jr, make_batch, steps=4, log_every=2,
                        steps_per_loop=2)
    finally:
        jr.close()
    assert [s for s, _ in hist["loss"]] == [s for s, _ in jhist["loss"]] \
        == [2, 4]
    assert all(np.isfinite(v) for _, v in hist["loss"])


def test_async_ps_constructor_contract(monkeypatch):
    """Mutable extra state is refused; a non-chief with no service
    raises ``OSError``; the blob's bytes are the tree's."""
    t = make_trainable()
    t.extra = {"stats": torch.zeros(2)}
    with pytest.raises(NotImplementedError, match="mutable extra state"):
        port.AsyncPSRunner(t, device="cpu")
    monkeypatch.delenv("AUTODIST_TPU_COORD_SERVICE", raising=False)
    monkeypatch.setenv("AUTODIST_TPU_WORKER", "w1")
    with pytest.raises(OSError, match="coordination service"):
        port.AsyncPSRunner(make_trainable(), device="cpu")


def test_pack_round_trip_and_jax_layout():
    """The blob is the JAX package's layout: the port unpacks a JAX
    blob, and JAX a port blob, leaf for leaf (bf16 leaves keep their
    bits)."""
    from autodist_tpu.runner import _pack_tree as jax_pack
    from autodist_tpu.runner import _unpack_tree as jax_unpack

    tree = {"b": torch.arange(3, dtype=torch.float32),
            "a": {"w": torch.randn(2, 4), "v": torch.ones(5)}}
    version, back = _unpack_tree(_pack_tree(7, tree), tree, "cpu")
    assert version == 7
    for (n, x), (m, y) in zip(flatten_with_names(tree),
                              flatten_with_names(back)):
        assert n == m and torch.equal(x, y)
    like = jax.tree.map(np.asarray, unflatten(
        {n: t.numpy() for n, t in flatten_with_names(tree)}))
    version, jtree = jax_unpack(_pack_tree(3, tree), like)
    assert version == 3
    for n, x in flatten_with_names(tree):
        np.testing.assert_array_equal(_flat(jtree)[n], x.numpy())
    version, ptree = _unpack_tree(jax_pack(5, like), tree, "cpu")
    assert version == 5
    for n, x in flatten_with_names(tree):
        assert torch.equal(dict(flatten_with_names(ptree))[n], x)
    bf = {"h": torch.randn(4, 3).to(torch.bfloat16)}
    _, bf_back = _unpack_tree(_pack_tree(0, bf), bf, "cpu")
    assert bf_back["h"].dtype == torch.bfloat16
    assert torch.equal(bf_back["h"], bf["h"])


def test_bert_through_async_ps_matches_jax():
    """A 2-layer BERT (hidden 128, einsum attention, fp32, dropout off)
    through ``AutoDist(spec, PS(sync=False))`` in both packages on the
    same converted weights and batches, ``wait_applied`` after each of 3
    SGD steps: params within 1e-5."""
    from autodist_tpu import PS as JaxPS
    from autodist_tpu import AutoDist as JaxAutoDist
    from autodist_tpu.capture import path_to_name
    from autodist_tpu.models import bert as jbert
    from autodist_tpu.models.transformer import TransformerConfig as JaxCfg
    from autodist_tpu_torch.models import bert as tbert

    sizes = dict(vocab_size=97, hidden_size=128, num_layers=2, num_heads=2,
                 mlp_dim=256, max_len=32, dropout_rate=0.0,
                 attention_dropout_rate=0.0)
    jt = jbert.make_mlm_trainable(JaxCfg(**sizes, dtype=jnp.float32),
                                  optax.sgd(0.1), jax.random.PRNGKey(0),
                                  batch_size=2, seq_len=16, num_masked=4)
    jparams = jax.tree.map(np.asarray, jt.params)
    tt = tbert.make_mlm_trainable(
        port.TransformerConfig(**sizes, dtype=torch.float32),
        port.optim.sgd(0.1), torch.Generator().manual_seed(0), device="cpu")
    tt.params = port.from_jax_params(jparams, device="cpu")
    # 8 rows: one a simulated JAX device.
    batches = [jbert.synthetic_mlm_batch(40 + i, 8, 16, 4, 97)
               for i in range(3)]

    jr = JaxAutoDist({}, JaxPS(sync=False)).build(copy.copy(jt))
    try:
        for i, b in enumerate(batches):
            jr.step(b)
            jr.wait_applied(i + 1)
        want = {path_to_name(p): np.asarray(x) for p, x in
                jax.tree_util.tree_flatten_with_path(jr.get_params())[0]}
    finally:
        jr.close()
    runner = port.AutoDist({}, port.PS(sync=False), device="cpu").build(tt)
    try:
        losses = []
        for i, b in enumerate(batches):
            losses.append(float(runner.step(b)["loss"]))
            runner.wait_applied(i + 1)
        got = _flat(runner.get_params())
    finally:
        runner.close()
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p, want[name], atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    assert all(np.isfinite(losses))


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import autodist_tpu_torch as port

    rng = np.random.RandomState(0)
    params = {"w": torch.as_tensor(rng.randn(6, 3).astype(np.float32)),
              "b": torch.zeros(3)}

    def loss_fn(p, batch):
        return ((batch["x"] @ p["w"] + p["b"] - batch["y"]) ** 2).mean()

    t = port.Trainable.from_loss_fn(loss_fn, params, port.optim.sgd(0.1))
    runner = port.AutoDist({}, port.PS(sync=False), device="cpu").build(t)
    assert not runner.is_chief
    for i in range(4):
        r = np.random.RandomState(100 + i)
        runner.step({"x": r.randn(16, 6).astype(np.float32),
                     "y": r.randn(16, 3).astype(np.float32)})
    runner.close()
    print("pushed", runner.step_count)
""")


def test_worker_in_another_process_pushes_to_the_chief():
    """The chief (its PS thread and a worker) here, one more worker in a
    subprocess that imports only the port: 4 pushes each, all 8 applied,
    the parameters finite."""
    runner = port.AutoDist({}, port.PS(sync=False),
                           device="cpu").build(make_trainable())
    try:
        assert runner.is_chief
        env = dict(os.environ, AUTODIST_TPU_WORKER="w1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen([sys.executable, "-c", _WORKER], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for i in range(4):
            runner.step(make_batch(200 + i))
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out
        assert "pushed 4" in out
        runner.wait_applied(8, timeout_s=60.0)
        params = _flat(runner.get_params())
        assert all(np.isfinite(v).all() for v in params.values())
        assert not np.allclose(params["w"], _init()["w"])
    finally:
        runner.close()
