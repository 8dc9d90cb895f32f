"""``fetch`` in the port against the JAX package's, on the CPU.

The cases of ``tests/unit/test_fetches.py``: a 3-layer tanh MLP tags
each layer's activation norm (and, to hold the leaf-by-leaf metric
reduction, a per-feature mean vector and an integer count); on 2 gloo
ranks under ``PartitionedPS`` (FSDP), ``GradAccumulation(PartitionedPS,
2)`` and ``ZeRO(stage=3)`` the fetched metrics equal the JAX runner's on
a data axis of 2 within 1e-5 (floats averaged over the replicas, the
count summed).  The pipeline's loss head tags a value, held to the JAX
``Pipeline`` runner's; a tag inside a stage raises naming the tag, as do
a duplicate tag and a tag colliding with a metric; outside a collector
``fetch`` is a no-op.
"""
import textwrap

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu import AutoDist as JAutoDist
from autodist_tpu import PipelineTrainable as JPipelineTrainable
from autodist_tpu import Trainable as JTrainable
from autodist_tpu import fetch as jfetch
from autodist_tpu.strategy import builders as jbuilders
from autodist_tpu_torch import testing

TOL = dict(rtol=1e-5, atol=1e-5)
DIM = 16
WEIGHTS = [np.random.RandomState(i).randn(DIM, DIM).astype(np.float32)
           * 0.3 for i in range(3)]
BUILDERS = {"PartitionedPS": ("PartitionedPS", {}),
            "accum": ("GradAccumulation", {"builder": "PartitionedPS",
                                           "steps": 2}),
            "ZeRO3": ("ZeRO", {"stage": 3})}


def batch(seed=0):
    r = np.random.RandomState(seed)
    return {"x": r.randn(8, DIM).astype(np.float32),
            "y": r.randn(8, DIM).astype(np.float32)}


def jax_mlp():
    def loss_fn(p, b):
        h = b["x"]
        for i in range(3):
            h = jnp.tanh(h @ p[f"layer{i}"]["w"])
            jfetch(f"act_norm_l{i}", jnp.linalg.norm(h) / h.shape[0])
        jfetch("feature_mean", h.mean(0))
        jfetch("positive", jnp.sum(h > 0))
        return jnp.mean((h - b["y"]) ** 2)

    params = {f"layer{i}": {"w": jnp.asarray(w)}
              for i, w in enumerate(WEIGHTS)}
    return JTrainable.from_loss_fn(loss_fn, params, optax.sgd(0.1))


def jax_builder(name, kw):
    kw = dict(kw)
    if "builder" in kw:
        kw["builder"] = jbuilders.create(kw["builder"])
    return jbuilders.create(name, **kw)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.strategy import builders
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)

    def mlp():
        def loss_fn(p, b):
            h = b["x"]
            for i in range(3):
                h = torch.tanh(h @ p[f"layer{i}"]["w"])
                port.fetch(f"act_norm_l{i}", h.norm() / h.shape[0])
            port.fetch("feature_mean", h.mean(0))
            port.fetch("positive", (h > 0).sum())
            return ((h - b["y"]) ** 2).mean()
        params = {f"layer{i}": {"w": torch.tensor(w)}
                  for i, w in enumerate(job["weights"])}
        return port.Trainable.from_loss_fn(loss_fn, params,
                                           port.optim.sgd(0.1))

    got = {}
    for label, (name, kw) in job["builders"].items():
        kw = dict(kw)
        if "builder" in kw:
            kw["builder"] = builders.create(kw["builder"])
        runner = port.AutoDist({}, builders.create(name, **kw),
                               device="cpu").build(mlp())
        m = runner.step(job["batch"])
        got[label] = {k: v for k, v in m.items() if k.startswith("fetch/")}
        got[label + " eval"] = {k: v for k, v in
                                runner.eval_step(job["batch"]).items()
                                if k.startswith("fetch/")}
    torch.save(got, f"{out}.{rank}")
    testing.end_rank()
""")


def test_fetch_on_two_ranks_matches_jax(tmp_path):
    inp = tmp_path / "job.pt"
    torch.save({"weights": WEIGHTS, "builders": BUILDERS,
                "batch": batch()}, inp)
    testing.launch(_WORKER, 2, (inp, tmp_path / "out"), tmp=tmp_path,
                   timeout=240)()
    spec = {"topology": {"platform": "cpu", "num_devices": 2},
            "mesh": {"data": 2}}
    for label, (name, kw) in BUILDERS.items():
        jr = JAutoDist(spec, jax_builder(name, kw)).build(jax_mlp())
        want = {k: np.asarray(v) for k, v in jr.step(batch()).items()
                if k.startswith("fetch/")}
        want_eval = {k: np.asarray(v) for k, v in
                     jr.eval_step(batch()).items() if k.startswith("fetch/")}
        assert set(want) == {"fetch/act_norm_l0", "fetch/act_norm_l1",
                             "fetch/act_norm_l2", "fetch/feature_mean",
                             "fetch/positive"}
        for rank in range(2):
            got = torch.load(tmp_path / f"out.{rank}", weights_only=False)
            for which, ref in ((label, want), (label + " eval", want_eval)):
                assert set(got[which]) == set(ref), which
                for k, v in ref.items():
                    g = got[which][k]
                    assert tuple(g.shape) == v.shape, (which, k)
                    assert g.is_floating_point() == \
                        np.issubdtype(v.dtype, np.floating), (which, k)
                    np.testing.assert_allclose(g.numpy(), v, **TOL,
                                               err_msg=f"{which} {k}")


S, H = 4, 8
STACKED = np.random.RandomState(0).randn(S, H, H).astype(np.float32) * 0.4


def test_fetch_under_pipeline_loss_head():
    def jhead(outputs, b):
        jfetch("head_out_norm", jnp.linalg.norm(outputs) / outputs.shape[0])
        return jnp.mean((outputs - b["y"]) ** 2), {}

    def head(outputs, b):
        port.fetch("head_out_norm", outputs.norm() / outputs.shape[0])
        return ((outputs - b["y"]) ** 2).mean(), {}

    jt = JPipelineTrainable(lambda p, x: jnp.tanh(x @ p["w"]),
                            {"w": jnp.asarray(STACKED)}, jhead,
                            optax.sgd(0.05), num_stages=S)
    jr = JAutoDist({"topology": {"platform": "cpu", "num_devices": 4},
                    "mesh": {"data": 1, "pipe": 4}}, "Pipeline",
                   num_microbatches=2).build(jt)
    t = port.PipelineTrainable(lambda p, x: torch.tanh(x @ p["w"]),
                               {"w": torch.tensor(STACKED)}, head,
                               port.optim.sgd(0.05), num_stages=S)
    runner = port.AutoDist({"mesh": {"pipe": 1}}, port.Pipeline(
        num_microbatches=2, virtual_stages=S), device="cpu").build(t)
    r = np.random.RandomState(0)
    bh = {"x": r.randn(8, H).astype(np.float32),
          "y": r.randn(8, H).astype(np.float32)}
    want = float(np.asarray(jr.step(bh)["fetch/head_out_norm"]))
    got = float(runner.step(bh)["fetch/head_out_norm"])
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, **TOL)
    # the sequential reference loss reports the same tag
    seq = t.loss(t.params, None, {k: torch.tensor(v) for k, v in
                                  bh.items()}, None)
    np.testing.assert_allclose(float(seq[2]["fetch/head_out_norm"]), want,
                               **TOL)


def test_fetch_inside_pipeline_stage_raises():
    def stage(p, x):
        h = torch.tanh(x @ p["w"])
        port.fetch("stage_h", h.norm())
        return h

    t = port.PipelineTrainable(
        stage, {"w": torch.tensor(STACKED)},
        lambda o, b: (((o - b["y"]) ** 2).mean(), {}),
        port.optim.sgd(0.05), num_stages=S)
    runner = port.AutoDist({"mesh": {"pipe": 1}}, port.Pipeline(
        num_microbatches=2, virtual_stages=S), device="cpu").build(t)
    b = {"x": np.ones((8, H), np.float32), "y": np.ones((8, H), np.float32)}
    with pytest.raises(ValueError, match="stage_h"):
        runner.step(b)


def _tiny(loss_fn):
    return port.Trainable.from_loss_fn(
        loss_fn, {"w": torch.ones(DIM, DIM)}, port.optim.sgd(0.1))


def test_fetch_collision_with_metric_errors():
    def loss_fn(p, b):
        port.fetch("act", torch.zeros(()))
        l = ((b["x"] @ p["w"]) ** 2).mean()
        return l, {"fetch/act": l}

    t = _tiny(loss_fn)
    with pytest.raises(ValueError, match="collides"):
        t.loss(t.params, None, {"x": torch.ones(2, DIM)}, None)


def test_fetch_duplicate_tag_raises():
    def loss_fn(p, b):
        for _ in range(2):
            port.fetch("act_norm", torch.zeros(()))
        return ((b["x"] @ p["w"]) ** 2).mean()

    t = _tiny(loss_fn)
    with pytest.raises(ValueError, match="already used"):
        t.loss(t.params, None, {"x": torch.ones(2, DIM)}, None)


def test_fetch_noop_outside_collector():
    x, y = torch.ones(3), jnp.ones(3)
    assert port.fetch("anything", x) is x
    assert jfetch("anything", y) is y
