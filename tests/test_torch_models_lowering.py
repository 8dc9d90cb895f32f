"""The model zoo through the collective lowering, the port against the
JAX package on the CPU.

* Cross-replica BatchNorm: ResNet18 (``num_filters=8``, 32 px)
  through ``AllReduce`` on 2 gloo ranks, 3 ``sgd(0.1, momentum=0.9)``
  steps on a global batch of 8, against the JAX runner on a 2-device
  mesh, and against one port rank on the whole batch (both sides use
  the global statistics, so they agree): params and ``batch_stats``
  within 1e-5 of each tensor's largest value (floor 1e-3), losses within
  1e-5 relative.  The lowering binds the data axis around the loss, as
  the JAX program's ``shard_map`` does, and the statistics' mean is
  differentiable, its gradient averaged over the ranks too (a gradient
  left local would miss by far more than the tolerance).  The model and
  its parameters are float64 (``jax.enable_x64`` on the JAX side; the
  gradient buckets still travel in fp32): in fp32 the norms' scales and
  biases part by up to 2.5e-5 of their largest value after 3 steps, in
  every pair of these runs, as the fast variance's rounding at a 1x1
  map over 4 samples moves their gradients
  (``test_torch_models_vision.py``).
* lm1b (vocab 2000, widths 32, 2 layers) through ``Parallax`` on the
  same 2 ranks (the tables row-sharded, touched rows only), 3
  ``adagrad(0.2)`` steps at chosen seeds, against a plain JAX loop fed
  the port's per-step keys: rank ``i`` of ``n`` draws its negatives
  from ``PRNGKey(seed * n + i)``, so the loop takes ``value_and_grad``
  of the JAX trainable's loss on each half of the batch at its key,
  averages, and applies ``optax.adagrad``; same tolerances.
* The GSPMD lowering binds no axis in either package: a BatchNorm
  model trained through ``FSDPSharded`` raises ``NameError`` in both.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import models as pm
from autodist_tpu_torch import testing

import test_torch_models_vision as h

WORLD = 2
STEPS = 3
LM = dict(vocab_size=2000, embed_dim=32, hidden_dim=32, num_layers=2)
LM_SEEDS = (5, 17, 123)

_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import models as pm
    from autodist_tpu_torch import testing
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    res = {}

    tr = pm.make_image_trainable(
        pm.ResNet18(num_classes=10, num_filters=8, dtype=torch.float64),
        port.optim.sgd(0.1, momentum=0.9), torch.Generator(),
        image_size=32, device="cpu")
    tr.params = port.from_jax_params(job["resnet"], device="cpu")
    tr.extra = port.from_jax_params(job["resnet_extra"], device="cpu")
    runner = port.AutoDist({}, port.AllReduce(), device="cpu").build(tr)
    losses = [float(runner.step(b)["loss"]) for b in job["images"]]
    res["resnet"] = {"params": runner.get_params(),
                     "extra": runner.get_extra(), "losses": losses}

    lm = pm.make_lm1b_trainable(port.optim.adagrad(0.2), torch.Generator(),
                                device="cpu", **job["lm_sizes"])
    lm.params = port.from_jax_params(job["lm"], device="cpu")
    runner = port.AutoDist({}, port.Parallax(), device="cpu").build(lm)
    losses = [float(runner.step(b, rng=s)["loss"])
              for b, s in zip(job["tokens"], job["seeds"])]
    res["lm1b"] = {"params": runner.get_params(), "losses": losses,
                   "sharded": sorted(n for n, vp in
                                     runner.lowered.plan.var_plans.items()
                                     if vp.stored_sharded)}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _images(seed):
    return h.image_batch(32, 8, 10, seed)


def _tokens(seed):
    r = np.random.RandomState(seed)
    return {"x": r.randint(0, 2000, (4, 5)).astype(np.int32),
            "y": r.randint(0, 2000, (4, 5)).astype(np.int32)}


def _resnet_trainable(dtype=torch.float64):
    return pm.make_image_trainable(
        pm.ResNet18(num_classes=10, num_filters=8, dtype=dtype),
        port.optim.sgd(0.1, momentum=0.9), torch.Generator().manual_seed(0),
        image_size=32, device="cpu")


def _f64(tree):
    return jax.tree.map(lambda a: a.astype(np.float64), tree)


@pytest.fixture(scope="module")
def job():
    tr = _resnet_trainable()
    lm = pm.make_lm1b_trainable(port.optim.adagrad(0.2),
                                torch.Generator().manual_seed(1),
                                device="cpu", **LM)
    return {"resnet": _f64(port.to_jax_params(tr.params)),
            "resnet_extra": _f64(port.to_jax_params(tr.extra)),
            "images": [_images(s) for s in range(STEPS)],
            "lm": port.to_jax_params(lm.params), "lm_sizes": LM,
            "tokens": [_tokens(10 + s) for s in range(STEPS)],
            "seeds": list(LM_SEEDS)}


@pytest.fixture(scope="module")
def ranks(job, tmp_path_factory):
    """The 2-rank job, started before the JAX work and joined on use."""
    tmp = tmp_path_factory.mktemp("zoo_lowering")
    torch.save(job, tmp / "job.pt")
    join = testing.launch(_WORKER, WORLD, (tmp / "job.pt", tmp / "out.pt"),
                          tmp=tmp / "ranks", timeout=300)
    done = {}

    def result():
        if not done:
            join()
            done.update(torch.load(tmp / "out.pt", weights_only=False))
        return done

    return result


def _check(got_params, want_params, got_losses, want_losses, what):
    h.close(h.named(got_params), h.named(want_params), h.TOL, what)
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5,
                               err_msg=what)


def test_synced_batchnorm_on_two_ranks_matches_the_jax_runner(job, ranks):
    from autodist_tpu import AllReduce, AutoDist
    from autodist_tpu.models import resnet

    with jax.enable_x64(True):
        jmodel = resnet.ResNet18(num_classes=10, num_filters=8,
                                 dtype=jnp.float64)
        jtr = h.jax_trainable(lambda k: resnet.make_image_trainable(
            jmodel, optax.sgd(0.1, momentum=0.9), k, image_size=32,
            batch_size=2))
        jtr.params = jax.tree.map(jnp.asarray, job["resnet"])
        jtr.extra = jax.tree.map(jnp.asarray, job["resnet_extra"])
        runner = AutoDist({"topology": {"platform": "cpu",
                                        "num_devices": WORLD}},
                          AllReduce()).build(jtr)
        losses = [float(np.asarray(runner.step(b)["loss"]))
                  for b in job["images"]]
        params = jax.device_get(runner.get_params())
        extra = jax.device_get(runner.get_extra())
    got = ranks()["resnet"]
    _check(got["params"], params, got["losses"], losses, "params")
    h.close(h.named(got["extra"]), h.named(extra), h.TOL, "batch_stats")


def test_synced_batchnorm_on_two_ranks_matches_one_rank(job, ranks):
    """Global statistics on 2 ranks are the whole batch's on 1."""
    tr = _resnet_trainable()
    tr.params = port.from_jax_params(job["resnet"], device="cpu")
    tr.extra = port.from_jax_params(job["resnet_extra"], device="cpu")
    runner = port.AutoDist({}, port.AllReduce(), device="cpu").build(tr)
    losses = [float(runner.step(b)["loss"]) for b in job["images"]]
    got = ranks()["resnet"]
    _check(got["params"], runner.get_params(), got["losses"], losses,
           "params")
    h.close(h.named(got["extra"]), h.named(runner.get_extra()), h.TOL,
            "batch_stats")


def test_lm1b_through_parallax_matches_a_jax_loop(job, ranks):
    from autodist_tpu.models import lm1b

    jtr = h.jax_trainable(lambda k: lm1b.make_lm1b_trainable(
        optax.adagrad(0.2), k, **LM))
    opt = optax.adagrad(0.2)
    params = jax.tree.map(jnp.asarray, job["lm"])
    state = opt.init(params)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b, key: jtr.loss(p, None, b, key)[0]))
    losses = []
    for batch, seed in zip(job["tokens"], job["seeds"]):
        rows = len(batch["x"]) // WORLD
        parts = [grad(params, {k: v[i * rows:(i + 1) * rows]
                               for k, v in batch.items()},
                      jax.random.PRNGKey(seed * WORLD + i))
                 for i in range(WORLD)]
        losses.append(float(np.mean([float(l) for l, _ in parts])))
        g = jax.tree.map(lambda *gs: sum(gs) / WORLD, *[g for _, g in parts])
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    got = ranks()["lm1b"]
    assert got["sharded"] == ["embedding/embedding", "softmax_w"]
    _check(got["params"], jax.device_get(params), got["losses"], losses,
           "params")


def test_gspmd_binds_no_axis_in_either_package(job):
    from autodist_tpu import AutoDist, FSDPSharded
    from autodist_tpu.models import resnet

    batch = h.image_batch(32, 2, 10)
    runner = port.AutoDist({"mesh": {"data": 1, "model": 1}},
                           port.FSDPSharded(), device="cpu").build(
        _resnet_trainable(torch.float32))
    with pytest.raises(NameError, match="unbound axis name"):
        runner.step(batch)
    jmodel = resnet.ResNet18(num_classes=10, num_filters=8,
                             dtype=jnp.float32)
    jtr = h.jax_trainable(lambda k: resnet.make_image_trainable(
        jmodel, optax.sgd(0.1), k, image_size=32, batch_size=2))
    jtr.params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                              job["resnet"])
    jtr.extra = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                             job["resnet_extra"])
    jrunner = AutoDist({"topology": {"platform": "cpu", "num_devices": 1},
                        "mesh": {"data": 1, "model": 1}},
                       FSDPSharded()).build(jtr)
    with pytest.raises(NameError, match="unbound axis name"):
        jrunner.step(batch)
