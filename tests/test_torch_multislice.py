"""Multi-slice in the port against the JAX package on the CPU.

The cases of ``tests/unit/test_multislice.py`` ("every strategy must
produce identical numerics over a ``dcn x data`` mesh") on gloo ranks:
a 4-rank job lays its ranks out as ``{"dcn": 2, "data": 2}`` and a
8-rank one as ``{"dcn": 2, "data": 2, "seq": 2}``, each held to the JAX
package on a mesh of the same shape over as many CPU devices, on the
same seeded numpy weights and batches:

* ``AllReduce``, ``PS`` (ZeRO-1) and ``PartitionedPS`` on the linear
  model of ``tests/unit/test_end_to_end.py``: both packages' plans have
  ``repl_axes == ("dcn", "data")``, the params after 3 steps agree
  within the JAX golden's 2e-6, and the port's state manifests equal the
  JAX package's once the port's ``split`` is dropped;
* the ``Parallax`` vocab-sharded embedding of ``tests/unit/
  test_sparse.py`` over ``dcn x data`` (the touched-rows path spans both
  axes), at 2e-6;
* the ``num_slices`` shorthand (``{"dcn": 2, "data": 2}`` from
  ``topology.num_slices``) trains; 3 slices of 8 devices raise;
* ``ExpertParallel(expert_over_dcn=True)`` on a 2-slice spec whose mesh
  absorbs the slices into the expert axis, and plain ``ExpertParallel``
  with ``dcn`` in its replica axes, on the MoE LM at fp32 against the
  JAX runner (1e-5), with the JAX package's refusals and plan lint
  (ADT060, ADT061) on the same plans;
* sequence parallelism over ``dcn x data x seq`` against the JAX
  ``lower_sequence_parallel`` at 1e-5.  Its batch is ``[8, 8, 16]`` and
  every replica sees a different slice of it: had the gradient mean
  skipped ``dcn`` (a data-only mean, the fault the JAX test names), each
  slice would have stepped on its own half of the batch, and the two
  halves' gradients differ at O(1) for random data, far beyond 1e-5;
* the ``DataLoader``'s global batches split over the whole replica
  group; the project logger's records reach ``caplog``.
"""
import json
import logging
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel.common import flatten_with_names

DCN = {"dcn": 2, "data": 2}
TOL = dict(rtol=2e-6, atol=2e-6)          # tests/unit/test_multislice.py
SEQ_TOL = dict(rtol=1e-5, atol=1e-5)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
STEPS = 3
MOE_SIZES = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
                 expert_hidden=32, num_experts=4, capacity_factor=4.0,
                 max_len=8)
MOE_EPS = 1e-4
# label -> (JAX spec, port spec, ExpertParallel keywords)
MOE_CASES = {
    "over_dcn": ({"topology": {"num_devices": 4, "num_slices": 2},
                  "mesh": {"data": 2, "expert": 2}},
                 dict(expert_over_dcn=True)),
    "dcn_replicas": ({"topology": {"num_devices": 4},
                      "mesh": {"dcn": 2, "expert": 2}}, {}),
}


def linear_batch(seed):
    r = np.random.RandomState(seed)
    return {"x": r.randn(16, 6).astype(np.float32),
            "y": r.randn(16, 3).astype(np.float32)}


def sparse_batch(seed):
    # tests/unit/test_sparse.py's make_batch
    r = np.random.RandomState(seed)
    ids = r.randint(0, 64, (16, 4)).astype(np.int32)
    ids[:, 0] = ids[0, 0]
    return {"ids": ids, "y": r.randn(16).astype(np.float32)}


def moe_batches():
    r = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        x = r.randint(0, 64, (8, 8)).astype(np.int32)
        out.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return out


def seq_batch():
    r = np.random.RandomState(1)
    return {"x": r.randn(8, 8, 16).astype(np.float32),
            "y": r.randn(8, 8, 4).astype(np.float32)}


_PREAMBLE = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel.common import flatten_with_names
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)


    def params(runner):
        return {n: t.clone() for n, t in
                flatten_with_names(runner.get_params())}
""")

_WORKER4 = _PREAMBLE + textwrap.dedent("""
    from autodist_tpu_torch.data import DataLoader
    from autodist_tpu_torch.models import moe_transformer
    from autodist_tpu_torch.ops import embedding_lookup

    def linear(seed=0):
        # tests/unit/test_end_to_end.py's model
        r = np.random.RandomState(seed)
        p = {"dense": {"w": torch.tensor(r.randn(6, 3),
                                         dtype=torch.float32),
                       "b": torch.zeros(3)},
             "scale": torch.ones(())}

        def loss_fn(p, batch):
            pred = (batch["x"] @ p["dense"]["w"] + p["dense"]["b"]) \\
                * p["scale"]
            return ((pred - batch["y"]) ** 2).mean()

        return port.Trainable.from_loss_fn(loss_fn, p, port.optim.sgd(0.1))

    def sparse():
        # tests/unit/test_sparse.py's model
        r = np.random.RandomState(0)
        p = {"embedding": torch.tensor(r.randn(64, 8) * 0.1,
                                       dtype=torch.float32),
             "head": {"w": torch.tensor(r.randn(8, 1) * 0.1,
                                        dtype=torch.float32)}}

        def loss_fn(p, batch):
            emb = embedding_lookup(p["embedding"], batch["ids"])
            pred = (emb.mean(dim=1) @ p["head"]["w"])[:, 0]
            return ((pred - batch["y"]) ** 2).mean()

        return port.Trainable.from_loss_fn(loss_fn, p, port.optim.adam(1e-2),
                                           sparse_params=("embedding",))

    res = {}
    for label, builder in (("AllReduce", port.AllReduce()),
                           ("PS", port.PS()),
                           ("PartitionedPS", port.PartitionedPS())):
        runner = port.AutoDist({"mesh": job["mesh"]}, builder,
                               device="cpu").build(linear())
        plan = runner.lowered.plan
        manifest = runner.lowered.state_manifest(runner.state)
        for b in job["linear"]:
            runner.step(b)
        res[label] = {"repl_axes": plan.repl_axes,
                      "num_replicas": plan.num_replicas,
                      "params": params(runner), "manifest": manifest,
                      "batch_axis": runner.lowered.batch_axis.name}
    runner = port.AutoDist({"mesh": job["mesh"]}, port.Parallax(),
                           device="cpu").build(sparse())
    res["sparse_lookup"] = runner.lowered.plan.var_plans[
        "embedding"].sparse_lookup
    for b in job["sparse"]:
        runner.step(b)
    res["Parallax"] = params(runner)
    shorthand = port.AutoDist(
        {"topology": {"num_devices": 4, "num_slices": 2}}, port.AllReduce(),
        device="cpu")
    runner = shorthand.build(linear())
    res["shorthand_mesh"] = dict(runner.mesh.shape)
    res["shorthand_loss"] = float(runner.step(job["linear"][0])["loss"])
    loader = DataLoader(lambda i: job["linear"][i], runner.mesh,
                        global_batches=True, num_batches=1, device="cpu")
    res["loader_x"] = [b["x"].clone() for b in loader][0]
    res["replica_index"] = runner.mesh.replica_axis().index
    for label, (spec, kw) in job["moe"].items():
        tr = moe_transformer.make_moe_lm_trainable(
            moe_transformer.MoeConfig(**job["moe_sizes"],
                                      dtype=torch.float32),
            port.optim.adam(1e-2, eps=job["eps"]),
            torch.Generator().manual_seed(0), batch_size=8, seq_len=8,
            device="cpu")
        tr.params = job["moe_params"]
        runner = port.AutoDist(spec, port.ExpertParallel(
            num_experts=4, capacity_factor=4.0, **kw), device="cpu").build(tr)
        ms = [runner.step(b) for b in job["moe_batches"]]
        res[label] = {"loss": [float(m["loss"]) for m in ms],
                      "params": params(runner),
                      "strategy": runner.strategy.to_json()}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")

_WORKER8 = _PREAMBLE + textwrap.dedent("""
    from autodist_tpu_torch.parallel.sequence import lower_sequence_parallel

    mesh = port.ResourceSpec({"mesh": {"dcn": 2, "data": 2, "seq": 2}}
                             ).make_mesh()
    p = {"w": torch.tensor(np.random.RandomState(0).randn(16, 4),
                           dtype=torch.float32)}

    def loss_fn(p, batch):
        # a token-mean loss: no attention is needed for the sync axes
        return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()

    tr = port.Trainable.from_loss_fn(loss_fn, p, port.optim.sgd(0.2))
    runner = port.DistributedRunner(tr, lower_sequence_parallel(
        tr, mesh, device="cpu"))
    for _ in range(2):
        runner.step(job["seq"], rng=0)
    res = {"w": runner.state["params"]["w"].clone(),
           "x_shape": tuple(runner.lowered.placement_of(job["seq"])
                            ["x"][0][1].ranks)}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _jax_moe_trainable():
    from autodist_tpu.models.moe_transformer import (MoeConfig,
                                                     make_moe_lm_trainable)

    return make_moe_lm_trainable(
        MoeConfig(**MOE_SIZES, dtype=jnp.float32),
        optax.adam(1e-2, eps=MOE_EPS), jax.random.PRNGKey(0), batch_size=8,
        seq_len=8)


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _launch(script, world, job, tmp):
    tmp.mkdir()
    inp, out = tmp / "job.pt", tmp / "res.pt"
    torch.save(job, inp)
    join = testing.launch(script, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both gloo jobs, started before the JAX programs run."""
    tmp = tmp_path_factory.mktemp("multislice")
    jparams = jax.tree.map(np.asarray, _jax_moe_trainable().params)
    four = _launch(_WORKER4, 4, {
        "mesh": DCN, "linear": [linear_batch(s) for s in range(STEPS)],
        "sparse": [sparse_batch(s) for s in range(2)],
        "moe": {k: ({"topology": dict(spec["topology"], platform="cpu"),
                     "mesh": spec["mesh"]}, kw)
                for k, (spec, kw) in MOE_CASES.items()},
        "moe_sizes": MOE_SIZES, "eps": MOE_EPS,
        "moe_params": port.from_jax_params(jparams, device="cpu"),
        "moe_batches": moe_batches()}, tmp / "four")
    eight = _launch(_WORKER8, 8, {"seq": seq_batch()}, tmp / "eight")
    return four, eight


@pytest.fixture(scope="module")
def jax_runs(started):
    from autodist_tpu import AllReduce, AutoDist, Parallax, PartitionedPS, PS
    from autodist_tpu.strategy.parallel_builders import ExpertParallel
    from tests.unit.test_end_to_end import make_trainable
    from tests.unit.test_sparse import make_trainable as sparse_trainable

    spec = {"topology": {"num_devices": 4}, "mesh": DCN}
    out = {}
    for label, builder in (("AllReduce", AllReduce), ("PS", PS),
                           ("PartitionedPS", PartitionedPS)):
        runner = AutoDist(spec, builder()).build(make_trainable())
        out[label] = {"repl_axes": runner.lowered.plan.repl_axes,
                      "manifest": runner.lowered.state_manifest(
                          runner.state)}
        for s in range(STEPS):
            runner.step(linear_batch(s))
        out[label]["params"] = _jflat(runner.get_params())
    runner = AutoDist(spec, Parallax()).build(sparse_trainable(
        optax.adam(1e-2)))
    for s in range(2):
        runner.step(sparse_batch(s))
    out["Parallax"] = _jflat(runner.get_params())
    for label, (mspec, kw) in MOE_CASES.items():
        runner = AutoDist(mspec, ExpertParallel(
            num_experts=4, capacity_factor=4.0, **kw)).build(
            _jax_moe_trainable())
        ms = [runner.step(b) for b in moe_batches()]
        out[label] = {"loss": [float(np.asarray(m["loss"])) for m in ms],
                      "params": _jflat(runner.get_params()),
                      "strategy": runner.strategy.to_json()}
        runner.close()
    return out


@pytest.fixture(scope="module")
def four(started, jax_runs):
    return started[0]()


@pytest.fixture(scope="module")
def eight(started):
    return started[1]()


def _close(got: dict, want: dict, tol):
    assert set(got) == set(want)
    for name, value in got.items():
        np.testing.assert_allclose(np.asarray(value), want[name], **tol,
                                   err_msg=name)


@pytest.mark.parametrize("label", ["AllReduce", "PS", "PartitionedPS"])
def test_multislice_matches_jax(four, jax_runs, label):
    got, want = four[label], jax_runs[label]
    assert tuple(got["repl_axes"]) == want["repl_axes"] == ("dcn", "data")
    assert got["num_replicas"] == 4 and got["batch_axis"] == "dcn+data"
    _close(got["params"], want["params"], TOL)


@pytest.mark.parametrize("label", ["AllReduce", "PS", "PartitionedPS"])
def test_multislice_manifest_matches_jax(four, jax_runs, label):
    """The collective family's manifest over ``dcn x data``: each leaf's
    global stored shape and recipe are the JAX package's; a sharded one
    splits over the joint replica axis."""
    mine, want = four[label]["manifest"], jax_runs[label]["manifest"]
    assert mine["family"] == want["family"] == "collective"
    for name, rec in mine["leaves"].items():
        if name.startswith("opt_state/"):
            continue       # optax's chain paths; test_torch_elastic.py
        assert {k: v for k, v in rec.items() if k != "split"} \
            == want["leaves"][name], name
    if label == "PartitionedPS":      # its params are stored sharded
        splits = [r["split"] for r in mine["leaves"].values() if r["split"]]
        assert splits and all(s["axis"] == "dcn+data" and s["ranks"] == 4
                              for s in splits)


def test_multislice_sparse_embedding(four, jax_runs):
    assert four["sparse_lookup"]
    _close(four["Parallax"], jax_runs["Parallax"], TOL)


def test_num_slices_topology_shorthand(four):
    assert four["shorthand_mesh"] == {"dcn": 2, "data": 2}
    assert np.isfinite(four["shorthand_loss"])
    spec = port.ResourceSpec({"topology": {"num_devices": 8,
                                           "num_slices": 2}})
    assert spec.resolved_mesh_shape() == {"dcn": 2, "data": 4}
    assert spec.three_d() == (8, 1, 1)
    with pytest.raises(ValueError, match="slices"):
        port.ResourceSpec({"topology": {"num_devices": 8, "num_slices": 3}}
                          ).resolved_mesh_shape()


def test_loader_splits_over_the_replica_group(four):
    """Rank 0 of ``dcn x data`` keeps the first quarter of a global
    batch."""
    assert four["replica_index"] == 0
    np.testing.assert_array_equal(four["loader_x"].numpy(),
                                  linear_batch(0)["x"][:4])


@pytest.mark.parametrize("label", list(MOE_CASES))
def test_expert_parallel_over_slices_matches_jax(four, jax_runs, label):
    got, want = four[label], jax_runs[label]
    np.testing.assert_allclose(got["loss"], want["loss"], **MOE_TOL)
    _close(got["params"], want["params"], MOE_TOL)
    assert json.loads(got["strategy"])["graph_config"]["parallel"][
        "expert_over_dcn"] == (label == "over_dcn")
    assert json.loads(got["strategy"])["graph_config"]["parallel"] == \
        json.loads(want["strategy"])["graph_config"]["parallel"]


def test_sequence_parallel_syncs_across_dcn(eight):
    """dcn x data x seq against the JAX ``lower_sequence_parallel`` on
    the same mesh and batch (the module docstring says why a data-only
    mean fails this)."""
    from jax.sharding import Mesh

    from autodist_tpu import Trainable
    from autodist_tpu.parallel.sequence import lower_sequence_parallel

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("dcn", "data", "seq"))
    params = {"w": jnp.asarray(np.random.RandomState(0).randn(16, 4),
                               jnp.float32)}

    def loss_fn(p, batch):
        return jnp.mean((batch["x"] @ p["w"] - batch["y"]) ** 2)

    t = Trainable.from_loss_fn(loss_fn, params, optax.sgd(0.2))
    init_fn, step_fn, _ = lower_sequence_parallel(t, mesh)
    state = init_fn(t.params, None)
    b = jax.tree.map(jnp.asarray, seq_batch())
    for _ in range(2):
        state, _ = step_fn(state, b, jax.random.PRNGKey(0))
    np.testing.assert_allclose(eight["w"].numpy(),
                               np.asarray(state["params"]["w"]), **SEQ_TOL)
    # The batch's replica cut spans dcn x data: 4 of the 8 ranks.
    assert len(eight["x_shape"]) == 4


def test_expert_over_dcn_checks_and_lint_match_jax():
    """The refusals raise the JAX package's errors; ADT060 and ADT061
    fire on the same plans in both packages."""
    from autodist_tpu.analysis import lint_plan as jlint
    from autodist_tpu.strategy.ir import Strategy as JStrategy
    from autodist_tpu.strategy.parallel_builders import \
        ExpertParallel as JExpertParallel
    from autodist_tpu_torch.analysis import lint_plan
    from autodist_tpu_torch.models import moe_transformer as tmoe

    for mine, theirs in ((port.ExpertParallel, JExpertParallel),):
        for kw in (dict(expert_over_dcn=True, kernel=("a2a_ring",),
                        collective_precision={"moe_a2a": "int8"}),):
            with pytest.raises(ValueError) as a:
                mine(**kw)
            with pytest.raises(ValueError) as b:
                theirs(**kw)
            assert str(a.value) == str(b.value)
    tr = tmoe.make_moe_lm_trainable(
        tmoe.MoeConfig(**MOE_SIZES, dtype=torch.float32),
        port.optim.adam(1e-2), torch.Generator().manual_seed(0),
        batch_size=8, seq_len=8, device="cpu")
    single = {"topology": {"num_devices": 4},
              "mesh": {"data": 2, "expert": 2}}
    with pytest.raises(ValueError) as a:
        port.ExpertParallel(expert_over_dcn=True).build(
            tr, port.ResourceSpec(single))
    from autodist_tpu.resource import ResourceSpec as JResourceSpec
    with pytest.raises(ValueError) as b:
        JExpertParallel(expert_over_dcn=True).build(
            _jax_moe_trainable(), JResourceSpec(single))
    assert str(a.value) == str(b.value)
    # ADT061 on an expert_over_dcn plan, ADT060 on a variable sharded
    # over dcn (a hand-edited strategy), nothing on the plain plan.
    over = port.ExpertParallel(expert_over_dcn=True).build(
        tr, port.ResourceSpec(MOE_CASES["over_dcn"][0]))
    plain = port.ExpertParallel().build(tr, port.ResourceSpec(single))
    edited = json.loads(plain.to_json())
    edited["node_configs"][0]["partitioner"] = {
        "partition_str": "", "mesh_axis": "dcn", "spec": ["dcn", None]}
    for strategy in (over, plain,
                     port.Strategy.from_json(json.dumps(edited))):
        mine = lint_plan(strategy)
        theirs = jlint(JStrategy.from_json(strategy.to_json()))
        assert mine.codes() == {c for c in theirs.codes()
                                if c in ("ADT060", "ADT061")}
        assert [(d.code, d.where, d.message) for d in mine] == [
            (d.code, d.where, d.message) for d in theirs
            if d.code in ("ADT060", "ADT061")]
    assert lint_plan(over).codes() == {"ADT061"}
    assert lint_plan(port.Strategy.from_json(json.dumps(edited))
                     ).codes() == {"ADT060"}


def test_project_logger_records_reach_caplog(caplog):
    """After ``get_logger()``, a module logger's warning still reaches
    the root handlers (``caplog``), whatever ran first."""
    from autodist_tpu_torch.utils.logging import get_logger

    get_logger()
    with caplog.at_level(logging.WARNING):
        logging.getLogger("autodist_tpu_torch.runner").warning(
            "staleness without a gate")
    assert "staleness without a gate" in caplog.text


# ExpertParallel keywords (the expert family's knobs) and the spec each
# builds on: the same strategy in both packages, or the same refusal.
SLICES = {"topology": {"num_devices": 4, "num_slices": 2},
          "mesh": {"data": 2, "expert": 2}}
ONE_SLICE = {"topology": {"num_devices": 4},
             "mesh": {"data": 2, "expert": 2}}
EXPERT_KNOBS = [
    ({}, SLICES),
    ({"expert_over_dcn": True}, SLICES),
    ({"expert_over_dcn": True}, ONE_SLICE),
    ({"collective_precision": {"moe_a2a": "int8"},
      "kernel": ("a2a_ring",)}, ONE_SLICE),
    ({"collective_precision": {"moe_a2a": "int8"},
      "kernel": ("a2a_ring",)}, SLICES),
    ({"collective_precision": {"moe_a2a": "int8"},
      "kernel": ("a2a_ring",), "expert_over_dcn": True}, SLICES),
    ({"kernel": ("a2a_ring",)}, ONE_SLICE),
    ({"kernel": ("quant_ring",)}, ONE_SLICE),
    ({"collective_precision": {"moe_a2a": "int8"},
      "expert_over_dcn": True}, SLICES),
    ({"collective_precision": "bf16", "zero_stage": 1}, SLICES),
    ({"zero_stage": 3, "expert_over_dcn": True}, SLICES),
    ({"compressor": "bf16_ef"}, ONE_SLICE),
    ({"capacity_factor": 0.0}, ONE_SLICE),
    ({"num_experts": 3}, ONE_SLICE),
]


@pytest.mark.parametrize("kw,spec", EXPERT_KNOBS,
                         ids=[str(i) for i in range(len(EXPERT_KNOBS))])
def test_expert_parallel_knobs_match_jax(kw, spec):
    """``ExpertParallel``'s checks and its strategy, keyword for keyword
    against the JAX builder: the same refusal (``a2a_ring`` across
    slices or without int8, ``expert_over_dcn`` on one slice, a
    non-dividing expert count), or the same ``graph_config`` with
    ``expert_over_dcn`` in its ``parallel`` JSON."""
    from autodist_tpu.resource import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy.parallel_builders import \
        ExpertParallel as JExpertParallel
    from autodist_tpu_torch.models import moe_transformer as tmoe

    def build(make, trainable, resource_spec):
        try:
            return make(**kw).build(trainable, resource_spec), None
        except ValueError as e:
            return None, str(e)

    tr = tmoe.make_moe_lm_trainable(
        tmoe.MoeConfig(**MOE_SIZES, dtype=torch.float32),
        port.optim.adam(1e-2), torch.Generator().manual_seed(0),
        batch_size=8, seq_len=8, device="cpu")
    mine, mine_err = build(port.ExpertParallel, tr, port.ResourceSpec(spec))
    theirs, their_err = build(JExpertParallel, _jax_moe_trainable(),
                              JResourceSpec(spec))
    assert mine_err == their_err
    if theirs is None:
        return
    got = json.loads(mine.to_json())["graph_config"]
    want = json.loads(theirs.to_json())["graph_config"]
    assert got == want
    assert got["parallel"]["expert_over_dcn"] == bool(
        kw.get("expert_over_dcn"))
