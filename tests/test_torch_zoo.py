"""The data-parallel strategy zoo on the collective lowering, against the
JAX package on the CPU.

A 2-layer BERT (hidden 64, 2 heads of 32, vocabulary 97, so that a
vocab-split table pads) is built by the JAX package and its weights are
carried into the port (:func:`autodist_tpu_torch.from_jax_params`).
Every entry of the JAX golden list (``tests/unit/test_end_to_end.py``
``STRATEGIES``) trains in fp32 with dropout off on the same numpy
batches (3 SGD steps at 0.1, the golden's optimizer: Adam
would turn the last-bit noise of other summation orders in near-zero
gradients into whole steps): the port on 2 and on 4 gloo ranks, the JAX package
on a data axis of the same size.  The final parameters agree within the
JAX golden's own tolerance (rtol 2e-5, atol 2e-6); ``get_params`` has
the logical, unpadded shapes.  Builders whose JAX plans are equal lower
to one JAX program, run once.  ``GradAccumulation(AllReduce(), k)`` for
k = 2 and 4 is held to the JAX program and to the port's own
full-batch step (1e-6); the optimizers-under-sharded-state goldens
(``test_end_to_end.py`` ``test_optimizers_under_sharded_state``) run on
the linear model with sgd, adam and adamw.  Every builder's strategy
serializes as the JAX builder's, for BERT and for the ``SparseEmbed``
model, at 1, 2 and 4 replicas.  The stored bytes a rank holds show the
``1/n`` sharding of PS (optimizer state) and PartitionedPS (both).
"""
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
from autodist_tpu_torch.models import bert as tbert
from autodist_tpu_torch.strategy import builders as tbuilders

BERT = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
            mlp_dim=128, max_len=16, dropout_rate=0.0,
            attention_dropout_rate=0.0)
B, L, P, STEPS = 16, 16, 4, 3
WORLDS = (2, 4)
TOL = dict(rtol=2e-5, atol=2e-6)
# tests/unit/test_end_to_end.py STRATEGIES: (id, builder name, kwargs).
GOLDEN = [("AllReduce", "AllReduce", {"chunk_size": 2}),
          ("AllReduce-chunk1", "AllReduce", {"chunk_size": 1}),
          ("PS", "PS", {}),
          ("PSLoadBalancing", "PSLoadBalancing", {}),
          ("PartitionedPS", "PartitionedPS", {}),
          ("UnevenPartitionedPS", "UnevenPartitionedPS", {}),
          ("PartitionedAR", "PartitionedAR", {}),
          ("RandomAxisPartitionAR", "RandomAxisPartitionAR", {"seed": 3}),
          ("Parallax", "Parallax", {}),
          ("ZeRO1", "ZeRO", {"stage": 1}),
          ("ZeRO2", "ZeRO", {"stage": 2}),
          ("ZeRO3", "ZeRO", {"stage": 3})]
ACCUM = [(f"GradAccumulation{k}", "GradAccumulation",
          {"builder": "AllReduce", "steps": k}) for k in (2, 4)]
# test_end_to_end.py test_optimizers_under_sharded_state, on the port's
# three optimizers.
OPT_STRATEGIES = ("PS", "PartitionedPS", "PartitionedAR", "AllReduce")
OPTIMIZERS = {"sgd": ("sgd", 0.1), "adam": ("adam", 1e-2),
              "adamw": ("adamw", 1e-2, 0.01)}
LIN_BATCH, LIN_DIM, LIN_OUT = 16, 6, 3


def _jax_opt(spec):
    name, lr, *rest = spec
    if name == "adamw":
        return optax.adamw(lr, weight_decay=rest[0])
    return getattr(optax, name)(lr)


def _bert_batches():
    return [jbatch(s) for s in range(STEPS)]


def jbatch(seed):
    from autodist_tpu.models import bert as jbert

    return jbert.synthetic_mlm_batch(seed, B, L, P, BERT["vocab_size"])


def _lin_params():
    r = np.random.RandomState(0)
    return {"dense": {"w": r.randn(LIN_DIM, LIN_OUT).astype(np.float32),
                      "b": np.zeros(LIN_OUT, np.float32)},
            "scale": np.ones((), np.float32)}


def _lin_batches():
    out = []
    for s in range(2):
        r = np.random.RandomState(s)
        out.append({"x": r.randn(LIN_BATCH, LIN_DIM).astype(np.float32),
                    "y": r.randn(LIN_BATCH, LIN_OUT).astype(np.float32)})
    return out


def _jax_bert(optimizer=None):
    from autodist_tpu.models import bert as jbert
    from autodist_tpu.models.transformer import TransformerConfig

    return jbert.make_mlm_trainable(
        TransformerConfig(**BERT, dtype=jnp.float32),
        optimizer or optax.sgd(0.1),
        jax.random.PRNGKey(0), batch_size=2, seq_len=L, num_masked=P)


def _jax_lin(optimizer):
    from autodist_tpu import Trainable

    def loss_fn(p, batch):
        pred = batch["x"] @ p["dense"]["w"] + p["dense"]["b"]
        return jnp.mean((pred * p["scale"] - batch["y"]) ** 2)

    return Trainable.from_loss_fn(
        loss_fn, jax.tree.map(jnp.asarray, _lin_params()), optimizer)


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(
                jax.device_get(tree))[0]}


def _jspec(n):
    from autodist_tpu.resource import ResourceSpec

    return ResourceSpec({"topology": {"platform": "cpu", "num_devices": n}})


def _jax_builder(name, kw):
    from autodist_tpu.strategy import builders as jbuilders

    return jbuilders.create(name, **kw)


def _plan_key(lowered):
    """What decides the JAX program: every variable's plan."""
    return tuple((vp.name, vp.stored_sharded, vp.split_axis, vp.update,
                  vp.bucket, vp.compressor, vp.sparse_lookup)
                 for vp in lowered.plan.var_plans.values())


def _jax_run(trainable, builder, n, batches):
    from autodist_tpu import AutoDist

    runner = AutoDist(_jspec(n), builder).build(trainable)
    losses = [float(np.asarray(runner.step(b)["loss"])) for b in batches]
    return runner, losses, _jflat(runner.get_params())


# --------------------------------------------------------------------------- #
# The gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel.common import flatten_with_names
    from autodist_tpu_torch.models import bert
    from autodist_tpu_torch.strategy import builders
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)

    def optimizer(spec):
        name, lr, *rest = spec
        if name == "adamw":
            return port.optim.adamw(lr, weight_decay=rest[0])
        return getattr(port.optim, name)(lr)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for _, t in flatten_with_names(tree)
                   if isinstance(t, torch.Tensor))

    def bert_trainable(opt=job["bert_opt"]):
        cfg = port.TransformerConfig(**job["bert"], dtype=torch.float32)
        tr = bert.make_mlm_trainable(cfg, optimizer(opt),
                                     torch.Generator(), device="cpu")
        tr.params = job["bert_params"]
        return tr

    def lin_trainable(opt):
        def loss_fn(p, b):
            pred = b["x"] @ p["dense"]["w"] + p["dense"]["b"]
            return ((pred * p["scale"] - b["y"]) ** 2).mean()
        params = {"dense": {k: torch.as_tensor(v) for k, v in
                            job["lin_params"]["dense"].items()},
                  "scale": torch.as_tensor(job["lin_params"]["scale"])}
        return port.Trainable.from_loss_fn(loss_fn, params, opt)

    res = {}
    for case, name, kw in job["bert_cases"]:
        runner = port.AutoDist({}, builders.create(name, **kw),
                               device="cpu").build(bert_trainable())
        losses = [float(runner.step(b)["loss"]) for b in job["bert_batches"]]
        res[case] = {"losses": losses, "params": runner.get_params()}
    for name in job["bytes_cases"]:
        runner = port.AutoDist({}, name, device="cpu").build(
            bert_trainable(("adam", 1e-3)))
        runner.step(job["bert_batches"][0])
        plans = runner.lowered.plan.var_plans.values()
        res[f"bytes-{name}"] = {
            "params": nbytes(runner.state["params"]),
            "opt": nbytes(runner.state["opt_state"]),
            # fp32 parameters; Adam's mu and nu, and its int32 count
            "want_params": 4 * sum(int(np.prod(vp.stored_shape(world)))
                                   for vp in plans),
            "want_opt": 4 + 8 * sum(int(np.prod(
                vp.local_update_shape(world))) for vp in plans)}
    for case, name, opt in job["lin_cases"]:
        runner = port.AutoDist({}, name, device="cpu").build(
            lin_trainable(optimizer(opt)))
        for b in job["lin_batches"]:
            runner.step(b)
        res[case] = {"params": runner.get_params()}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, _jax_bert().params)


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """The 2- and 4-rank gloo jobs, started before the JAX runs so that
    they run side by side."""
    tmp = tmp_path_factory.mktemp("zoo")
    inp = tmp / "job.pt"
    torch.save({
        "bert": BERT, "bert_opt": ("sgd", 0.1),
        "bert_params": port.from_jax_params(jparams, device="cpu"),
        "bert_batches": _bert_batches(), "bert_cases": GOLDEN + ACCUM,
        "bytes_cases": ("AllReduce", "PS", "PartitionedPS"),
        "lin_params": _lin_params(), "lin_batches": _lin_batches(),
        "lin_cases": [(f"{s}-{o}", s, OPTIMIZERS[o])
                      for s in OPT_STRATEGIES for o in OPTIMIZERS]}, inp)
    joins = {w: testing.launch(_WORKER, w, (inp, tmp / f"out{w}.pt"),
                               tmp=tmp / f"w{w}", timeout=400)
             for w in WORLDS}

    def result(world):
        joins[world]()
        return torch.load(tmp / f"out{world}.pt", weights_only=False)

    return result


@pytest.fixture(scope="module")
def jax_runs(started):
    """Each distinct JAX plan of the golden list and the accumulation
    cases, run once a data-axis size; the linear optimizer goldens."""
    from autodist_tpu.strategy import builders as jbuilders

    out, batches = {}, _bert_batches()
    for n in WORLDS:
        by_plan = {}
        for case, name, kw in GOLDEN + ACCUM:
            tr = _jax_bert()
            builder = _jax_builder(name, kw)
            from autodist_tpu import AutoDist

            key = (_plan_key(AutoDist(_jspec(n), builder).lower(tr)),
                   getattr(builder, "steps", 1))
            if key not in by_plan:
                by_plan[key] = _jax_run(tr, builder, n, batches)[1:]
            out[(n, case)] = by_plan[key]
        for s in OPT_STRATEGIES:
            for o, spec in OPTIMIZERS.items():
                tr = _jax_lin(_jax_opt(spec))
                out[(n, f"{s}-{o}")] = _jax_run(
                    tr, jbuilders.create(s), n, _lin_batches())[2]
    return out


@pytest.fixture(scope="module")
def port_runs(started, jax_runs):
    return {w: started(w) for w in WORLDS}


def _assert_params(got, want, **tol):
    got = {n: t.numpy() for n, t in flatten_with_names(got)}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                   **tol)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c for c, _, _ in GOLDEN])
def test_golden_builder_matches_jax(case, world, port_runs, jax_runs):
    """Each golden builder: 3 SGD steps on ``world`` gloo ranks end at
    the JAX runner's parameters on a data axis of ``world``, at their
    logical shapes, with the JAX losses."""
    res = port_runs[world][case]
    losses, want = jax_runs[(world, case)]
    _assert_params(res["params"], want, **TOL)
    np.testing.assert_allclose(res["losses"], losses, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("steps", [2, 4])
def test_accumulation_matches_jax_and_the_full_batch(steps, world,
                                                     port_runs, jax_runs):
    """``GradAccumulation(AllReduce(), steps)`` ends at the JAX
    program's parameters and, within 1e-6, at the port's own full-batch
    ``AllReduce`` run (the mean of equal microbatch means is the
    full-batch mean)."""
    res = port_runs[world][f"GradAccumulation{steps}"]
    _assert_params(res["params"],
                   jax_runs[(world, f"GradAccumulation{steps}")][1], **TOL)
    full = {n: t.numpy() for n, t in
            flatten_with_names(port_runs[world]["AllReduce"]["params"])}
    _assert_params(res["params"], full, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("opt", list(OPTIMIZERS))
@pytest.mark.parametrize("strategy", OPT_STRATEGIES)
def test_optimizers_under_sharded_state(strategy, opt, world, port_runs,
                                        jax_runs):
    """The optimizer's state shards with each update space (flat PS,
    stored-sharded PartitionedPS, reduce-scattered PartitionedAR) and
    trains as the JAX runner does (the JAX golden's rtol 2e-4, atol
    1e-5)."""
    _assert_params(port_runs[world][f"{strategy}-{opt}"]["params"],
                   jax_runs[(world, f"{strategy}-{opt}")],
                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_stored_bytes_shard_by_the_data_axis(world, port_runs):
    """Per rank, PS holds the whole parameters and ``1/n`` of Adam's
    state; PartitionedPS ``1/n`` of both.  Each is exactly its plan's
    padded shards; at this size PartitionedPS pads the 2- and 3-row
    tensors it splits over 4 ranks, hence its looser bound."""
    runs = port_runs[world]
    ar, ps, pps = (runs[f"bytes-{name}"]
                   for name in ("AllReduce", "PS", "PartitionedPS"))
    for res in (ar, ps, pps):
        assert (res["params"], res["opt"]) == (res["want_params"],
                                               res["want_opt"])
    assert ps["params"] == ar["params"]
    assert ar["opt"] / world <= ps["opt"] <= ar["opt"] / world * 1.01
    for key in ("params", "opt"):
        assert ar[key] / world <= pps[key] <= ar[key] / world * 1.15


# --------------------------------------------------------------------------- #
# Strategies serialize as the JAX builders'
# --------------------------------------------------------------------------- #
class _Spec:
    """A resource spec of ``n`` replicas, without a process group."""

    def __init__(self, n):
        self.n = n

    def resolved_mesh_shape(self):
        return {"data": self.n}


def _port_sparse_model():
    from autodist_tpu_torch.models.embedding import SparseEmbed

    gen = torch.Generator().manual_seed(0)
    model = torch.nn.ModuleDict({"embed": SparseEmbed(9000, 8, gen),
                                 "out": torch.nn.Linear(8, 1)})
    params = {"embed": {"embedding": model["embed"].embedding.detach()},
              "out": {"kernel": model["out"].weight.detach().T,
                      "bias": model["out"].bias.detach()}}
    return port.Trainable(lambda *a: None, params, port.optim.sgd(0.1))


def _jax_sparse_model():
    import flax.linen as nn

    from autodist_tpu import Trainable
    from autodist_tpu.models.embedding import SparseEmbed

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, ids):
            x = SparseEmbed(9000, 8, name="embed")(ids).mean(axis=1)
            return nn.Dense(1, name="out")(x)[:, 0]

    params = Tiny().init(jax.random.PRNGKey(0),
                         jnp.zeros((2, 4), jnp.int32))["params"]
    return Trainable.from_loss_fn(lambda p, b: 0.0, params, optax.sgd(0.1))


ZOO = GOLDEN + ACCUM + [
    ("AllReduce-bf16_ef", "AllReduce", {"compressor": "bf16_ef"}),
    ("PartitionedAR-int8_ef", "PartitionedAR", {"compressor": "int8_ef"}),
    ("Parallax-powersgd", "Parallax", {"chunk_size": 3,
                                       "compressor": "powersgd:2"}),
    ("PartitionedPS-axis1", "PartitionedPS", {"split_axis": 1}),
    ("GradAccumulation-default", "GradAccumulation", {"steps": 2})]


@pytest.fixture(scope="module")
def bert_pair(jparams):
    ttr = tbert.make_mlm_trainable(
        port.TransformerConfig(**BERT, dtype=torch.float32),
        port.optim.sgd(0.1), torch.Generator(), device="cpu")
    return _jax_bert(), ttr


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("model", ["bert", "sparse_embed"])
@pytest.mark.parametrize("case", [c for c, _, _ in ZOO])
def test_strategy_serializes_as_jax(case, model, n, bert_pair):
    """Node configs (synchronizers, groups, reduction destinations,
    partitioners, random axes, sparsity) and the graph config equal the
    JAX builder's, key for key."""
    name, kw = {c: (nm, k) for c, nm, k in ZOO}[case]
    jtr, ttr = (bert_pair if model == "bert"
                else (_jax_sparse_model(), _port_sparse_model()))
    want = _jax_builder(name, kw).build(jtr, _jspec(n))
    got = tbuilders.create(name, **kw).build(ttr, _Spec(n))
    assert [nc.to_dict() for nc in got.node_configs] == \
        [nc.to_dict() for nc in want.node_configs]
    assert got.graph_config.to_dict() == want.graph_config.to_dict()
    back = port.Strategy.from_json(want.to_json())
    assert [nc.to_dict() for nc in back.node_configs] == \
        [nc.to_dict() for nc in want.node_configs]


def test_default_builder_is_ps_load_balancing_and_names_take_kwargs():
    """``AutoDist(spec)`` builds ``PSLoadBalancing``; a builder's name
    takes its keyword arguments, as in the JAX package."""
    assert isinstance(port.AutoDist({}).strategy_builder,
                      tbuilders.PSLoadBalancing)
    ad = port.AutoDist({}, "AllReduce", chunk_size=3, compressor="fp16")
    assert (ad.strategy_builder.chunk_size,
            ad.strategy_builder.compressor) == (3, "fp16")
    acc = tbuilders.create("GradAccumulation", builder="PartitionedPS",
                           steps=3)
    assert isinstance(acc.builder, tbuilders.PartitionedPS)
    with pytest.raises(ValueError, match="ZeRO stage"):
        tbuilders.ZeRO(stage=4)
    with pytest.raises(ValueError, match="unknown compressor"):
        port.AutoDist({}, port.AllReduce(compressor="int4"),
                      device="cpu").build(tbert.make_mlm_trainable(
                          port.TransformerConfig(**BERT,
                                                 dtype=torch.float32),
                          port.optim.sgd(0.1), torch.Generator(),
                          device="cpu"))
