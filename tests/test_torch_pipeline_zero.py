"""ZeRO in the port's pipeline lowering against the JAX package on the CPU.

``Pipeline(zero_stage=s)`` for s in 1, 2 and 3 trains the pipelined LM
(vocabulary 33, hidden 16, 2 heads, mlp 32, length 8, fp32, one layer a
stage, 2 stages) on ``{"data": 2, "pipe": 2}`` (4 gloo ranks) and on
``{"data": 2, "pipe": 2, "model": 2}`` (8 gloo ranks) with and without
``vocab_parallel``: the goldens of ``tests/unit/test_parallel_zero.py``
(``test_pipeline_zero_stages_match_reference``, its ``_Z_SPECS``) and of
``tests/unit/test_vocab_parallel.py`` (the vocab table's ZeRO-1, and its
ZeRO-3 request degrading to state sharding).  The JAX trainable's weights
are carried into the port bit for bit, both sides run 3 SGD steps on the
same numpy batches, and the port's ranks run in subprocesses started
before the JAX programs, so that the two run side by side.

Each case checks the losses and the gathered params at their logical
shapes within 1e-5 (absolute and relative: ZeRO reorders exact fp32
sums), the shape each rank stores of every parameter against the JAX
program's per-device shard shape (ZeRO-3's flat rows, the vocab table's
padded model shard), and the ``zero_degraded`` record against the JAX
lowering's.  One more step under Adam holds the optimizer state of every
ZeRO variable to its flat ``1/n`` shard.  The harness is shared with
``tests/test_torch_pipeline_options.py``.
"""
import json
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

SIZES = dict(vocab_size=33, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=8, dropout_rate=0.0,
             attention_dropout_rate=0.0)
STEPS = 3
LR = 0.05
TOL = dict(atol=1e-5, rtol=1e-5)

DP2_PP2 = {"data": 2, "pipe": 2}
DP2_PP2_TP2 = {"data": 2, "pipe": 2, "model": 2}
TP = dict(tensor_parallel=2)
VOCAB = dict(tensor_parallel=2, vocab_parallel=True)
MESHES = {"dp2_pp2": (DP2_PP2, {}), "dp2_pp2_tp2": (DP2_PP2_TP2, TP),
          "dp2_pp2_tp2_vocab": (DP2_PP2_TP2, VOCAB)}

# name -> (mesh, Pipeline keywords, accumulation steps); every case of a
# mesh runs on both sides.
CASES = {f"{key}_zero{s}": (mesh, dict(kw, num_microbatches=2,
                                       zero_stage=s), 1)
         for key, (mesh, kw) in MESHES.items() for s in (1, 2, 3)}


def world_of(mesh) -> int:
    return int(np.prod(list(mesh.values())))


def batch(seed, rows=8):
    r = np.random.RandomState(seed)
    return {"x": r.randint(0, SIZES["vocab_size"], (rows, 8)).astype(
                np.int32),
            "y": r.randint(0, SIZES["vocab_size"], (rows, 8)).astype(
                np.int32)}


def jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_lm(opt):
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    return make_pipeline_lm_trainable(
        TransformerConfig(**SIZES, dtype=jnp.float32), opt,
        jax.random.PRNGKey(0))


def jax_builder(kw, accum):
    from autodist_tpu.strategy.builders import GradAccumulation
    from autodist_tpu.strategy.parallel_builders import Pipeline

    builder = Pipeline(**kw)
    return GradAccumulation(builder, accum) if accum > 1 else builder


def jax_run(mesh, kw, accum=1, trainable=None, batches=None):
    """Losses, final params, each parameter's and each compressor row's
    per-device shard shape, the ``zero_degraded`` record and the
    strategy JSON of the JAX package's program."""
    from autodist_tpu import AutoDist
    from autodist_tpu.capture import path_to_name

    spec = {"topology": {"platform": "cpu", "num_devices": world_of(mesh)},
            "mesh": mesh}
    trainable = trainable or jax_lm(optax.sgd(LR))
    runner = AutoDist(spec, jax_builder(kw, accum)).build(trainable)
    try:
        batches = batches or [batch(i) for i in range(STEPS)]
        losses = [float(np.asarray(runner.step(b)["loss"])) for b in batches]
        shards = {path_to_name(p): tuple(x.sharding.shard_shape(x.shape))
                  for p, x in jax.tree_util.tree_flatten_with_path(
                      runner.state["params"])[0]}
        sync = {path_to_name(p): tuple(x.sharding.shard_shape(x.shape))
                for p, x in jax.tree_util.tree_flatten_with_path(
                    runner.state["sync_state"])[0]}
        return {"losses": losses, "params": jflat(runner.get_params()),
                "shards": shards, "sync": sync,
                "degraded": dict(runner.lowered.zero_degraded or {}),
                "strategy": runner.strategy.to_json()}
    finally:
        runner.close()


# --------------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------------- #
WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel.common import flatten_with_names
    from autodist_tpu_torch.models import pipeline_lm
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    OPTS = {"sgd": lambda: port.optim.sgd(job["lr"]),
            "adam": lambda: port.optim.adam(1e-2)}

    def mlp_stage(chunk, x):
        return torch.relu(x @ chunk["w"] + chunk["b"])

    def mse_head(outputs, batch):
        return ((outputs - batch["y"]) ** 2).mean(), {}

    def trainable(model, opt):
        if model == "mlp":
            params = job["params"]["mlp"]
            return port.capture.PipelineTrainable(
                mlp_stage, params, mse_head, OPTS[opt](),
                num_stages=params["w"].shape[0])
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(**job["sizes"], dtype=torch.float32),
            OPTS[opt](), torch.Generator().manual_seed(0), device="cpu")
        tr.params = job["params"]["lm"]
        return tr

    res = {}
    for name, case in job["cases"].items():
        builder = port.Pipeline(**case["kw"])
        if case["accum"] > 1:
            builder = port.GradAccumulation(builder, case["accum"])
        runner = port.AutoDist({"mesh": case["mesh"]}, builder,
                               device="cpu").build(
            trainable(case["model"], case["opt"]))
        losses = [float(runner.step(b)["loss"])
                  for b in job["batches"][case["model"]]]
        low = runner.lowered
        res[name] = {
            "losses": losses, "params": runner.get_params(),
            "stored": {nm: tuple(t.shape)
                       for nm, t in runner.state["params"].items()},
            "opt_state": {nm: tuple(t.shape) for nm, t in
                          flatten_with_names(runner.state["opt_state"])},
            "sync_state": {nm: tuple(t.shape) for nm, t in
                           runner.state["sync_state"].items()},
            "degraded": dict(low.zero_degraded),
            "unapplied": dict(low.unapplied),
            "zero3_shapes": dict(low.zero3_shapes),
            "strategy": runner.strategy.to_json()}
    torch.save(res, out.replace(".pt", f"{rank}.pt"))
    testing.end_rank()
""")


def start_gloo(cases: dict, params: dict, batches: dict, tmp, world: int):
    """Start ``world`` ranks over ``cases`` (``name -> dict(mesh, kw,
    accum, model, opt)``); returns a function that joins them and
    loads every rank's results, ``[rank][name]`` (raising with a failed
    rank's whole log)."""
    tmp.mkdir()
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    torch.save({"cases": cases, "sizes": SIZES, "lr": LR, "params": params,
                "batches": batches}, inp)
    join = testing.launch(WORKER, world, (inp, out), tmp=tmp, timeout=400)

    def result():
        join()
        return [torch.load(str(tmp / f"res{r}.pt"), weights_only=False)
                for r in range(world)]

    return result


def lm_case(mesh, kw, accum=1, opt="sgd"):
    return {"mesh": mesh, "kw": kw, "accum": accum, "model": "lm",
            "opt": opt}


def assert_matches(got, want, loss_tol=TOL, param_tol=TOL):
    """Losses and the gathered logical params against the JAX run's."""
    np.testing.assert_allclose(got["losses"], want["losses"], **loss_tol)
    params = dict(flatten_with_names(got["params"]))
    assert set(params) == set(want["params"])
    for name, p in params.items():
        assert tuple(p.shape) == want["params"][name].shape, name
        np.testing.assert_allclose(p.numpy(), want["params"][name],
                                   err_msg=name, **param_tol)


# A narrowed wire's rule.  Where every narrowed sum runs over 2 ranks
# it is order-free, so the two packages part only where a value lands on
# the other side of a rounding after an ulp of upstream fp32 difference:
# a few elements, by one wire unit each.  Narrowing itself rounds every
# element, by about 0.29 of a unit in the root mean square.  So each
# tensor's distance from the JAX run (the Frobenius norm of the
# difference) is held within a quarter of a wire unit of the tensor's
# whole update (the norm of final - initial in the JAX run), every loss
# within as much of the loss's fall, and the same mesh's fp32 program
# must fall outside that bound, so that a wire which widens to fp32
# fails, as does a step that leaves the state unchanged (a whole update
# away).  A narrowed sum over n > 2 ranks rounds at each of its n - 1
# additions, in an order each package picks: n - 1 units, and there the
# fp32 program must part from the narrowed one beyond fp32 noise (1e-5
# of some tensor).  On this harness's runs the order-free wires part
# from JAX by at most 0.12 units and their fp32 programs by 0.59 or
# more; the 4-rank sums by at most 1.84 units.
WIRE_UNIT = {"bf16": 2.0 ** -8, "int8": 2.0 / 127}


def wire_units(n: int) -> float:
    """The units of a tensor's update a narrowed program may part from
    the JAX one's when its widest narrowed sum runs over ``n`` ranks."""
    return 0.25 if n <= 2 else n - 1.0


def _norm(x) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64).reshape(-1)))


def _params(run) -> dict:
    return {nm: np.asarray(p) for nm, p in flatten_with_names(run["params"])}


def wire_misses(got, want, init, wire, n):
    """The tensors and losses of ``got`` beyond the wire's bound from
    ``want`` (the JAX run; ``init``, the weights both started from), each
    with its distance and bound.  The fp32 floor: 1e-6 of the tensor's
    norm (or the loss)."""
    unit = wire_units(n) * WIRE_UNIT[wire]
    params, misses = _params(got), {}
    for name, w in want["params"].items():
        bound = unit * _norm(w - init[name]) + 1e-6 * _norm(w) + 1e-9
        dist = _norm(params[name] - w)
        if dist > bound:
            misses[name] = (dist, bound)
    fall = abs(want["losses"][0] - want["losses"][-1])
    for k, (a, b) in enumerate(zip(got["losses"], want["losses"])):
        bound = unit * fall + 1e-6 * abs(b)
        if abs(a - b) > bound:
            misses[f"loss {k}"] = (abs(a - b), bound)
    return misses


def assert_wire_matches(got, want, init, wire, fp32, n=2):
    """``got`` within the wire's bound of the JAX run ``want``, and the
    same mesh's ``fp32`` program outside it (beyond 1e-5 of ``got`` in
    some tensor where a narrowed sum spans ``n`` > 2 ranks)."""
    misses = wire_misses(got, want, init, wire, n)
    assert not misses, misses
    if n <= 2:
        assert wire_misses(fp32, want, init, wire, n), (
            "the fp32 program is as close to the narrowed JAX run: the "
            "wire did not narrow")
    else:
        mine, wide = _params(got), _params(fp32)
        assert any(_norm(mine[nm] - wide[nm]) > 1e-5 * _norm(wide[nm])
                   for nm in wide), "the narrowed program is the fp32 one"


def assert_stored_like_jax(ranks, want):
    """Every rank stores each parameter at the JAX program's per-device
    shard shape."""
    for r, got in enumerate(ranks):
        assert got["stored"] == want["shards"], f"rank {r}"


# --------------------------------------------------------------------------- #
# This file's cases
# --------------------------------------------------------------------------- #
ADAM = {f"{key}_zero{s}_adam": lm_case(mesh, dict(kw, num_microbatches=2,
                                                  zero_stage=s),
                                       opt="adam")
        for key, (mesh, kw) in MESHES.items() for s in (1, 3)}


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, jax_lm(optax.sgd(LR)).params)


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """Both gloo jobs (4 and 8 ranks), started before the JAX programs
    run."""
    tmp = tmp_path_factory.mktemp("pipe_zero")
    params = {"lm": port.from_jax_params(jparams, device="cpu")}
    batches = {"lm": [batch(i) for i in range(STEPS)]}
    jobs = {}
    for world in (4, 8):
        cases = {nm: lm_case(mesh, kw, accum)
                 for nm, (mesh, kw, accum) in CASES.items()
                 if world_of(mesh) == world}
        cases.update({nm: c for nm, c in ADAM.items()
                      if world_of(c["mesh"]) == world})
        jobs[world] = start_gloo(cases, params, batches,
                                 tmp / f"w{world}", world)
    return jobs


@pytest.fixture(scope="module")
def jax_runs(started):
    return {name: jax_run(mesh, kw, accum)
            for name, (mesh, kw, accum) in CASES.items()}


@pytest.fixture(scope="module")
def port_runs(started, jax_runs):
    """``{case: [rank results]}``."""
    runs = {}
    for world in (4, 8):
        ranks = started[world]()
        for name in ranks[0]:
            runs[name] = [r[name] for r in ranks]
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_zero_stages_match_jax(port_runs, jax_runs, case):
    """Losses, gathered params at their logical shapes, each rank's
    stored shapes and the degradation record against the JAX program's
    same strategy (1e-5)."""
    ranks, want = port_runs[case], jax_runs[case]
    for got in ranks:
        assert_matches(got, want)
    assert_stored_like_jax(ranks, want)
    assert ranks[0]["degraded"] == want["degraded"]
    assert ranks[0]["unapplied"] == {}


@pytest.mark.parametrize("case", list(CASES))
def test_strategy_json_is_the_jax_builders(port_runs, jax_runs, case):
    """The ZeRO strategies serialize to the JAX builder's JSON (ids
    aside): PS synchronizers at the requested stage, ``zero_stage`` on
    the graph config."""
    text = jax_runs[case]["strategy"]
    mine = port_runs[case][0]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text


@pytest.mark.parametrize("key", list(MESHES))
def test_stage2_is_stage1(port_runs, key):
    """Stages 1 and 2 run one program (the flat reduce-scatter already
    shards the gradient): the same losses and params bit for bit."""
    a, b = port_runs[f"{key}_zero1"][0], port_runs[f"{key}_zero2"][0]
    assert a["losses"] == b["losses"]
    for (n, x), (_, y) in zip(flatten_with_names(a["params"]),
                              flatten_with_names(b["params"])):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("case", list(ADAM))
def test_optimizer_state_is_the_flat_shard(port_runs, case):
    """Under Adam every ZeRO variable's moments are its flat shard: a
    stage variable's over data (``padded / 2`` of its local chunks, or
    ZeRO-3's stored rows), a shared one's over pipe x data (``padded /
    4``), the vocab table's local shard over pipe x data too; a degraded
    variable's moments have its stored shape."""
    from autodist_tpu_torch.kernel.common import padded_flat_size

    ranks = port_runs[case]
    got = ranks[0]
    stage3 = case.split("_zero")[1].startswith("3")
    for nm, stored in got["stored"].items():
        mu = got["opt_state"][f"mu/{nm}"]
        if nm in got["degraded"] and nm != "shared/embedding":
            assert mu == stored, nm
            continue
        n = 2 if nm.startswith("stages/") else 4
        size = int(np.prod(stored))
        if stage3 and nm in got["zero3_shapes"]:
            assert mu == stored, nm
            logical = got["zero3_shapes"][nm]
            if nm.startswith("stages/"):
                chunk = int(np.prod(logical[1:]))
                assert stored == (1, padded_flat_size(chunk, 2) // 2), nm
            else:
                assert stored == (padded_flat_size(
                    int(np.prod(logical)), 4) // 4,), nm
        else:
            assert mu == (padded_flat_size(size, n) // n,), nm
    for r in ranks[1:]:
        assert r["opt_state"] == got["opt_state"]


def test_vocab_table_state_shards_and_its_zero3_degrades(port_runs,
                                                         jax_runs):
    """The vocab-sharded table keeps ZeRO-1 (its optimizer state shards
    over pipe x data within its model coordinate, its parameter stays
    the ``[17, 16]`` model shard), and its ZeRO-3 request degrades to
    that form with the JAX lowering's record; the model-sharded stage
    variables degrade in both, the replicated shared ones store ZeRO-3
    shards."""
    z1 = port_runs["dp2_pp2_tp2_vocab_zero1"][0]
    z3 = port_runs["dp2_pp2_tp2_vocab_zero3"][0]
    assert "shared/embedding" not in z1["degraded"]
    assert any(k.startswith("stages/") for k in z1["degraded"])
    assert z1["stored"]["shared/embedding"] == (17, 16)
    assert "shared/embedding" in z3["degraded"]
    assert z3["degraded"] == jax_runs["dp2_pp2_tp2_vocab_zero3"]["degraded"]
    assert z3["stored"]["shared/embedding"] == (17, 16)
    assert z3["stored"]["shared/ln_final_scale"] == (4,)
    assert "shared/embedding" not in z3["zero3_shapes"]
