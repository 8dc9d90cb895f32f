"""The cross-process pipe schedule: ``Pipeline`` over a pipe axis of 2
(GPipe and interleaved), with tensor parallelism inside the stages and a
data axis beside it, against the JAX package on the CPU.

The tiny config of the JAX package's pipeline goldens (vocabulary 32,
hidden 16, 2 heads, mlp 32, length 8, fp32, no dropout; one layer a
stage, 4 stages at V = 2 and 2 at V = 1) is built by the JAX package;
its weights are carried into the port bit for bit and both sides train
3 SGD steps on the same numpy batches.  The port runs on 2 and 4 gloo
ranks in subprocesses, one module-scoped job per world size, started
before the JAX goldens are computed so that the two run side by side.

Tolerances: losses and final gathered params within 1e-5 for the fp32
programs; the ``quant_ring`` program's those ``test_training_matches_jax``
of ``tests/test_torch_tensor_parallel.py`` gives the int8 programs
(losses 1e-4 relative, params 1e-5 absolute and 1e-4 relative; no int8
level rounds the other way here, so the 2-rank ring's FMA-flip
allowance is not needed).  The schedule helpers and chunk permutations
equal the JAX package's exactly.
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
from autodist_tpu_torch.parallel import pipeline as pp

SIZES = dict(vocab_size=32, hidden_size=16, num_layers=4, num_heads=2,
             mlp_dim=32, max_len=8, dropout_rate=0.0,
             attention_dropout_rate=0.0)
INT8 = {"tp_psum": "int8"}
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
INT8_LOSS = dict(atol=0, rtol=1e-4)
INT8_PARAMS = dict(atol=1e-5, rtol=1e-4)

# name -> (world, mesh, Pipeline keywords)
PIPE2 = {"data": 1, "pipe": 2}
PIPE2_MODEL2 = {"data": 1, "pipe": 2, "model": 2}
CASES = {
    "pipe2_v1_m2": (2, PIPE2, dict(num_microbatches=2, virtual_stages=1)),
    "pipe2_v1_m4": (2, PIPE2, dict(num_microbatches=4, virtual_stages=1)),
    "pipe2_v2_m2": (2, PIPE2, dict(num_microbatches=2, virtual_stages=2)),
    "pipe2_v2_m4": (2, PIPE2, dict(num_microbatches=4, virtual_stages=2)),
    "pipe2_model2_fp32": (4, PIPE2_MODEL2, dict(
        num_microbatches=2, virtual_stages=2, tensor_parallel=2)),
    "pipe2_model2_collective_matmul": (4, PIPE2_MODEL2, dict(
        num_microbatches=2, virtual_stages=2, tensor_parallel=2,
        comm_overlap="matmul", kernel=("collective_matmul",))),
    "pipe2_model2_quant_ring": (4, PIPE2_MODEL2, dict(
        num_microbatches=2, virtual_stages=2, tensor_parallel=2,
        collective_precision=INT8, kernel=("quant_ring",))),
    "data2_pipe2": (4, {"data": 2, "pipe": 2}, dict(
        num_microbatches=2, virtual_stages=2)),
}


def _stages(case):
    _, mesh, kw = CASES[case]
    return mesh["pipe"] * kw["virtual_stages"]


def _batch(seed, batch=8):
    r = np.random.RandomState(seed)
    return {"x": r.randint(0, 32, (batch, 8)).astype(np.int32),
            "y": r.randint(0, 32, (batch, 8)).astype(np.int32)}


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trainable(num_stages):
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    return make_pipeline_lm_trainable(
        TransformerConfig(**SIZES, dtype=jnp.float32), optax.sgd(0.05),
        jax.random.PRNGKey(0), num_stages=num_stages)


def _jax_run(case):
    """Losses, final params and strategy JSON of the JAX package's
    program."""
    from autodist_tpu import AutoDist

    world, mesh, kw = CASES[case]
    spec = {"topology": {"platform": "cpu", "num_devices": world},
            "mesh": mesh}
    runner = AutoDist(spec, "Pipeline", **kw).build(
        _jax_trainable(_stages(case)))
    try:
        losses = [float(np.asarray(runner.step(_batch(i))["loss"]))
                  for i in range(STEPS)]
        return losses, _jflat(runner.get_params()), runner.strategy.to_json()
    finally:
        runner.close()


# --------------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import functools
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models import pipeline_lm
    from autodist_tpu_torch.strategy.parallel_builders import Pipeline
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    res = {}
    for name, (mesh, kw, stages) in job["cases"].items():
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(**job["sizes"], dtype=torch.float32),
            port.optim.sgd(0.05), torch.Generator().manual_seed(0),
            num_stages=stages, device="cpu")
        tr.params = job["params"][stages]
        calls = []
        stage_fn = tr.stage_fn

        @functools.wraps(stage_fn)
        def counted(*a, **k):
            calls.append(1)
            return stage_fn(*a, **k)

        tr.stage_fn = counted
        runner = port.AutoDist({"mesh": mesh}, Pipeline(**kw),
                               device="cpu").build(tr)
        losses = [float(runner.step(b)["loss"]) for b in job["batches"]]
        # Every rank's stage calls, gathered before get_params.
        mine = torch.tensor([len(calls)])
        every = [torch.zeros_like(mine) for _ in range(world)]
        torch.distributed.all_gather(every, mine)
        res[name] = {"losses": losses, "params": runner.get_params(),
                     "strategy": runner.strategy.to_json(),
                     "stage_calls": [int(c) for c in every]}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _start_gloo(world, params, tmp):
    """Start the job of ``world`` ranks over every case of that world;
    returns a function that joins the ranks and loads rank 0's results
    (raising with a failed rank's whole log)."""
    tmp = tmp / f"job{world}"
    tmp.mkdir()
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    cases = {name: (mesh, kw, _stages(name))
             for name, (w, mesh, kw) in CASES.items() if w == world}
    torch.save({"cases": cases, "sizes": SIZES, "params": params,
                "batches": [_batch(i) for i in range(STEPS)]}, inp)
    join = testing.launch(_WORKER, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


@pytest.fixture(scope="module")
def jparams():
    """The JAX trainables' weights at 2 and 4 stages."""
    return {s: jax.tree.map(np.asarray, _jax_trainable(s).params)
            for s in (2, 4)}


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """Both gloo jobs, started side by side before the JAX goldens are
    computed; each is joined by the ``port`` fixture."""
    tmp = tmp_path_factory.mktemp("pipe")
    params = {s: port.from_jax_params(p, device="cpu")
              for s, p in jparams.items()}
    return {w: _start_gloo(w, params, tmp) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_runs(started):
    """The JAX package's programs, by case."""
    return {case: _jax_run(case) for case in CASES}


@pytest.fixture(scope="module")
def port_runs(started, jax_runs):
    """The port's programs, by case."""
    runs = {}
    for world in (2, 4):
        runs.update(started[world]())
    return runs


@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax(port_runs, jax_runs, case):
    """Each program's losses and final full params (gathered over the
    pipe and model axes, in logical chunk order) against the JAX
    package's same program."""
    got = port_runs[case]
    jlosses, jfinal, _ = jax_runs[case]
    int8 = case.endswith("quant_ring")
    np.testing.assert_allclose(got["losses"], jlosses,
                               **(INT8_LOSS if int8 else TOL))
    params = dict(flatten_with_names(got["params"]))
    assert set(params) == set(jfinal)
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), jfinal[name], err_msg=name,
                                   **(INT8_PARAMS if int8 else TOL))


@pytest.mark.parametrize("case", list(CASES))
def test_strategy_json_is_the_jax_builders(port_runs, jax_runs, case):
    """The port's strategy at the pipe meshes serializes to the JAX
    builder's JSON byte for byte (ids aside)."""
    text = jax_runs[case][2]
    mine = port_runs[case]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text


@pytest.mark.parametrize("case", list(CASES))
def test_bubble_ticks_run_no_stage(port_runs, case):
    """Every rank runs its stage once per (microbatch, local chunk) a
    step, M·V times, however many ticks the schedule has."""
    _, _, kw = CASES[case]
    per_step = kw["num_microbatches"] * kw["virtual_stages"]
    assert port_runs[case]["stage_calls"] == [per_step * STEPS] * len(
        port_runs[case]["stage_calls"])


def test_layouts_of_one_model_agree(port_runs):
    """The 4-layer model at V = 2, M = 2 on a pipe axis of 2 trains to
    the same losses with its stages cut over a model axis of 2, and with
    its batch split over a data axis of 2."""
    np.testing.assert_allclose(port_runs["pipe2_model2_fp32"]["losses"],
                               port_runs["pipe2_v2_m2"]["losses"], **TOL)
    np.testing.assert_allclose(port_runs["data2_pipe2"]["losses"],
                               port_runs["pipe2_v2_m2"]["losses"], **TOL)


# --------------------------------------------------------------------------- #
# The schedule's host math against the JAX package's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("M", [1, 2, 3, 4])
def test_schedule_matches_jax(n, V, M):
    """``start_tick``, ``num_ticks``, ``bubble_fraction`` and every
    tick's assignment on every device equal the JAX package's."""
    from autodist_tpu.parallel import pipeline as jp

    kw = dict(num_devices=n, virtual_stages=V)
    for m in range(M):
        for c in range(n * V):
            assert pp.start_tick(m, c, **kw) == jp.start_tick(m, c, **kw)
    T = pp.num_ticks(M, n, V)
    assert T == jp.num_ticks(M, n, V)
    assert pp.bubble_fraction(M, n, V) == jp.bubble_fraction(M, n, V)
    seen = set()
    for t in range(T):
        for d in range(n):
            got = pp._tick_assignment(t, d, n=n, V=V, M=M)
            want = jp._tick_assignment(t, d, n=n, V=V, M=M)
            assert got == tuple(int(w) for w in want), (t, d)
            if got[0]:
                seen.add((got[1], got[2] * n + d, t))
    # Each (microbatch, chunk) runs once, at its start tick.
    assert seen == {(m, c, pp.start_tick(m, c, **kw))
                    for m in range(M) for c in range(n * V)}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("V", [1, 2])
def test_chunk_permutations_match_jax(n, V):
    from autodist_tpu.parallel import pipeline as jp

    perm, inv = pp.chunk_permutation(n, V), pp.chunk_permutation_inv(n, V)
    np.testing.assert_array_equal(perm, jp.chunk_permutation(n, V))
    np.testing.assert_array_equal(inv, jp.chunk_permutation_inv(n, V))
    np.testing.assert_array_equal(perm[inv], np.arange(n * V))


def test_pipe_axis_builds():
    """A spec with a pipe axis of 2 is accepted; the other axes of later
    items keep raising under their item names."""
    assert port.ResourceSpec({"mesh": {"pipe": 2}}).mesh_shape == {"pipe": 2}
    with pytest.raises(NotImplementedError, match="item 9"):
        port.ResourceSpec({"mesh": {"pipe": 2, "dcn": 2}})
