"""``comm_overlap="rsag"`` and narrowed precisions under overlap in the
port against the JAX package on the CPU.

(a) ``psum_decomposed`` at fp32, bf16 and int8 on 2 and 4 gloo ranks
against the JAX function under ``shard_map`` over as many simulated
devices, on a payload of 15 values a rank (padded to divide the axis);
(b) a column-parallel then row-parallel pair under ``"rsag"`` at model
2: the loss and the input and kernel gradients against JAX's;
(c) ``Pipeline(tensor_parallel=2, vocab_parallel=True)`` training under
``"rsag"`` at fp32 and with ``tp_psum`` int8 beside ``vocab_stats``
bf16, and under ``"matmul"`` with ``tp_psum`` int8 and the fused
``collective_matmul`` kernel elected, at model 2, and ``"rsag"`` at
pipe 2 x model 2, against the JAX ``Pipeline`` runner (the tiny config
of the JAX package's vocab-parallel goldens, vocab 33, 2 layers, 3 SGD
steps on the same numpy batches).  One gloo job a world size runs every
check of that size, started before the JAX goldens are computed.

Tolerances: the fp32 pair within 1e-6 (relative and absolute); a
narrowed pair within one wire unit of its inputs (int8: the rs half's
shared level ``max|x| / 127`` plus the ag half's ``max|sum| / 127``;
bf16: ``2^-8`` of the summed magnitudes, twice, as each half rounds
once); the grads 1e-5 relative and 1e-6 absolute; training losses and
gathered params 1e-5 relative and 1e-6 absolute at fp32.  The int8
programs' losses are held at 1e-4 relative; their params' largest gap to
JAX's same program must stay below a quarter of what the int8 wire moves
JAX's params from its fp32 program (an int8 level that rounds the other
way, after float arithmetic XLA fuses differently, moves a few params:
the ``"rsag"`` program with ``tp_psum`` int8 and ``vocab_stats`` bf16
sits ~2e-5 from JAX's against the wire's ~2e-3; with ``tp_psum`` alone
at int8, ~2.5e-4 against ~1.6e-3).  The
tp-2 serving engine under ``"rsag"`` is held to the JAX engine token for
token in ``tests/test_torch_tp_serving.py``.
"""
import json
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import autodist_tpu._jax_compat  # noqa: F401  (jax.shard_map on 0.4.x)
import autodist_tpu_torch as port
from autodist_tpu_torch import testing
from autodist_tpu_torch.kernel.common import flatten_with_names

V = 33
SIZES = dict(vocab_size=V, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=8, dropout_rate=0.0,
             attention_dropout_rate=0.0)
STEPS = 3
TOL = dict(atol=1e-6, rtol=1e-5)
INT8_LOSS = dict(atol=0, rtol=1e-4)
PRECISIONS = ("fp32", "bf16", "int8")
MODEL2 = {"data": 1, "pipe": 1, "model": 2}
PIPE2_MODEL2 = {"data": 1, "pipe": 2, "model": 2}
PROGRAMS = {
    "rsag": dict(comm_overlap="rsag"),
    "rsag_int8": dict(comm_overlap="rsag", collective_precision={
        "tp_psum": "int8", "vocab_stats": "bf16"}),
    "matmul_int8": dict(comm_overlap="matmul",
                        collective_precision={"tp_psum": "int8"},
                        kernel=("collective_matmul",)),
}
# name -> (world, mesh, program)
CASES = {f"model2_{p}": (2, MODEL2, p) for p in PROGRAMS}
CASES["pipe2_model2_rsag"] = (4, PIPE2_MODEL2, "rsag")


def _pipe_kw(mesh, program):
    return dict(num_microbatches=2, virtual_stages=2 // mesh["pipe"],
                tensor_parallel=2, vocab_parallel=True, **PROGRAMS[program])


def _batch(seed, batch=8):
    r = np.random.RandomState(seed)
    return {"x": r.randint(0, V, (batch, 8)).astype(np.int32),
            "y": r.randint(0, V, (batch, 8)).astype(np.int32)}


def _psum_inputs(n):
    """One ``[3, 5]`` payload a rank (15 values: padded at 2 and 4)."""
    return np.random.RandomState(10 + n).randn(n, 3, 5).astype(np.float32)


def _mlp_inputs():
    r = np.random.RandomState(4)
    return (r.randn(2, 3, 8).astype(np.float32),
            (r.randn(8, 12) * 0.3).astype(np.float32),
            (r.randn(12, 8) * 0.3).astype(np.float32))


def _wire_unit(x, prec):
    """One wire unit of the decomposed sum of ``x [n, ...]``."""
    total = np.abs(x).sum(0).max()
    if prec == "int8":
        return np.abs(x).max() / 127 + np.abs(x.sum(0)).max() / 127
    return 2 * 2.0 ** -8 * total


# --------------------------------------------------------------------------- #
# The JAX package's functions under shard_map
# --------------------------------------------------------------------------- #
def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("model",))


def _jax_psum(n, prec):
    from autodist_tpu.parallel.tensor import psum_decomposed

    out = jax.shard_map(
        lambda x: psum_decomposed(x[0], "model", prec)[None],
        mesh=_jax_mesh(n), in_specs=P("model"), out_specs=P("model"),
        check_vma=False)(jnp.asarray(_psum_inputs(n)))
    return np.asarray(out)


def _jax_mlp():
    from autodist_tpu.parallel.tensor import column_parallel, row_parallel

    x, w1, w2 = _mlp_inputs()

    def local(x, w1, w2):
        def loss(x, w1, w2):
            h = jax.nn.gelu(column_parallel(x, w1, model_axis="model",
                                            comm_overlap="rsag"))
            y = row_parallel(h, w2, model_axis="model", comm_overlap="rsag")
            return jnp.sum(y ** 2)
        val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(x, w1, w2)
        return (val, *grads)

    out = jax.shard_map(
        local, mesh=_jax_mesh(2), in_specs=(P(), P(None, "model"),
                                            P("model", None)),
        out_specs=(P(), P(), P(None, "model"), P("model", None)),
        check_vma=False)(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    return [np.asarray(o) for o in out]


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trainable():
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    return make_pipeline_lm_trainable(
        TransformerConfig(**SIZES, dtype=jnp.float32), optax.sgd(0.05),
        jax.random.PRNGKey(0))


def _jax_run(case):
    """Losses, final params and strategy JSON of the JAX program."""
    from autodist_tpu import AutoDist

    _, mesh, program = CASES[case]
    spec = {"topology": {"platform": "cpu",
                         "num_devices": int(np.prod(list(mesh.values())))},
            "mesh": mesh}
    runner = AutoDist(spec, "Pipeline", **_pipe_kw(mesh, program)).build(
        _jax_trainable())
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
    import sys
    import torch
    import torch.nn.functional as F
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.models import pipeline_lm
    from autodist_tpu_torch.parallel import tensor
    from autodist_tpu_torch.resource import ResourceSpec
    from autodist_tpu_torch.strategy.parallel_builders import Pipeline
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    res = {}
    model = ResourceSpec({"mesh": {"model": world}}).make_mesh().axis(
        "model")
    for prec in job["precisions"]:
        res[("psum", prec)] = tensor.psum_decomposed(
            job["psum"][rank], model, prec)
    if "mlp" in job:
        x, w1, w2 = job["mlp"]
        x = x.clone().requires_grad_()
        w1 = w1.chunk(2, dim=1)[rank].clone().requires_grad_()
        w2 = w2.chunk(2, dim=0)[rank].clone().requires_grad_()
        h = F.gelu(tensor.column_parallel(x, w1, model_axis=model,
                                          comm_overlap="rsag"),
                   approximate="tanh")
        y = tensor.row_parallel(h, w2, model_axis=model, comm_overlap="rsag")
        val = (y ** 2).sum()
        val.backward()
        res["mlp"] = (val.detach(), x.grad, model.all_gather(w1.grad, dim=1),
                      model.all_gather(w2.grad, dim=0))
    for name, (mesh, kw) in job["cases"].items():
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(**job["sizes"], dtype=torch.float32),
            port.optim.sgd(0.05), torch.Generator().manual_seed(0),
            device="cpu")
        tr.params = job["params"]
        runner = port.AutoDist({"mesh": mesh}, Pipeline(**kw),
                               device="cpu").build(tr)
        losses = [float(runner.step(b)["loss"]) for b in job["batches"]]
        res[name] = {"losses": losses, "params": runner.get_params(),
                     "strategy": runner.strategy.to_json()}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _start_gloo(world, params, tmp):
    """Start the job of ``world`` ranks; returns a function that joins
    the ranks and loads rank 0's results."""
    tmp = tmp / f"job{world}"
    tmp.mkdir()
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    job = {"cases": {name: (mesh, _pipe_kw(mesh, program))
                     for name, (w, mesh, program) in CASES.items()
                     if w == world},
           "sizes": SIZES, "params": params, "precisions": PRECISIONS,
           "psum": torch.as_tensor(_psum_inputs(world)),
           "batches": [_batch(i) for i in range(STEPS)]}
    if world == 2:
        job["mlp"] = tuple(torch.as_tensor(a) for a in _mlp_inputs())
    torch.save(job, inp)
    join = testing.launch(_WORKER, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both gloo jobs, started before the JAX goldens are computed."""
    tmp = tmp_path_factory.mktemp("overlap")
    params = port.from_jax_params(
        jax.tree.map(np.asarray, _jax_trainable().params), device="cpu")
    return {w: _start_gloo(w, params, tmp) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_runs(started):
    return {case: _jax_run(case) for case in CASES}


@pytest.fixture(scope="module")
def ranks(started, jax_runs):
    """Every check's result from rank 0 of its job, by world size."""
    return {world: started[world]() for world in (2, 4)}


# --------------------------------------------------------------------------- #
# (a), (b): the decomposed pair and the boundaries
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("prec", PRECISIONS)
def test_psum_decomposed_matches_jax(ranks, world, prec):
    """The pair's sum on rank 0 against JAX's on device 0: fp32 within
    1e-6, a narrowed wire within one wire unit; and the fp32 pair is
    the plain sum."""
    x = _psum_inputs(world)
    got = ranks[world][("psum", prec)].numpy()
    want = _jax_psum(world, prec)[0]
    assert got.shape == want.shape == (3, 5)
    if prec == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, x.sum(0), rtol=1e-6, atol=1e-6)
    else:
        unit = _wire_unit(x, prec)
        gap = float(np.abs(got - want).max())
        print(f"{prec} at {world} ranks: |port - JAX| {gap:.3g}, one wire "
              f"unit {unit:.3g}, |port - sum| "
              f"{float(np.abs(got - x.sum(0)).max()):.3g}")
        assert gap <= unit
        assert float(np.abs(got - x.sum(0)).max()) <= 2 * unit


def test_column_row_rsag_grads_match_jax(ranks):
    """A column-parallel then row-parallel pair under ``"rsag"`` at
    model 2: the loss, the input's gradient and both kernels' gathered
    gradients against the JAX pair's."""
    val, dx, dw1, dw2 = ranks[2]["mlp"]
    jval, jdx, jdw1, jdw2 = _jax_mlp()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    for got, want in ((dx, jdx), (dw1, jdw1), (dw2, jdw2)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
# (c): Pipeline training under overlap
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax(ranks, jax_runs, case):
    """Losses and the gathered params against the JAX program of the
    same mesh, overlap mode and precisions."""
    world, _, program = CASES[case]
    got = ranks[world][case]
    jlosses, jfinal, _ = jax_runs[case]
    int8 = program.endswith("int8")
    np.testing.assert_allclose(got["losses"], jlosses,
                               **(INT8_LOSS if int8 else TOL))
    params = dict(flatten_with_names(got["params"]))
    assert set(params) == set(jfinal)
    if not int8:
        for name, p in params.items():
            np.testing.assert_allclose(p.numpy(), jfinal[name], err_msg=name,
                                       **TOL)
        return
    # An int8 level that rounds the other way moves the program: the
    # gap to JAX's program is held to a quarter of what the int8 wire
    # itself moves JAX's params from its fp32 program of the mesh.
    fp32 = jax_runs["model2_rsag"][1]
    gap = max(float(np.abs(p.numpy() - jfinal[nm]).max())
              for nm, p in params.items())
    wire = max(float(np.abs(jfinal[nm] - fp32[nm]).max()) for nm in fp32)
    print(f"{case}: params {gap:.3g} from JAX's; JAX's int8 wire moves "
          f"its params {wire:.3g} from fp32")
    assert gap < 0.25 * wire


@pytest.mark.parametrize("case", list(CASES))
def test_strategy_json_is_the_jax_builders(ranks, jax_runs, case):
    """The strategy under overlap serializes to the JAX builder's JSON
    byte for byte (ids aside), the mode on the graph config and on each
    Megatron kernel's partitioner."""
    world, _, program = CASES[case]
    text = jax_runs[case][2]
    mine = ranks[world][case]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    doc = json.loads(mine)
    mode = PROGRAMS[program]["comm_overlap"]
    assert doc["graph_config"]["parallel"]["comm_overlap"] == mode
    wo = [nc for nc in doc["node_configs"]
          if nc["var_name"] == "stages/mlp/wo/kernel"][0]
    assert wo["partitioner"]["comm_overlap"] == mode


def test_rsag_equals_the_blocking_program(ranks, jax_runs):
    """The fp32 ``"rsag"`` program trains to the blocking program's
    losses at model 2 and at pipe 2 x model 2 (a different summation
    order only): held to the JAX blocking program of the same mesh."""
    from autodist_tpu import AutoDist

    for case, mesh in (("model2_rsag", MODEL2),
                       ("pipe2_model2_rsag", PIPE2_MODEL2)):
        spec = {"topology": {"platform": "cpu",
                             "num_devices": int(np.prod(list(
                                 mesh.values())))}, "mesh": mesh}
        kw = _pipe_kw(mesh, "rsag")
        kw.pop("comm_overlap")
        runner = AutoDist(spec, "Pipeline", **kw).build(_jax_trainable())
        try:
            blocking = [float(np.asarray(runner.step(_batch(i))["loss"]))
                        for i in range(STEPS)]
        finally:
            runner.close()
        world = CASES[case][0]
        np.testing.assert_allclose(ranks[world][case]["losses"], blocking,
                                   **TOL)
