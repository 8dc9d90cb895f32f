"""Megatron tensor-parallel training of the pipelined LM through
``Pipeline(tensor_parallel=t)`` at one pipe device, against the JAX
package on the CPU.

The tiny config of the JAX package's kernel goldens (vocabulary 32,
hidden 16, 2 layers, 2 heads, mlp 32, length 8, fp32, no dropout) is
built by the JAX package; its weights are carried into the port bit for
bit and both sides train 3 SGD steps on the same numpy batches.  The
port runs on 2 (and 4) gloo ranks in subprocesses, started before the
JAX goldens are computed so that the two run side by side.  Tolerances:
fp32 programs 1e-5 (the same arithmetic in other summation orders), the
int8 programs 1e-4 relative, and the JAX goldens' own relations between
the programs.

One rounding flip is shown and allowed for.  The port's ring hop rounds
``f32(q) * s`` and ``+ local`` separately, as the JAX package's host
mirror of the ring does; under ``jit`` XLA's CPU backend contracts the
Pallas hop's ``q * s + local`` into one FMA.  At 2 ranks one int8 level
of step 2 rounds the other way, which moves the params by up to 3.5e-5
(the losses stay within 1e-5 relative).  The same run with an FMA in
the port's hop (``quant_ring_fma``, the plain hop replaced in the
workers only) matches the JAX program to 1e-5: the gap is that flip.
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
from autodist_tpu_torch import interop, testing
from autodist_tpu_torch.kernel.common import flatten_with_names
from autodist_tpu_torch.models import pipeline_lm as tlm
from autodist_tpu_torch.strategy.parallel_builders import Pipeline

SIZES = dict(vocab_size=32, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=8, dropout_rate=0.0,
             attention_dropout_rate=0.0)
PIPE = dict(num_microbatches=2, virtual_stages=2)
INT8 = {"tp_psum": "int8"}
PROGRAMS = {
    "fp32": {},
    "int8": dict(collective_precision=INT8),
    "quant_ring": dict(collective_precision=INT8, kernel=("quant_ring",)),
    "matmul": dict(comm_overlap="matmul"),
    "collective_matmul": dict(comm_overlap="matmul",
                              kernel=("collective_matmul",)),
}
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
INT8_RTOL = 1e-4


def _batch(seed, batch=8):
    r = np.random.RandomState(seed)
    return {"x": r.randint(0, 32, (batch, 8)).astype(np.int32),
            "y": r.randint(0, 32, (batch, 8)).astype(np.int32)}


def _tcfg():
    return port.TransformerConfig(**SIZES, dtype=torch.float32)


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jparams():
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    tr = make_pipeline_lm_trainable(
        TransformerConfig(**SIZES, dtype=jnp.float32), optax.sgd(0.05),
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, tr.params)


def _jax_trainable():
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    return make_pipeline_lm_trainable(
        TransformerConfig(**SIZES, dtype=jnp.float32), optax.sgd(0.05),
        jax.random.PRNGKey(0))


def _jax_spec(mesh):
    return {"topology": {"platform": "cpu",
                         "num_devices": int(np.prod(list(mesh.values())))},
            "mesh": mesh}


def _jax_run(mesh, program):
    """Losses, final params and strategy JSON of the JAX package's
    program."""
    from autodist_tpu import AutoDist

    runner = AutoDist(_jax_spec(mesh), "Pipeline",
                      tensor_parallel=mesh.get("model", 1), **PIPE,
                      **PROGRAMS[program]).build(_jax_trainable())
    try:
        losses = [float(np.asarray(runner.step(_batch(i))["loss"]))
                  for i in range(STEPS)]
        return losses, _jflat(runner.get_params()), runner.strategy.to_json()
    finally:
        runner.close()


def _port_trainable(jparams, device="cpu"):
    tr = tlm.make_pipeline_lm_trainable(
        _tcfg(), port.optim.sgd(0.05), torch.Generator().manual_seed(0),
        device=device)
    tr.params = port.from_jax_params(jparams, device=device)
    return tr


# --------------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel import quant_ring as qr
    from autodist_tpu_torch.models import pipeline_lm
    from autodist_tpu_torch.strategy.parallel_builders import Pipeline
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    plain_hop = qr.fused_hop_plain

    def fma_hop(q_in, scale_in, local):
        acc = (q_in.double() * scale_in.double() + local.double()).float()
        return qr._quantize_pair(acc)

    res = {}
    for name in job["programs"]:
        qr.fused_hop_plain = fma_hop if name.endswith("_fma") else plain_hop
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(**job["sizes"], dtype=torch.float32),
            port.optim.sgd(0.05), torch.Generator().manual_seed(0),
            device="cpu")
        tr.params = job["params"]
        runner = port.AutoDist({"mesh": job["mesh"]}, Pipeline(
            tensor_parallel=2, **job["pipe"],
            **job["kw"][name.removesuffix("_fma")]),
            device="cpu").build(tr)
        losses = [float(runner.step(b)["loss"]) for b in job["batches"]]
        res[name] = {"losses": losses, "params": runner.get_params(),
                     "strategy": runner.strategy.to_json()}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _start_gloo(world, mesh, programs, params, tmp):
    """Start the job's ranks; returns a function that joins them and
    loads rank 0's results (raising with a failed rank's whole log)."""
    tmp = tmp / f"job{world}"
    tmp.mkdir()
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    torch.save({"programs": programs, "sizes": SIZES, "mesh": mesh,
                "pipe": PIPE, "kw": PROGRAMS, "params": params,
                "batches": [_batch(i) for i in range(STEPS)]}, inp)
    join = testing.launch(_WORKER, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


MESH2 = {"data": 1, "pipe": 1, "model": 2}
MESH4 = {"data": 2, "pipe": 1, "model": 2}


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """Both gloo jobs, started side by side before the JAX goldens are
    computed; each is joined by its own fixture."""
    tmp = tmp_path_factory.mktemp("tp")
    params = port.from_jax_params(jparams, device="cpu")
    return {2: _start_gloo(2, MESH2, list(PROGRAMS) + ["quant_ring_fma"],
                           params, tmp),
            4: _start_gloo(4, MESH4, ["quant_ring"], params, tmp)}


@pytest.fixture(scope="module")
def jax_runs(started):
    """The JAX package's programs, keyed ``(world, program)``."""
    runs = {(2, p): _jax_run(MESH2, p) for p in PROGRAMS}
    runs[(4, "quant_ring")] = _jax_run(MESH4, "quant_ring")
    return runs


@pytest.fixture(scope="module")
def port2(started, jax_runs):
    """The 2-rank job's programs."""
    return started[2]()


@pytest.fixture(scope="module")
def port4(started, jax_runs):
    """The 4-rank job's program."""
    return started[4]()


@pytest.fixture
def runs(port2, jax_runs):
    """The port's 2-rank programs keyed ``(2, program)`` and the JAX
    package's."""
    return {(2, p): r for p, r in port2.items()}, jax_runs


CASES = [(2, p) for p in PROGRAMS] + [(4, "quant_ring")]


@pytest.mark.parametrize("world,program", CASES)
def test_training_matches_jax(request, jax_runs, world, program):
    """Each program's losses and final full params (gathered over the
    model axis) against the JAX package's same program."""
    got = request.getfixturevalue(f"port{world}")[program]
    jlosses, jfinal, _ = jax_runs[(world, program)]
    int8 = "int8" in str(PROGRAMS[program])
    np.testing.assert_allclose(got["losses"], jlosses,
                               **(dict(atol=0, rtol=INT8_RTOL) if int8
                                  else TOL))
    # The rounding flip of the module docstring, at 2 ranks.
    ptol = (dict(atol=1e-4, rtol=INT8_RTOL) if (world, program) == (
        2, "quant_ring") else dict(atol=1e-5, rtol=INT8_RTOL) if int8
        else TOL)
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), jfinal[name], err_msg=name,
                                   **ptol)


def test_quant_ring_gap_to_jax_is_the_fma_flip(runs):
    """With an FMA in the hop, as XLA compiles the Pallas hop, the
    2-rank ring program matches the JAX program to 1e-5; without it
    some param differs by more (the flip the tolerance above allows)."""
    port_runs, jax_runs = runs
    jlosses, jfinal, _ = jax_runs[(2, "quant_ring")]
    fma, sep = port_runs[(2, "quant_ring_fma")], port_runs[(2, "quant_ring")]
    np.testing.assert_allclose(fma["losses"], jlosses, **TOL)
    gap = 0.0
    for name, p in flatten_with_names(fma["params"]):
        np.testing.assert_allclose(p.numpy(), jfinal[name], err_msg=name,
                                   **TOL)
    for name, p in flatten_with_names(sep["params"]):
        gap = max(gap, float(np.abs(p.numpy() - jfinal[name]).max()))
    assert 1e-5 < gap < 1e-4


def test_programs_keep_the_jax_goldens_relations(runs):
    """The fused ring step tracks the composed matmul ring at 1e-5, the
    quantized ring the composed int8 program at 2e-2, and fp32 the
    one-shard sequential loss."""
    port_runs, _ = runs
    losses = {p: port_runs[(2, p)]["losses"] for p in PROGRAMS}
    np.testing.assert_allclose(losses["collective_matmul"],
                               losses["matmul"], rtol=1e-5)
    np.testing.assert_allclose(losses["quant_ring"], losses["int8"],
                               rtol=2e-2)
    np.testing.assert_allclose(losses["fp32"][0], 3.4543259, rtol=1e-6)


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_strategy_json_is_the_jax_builders(runs, program):
    """The port's ``Pipeline`` strategy serializes to the JAX builder's
    JSON byte for byte (ids aside), and the JAX JSON reads back into the
    port and re-emits the same bytes."""
    port_runs, jax_runs = runs
    text = jax_runs[(2, program)][2]
    mine = port_runs[(2, program)]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    assert port.Strategy.from_json(text).to_json() == text


def test_one_shard_pipeline_matches_jax(jparams):
    """``Pipeline()`` on one process, one shard: the JAX package's
    losses and params after 3 steps; with ``Pipeline`` strategies the
    runner's ``get_params`` is the logical tree."""
    jl, jfinal, jtext = _jax_run({"data": 1, "pipe": 1}, "fp32")
    runner = port.AutoDist({"mesh": {"data": 1, "pipe": 1}},
                           Pipeline(**PIPE), device="cpu").build(
        _port_trainable(jparams))
    losses = [float(runner.step(_batch(i))["loss"]) for i in range(STEPS)]
    np.testing.assert_allclose(losses, jl, **TOL)
    for name, p in flatten_with_names(runner.get_params()):
        np.testing.assert_allclose(p.numpy(), jfinal[name], **TOL,
                                   err_msg=name)
    assert runner.strategy.to_json().replace(
        runner.strategy.id, json.loads(jtext)["id"], 1) == jtext


def test_sequential_loss_and_grads_match_jax(jparams):
    """``PipelineTrainable.loss`` (the sequential reference) and every
    gradient against the JAX trainable's."""
    jtr = _jax_trainable()
    batch = _batch(5)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtr.loss(p, None, batch, None)[::2], has_aux=True)(
        jtr.params)
    tr = _port_trainable(jparams)
    leaves = {n: t.clone().requires_grad_()
              for n, t in flatten_with_names(tr.params)}
    from autodist_tpu_torch.kernel.common import unflatten

    loss, _, metrics = tr.loss(unflatten(leaves), None,
                               {k: torch.as_tensor(v)
                                for k, v in batch.items()}, None)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    np.testing.assert_allclose(float(metrics["accuracy"]),
                               float(jm["accuracy"]), **TOL)
    jg = _jflat(jg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], **TOL, err_msg=name)


def test_shard_params_cuts_the_named_sharding_slices(jparams):
    """A rank's model shard is the slice JAX's ``NamedSharding`` gives
    its model index, bit for bit."""
    from autodist_tpu.resource import ResourceSpec
    from autodist_tpu.strategy.parallel_builders import Pipeline as JPipe
    from jax.sharding import NamedSharding, PartitionSpec as P

    jtr = _jax_trainable()
    spec = ResourceSpec(_jax_spec(MESH2))
    strategy = port.Strategy.from_json(
        JPipe(tensor_parallel=2, **PIPE).build(jtr, spec).to_json())
    dims = interop.model_dims(strategy)
    assert dims == {"stages/attention/qkv/kernel": 3,
                    "stages/attention/qkv/bias": 2,
                    "stages/attention/out/kernel": 1,
                    "stages/mlp/wi/kernel": 2, "stages/mlp/wi/bias": 1,
                    "stages/mlp/wo/kernel": 1}
    tree = port.from_jax_params(jparams, device="cpu")
    mesh = spec.make_mesh()
    flat = dict(flatten_with_names(tree))
    shards = [dict(flatten_with_names(interop.shard_params(tree, dims, i, 2)))
              for i in range(2)]
    for nc in strategy.node_configs:
        sharded = jax.device_put(flat[nc.var_name].numpy(), NamedSharding(
            mesh, P(*nc.partitioner.spec)) if nc.partitioner else None)
        for shard in sharded.addressable_shards:
            i = mesh.devices.reshape(-1).tolist().index(shard.device)
            np.testing.assert_array_equal(
                shards[i % 2][nc.var_name].numpy(), np.asarray(shard.data))


def test_builder_checks_match_jax():
    """Electing a kernel without its enabling knob raises the JAX
    builder's ValueError in both packages."""
    from autodist_tpu.strategy.parallel_builders import Pipeline as JPipe

    bad = [(dict(tensor_parallel=2, kernel=("quant_ring",)), "quant_ring"),
           (dict(tensor_parallel=2, collective_precision=INT8,
                 comm_overlap="rsag", kernel=("quant_ring",)), "quant_ring"),
           (dict(tensor_parallel=2, collective_precision=INT8,
                 comm_overlap="matmul", kernel=("quant_ring",)),
            "quant_ring"),
           (dict(tensor_parallel=2, kernel=("collective_matmul",)),
            "collective_matmul"),
           (dict(tensor_parallel=1, comm_overlap="matmul",
                 kernel=("collective_matmul",)), "collective_matmul"),
           (dict(num_microbatches=0), "num_microbatches")]
    for kw, match in bad:
        for builder in (JPipe, Pipeline):
            with pytest.raises(ValueError, match=match):
                builder(**kw)


def test_build_checks_the_mesh_and_the_trainable(jparams):
    tr = _port_trainable(jparams)
    with pytest.raises(ValueError, match="virtual stages"):
        Pipeline(virtual_stages=3).build(
            tr, port.ResourceSpec({"mesh": {"pipe": 1}}))
    with pytest.raises(ValueError, match="'pipe' mesh axis"):
        Pipeline(virtual_stages=2).build(tr, port.ResourceSpec({}))
    with pytest.raises(ValueError, match="'model' mesh axis"):
        Pipeline(virtual_stages=2, tensor_parallel=2).build(
            tr, port.ResourceSpec({"mesh": {"pipe": 1}}))


@pytest.mark.parametrize("what", [
    "pipe_axis", "seq_axis", "zero", "remat", "vocab_parallel", "rsag",
    "int8_overlap", "compressor", "dropout", "stage_aux", "remat_json",
    "vocab_embedding"])
def test_out_of_slice_options_raise(what, jparams):
    """An asynchronous PS and the pipelined LM's dropout at
    ``tensor_parallel > 1`` raise the JAX package's own errors.
    Everything else these cases once refused runs now and is held to
    what it builds: a ``dcn`` axis beside pipe and model (the JAX
    builder's graph config), ZeRO, compressors and remat
    beside ``comm_overlap="rsag"`` and narrowed precisions under
    overlap, a stale PS with its bound, keyed dropout at one shard,
    ``stage_aux``."""
    from autodist_tpu_torch.parallel import axis, tensor

    if what == "pipe_axis":
        # A pipe axis of 2 resolves with ZeRO and rsag.
        tr = _port_trainable(jparams)
        ad = port.AutoDist({"mesh": {"pipe": 1}}, Pipeline(**PIPE),
                           device="cpu")
        d = json.loads(ad.build_or_load_strategy(tr).to_json())
        d["graph_config"]["mesh_axes"]["pipe"] = 2
        d["graph_config"]["parallel"].update(virtual_stages=1,
                                             zero_stage=1,
                                             comm_overlap="rsag")
        from autodist_tpu_torch.parallel.pipeline import make_pipeline_plan
        from autodist_tpu_torch.resource import Mesh

        plan = make_pipeline_plan(tr, port.Strategy.from_json(json.dumps(d)),
                                  Mesh(shape={"data": 1, "pipe": 2}))
        assert (plan.comm_overlap, plan.virtual_stages) == ("rsag", 1)
    elif what == "remat":
        b = Pipeline(remat=True, tensor_parallel=2, comm_overlap="matmul",
                     collective_precision=INT8)
        assert (b.remat, b.comm_overlap, b.precision) == (
            True, "matmul", INT8)
    elif what == "vocab_parallel":
        b = Pipeline(tensor_parallel=2, vocab_parallel=True, zero_stage=1,
                     comm_overlap="matmul",
                     collective_precision={"vocab_stats": "bf16"})
        assert b.precision == {"vocab_stats": "bf16"} and b.vocab_parallel
    elif what == "rsag":
        assert Pipeline(tensor_parallel=2,
                        comm_overlap="rsag").comm_overlap == "rsag"
    elif what == "int8_overlap":
        assert Pipeline(tensor_parallel=2, comm_overlap="matmul",
                        collective_precision=INT8).precision == INT8
    elif what == "compressor":
        b = Pipeline(compressor="bf16_ef", tensor_parallel=2,
                     comm_overlap="rsag")
        assert b.comm_overlap == "rsag"
    elif what == "dropout":
        # Keyed dropout at one shard; at a model axis of 2 a stage
        # raises the JAX package's error.
        tr = tlm.make_pipeline_lm_trainable(
            port.TransformerConfig(**dict(SIZES, dropout_rate=0.1),
                                   dtype=torch.float32),
            port.optim.sgd(0.1), torch.Generator(), device="cpu")
        assert tr.stage_rng
        chunk = port.capture.stage_slice(tr.params["stages"], 0)
        with pytest.raises(NotImplementedError,
                           match="tensor_parallel > 1 requires dropout"):
            tr.stage_fn(chunk, torch.zeros(2, 8, 16), None, None,
                        model_axis=axis.Axis("model", size=2))
    elif what == "stage_aux":
        tr = port.capture.PipelineTrainable(
            lambda c, x: (x * c["w"], (x ** 2).mean()),
            {"w": torch.full((2,), 2.0)}, lambda o, b: (o.sum(), {}),
            port.optim.sgd(0.1), num_stages=2, stage_aux=True)
        loss, _, metrics = tr.loss(tr.params, None,
                                   {"x": torch.ones(3)}, None)
        # 4 * 3 from the head, 1 + 4 from the two stages' aux.
        assert float(loss) == 17.0 and float(metrics["aux_loss"]) == 5.0
    elif what == "vocab_embedding":
        # The sharded lookup's decomposed sum at a narrowed tp_psum
        # precision runs; at a one-rank model axis it is the table's
        # rows.
        table = torch.arange(12.0).view(4, 3)
        ids = torch.tensor([3, 0, 2])
        with tensor.precision_scope(INT8):
            out = tensor.vocab_parallel_embedding(
                ids, table, model_axis=axis.Axis("model"),
                comm_overlap="matmul")
        torch.testing.assert_close(out, table[ids])
    elif what == "zero":
        # ZeRO runs; an asynchronous PS raises in the JAX package's
        # words (it is the AsyncPSRunner's, not a lowering's).
        tr = _port_trainable(jparams)
        ad = port.AutoDist({"mesh": {"pipe": 1}}, Pipeline(
            **PIPE, zero_stage=1), device="cpu")
        d = json.loads(ad.build_or_load_strategy(tr).to_json())
        d["node_configs"][0]["synchronizer"]["sync"] = False
        with pytest.raises(NotImplementedError,
                           match=r"sync=False.*AsyncPSRunner"):
            ad.lower(tr, port.Strategy.from_json(json.dumps(d)))
    elif what == "remat_json":
        # remat read back from JSON runs; a stale PS lowers with its
        # bound on the lowered program (the runner's SSP gate).
        tr = _port_trainable(jparams)
        ad = port.AutoDist({"mesh": {"pipe": 1}}, Pipeline(**PIPE),
                           device="cpu")
        d = json.loads(ad.build_or_load_strategy(tr).to_json())
        d["graph_config"]["parallel"]["remat"] = True
        d["node_configs"][0]["synchronizer"] = {"kind": "ps",
                                                "staleness": 2}
        lowered = ad.lower(tr, port.Strategy.from_json(json.dumps(d)))
        assert lowered.ssp_staleness == 2
    else:
        # A dcn axis beside the pipe and model axes: the cross-slice
        # replicas, counted and recorded as the JAX builder does.
        from autodist_tpu.resource import ResourceSpec as JResourceSpec
        from autodist_tpu.strategy.parallel_builders import \
            Pipeline as JPipe

        sliced = {"topology": {"num_devices": 4},
                  "mesh": {"dcn": 2, "pipe": 1, "model": 2}}
        kw = dict(PIPE, tensor_parallel=2)
        mine = Pipeline(**kw).build(_port_trainable(jparams),
                                    port.ResourceSpec(sliced))
        theirs = JPipe(**kw).build(_jax_trainable(), JResourceSpec(sliced))
        assert mine.graph_config.replicas == 2
        assert json.loads(mine.to_json())["graph_config"] == \
            json.loads(theirs.to_json())["graph_config"]


def test_entry_points_default_to_the_card():
    """``device=None`` means CUDA: without a card the pipelined LM's
    trainable and the Pipeline lowering raise instead of carrying on on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlm.make_pipeline_lm_trainable(_tcfg(), port.optim.sgd(0.1),
                                       torch.Generator())
    tr = tlm.make_pipeline_lm_trainable(_tcfg(), port.optim.sgd(0.1),
                                        torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.AutoDist({"mesh": {"pipe": 1}}, Pipeline(**PIPE)).build(tr)
