"""Vocab parallelism in the port against the JAX package on the CPU: the
sharded lookup, the streaming cross-entropy and the greedy election on 2
gloo ranks against ``shard_map`` over 2 simulated devices, and
``Pipeline(tensor_parallel=2, vocab_parallel=True)`` training against the
JAX ``Pipeline`` program at model 2 (pipe 1) and at pipe 2 x model 2.

The primitives take their inputs from a numpy seed (hidden 8, batch 2,
length 4, sequence chunks of 2) at vocab 10 (divisible) and 9 (one
padded row), with the ``vocab_stats`` slot at fp32, bf16 and int8.  The
training cases use the tiny config of the JAX package's vocab-parallel
goldens at vocab 33 (hidden 16, 2 layers, 2 heads, mlp 32, length 8,
fp32; odd, so the table pads to 34 rows), built by the JAX package and
carried into the port with ``interop``; both sides train 3 SGD steps on
the same numpy batches.  Each world size is one module-scoped job of
every check it runs, started before the JAX goldens are computed.

Tolerances: the JAX golden's own (``test_vocab_parallel.py:91``): the
loss 1e-6 relative, dx and dW 1e-5 relative and 1e-6 absolute, ``pred``
exact, and the lookup bit for bit; the narrowed ``vocab_stats`` runs the
same arithmetic as JAX and is held to the same.  Training: losses and
gathered params 1e-5 relative and 1e-6 absolute for the fp32 and
``collective_matmul`` programs; the int8 programs those
``tests/test_torch_pipeline.py`` gives them (losses 1e-4 relative,
params 1e-5 absolute and 1e-4 relative).  At pipe 2 x model 2 the
``quant_ring`` program's params are allowed 1e-4 absolute: there the JAX
program's params differ from its own model-2 program's by up to ~5e-5
(equal losses), and the port's stay on the model-2 program's
(``test_quant_ring_pipe2_gap_is_the_jax_layouts``).
"""
import json
import textwrap
import types

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
from autodist_tpu_torch.models import pipeline_lm as tlm
from autodist_tpu_torch.strategy.parallel_builders import Pipeline

V = 33
SIZES = dict(vocab_size=V, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=8, dropout_rate=0.0,
             attention_dropout_rate=0.0)
STEPS = 3
INT8 = {"tp_psum": "int8"}
TOL = dict(atol=1e-6, rtol=1e-5)
INT8_LOSS = dict(atol=0, rtol=1e-4)
INT8_PARAMS = dict(atol=1e-5, rtol=1e-4)
MODEL2 = {"data": 1, "pipe": 1, "model": 2}
PIPE2_MODEL2 = {"data": 1, "pipe": 2, "model": 2}
PROGRAMS = {
    "fp32": {},
    "quant_ring": dict(collective_precision=INT8, kernel=("quant_ring",)),
    "collective_matmul": dict(comm_overlap="matmul",
                              kernel=("collective_matmul",)),
    "int8_stats": dict(collective_precision={"tp_psum": "int8",
                                             "vocab_stats": "int8"}),
}
# name -> (world, mesh, program); 2 stages (V = 2 at pipe 1, GPipe at 2)
CASES = {f"model2_{p}": (2, MODEL2, p) for p in PROGRAMS}
CASES.update({f"pipe2_model2_{p}": (4, PIPE2_MODEL2, p)
              for p in ("fp32", "quant_ring", "collective_matmul")})
XENT = [(vocab, prec) for vocab in (10, 9) for prec in ("fp32", "bf16",
                                                        "int8")]


def _pipe_kw(mesh, program):
    return dict(num_microbatches=2, virtual_stages=2 // mesh["pipe"],
                tensor_parallel=2, vocab_parallel=True, **PROGRAMS[program])


def _batch(seed, batch=8):
    r = np.random.RandomState(seed)
    return {"x": r.randint(0, V, (batch, 8)).astype(np.int32),
            "y": r.randint(0, V, (batch, 8)).astype(np.int32)}


def _xent_inputs(vocab):
    r = np.random.RandomState(3)
    return (r.randn(2, 4, 8).astype(np.float32),
            (r.randn(vocab, 8) * 0.5).astype(np.float32),
            r.randint(0, vocab, (2, 4)).astype(np.int32))


def _underflow_inputs():
    """A confident token beside flat ones, what the pipelined LM's tied
    head meets at full width: vocab 1024, hidden 256, one sequence of 4
    tokens (one sequence chunk, so one int8 scale).  Token 0's hidden
    state is its target's embedding row scaled so that its logit stands
    11 above the rest (a sum-exp near 1); tokens 1-3 sit near zero
    (logits near 0, a sum-exp near 1024, about 512 a shard)."""
    r = np.random.RandomState(500)
    emb = (0.1 * r.randn(1024, 256)).astype(np.float32)
    targets = r.randint(0, 1024, (1, 4)).astype(np.int32)
    x = (0.01 * r.randn(1, 4, 256)).astype(np.float32)
    row = emb[targets[0, 0]]
    x[0, 0] = 11.0 * row / np.dot(row, row)
    return x, emb, targets


def _lookup_inputs():
    r = np.random.RandomState(0)
    return (r.randn(7, 4).astype(np.float32),
            r.randint(0, 7, (3, 5)).astype(np.int32))


def _padded(a, tp=2):
    pad = (-a.shape[0]) % tp
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


def _greedy_inputs():
    """Every real row scores below zero, the zero padded row would score
    0 (the max) if it were not masked; and a random case at vocab 9."""
    r = np.random.RandomState(0)
    emb = np.abs(r.randn(5, 8)).astype(np.float32) + 0.1
    x = -np.ones((1, 8), np.float32)
    return {"adversarial": (x, emb, 5),
            "random": (r.randn(4, 8).astype(np.float32),
                       r.randn(9, 8).astype(np.float32), 9)}


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


def _jax_spec(mesh):
    return {"topology": {"platform": "cpu",
                         "num_devices": int(np.prod(list(mesh.values())))},
            "mesh": mesh}


def _jax_run(case):
    """Losses, final params and strategy JSON of the JAX program."""
    from autodist_tpu import AutoDist

    _, mesh, program = CASES[case]
    runner = AutoDist(_jax_spec(mesh), "Pipeline",
                      **_pipe_kw(mesh, program)).build(_jax_trainable())
    try:
        losses = [float(np.asarray(runner.step(_batch(i))["loss"]))
                  for i in range(STEPS)]
        return losses, _jflat(runner.get_params()), runner.strategy.to_json()
    finally:
        runner.close()


# --------------------------------------------------------------------------- #
# The JAX package's primitives under shard_map on 2 simulated devices
# --------------------------------------------------------------------------- #
def _jax_mesh():
    return Mesh(np.array(jax.devices()[:2]), ("model",))


def _jax_lookup():
    from autodist_tpu.parallel.tensor import vocab_parallel_embedding

    emb, tokens = _lookup_inputs()
    return np.asarray(jax.shard_map(
        lambda t, e: vocab_parallel_embedding(t, e, model_axis="model"),
        mesh=_jax_mesh(), in_specs=(P(), P("model", None)), out_specs=P(),
        check_vma=False)(jnp.asarray(tokens), jnp.asarray(_padded(emb))))


def _jax_xent(vocab, prec):
    from autodist_tpu.parallel.tensor import (precision_scope,
                                              vocab_parallel_cross_entropy)

    x, emb, targets = _xent_inputs(vocab)

    def local(x, e):
        def loss(x, e):
            nll, pred = vocab_parallel_cross_entropy(
                x, e, jnp.asarray(targets), vocab_size=vocab,
                model_axis="model", seq_chunk=2)
            return jnp.mean(nll), pred
        (val, pred), (dx, de) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(x, e)
        return val, pred, dx, de

    with precision_scope({"vocab_stats": prec}):
        out = jax.shard_map(
            local, mesh=_jax_mesh(), in_specs=(P(), P("model", None)),
            out_specs=(P(), P(), P(), P("model", None)),
            check_vma=False)(jnp.asarray(x), jnp.asarray(_padded(emb)))
    return [np.asarray(o) for o in out]


def _jax_underflow(prec):
    from autodist_tpu.parallel.tensor import (precision_scope,
                                              vocab_parallel_cross_entropy)

    x, emb, targets = _underflow_inputs()
    with precision_scope({"vocab_stats": prec}):
        nll, _ = jax.shard_map(
            lambda xx, ee: vocab_parallel_cross_entropy(
                xx, ee, jnp.asarray(targets), vocab_size=emb.shape[0],
                model_axis="model"),
            mesh=_jax_mesh(), in_specs=(P(), P("model", None)),
            out_specs=(P(), P()), check_vma=False)(
                jnp.asarray(x), jnp.asarray(emb))
    return np.asarray(nll)


def _jax_greedy(x, emb, vocab):
    from autodist_tpu.parallel.tensor import vocab_parallel_greedy_token

    tok, m = jax.shard_map(
        lambda xx, ee: vocab_parallel_greedy_token(
            xx, ee, vocab_size=vocab, model_axis="model"),
        mesh=_jax_mesh(), in_specs=(P(), P("model", None)),
        out_specs=(P(), P()), check_vma=False)(
            jnp.asarray(x), jnp.asarray(_padded(emb)))
    return np.asarray(tok), np.asarray(m)


# --------------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import torch
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
    if "prims" in job:
        model = ResourceSpec({"mesh": {"model": 2}}).make_mesh().axis("model")
        p = job["prims"]

        def shard(t):
            return t.chunk(2)[model.index]

        emb, tokens = p["lookup"]
        res["lookup"] = tensor.vocab_parallel_embedding(
            torch.as_tensor(tokens), shard(emb), model_axis=model)
        for (vocab, prec), (x, emb, targets) in p["xent"].items():
            x = x.clone().requires_grad_()
            e = shard(emb).clone().requires_grad_()
            with tensor.precision_scope({"vocab_stats": prec}):
                nll, pred = tensor.vocab_parallel_cross_entropy(
                    x, e, targets, vocab_size=vocab, model_axis=model,
                    seq_chunk=2)
            val = nll.mean()
            val.backward()
            res[("xent", vocab, prec)] = (
                val.detach(), pred, x.grad, model.all_gather(e.grad))
        for prec in ("fp32", "int8"):
            x, emb, targets = p["underflow"]
            with tensor.precision_scope({"vocab_stats": prec}):
                nll, _ = tensor.vocab_parallel_cross_entropy(
                    x, shard(emb), targets, vocab_size=emb.shape[0],
                    model_axis=model)
            res[("underflow", prec)] = nll
        for name, (x, emb, vocab) in p["greedy"].items():
            res[("greedy", name)] = tensor.vocab_parallel_greedy_token(
                x, shard(emb), vocab_size=vocab, model_axis=model)
    for name, (mesh, kw) in job["cases"].items():
        tr = pipeline_lm.make_pipeline_lm_trainable(
            port.TransformerConfig(**job["sizes"], dtype=torch.float32),
            port.optim.sgd(0.05), torch.Generator().manual_seed(0),
            device="cpu")
        tr.params = job["params"]
        runner = port.AutoDist({"mesh": mesh}, Pipeline(**kw),
                               device="cpu").build(tr)
        losses = [float(runner.step(b)["loss"]) for b in job["batches"]]
        stored = runner.state["params"]["shared/embedding"].shape
        res[name] = {"losses": losses, "params": runner.get_params(),
                     "strategy": runner.strategy.to_json(),
                     "stored": tuple(stored)}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _prims():
    """The primitives' inputs, as torch tensors (each rank cuts its
    shard of the padded tables)."""
    def t(a):
        return torch.as_tensor(a)

    emb, tokens = _lookup_inputs()
    xent = {}
    for vocab, prec in XENT:
        x, e, targets = _xent_inputs(vocab)
        xent[(vocab, prec)] = (t(x), t(_padded(e)), t(targets))
    greedy = {name: (t(x), t(_padded(e)), vocab)
              for name, (x, e, vocab) in _greedy_inputs().items()}
    return {"lookup": (t(_padded(emb)), tokens), "xent": xent,
            "greedy": greedy,
            "underflow": tuple(t(a) for a in _underflow_inputs())}


def _start_gloo(world, params, tmp):
    """Start the job of ``world`` ranks; returns a function that joins
    the ranks and loads rank 0's results."""
    tmp = tmp / f"job{world}"
    tmp.mkdir()
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    cases = {name: (mesh, _pipe_kw(mesh, program))
             for name, (w, mesh, program) in CASES.items() if w == world}
    job = {"cases": cases,
           "sizes": SIZES, "params": params,
           "batches": [_batch(i) for i in range(STEPS)]}
    if world == 2:
        job["prims"] = _prims()
    torch.save(job, inp)
    join = testing.launch(_WORKER, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, _jax_trainable().params)


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """Both gloo jobs, started before the JAX goldens are computed."""
    tmp = tmp_path_factory.mktemp("vocab")
    params = port.from_jax_params(jparams, device="cpu")
    return {w: _start_gloo(w, params, tmp) for w in (2, 4)}


@pytest.fixture(scope="module")
def jax_runs(started):
    return {case: _jax_run(case) for case in CASES}


@pytest.fixture(scope="module")
def ranks(started, jax_runs):
    """Every check's result from rank 0 of its job."""
    out = {}
    for world in (2, 4):
        out.update(started[world]())
    return out


# --------------------------------------------------------------------------- #
# (a), (b): the primitives
# --------------------------------------------------------------------------- #
def test_embedding_lookup_is_exact(ranks):
    """The masked shard lookup and its sum equal the JAX function and
    the full table's rows bit for bit (vocab 7, one padded row)."""
    emb, tokens = _lookup_inputs()
    got = ranks["lookup"].numpy()
    np.testing.assert_array_equal(got, _jax_lookup())
    np.testing.assert_array_equal(got, emb[tokens])


@pytest.mark.parametrize("vocab,prec", XENT)
def test_cross_entropy_matches_jax(ranks, vocab, prec):
    """Loss, pred, dx and the gathered padded dW against the JAX
    epilogue under the same ``vocab_stats`` precision; the padded row
    gets no gradient."""
    val, pred, dx, de = ranks[("xent", vocab, prec)]
    jval, jpred, jdx, jde = _jax_xent(vocab, prec)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    np.testing.assert_array_equal(pred.numpy(), jpred)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(de.numpy(), jde, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(de.numpy()[vocab:], 0.0)
    if prec == "fp32":
        x, emb, targets = _xent_inputs(vocab)
        np.testing.assert_array_equal(pred.numpy(), (x @ emb.T).argmax(-1))


def test_int8_stats_underflow_is_the_jax_rule(ranks):
    """At int8 the sum-exp's group scale is set by the flat tokens
    (about 512 a shard, a level of about 4), so the confident token's
    sum-exp near 1 rounds to level 0 and its loss is log 0 = -inf: in the
    JAX epilogue as in the port's, the same tokens finite and equal
    (1e-6 relative) and the same token -inf.  At fp32 both are finite
    and agree."""
    want = _jax_underflow("fp32")
    got = ranks[("underflow", "fp32")].numpy()
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = _jax_underflow("int8")
    got = ranks[("underflow", "int8")].numpy()
    print(f"vocab_stats int8: JAX nll {want.tolist()}, port nll "
          f"{got.tolist()}")
    assert np.isneginf(want[0, 0]) and np.isneginf(got[0, 0])
    np.testing.assert_allclose(got[0, 1:], want[0, 1:], rtol=1e-6)
    assert np.isfinite(want[0, 1:]).all()


@pytest.mark.parametrize("name", ["adversarial", "random"])
def test_greedy_election_matches_jax(ranks, name):
    """The election over the model axis gives the JAX token and max
    logit; a padded row never wins, even where it would score the
    max."""
    tok, m = ranks[("greedy", name)]
    x, emb, vocab = _greedy_inputs()[name]
    jtok, jm = _jax_greedy(x, emb, vocab)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_allclose(m.numpy(), jm, rtol=1e-6)
    np.testing.assert_array_equal(tok.numpy(), (x @ emb.T).argmax(-1))
    assert (tok.numpy() < vocab).all()


# --------------------------------------------------------------------------- #
# (c), (d): Pipeline(tensor_parallel=2, vocab_parallel=True)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_training_matches_jax(ranks, jax_runs, case):
    """Losses and the gathered params (the table back to its [33, H]
    rows) against the JAX program; each rank stores its [17, H] padded
    shard."""
    got = ranks[case]
    jlosses, jfinal, _ = jax_runs[case]
    int8 = CASES[case][2] in ("quant_ring", "int8_stats")
    np.testing.assert_allclose(got["losses"], jlosses,
                               **(INT8_LOSS if int8 else TOL))
    params = dict(flatten_with_names(got["params"]))
    assert set(params) == set(jfinal)
    assert tuple(params["shared/embedding"].shape) == (V, 16)
    assert got["stored"] == (17, 16)
    # The JAX layouts' gap of the module docstring.
    ptol = (dict(atol=1e-4, rtol=1e-4) if case == "pipe2_model2_quant_ring"
            else INT8_PARAMS if int8 else TOL)
    for name, p in params.items():
        np.testing.assert_allclose(p.numpy(), jfinal[name], err_msg=name,
                                   **ptol)


def test_quant_ring_pipe2_gap_is_the_jax_layouts(ranks, jax_runs):
    """The JAX ``quant_ring`` program with ``vocab_parallel`` gives the
    same losses at pipe 2 x model 2 as at model 2 but params up to ~5e-5
    apart (without ``vocab_parallel`` they agree to 1e-8); the port's
    pipe 2 x model 2 program sits on the JAX model-2 program's params at
    the int8 tolerance, so the allowance above is that JAX gap."""
    pipe2, model2 = (jax_runs[f"{m}_quant_ring"][1]
                     for m in ("pipe2_model2", "model2"))
    gap = max(float(np.abs(pipe2[nm] - model2[nm]).max()) for nm in pipe2)
    assert 1e-5 < gap < 1e-4
    got = ranks["pipe2_model2_quant_ring"]
    np.testing.assert_allclose(got["losses"],
                               jax_runs["model2_quant_ring"][0], **TOL)
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), model2[name], err_msg=name,
                                   **INT8_PARAMS)


@pytest.mark.parametrize("case", list(CASES))
def test_strategy_json_is_the_jax_builders(ranks, jax_runs, case):
    """The vocab-parallel strategy serializes to the JAX builder's JSON
    byte for byte (ids aside): the table ``[model, None]`` at the
    ``vocab_stats`` precision."""
    text = jax_runs[case][2]
    mine = ranks[case]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    table = [nc for nc in json.loads(mine)["node_configs"]
             if nc["var_name"] == "shared/embedding"][0]
    assert table["partitioner"]["spec"] == ["model", None]


def test_vocab_parallel_at_one_shard_is_recorded():
    """At ``tensor_parallel=1`` the knob is recorded and shards nothing,
    as in the JAX builder."""
    from autodist_tpu import AutoDist

    mesh = {"data": 1, "pipe": 1}
    kw = dict(num_microbatches=2, virtual_stages=2, vocab_parallel=True)
    tr = tlm.make_pipeline_lm_trainable(
        port.TransformerConfig(**SIZES, dtype=torch.float32),
        port.optim.sgd(0.05), torch.Generator().manual_seed(0),
        device="cpu")
    mine = port.AutoDist({"mesh": mesh}, Pipeline(**kw),
                         device="cpu").build_or_load_strategy(tr).to_json()
    text = AutoDist(_jax_spec(mesh), "Pipeline", **kw) \
        .build_or_load_strategy(_jax_trainable()).to_json()
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    assert json.loads(mine)["graph_config"]["parallel"]["vocab_parallel"]


@pytest.mark.parametrize("what", ["no_shared", "head", "overlap_stats"])
def test_builder_checks(what):
    """The JAX builder's vocab checks, with its errors; a narrowed
    ``vocab_stats`` under overlap builds."""
    tr = tlm.make_pipeline_lm_trainable(
        port.TransformerConfig(**SIZES, dtype=torch.float32),
        port.optim.sgd(0.05), torch.Generator().manual_seed(0),
        device="cpu")
    # A 2-rank mesh's spec, read without a process group.
    rs = types.SimpleNamespace(resolved_mesh_shape=lambda: dict(MODEL2))
    kw = dict(num_microbatches=2, virtual_stages=2, tensor_parallel=2,
              vocab_parallel=True)
    if what == "no_shared":
        tr = port.capture.PipelineTrainable(
            tr.stage_fn, tr.params["stages"], lambda o, b: (0, {}),
            tr.optimizer, num_stages=2)
        with pytest.raises(ValueError, match="no shared_params"):
            Pipeline(**kw).build(tr, rs)
    elif what == "head":
        tr.loss_head = lambda outputs, batch, shared: (0, {})
        with pytest.raises(ValueError, match="vocab-parallel-aware"):
            Pipeline(**kw).build(tr, rs)
    else:
        strategy = Pipeline(**kw, comm_overlap="matmul",
                            collective_precision={"vocab_stats": "bf16"}
                            ).build(tr, rs)
        assert strategy.graph_config.precision == {"vocab_stats": "bf16"}
        assert strategy.graph_config.parallel["comm_overlap"] == "matmul"
