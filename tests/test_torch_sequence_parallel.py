"""Sequence-parallel training through ``SequenceParallel``, against the
JAX package on the CPU.

A ``TransformerLM`` (vocabulary 64, hidden 32, 2 heads of 16, 1 layer,
global sequence 32, batch 4, fp32) is built by the JAX package; its
weights are carried into the port bit for bit, and both sides train 3
SGD steps on the same numpy batches with the config's ``attention_fn``
the einsum ring or the flash ring (causal) and its ``position_fn``
``global_positions``.  The port runs on 4 gloo ranks at ``{"data": 2,
"seq": 2}`` and at ``{"seq": 4}``; the JAX package runs
``lower_sequence_parallel`` on the same mesh of its simulated devices.
The final params agree within 2e-5 (the JAX tests' tolerance) and the
losses within 1e-5.  At data 2 x seq 2 with the einsum ring the port
also runs ``compressor="bf16_ef"``, the ``grad`` slot at int8 (every
variable's ``int8_ef``) and ``GradAccumulation(..., 2)`` through
``AutoDist`` against the JAX builders' runners (the compressed ones to
twice the wire's unit of each tensor's update: a bf16 sum of 4 ranks
parts by its order, an int8 level by the residual's rounding).  The strategy JSON equals the JAX builder's; the
JAX package's errors (no matching ``seq_leaves``, no seq axis, its
builder checks) and the out-of-range position's NaN loss hold in both;
what the slice does not run raises, naming its item.
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
from autodist_tpu_torch.parallel import ring_attention as tring
from autodist_tpu_torch.parallel import sequence as tseq
from autodist_tpu_torch.strategy.parallel_builders import SequenceParallel

LM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
          mlp_dim=64, max_len=32, dropout_rate=0.0,
          attention_dropout_rate=0.0)
SEQ, BATCH, STEPS, LR = 32, 4, 3, 0.5
MESHES = {"data 2 x seq 2": {"data": 2, "seq": 2}, "seq 4": {"seq": 4}}
# Compressors, the grad slot and accumulation: builder keywords (accum:
# GradAccumulation around SequenceParallel) at data 2 x seq 2, einsum.
SYNC_PROGRAMS = {"bf16_ef": dict(compressor="bf16_ef"),
                 "grad_int8": dict(collective_precision={"grad": "int8"}),
                 "accum2": dict(accum=2)}
RINGS = ("einsum", "flash")
TOL = dict(atol=2e-5, rtol=2e-5)


def _batches():
    r = np.random.RandomState(1)
    out = []
    for _ in range(STEPS):
        x = r.randint(0, 64, (BATCH, SEQ)).astype(np.int32)
        out.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return out


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_trainable(ring=None, max_len=LM["max_len"]):
    """The JAX LM: initialized unsharded (no ring, arange positions),
    applied with ``ring`` and ``global_positions`` when given."""
    from autodist_tpu.capture import Trainable
    from autodist_tpu.models.transformer import (TransformerConfig,
                                                 TransformerLM, lm_loss_head)
    from autodist_tpu.parallel import ring_attention as jring
    from autodist_tpu.parallel.sequence import global_positions

    kw = dict(LM, max_len=max_len, dtype=jnp.float32)
    params = jax.jit(TransformerLM(TransformerConfig(**kw)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, min(SEQ, max_len)),
                                         jnp.int32))["params"]
    fn = None if ring is None else {
        "einsum": jring.make_ring_attention_fn,
        "flash": jring.make_ring_flash_attention_fn}[ring](causal=True)
    model = TransformerLM(TransformerConfig(
        **kw, attention_fn=fn,
        position_fn=None if ring is None else global_positions))

    def loss_fn(p, batch):
        return lm_loss_head(model.apply({"params": p}, batch["x"]), batch)

    return Trainable.from_loss_fn(loss_fn, params, optax.sgd(LR))


def _jax_run(mesh_shape, ring):
    from jax.sharding import Mesh

    from autodist_tpu.parallel.sequence import lower_sequence_parallel

    n = int(np.prod(list(mesh_shape.values())))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(
        tuple(mesh_shape.values())), tuple(mesh_shape))
    tr = _jax_trainable(ring)
    init_fn, step_fn, _ = lower_sequence_parallel(tr, mesh)
    state, losses = init_fn(tr.params, None), []
    for b in _batches():
        state, m = step_fn(state, jax.tree.map(jnp.asarray, b),
                           jax.random.PRNGKey(0))
        losses.append(float(np.asarray(m["loss"])))
    return losses, _jflat(jax.device_get(state["params"]))


def _port_cfg(ring=None, **kw):
    fn = None if ring is None else {
        "einsum": tring.make_ring_attention_fn,
        "flash": tring.make_ring_flash_attention_fn}[ring](causal=True)
    return port.TransformerConfig(
        **{**LM, **kw}, dtype=torch.float32, attention_fn=fn,
        position_fn=None if ring is None else tseq.global_positions)


def _port_trainable(params, ring="flash", **kw):
    tr = port.make_lm_trainable(_port_cfg(ring, **kw), port.optim.sgd(LR),
                                torch.Generator(), device="cpu")
    tr.params = port.from_jax_params(params, device="cpu")
    return tr


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, _jax_trainable().params)


# --------------------------------------------------------------------------- #
# 4 gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.parallel import ring_attention, sequence
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    rings = {"einsum": ring_attention.make_ring_attention_fn,
             "flash": ring_attention.make_ring_flash_attention_fn}
    res = {}
    for label, mesh in job["meshes"].items():
        for ring in job["rings"]:
            cfg = port.TransformerConfig(
                **job["lm"], dtype=torch.float32,
                attention_fn=rings[ring](causal=True),
                position_fn=sequence.global_positions)
            tr = port.make_lm_trainable(cfg, port.optim.sgd(job["lr"]),
                                        torch.Generator(), device="cpu")
            tr.params = job["params"]
            runner = port.AutoDist({"mesh": mesh}, port.SequenceParallel(),
                                   device="cpu").build(tr)
            if ring == "flash":
                ms = [runner.step(b) for b in job["batches"]]
                losses = [float(m["loss"]) for m in ms]
            else:
                ms = runner.run_steps(port.stack_steps(job["batches"]))
                losses = ms["loss"].tolist()
            res[(label, ring)] = {
                "loss": losses, "params": runner.get_params(),
                "strategy": runner.strategy.to_json(),
                "x_shape": tuple(runner._place_batch(
                    job["batches"][0])["x"].shape)}
            try:        # a sequence of 31 does not divide over seq
                runner.step({k: v[:, :31] for k, v in
                             job["batches"][0].items()})
            except ValueError as e:
                res[(label, ring)]["indivisible"] = str(e)
    for name, kw in job["sync_programs"].items():
        kw = dict(kw)
        accum = kw.pop("accum", 1)
        cfg = port.TransformerConfig(
            **job["lm"], dtype=torch.float32,
            attention_fn=rings["einsum"](causal=True),
            position_fn=sequence.global_positions)
        tr = port.make_lm_trainable(cfg, port.optim.sgd(job["lr"]),
                                    torch.Generator(), device="cpu")
        tr.params = job["params"]
        builder = port.SequenceParallel(**kw)
        if accum > 1:
            builder = port.GradAccumulation(builder, accum)
        runner = port.AutoDist({"mesh": job["meshes"]["data 2 x seq 2"]},
                               builder, device="cpu").build(tr)
        res[("sync", name)] = {
            "loss": [float(runner.step(b)["loss"]) for b in job["batches"]],
            "params": runner.get_params(),
            "rows": sorted(runner.state["sync_state"])}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """The 4-rank gloo job, started before the JAX runs so that the two
    run side by side."""
    tmp = tmp_path_factory.mktemp("seq")
    inp, out = tmp / "job.pt", tmp / "res.pt"
    torch.save({"meshes": MESHES, "rings": RINGS, "lm": LM, "lr": LR,
                "sync_programs": SYNC_PROGRAMS,
                "params": port.from_jax_params(jparams, device="cpu"),
                "batches": _batches()}, inp)
    join = testing.launch(_WORKER, 4, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


def _jax_sync_run(program):
    """A ``SYNC_PROGRAMS`` program through the JAX builders' runner."""
    from autodist_tpu import AutoDist, GradAccumulation
    from autodist_tpu.strategy.parallel_builders import (
        SequenceParallel as JSeq)

    kw = dict(SYNC_PROGRAMS[program])
    accum = kw.pop("accum", 1)
    builder = JSeq(**kw)
    if accum > 1:
        builder = GradAccumulation(builder, accum)
    runner = AutoDist({"topology": {"platform": "cpu", "num_devices": 4},
                       "mesh": MESHES["data 2 x seq 2"]},
                      builder).build(_jax_trainable("einsum"))
    try:
        losses = [float(np.asarray(runner.step(b)["loss"]))
                  for b in _batches()]
        return losses, _jflat(jax.device_get(runner.get_params()))
    finally:
        runner.close()


@pytest.fixture(scope="module")
def jax_runs(started):
    out = {(label, ring): _jax_run(mesh, ring)
           for label, mesh in MESHES.items() for ring in RINGS}
    out.update({("sync", p): _jax_sync_run(p) for p in SYNC_PROGRAMS})
    return out


@pytest.fixture(scope="module")
def port4(started, jax_runs):
    return started()


@pytest.mark.parametrize("label", list(MESHES))
@pytest.mark.parametrize("ring", RINGS)
def test_training_matches_jax(port4, jax_runs, label, ring):
    """3 SGD steps on 4 ranks: the losses within 1e-5 and the final
    params within 2e-5 of JAX ``lower_sequence_parallel`` on the same
    mesh (the einsum ring through ``run_steps``, the flash ring through
    ``step``)."""
    got = port4[(label, ring)]
    jlosses, jfinal = jax_runs[(label, ring)]
    np.testing.assert_allclose(got["loss"], jlosses, atol=1e-5, rtol=1e-5)
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(p.numpy(), jfinal[name], **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("program", list(SYNC_PROGRAMS))
def test_compressors_and_accumulation_match_jax(port4, jax_runs, jparams,
                                                program):
    """A per-variable compressor, the ``grad`` slot and accumulation on
    ``data 2 x seq 2``: losses and final params against the JAX
    builders' runner; a stateful compressor keeps one row a variable."""
    got = port4[("sync", program)]
    jlosses, jfinal = jax_runs[("sync", program)]
    assert got["rows"] == ([] if program == "accum2"
                           else sorted(jfinal))
    if program == "accum2":
        np.testing.assert_allclose(got["loss"], jlosses, atol=1e-5,
                                   rtol=1e-5)
        for name, p in flatten_with_names(got["params"]):
            np.testing.assert_allclose(p.numpy(), jfinal[name], **TOL,
                                       err_msg=name)
        return
    # A narrow wire's sum of 4 ranks parts by its order (bf16), a level
    # by the residual's rounding (int8): the runs agree to twice the
    # wire's unit of each tensor's update (in L2 norm) and of the loss's
    # fall.
    unit = 2 * {"bf16_ef": 2.0 ** -8, "grad_int8": 1 / 127}[program]
    init = _jflat(jparams)
    for name, p in flatten_with_names(got["params"]):
        moved = np.linalg.norm(jfinal[name] - init[name])
        assert np.linalg.norm(p.numpy() - jfinal[name]) \
            <= unit * moved + 1e-7, name
    assert np.all(np.abs(np.subtract(got["loss"], jlosses))
                  <= unit * np.abs(np.subtract(jlosses, jlosses[0])) + 1e-6)


def test_rank_holds_its_batch_and_sequence_chunk(port4):
    """The feed cuts the token leaves along dim 0 over data and dim 1
    over seq: ``[4, 32]`` -> ``[2, 16]`` at data 2 x seq 2, ``[4, 8]``
    at seq 4; a sequence of 31, which does not divide, raises a
    ValueError naming the seq axis."""
    assert port4[("data 2 x seq 2", "flash")]["x_shape"] == (2, 16)
    assert port4[("seq 4", "flash")]["x_shape"] == (4, 8)
    for label, n in (("data 2 x seq 2", 2), ("seq 4", 4)):
        for ring in RINGS:
            assert f"does not divide by the {n}-way 'seq' axis" in port4[
                (label, ring)]["indivisible"]


@pytest.mark.parametrize("label", list(MESHES))
def test_strategy_json_is_the_jax_builders(port4, label):
    """The port's ``SequenceParallel`` strategy serializes to the JAX
    builder's JSON byte for byte (ids aside), and reads back."""
    from autodist_tpu.resource import ResourceSpec as JSpec
    from autodist_tpu.strategy.parallel_builders import (
        SequenceParallel as JSeq)

    mesh = MESHES[label]
    text = JSeq().build(_jax_trainable("flash"), JSpec(
        {"topology": {"platform": "cpu", "num_devices": 4},
         "mesh": mesh})).to_json()
    mine = port4[(label, "flash")]["strategy"]
    assert json.loads(mine)["graph_config"]["lowering"] == "sequence"
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    assert port.Strategy.from_json(text).to_json() == text


# --------------------------------------------------------------------------- #
# one process
# --------------------------------------------------------------------------- #
def _one_rank(tr):
    return port.AutoDist({"mesh": {"seq": 1}}, SequenceParallel(),
                         device="cpu").build(tr)


def test_one_rank_seq_axis_trains_as_one_process(jparams):
    """``{"seq": 1}``: the flash ring (one diagonal chunk) trains as the
    plain model through ``AllReduce``, within 1e-6."""
    a = _one_rank(_port_trainable(jparams))
    b = port.AutoDist({}, port.AllReduce(), device="cpu").build(
        _port_trainable(jparams, ring=None))
    for batch in _batches():
        torch.testing.assert_close(a.step(batch)["loss"],
                                   b.step(batch)["loss"], atol=1e-6,
                                   rtol=1e-6)
    for (n, x), (_, y) in zip(flatten_with_names(a.get_params()),
                              flatten_with_names(b.get_params())):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6, msg=n)


def test_unmatched_seq_leaves_raise(jparams):
    """A batch with no leaf named in ``seq_leaves``: the JAX ValueError
    in both packages."""
    from jax.sharding import Mesh

    from autodist_tpu.parallel.sequence import lower_sequence_parallel

    b = _batches()[0]
    bad = {"tokens": b["x"], "labels": b["y"]}
    mesh = Mesh(np.array(jax.devices()[:2]), ("seq",))
    tr = _jax_trainable("einsum")
    init_fn, step_fn, _ = lower_sequence_parallel(tr, mesh)
    with pytest.raises(ValueError, match="seq_leaves"):
        step_fn(init_fn(tr.params, None), jax.tree.map(jnp.asarray, bad),
                jax.random.PRNGKey(0))
    runner = _one_rank(_port_trainable(jparams))
    with pytest.raises(ValueError, match="seq_leaves"):
        runner.step(bad)


def test_positions_past_the_table_give_a_nan_loss(jparams):
    """A positional table of 16 rows under a global sequence of 32 (no
    static ``max_len`` check): the loss is NaN on the first step, in the
    JAX package and in the port, which clamps the gather instead of
    reading out of range."""
    from jax.sharding import Mesh

    from autodist_tpu.parallel.sequence import lower_sequence_parallel

    batch = _batches()[0]
    jtr = _jax_trainable("einsum", max_len=16)
    init_fn, step_fn, _ = lower_sequence_parallel(
        jtr, Mesh(np.array(jax.devices()[:2]), ("seq",)))
    _, m = step_fn(init_fn(jtr.params, None), jax.tree.map(jnp.asarray,
                                                             batch),
                   jax.random.PRNGKey(0))
    assert np.isnan(float(np.asarray(m["loss"])))
    tr = port.make_lm_trainable(_port_cfg("einsum", max_len=16),
                                port.optim.sgd(LR), torch.Generator(),
                                device="cpu")
    tr.params = port.from_jax_params(jax.tree.map(np.asarray, jtr.params),
                                     device="cpu")
    assert torch.isnan(_one_rank(tr).step(batch)["loss"])


def test_sequence_lowering_direct_entry(jparams):
    """``lower_sequence_parallel`` (the direct API) gives the step the
    strategy lowering gives, and refuses a mesh without a seq axis."""
    from autodist_tpu_torch.resource import Mesh
    from autodist_tpu_torch.runner import DistributedRunner

    tr = _port_trainable(jparams)
    direct = DistributedRunner(tr, tseq.lower_sequence_parallel(
        tr, Mesh(shape={"seq": 1}), device="cpu"))
    via = _one_rank(_port_trainable(jparams))
    batch = _batches()[0]
    torch.testing.assert_close(direct.step(batch)["loss"],
                               via.step(batch)["loss"], atol=0, rtol=0)
    with pytest.raises(ValueError, match="no 'seq' axis"):
        tseq.lower_sequence_parallel(tr, Mesh(shape={"data": 1}),
                                     device="cpu")


def test_builder_checks_match_jax(jparams):
    """The JAX builder's ValueErrors, in both packages: ``zero_stage``
    with ``zero1``, ZeRO with a compressor, the grad slot with a
    compressor, and a mesh without a seq axis."""
    from autodist_tpu.resource import ResourceSpec as JSpec
    from autodist_tpu.strategy.parallel_builders import (
        SequenceParallel as JSeq)

    bad = [(dict(zero_stage=1, zero1=True), "not both"),
           (dict(zero_stage=5), "zero_stage must be"),
           (dict(zero_stage=1, compressor="int8_ef"), "mutually exclusive"),
           (dict(collective_precision={"grad": "int8"},
                 compressor="int8_ef"), "not both")]
    for kw, match in bad:
        for builder in (JSeq, SequenceParallel):
            with pytest.raises(ValueError, match=match):
                builder(**kw)

    class Spec:
        def resolved_mesh_shape(self):
            return {"data": 2}

    with pytest.raises(ValueError, match="'seq' mesh axis"):
        SequenceParallel().build(_port_trainable(jparams), Spec())
    with pytest.raises(ValueError, match="'seq' mesh axis"):
        JSeq().build(_jax_trainable(), JSpec(
            {"topology": {"platform": "cpu", "num_devices": 2},
             "mesh": {"data": 2}}))


def _pipeline_accumulation_with_dropout():
    """``GradAccumulation`` over a ``Pipeline`` runs; the pipelined LM
    with dropout still raises (its per-row draws, ``stage_rng``)."""
    from autodist_tpu_torch.models.pipeline_lm import (
        make_pipeline_lm_trainable)

    cfg = port.TransformerConfig(**{**LM, "num_layers": 1,
                                    "dropout_rate": 0.1},
                                 dtype=torch.float32)
    tr = make_pipeline_lm_trainable(cfg, port.optim.sgd(LR),
                                    torch.Generator(), device="cpu")
    port.AutoDist({"mesh": {"data": 1, "pipe": 1, "model": 1}},
                  port.GradAccumulation(port.Pipeline(num_microbatches=1),
                                        2), device="cpu").build(tr)


def _ps_json(d, **sync):
    """The strategy JSON ``d`` with every node a PS synchronizer."""
    for node in d["node_configs"]:
        node["synchronizer"] = {"kind": "ps", **sync}
    return port.Strategy.from_json(json.dumps(d))


@pytest.mark.parametrize("what,item", [
    ("zero", "item 8: AsyncPSRunner"),
    ("zero1", "item 8: AsyncPSRunner"),
    ("zero_min_bytes", None),
    ("compressor", None),
    ("grad_precision", None),
    ("compressor_json", None),
    ("accum_json", "slice 3 leftovers"),
    ("dcn_axis", "item 9")])
def test_out_of_slice_options_raise(what, item, jparams):
    """What this slice does not run raises ``NotImplementedError``
    naming its ROADMAP item; ZeRO, compressors, the precision slots and
    accumulation run now.  The ZeRO cases hold the PS synchronizers the
    sequence lowering still refuses (asynchronous, stale); the
    accumulation case the pipelined LM's dropout; the rest (item
    ``None``) build: a ZeRO mix, and the slots this lowering has no
    boundary for, which its ``Lowered`` records as unapplied."""
    tr = _port_trainable(jparams)
    ad = port.AutoDist({"mesh": {"seq": 1}}, SequenceParallel(),
                       device="cpu")
    d = json.loads(ad.build_or_load_strategy(tr).to_json())
    if item is None:
        if what == "zero_min_bytes":
            low = port.AutoDist({"mesh": {"seq": 1}}, SequenceParallel(
                zero_min_bytes=1 << 10, compressor="bf16"),
                device="cpu").build(tr).lowered
            assert low.zero3_shapes == {} and low.unapplied == {}
            return
        if what == "compressor":
            builder = SequenceParallel(
                compressor="bf16_ef", collective_precision={"tp_psum": "bf16"})
            slots = {"tp_psum"}
        elif what == "grad_precision":
            builder = SequenceParallel(collective_precision={
                "grad": "bf16", "vocab_stats": "int8"})
            slots = {"vocab_stats"}
        else:
            d["node_configs"][0]["synchronizer"]["compressor"] = "bf16_ef"
            d["graph_config"]["precision"] = {"moe_a2a": "int8"}
            assert set(ad.lower(tr, port.Strategy.from_json(
                json.dumps(d))).unapplied) == {"moe_a2a"}
            return
        low = port.AutoDist({"mesh": {"seq": 1}}, builder,
                            device="cpu").build(tr).lowered
        assert set(low.unapplied) == slots
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1, {item}"):
        if what == "zero":
            ad.lower(tr, _ps_json(d, sync=False))
        elif what == "zero1":
            ad.lower(tr, _ps_json(d, staleness=2))
        elif what == "accum_json":
            _pipeline_accumulation_with_dropout()
        else:
            port.ResourceSpec({"mesh": {"dcn": 2, "seq": 2}})


def test_entry_points_default_to_the_card(jparams):
    """``device=None`` means CUDA: without a card the LM trainable and
    the sequence lowering raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.make_lm_trainable(_port_cfg("flash"), port.optim.sgd(LR),
                               torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.AutoDist({"mesh": {"seq": 1}}, SequenceParallel()).build(
            _port_trainable(jparams))
