"""Expert-parallel training of the MoE LM through ``ExpertParallel``,
against the JAX package on the CPU.

The JAX package's tiny golden config (vocabulary 64, hidden 16, 1 layer,
2 heads, expert hidden 32, 4 experts, capacity factor 4.0, length 8,
batch 8, fp32) is built by the JAX package; its weights are carried into
the port bit for bit and both sides train 3 Adam steps on the same numpy
batches in four programs: fp32, the composed bf16 and int8 exchanges,
and the ``a2a_ring`` kernel.  The port runs on 2 gloo ranks (``{"expert":
2}``) and on 4 (``{"data": 2, "expert": 2}``) in subprocesses, started
before the JAX runs so that the two run side by side.  Tolerances: the
fp32 and bf16 programs 1e-5 (the same arithmetic in other summation
orders; bf16 rounds the same values to nearest even in both), the int8
programs 1e-4 relative on the losses and 1e-4 on the params.  The
gradient compressors (``compressor="bf16_ef"`` and ``"int8_ef"``, each
variable with its own error-feedback row) and ``GradAccumulation(...,
2)`` run as further programs, the compressors to twice the wire's unit
of each tensor's update (a bf16 sum of 4 ranks parts by its order; an
int8 level by the residual's rounding).  The
port's hop rounds as the JAX package's host mirror of the ring does,
and no rounding of the int8 programs flips against XLA's compiled
Pallas hop at this size: their final params agree to 1e-6.
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
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models import moe_transformer as tmoe
from autodist_tpu_torch.parallel import moe as tm
from autodist_tpu_torch.strategy.parallel_builders import ExpertParallel

SIZES = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
             expert_hidden=32, num_experts=4, capacity_factor=4.0,
             max_len=8)
INT8 = {"moe_a2a": "int8"}
PROGRAMS = {
    "fp32": {},
    "bf16": dict(collective_precision={"moe_a2a": "bf16"}),
    "int8": dict(collective_precision=INT8),
    "a2a_ring": dict(collective_precision=INT8, kernel=("a2a_ring",)),
    "bf16_ef": dict(compressor="bf16_ef"),
    "int8_ef": dict(compressor="int8_ef"),
    "accum2": dict(accum=2),
}
# Programs whose sums part by more than fp32 summation order: int8
# levels, and the bf16 and int8 gradient wires of the compressors.
NARROW = ("int8", "a2a_ring", "bf16_ef", "int8_ef")
BUILD = dict(num_experts=4, capacity_factor=4.0)
# Adam's eps: the k projection's bias has an exactly zero gradient (a
# softmax does not see a shift of every score), and at eps 1e-8 Adam
# blows its summation-order noise up to learning-rate-sized steps that
# differ between any two implementations.
EPS = 1e-4
STEPS = 3
TOL = dict(atol=1e-5, rtol=1e-5)
INT8_RTOL = 1e-4
MESH2 = {"expert": 2}
MESH4 = {"data": 2, "expert": 2}


def _batches():
    r = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        x = r.randint(0, 64, (8, 8)).astype(np.int32)
        out.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return out


def _jax_trainable(expert_sharded=True):
    from autodist_tpu.models.moe_transformer import (MoeConfig,
                                                     make_moe_lm_trainable)

    return make_moe_lm_trainable(
        MoeConfig(**SIZES, dtype=jnp.float32), optax.adam(1e-2, eps=EPS),
        jax.random.PRNGKey(0), batch_size=8, seq_len=8,
        expert_sharded=expert_sharded)


def _jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_spec(mesh):
    return {"topology": {"platform": "cpu",
                         "num_devices": int(np.prod(list(mesh.values())))},
            "mesh": mesh}


def _jax_run(mesh, program):
    """Losses, nlls, final params and strategy JSON of the JAX package's
    program."""
    from autodist_tpu import AutoDist, GradAccumulation
    from autodist_tpu.strategy.parallel_builders import (
        ExpertParallel as JExpertParallel)

    kw = dict(PROGRAMS[program])
    accum = kw.pop("accum", 1)
    builder = JExpertParallel(**BUILD, **kw)
    if accum > 1:
        builder = GradAccumulation(builder, accum)
    runner = AutoDist(_jax_spec(mesh), builder).build(_jax_trainable())
    try:
        ms = [runner.step(b) for b in _batches()]
        return ({k: [float(np.asarray(m[k])) for m in ms]
                 for k in ("loss", "nll")},
                _jflat(runner.get_params()), runner.strategy.to_json())
    finally:
        runner.close()


@pytest.fixture(scope="module")
def jparams():
    return jax.tree.map(np.asarray, _jax_trainable().params)


def _tcfg():
    return tmoe.MoeConfig(**SIZES, dtype=torch.float32)


def _port_trainable(jparams, expert_sharded=True, device="cpu"):
    tr = tmoe.make_moe_lm_trainable(
        _tcfg(), port.optim.adam(1e-2, eps=EPS),
        torch.Generator().manual_seed(0), batch_size=8, seq_len=8,
        expert_sharded=expert_sharded, device=device)
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
    from autodist_tpu_torch.models import moe_transformer
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    res = {}
    for name, kw in job["programs"].items():
        tr = moe_transformer.make_moe_lm_trainable(
            moe_transformer.MoeConfig(**job["sizes"], dtype=torch.float32),
            port.optim.adam(1e-2, eps=job["eps"]),
            torch.Generator().manual_seed(0), batch_size=8, seq_len=8,
            device="cpu")
        tr.params = job["params"]
        kw = dict(kw)
        accum = kw.pop("accum", 1)
        builder = port.ExpertParallel(**job["build"], **kw)
        if accum > 1:
            builder = port.GradAccumulation(builder, accum)
        runner = port.AutoDist({"mesh": job["mesh"]}, builder,
                               device="cpu").build(tr)
        ms = [runner.step(b) for b in job["batches"]]
        res[name] = {"loss": [float(m["loss"]) for m in ms],
                     "nll": [float(m["nll"]) for m in ms],
                     "params": runner.get_params(),
                     "strategy": runner.strategy.to_json(),
                     "local": {k: tuple(v.shape) for k, v in
                               runner.state["params"].items()}}
    if rank == 0:
        torch.save(res, out)
    testing.end_rank()
""")


def _start(world, mesh, params, tmp):
    tmp = tmp / f"job{world}"
    tmp.mkdir()
    inp, out = tmp / "job.pt", tmp / "res.pt"
    torch.save({"programs": PROGRAMS, "sizes": SIZES, "mesh": mesh,
                "build": BUILD, "params": params, "batches": _batches(),
                "eps": EPS}, inp)
    join = testing.launch(_WORKER, world, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return torch.load(out, weights_only=False)

    return result


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    """Both gloo jobs, started side by side before the JAX runs; each is
    joined by its own fixture."""
    tmp = tmp_path_factory.mktemp("moe")
    params = port.from_jax_params(jparams, device="cpu")
    return {2: _start(2, MESH2, params, tmp), 4: _start(4, MESH4, params,
                                                        tmp)}


@pytest.fixture(scope="module")
def jax_runs(started):
    """The JAX package's programs, keyed ``(world, program)``."""
    return {(w, p): _jax_run(mesh, p)
            for w, mesh in ((2, MESH2), (4, MESH4)) for p in PROGRAMS}


@pytest.fixture(scope="module")
def port2(started, jax_runs):
    return started[2]()


@pytest.fixture(scope="module")
def port4(started, jax_runs):
    return started[4]()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("program", list(PROGRAMS))
def test_training_matches_jax(request, jax_runs, world, program):
    """Each program's losses, nlls and final full params (gathered over
    the expert axis) against the JAX package's same program."""
    got = request.getfixturevalue(f"port{world}")[program]
    jm, jfinal, _ = jax_runs[(world, program)]
    if program in ("bf16_ef", "int8_ef"):
        # A bf16 sum of 4 ranks parts by its order, an int8 level by
        # the residual's rounding: the runs agree to twice the wire's
        # unit of each tensor's update (in L2 norm: Adam turns one
        # element's near-zero gradient's rounding into a whole step) and
        # of the loss's fall.
        unit = 2 * {"bf16_ef": 2.0 ** -8, "int8_ef": 1 / 127}[program]
        init = _jflat(request.getfixturevalue("jparams"))
        for name, p in flatten_with_names(got["params"]):
            moved = np.linalg.norm(jfinal[name] - init[name])
            assert np.linalg.norm(p.numpy() - jfinal[name]) \
                <= unit * moved + 1e-7, name
        for k in ("loss", "nll"):
            assert np.all(np.abs(np.subtract(got[k], jm[k]))
                          <= unit * np.abs(np.subtract(jm[k], jm[k][0]))
                          + 1e-6), k
        return
    int8 = program in NARROW
    for k in ("loss", "nll"):
        np.testing.assert_allclose(got[k], jm[k], **(
            dict(atol=0, rtol=INT8_RTOL) if int8 else TOL))
    for name, p in flatten_with_names(got["params"]):
        np.testing.assert_allclose(
            p.numpy(), jfinal[name], err_msg=name,
            **(dict(atol=1e-4, rtol=INT8_RTOL) if int8 else TOL))


def test_int8_programs_have_no_rounding_flip(port2, jax_runs):
    """No int8 level rounds the other way between the port's hop and
    the Pallas hop XLA compiles: the final params agree to 1e-6."""
    for program in ("int8", "a2a_ring"):
        _, jfinal, _ = jax_runs[(2, program)]
        for name, p in flatten_with_names(port2[program]["params"]):
            np.testing.assert_allclose(p.numpy(), jfinal[name],
                                       atol=1e-6, rtol=1e-6, err_msg=name)


def test_expert_tables_are_stored_sharded(port4):
    """Each rank stores its ``E / 2`` experts; the gate and the rest are
    replicated."""
    local = port4["fp32"]["local"]
    assert local["layer_0_moe/expert_wi"] == (2, 16, 32)
    assert local["layer_0_moe/expert_wo"] == (2, 32, 16)
    assert local["layer_0_moe/expert_gate"] == (16, 4)


def test_programs_track_the_dense_reference(port2, port4):
    """Every program's nll trajectory stays within the JAX golden's 5e-3
    of the dense one-process run (``expert_sharded=False`` through
    ``AllReduce``) on the same weights and batches."""
    from autodist_tpu import AutoDist

    runner = AutoDist({"topology": {"platform": "cpu", "num_devices": 1}},
                      "AllReduce").build(_jax_trainable(False))
    dense = [float(np.asarray(runner.step(b)["nll"])) for b in _batches()]
    runner.close()
    for runs in (port2, port4):
        for program, got in runs.items():
            np.testing.assert_allclose(got["nll"], dense, atol=5e-3,
                                       err_msg=program)


@pytest.mark.parametrize("program", list(PROGRAMS))
def test_strategy_json_is_the_jax_builders(port2, jax_runs, program):
    """The port's ``ExpertParallel`` strategy serializes to the JAX
    builder's JSON byte for byte (ids aside), and the JAX JSON reads
    back into the port and re-emits the same bytes."""
    text = jax_runs[(2, program)][2]
    mine = port2[program]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text
    assert port.Strategy.from_json(text).to_json() == text


def test_dense_loss_and_grads_match_jax(jparams):
    """The dense MoE LM's loss, metrics and every gradient against the
    JAX trainable's (``expert_sharded=False``)."""
    jtr = _jax_trainable(False)
    batch = _batches()[1]
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtr.loss(p, None, batch, None)[::2], has_aux=True)(
        jtr.params)
    tr = _port_trainable(jparams, expert_sharded=False)
    leaves = {n: t.clone().requires_grad_()
              for n, t in flatten_with_names(tr.params)}
    loss, _, metrics = tr.loss(unflatten(leaves), None,
                               {k: torch.as_tensor(v)
                                for k, v in batch.items()}, None)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    np.testing.assert_allclose(float(loss), float(jl), **TOL)
    for k in ("nll", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **TOL)
    jg = _jflat(jg)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jg[name], **TOL, err_msg=name)


def test_interop_round_trips_the_moe_tree(jparams):
    """The MoE tree converts leaf for leaf both ways, bit for bit, and a
    tree with a leaf missing is refused."""
    tree = port.from_jax_params(jparams, device="cpu")
    back = port.to_jax_params(tree)
    for name, a in _jflat(jparams).items():
        np.testing.assert_array_equal(dict(flatten_with_names(back))[name], a)
    flat = dict(flatten_with_names(jparams))
    flat.pop("layer_0_moe/expert_wo")
    with pytest.raises(ValueError, match="expert_wo"):
        port.from_jax_params(unflatten(flat), device="cpu")


def test_top2_gating_matches_jax():
    """``top2_gating`` against the JAX function on the same logits at
    1e-6, with ties, and with capacity drops."""
    from autodist_tpu.parallel.moe import top2_gating

    r = np.random.RandomState(3)
    cases = [(r.randn(32, 8).astype(np.float32), 8),
             (r.randn(32, 8).astype(np.float32), 4),
             (np.tile([[5.0, 1.0, 0.0, 0.0]], (6, 1)).astype(np.float32), 1),
             (np.zeros((5, 4), np.float32), 4)]
    for logits, cap in cases:
        jd, jc, ja = top2_gating(jnp.asarray(logits), cap)
        d, c, a = tm.top2_gating(torch.as_tensor(logits), cap)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(float(a), float(ja), atol=1e-6, rtol=1e-6)


def test_dense_reference_matches_jax():
    """``dense_moe_reference`` and ``expert_parallel_ffn`` on a one-rank
    expert axis against the JAX functions at 1e-6."""
    from autodist_tpu.parallel.moe import dense_moe_reference

    r = np.random.RandomState(5)
    tokens = r.randn(16, 16).astype(np.float32)
    gate, wi, wo = (r.randn(16, 4).astype(np.float32) * 0.5,
                    r.randn(4, 16, 32).astype(np.float32) * 0.2,
                    r.randn(4, 32, 16).astype(np.float32) * 0.2)
    jo, ja = dense_moe_reference(*map(jnp.asarray, (tokens, gate, wi, wo)), 8)
    to = [torch.as_tensor(a) for a in (tokens, gate, wi, wo)]
    o, a = tm.dense_moe_reference(*to, 8)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(float(a), float(ja), atol=1e-6, rtol=1e-6)
    from autodist_tpu_torch.parallel.axis import Axis

    # capacity ceil(2 * 16 * 1.0 / 4) = 8, the dense call's
    o1, a1 = tm.expert_parallel_ffn(*to, Axis("expert"), capacity_factor=1.0)
    torch.testing.assert_close(o1, o, atol=0, rtol=0)


def test_builder_checks_match_jax():
    """The JAX builder's ValueErrors, in both packages."""
    from autodist_tpu.strategy.parallel_builders import (
        ExpertParallel as JExpert)

    bad = [(dict(kernel=("a2a_ring",)), "moe_a2a slot at 'int8'"),
           (dict(collective_precision={"moe_a2a": "bf16"},
                 kernel=("a2a_ring",)), "moe_a2a slot at 'int8'"),
           (dict(kernel=("quant_ring",)), "tensor-parallel ring"),
           (dict(collective_precision=INT8, kernel=("a2a_ring",),
                 expert_over_dcn=True), "cannot span"),
           (dict(capacity_factor=0), "capacity_factor"),
           (dict(zero_stage=1, zero1=True), "not both"),
           (dict(zero_stage=5), "zero_stage must be"),
           (dict(zero_stage=1, compressor="int8_ef"), "mutually exclusive"),
           (dict(collective_precision={"grad": "int8"},
                 compressor="int8_ef"), "not both")]
    for kw, match in bad:
        for builder in (JExpert, ExpertParallel):
            with pytest.raises(ValueError, match=match):
                builder(**kw)


def test_build_checks_the_mesh_and_the_trainable(jparams):
    """No expert axis, experts that do not divide it, names that match
    nothing: the JAX builder's errors."""
    from autodist_tpu.resource import ResourceSpec as JSpec
    from autodist_tpu.strategy.parallel_builders import (
        ExpertParallel as JExpert)

    class Spec:
        """A resolved mesh of two ranks without a process group."""

        def __init__(self, shape):
            self.shape = shape

        def resolved_mesh_shape(self):
            return dict(self.shape)

    tr, jtr = _port_trainable(jparams), _jax_trainable()
    cases = [({"data": 1}, {}, "'expert' mesh axis"),
             ({"expert": 2}, dict(num_experts=3), "must divide"),
             ({"expert": 2}, dict(expert_params=("nope",)), "matched no"),
             ({"expert": 2}, dict(detect=False), "no expert variables")]
    for mesh, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            ExpertParallel(**kw).build(tr, Spec(mesh))
        with pytest.raises(ValueError, match=match):
            JExpert(**kw).build(jtr, JSpec(_jax_spec(mesh)))
    # A gate named explicitly shards on its leading dim, as in JAX.
    s = ExpertParallel(expert_params=("layer_0_moe/expert_gate",)).build(
        tr, Spec({"expert": 2}))
    specs = {nc.var_name: nc.partitioner.spec for nc in s.node_configs
             if nc.partitioner}
    assert specs == {"layer_0_moe/expert_gate": ["expert", None],
                     "layer_0_moe/expert_wi": ["expert", None, None],
                     "layer_0_moe/expert_wo": ["expert", None, None]}


def test_lowering_binds_the_wire_election(jparams):
    """The lowering writes the strategy's ``moe_a2a`` precision and
    ``a2a_ring`` election into the trainable's slot, and refuses an
    election for a trainable without one."""
    tr = _port_trainable(jparams)
    port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel(
        collective_precision=INT8, kernel=("a2a_ring",)),
        device="cpu").build(tr)
    assert tr.moe_a2a == {"precision": "int8", "kernel": True}
    del tr.moe_a2a
    with pytest.raises(ValueError, match="no moe_a2a binding slot"):
        port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel(
            collective_precision=INT8), device="cpu").build(tr)


@pytest.mark.parametrize("program", ["fp32", "a2a_ring"])
def test_one_rank_expert_axis_trains_as_the_dense_model(jparams, program):
    """``{"expert": 1}``: the sharded model on one process trains as the
    dense model does through ``AllReduce``, step for step (a one-rank
    ring is the identity, as in the JAX package)."""
    a = port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel(
        **PROGRAMS[program]), device="cpu").build(_port_trainable(jparams))
    b = port.AutoDist({}, port.AllReduce(), device="cpu").build(
        _port_trainable(jparams, expert_sharded=False))
    for batch in _batches():
        torch.testing.assert_close(a.step(batch)["loss"],
                                   b.step(batch)["loss"], atol=0, rtol=0)
    for (n, x), (_, y) in zip(flatten_with_names(a.get_params()),
                              flatten_with_names(b.get_params())):
        torch.testing.assert_close(x, y, atol=0, rtol=0, msg=n)


@pytest.mark.parametrize("what", ["zero", "zero1", "zero_min_bytes",
                                  "compressor", "grad_precision",
                                  "expert_over_dcn", "accum_json",
                                  "seq_axis"])
def test_out_of_slice_options_raise(what, jparams):
    """Every case these tests once refused runs now.  ZeRO, compressors,
    the ``grad`` slot and accumulation run: the ZeRO cases hold the PS
    synchronizers beyond plain ZeRO (an asynchronous one raises in the
    JAX package's words, a stale one lowers with its bound), the
    compressor case a compressor beside ``expert_over_dcn`` (the JAX
    builder's strategy), ``expert_over_dcn`` its slice checks, the
    ``seq_axis`` case a ``dcn`` axis beside the expert axis;
    ``zero_min_bytes`` and
    the ``grad`` slot build, and the ``Lowered`` records what they did
    (the expert tables' degraded ZeRO, the unapplied slot), and the
    accumulation case steps the pipelined LM with dropout."""
    tr = _port_trainable(jparams)
    ad = port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel(**BUILD),
                       device="cpu")
    if what == "zero_min_bytes":
        low = port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel(
            **BUILD, zero_min_bytes=0), device="cpu").build(tr).lowered
        assert set(low.zero_degraded) == {
            nm for nm in low.plan.expert_vars}
        return
    if what == "grad_precision":
        low = port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel(
            **BUILD, collective_precision={"grad": "bf16"}),
            device="cpu").build(tr).lowered
        assert set(low.unapplied) == {"grad"}
        return
    if what == "accum_json":
        from autodist_tpu_torch.models.pipeline_lm import (
            make_pipeline_lm_trainable)

        cfg = port.TransformerConfig(
            vocab_size=16, hidden_size=8, num_layers=1, num_heads=2,
            mlp_dim=16, max_len=8, dtype=torch.float32,
            dropout_rate=0.1, attention_dropout_rate=0.0)
        runner = port.AutoDist(
            {"mesh": {"data": 1, "pipe": 1, "model": 1}},
            port.GradAccumulation(port.Pipeline(num_microbatches=1), 2),
            device="cpu").build(make_pipeline_lm_trainable(
                cfg, port.optim.sgd(0.1), torch.Generator(), device="cpu"))
        x = np.random.RandomState(0).randint(0, 16, (4, 8))
        assert np.isfinite(float(runner.step({"x": x, "y": x},
                                             rng=3)["loss"]))
        return
    d = json.loads(ad.build_or_load_strategy(tr).to_json())
    if what in ("zero", "zero1"):
        for node in d["node_configs"]:
            node["synchronizer"] = {"kind": "ps", "sync": what != "zero",
                                    "staleness": int(what == "zero1")}
        strategy = port.Strategy.from_json(json.dumps(d))
        if what == "zero1":
            assert ad.lower(tr, strategy).ssp_staleness == 1
            return
        with pytest.raises(NotImplementedError,
                           match=r"sync=False.*AsyncPSRunner"):
            ad.lower(tr, strategy)
        return
    from autodist_tpu.resource import ResourceSpec as JResourceSpec
    from autodist_tpu.strategy.parallel_builders import \
        ExpertParallel as JExpertParallel

    sliced = {"topology": {"num_devices": 2, "num_slices": 2},
              "mesh": {"expert": 2}}
    if what == "compressor":
        # A compressor beside expert_over_dcn: the JAX builder's strategy.
        kw = dict(BUILD, compressor="bf16_ef", expert_over_dcn=True)
        mine = ExpertParallel(**kw).build(tr, port.ResourceSpec(sliced))
        theirs = JExpertParallel(**kw).build(_jax_trainable(),
                                             JResourceSpec(sliced))
        assert json.loads(mine.to_json()) == {
            **json.loads(theirs.to_json()), "id": mine.id}
    elif what == "expert_over_dcn":
        # It builds on two slices; a single-slice spec and the a2a_ring
        # kernel raise the JAX package's errors.
        assert ExpertParallel(**BUILD, expert_over_dcn=True).build(
            tr, port.ResourceSpec(sliced)).graph_config.parallel[
            "expert_over_dcn"]
        single = {"topology": {"num_devices": 2}, "mesh": {"expert": 2}}
        for build, spec in (((ExpertParallel, tr), port.ResourceSpec),
                            ((JExpertParallel, _jax_trainable()),
                             JResourceSpec)):
            with pytest.raises(ValueError, match="spans slices, but the "
                               "spec resolves single-slice"):
                build[0](**BUILD, expert_over_dcn=True).build(
                    build[1], spec(single))
            with pytest.raises(ValueError, match="cannot span slices"):
                build[0](expert_over_dcn=True, kernel=("a2a_ring",),
                         collective_precision=INT8)
    else:
        # A dcn axis beside the expert axis: the replica count folds it.
        mine = ExpertParallel(**BUILD).build(tr, port.ResourceSpec(
            {"topology": {"num_devices": 4}, "mesh": {"dcn": 2,
                                                      "expert": 2}}))
        assert mine.graph_config.replicas == 2


def test_entry_points_default_to_the_card(jparams):
    """``device=None`` means CUDA: without a card the MoE trainable and
    the expert lowering raise instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmoe.make_moe_lm_trainable(_tcfg(), port.optim.adam(1e-2),
                                   torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.AutoDist({"mesh": {"expert": 1}}, ExpertParallel()).build(
            _port_trainable(jparams))
