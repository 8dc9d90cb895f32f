"""ZeRO in the port's sequence and expert lowerings against the JAX
package on the CPU.

Sequence: the causal ``TransformerLM`` of
``tests/test_torch_sequence_parallel.py`` (vocabulary 64, hidden 32, 2
heads, 1 layer, global sequence 32, batch 4, fp32, the einsum ring,
``global_positions``) trains 3 SGD steps on ``{"data": 2, "seq": 2}``
(4 gloo ranks) under ``SequenceParallel(zero_stage=1|2|3)``, ZeRO-3
with the ``zero3_gather`` slot at bf16 and at int8, the
``zero_min_bytes`` mix of ZeRO-1 and the bf16 compressor, and the
``int8_ring`` compressor over the joint ``data x seq`` group: the goldens
``test_sequence_zero1_matches_replicated_run_and_shards_state``,
``test_sequence_zero_min_bytes_mixes_per_variable`` and
``test_sequence_int8_ring_compressor_over_tuple_axes`` of
``tests/unit/test_parallel_zero.py``.

Expert: the MoE LM of ``tests/test_torch_moe.py`` (Adam, eps 1e-4)
trains 3 steps on ``{"data": 2, "expert": 2}`` under
``ExpertParallel(zero_stage=1|3)`` (replicated variables ZeRO over
``data x expert``, the expert tables degraded to plain sync with the JAX
lowering's record: ``test_expert_zero1_shards_replicated_state_only``),
the ``grad`` slot at bf16, which the expert lowering leaves unapplied as
the JAX lowering does (its own 1/E-scaled sync stands) and records, and
``compressor="bf16_ef"`` on the expert tables, whose error-feedback rows
are as wide as a rank's expert shard
(``test_expert_compressor_on_sharded_vars_sizes_ef_locally``).

Both sides start from the JAX trainables' weights and see the same numpy
batches; the port's ranks run in subprocesses started before the JAX
programs.  Each case checks the losses, the gathered params at their
logical shapes, the shape each rank stores of every parameter against
the JAX program's per-device shard shape, the compressor rows' widths and
the ``zero_degraded`` record.  Tolerances: 1e-5 where the wire is exact
(ZeRO reorders fp32 sums; the unapplied slot changes nothing); for a
narrowed gather or compressor the rule of
``tests/test_torch_pipeline_zero.py`` (``wire_misses``): every narrowed
sum here runs over 4 ranks, so each tensor within 3 wire units of its
update (one a rounding addition, whose order each package picks), the
losses within 3 units of their fall, and the lowering's fp32 program
apart from the narrowed one beyond fp32 noise.
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

import test_torch_pipeline_zero as h

LM = dict(vocab_size=64, hidden_size=32, num_layers=1, num_heads=2,
          mlp_dim=64, max_len=32, dropout_rate=0.0,
          attention_dropout_rate=0.0)
MOE = dict(vocab_size=64, hidden_size=16, num_layers=1, num_heads=2,
           expert_hidden=32, num_experts=4, capacity_factor=4.0, max_len=8)
MOE_BUILD = dict(num_experts=4, capacity_factor=4.0)
MOE_EPS = 1e-4
SEQ_MESH = {"data": 2, "seq": 2}
EXPERT_MESH = {"data": 2, "expert": 2}
STEPS, LR = 3, 0.5
TOL = dict(atol=1e-5, rtol=1e-5)

# name -> (lowering, builder keywords, wire or None)
CASES = {
    "seq_zero1": ("seq", dict(zero_stage=1), None),
    "seq_zero2": ("seq", dict(zero_stage=2), None),
    "seq_zero3": ("seq", dict(zero_stage=3), None),
    "seq_zero3_gather_bf16": ("seq", dict(zero_stage=3, collective_precision={
        "zero3_gather": "bf16"}), "bf16"),
    "seq_zero3_gather_int8": ("seq", dict(zero_stage=3, collective_precision={
        "zero3_gather": "int8"}), "int8"),
    "seq_zero_min_bytes": ("seq", dict(zero_min_bytes=4096,
                                       compressor="bf16"), "bf16"),
    "seq_int8_ring": ("seq", dict(compressor="int8_ring"), "int8"),
    "expert_zero1": ("expert", dict(zero_stage=1), None),
    "expert_zero3": ("expert", dict(zero_stage=3), None),
    "expert_grad_bf16": ("expert", dict(collective_precision={
        "grad": "bf16"}), None),
    "expert_bf16_ef": ("expert", dict(compressor="bf16_ef"), "bf16"),
}


def lm_batches():
    r = np.random.RandomState(1)
    out = []
    for _ in range(STEPS):
        x = r.randint(0, 64, (4, 32)).astype(np.int32)
        out.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return out


def moe_batches():
    r = np.random.RandomState(0)
    out = []
    for _ in range(STEPS):
        x = r.randint(0, 64, (8, 8)).astype(np.int32)
        out.append({"x": x, "y": np.roll(x, -1, axis=1)})
    return out


def jflat(tree):
    from autodist_tpu.capture import path_to_name

    return {path_to_name(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_lm(opt=None):
    """The JAX LM, initialized unsharded and applied with the einsum
    ring and ``global_positions``."""
    from autodist_tpu.capture import Trainable
    from autodist_tpu.models.transformer import (TransformerConfig,
                                                 TransformerLM, lm_loss_head)
    from autodist_tpu.parallel import ring_attention as jring
    from autodist_tpu.parallel.sequence import global_positions

    kw = dict(LM, dtype=jnp.float32)
    params = jax.jit(TransformerLM(TransformerConfig(**kw)).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32), jnp.int32))["params"]
    model = TransformerLM(TransformerConfig(
        **kw, attention_fn=jring.make_ring_attention_fn(causal=True),
        position_fn=global_positions))

    def loss_fn(p, batch):
        return lm_loss_head(model.apply({"params": p}, batch["x"]), batch)

    return Trainable.from_loss_fn(loss_fn, params, opt or optax.sgd(LR))


def jax_moe():
    from autodist_tpu.models.moe_transformer import (MoeConfig,
                                                     make_moe_lm_trainable)

    return make_moe_lm_trainable(
        MoeConfig(**MOE, dtype=jnp.float32), optax.adam(1e-2, eps=MOE_EPS),
        jax.random.PRNGKey(0), batch_size=8, seq_len=8)


def jax_run(case):
    """Losses, params, per-device shard shapes of the params and the
    compressor rows, the degradation record and the strategy JSON of the
    JAX package's program."""
    from autodist_tpu import AutoDist
    from autodist_tpu.capture import path_to_name
    from autodist_tpu.strategy.parallel_builders import (ExpertParallel,
                                                         SequenceParallel)

    kind, kw, _ = CASES[case]
    mesh = SEQ_MESH if kind == "seq" else EXPERT_MESH
    builder = (SequenceParallel(**kw) if kind == "seq"
               else ExpertParallel(**MOE_BUILD, **kw))
    runner = AutoDist({"topology": {"platform": "cpu", "num_devices": 4},
                       "mesh": mesh}, builder).build(
        jax_lm() if kind == "seq" else jax_moe())
    try:
        batches = lm_batches() if kind == "seq" else moe_batches()
        losses = [float(np.asarray(runner.step(b)["loss"])) for b in batches]

        def shards(tree):
            return {path_to_name(p): tuple(x.sharding.shard_shape(x.shape))
                    for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}

        return {"losses": losses, "params": jflat(runner.get_params()),
                "shards": shards(runner.state["params"]),
                "sync": shards(runner.state["sync_state"]),
                "degraded": dict(runner.lowered.zero_degraded or {}),
                "strategy": runner.strategy.to_json()}
    finally:
        runner.close()


# --------------------------------------------------------------------------- #
# 4 gloo ranks
# --------------------------------------------------------------------------- #
WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.kernel.common import flatten_with_names
    from autodist_tpu_torch.models import moe_transformer
    from autodist_tpu_torch.parallel import ring_attention, sequence
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)

    def trainable(kind, opt):
        if kind == "seq":
            cfg = port.TransformerConfig(
                **job["lm"], dtype=torch.float32,
                attention_fn=ring_attention.make_ring_attention_fn(
                    causal=True),
                position_fn=sequence.global_positions)
            tr = port.make_lm_trainable(
                cfg, port.optim.sgd(job["lr"]) if opt == "sgd"
                else port.optim.adam(1e-2), torch.Generator(), device="cpu")
            tr.params = job["params"]["seq"]
            return tr
        tr = moe_transformer.make_moe_lm_trainable(
            moe_transformer.MoeConfig(**job["moe"], dtype=torch.float32),
            port.optim.adam(1e-2, eps=job["eps"]),
            torch.Generator().manual_seed(0), batch_size=8, seq_len=8,
            device="cpu")
        tr.params = job["params"]["expert"]
        return tr

    res = {}
    for name, (kind, kw, opt) in job["cases"].items():
        builder = (port.SequenceParallel(**kw) if kind == "seq" else
                   port.ExpertParallel(**job["build"], **kw))
        runner = port.AutoDist({"mesh": job["meshes"][kind]}, builder,
                               device="cpu").build(trainable(kind, opt))
        losses = [float(runner.step(b)["loss"])
                  for b in job["batches"][kind]]
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

# Port-only: Adam's moments under ZeRO on the sequence LM.
ADAM = {"seq_zero1_adam": ("seq", dict(zero_stage=1), "adam"),
        "seq_zero3_adam": ("seq", dict(zero_stage=3), "adam")}
# Port-only: each lowering's fp32 program, which a narrowed wire must
# part from.
FP32 = {"seq": "seq_plain", "expert": "expert_plain"}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("zero_spmd")
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    cases = {nm: (kind, kw, "sgd") for nm, (kind, kw, _) in CASES.items()}
    cases.update(ADAM)
    cases.update({nm: (kind, {}, "sgd") for kind, nm in FP32.items()})
    torch.save({
        "cases": cases, "lm": LM, "moe": MOE, "build": MOE_BUILD,
        "eps": MOE_EPS, "lr": LR,
        "meshes": {"seq": SEQ_MESH, "expert": EXPERT_MESH},
        "params": {"seq": port.from_jax_params(
                       jax.tree.map(np.asarray, jax_lm().params),
                       device="cpu"),
                   "expert": port.from_jax_params(
                       jax.tree.map(np.asarray, jax_moe().params),
                       device="cpu")},
        "batches": {"seq": lm_batches(), "expert": moe_batches()}}, inp)
    join = testing.launch(WORKER, 4, (inp, out), tmp=tmp, timeout=400)

    def result():
        join()
        ranks = [torch.load(str(tmp / f"res{r}.pt"), weights_only=False)
                 for r in range(4)]
        return {name: [r[name] for r in ranks] for name in ranks[0]}

    return result


@pytest.fixture(scope="module")
def jax_runs(started):
    return {case: jax_run(case) for case in CASES}


@pytest.fixture(scope="module")
def port_runs(started, jax_runs):
    return started()


@pytest.fixture(scope="module")
def init():
    """The weights both packages start from, by lowering and name."""
    return {"seq": jflat(jax_lm().params), "expert": jflat(jax_moe().params)}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(port_runs, jax_runs, init, case):
    """Losses, gathered params at their logical shapes, each rank's
    stored shapes and compressor rows, and the degradation record,
    against the JAX program's (a narrowed wire by its bound, which the
    lowering's fp32 program must miss)."""
    kind, _, wire = CASES[case]
    ranks, want = port_runs[case], jax_runs[case]
    for r, got in enumerate(ranks):
        params = dict(flatten_with_names(got["params"]))
        assert set(params) == set(want["params"])
        for name, p in params.items():
            assert tuple(p.shape) == want["params"][name].shape, name
        if wire is None:
            np.testing.assert_allclose(got["losses"], want["losses"], **TOL)
            for name, p in params.items():
                np.testing.assert_allclose(p.numpy(), want["params"][name],
                                           err_msg=name, **TOL)
        else:
            # Every narrowed sum here spans data x seq or data x expert.
            h.assert_wire_matches(got, want, init[kind], wire,
                                  port_runs[FP32[kind]][r], 4)
        assert got["stored"] == want["shards"], f"rank {r}"
        assert {k: (1,) + v for k, v in got["sync_state"].items()} \
            == want["sync"], f"rank {r}"
        assert got["degraded"] == want["degraded"]


@pytest.mark.parametrize("case", ["seq_zero1", "seq_zero3",
                                  "seq_zero_min_bytes", "expert_zero3"])
def test_strategy_json_is_the_jax_builders(port_runs, jax_runs, case):
    """The builders emit the JAX builders' synchronizers (PS at the
    stage, the ``zero_min_bytes`` split on each variable's bytes): the
    strategy serializes to the JAX JSON (ids aside)."""
    text = jax_runs[case]["strategy"]
    mine = port_runs[case][0]["strategy"]
    assert mine.replace(json.loads(mine)["id"], json.loads(text)["id"],
                        1) == text


def test_zero3_stores_flat_shards(port_runs):
    """Sequence ZeRO-3: every variable is stored as its flat shard over
    the 4 ranks of ``data x seq`` (the 64 x 32 table as 512 elements)
    and gathered back to its logical shape."""
    got = port_runs["seq_zero3"][0]
    assert got["stored"]["token_embed/embedding"] == (512,)
    assert got["zero3_shapes"]["token_embed/embedding"] == (64, 32)
    assert set(got["zero3_shapes"]) == set(got["stored"])
    assert tuple(got["params"]["token_embed"]["embedding"].shape) == (64, 32)


@pytest.mark.parametrize("case", list(ADAM))
def test_adam_moments_are_the_flat_shard(port_runs, case):
    """Adam's moments of a ZeRO variable are its flat ``1/4`` shard: the
    optimizer state a rank holds is a quarter of the replicated one's,
    up to each variable's padding."""
    from autodist_tpu_torch.kernel.common import padded_flat_size

    got = port_runs[case][0]
    total = 0
    for nm, stored in got["stored"].items():
        logical = got["zero3_shapes"].get(nm, stored)
        size = int(np.prod(logical))
        want = (padded_flat_size(size, 4) // 4,)
        assert got["opt_state"][f"mu/{nm}"] == want, nm
        assert got["opt_state"][f"nu/{nm}"] == want, nm
        total += size
    assert sum(np.prod(got["opt_state"][f"mu/{nm}"])
               for nm in got["stored"]) * 4 < total * 1.05


def test_expert_tables_degrade_with_the_record(port_runs):
    """ZeRO on the expert tables degrades to plain sync (their state
    already shards with them over the expert axis): each rank stores its
    expert shard whole, the record names every table, and the
    replicated variables store ZeRO-3 flat shards."""
    got = port_runs["expert_zero3"][0]
    experts = [nm for nm in got["stored"] if "expert_w" in nm]
    assert experts and set(experts) <= set(got["degraded"])
    for nm in experts:
        assert nm not in got["zero3_shapes"]
    assert set(got["zero3_shapes"]) == set(got["stored"]) - set(
        got["degraded"])


def test_expert_grad_slot_is_recorded_unapplied(port_runs, jax_runs):
    """The expert lowering leaves the ``grad`` slot unapplied, as the JAX
    lowering does (its 1/E-scaled sync of the expert tables stands): no
    compressor row, the fp32 program's numbers, and the ``Lowered``
    says so."""
    got = port_runs["expert_grad_bf16"][0]
    assert got["sync_state"] == {}
    assert set(got["unapplied"]) == {"grad"}
    assert jax_runs["expert_grad_bf16"]["sync"] == {}
