"""Compressors, the ``"int8"`` precision string, remat, accumulation and
ZeRO's narrowed gathers in the port's pipeline lowering on ``{"data": 2,
"pipe": 2}`` (4 gloo ranks), against the JAX package on the CPU; and
the ``"int8"`` string on a pipe axis of 2 (2 ranks) with no data axis and
with one of size 1.

The pipelined LM of ``tests/test_torch_pipeline_zero.py`` (its harness
is shared) trains 3 SGD steps on both sides under
``Pipeline(num_microbatches=2, ...)`` with: ``compressor="bf16_ef"``;
``collective_precision="int8"``, the bare string ``bench.py quant``
passes, whose ``grad`` slot elects ``int8_ef`` over the data axis;
``remat=True``; ``GradAccumulation(Pipeline(...), 2)``; ZeRO-3 with the
``zero3_gather`` slot at bf16 and at int8; and the ``zero_min_bytes``
mix of ZeRO-3 and ``bf16_ef`` (``test_pipeline_zero_stages_with_bf16_ef
_mix``).  The goldens' MLP pipeline with 7-wide layers (a chunk of 49
and 7 elements, which the data axis's 2 ranks do not divide) trains
under ZeRO-3 and Adam (``test_pipeline_zero3_non_divisible_leaf
_padding``).

Tolerances: 1e-5 (absolute and relative) where the wire is exact (ZeRO,
remat, accumulation); for a narrowed wire (bf16 2^-8, int8 2/127) the
rule of ``wire_misses`` in ``tests/test_torch_pipeline_zero.py``: each
tensor within a quarter of a unit of its update where the narrowed sums
run over the data axis's 2 ranks (order-free), the losses within as
much of their fall, and the fp32 program outside that bound; 3 units
where a narrowed sum spans pipe x data.  Remat is also held to the plain
program bit for bit, and each compressor's state rows to the JAX
program's row widths.
"""
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch.kernel.common import flatten_with_names

import test_torch_pipeline_zero as h

MESH = h.DP2_PP2
M2 = dict(num_microbatches=2)
MIX = dict(M2, zero_stage=3, zero_min_bytes=512, compressor="bf16_ef")

# name -> (Pipeline keywords, accumulation steps, wire or None)
CASES = {
    "compressor": (dict(M2, compressor="bf16_ef"), 1, "bf16"),
    "int8": (dict(M2, collective_precision="int8"), 1, "int8"),
    "remat": (dict(M2, remat=True), 1, None),
    "accum2": (M2, 2, None),
    "zero3_gather_bf16": (dict(M2, zero_stage=3, collective_precision={
        "zero3_gather": "bf16"}), 1, "bf16"),
    "zero3_gather_int8": (dict(M2, zero_stage=3, collective_precision={
        "zero3_gather": "int8"}), 1, "int8"),
    "zero3_mix": (MIX, 1, "bf16"),
}
HID = 7
# The cases whose narrowed sums span more than the data axis's 2 ranks:
# the shared leaves' gathers scatter back over pipe x data.
SUM_RANKS = {"zero3_gather_bf16": 4, "zero3_gather_int8": 4}


def mlp_params():
    r = np.random.RandomState(0)
    return {"w": (r.randn(2, HID, HID) * 0.5).astype(np.float32),
            "b": (r.randn(2, HID) * 0.1).astype(np.float32)}


def mlp_batches():
    r = np.random.RandomState(2)
    return [{"x": r.randn(8, HID).astype(np.float32),
             "y": r.randn(8, HID).astype(np.float32)}
            for _ in range(h.STEPS)]


def jax_mlp():
    import jax
    import jax.numpy as jnp
    from autodist_tpu import PipelineTrainable

    def stage(params, x):
        return jax.nn.relu(x @ params["w"] + params["b"])

    def head(outputs, batch):
        return jnp.mean((outputs - batch["y"]) ** 2), {}

    return PipelineTrainable(stage, jax.tree.map(jnp.asarray, mlp_params()),
                             head, optax.adam(1e-2), num_stages=2)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    import jax

    params = {"lm": port.from_jax_params(
                  jax.tree.map(np.asarray, h.jax_lm(optax.sgd(h.LR)).params),
                  device="cpu"),
              "mlp": {k: torch.as_tensor(v) for k, v in mlp_params().items()}}
    batches = {"lm": [h.batch(i) for i in range(h.STEPS)],
               "mlp": mlp_batches()}
    cases = {nm: h.lm_case(MESH, kw, accum)
             for nm, (kw, accum, _) in CASES.items()}
    cases["plain"] = h.lm_case(MESH, M2)
    cases["mlp_zero3"] = dict(mesh=MESH, kw=dict(M2, zero_stage=3),
                              accum=1, model="mlp", opt="adam")
    return h.start_gloo(cases, params, batches,
                        tmp_path_factory.mktemp("pipe_opts") / "w4", 4)


# The "int8" string on a pipe axis of 2 (2 ranks): without a data axis
# (the mesh factor_3d gives bench.py quant at data 1) and with a data
# axis of size 1 (chip_smoke.py's phase 7 mesh).
INT8_PIPE = {"pipe2_int8": {"pipe": 2}, "data1_pipe2_int8": {"data": 1,
                                                             "pipe": 2}}


@pytest.fixture(scope="module")
def started2(tmp_path_factory):
    import jax

    params = {"lm": port.from_jax_params(
        jax.tree.map(np.asarray, h.jax_lm(optax.sgd(h.LR)).params),
        device="cpu")}
    cases = {nm: h.lm_case(mesh, dict(M2, collective_precision="int8"))
             for nm, mesh in INT8_PIPE.items()}
    return h.start_gloo(cases, params,
                        {"lm": [h.batch(i) for i in range(h.STEPS)]},
                        tmp_path_factory.mktemp("pipe_opts") / "w2", 2)


@pytest.fixture(scope="module")
def jax_runs(started, started2):
    runs = {nm: h.jax_run(MESH, kw, accum)
            for nm, (kw, accum, _) in CASES.items()}
    runs["mlp_zero3"] = h.jax_run(MESH, dict(M2, zero_stage=3),
                                  trainable=jax_mlp(),
                                  batches=mlp_batches())
    runs.update({nm: h.jax_run(mesh, dict(M2, collective_precision="int8"))
                 for nm, mesh in INT8_PIPE.items()})
    return runs


@pytest.fixture(scope="module")
def port_runs(started, started2, jax_runs):
    runs = {}
    for job in (started, started2):
        ranks = job()
        runs.update({name: [r[name] for r in ranks] for name in ranks[0]})
    return runs


@pytest.fixture(scope="module")
def init():
    """The weights both packages start from, by name."""
    return h.jflat(h.jax_lm(optax.sgd(h.LR)).params)


@pytest.mark.parametrize("case", [*CASES, "mlp_zero3"])
def test_options_match_jax(port_runs, jax_runs, init, case):
    """Losses, gathered params at their logical shapes and each rank's
    stored shapes against the JAX program's: 1e-5 for an exact wire; a
    narrowed one by the wire's bound, which the same mesh's fp32
    program (``plain``) must miss."""
    wire = CASES[case][2] if case in CASES else None
    ranks, want = port_runs[case], jax_runs[case]
    for r, got in enumerate(ranks):
        if wire is None:
            h.assert_matches(got, want)
        else:
            h.assert_wire_matches(got, want, init, wire,
                                  port_runs["plain"][r],
                                  SUM_RANKS.get(case, 2))
    h.assert_stored_like_jax(ranks, want)
    assert ranks[0]["degraded"] == want["degraded"] == {}


def test_mlp_zero3_pads_each_chunk(port_runs):
    """A 7 x 7 chunk (49 elements) pads to 50 over the 2 data ranks: each
    rank stores a ``[1, 25]`` row and its bias a ``[1, 4]`` one, and
    ``get_params`` returns the unpadded ``[2, 7, 7]``."""
    got = port_runs["mlp_zero3"][0]
    assert got["stored"] == {"b": (1, 4), "w": (1, 25)}
    assert got["zero3_shapes"] == {"b": (2, HID), "w": (2, HID, HID)}
    assert tuple(got["params"]["w"].shape) == (2, HID, HID)


def test_remat_is_the_plain_program(port_runs):
    """Remat recomputes each stage call in the backward: the same
    losses and params as the plain program, bit for bit."""
    a, b = port_runs["remat"][0], port_runs["plain"][0]
    assert a["losses"] == b["losses"]
    for (n, x), (_, y) in zip(flatten_with_names(a["params"]),
                              flatten_with_names(b["params"])):
        assert torch.equal(x, y), n


@pytest.mark.parametrize("case", ["compressor", "int8", "zero3_mix"])
def test_compressor_rows_are_the_jax_programs(port_runs, jax_runs, case):
    """Every compressed variable keeps one state row a rank, as wide as
    its local gradient: the same variables and widths as the JAX
    program's per-device rows (the mix's: its small variables only)."""
    want = jax_runs[case]["sync"]
    assert want
    for got in port_runs[case]:
        assert {k: (1,) + v for k, v in got["sync_state"].items()} == want


def test_int8_string_fills_every_slot(port_runs):
    """The bare ``"int8"`` string elects ``int8_ef`` for every variable
    (a stateful row each) and records nothing as unapplied: the mesh
    has a data axis."""
    got = port_runs["int8"][0]
    assert set(got["sync_state"]) == set(got["stored"])
    assert got["unapplied"] == {}


def test_pipe_only_mesh_records_its_unapplied_compressors(port_runs,
                                                          jax_runs):
    """A mesh without a data axis has nothing to compress over: the
    ``"int8"`` string's ``grad`` slot runs no compressor, as in the JAX
    package (which logs it), and the ``Lowered`` records every
    variable's; the rest of the string has no boundary there (no model
    axis), so both packages train the fp32 program (1e-5)."""
    ranks, want = port_runs["pipe2_int8"], jax_runs["pipe2_int8"]
    for got in ranks:
        h.assert_matches(got, want)
        assert got["sync_state"] == {} and want["sync"] == {}
        assert set(got["unapplied"]) == set(got["stored"])


def test_a_data_axis_of_one_keeps_the_grad_slot(port_runs, jax_runs, init):
    """A declared data axis of size 1 stays in the mesh, and the
    ``grad`` slot's ``int8_ef`` runs over it (one rank: the gradient is
    quantized, the residual kept), in both packages alike: a state row
    for every variable, the int8 wire's tolerance."""
    assert port.ResourceSpec({"mesh": {"data": 1, "pipe": 2}}).mesh_shape \
        == {"data": 1, "pipe": 2}
    ranks = port_runs["data1_pipe2_int8"]
    want = jax_runs["data1_pipe2_int8"]
    for r, got in enumerate(ranks):
        h.assert_wire_matches(got, want, init, "int8",
                              port_runs["pipe2_int8"][r])
        assert {k: (1,) + v for k, v in got["sync_state"].items()} \
            == want["sync"]
        assert set(got["sync_state"]) == set(got["stored"])
        assert got["unapplied"] == {}
