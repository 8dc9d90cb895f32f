"""Compressors, the ``"int8"`` precision string, remat and accumulation
in the port's pipeline lowering with tensor parallelism inside the
stages, on ``{"data": 2, "pipe": 2, "model": 2}`` (8 gloo ranks) with
and without ``vocab_parallel``, against the JAX package on the CPU.

The pipelined LM and the harness of ``tests/test_torch_pipeline_zero.py``;
3 SGD steps on both sides under ``Pipeline(num_microbatches=2,
tensor_parallel=2, ...)`` with ``compressor="bf16_ef"``,
``collective_precision="int8"`` (``bench.py quant``'s string: its
``tp_psum``, ``vocab_stats`` and ``grad`` slots narrowed), ``remat=True``
and ``GradAccumulation(Pipeline(...), 2)``.  Tolerances as in
``tests/test_torch_pipeline_options.py``: 1e-5 for remat and
accumulation; a narrowed wire (every narrowed sum over 2 ranks here)
per tensor within a quarter of a unit of the tensor's update, and the
layout's fp32 program outside that bound.
Remat with the fused int8 ring inside the stages (``quant_ring``, whose
recompute re-runs the model-axis rings during the backward, every model
peer in the same order) is held to the same program without remat, bit
for bit.
"""
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch.kernel.common import flatten_with_names

import test_torch_pipeline_zero as h
from test_torch_pipeline_options import init  # noqa: F401 (a fixture)

MESH = h.DP2_PP2_TP2
M2 = dict(num_microbatches=2)
RING = dict(M2, tensor_parallel=2, collective_precision={"tp_psum": "int8"},
            kernel=("quant_ring",))
# name -> (Pipeline keywords, accumulation steps, wire or None)
CASES = {f"{key}_{opt}": (dict(M2, **layout, **kw), accum, wire)
         for key, layout in (("tp2", h.TP), ("tp2_vocab", h.VOCAB))
         for opt, kw, accum, wire in (
             ("compressor", dict(compressor="bf16_ef"), 1, "bf16"),
             ("int8", dict(collective_precision="int8"), 1, "int8"),
             ("remat", dict(remat=True), 1, None),
             ("accum2", {}, 2, None))}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    import jax

    params = {"lm": port.from_jax_params(
        jax.tree.map(np.asarray, h.jax_lm(optax.sgd(h.LR)).params),
        device="cpu")}
    cases = {nm: h.lm_case(MESH, kw, accum)
             for nm, (kw, accum, _) in CASES.items()}
    # Each layout's fp32 program, which a narrowed wire must part from.
    cases.update({f"{key}_plain": h.lm_case(MESH, dict(M2, **layout))
                  for key, layout in (("tp2", h.TP), ("tp2_vocab", h.VOCAB))})
    cases["quant_ring"] = h.lm_case(MESH, RING)
    cases["quant_ring_remat"] = h.lm_case(MESH, dict(RING, remat=True))
    return h.start_gloo(cases, params,
                        {"lm": [h.batch(i) for i in range(h.STEPS)]},
                        tmp_path_factory.mktemp("pipe_tp") / "w8", 8)


@pytest.fixture(scope="module")
def jax_runs(started):
    return {nm: h.jax_run(MESH, kw, accum)
            for nm, (kw, accum, _) in CASES.items()}


@pytest.fixture(scope="module")
def port_runs(started, jax_runs):
    ranks = started()
    return {name: [r[name] for r in ranks] for name in ranks[0]}


@pytest.mark.parametrize("case", list(CASES))
def test_options_match_jax(port_runs, jax_runs, init, case):
    """Losses, gathered params at their logical shapes, each rank's
    stored shapes and compressor rows against the JAX program's (a
    narrowed wire by its bound, which the layout's fp32 program must
    miss)."""
    wire = CASES[case][2]
    ranks, want = port_runs[case], jax_runs[case]
    fp32 = port_runs[case.rsplit("_", 1)[0] + "_plain"]
    for r, got in enumerate(ranks):
        if wire is None:
            h.assert_matches(got, want)
        else:
            h.assert_wire_matches(got, want, init, wire, fp32[r])
        assert {k: (1,) + v for k, v in got["sync_state"].items()} \
            == want["sync"]
    h.assert_stored_like_jax(ranks, want)


def test_remat_recomputes_the_rings(port_runs):
    """Remat over stages whose boundaries run the int8 ring: the same
    losses and params as without remat, bit for bit."""
    a = port_runs["quant_ring_remat"][0]
    b = port_runs["quant_ring"][0]
    assert a["losses"] == b["losses"]
    for (n, x), (_, y) in zip(flatten_with_names(a["params"]),
                              flatten_with_names(b["params"])):
        assert torch.equal(x, y), n
