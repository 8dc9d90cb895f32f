"""Gradient accumulation against the plain program under Adam at eps
1e-8, in both packages, on the CPU.

``GradAccumulation(Pipeline(num_microbatches=2), 2)`` and the plain
``Pipeline(num_microbatches=2)`` train the pipelined LM (the harness of
``tests/test_torch_pipeline_zero.py``: vocabulary 33, hidden 16, fp32)
on ``{"data": 2, "pipe": 2}`` for 3 steps on the same weights and
batches under ``bench.py quant``'s optimizer, ``adam(1e-3)`` (eps
1e-8).  Accumulation sums the gradient in another order, and Adam
divides it by its own root mean square plus eps: where a gradient sits
near eps, an ulp of difference moves the update by up to the learning
rate.  So accumulation parts from plain beyond fp32 noise in both
packages.  The port's gap, per tensor (its largest absolute difference
over the plain tensor's largest value, floored at 1e-3), is held within
twice the JAX package's gap plus 1e-5 (fp32 noise): the port's accumulation parts
from plain as the reference's does, no more.
"""
import numpy as np
import optax

import autodist_tpu_torch as port
from autodist_tpu_torch.kernel.common import flatten_with_names

import test_torch_pipeline_zero as h

M2 = dict(num_microbatches=2)


def _gaps(accum, plain):
    return {nm: float(np.abs(accum[nm] - p).max()
                      / max(float(np.abs(p).max()), 1e-3))
            for nm, p in plain.items()}


def test_accumulation_gap_under_adam_is_the_jax_packages(tmp_path):
    jax_tr = h.jax_lm(optax.adam(1e-3))
    params = {"lm": port.from_jax_params(
        {k: v for k, v in jax_tr.params.items()}, device="cpu")}
    batches = [h.batch(i) for i in range(h.STEPS)]
    cases = {"plain": h.lm_case(h.DP2_PP2, M2, 1, "adam_quant"),
             "accum2": h.lm_case(h.DP2_PP2, M2, 2, "adam_quant")}
    join = h.start_gloo(cases, params, {"lm": batches}, tmp_path / "w4", 4)
    jax_runs = {name: h.jax_run(h.DP2_PP2, M2, accum,
                                trainable=h.jax_lm(optax.adam(1e-3)),
                                batches=batches)
                for name, accum in (("plain", 1), ("accum2", 2))}
    got = join()[0]
    port_runs = {name: {nm: np.asarray(p) for nm, p in
                        flatten_with_names(got[name]["params"])}
                 for name in cases}
    jax_gap = _gaps(jax_runs["accum2"]["params"], jax_runs["plain"]["params"])
    port_gap = _gaps(port_runs["accum2"], port_runs["plain"])
    over = {nm: (port_gap[nm], jax_gap[nm]) for nm in jax_gap
            if port_gap[nm] > 2 * jax_gap[nm] + 1e-5}
    assert not over, over
    print("largest gaps (port, JAX):",
          sorted(((port_gap[nm], jax_gap[nm], nm) for nm in jax_gap),
                 reverse=True)[:4])
