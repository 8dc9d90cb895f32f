"""Prefix caching's capacity at ``bench.py serve --prompt-mix
shared-prefix``'s accelerator configuration, in both packages, on the
CPU.

The bench (``bench.py:737-790``) serves 24 requests that open with one
256-token prefix on 32 slots over a pool of 512 blocks of 16 with a
512-token prompt bucket, paged alone and prefix-cached, and bars the
cached run to admit strictly more at its peak.  Admission depends only
on prompt lengths, budgets and the prefix index, not on the model's
width or the prefill's form, so a 1-layer, 16-wide model with the
bench's vocabulary, prefilling in chunks of 64, stands in.  Submitted all at once, as the bench does, the first admission
round fills the pool before any prefix is registered (a same-batch
request never shares an unwritten block), so both runs peak at the
same count in the JAX package too: the port is held to the JAX
engine's peak and hit blocks in both runs.  With the prefix resident
first (one request admitted alone, as a cached system prompt is), the
cached run admits strictly more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port

V = 32768
SIZES = dict(vocab_size=V, hidden_size=16, num_layers=1, num_heads=2,
             mlp_dim=32, max_len=1024, dropout_rate=0.0,
             attention_dropout_rate=0.0)
# The bench's engine, but for the prefill: chunks of 64 instead of its
# 512-token bucket (the same admissions; a JAX chunk program compiles in
# seconds, its 512-token one in a minute).
ENGINE = dict(num_slots=32, max_len=1024, prefill_len=512, decode_steps=16,
              kv_layout="paged", kv_block_len=16, kv_num_blocks=512,
              prefill_chunk=64)


def requests():
    """The bench's mix: its rng, its order of draws."""
    r = np.random.RandomState(0)
    shared = r.randint(0, V, 256).tolist()
    out = []
    for _ in range(24):
        suffix = int(r.randint(1, 512 - 256 + 1))
        prompt = shared + r.randint(0, V, suffix).tolist()
        out.append((prompt, int(r.randint(2, 65))))
    return shared, out


def peak(batcher, resident=None):
    """Peak admitted count and hit blocks of the mix (after ``resident``,
    admitted alone first, where given)."""
    _, mix = requests()
    if resident is not None:
        batcher.submit(resident, max_new_tokens=64)
        batcher.step()
    for prompt, n in mix:
        batcher.submit(prompt, max_new_tokens=n)
    admitted = 0
    while batcher.queue_depth or batcher.active_slots:
        batcher.step()
        admitted = max(admitted, batcher.active_slots)
    hits = sum(c.prefix_hit_blocks for c in batcher.completions.values())
    return admitted, hits


@pytest.fixture(scope="module")
def params():
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
    from autodist_tpu.models.transformer import TransformerConfig

    jcfg = TransformerConfig(dtype=jnp.float32, **SIZES)
    jparams = make_pipeline_lm_trainable(jcfg, optax.sgd(0.1),
                                         jax.random.PRNGKey(0)).params
    return jcfg, jparams, port.from_jax_params(
        jax.tree.map(np.asarray, jparams), device="cpu")


def test_bench_order_peaks_equal_the_jax_engines(params):
    from autodist_tpu.serving import ContinuousBatcher as JaxBatcher
    from autodist_tpu.serving import ServingEngine as JaxEngine

    jcfg, jparams, tparams = params
    tcfg = port.TransformerConfig(dtype=torch.float32, **SIZES)
    got, want = {}, {}
    for caching in (False, True):
        got[caching] = peak(port.ContinuousBatcher(port.ServingEngine(
            tcfg, tparams, device="cpu", prefix_caching=caching, **ENGINE)))
        want[caching] = peak(JaxBatcher(JaxEngine(
            jcfg, jparams, prefix_caching=caching, **ENGINE)))
    assert got == want
    assert want[True][1] > 0 and want[False][1] == 0


def test_resident_prefix_admits_strictly_more(params):
    _, _, tparams = params
    tcfg = port.TransformerConfig(dtype=torch.float32, **SIZES)
    shared, _ = requests()
    runs = {caching: peak(port.ContinuousBatcher(port.ServingEngine(
        tcfg, tparams, device="cpu", prefix_caching=caching, **ENGINE)),
        resident=shared + [1, 2, 3])
        for caching in (False, True)}
    assert runs[True][0] > runs[False][0], runs
