"""The rest of serving in the port against the JAX engine, on the CPU in
fp32: seeded sampling, prefix caching with copy-on-write, speculative
decoding and K1 in the prefill, at tensor parallel 1.

The JAX package's throughput-ladder sizes (vocab 33, hidden 16, 2
layers, 2 heads, mlp 32, max_len 24; a different-weights draft from
``PRNGKey(3)``), carried into the port with ``from_jax_params``.  The
draw's uniform ``u`` equals ``jax.random``'s bit for bit; the gumbel
values ``-log(-log(u))`` may differ by an ulp of the two ``log``s
(held at 1e-6 absolute).  Token streams are compared exactly: every
rung (dense, paged, chunked, prefix-cached, speculative with either
draft, K1 in the prefill), greedy and sampled, equals the JAX engine's
stream on the same weights, prompt and seed, and the ladder's own
exactness holds in the port.  Around the streams: admission at equal
pool bytes, the hit and speculation counters against the JAX batcher's,
the JAX ``lint_block_trace`` over the port's block trace, and the
runner constructors.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable
from autodist_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from autodist_tpu.serving import ContinuousBatcher as JaxBatcher
from autodist_tpu.serving import ServingEngine as JaxEngine
from autodist_tpu_torch.ops import threefry
from autodist_tpu_torch.serving import kv_cache as tkv

V, MAX_LEN = 33, 24
SMALL = dict(vocab_size=V, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=MAX_LEN, dropout_rate=0.0,
             attention_dropout_rate=0.0)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]   # 10 tokens: 2 full blocks + 2
N = 11
SEED = 7
BASE = dict(num_slots=2, max_len=MAX_LEN, prefill_len=12, decode_steps=3,
            kv_layout="paged", kv_block_len=4)
SAMPLED = dict(temperature=0.9, top_k=0)
RUNGS = {
    "dense": dict(kv_layout="dense"),
    "paged": {},
    "chunked": dict(prefill_chunk=4),
    "prefix": dict(prefill_chunk=4, prefix_caching=True),
    "spec_same": dict(speculative=2, draft="same"),
    "spec_other": dict(speculative=2, draft="other"),
    "k1_dense": dict(kv_layout="dense", flash=True),
    "k1_paged": dict(flash=True),
}


@pytest.fixture(scope="module")
def jcfg():
    return JaxTransformerConfig(dtype=jnp.float32, **SMALL)


@pytest.fixture(scope="module")
def tcfg():
    return port.TransformerConfig(dtype=torch.float32, **SMALL)


@pytest.fixture(scope="module")
def jparams(jcfg):
    return {k: make_pipeline_lm_trainable(
        jcfg, optax.sgd(0.1), jax.random.PRNGKey(s)).params
        for k, s in (("same", 0), ("other", 3))}


@pytest.fixture(scope="module")
def tparams(jparams):
    return {k: port.from_jax_params(jax.tree.map(np.asarray, p),
                                    device="cpu")
            for k, p in jparams.items()}


def run_single(engine, prompt, n, seed=None, slot=0):
    """One request through the raw engine API, its first ``n`` tokens
    (``tests/unit/test_throughput_ladder.run_single``)."""
    B = engine.num_slots
    P = engine.max_prompt_tokens if engine.prefill_chunk \
        else engine.prefill_len
    prompts = np.zeros((B, P), np.int64)
    prompts[slot, :len(prompt)] = prompt
    p_lens = np.zeros((B,), np.int64)
    p_lens[slot] = len(prompt)
    admit = np.zeros((B,), bool)
    admit[slot] = True
    seeds = None if seed is None else np.full((B,), seed, np.int32)
    engine.reserve_slot(slot, len(prompt), n, prompt=np.asarray(prompt))
    tok = engine.prefill(prompts, p_lens, admit, seeds=seeds)
    out = [int(tok[slot])]
    while len(out) < n:
        w = engine.decode_window(admit)
        out.extend(int(t) for t in w.tokens[:w.counts[slot], slot])
    engine.release_slot(slot)
    return out[:n]


def assert_idle(engine):
    free, used, total = engine.block_accounting()
    assert used == 0 and free == total, (free, used, total)


def engines(rung, jcfg, jparams, tcfg, tparams, **extra):
    """The JAX and the port engine of one rung."""
    kw = {**BASE, **RUNGS[rung], **extra}
    draft = kw.pop("draft", None)
    if kw.pop("flash", False):
        from autodist_tpu.ops.flash_attention import make_attention_fn

        jcfg = dataclasses.replace(jcfg, attention_fn=make_attention_fn(
            True))
        tcfg = dataclasses.replace(tcfg, attention_fn=port.ops
                                   .make_attention_fn(True))
    jkw, tkw = dict(kw), dict(kw)
    if draft:
        jkw.update(draft_cfg=jcfg, draft_params=jparams[draft])
        tkw.update(draft_cfg=tcfg, draft_params=tparams[draft])
    return (JaxEngine(jcfg, jparams["same"], **jkw),
            port.ServingEngine(tcfg, tparams["same"], device="cpu", **tkw))


# --------------------------------------------------------------------------- #
# the draw
# --------------------------------------------------------------------------- #
def test_threefry_bits_and_uniform_equal_jax_random():
    """``fold_in`` by seed, position and row, then ``bits`` and
    ``uniform(1e-7, 1)``, over a grid of seeds, positions and rows: the
    bits and ``u`` exactly, the gumbel values within 1e-6."""
    from autodist_tpu.parallel.tensor import _rowwise_gumbel
    from autodist_tpu_torch.parallel.tensor import \
        _rowwise_gumbel as port_gumbel

    seeds = np.array([0, 7, 2 ** 31 - 1], np.int32)
    positions = np.array([0, 1, 17, 1023, 2 ** 20], np.int32)
    rows = np.arange(0, 2000, 3, dtype=np.int32)

    @jax.jit
    def reference(seed, pos):
        base = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), seed), pos)
        keys = jax.vmap(lambda r: jax.random.fold_in(base, r))(rows)
        bits = jax.vmap(lambda k: jax.random.bits(k, (), jnp.uint32))(keys)
        u = jax.vmap(lambda k: jax.random.uniform(
            k, (), jnp.float32, minval=1e-7, maxval=1.0))(keys)
        return bits, u, _rowwise_gumbel(seed, pos, rows)

    for seed in seeds:
        for pos in positions:
            bits, u, g = map(np.asarray, reference(seed, pos))
            key = threefry.fold_in(threefry.fold_in(
                threefry.key(0), torch.tensor(seed)), torch.tensor(pos))
            keys = threefry.fold_in(key, torch.as_tensor(rows))
            np.testing.assert_array_equal(
                threefry.random_bits32(keys).numpy(), bits.astype(np.int64))
            tu = threefry.uniform(keys, 1e-7, 1.0).numpy()
            np.testing.assert_array_equal(tu.view(np.int32),
                                          u.view(np.int32))
            got = port_gumbel(torch.tensor([seed]), torch.tensor([pos]),
                              torch.as_tensor(rows))[0]
            np.testing.assert_allclose(got.numpy(), g, atol=1e-6, rtol=0)


@pytest.mark.parametrize("top_k", [0, 5])
def test_sample_token_equals_jax(top_k):
    """``vocab_parallel_sample_token`` at tp 1 over random hidden states,
    tables, seeds and positions: the same tokens as the JAX function,
    and ``top_k=1`` is the greedy token."""
    from autodist_tpu.parallel.tensor import \
        vocab_parallel_sample_token as jax_sample
    from autodist_tpu_torch.parallel.tensor import (
        vocab_parallel_greedy_token, vocab_parallel_sample_token)

    rng = np.random.RandomState(top_k)
    fn = jax.jit(lambda x, e, s, p: jax_sample(
        x, e, vocab_size=V, seeds=s, positions=p, temperature=0.9,
        top_k=top_k)[0])
    for _ in range(20):
        x = rng.randn(6, 16).astype(np.float32)
        emb = (rng.randn(V, 16) * 0.5).astype(np.float32)
        seeds = rng.randint(0, 2 ** 31 - 1, 6).astype(np.int32)
        pos = rng.randint(0, 4096, 6).astype(np.int32)
        args = dict(vocab_size=V, seeds=torch.as_tensor(seeds),
                    positions=torch.as_tensor(pos), temperature=0.9)
        got, _ = vocab_parallel_sample_token(
            torch.as_tensor(x), torch.as_tensor(emb), top_k=top_k, **args)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(fn(x, emb, seeds, pos)))
        one, _ = vocab_parallel_sample_token(
            torch.as_tensor(x), torch.as_tensor(emb), top_k=1, **args)
        greedy, _ = vocab_parallel_greedy_token(
            torch.as_tensor(x), torch.as_tensor(emb), vocab_size=V)
        assert torch.equal(one, greedy)


# --------------------------------------------------------------------------- #
# every rung's stream against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("rung", list(RUNGS))
def test_rung_stream_equals_jax(rung, sampled, jcfg, jparams, tcfg,
                                tparams):
    """One request through the raw engine API: the port's stream equals
    the JAX engine's token for token, both pools end idle, and the
    port's stream equals its vanilla paged engine's (the ladder is
    exact: chunked == single shot, cached == cold, speculative ==
    vanilla, K1 == the plain attention)."""
    extra = SAMPLED if sampled else {}
    seed = SEED if sampled else None
    jengine, tengine = engines(rung, jcfg, jparams, tcfg, tparams, **extra)
    want = run_single(jengine, PROMPT, N, seed=seed)
    assert run_single(tengine, PROMPT, N, seed=seed) == want
    assert all(0 <= t < V for t in want)
    assert_idle(tengine)
    if tengine.draft is not None:
        assert_idle(tengine.draft)
    vanilla = port.ServingEngine(tcfg, tparams["same"], device="cpu",
                                 **BASE, **extra)
    assert run_single(vanilla, PROMPT, N, seed=seed) == want


def test_sampled_streams_differ_by_seed_and_interleave(tcfg, tparams):
    """Two seeds give two streams; each request's stream through the
    batcher, two slots interleaved, equals its run-alone stream."""
    kw = dict(BASE, prefill_chunk=4, **SAMPLED)
    solo = {}
    for seed in (SEED, 8):
        b = port.ContinuousBatcher(port.ServingEngine(
            tcfg, tparams["same"], device="cpu", **kw))
        rid = b.submit(PROMPT, max_new_tokens=N, seed=seed)
        solo[seed] = b.run()[rid].tokens
    assert solo[SEED] != solo[8]
    b = port.ContinuousBatcher(port.ServingEngine(
        tcfg, tparams["same"], device="cpu", **kw))
    rids = {seed: b.submit(PROMPT, max_new_tokens=N, seed=seed)
            for seed in (SEED, 8)}
    done = b.run()
    assert {s: done[r].tokens for s, r in rids.items()} == solo


# --------------------------------------------------------------------------- #
# prefix caching
# --------------------------------------------------------------------------- #
def _admit_two(tcfg, tparams, prefix_caching):
    e = port.ServingEngine(tcfg, tparams["same"], device="cpu", **BASE,
                           prefill_chunk=4, prefix_caching=prefix_caching)
    prompts = np.zeros((2, e.max_prompt_tokens), np.int64)
    prompts[0, :len(PROMPT)] = PROMPT
    e.reserve_slot(0, len(PROMPT), N, prompt=np.asarray(PROMPT))
    e.prefill(prompts, np.array([len(PROMPT), 0]), np.array([True, False]))
    hits = e.reserve_slot(1, len(PROMPT), N, prompt=np.asarray(PROMPT))
    return e, prompts, hits


def test_prefix_cache_admits_more_and_shared_equals_cold(jcfg, jparams,
                                                         tcfg, tparams):
    """At equal pool bytes a second request on a resident prefix leaves
    strictly more free blocks with caching on; it hits the 2 full blocks
    and the partial tail (3, as in JAX), its decode copies the shared
    tail before writing (a ``cow`` event), both slots decode the cold
    stream, and the engine ends idle with a lint-clean trace."""
    from autodist_tpu.analysis import lint_block_trace

    cold = run_single(engines("paged", jcfg, jparams, tcfg, tparams)[0],
                      PROMPT, N)
    plain, _, _ = _admit_two(tcfg, tparams, False)
    e, prompts, hits = _admit_two(tcfg, tparams, True)
    assert e.free_blocks > plain.free_blocks
    assert hits == 3
    prompts[1] = prompts[0]
    e.prefill(prompts, np.array([0, len(PROMPT)]), np.array([False, True]))
    got = {0: [], 1: []}
    active = np.array([True, True])
    while min(map(len, got.values())) < N - 1:
        w = e.decode_window(active)
        for slot in got:
            got[slot] += [int(t) for t in w.tokens[:w.counts[slot], slot]]
    for slot in got:
        assert got[slot][:N - 1] == cold[1:], slot
    e.release_slot(0)
    e.release_slot(1)
    assert_idle(e)
    trace = list(e._allocator.events)
    assert {"share", "cow", "write"} <= {ev[0] for ev in trace}
    report = lint_block_trace(trace)
    assert not report.diagnostics, report.render()


LADDER = dict(prefill_chunk=4, prefix_caching=True, speculative=2)
REQUESTS = [(PROMPT, 6, 1), (PROMPT, 4, 2), (PROMPT[:6] + [7, 7], 5, 3),
            (PROMPT, 3, 4), (PROMPT[:9], 7, 5)]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_ladder_batcher_counters_equal_jax(sampled, jcfg, jparams, tcfg,
                                           tparams):
    """Interleaved shared-prefix requests through ``ContinuousBatcher``
    on the full ladder (chunked, prefix-cached, speculative with the
    other-weights draft): tokens, finish reasons, prefix-hit blocks and
    the proposed/accepted counts of every request equal the JAX
    batcher's; the port's block trace lints clean and both pools end
    idle."""
    from autodist_tpu.analysis import lint_block_trace

    extra = dict(LADDER, **(SAMPLED if sampled else {}))
    jengine, tengine = engines("spec_other", jcfg, jparams, tcfg, tparams,
                               **extra)
    out = []
    for batcher in (JaxBatcher(jengine), port.ContinuousBatcher(tengine)):
        rids = [batcher.submit(p, max_new_tokens=n, seed=s)
                for p, n, s in REQUESTS]
        done = batcher.run()
        out.append([(done[r].tokens, done[r].finish_reason,
                     done[r].prefix_hit_blocks, done[r].spec_proposed,
                     done[r].spec_accepted) for r in rids])
    assert out[1] == out[0]
    assert sum(c[2] for c in out[0]) > 0
    assert 0 < sum(c[4] for c in out[0]) < sum(c[3] for c in out[0])
    report = lint_block_trace(list(tengine._allocator.events))
    assert not report.diagnostics, report.render()
    assert_idle(tengine)
    assert_idle(tengine.draft)


def test_allocator_and_prefix_keys_equal_jax():
    """The refcounted allocator's results and event trace, and the
    chained prefix keys, equal the JAX package's."""
    from autodist_tpu.serving import kv_cache as jkv

    ja, ta = jkv.BlockAllocator(6), tkv.BlockAllocator(6)
    for op, arg in [("alloc", 3), ("share", 1), ("free", [1, 2]),
                    ("alloc", 2), ("share", 0), ("free", [0, 0, 1])]:
        assert getattr(ja, op)(arg) == getattr(ta, op)(arg)
        assert (ja.free_blocks, ja.used_blocks) == (ta.free_blocks,
                                                    ta.used_blocks)
    ja.note("write", 3)
    ta.note("write", 3)
    assert list(ja.events) == list(ta.events)
    assert ta.TRACE_LIMIT == jkv.BlockAllocator.TRACE_LIMIT
    with pytest.raises(ValueError, match="cannot share a free block"):
        ta.share(5)
    for prompt in (PROMPT, PROMPT[:8], [], [2 ** 40, 1, 2]):
        for bl in (4, 3):
            assert tkv.prefix_block_keys(prompt, bl) == \
                jkv.prefix_block_keys(prompt, bl)


def test_copy_pool_block_is_in_place():
    k = torch.arange(2 * 4 * 1 * 2 * 1, dtype=torch.float32).reshape(
        2, 4, 1, 2, 1)
    v = -k.clone()
    ids = (id(k), id(v))
    want_k, want_v = k.clone(), v.clone()
    want_k[:, 3], want_v[:, 3] = k[:, 1], v[:, 1]
    out = tkv.copy_pool_block(k, v, 1, 3)
    assert (id(out[0]), id(out[1])) == ids
    assert torch.equal(k, want_k) and torch.equal(v, want_v)


@pytest.mark.parametrize("chunk", [False, True], ids=["prompt", "chunk"])
def test_paged_writers_write_from_equal_jax(chunk):
    """The ``write_from`` floor of the paged prompt and chunk writers
    against the JAX writers (blocks below the floor untouched)."""
    from autodist_tpu.serving import kv_cache as jkv

    rng = np.random.RandomState(5)
    pool = rng.randn(2, 9, 2, 4, 3).astype(np.float32)
    S = 8
    kv = rng.randn(3, S, 2, 3).astype(np.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], np.int32)
    admit = np.array([True, True, False])
    p_lens = np.array([7, 16, 4], np.int32)
    wf = np.array([1, 3, 0], np.int32)
    if chunk:
        want = jkv.paged_write_chunk(
            jnp.asarray(pool), 1, jnp.asarray(kv), jnp.asarray(admit),
            jnp.asarray(table), 4, jnp.int32(8), jnp.asarray(p_lens),
            write_from=jnp.asarray(wf))
        got = tkv.paged_write_chunk(
            torch.as_tensor(pool), 1, torch.as_tensor(kv),
            torch.as_tensor(admit), torch.as_tensor(table), 4,
            torch.tensor(8, dtype=torch.int32), torch.as_tensor(p_lens),
            write_from=torch.as_tensor(wf))
    else:
        want = jkv.paged_write_prompt(
            jnp.asarray(pool), 1, jnp.asarray(kv), jnp.asarray(admit),
            jnp.asarray(table), 4, jnp.asarray(p_lens),
            write_from=jnp.asarray(wf))
        got = tkv.paged_write_prompt(
            torch.as_tensor(pool), 1, torch.as_tensor(kv),
            torch.as_tensor(admit), torch.as_tensor(table), 4,
            torch.as_tensor(p_lens), write_from=torch.as_tensor(wf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# constructors from the training stack
# --------------------------------------------------------------------------- #
def _trained_runner(tcfg):
    from autodist_tpu_torch.models import pipeline_lm

    tr = pipeline_lm.make_pipeline_lm_trainable(
        tcfg, port.optim.sgd(0.5), torch.Generator().manual_seed(0),
        device="cpu")
    runner = port.AutoDist({"mesh": {"data": 1, "pipe": 1, "model": 1}},
                           port.Pipeline(num_microbatches=2,
                                         virtual_stages=2),
                           device="cpu").build(tr)
    rng = np.random.RandomState(0)
    for _ in range(2):
        runner.step({"x": rng.randint(0, V, (4, 8)).astype(np.int32),
                     "y": rng.randint(0, V, (4, 8)).astype(np.int32)})
    return runner


def test_from_runner_serves_the_trained_params(tcfg):
    """A ``Pipeline``-trained runner's engine (``from_runner`` and
    ``serve(runner=, strategy=)``) emits the stream of the engine built
    from its ``get_params()``; the strategy's Strategy-IR serving knobs
    seed the engine, explicit kwargs win."""
    runner = _trained_runner(tcfg)
    kw = dict(BASE, **SAMPLED)
    want = run_single(port.ServingEngine(tcfg, runner.get_params(),
                                         device="cpu", **kw), PROMPT, N,
                      seed=SEED)
    got = run_single(port.ServingEngine.from_runner(
        runner, tcfg, device="cpu", **kw), PROMPT, N, seed=SEED)
    assert got == want
    strategy = copy.deepcopy(runner.strategy)
    strategy.graph_config.parallel.update(
        kv_layout="paged", prefill_chunk=4, prefix_caching=True)
    engine = port.serve(tcfg, runner=runner, strategy=strategy,
                        device="cpu", num_slots=2, max_len=MAX_LEN,
                        prefill_len=12, decode_steps=3, kv_block_len=4,
                        **SAMPLED)
    assert (engine.kv_layout, engine.prefill_chunk, engine.prefix_caching,
            engine.tensor_parallel) == ("paged", 4, True, 1)
    assert run_single(engine, PROMPT, N, seed=SEED) == want
    engine = port.serve(tcfg, params=runner.get_params(), strategy=strategy,
                        device="cpu", prefill_chunk=None,
                        prefix_caching=False,
                        **dict(BASE, **SAMPLED, kv_layout="dense"))
    assert engine.kv_layout == "dense" and not engine.prefix_caching
    with pytest.raises(ValueError, match="exactly one of"):
        port.serve(tcfg, params=runner.get_params(), runner=runner)
