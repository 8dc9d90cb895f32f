"""The rest of serving at tensor parallel 2 in the port against the JAX
engine at tensor parallel 2 (2 simulated devices), on the CPU in fp32.

One module-scoped job of 2 gloo ranks, started before the JAX streams
are computed, runs every engine: seeded sampling (``temperature=0.9``,
``top_k=5``) with and without ``vocab_parallel`` (the shards all-gather
their local top-k values), prefix caching with copy-on-write, and
speculative decoding with a different-weights draft (tp 1 on every
rank), greedy and sampled.  The throughput-ladder sizes of
``tests/unit/test_throughput_ladder.py`` (vocab 33, odd, so a
vocab-parallel table pads to 34 rows).  Streams, finish reasons,
prefix-hit blocks and the speculation counters are compared exactly,
on both ranks; each rank's block trace goes through the JAX
``lint_block_trace``.
"""
import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu_torch import testing

V, MAX_LEN = 33, 24
SMALL = dict(vocab_size=V, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=MAX_LEN, dropout_rate=0.0,
             attention_dropout_rate=0.0)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
N, SEED = 11, 7
BASE = dict(num_slots=2, max_len=MAX_LEN, prefill_len=12, decode_steps=3,
            kv_layout="paged", kv_block_len=4, tensor_parallel=2)
SAMPLED = dict(temperature=0.9, top_k=5)
ENGINES = {
    "sampled_dense_vp": dict(kv_layout="dense", vocab_parallel=True,
                             **SAMPLED),
    "sampled_chunked_vp": dict(prefill_chunk=4, vocab_parallel=True,
                               **SAMPLED),
    "sampled_paged": dict(**SAMPLED),
    "prefix_vp": dict(prefill_chunk=4, prefix_caching=True,
                      vocab_parallel=True, **SAMPLED),
    "spec_vp": dict(speculative=2, vocab_parallel=True),
    "spec_sampled_vp": dict(speculative=2, vocab_parallel=True, **SAMPLED),
}
DRAFTED = {"spec_vp", "spec_sampled_vp"}
LADDER = dict(prefill_chunk=4, prefix_caching=True, speculative=2,
              vocab_parallel=True, comm_overlap="matmul", **SAMPLED)
REQUESTS = [(PROMPT, 6, 1), (PROMPT, 4, 2), (PROMPT[:6] + [7, 7], 5, 3),
            (PROMPT, 3, 4)]


def _run_single(engine, prompt, n, seed=None, slot=0):
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


def _run_requests(batcher, requests):
    rids = [batcher.submit(p, max_new_tokens=n, seed=s)
            for p, n, s in requests]
    done = batcher.run()
    return [(done[r].tokens, done[r].finish_reason,
             done[r].prefix_hit_blocks, done[r].spec_proposed,
             done[r].spec_accepted) for r in rids]


_WORKER = textwrap.dedent("""
    import sys
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    ns = {}
    exec(job["helpers"], ns)
    cfg = port.TransformerConfig(**job["sizes"], dtype=torch.float32)
    draft = dict(draft_cfg=cfg, draft_params=job["draft"])
    res = {"streams": {}}
    for key, kw in job["engines"].items():
        if key in job["drafted"]:
            kw = dict(kw, **draft)
        engine = port.ServingEngine(cfg, job["params"], device="cpu", **kw)
        res["streams"][key] = ns["_run_single"](engine, job["prompt"],
                                                job["n"], seed=job["seed"])
        for e in (engine, engine.draft):
            if e is not None:
                free, used, total = e.block_accounting()
                assert used == 0 and free == total, (key, free, used)
    engine = port.ServingEngine(cfg, job["params"], device="cpu",
                                **job["ladder"], **draft)
    res["ladder"] = ns["_run_requests"](port.ContinuousBatcher(engine),
                                        job["requests"])
    res["events"] = list(engine._allocator.events)
    res["idle"] = [e.block_accounting() for e in (engine, engine.draft)]
    torch.save(res, f"{out}.{rank}")
    testing.end_rank()
""")


@pytest.fixture(scope="module")
def jcfg():
    from autodist_tpu.models.transformer import TransformerConfig

    return TransformerConfig(dtype=jnp.float32, **SMALL)


@pytest.fixture(scope="module")
def jparams(jcfg):
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable

    return [make_pipeline_lm_trainable(jcfg, optax.sgd(0.1),
                                       jax.random.PRNGKey(s)).params
            for s in (0, 3)]


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ladder_tp")
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    target, draft = (port.from_jax_params(jax.tree.map(np.asarray, p),
                                          device="cpu") for p in jparams)
    torch.save({
        "helpers": "import numpy as np\n" + "\n".join(
            inspect.getsource(f) for f in (_run_single, _run_requests)),
        "sizes": SMALL, "prompt": PROMPT, "n": N, "seed": SEED,
        "params": target, "draft": draft, "drafted": DRAFTED,
        "engines": {k: dict(BASE, **kw) for k, kw in ENGINES.items()},
        "ladder": dict(BASE, **LADDER), "requests": REQUESTS}, inp)
    join = testing.launch(_WORKER, 2, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return [torch.load(f"{out}.{r}", weights_only=False)
                for r in range(2)]

    return result


def _jax_engine(jcfg, jparams, kw, drafted):
    from autodist_tpu.serving import ServingEngine as JaxEngine

    kw = dict(BASE, **kw)
    if drafted:
        kw.update(draft_cfg=jcfg, draft_params=jparams[1])
    return JaxEngine(jcfg, jparams[0], **kw)


@pytest.fixture(scope="module")
def jax_results(started, jcfg, jparams):
    from autodist_tpu.serving import ContinuousBatcher as JaxBatcher

    streams = {k: _run_single(_jax_engine(jcfg, jparams, kw, k in DRAFTED),
                              PROMPT, N, seed=SEED)
               for k, kw in ENGINES.items()}
    ladder = _run_requests(JaxBatcher(_jax_engine(jcfg, jparams, LADDER,
                                                  True)), REQUESTS)
    return streams, ladder


@pytest.fixture(scope="module")
def ranks(started, jax_results):
    return started()


@pytest.mark.parametrize("key", list(ENGINES))
def test_stream_equals_jax_at_tp2(ranks, jax_results, key):
    """One request through the raw engine API at tensor parallel 2:
    token for token the JAX engine's stream, on both ranks."""
    want = jax_results[0][key]
    for r in ranks:
        assert r["streams"][key] == want
    assert all(0 <= t < V for t in want)


def test_ladder_batcher_equals_jax_at_tp2(ranks, jax_results):
    """The full ladder (chunked, prefix-cached, speculative, sampled,
    ``vocab_parallel``, the collective-matmul ring) through
    ``ContinuousBatcher``: every request's tokens, finish reason,
    prefix-hit blocks and speculation counts equal the JAX batcher's at
    tensor parallel 2, on both ranks; each rank's block trace lints
    clean and both pools end idle."""
    from autodist_tpu.analysis import lint_block_trace

    want = jax_results[1]
    assert sum(c[2] for c in want) > 0 and sum(c[3] for c in want) > 0
    for r in ranks:
        assert r["ladder"] == want
        report = lint_block_trace(r["events"])
        assert not report.diagnostics, report.render()
        for free, used, total in r["idle"]:
            assert used == 0 and free == total
