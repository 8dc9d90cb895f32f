"""Tensor-parallel serving in the port against the JAX engine on the
CPU: ``ServingEngine(tensor_parallel=2)`` on 2 gloo ranks emits the JAX
engine's greedy tokens at tensor parallel 2 (2 simulated devices) token
for token, and the batcher keeps the ranks in step when their clocks or
callers disagree.

The tiny config of the JAX serving goldens (vocab 33, odd, so a
vocab-parallel table pads to 34 rows; hidden 16, 2 layers, 2 heads, mlp
32, max_len 24, fp32), built by the JAX package and carried into the
port with ``interop``.  Every engine (dense, paged, paged with chunked
prefill; ``vocab_parallel`` on and off; ``comm_overlap`` None and
``"matmul"``) decodes one prompt of 10 tokens for 11 tokens through the
raw engine API, and the dense vocab-parallel engine also serves a ragged
mix through ``ContinuousBatcher`` with a request that runs into
``max_len``.  One module-scoped job of 2 ranks runs every check,
started before the JAX streams are computed.  Streams are compared
exactly.
"""
import itertools
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
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]    # chunk 4 -> 3 chunks
N = 11
ENGINE = dict(num_slots=2, max_len=MAX_LEN, prefill_len=12, decode_steps=3,
              tensor_parallel=2)
LAYOUTS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_block_len=4),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=4,
                          prefill_chunk=4),
}
CONFIGS = list(itertools.product(LAYOUTS, (False, True), (None, "matmul")))
MIX = [(PROMPT, dict(max_new_tokens=7)),
       ([2, 7, 1], dict(max_new_tokens=9, eos_id=17)),
       ([8, 6, 7, 5, 3], dict(max_new_tokens=4)),
       ([5, 5, 5], dict(max_new_tokens=200))]
# (f): three requests on two slots, each rank's clock or caller apart.
SPLITS = ("rank1_clock_ahead", "rank0_clock_ahead", "cancel_on_rank1")


def _engine_kw(layout, vp, overlap):
    return dict(ENGINE, **LAYOUTS[layout], vocab_parallel=vp,
                comm_overlap=overlap)


def _run_single(engine, prompt, n, slot=0):
    """One request through the raw engine API, its first ``n`` tokens
    (the JAX package's ``test_throughput_ladder.run_single``)."""
    B = engine.num_slots
    P = engine.max_prompt_tokens if engine.prefill_chunk \
        else engine.prefill_len
    prompts = np.zeros((B, P), np.int64)
    prompts[slot, :len(prompt)] = prompt
    p_lens = np.zeros((B,), np.int64)
    p_lens[slot] = len(prompt)
    admit = np.zeros((B,), bool)
    admit[slot] = True
    engine.reserve_slot(slot, len(prompt), n, prompt=np.asarray(prompt))
    tok = engine.prefill(prompts, p_lens, admit)
    out = [int(tok[slot])]
    while len(out) < n:
        w = engine.decode_window(admit)
        out.extend(int(t) for t in w.tokens[:w.counts[slot], slot])
    engine.release_slot(slot)
    return out[:n]


def _run_mix(batcher):
    rids = [batcher.submit(p, **kw) for p, kw in MIX]
    done = batcher.run()
    return [(done[r].tokens, done[r].finish_reason) for r in rids]


# --------------------------------------------------------------------------- #
# gloo ranks
# --------------------------------------------------------------------------- #
_WORKER = textwrap.dedent("""
    import sys
    import time
    import types
    import torch
    import autodist_tpu_torch as port
    from autodist_tpu_torch import testing
    from autodist_tpu_torch.serving import batcher as batcher_mod
    rank, world, store, inp, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
    torch.set_num_threads(1)
    testing.init_rank(rank, world, store)
    job = torch.load(inp, weights_only=False)
    ns = {}
    exec(job["helpers"], ns)
    cfg = port.TransformerConfig(**job["sizes"], dtype=torch.float32)
    res = {"streams": {}, "splits": {}}
    for key, kw in job["engines"].items():
        engine = port.ServingEngine(cfg, job["params"], device="cpu", **kw)
        res["streams"][key] = ns["_run_single"](engine, job["prompt"],
                                                job["n"])
        free, used, total = engine.block_accounting()
        assert used == 0 and free == total, (key, free, used)
    engine = port.serve(cfg, params=job["params"], device="cpu",
                        **job["mix_engine"])
    res["mix"] = ns["_run_mix"](port.ContinuousBatcher(engine))
    offset = [0.0]
    real = time.perf_counter
    batcher_mod.time = types.SimpleNamespace(
        perf_counter=lambda: real() + offset[0])
    for split in job["splits"]:
        batcher = port.ContinuousBatcher(port.serve(
            cfg, params=job["params"], device="cpu", **job["split_engine"]))
        rids = [batcher.submit(p, max_new_tokens=6, deadline_s=100.0)
                for p in ([3, 1, 4], [2, 7], [5, 5, 5, 5, 9])]
        ahead = {"rank1_clock_ahead": 1, "rank0_clock_ahead": 0}.get(split)
        offset[0] = 1000.0 if rank == ahead else 0.0
        if split == "cancel_on_rank1" and rank == 1:
            assert batcher.cancel(rids[1])
        done = batcher.run()
        offset[0] = 0.0
        res["splits"][split] = [(done[r].tokens, done[r].finish_reason)
                                for r in rids]
    torch.save(res, f"{out}.{rank}")
    testing.end_rank()
""")


def _helpers():
    """The harness functions' source, run in the workers."""
    import inspect

    return "import numpy as np\n" + "\n".join(
        inspect.getsource(f) for f in (_run_single, _run_mix)) + \
        f"\nMIX = {MIX!r}\n"


@pytest.fixture(scope="module")
def jcfg():
    from autodist_tpu.models.transformer import TransformerConfig

    return TransformerConfig(dtype=jnp.float32, **SMALL)


@pytest.fixture(scope="module")
def jparams(jcfg):
    from autodist_tpu.models.pipeline_lm import make_pipeline_lm_trainable

    return make_pipeline_lm_trainable(jcfg, optax.sgd(0.1),
                                      jax.random.PRNGKey(0)).params


@pytest.fixture(scope="module")
def started(jparams, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_serving")
    inp, out = str(tmp / "job.pt"), str(tmp / "res.pt")
    torch.save({
        "helpers": _helpers(), "sizes": SMALL, "prompt": PROMPT, "n": N,
        "params": port.from_jax_params(jax.tree.map(np.asarray, jparams),
                                       device="cpu"),
        "engines": {c: _engine_kw(*c) for c in CONFIGS},
        "mix_engine": _engine_kw("dense", True, None),
        "split_engine": _engine_kw("paged", True, None),
        "splits": SPLITS}, inp)
    join = testing.launch(_WORKER, 2, (inp, out), tmp=tmp, timeout=300)

    def result():
        join()
        return [torch.load(f"{out}.{r}", weights_only=False)
                for r in range(2)]

    return result


@pytest.fixture(scope="module")
def jax_streams(started, jcfg, jparams):
    """The JAX engine at tensor parallel 2, by configuration."""
    from autodist_tpu.serving import ServingEngine as JaxEngine

    out = {}
    for c in CONFIGS:
        kw = _engine_kw(*c)
        if c[0] == "paged_chunked":
            kw["kernel"] = ("flash_decode", "flash_prefill")
        out[c] = _run_single(JaxEngine(jcfg, jparams, **kw), PROMPT, N)
    return out


@pytest.fixture(scope="module")
def ranks(started, jax_streams):
    """Both ranks' results."""
    return started()


@pytest.mark.parametrize("layout,vp,overlap", CONFIGS)
def test_stream_matches_jax_at_tp2(ranks, jax_streams, layout, vp,
                                   overlap):
    """Token for token equal to the JAX engine's stream at tensor
    parallel 2, on both ranks, and inside the vocabulary."""
    want = jax_streams[(layout, vp, overlap)]
    for r in ranks:
        assert r["streams"][(layout, vp, overlap)] == want
    assert all(0 <= t < V for t in want)


def test_batcher_mix_matches_jax_at_tp2(ranks, jcfg, jparams):
    """The ragged mix through ``ContinuousBatcher``: equal tokens and
    finish reasons on both ranks and against the JAX engine, the last
    request running into ``max_len``."""
    from autodist_tpu.serving import ContinuousBatcher as JaxBatcher
    from autodist_tpu.serving import ServingEngine as JaxEngine

    want = _run_mix(JaxBatcher(JaxEngine(jcfg, jparams,
                                         **_engine_kw("dense", True, None))))
    assert ranks[0]["mix"] == ranks[1]["mix"] == want
    assert want[-1][1] == "max_len"


@pytest.mark.parametrize("split", SPLITS)
def test_one_ranks_clock_or_cancel_does_not_split_the_group(ranks, split):
    """A deadline that expires on one rank's clock, or a cancel called on
    one rank, gives both ranks the same completions (rank 0's clock
    decides expiries; a cancel anywhere withdraws the request
    everywhere), and no collective hangs."""
    got = [r["splits"][split] for r in ranks]
    assert got[0] == got[1]
    reasons = [reason for _, reason in got[0]]
    if split == "rank1_clock_ahead":
        assert reasons == ["max_tokens"] * 3
        assert all(len(toks) == 6 for toks, _ in got[0])
    elif split == "rank0_clock_ahead":
        assert set(reasons) == {"deadline_exceeded"}
    else:
        assert reasons == ["max_tokens", "cancelled", "max_tokens"]
        assert got[0][1][0] == []


def test_tensor_parallel_checks(jcfg):
    """``num_heads`` must divide, and the job must hold ``tp`` ranks, as
    the JAX engine checks its devices."""
    import dataclasses

    tcfg = port.TransformerConfig(**SMALL, dtype=torch.float32)
    params = port.init_pipeline_lm_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="num_heads"):
        port.ServingEngine(dataclasses.replace(tcfg, num_heads=1), params,
                           device="cpu", tensor_parallel=2)
    with pytest.raises(ValueError, match="job of 2 ranks"):
        port.ServingEngine(tcfg, params, device="cpu", tensor_parallel=2)
