"""The port's serving slice against the JAX package, on the CPU in fp32.

Same weights on both sides (the JAX package's own initialization,
converted with ``from_jax_params``): the model's full-sequence logits
agree at atol 1e-4, and greedy token streams from the port's engine
equal the JAX engine's token for token — dense, paged, and paged with
chunked prefill against the JAX engine that elects its flash-decode and
flash-prefill kernels — driven through the raw engine API as the JAX
package's throughput-ladder tests drive it, and through
``ContinuousBatcher`` with a request that runs into ``max_len``.
Around the streams: the weight converter round-trips bit for bit, the
package imports no JAX, and the entry points refuse to fall back to the
CPU or to serve what the slice has not ported.
"""
import ast
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import autodist_tpu_torch as port
from autodist_tpu.models.pipeline_lm import (make_pipeline_lm_trainable,
                                             sequential_logits)
from autodist_tpu.models.transformer import \
    TransformerConfig as JaxTransformerConfig
from autodist_tpu.serving import ContinuousBatcher as JaxBatcher
from autodist_tpu.serving import ServingEngine as JaxEngine
from autodist_tpu_torch import telemetry
from autodist_tpu_torch.models.pipeline_lm import \
    sequential_logits as port_sequential_logits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, MAX_LEN = 33, 24
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]   # 10 tokens: chunk=4 -> 3 chunks
MAX_NEW = 6
SMALL = dict(vocab_size=V, hidden_size=16, num_layers=2, num_heads=2,
             mlp_dim=32, max_len=MAX_LEN, dropout_rate=0.0,
             attention_dropout_rate=0.0)


@pytest.fixture(scope="module")
def jcfg():
    return JaxTransformerConfig(dtype=jnp.float32, **SMALL)


@pytest.fixture(scope="module")
def tcfg():
    return port.TransformerConfig(dtype=torch.float32, **SMALL)


@pytest.fixture(scope="module")
def jparams(jcfg):
    return make_pipeline_lm_trainable(jcfg, optax.sgd(0.1),
                                      jax.random.PRNGKey(0)).params


@pytest.fixture(scope="module")
def tparams(jparams):
    return port.from_jax_params(jax.tree.map(np.asarray, jparams),
                                device="cpu")


ENGINE = dict(num_slots=2, max_len=MAX_LEN, prefill_len=12, decode_steps=3)
LAYOUTS = {
    "dense": {},
    "paged": dict(kv_layout="paged", kv_block_len=4),
    "paged_chunked": dict(kv_layout="paged", kv_block_len=4,
                          prefill_chunk=4),
}


def jax_engine(jcfg, jparams, layout):
    kw = dict(ENGINE, **LAYOUTS[layout])
    if layout == "paged_chunked":
        kw["kernel"] = ("flash_decode", "flash_prefill")
    return JaxEngine(jcfg, jparams, **kw)


def port_engine(tcfg, tparams, layout, **extra):
    return port.ServingEngine(tcfg, tparams, device="cpu",
                              **dict(ENGINE, **LAYOUTS[layout], **extra))


def run_single(engine, prompt, n, slot=0):
    """One request through the raw engine API, first ``n`` tokens (the
    JAX package's ``test_throughput_ladder.run_single`` harness)."""
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


# --------------------------------------------------------------------------- #
# model and weights
# --------------------------------------------------------------------------- #
def test_sequential_logits_match_jax(jcfg, jparams, tcfg, tparams):
    toks = np.random.RandomState(0).randint(0, V, (2, MAX_LEN))
    want = np.asarray(sequential_logits(jcfg, jparams, jnp.asarray(toks)))
    got = port_sequential_logits(tcfg, tparams, torch.as_tensor(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_params_round_trip_bit_exact(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    back = port.to_jax_params(port.from_jax_params(tree, device="cpu"))
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


def test_converter_rejects_a_foreign_tree(jparams):
    tree = jax.tree.map(np.asarray, jparams)
    del tree["shared"]["pos_embed"]
    with pytest.raises(ValueError, match="pos_embed"):
        port.from_jax_params(tree, device="cpu")


def test_init_params_have_the_jax_tree(jparams, tcfg):
    """``init_pipeline_lm_params`` builds the shapes and dtypes of
    ``make_pipeline_lm_trainable(...).params``, reproducibly from its
    generator."""
    def draw():
        return port.init_pipeline_lm_params(
            tcfg, torch.Generator().manual_seed(0), device="cpu")
    ours = port.to_jax_params(draw())
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), ours) == \
        jax.tree.map(lambda a: (a.shape, str(np.asarray(a).dtype)), jparams)
    again = port.to_jax_params(draw())
    jax.tree.map(np.testing.assert_array_equal, ours, again)


# --------------------------------------------------------------------------- #
# engine streams, token for token
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_stream_matches_jax(layout, jcfg, jparams, tcfg, tparams):
    n = MAX_NEW + 5
    want = run_single(jax_engine(jcfg, jparams, layout), PROMPT, n)
    engine = port_engine(tcfg, tparams, layout)
    assert run_single(engine, PROMPT, n) == want
    if layout == "paged_chunked":
        assert engine.last_prefill_chunks == 3        # ceil(10 / 4)
    free, used, total = engine.block_accounting()
    assert used == 0 and free == total


@pytest.mark.parametrize("layout", ["dense", "paged_chunked"])
def test_batcher_completions_match_jax(layout, jcfg, jparams, tcfg,
                                       tparams):
    """A ragged mix through ``ContinuousBatcher`` on two slots: equal
    tokens and finish reasons, an EOS stop among them, and a last
    request that runs into ``max_len`` — the over-decode edge, where a
    final window writes past the lane (clamped) and embeds positions
    past the table (NaN), all of it discarded."""
    reqs = [(PROMPT, dict(max_new_tokens=7)),
            ([2, 7, 1], dict(max_new_tokens=9, eos_id=17)),
            ([8, 6, 7, 5, 3], dict(max_new_tokens=4)),
            ([5, 5, 5], dict(max_new_tokens=200))]

    def run(batcher):
        rids = [batcher.submit(p, **kw) for p, kw in reqs]
        done = batcher.run()
        return [(done[r].tokens, done[r].finish_reason) for r in rids]

    want = run(JaxBatcher(jax_engine(jcfg, jparams, layout)))
    got = run(port.ContinuousBatcher(port_engine(tcfg, tparams, layout)))
    assert got == want
    assert want[-1][1] == "max_len"
    assert len(want[-1][0]) == MAX_LEN - 3


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_engine_keeps_its_decode_state_tensors(layout, jcfg, jparams, tcfg,
                                               tparams):
    """Prefill, chunked prefill and decode write the current tokens, the
    lengths, the active mask and the emitted window in place: the engine
    holds the same tensor objects from construction to the last release
    (a CUDA graph replays on their addresses), and its stream still
    equals the JAX engine's.  On the CPU no window is captured."""
    engine = port_engine(tcfg, tparams, layout)
    held = {"tok": engine._tok, "lengths": engine.cache.lengths,
            "active": engine._active, "emitted": engine._emitted,
            "k": engine.cache.k, "v": engine.cache.v}
    if layout != "dense":
        held["block_table"] = engine.cache.block_table
    n = MAX_NEW + 5
    want = run_single(jax_engine(jcfg, jparams, layout), PROMPT, n, slot=1)
    assert run_single(engine, PROMPT, n, slot=1) == want
    now = {"tok": engine._tok, "lengths": engine.cache.lengths,
           "active": engine._active, "emitted": engine._emitted,
           "k": engine.cache.k, "v": engine.cache.v,
           "block_table": getattr(engine.cache, "block_table", None)}
    for name, t in held.items():
        assert now[name] is t, name
    assert not engine.decode_graph
    assert engine.captures == engine.replays == 0


def test_dense_slot_reuse_after_max_len(tcfg, tparams):
    """A request admitted into the dense slot a ``max_len`` request just
    left decodes its run-alone stream.  (The JAX engine does not: the
    over-decode leaves NaN rows behind the length mask, and its masked
    value products turn them into NaN logits — token ``vocab_size`` —
    for the next occupant.  ROADMAP Queue 3 records the difference.)"""
    one_slot = dict(num_slots=1)
    batcher = port.ContinuousBatcher(port_engine(tcfg, tparams, "dense",
                                                 **one_slot))
    long_rid = batcher.submit([3, 1, 4, 1, 5], max_new_tokens=100)
    rid = batcher.submit([2, 7, 1], max_new_tokens=6)
    done = batcher.run()
    assert done[long_rid].finish_reason == "max_len"
    solo = port.ContinuousBatcher(port_engine(tcfg, tparams, "dense",
                                              **one_slot))
    srid = solo.submit([2, 7, 1], max_new_tokens=6)
    assert done[rid].tokens == solo.run()[srid].tokens
    assert all(0 <= t < V for t in done[rid].tokens)


def test_embed_past_the_position_table_is_nan(tcfg, tparams):
    """``jnp.take`` fills out-of-range rows with NaN; the port does the
    same instead of raising."""
    engine = port_engine(tcfg, tparams, "dense")
    x = engine._embed(torch.tensor([[1, 2]]), torch.tensor([[MAX_LEN - 1,
                                                              MAX_LEN]]))
    assert torch.isfinite(x[0, 0]).all() and torch.isnan(x[0, 1]).all()


def test_batcher_telemetry(tcfg, tparams):
    tel = telemetry.reset()
    batcher = port.ContinuousBatcher(port_engine(tcfg, tparams, "paged"))
    rid = batcher.submit(PROMPT, max_new_tokens=4,
                         trace_id=telemetry.mint_trace_id())
    done = batcher.run()
    assert tel.counter("serve/requests").value == 1
    assert tel.counter("serve/tokens").value == len(done[rid].tokens) == 4
    assert len(tel.histogram("serve/ttft_ms").values) == 1
    (event,) = [e for e in tel.events if e["kind"] == "serve"]
    assert event["kv_layout"] == "paged" and event["finish"] == "max_tokens"
    assert event["trace_id"] == done[rid].trace_id
    assert tel.gauge("serve/kv_blocks_used").value == 0
    assert {s["name"] for s in tel.spans} == {"serve/prefill",
                                             "serve/decode"}


# --------------------------------------------------------------------------- #
# what the slice refuses
# --------------------------------------------------------------------------- #
def _other_vocab_draft(tcfg, tparams):
    import dataclasses

    return dict(speculative=2, draft_params=tparams,
                draft_cfg=dataclasses.replace(tcfg, vocab_size=V + 1))


def _einsum_attention(tcfg, tparams):
    import dataclasses

    return dict(cfg=dataclasses.replace(tcfg, attention_fn=lambda *a: None))


@pytest.mark.parametrize("kw", [
    (dict(prefix_caching=True), ValueError, "requires kv_layout='paged'"),
    (dict(speculative=2), ValueError, "needs a draft model"),
    (_other_vocab_draft, ValueError, "must match the target's"),
    (dict(comm_overlap="rsag"), None, "rsag"),
    (dict(temperature=-0.5), ValueError, "temperature must be >= 0"),
    (dict(top_k=-1), ValueError, "top_k must be >= 0"),
    (_einsum_attention, NotImplementedError, "flash-attention family")])
def test_out_of_slice_options_raise(kw, tcfg, tparams):
    """What the engine refuses: the JAX engine's own validation errors,
    with its messages.  ``comm_overlap="rsag"`` (``exc`` None) builds,
    and at one rank it is recorded and sums nothing."""
    make, exc, match = kw
    kw = make(tcfg, tparams) if callable(make) else dict(make)
    cfg = kw.pop("cfg", tcfg)
    if exc is None:
        engine = port.ServingEngine(cfg, tparams, device="cpu", **kw)
        assert engine.comm_overlap == match and engine.model_axis is None
        return
    with pytest.raises(exc, match=re.escape(match)):
        port.ServingEngine(cfg, tparams, device="cpu", **kw)


def test_out_of_slice_constructors_raise(tcfg, tparams, tmp_path):
    """A non-flash attention function is refused; the artifact
    constructors are ported (``tests/test_torch_export.py``) and refuse
    a directory that holds no export artifact."""
    import dataclasses

    with pytest.raises(NotImplementedError, match="flash-attention family"):
        port.ServingEngine(dataclasses.replace(
            tcfg, attention_fn=lambda *a: None), tparams, device="cpu")
    for make in (lambda: port.ServingEngine.from_artifact(str(tmp_path),
                                                          tcfg),
                 lambda: port.serve(tcfg, artifact=str(tmp_path),
                                    device="cpu")):
        with pytest.raises(FileNotFoundError,
                           match="not an export artifact"):
            make()


def test_kernel_election_is_validated(tcfg, tparams):
    from autodist_tpu_torch.strategy.ir import UnknownKernelError

    engine = port.ServingEngine(tcfg, tparams, device="cpu",
                                kernel="flash_decode")
    assert engine.kernel == {"flash_decode": True}
    with pytest.raises(UnknownKernelError):
        port.ServingEngine(tcfg, tparams, device="cpu", kernel="nope")


def test_entry_points_default_to_the_card(tcfg, tparams):
    """``device=None`` means CUDA; without a card every entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: port.ServingEngine(tcfg, tparams),
                 lambda: port.serve(tcfg, params=tparams),
                 lambda: port.init_pipeline_lm_params(
                     tcfg, torch.Generator()),
                 lambda: port.from_jax_params(port.to_jax_params(tparams))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# --------------------------------------------------------------------------- #
# import hygiene and the chip smoke's refusal
# --------------------------------------------------------------------------- #
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "autodist_tpu")


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "autodist_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    for path in paths:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, autodist_tpu_torch, autodist_tpu_torch.serving, "
            "autodist_tpu_torch.ops, autodist_tpu_torch.models.bert, "
            "autodist_tpu_torch.optim, autodist_tpu_torch.kernel.lowering, "
            "autodist_tpu_torch.runner, autodist_tpu_torch.autodist, "
            "autodist_tpu_torch.train, autodist_tpu_torch.data, "
            "autodist_tpu_torch.fetches, autodist_tpu_torch.checkpoint, "
            "autodist_tpu_torch.runtime.retry, "
            "autodist_tpu_torch.runtime.faults, "
            "autodist_tpu_torch.kernel.gspmd, "
            "autodist_tpu_torch.strategy.gspmd_builders; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert '"ok"' not in out.stdout
