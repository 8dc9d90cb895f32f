"""Batched-inference engine for the pipelined LM, on one GPU or on a
tensor-parallel group.

Counterpart of ``autodist_tpu/serving/engine.py``.  The same host-side
contract — ``prefill`` / ``decode_window`` over a fixed slot batch,
block accounting for the paged layout — drives the same model math
(:func:`~autodist_tpu_torch.models.pipeline_lm._tp_encoder_layer`):

* **prefill** runs the zero-padded prompt bucket through every layer
  (attention: the plain causal product, or K1 where ``cfg.attention_fn``
  is the flash adapter), fills the cache and emits each admitted slot's
  first token; under ``prefill_chunk`` (paged only) it walks the prompt
  in chunks whose attention is the paged flash-prefill kernel (K7);
* **decode** runs ``decode_steps`` token steps per window: each layer
  writes the step's k/v into the cache and attends through the dense
  (K5) or paged (K6) flash-decode kernel;
* the **epilogue** is greedy at ``temperature == 0``, else seeded
  Gumbel-max sampling keyed per (request seed, position, vocab row)
  (:func:`~autodist_tpu_torch.parallel.tensor
  .vocab_parallel_sample_token`), ``top_k`` restricting it;
* **prefix caching** (paged only) shares the pool blocks of a prompt's
  leading blocks between requests, keyed by content
  (:func:`~autodist_tpu_torch.serving.kv_cache.prefix_block_keys`): a
  request reserves only its novel suffix, its prefill skips the shared
  blocks (``write_from``), and a write into a shared block copies it
  first (copy-on-write, :meth:`ServingEngine._cow_protect`);
* **speculative decoding** (``speculative=k`` with a draft model) lets
  a nested tp-1 draft engine propose ``k`` tokens, scores the ``[B, k +
  1]`` window in one target pass through K7 (the verify window), and
  keeps on the host the longest prefix the target agrees with plus the
  target's own next token: the stream vanilla decode emits, token for
  token.

Attention over the cache always goes through the kernel wrappers: on
the card they launch the CUDA kernels, on CPU tensors they run the
kernels' plain versions.  ``kernel=`` is validated and recorded for
signature parity with the JAX engine; it selects nothing.

JAX donates the cache into its compiled programs; here the decode
state is updated **in place**: ``engine.cache`` keeps the same ``k``,
``v``, ``lengths`` and block-table tensors for the engine's life, and
every per-call input (tokens, prompts, prompt lengths, the admit and
active masks, the seeds, the prefix floor, the chunk start) and output
lives in a static buffer that the host copies into.  JAX rebinds
``lengths`` and the current tokens after a speculative window; the port
copies into the captured tensors instead, so a replay never reads a
stale address.  On the card each program is recorded once into a CUDA
graph (:mod:`autodist_tpu_torch.cuda_graph`) and replayed: the decode
window (and the draft's own), the single-token catch-up, the verify
window, the single-shot prefill (one graph for the prompt bucket) and
the prefill chunk (one graph serves every chunk: its start is a device
scalar, as JAX traces it).  A program's first call runs its body
eagerly, as the capture's warm-up, and is recorded after it.
``decode_graph=False`` and ``prefill_graph=False`` launch the bodies
from the host instead (the routes the graphs are measured against); on
the CPU the bodies always run eagerly.

At ``tensor_parallel=t > 1`` every process of a ``torch.distributed``
job of ``t`` ranks builds the same engine and makes the same calls
(:class:`~autodist_tpu_torch.serving.batcher.ContinuousBatcher` keeps
them in step): each rank holds its Megatron shards, cut from the full
tree by the pipeline builder's rule tables (:func:`serving_param_dims`,
JAX ``serving_param_specs``), and a cache of ``num_heads / t`` heads;
the layers sum their row-parallel outputs over the group
(``comm_overlap="rsag"``: a reduce-scatter + all-gather pair;
``"matmul"``: the collective-matmul ring).  Under
``vocab_parallel`` the tied table is sharded too, padded to divide, and
the embedding and the epilogues take the vocab-parallel forms of
:mod:`autodist_tpu_torch.parallel.tensor`; without it every rank holds
the whole table and picks the same token alone.  The draft runs at tp 1
on every rank.  A group of NCCL ranks replays the graphs like one card;
gloo ranks on the card stage every exchange through the host, so they
run the host loop.

:meth:`ServingEngine.from_artifact` serves an export
artifact's ``params/`` (:mod:`autodist_tpu_torch.checkpoint.export`).
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, cuda_graph, interop
from autodist_tpu_torch.capture import stage_slice
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.kernel.flash_decode import (
    flash_decode_attention, flash_decode_attention_paged)
from autodist_tpu_torch.kernel.flash_prefill import \
    flash_prefill_attention_paged
from autodist_tpu_torch.models.pipeline_lm import (_layer_norm,
                                                   _tp_encoder_layer,
                                                   tree_map)
from autodist_tpu_torch.ops import is_flash_attention_fn
from autodist_tpu_torch.parallel.axis import Axis
from autodist_tpu_torch.parallel.tensor import (normalize_comm_overlap,
                                                vocab_parallel_embedding,
                                                vocab_parallel_greedy_token,
                                                vocab_parallel_sample_token)
from autodist_tpu_torch.serving import kv_cache
from autodist_tpu_torch.strategy.parallel_builders import (
    PIPELINE_TP_RULES, PIPELINE_VOCAB_RULES)
from autodist_tpu_torch.strategy.ir import (normalize_kernel,
                                            normalize_kv_layout,
                                            normalize_prefill_chunk,
                                            normalize_prefix_caching,
                                            normalize_speculative)
from autodist_tpu_torch import telemetry


def serving_param_dims(params, tp: int, vocab_parallel: bool) -> dict:
    """``{leaf name: dim}`` of the leaves a tensor-parallel engine
    shards over the model axis, from the rule tables the ``Pipeline``
    builder writes into the Strategy IR (JAX ``serving_param_specs``):
    a stage leaf keeps its leading layer dim and shards the Megatron dim
    its tp rule names; the shared tied table shards its vocabulary under
    ``vocab_parallel``; the rest replicate."""
    if tp == 1:
        return {}
    tp_rules = [(re.compile(p), spec) for p, spec in PIPELINE_TP_RULES]
    vocab_rules = [(re.compile(p), spec)
                   for p, spec in PIPELINE_VOCAB_RULES]
    dims = {}
    for name, leaf in flatten_with_names(params):
        shape = tuple(leaf.shape)
        if name.startswith("stages/"):
            rules, tail = tp_rules, shape[1:]
        elif vocab_parallel and name.startswith("shared/"):
            rules, tail = vocab_rules, shape
        else:
            continue
        for pat, spec in rules:
            if pat.search(name) and len(spec) == len(tail):
                d = spec.index(const.MODEL_AXIS)
                if rules is tp_rules and tail[d] % tp:
                    raise ValueError(f"{name}: dim {tail[d]} does not "
                                     f"divide by tensor_parallel={tp}")
                dims[name] = d + len(shape) - len(tail)
                break
    return dims


def seed_engine_kwargs(engine_kwargs: dict, strategy) -> dict:
    """Default the serving knobs from a training strategy's Strategy-IR
    ``parallel`` record and kernel slot (explicit kwargs win), the JAX
    package's one definition behind every ``strategy=`` entry point.  A
    speculative election still needs the caller's draft model: the IR
    records the decision, not the weights."""
    if strategy is not None:
        par = strategy.graph_config.parallel or {}
        engine_kwargs.setdefault(
            "tensor_parallel", int(par.get("tensor_parallel", 1) or 1))
        engine_kwargs.setdefault(
            "vocab_parallel", bool(par.get("vocab_parallel", False)))
        engine_kwargs.setdefault("comm_overlap", par.get("comm_overlap"))
        engine_kwargs.setdefault(
            "kv_layout", normalize_kv_layout(par.get("kv_layout")))
        engine_kwargs.setdefault(
            "prefill_chunk",
            normalize_prefill_chunk(par.get("prefill_chunk")))
        engine_kwargs.setdefault(
            "prefix_caching",
            normalize_prefix_caching(par.get("prefix_caching")))
        engine_kwargs.setdefault(
            "speculative", normalize_speculative(par.get("speculative")))
        kern = getattr(strategy.graph_config, "kernel", None)
        if kern:
            engine_kwargs.setdefault("kernel", dict(kern))
    return engine_kwargs


def _model_group(tp: int) -> Axis:
    """The model axis of a tensor-parallel engine: every rank of the
    default process group, which must hold ``tp`` ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp:
        raise ValueError(
            f"tensor_parallel={tp} needs a torch.distributed job of {tp} "
            f"ranks (init_process_group first); the job has {world}")
    return Axis(const.MODEL_AXIS, size=tp, index=dist.get_rank(),
                ranks=tuple(range(tp)), group=dist.group.WORLD)


@dataclasses.dataclass
class DecodeWindow:
    """One decode window's host-visible outcome: ``tokens [n, B]`` with
    column ``i`` valid through ``counts[i]`` (a vanilla window emits
    ``decode_steps`` a slot, a speculative one ``accepted + 1``);
    ``spec_proposed`` / ``spec_accepted`` count the draft's proposals
    (zero on vanilla windows)."""

    tokens: np.ndarray
    counts: np.ndarray
    spec_proposed: np.ndarray
    spec_accepted: np.ndarray


def _matmul_weights(chunk, dtype):
    """A layer's matmul kernels and biases cast to ``dtype`` once (the
    JAX engine casts them on every call; the values are the same); the
    norms' fp32 parameters stay as they are."""
    def cast(node):
        return {k: cast(v) if isinstance(v, dict) else v.to(dtype)
                for k, v in node.items()}
    return {"attention": cast(chunk["attention"]), "mlp": cast(chunk["mlp"]),
            "ln_attention": chunk["ln_attention"], "ln_mlp": chunk["ln_mlp"]}


class ServingEngine:
    """Prefill/decode engine for the pipelined transformer LM.

    ``params``: the logical ``{"stages": ..., "shared": ...}`` tree of
    :func:`~autodist_tpu_torch.models.pipeline_lm.init_pipeline_lm_params`,
    :func:`~autodist_tpu_torch.interop.from_jax_params` or a runner's
    ``get_params()``.  The knobs mean what they mean to the JAX engine:
    ``num_slots`` batch slots, the ``prefill_len`` prompt bucket,
    ``decode_steps`` tokens per window, ``kv_layout`` ``"dense"`` or
    ``"paged"`` (a pool of ``kv_num_blocks`` blocks of ``kv_block_len``
    positions, admitted against free blocks), ``prefill_chunk`` (paged
    only), ``temperature`` / ``top_k`` (the sampling rung; 0 is the
    exact greedy program), ``prefix_caching`` (paged only) and
    ``speculative=k`` with ``draft_cfg`` / ``draft_params`` (a draft of
    the same vocabulary).  ``cfg.attention_fn`` may be the flash adapter
    (:func:`~autodist_tpu_torch.ops.make_attention_fn`): the single-shot
    prefill then attends through K1.

    ``tensor_parallel=t`` runs the engine on the ``t`` ranks of the
    default process group (every rank constructs it with the same
    arguments and ``params``, the full logical tree);
    ``vocab_parallel`` shards the tied table's vocabulary over them;
    ``comm_overlap="rsag"`` sums the row-parallel outputs with a
    reduce-scatter + all-gather pair, ``"matmul"`` with the
    collective-matmul ring.  :attr:`model_axis` is the group's
    :class:`~autodist_tpu_torch.parallel.axis.Axis` (``None`` at one
    rank).

    ``device=None`` means the card and raises ``RuntimeError`` where
    there is none; pass ``device="cpu"`` to run the plain path.  On the
    card each program replays one CUDA graph unless ``decode_graph`` /
    ``prefill_graph`` is False or the group stages through the host
    (gloo); :attr:`captures` / :attr:`replays` count the window graphs
    (decode, verify, catch-up), :attr:`prefill_captures` /
    :attr:`prefill_replays` the prefill ones.
    """

    def __init__(self, cfg, params, *, tensor_parallel: int = 1,
                 vocab_parallel: bool = False, comm_overlap=None,
                 kernel=None,
                 num_slots: int = 4, max_len: Optional[int] = None,
                 prefill_len: Optional[int] = None, decode_steps: int = 8,
                 kv_layout: str = "dense",
                 kv_block_len: Optional[int] = None,
                 kv_num_blocks: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 prefill_chunk: Optional[int] = None,
                 prefix_caching: bool = False,
                 speculative: Optional[int] = None,
                 draft_cfg=None, draft_params=None,
                 device=None, decode_graph: bool = True,
                 prefill_graph: bool = True):
        self.cfg = cfg
        self.kernel = normalize_kernel(kernel)
        attn_fn = cfg.attention_fn
        if attn_fn is not None:
            if not is_flash_attention_fn(attn_fn):
                # The decode step attends over the cache with its own
                # kernels; another attention_fn would serve different
                # numerics than it trained with.
                raise NotImplementedError(
                    "serving supports cfg.attention_fn only for the "
                    "flash-attention family (autodist_tpu_torch.ops."
                    "make_attention_fn / flash_attention — numerics-"
                    "equivalent to the trained einsum path, decode "
                    "served by the flash-decode cache kernel); got "
                    f"{getattr(attn_fn, '__name__', attn_fn)!r} — "
                    "clear attention_fn or use the supported kernel")
            self.kernel = dict(self.kernel, flash_decode=True)
        if cfg.dropout_rate or cfg.attention_dropout_rate:
            raise ValueError(
                "serving requires dropout_rate == "
                "attention_dropout_rate == 0 (inference mode)")
        tp = int(tensor_parallel)
        if tp < 1:
            raise ValueError("tensor_parallel must be >= 1")
        if tp > 1 and cfg.num_heads % tp:
            raise ValueError(
                f"num_heads={cfg.num_heads} must divide by "
                f"tensor_parallel={tp}")
        self.tensor_parallel = tp
        self.vocab_parallel = bool(vocab_parallel) and tp > 1
        self.comm_overlap = normalize_comm_overlap(comm_overlap)
        self.num_slots = int(num_slots)
        self.max_len = int(max_len or cfg.max_len)
        if self.max_len > cfg.max_len:
            raise ValueError(
                f"max_len={self.max_len} exceeds the model's trained "
                f"position table ({cfg.max_len})")
        self.prefill_len = int(prefill_len or min(self.max_len, 16))
        if self.prefill_len > self.max_len:
            raise ValueError("prefill_len must be <= max_len")
        self.decode_steps = int(decode_steps)
        self.kv_layout = normalize_kv_layout(kv_layout)
        self.kv_block_len = int(kv_block_len or min(16, self.max_len))
        if self.kv_block_len < 1:
            raise ValueError("kv_block_len must be >= 1")
        self.max_blocks = kv_cache.blocks_for(self.max_len,
                                              self.kv_block_len)
        self.kv_num_blocks = int(kv_num_blocks
                                 or self.num_slots * self.max_blocks)
        paged = self.kv_layout == "paged"
        if paged and self.kv_num_blocks < self.max_blocks:
            raise ValueError(
                f"kv_num_blocks={self.kv_num_blocks} cannot hold even "
                f"one full-length request ({self.max_blocks} blocks of "
                f"{self.kv_block_len})")
        self.prefill_chunk = normalize_prefill_chunk(prefill_chunk)
        if self.prefill_chunk is not None:
            if not paged:
                raise ValueError(
                    "prefill_chunk writes prompt chunks through the "
                    "block table — it requires kv_layout='paged'")
            if self.prefill_chunk % self.kv_block_len:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be a "
                    f"multiple of kv_block_len={self.kv_block_len} so "
                    "chunk writes stay block-granular")
        self.prefix_caching = normalize_prefix_caching(prefix_caching)
        if self.prefix_caching and not paged:
            raise ValueError(
                "prefix_caching shares physical pool blocks — it "
                "requires kv_layout='paged'")
        self.speculative = normalize_speculative(speculative)
        if self.speculative is not None:
            if draft_cfg is None or draft_params is None:
                raise ValueError(
                    "speculative decoding needs a draft model: pass "
                    "draft_cfg and draft_params (the Strategy IR records "
                    "the k election, not the weights)")
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab_size={draft_cfg.vocab_size} must "
                    f"match the target's {cfg.vocab_size} — accept/"
                    "reject compares token ids")
        self.temperature = float(temperature)
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        self.top_k = int(top_k)
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")

        self.device = resolve_device(device)
        self.model_axis = _model_group(tp) if tp > 1 else None
        dev, dtype = self.device, cfg.dtype
        # Each rank keeps its shards (the table padded to divide under
        # vocab_parallel), copied out of the full tree.
        dims = serving_param_dims(params, tp, self.vocab_parallel)
        local = interop.shard_params(
            tree_map(torch.as_tensor, params), dims,
            self.model_axis.index if tp > 1 else 0, tp,
            padded={"shared/embedding"})
        self.params = unflatten({
            nm: t.to(dev).clone() if nm in dims else t.to(dev)
            for nm, t in flatten_with_names(local)})
        self._tp = dict(model_axis=self.model_axis,
                        comm_overlap=self.comm_overlap)
        self._vocab_axis = self.model_axis if self.vocab_parallel else None
        self._shared = self.params["shared"]
        self._layers = [
            _matmul_weights(stage_slice(self.params["stages"], i), dtype)
            for i in range(cfg.num_layers)]

        # Static buffers: every program reads its inputs from, and
        # writes its outputs to, these addresses (a graph replays on
        # them).
        B = self.num_slots

        def buf(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self._tok = buf(B)
        self._active = buf(B, dtype=torch.bool)
        self._emitted = {self.decode_steps: buf(self.decode_steps, B), 1:
                         buf(1, B)}
        self._seeds = buf(B)
        self._seeds_host = np.zeros((B,), np.int32)
        self._p_lens = buf(B)
        self._admit = buf(B, dtype=torch.bool)
        if self.prefill_chunk is None:
            self._prompts = buf(B, self.prefill_len, dtype=torch.int64)
        else:
            self._chunk_toks = buf(B, self.prefill_chunk, dtype=torch.int64)
            self._chunk_start = buf()
        # A gloo group on the card stages its sums through the host: no
        # capture, the host loop (the route is read from the group).
        capturable = dev.type == "cuda" and not (
            self.model_axis is not None
            and self.model_axis.stages_through_host)
        self.decode_graph = bool(decode_graph) and capturable
        self.prefill_graph = bool(prefill_graph) and capturable
        self._graphs: dict = {}
        heads = cfg.num_heads // tp
        if paged:
            self.cache = kv_cache.init_paged_cache(
                cfg.num_layers, B, heads, cfg.head_dim, self.max_len,
                block_len=self.kv_block_len, num_blocks=self.kv_num_blocks,
                dtype=dtype, device=dev)
            # Host-side block accounting: the refcounted free list and
            # the numpy mirror of the device block table.
            self._allocator = kv_cache.BlockAllocator(self.kv_num_blocks)
            self._table = np.zeros((B, self.max_blocks), np.int32)
            self._slot_blocks: list = [[] for _ in range(B)]
            # Prefix-cache state: content key -> ready physical block
            # (registered only after the prefill that wrote it, so a
            # same-batch sibling never shares an unwritten block), the
            # reverse map for retirement at refcount 0, registrations
            # pending the prefill, the copy-on-write reserves (one
            # replacement block per extra reference on a shared partial
            # tail, so a copy never meets an exhausted pool), and the
            # per-slot novel-write floor and hit count.
            self._prefix_index: dict = {}
            self._block_keys: dict = {}
            self._pending_register: dict = {}
            self._cow_reserve: dict = {}
            self._write_from = np.zeros((B,), np.int32)
            self._write_from_dev = buf(B)
            self._slot_hits = np.zeros((B,), np.int32)
            self._emit_block_gauges()
        else:
            self.cache = kv_cache.init_cache(
                cfg.num_layers, B, heads, cfg.head_dim, self.max_len,
                dtype=dtype, device=dev)
            self._allocator = None
            # The verify window attends through K7 over the dense lanes
            # read as a pool of one block a slot.
            self._lane_table = torch.arange(
                B, dtype=torch.int32, device=dev)[:, None]
        self.last_prefill_chunks = 0

        # Speculative decoding: a nested engine of the same layout and
        # block scheme with its own pool and parameters, at tp 1 on every
        # rank (its choices are shard-invariant anyway: the draws are
        # keyed on (seed, position)), proposing k tokens a window.
        self.draft = None
        if self.speculative is not None:
            self.draft = ServingEngine(
                draft_cfg, draft_params, num_slots=B, max_len=self.max_len,
                prefill_len=self.prefill_len, decode_steps=self.speculative,
                kv_layout=self.kv_layout, kv_block_len=self.kv_block_len,
                temperature=self.temperature, top_k=self.top_k,
                prefill_chunk=self.prefill_chunk, device=dev,
                decode_graph=decode_graph, prefill_graph=prefill_graph)
            C = self.speculative + 1
            self._verify_in = buf(B, C, dtype=torch.int64)
            self._choices = buf(B, C)
            self._spec_catch = np.zeros((B,), bool)
            self._spec_catch_tok = np.zeros((B,), np.int32)

    # ------------------------------------------------------------------ #
    # constructors from the training stack
    # ------------------------------------------------------------------ #
    @classmethod
    def from_runner(cls, runner, cfg, *, strategy=None, **kw):
        """Serve a live runner's parameters (``runner.get_params()``, a
        collective where the strategy shards them: every rank calls
        it).  A training ``strategy`` seeds the serving knobs from its
        Strategy IR unless overridden (:func:`seed_engine_kwargs`)."""
        return cls(cfg, runner.get_params(),
                   **seed_engine_kwargs(kw, strategy))

    @classmethod
    def from_artifact(cls, path: str, cfg, **kw):
        """Serve an export artifact's ``params/`` tree (logical names,
        unpadded shapes; :func:`~autodist_tpu_torch.checkpoint.export
        .export_model`)."""
        from autodist_tpu_torch.checkpoint.export import \
            load_exported_params

        return cls(cfg, load_exported_params(path), **kw)

    # ------------------------------------------------------------------ #
    # the model math
    # ------------------------------------------------------------------ #
    def _embed(self, tokens, positions):
        """Token + position embedding for ``[B, S]`` ids at ``positions``
        (``[B, S]`` or ``[S]``).  A position past the model's table
        embeds as NaN, as the JAX engine's ``jnp.take`` fills it (a final
        window's over-decode reaches such positions; its tokens are
        discarded by the batcher)."""
        dtype = self.cfg.dtype
        x = vocab_parallel_embedding(tokens, self._shared["embedding"],
                                     model_axis=self._vocab_axis,
                                     comm_overlap=self.comm_overlap)
        table = self._shared["pos_embed"]
        positions = positions.long()
        pos = table[positions.clamp(0, table.shape[0] - 1)]
        oob = (positions < 0) | (positions >= table.shape[0])
        pos = torch.where(oob[..., None], float("nan"), pos)
        return x.to(dtype) + pos.to(dtype)

    def _next_token(self, h, positions):
        """The epilogue: next token ``[B]`` int32 from last-position
        hidden states, greedy at ``temperature == 0`` (the exact greedy
        program), else sampled under the slots' seeds at ``positions``
        (the emitted token's context length, its draw key)."""
        x = _layer_norm(h, self._shared["ln_final_scale"],
                        self._shared["ln_final_bias"])
        kw = dict(vocab_size=self.cfg.vocab_size,
                  model_axis=self._vocab_axis)
        if self.temperature == 0.0:
            tok, _ = vocab_parallel_greedy_token(
                x, self._shared["embedding"], **kw)
        else:
            tok, _ = vocab_parallel_sample_token(
                x, self._shared["embedding"], seeds=self._seeds,
                positions=positions, temperature=self.temperature,
                top_k=self.top_k, **kw)
        return tok

    def _forward(self, x, attend_for_layer):
        for layer in range(self.cfg.num_layers):
            x = _tp_encoder_layer(self.cfg, self._layers[layer], x, None,
                                  attend=attend_for_layer(layer), **self._tp)
        return x

    def _window_attention(self, q, layer, starts):
        """A ``[B, C]`` query window at per-slot ``starts`` over the
        cache through K7: the pool and table (paged), or the dense lanes
        read as a pool of one ``max_len`` block a slot."""
        c = self.cache
        if self.kv_layout == "paged":
            table, bl = c.block_table, self.kv_block_len
        else:
            table, bl = self._lane_table, self.max_len
        return flash_prefill_attention_paged(
            q.contiguous(), c.k[layer], c.v[layer], starts, table,
            block_len=bl, dtype=self.cfg.dtype)

    # ------------------------------------------------------------------ #
    # graphs
    # ------------------------------------------------------------------ #
    def _launch(self, name: str, body, use_graph: bool) -> None:
        """Run ``body`` on the static buffers: eagerly, or as the replay
        of its graph (recorded after the first call, which is the
        capture's warm-up and does the call's work)."""
        if not use_graph:
            body()
            return
        graph = self._graphs.get(name)
        if graph is None:
            with torch.cuda.device(self.device):
                self._graphs[name] = cuda_graph.Graph(
                    body, body, keep_warmup_counts=True)
        else:
            graph.replay()

    def _graph_stat(self, prefill: bool, what: str):
        return sum(getattr(g, what) for name, g in self._graphs.items()
                   if name.startswith("prefill") == prefill)

    @property
    def captures(self) -> int:
        """Window graphs captured (decode; verify and catch-up on a
        speculative engine)."""
        return sum(not name.startswith("prefill") for name in self._graphs)

    @property
    def replays(self) -> int:
        """Window calls that replayed a captured graph."""
        return self._graph_stat(False, "replays")

    @property
    def capture_seconds(self) -> float:
        return float(self._graph_stat(False, "seconds"))

    @property
    def prefill_captures(self) -> int:
        """Prefill graphs captured: one for the prompt bucket (single
        shot) or the chunk shape (chunked)."""
        return sum(name.startswith("prefill") for name in self._graphs)

    @property
    def prefill_replays(self) -> int:
        """Prefill calls (single shot) or chunks that replayed a graph."""
        return self._graph_stat(True, "replays")

    @property
    def prefill_capture_seconds(self) -> float:
        return float(self._graph_stat(True, "seconds"))

    def close(self) -> None:
        """Free the captured graphs, the draft's too (safe to call more
        than once)."""
        for graph in self._graphs.values():
            graph.close()
        self._graphs = {}
        if self.draft is not None:
            self.draft.close()

    # ------------------------------------------------------------------ #
    # host-side block accounting (the batcher's admission predicate)
    # ------------------------------------------------------------------ #
    def _prefix_lookup(self, prompt, prompt_len):
        """Walk the prefix index for ``prompt``'s leading blocks:
        ``(hits, novel, partial_hit)`` — the physical blocks already
        holding a contiguous leading run (the chained keys make the
        first miss terminal), ``{logical index: key}`` of the blocks this
        request computes (registered after its prefill lands), and the
        shared partial-tail block or ``None`` (decode writes into it, so
        admission pre-funds its copy)."""
        if not self.prefix_caching or prompt is None:
            return [], {}, None
        toks = np.asarray(prompt).reshape(-1)[:int(prompt_len)]
        full_keys, partial_key = kv_cache.prefix_block_keys(
            toks, self.kv_block_len)
        hits, novel, partial_hit = [], {}, None
        miss = False
        for j, key in enumerate(full_keys):
            phys = None if miss else self._prefix_index.get(key)
            if phys is None:
                miss = True
                novel[j] = key
            else:
                hits.append(phys)
        if partial_key is not None:
            j = len(full_keys)
            phys = None if miss else self._prefix_index.get(partial_key)
            if phys is None:
                novel[j] = partial_key
            else:
                hits.append(phys)
                partial_hit = phys
        return hits, novel, partial_hit

    def blocks_needed(self, prompt_len: int, max_new_tokens: int,
                      prompt=None) -> int:
        """Pool blocks a request reserves: ``min(prompt + budget,
        max_len)`` rounded up to blocks (0 under the dense layout).
        Under prefix caching, with ``prompt`` given, the charge drops to
        the novel suffix, plus one copy-on-write reserve when the
        partial tail is shared."""
        if self.kv_layout != "paged":
            return 0
        span = min(int(prompt_len) + int(max_new_tokens), self.max_len)
        n = kv_cache.blocks_for(span, self.kv_block_len)
        hits, _, partial_hit = self._prefix_lookup(prompt, prompt_len)
        return n - len(hits) + (1 if partial_hit is not None else 0)

    @property
    def free_blocks(self) -> int:
        return (self._allocator.free_blocks
                if self._allocator is not None else 0)

    def reserve_slot(self, slot: int, prompt_len: int,
                     max_new_tokens: int, prompt=None) -> int:
        """Map a request's blocks into ``slot``'s table row (paged; dense
        is a no-op).  Under prefix caching the shared leading blocks take
        another reference instead of being allocated.  Returns the
        number of prefix-hit blocks.  Raises :class:`~autodist_tpu_torch
        .serving.kv_cache.PoolExhaustedError`, before any reference
        moves, when the pool cannot cover it."""
        if self._allocator is None:
            return 0
        if self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} already holds blocks "
                             f"{self._slot_blocks[slot]}")
        span = min(int(prompt_len) + int(max_new_tokens), self.max_len)
        n = kv_cache.blocks_for(span, self.kv_block_len)
        hits, novel, partial_hit = self._prefix_lookup(prompt, prompt_len)
        n_hit = len(hits)
        new_blocks = self._allocator.alloc(
            n - n_hit + (1 if partial_hit is not None else 0))
        if partial_hit is not None:
            # The first generated token lands in the shared partial
            # tail: park its replacement for the copy-on-write.
            self._cow_reserve.setdefault(partial_hit, []).append(
                new_blocks.pop())
        for b in hits:
            self._allocator.share(b)
        blocks = hits + new_blocks
        self._slot_blocks[slot] = blocks
        self._write_from[slot] = n_hit
        self._slot_hits[slot] = n_hit
        if novel:
            self._pending_register[slot] = novel
        # Tail-fill the row with the slot's LAST block: an over-decode
        # position past the reservation (a final window's overshoot, or
        # the clamped >= max_len write) then routes into the slot's own
        # tail block — never block 0, which may be another slot's.
        self._table[slot, :] = blocks[-1]
        self._table[slot, :n] = blocks
        self._sync_table()
        self._emit_block_gauges()
        if self.draft is not None:
            self.draft.reserve_slot(slot, prompt_len, max_new_tokens)
        return n_hit

    def _trim_reserves(self, block: int) -> None:
        """Keep one copy-on-write reserve per extra reference on
        ``block`` and return the surplus to the pool."""
        pool = self._cow_reserve.get(block)
        if pool is None:
            return
        want = max(self._allocator.refcount(block) - 1, 0)
        while len(pool) > want:
            self._allocator.free_one(pool.pop())
        if not pool:
            del self._cow_reserve[block]

    def _free_blocks(self, blocks) -> None:
        """Drop one reference per block; a block freed for good retires
        its prefix-index entry, a shared survivor sheds surplus
        reserves."""
        for b in blocks:
            if self._allocator.free_one(b):
                key = self._block_keys.pop(b, None)
                if key is not None and self._prefix_index.get(key) == b:
                    del self._prefix_index[key]
            self._trim_reserves(b)

    def release_slot(self, slot: int) -> None:
        """Return ``slot``'s blocks (paged; dense is a no-op): one
        reference a block, so shared prefixes outlive their sharers.  The
        pool rows keep their stale content, unreachable behind the next
        owner's length mask."""
        if self._allocator is not None and self._slot_blocks[slot]:
            self._free_blocks(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._table[slot, :] = 0
            self._pending_register.pop(slot, None)
            self._write_from[slot] = 0
            self._slot_hits[slot] = 0
            self._sync_table()
            self._emit_block_gauges()
        if self.draft is not None:
            self._spec_catch[slot] = False
            self.draft.release_slot(slot)

    def block_accounting(self) -> tuple:
        """``(free, used, total)`` pool blocks; ``(0, 0, 0)`` dense."""
        if self._allocator is None:
            return (0, 0, 0)
        return (self._allocator.free_blocks, self._allocator.used_blocks,
                self.kv_num_blocks)

    def release_all_slots(self) -> None:
        for slot in range(self.num_slots):
            self.release_slot(slot)

    def _emit_block_gauges(self):
        telemetry.gauge("serve/kv_blocks_free").set(
            self._allocator.free_blocks)
        telemetry.gauge("serve/kv_blocks_used").set(
            self._allocator.used_blocks)

    def _sync_table(self):
        """Copy the host table into the device table in place, so that
        ``engine.cache`` is always the complete decode state."""
        self.cache.block_table.copy_(torch.from_numpy(self._table))

    # ------------------------------------------------------------------ #
    # copy-on-write and prefix registration
    # ------------------------------------------------------------------ #
    def _cow_protect(self, active, lengths, n: int) -> None:
        """Before a dispatch writes positions ``[L, L + n)`` of each
        active slot: a table entry in that span whose block is shared
        (refcount > 1) is copied into the slot's pre-funded reserve, in
        place in the pool, and the slot's row redirected, so that no
        write goes through a shared entry.  Every block of the span is
        noted as a ``write`` event."""
        if self._allocator is None:
            return
        bl = self.kv_block_len
        max_blocks = self._table.shape[1]
        changed = False
        for slot in range(self.num_slots):
            if not active[slot]:
                continue
            L = int(lengths[slot])
            lo = L // bl
            hi = min((L + n - 1) // bl, max_blocks - 1)
            for j in range(lo, hi + 1):
                b = int(self._table[slot, j])
                if self._allocator.refcount(b) > 1:
                    pool = self._cow_reserve.get(b)
                    if not pool:
                        raise RuntimeError(
                            f"shared block {b} in slot {slot}'s write "
                            "span has no copy-on-write reserve — "
                            "admission must pre-fund every extra "
                            "reference on a writable block")
                    r = pool.pop()
                    if not pool:
                        del self._cow_reserve[b]
                    kv_cache.copy_pool_block(self.cache.k, self.cache.v,
                                             b, r)
                    # Redirect every entry holding b (tail-fill
                    # duplicates included).
                    row = self._table[slot]
                    row[row == b] = r
                    self._slot_blocks[slot] = [
                        r if x == b else x for x in self._slot_blocks[slot]]
                    self._allocator.note("cow", b, r)
                    self._allocator.free_one(b)
                    self._trim_reserves(b)
                    changed = True
                self._allocator.note("write", int(self._table[slot, j]))
        if changed:
            self._sync_table()
            self._emit_block_gauges()

    def _flush_registration(self, admit) -> None:
        """Publish the prefix keys of the blocks the prefill just wrote
        (two same-batch requests with one prefix each keep private
        blocks; the first to flush wins the index)."""
        if not self.prefix_caching:
            return
        for slot in range(self.num_slots):
            pend = self._pending_register.get(slot)
            if not pend or not admit[slot]:
                continue
            blocks = self._slot_blocks[slot]
            for j, key in pend.items():
                if j >= len(blocks) or key in self._prefix_index:
                    continue
                self._prefix_index[key] = blocks[j]
                self._block_keys[blocks[j]] = key
            self._pending_register.pop(slot, None)

    # ------------------------------------------------------------------ #
    # host-side API (the batcher's contract)
    # ------------------------------------------------------------------ #
    @property
    def max_prompt_tokens(self) -> int:
        """Longest admissible prompt: the prefill bucket single-shot;
        the whole context minus one generated token when chunked."""
        return (self.max_len - 1 if self.prefill_chunk is not None
                else self.prefill_len)

    def prefill(self, prompts, p_lens, admit, seeds=None):
        """One prefill over the slot batch: admitted slots adopt their
        prompt's cache rows, length and first generated token (sampled,
        at ``temperature > 0``, under the slot's ``seeds`` entry).
        ``prompts`` is ``[B, max_prompt_tokens]`` (zero-padded).  A
        chunked engine skips the leading chunks that every admitted slot
        has as prefix hits.  Returns the per-slot current token ``[B]``
        (numpy)."""
        prompts_np = np.asarray(prompts)
        p_lens_np = np.asarray(p_lens).astype(np.int32)
        admit_np = np.asarray(admit, bool)
        if seeds is not None:
            self._seeds_host = np.where(
                admit_np, np.asarray(seeds, np.int32),
                self._seeds_host).astype(np.int32)
            self._seeds.copy_(torch.from_numpy(self._seeds_host))
        self._p_lens.copy_(torch.from_numpy(p_lens_np))
        self._admit.copy_(torch.from_numpy(admit_np))
        if self.prefix_caching:
            self._write_from_dev.copy_(torch.from_numpy(self._write_from))
        if self.prefill_chunk is None:
            if prompts_np.shape[1] != self.prefill_len:
                raise ValueError(
                    f"prompts are {prompts_np.shape[1]} wide; the prefill "
                    f"bucket is {self.prefill_len}")
            self._prompts.copy_(torch.from_numpy(
                prompts_np.astype(np.int64)))
            self._launch("prefill", self._prefill_body, self.prefill_graph)
            self.last_prefill_chunks = 1
        else:
            self._chunked_prefill(prompts_np, p_lens_np, admit_np)
        self._flush_registration(admit_np)
        if self.draft is not None:
            # The draft mirrors the resident prompts, so its proposals
            # condition on the same context; its first token is dropped
            # (decode_window aligns it to the target's).
            self.draft.prefill(prompts_np, p_lens_np, admit_np, seeds)
        return self._tok.cpu().numpy()

    def _prefill_body(self):
        """The single-shot prefill on the static buffers."""
        cfg, S, c = self.cfg, self.prefill_len, self.cache
        dev = self.device
        admit, p_lens = self._admit, self._p_lens
        wf = self._write_from_dev if self.prefix_caching else None
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=dev))[None, None]
        x = self._embed(self._prompts, torch.arange(S, device=dev))
        for layer in range(cfg.num_layers):
            x, k, v = _tp_encoder_layer(cfg, self._layers[layer], x, mask,
                                        return_kv=True, **self._tp)
            for arr, kv in ((c.k, k), (c.v, v)):
                if self.kv_layout == "paged":
                    kv_cache.paged_write_prompt(
                        arr, layer, kv, admit, c.block_table,
                        self.kv_block_len, p_lens, write_from=wf)
                else:
                    kv_cache.write_prompt(arr, layer, kv, admit)
        rows = torch.arange(self.num_slots, device=dev)
        last = x[rows, (p_lens.long() - 1).clamp(0, S - 1)]
        # The first token conditions on the p_lens prompt tokens: its
        # draw key.
        self._tok.copy_(torch.where(admit, self._next_token(last, p_lens),
                                    self._tok))
        c.lengths.copy_(torch.where(admit, p_lens, c.lengths))

    def _chunked_prefill(self, prompts_np, p_lens_np, admit_np):
        """Walk the prompts in ``prefill_chunk`` windows, one call (or
        replay) of the chunk program each, the chunk's tokens and start
        copied into its static buffers."""
        C = self.prefill_chunk
        if not admit_np.any():
            self.last_prefill_chunks = 0
            return
        hi_len = int(p_lens_np[admit_np].max())
        n_chunks = kv_cache.blocks_for(hi_len, C)
        padded = np.zeros((self.num_slots, n_chunks * C), np.int64)
        width = min(prompts_np.shape[1], padded.shape[1])
        padded[:, :width] = prompts_np[:, :width]
        # Chunks that every admitted slot holds as prefix hits carry no
        # novel write and no emission: skip them.  The chunk holding a
        # slot's last prompt token always runs (its first token is drawn
        # there).
        first = 0
        if self.prefix_caching:
            first = min(min(int(self._write_from[i]) * self.kv_block_len,
                            int(p_lens_np[i]) - 1)
                        for i in range(self.num_slots) if admit_np[i]) // C
        for ci in range(first, n_chunks):
            self._chunk_toks.copy_(torch.from_numpy(
                np.ascontiguousarray(padded[:, ci * C:(ci + 1) * C])))
            self._chunk_start.fill_(ci * C)
            self._launch("prefill_chunk", self._chunk_body,
                         self.prefill_graph)
        self.last_prefill_chunks = n_chunks - first

    def _chunk_body(self):
        """One prefill chunk on the static buffers: each layer writes the
        chunk's k/v block-granularly through the table, then attends over
        the pool with K7; the slot whose last prompt token falls in the
        chunk emits its first token."""
        C, dev, bl = self.prefill_chunk, self.device, self.kv_block_len
        c, cs = self.cache, self._chunk_start
        admit, p_lens = self._admit, self._p_lens
        wf = self._write_from_dev if self.prefix_caching else None
        starts = torch.zeros(self.num_slots, dtype=torch.int32,
                             device=dev) + cs

        def attend_for_layer(layer):
            def attend(q, k, v):
                for arr, kv in ((c.k, k), (c.v, v)):
                    kv_cache.paged_write_chunk(
                        arr, layer, kv, admit, c.block_table, bl, cs,
                        p_lens, write_from=wf)
                return self._window_attention(q, layer, starts)
            return attend

        x = self._forward(
            self._embed(self._chunk_toks, cs + torch.arange(C, device=dev)),
            attend_for_layer)
        emit = admit & (p_lens > cs) & (p_lens <= cs + C)
        rows = torch.arange(self.num_slots, device=dev)
        last = x[rows, (p_lens.long() - 1 - cs).clamp(0, C - 1)]
        self._tok.copy_(torch.where(emit, self._next_token(last, p_lens),
                                    self._tok))
        c.lengths.copy_(torch.where(emit, p_lens, c.lengths))

    def decode(self, active):
        """One window of ``decode_steps`` tokens; inactive slots hold
        their state (the dense layout still writes their lane at their
        length, which nothing reads).  Returns the emitted tokens
        ``[K, B]`` (numpy; inactive columns repeat the held token)."""
        return self._decode(active, self.decode_steps)

    def decode_one(self, active):
        """A single-token window (its own program): the speculative
        draft's catch-up, feeding the one proposal that a fully accepted
        window verified but the draft never wrote."""
        return self._decode(active, 1)

    def _decode(self, active, steps: int):
        active_np = np.asarray(active, bool)
        if self.kv_layout == "paged":
            self._cow_protect(active_np, self.lengths, steps)
        self._active.copy_(torch.from_numpy(active_np))
        self._launch(f"decode{steps}",
                     functools.partial(self._decode_body, steps),
                     self.decode_graph)
        return self._emitted[steps].cpu().numpy()

    def _decode_body(self, steps: int):
        """The window on the static buffers: ``steps`` token steps over
        the slots that ``_active`` marks, each layer writing the step's
        k/v and attending through K5 or K6; ``_tok``, ``cache.lengths``
        and the window's emitted tokens are written in place."""
        bl = self.kv_block_len
        act = self._active
        step = act.int()
        c = self.cache
        paged = self.kv_layout == "paged"
        tok, lengths = self._tok, c.lengths
        emitted = []

        def attend_for_layer(layer):
            def attend(q, k, v):
                q = q.contiguous()
                if paged:
                    for arr, kv in ((c.k, k), (c.v, v)):
                        kv_cache.paged_write_token(
                            arr, layer, kv, lengths, c.block_table, bl,
                            write_mask=act)
                    return flash_decode_attention_paged(
                        q, c.k[layer], c.v[layer], lengths, c.block_table,
                        block_len=bl, dtype=self.cfg.dtype)
                kv_cache.write_token(c.k, layer, k, lengths)
                kv_cache.write_token(c.v, layer, v, lengths)
                return flash_decode_attention(q, c.k[layer], c.v[layer],
                                              lengths, dtype=self.cfg.dtype)
            return attend

        for _ in range(steps):
            x = self._forward(self._embed(tok[:, None], lengths[:, None]),
                              attend_for_layer)
            # The emitted token conditions on lengths + 1 tokens.
            tok = torch.where(act, self._next_token(x[:, 0], lengths + 1),
                              tok)
            lengths = lengths + step
            emitted.append(tok)
        torch.stack(emitted, out=self._emitted[steps])
        self._tok.copy_(tok)
        c.lengths.copy_(lengths)

    def _verify_body(self):
        """The speculative verify window on the static buffers: the
        current token and the draft's ``k`` proposals (``_verify_in [B,
        k + 1]``) at positions ``lengths + c``, each row's k/v written
        token by token (masked to active slots under the paged layout),
        the window attending from ``starts = lengths`` through K7; the
        target's choice at row ``c`` is drawn at position ``lengths + 1
        + c``, the key the ``c``-th vanilla step uses.  Lengths do not
        move: the host accepts, rejects and rolls back."""
        C = self.speculative + 1
        c, act, bl = self.cache, self._active, self.kv_block_len
        lengths = c.lengths
        paged = self.kv_layout == "paged"
        positions = lengths[:, None] + torch.arange(C, device=self.device)

        def attend_for_layer(layer):
            def attend(q, k, v):
                for r in range(C):
                    for arr, kv in ((c.k, k), (c.v, v)):
                        if paged:
                            kv_cache.paged_write_token(
                                arr, layer, kv[:, r:r + 1], lengths + r,
                                c.block_table, bl, write_mask=act)
                        else:
                            kv_cache.write_token(arr, layer, kv[:, r:r + 1],
                                                 lengths + r)
                return self._window_attention(q, layer, lengths)
            return attend

        x = self._forward(self._embed(self._verify_in, positions),
                          attend_for_layer)
        torch.stack([self._next_token(x[:, r], lengths + 1 + r)
                     for r in range(C)], dim=1, out=self._choices)

    def decode_window(self, active) -> DecodeWindow:
        """The batcher's decode unit.  A vanilla engine emits
        ``decode_steps`` tokens a slot.  A speculative one runs the
        draft's catch-up and proposal windows, one verify window, then
        the host's accept/reject: each slot keeps the longest prefix of
        proposals the target agrees with plus the target's own next
        token, and the rejected tail rolls back by resetting
        ``lengths`` (copied into the captured tensors)."""
        active_np = np.asarray(active, bool)
        B = self.num_slots
        if self.speculative is None:
            toks = self.decode(active_np)
            counts = np.where(active_np, self.decode_steps,
                              0).astype(np.int32)
            z = np.zeros((B,), np.int32)
            return DecodeWindow(tokens=toks, counts=counts,
                                spec_proposed=z, spec_accepted=z.copy())
        ks, draft = self.speculative, self.draft
        # 1. Catch-up: a slot whose last window accepted every proposal
        # verified d_k, which the draft never wrote.
        need = self._spec_catch & active_np
        if need.any():
            draft_tok = draft._tok.cpu().numpy()
            draft._tok.copy_(torch.from_numpy(np.where(
                need, self._spec_catch_tok, draft_tok).astype(np.int32)))
            draft.decode_one(need)
            self._spec_catch &= ~need
        # 2. Align: the draft continues from the target's current token.
        tgt_tok = self._tok.cpu().numpy()
        draft._tok.copy_(torch.from_numpy(tgt_tok))
        # 3. Propose: the draft's window is the k-token proposer.
        proposals = draft.decode(active_np)                  # [k, B]
        # 4. Verify: one target window over [tok, d_1..d_k].
        lengths_np = self.lengths
        if self.kv_layout == "paged":
            self._cow_protect(active_np, lengths_np, ks + 1)
        tokens_in = np.zeros((B, ks + 1), np.int64)
        tokens_in[:, 0] = tgt_tok
        tokens_in[:, 1:] = proposals.T
        self._verify_in.copy_(torch.from_numpy(tokens_in))
        self._active.copy_(torch.from_numpy(active_np))
        self._launch("verify", self._verify_body, self.decode_graph)
        choices = self._choices.cpu().numpy()                # [B, k+1]
        # 5. Accept/reject and roll back: only lengths move; the stale
        # verified rows hide behind them.
        tok_np = tgt_tok.copy()
        new_len = lengths_np.copy()
        draft_len = draft.lengths.copy()
        tokens = np.zeros((ks + 1, B), np.int32)
        counts = np.zeros((B,), np.int32)
        accepted = np.zeros((B,), np.int32)
        proposed = np.zeros((B,), np.int32)
        for i in range(B):
            if not active_np[i]:
                continue
            j = 0
            while j < ks and choices[i, j] == proposals[j, i]:
                j += 1
            m = j + 1
            tokens[:m, i] = choices[i, :m]
            counts[i] = m
            accepted[i] = j
            proposed[i] = ks
            tok_np[i] = choices[i, j]
            new_len[i] = lengths_np[i] + m
            draft_len[i] = lengths_np[i] + min(m, ks)
            if j == ks:
                self._spec_catch[i] = True
                self._spec_catch_tok[i] = proposals[ks - 1, i]
        self._tok.copy_(torch.from_numpy(tok_np.astype(np.int32)))
        self.cache.lengths.copy_(torch.from_numpy(new_len.astype(np.int32)))
        draft.cache.lengths.copy_(torch.from_numpy(
            draft_len.astype(np.int32)))
        return DecodeWindow(tokens=tokens, counts=counts,
                            spec_proposed=proposed, spec_accepted=accepted)

    @property
    def lengths(self):
        return self.cache.lengths.cpu().numpy()
