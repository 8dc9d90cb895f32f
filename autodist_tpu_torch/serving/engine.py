"""Batched-inference engine for the pipelined LM, on one GPU.

Counterpart of ``autodist_tpu/serving/engine.py`` at tensor parallel 1
with greedy decoding.  The same host-side contract — ``prefill`` /
``decode_window`` over a fixed slot batch, block accounting for the
paged layout — drives the same model math
(:func:`~autodist_tpu_torch.models.pipeline_lm._tp_encoder_layer`):

* **prefill** runs the zero-padded prompt bucket through every layer
  with the plain causal attention, fills the cache and emits each
  admitted slot's first token; under ``prefill_chunk`` (paged only) it
  walks the prompt in chunks whose attention is the paged flash-prefill
  kernel (K7);
* **decode** runs ``decode_steps`` token steps per window: each layer
  writes the step's k/v into the cache and attends through the dense
  (K5) or paged (K6) flash-decode kernel.

Attention over the cache always goes through the kernel wrappers: on
the card they launch the CUDA kernels, on CPU tensors they run the
kernels' plain versions.  ``kernel=`` is validated and recorded for
signature parity with the JAX engine; it selects nothing.

JAX donates the cache into its compiled programs; here the cache
tensors are updated **in place** and ``engine.cache`` keeps the same
``k``/``v`` tensors for the engine's life.  PyTorch runs eagerly, so
there are no compiled programs: a window is a host loop of kernel
launches with one host sync at its end.

Everything outside the serving slice raises ``NotImplementedError``
naming its ROADMAP item: tensor/vocab parallelism and ``comm_overlap``,
sampling (``temperature``/``top_k``), speculative decoding, prefix
caching, ``cfg.attention_fn``, and the runner/artifact constructors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.flash_decode import (
    flash_decode_attention, flash_decode_attention_paged)
from autodist_tpu_torch.kernel.flash_prefill import \
    flash_prefill_attention_paged
from autodist_tpu_torch.models.pipeline_lm import (_layer_norm,
                                                   _tp_encoder_layer,
                                                   layer_params, tree_map)
from autodist_tpu_torch.parallel.tensor import (vocab_parallel_embedding,
                                                vocab_parallel_greedy_token)
from autodist_tpu_torch.serving import kv_cache
from autodist_tpu_torch.strategy.ir import (normalize_kernel,
                                            normalize_kv_layout,
                                            normalize_prefill_chunk,
                                            normalize_prefix_caching,
                                            normalize_speculative)
from autodist_tpu_torch import telemetry

_REST_OF_SERVING = "ROADMAP Queue 1, slice 4: the rest of serving"


def _not_ported(what: str, item: str = _REST_OF_SERVING):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass
class DecodeWindow:
    """One decode window's host-visible outcome: ``tokens [n, B]`` with
    column ``i`` valid through ``counts[i]``; the speculative counters
    stay zero (vanilla decode only)."""

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
    :func:`~autodist_tpu_torch.models.pipeline_lm.init_pipeline_lm_params`
    or :func:`~autodist_tpu_torch.interop.from_jax_params`.  The knobs
    mean what they mean to the JAX engine: ``num_slots`` batch slots,
    the ``prefill_len`` prompt bucket, ``decode_steps`` tokens per
    window, ``kv_layout`` ``"dense"`` or ``"paged"`` (a pool of
    ``kv_num_blocks`` blocks of ``kv_block_len`` positions, admitted
    against free blocks), ``prefill_chunk`` (paged only).

    ``device=None`` means the card and raises ``RuntimeError`` where
    there is none; pass ``device="cpu"`` to run the plain path.
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
                 device=None):
        self.cfg = cfg
        self.kernel = normalize_kernel(kernel)
        if cfg.attention_fn is not None:
            _not_ported("serving a cfg.attention_fn (the flash-attention "
                        "forward K1 comes with the training path)",
                        "ROADMAP Queue 1, slice 2: the training path")
        if cfg.dropout_rate or cfg.attention_dropout_rate:
            raise ValueError(
                "serving requires dropout_rate == "
                "attention_dropout_rate == 0 (inference mode)")
        tp = int(tensor_parallel)
        if tp < 1:
            raise ValueError("tensor_parallel must be >= 1")
        if tp > 1:
            _not_ported("tensor_parallel > 1")
        if vocab_parallel:
            _not_ported("vocab_parallel")
        if comm_overlap:
            _not_ported("comm_overlap")
        self.tensor_parallel = 1
        self.vocab_parallel = False
        self.comm_overlap = None
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
        if self.kv_layout == "paged" \
                and self.kv_num_blocks < self.max_blocks:
            raise ValueError(
                f"kv_num_blocks={self.kv_num_blocks} cannot hold even "
                f"one full-length request ({self.max_blocks} blocks of "
                f"{self.kv_block_len})")
        self.prefill_chunk = normalize_prefill_chunk(prefill_chunk)
        if self.prefill_chunk is not None:
            if self.kv_layout != "paged":
                raise ValueError(
                    "prefill_chunk writes prompt chunks through the "
                    "block table — it requires kv_layout='paged'")
            if self.prefill_chunk % self.kv_block_len:
                raise ValueError(
                    f"prefill_chunk={self.prefill_chunk} must be a "
                    f"multiple of kv_block_len={self.kv_block_len} so "
                    "chunk writes stay block-granular")
        self.prefix_caching = normalize_prefix_caching(prefix_caching)
        if self.prefix_caching:
            _not_ported("prefix_caching")
        self.speculative = normalize_speculative(speculative)
        if self.speculative is not None or draft_cfg is not None \
                or draft_params is not None:
            _not_ported("speculative decoding")
        self.temperature = float(temperature)
        if self.temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        self.top_k = int(top_k)
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.temperature > 0.0 or self.top_k > 0:
            _not_ported("sampling (temperature > 0 or top_k)")

        self.device = resolve_device(device)
        dev, dtype = self.device, cfg.dtype
        self.params = tree_map(lambda t: torch.as_tensor(t).to(dev), params)
        self._shared = self.params["shared"]
        self._layers = [
            _matmul_weights(layer_params(self.params["stages"], i), dtype)
            for i in range(cfg.num_layers)]

        self._tok = torch.zeros(self.num_slots, dtype=torch.int32,
                                device=dev)
        if self.kv_layout == "paged":
            self.cache = kv_cache.init_paged_cache(
                cfg.num_layers, self.num_slots, cfg.num_heads,
                cfg.head_dim, self.max_len, block_len=self.kv_block_len,
                num_blocks=self.kv_num_blocks, dtype=dtype, device=dev)
            # Host-side block accounting: the free list and the numpy
            # mirror of the device block table.
            self._allocator = kv_cache.BlockAllocator(self.kv_num_blocks)
            self._table = np.zeros((self.num_slots, self.max_blocks),
                                   np.int32)
            self._slot_blocks: list = [[] for _ in range(self.num_slots)]
            self._emit_block_gauges()
        else:
            self.cache = kv_cache.init_cache(
                cfg.num_layers, self.num_slots, cfg.num_heads,
                cfg.head_dim, self.max_len, dtype=dtype, device=dev)
            self._allocator = None
        self.last_prefill_chunks = 0

    @classmethod
    def from_runner(cls, runner, cfg, *, strategy=None, **kw):
        _not_ported("ServingEngine.from_runner (it needs the training "
                    "runner)", "ROADMAP Queue 1, slice 2: the training "
                    "path")

    @classmethod
    def from_artifact(cls, path: str, cfg, **kw):
        _not_ported("ServingEngine.from_artifact (checkpoint/export)")

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
        x = vocab_parallel_embedding(tokens, self._shared["embedding"])
        table = self._shared["pos_embed"]
        positions = positions.long()
        pos = table[positions.clamp(0, table.shape[0] - 1)]
        oob = (positions < 0) | (positions >= table.shape[0])
        pos = torch.where(oob[..., None], float("nan"), pos)
        return x.to(dtype) + pos.to(dtype)

    def _greedy(self, h):
        """Next token ``[B]`` int32 from last-position hidden states."""
        x = _layer_norm(h, self._shared["ln_final_scale"],
                        self._shared["ln_final_bias"])
        tok, _ = vocab_parallel_greedy_token(
            x, self._shared["embedding"], vocab_size=self.cfg.vocab_size)
        return tok

    def _forward(self, x, attend_for_layer):
        for layer in range(self.cfg.num_layers):
            x = _tp_encoder_layer(self.cfg, self._layers[layer], x, None,
                                  attend=attend_for_layer(layer))
        return x

    # ------------------------------------------------------------------ #
    # host-side block accounting (the batcher's admission predicate)
    # ------------------------------------------------------------------ #
    def blocks_needed(self, prompt_len: int, max_new_tokens: int,
                      prompt=None) -> int:
        """Pool blocks a request reserves: ``min(prompt + budget,
        max_len)`` rounded up to blocks (0 under the dense layout).
        ``prompt`` is accepted for parity; without prefix caching it
        changes nothing."""
        if self.kv_layout != "paged":
            return 0
        span = min(int(prompt_len) + int(max_new_tokens), self.max_len)
        return kv_cache.blocks_for(span, self.kv_block_len)

    @property
    def free_blocks(self) -> int:
        return (self._allocator.free_blocks
                if self._allocator is not None else 0)

    def reserve_slot(self, slot: int, prompt_len: int,
                     max_new_tokens: int, prompt=None) -> int:
        """Map a request's blocks into ``slot``'s table row (paged; dense
        is a no-op).  Returns the number of prefix-hit blocks (always 0
        here).  Raises :class:`~autodist_tpu_torch.serving.kv_cache
        .PoolExhaustedError` when the pool cannot cover it."""
        if self._allocator is None:
            return 0
        if self._slot_blocks[slot]:
            raise ValueError(f"slot {slot} already holds blocks "
                             f"{self._slot_blocks[slot]}")
        blocks = self._allocator.alloc(
            self.blocks_needed(prompt_len, max_new_tokens))
        self._slot_blocks[slot] = blocks
        # Tail-fill the row with the slot's LAST block: an over-decode
        # position past the reservation (a final window's overshoot, or
        # the clamped >= max_len write) then routes into the slot's own
        # tail block — never block 0, which may be another slot's.
        self._table[slot, :] = blocks[-1]
        self._table[slot, :len(blocks)] = blocks
        self._sync_table()
        self._emit_block_gauges()
        return 0

    def release_slot(self, slot: int) -> None:
        """Return ``slot``'s blocks to the free list (paged; dense is a
        no-op).  The pool rows keep their stale content, unreachable
        behind the next owner's length mask."""
        if self._allocator is not None and self._slot_blocks[slot]:
            self._allocator.free(self._slot_blocks[slot])
            self._slot_blocks[slot] = []
            self._table[slot, :] = 0
            self._sync_table()
            self._emit_block_gauges()

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
        prompt's cache rows, length and first generated token.
        ``prompts`` is ``[B, max_prompt_tokens]`` (zero-padded);
        ``seeds`` is accepted for parity (greedy decoding ignores it).
        Returns the per-slot current token ``[B]`` (numpy)."""
        del seeds
        dev = self.device
        prompts_np = np.asarray(prompts)
        p_lens_t = torch.as_tensor(np.asarray(p_lens), device=dev).int()
        admit_np = np.asarray(admit, bool)
        admit_t = torch.as_tensor(admit_np, device=dev)
        if self.prefill_chunk is None:
            if prompts_np.shape[1] != self.prefill_len:
                raise ValueError(
                    f"prompts are {prompts_np.shape[1]} wide; the prefill "
                    f"bucket is {self.prefill_len}")
            self._prefill_bucket(prompts_np, p_lens_t, admit_t)
            self.last_prefill_chunks = 1
        else:
            self._chunked_prefill(prompts_np, p_lens_t, admit_np, admit_t)
        return self._tok.cpu().numpy()

    def _prefill_bucket(self, prompts_np, p_lens_t, admit_t):
        cfg, dev, S = self.cfg, self.device, self.prefill_len
        c = self.cache
        paged = self.kv_layout == "paged"
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=dev))[None, None]
        x = self._embed(torch.as_tensor(prompts_np, device=dev),
                        torch.arange(S, device=dev))
        for layer in range(cfg.num_layers):
            x, k, v = _tp_encoder_layer(cfg, self._layers[layer], x, mask,
                                        return_kv=True)
            if paged:
                for arr, kv in ((c.k, k), (c.v, v)):
                    kv_cache.paged_write_prompt(
                        arr, layer, kv, admit_t, c.block_table,
                        self.kv_block_len, p_lens_t)
            else:
                kv_cache.write_prompt(c.k, layer, k, admit_t)
                kv_cache.write_prompt(c.v, layer, v, admit_t)
        rows = torch.arange(self.num_slots, device=dev)
        last = x[rows, (p_lens_t.long() - 1).clamp(0, S - 1)]
        self._tok = torch.where(admit_t, self._greedy(last), self._tok)
        c.lengths = torch.where(admit_t, p_lens_t, c.lengths)

    def _chunked_prefill(self, prompts_np, p_lens_t, admit_np, admit_t):
        """Walk the prompts in ``prefill_chunk`` windows: each writes its
        k/v block-granularly through the table, then attends over the
        pool with the paged flash-prefill kernel; the slot whose last
        prompt token falls in a chunk emits its first token there."""
        C, dev, bl = self.prefill_chunk, self.device, self.kv_block_len
        if not admit_np.any():
            self.last_prefill_chunks = 0
            return
        p_lens_np = p_lens_t.cpu().numpy()
        hi_len = int(p_lens_np[admit_np].max())
        n_chunks = kv_cache.blocks_for(hi_len, C)
        padded = np.zeros((self.num_slots, n_chunks * C), np.int64)
        width = min(prompts_np.shape[1], padded.shape[1])
        padded[:, :width] = prompts_np[:, :width]
        tokens = torch.as_tensor(padded, device=dev)
        c = self.cache
        rows = torch.arange(self.num_slots, device=dev)
        for ci in range(n_chunks):
            cs = ci * C
            starts = torch.full((self.num_slots,), cs, dtype=torch.int32,
                                device=dev)

            def attend_for_layer(layer, cs=cs, starts=starts):
                def attend(q, k, v):
                    for arr, kv in ((c.k, k), (c.v, v)):
                        kv_cache.paged_write_chunk(
                            arr, layer, kv, admit_t, c.block_table, bl, cs,
                            p_lens_t)
                    return flash_prefill_attention_paged(
                        q.contiguous(), c.k[layer], c.v[layer], starts,
                        c.block_table, block_len=bl, dtype=self.cfg.dtype)
                return attend

            x = self._forward(
                self._embed(tokens[:, cs:cs + C],
                            cs + torch.arange(C, device=dev)),
                attend_for_layer)
            emit = admit_t & (p_lens_t > cs) & (p_lens_t <= cs + C)
            last = x[rows, (p_lens_t.long() - 1 - cs).clamp(0, C - 1)]
            self._tok = torch.where(emit, self._greedy(last), self._tok)
            c.lengths = torch.where(emit, p_lens_t, c.lengths)
        self.last_prefill_chunks = n_chunks

    def decode(self, active):
        """One window of ``decode_steps`` tokens; inactive slots hold
        their state (the dense layout still writes their lane at their
        length, which nothing reads).  Returns the emitted tokens
        ``[K, B]`` (numpy; inactive columns repeat the held token)."""
        dev, bl = self.device, self.kv_block_len
        act = torch.as_tensor(np.asarray(active, bool), device=dev)
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

        for _ in range(self.decode_steps):
            x = self._forward(self._embed(tok[:, None], lengths[:, None]),
                              attend_for_layer)
            # The emitted token conditions on lengths + 1 tokens.
            tok = torch.where(act, self._greedy(x[:, 0]), tok)
            lengths = lengths + step
            emitted.append(tok)
        self._tok, c.lengths = tok, lengths
        return torch.stack(emitted).cpu().numpy()

    def decode_window(self, active) -> DecodeWindow:
        """The batcher's decode unit: ``decode_steps`` tokens per active
        slot."""
        active_np = np.asarray(active, bool)
        toks = self.decode(active_np)
        counts = np.where(active_np, self.decode_steps, 0).astype(np.int32)
        z = np.zeros((self.num_slots,), np.int32)
        return DecodeWindow(tokens=toks, counts=counts, spec_proposed=z,
                            spec_accepted=z.copy())

    @property
    def lengths(self):
        return self.cache.lengths.cpu().numpy()
