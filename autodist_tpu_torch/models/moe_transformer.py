"""Mixture-of-Experts transformer LM (the expert-parallel model family).

Counterpart of ``autodist_tpu/models/moe_transformer.py``: a decoder-only
LM whose MLP blocks are GShard top-2 gated expert layers, as
``nn.Module``s under the flax modules' names, so that a flax parameter
tree converts leaf for leaf (:mod:`autodist_tpu_torch.interop`):

``token_embed/embedding [V, H]``, ``pos_embed [max_len, H]``, per layer
``layer_{i}_attention/{qkv,out}/{kernel,bias}``,
``layer_{i}_ln_attention``, ``layer_{i}_moe/expert_gate [H, E]``,
``layer_{i}_moe/expert_wi [E, H, F]``, ``layer_{i}_moe/expert_wo [E, F,
H]``, ``layer_{i}_ln_moe``, and ``ln_final``.

One parameter set runs two ways: ``expert_sharded=False`` routes tokens
through the dense reference (no collectives, the golden semantics);
``expert_sharded=True`` runs inside the ``ExpertParallel`` lowering,
where each rank holds ``E / expert_axis`` experts and tokens travel by
all-to-all.  The MoE block computes in fp32; attention and norms in
``cfg.dtype``; the tied-embedding logits as flax's ``Embed.attend``
computes them (both operands in ``cfg.dtype``), then fp32 for the loss.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch import const
from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models.transformer import (Embed, LayerNorm,
                                                   SelfAttention,
                                                   TransformerConfig, normal)
from autodist_tpu_torch.parallel.axis import bound_axis
from autodist_tpu_torch.parallel.moe import (dense_moe_reference,
                                             expert_capacity,
                                             expert_parallel_ffn)


@dataclasses.dataclass(unsafe_hash=True)
class MoeConfig:
    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    expert_hidden: int = 1024
    num_experts: int = 8
    capacity_factor: float = 2.0
    max_len: int = 512
    aux_weight: float = 0.01
    dtype: Any = torch.bfloat16

    def encoder_cfg(self) -> TransformerConfig:
        return TransformerConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_layers=self.num_layers, num_heads=self.num_heads,
            mlp_dim=self.expert_hidden, max_len=self.max_len,
            dropout_rate=0.0, attention_dropout_rate=0.0,
            dtype=self.dtype, causal=True)


class MoeBlock(nn.Module):
    """Top-2 gated expert MLP over the flattened tokens, in fp32.  With
    ``expert_sharded`` the tables hold this rank's experts and the
    expert axis is the one the lowering binds by name
    (:func:`~autodist_tpu_torch.parallel.axis.bound_axis`)."""

    def __init__(self, cfg: MoeConfig, expert_sharded: bool, generator):
        super().__init__()
        self.cfg, self.expert_sharded = cfg, expert_sharded
        H, E, Fh = cfg.hidden_size, cfg.num_experts, cfg.expert_hidden
        self.expert_gate = nn.Parameter(normal((H, E), 0.02, generator))
        self.expert_wi = nn.Parameter(normal((E, H, Fh), 0.02 / math.sqrt(H),
                                             generator))
        self.expert_wo = nn.Parameter(normal((E, Fh, H),
                                             0.02 / math.sqrt(Fh), generator))

    def forward(self, x, a2a=(None, False)):
        cfg = self.cfg
        B, L, H = x.shape
        tokens = x.reshape(B * L, H).float()
        if self.expert_sharded:
            precision, kernel = a2a
            out, aux = expert_parallel_ffn(
                tokens, self.expert_gate, self.expert_wi, self.expert_wo,
                bound_axis(const.EXPERT_AXIS),
                capacity_factor=cfg.capacity_factor,
                a2a_precision=precision, a2a_kernel=kernel)
        else:
            capacity = expert_capacity(tokens.shape[0],
                                       cfg.capacity_factor, cfg.num_experts)
            out, aux = dense_moe_reference(tokens, self.expert_gate,
                                           self.expert_wi, self.expert_wo,
                                           capacity)
        return out.reshape(B, L, H).to(x.dtype), aux


class MoeTransformerLM(nn.Module):
    """Decoder-only LM: attention blocks and MoE blocks, post-norm."""

    def __init__(self, cfg: MoeConfig, generator, expert_sharded=False):
        super().__init__()
        self.cfg = cfg
        enc, H = cfg.encoder_cfg(), cfg.hidden_size
        self.token_embed = Embed(cfg.vocab_size, H, generator)
        self.pos_embed = nn.Parameter(normal((cfg.max_len, H), 0.02,
                                             generator))
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}_attention",
                            SelfAttention(enc, generator))
            self.add_module(f"layer_{i}_ln_attention",
                            LayerNorm(H, cfg.dtype, generator))
            self.add_module(f"layer_{i}_moe",
                            MoeBlock(cfg, expert_sharded, generator))
            self.add_module(f"layer_{i}_ln_moe",
                            LayerNorm(H, cfg.dtype, generator))
        self.ln_final = LayerNorm(H, cfg.dtype, generator)

    def forward(self, tokens, a2a=(None, False)):
        cfg, dtype = self.cfg, self.cfg.dtype
        L = tokens.shape[1]
        table = self.token_embed.embedding.to(dtype)
        x = F.embedding(tokens.long(), table) \
            + self.pos_embed[None, :L].to(dtype)
        causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=tokens.device))[None, None]
        aux_total = 0.0
        for i in range(cfg.num_layers):
            a = getattr(self, f"layer_{i}_attention")(x, causal)
            x = getattr(self, f"layer_{i}_ln_attention")(x + a)
            m, aux = getattr(self, f"layer_{i}_moe")(x, a2a)
            aux_total = aux_total + aux
            x = getattr(self, f"layer_{i}_ln_moe")(x + m)
        x = self.ln_final(x)
        logits = (x.to(dtype) @ table.T).float()
        return logits, aux_total / cfg.num_layers


def make_moe_lm_trainable(cfg: MoeConfig, optimizer, generator, *,
                          batch_size=4, seq_len=64,
                          expert_sharded: bool = True, device=None):
    """The MoE LM as a :class:`~autodist_tpu_torch.capture.Trainable`,
    its parameters drawn from ``generator`` with the flax modules'
    initializers and placed on ``device`` (``None``: the card); to hold
    it to the JAX package, set ``.params`` to
    :func:`~autodist_tpu_torch.interop.from_jax_params` of the JAX
    trainable's tree.  ``expert_sharded=True`` routes tokens by
    all-to-all for the ``ExpertParallel`` strategy; ``False`` is the
    dense one-process semantics.  Batches are ``{"x": [B, L] tokens,
    "y": [B, L] next tokens}``; the loss is ``nll + aux_weight * aux``.

    The trainable carries the ``moe_a2a`` slot, which the expert
    lowering fills with the strategy's ``moe_a2a`` precision and
    ``a2a_ring`` election, and the MoE shape (``num_experts``,
    ``capacity_factor``, ``tokens_per_step = batch_size * seq_len``)."""
    dev = resolve_device(device)
    model = MoeTransformerLM(cfg, generator,
                             expert_sharded=expert_sharded).to(dev)
    params = unflatten({name.replace(".", "/"): p.detach()
                        for name, p in model.named_parameters()})
    a2a_slot = {"precision": None, "kernel": False}

    def loss(p, extra, batch, rng):
        flat = {name.replace("/", "."): t for name, t in flatten_with_names(p)}
        logits, aux = torch.func.functional_call(
            model, flat, (batch["x"],),
            {"a2a": (a2a_slot["precision"], a2a_slot["kernel"])})
        logp = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, batch["y"].long()[..., None])
        nll = -ll.mean()
        total = nll + cfg.aux_weight * aux
        return total, extra, {"loss": total, "nll": nll, "aux": aux}

    t = Trainable(loss, params, optimizer)
    t.name = "moe_lm"
    t.moe_a2a = a2a_slot
    t.num_experts = cfg.num_experts
    t.capacity_factor = cfg.capacity_factor
    t.tokens_per_step = batch_size * seq_len
    return t
