"""Transformer encoder blocks — the shared modeling stack.

Counterpart of ``autodist_tpu/models/transformer.py``: the same
:class:`TransformerConfig` fields and defaults (``dtype`` is a torch
dtype), the einsum attention, and the encoder as ``nn.Module``s under
the flax modules' names and parameter layouts, so that a flax parameter
tree converts leaf for leaf (:mod:`autodist_tpu_torch.interop`):

* ``attention/qkv`` is a ``DenseGeneral`` with kernel ``[H, 3, heads,
  head_dim]`` and bias ``[3, heads, head_dim]``; ``attention/out`` has
  kernel ``[heads, head_dim, H]``;
* ``Dense`` kernels are ``[in, out]`` (not ``nn.Linear``'s ``[out,
  in]``);
* ``LayerNorm`` has ``scale``/``bias``, eps ``1e-6`` and flax's
  statistics (fp32 mean of squares minus squared mean, clamped at 0).

Parameters are fp32 and every module computes in ``cfg.dtype``, as flax
does with ``dtype=cfg.dtype``.  The MLP's GELU is the tanh form of
``flax.linen.gelu``.  Dropout draws from an explicit ``torch.Generator``
(``None`` turns it off); its bits differ from ``jax.random``'s, so
parity runs at rate 0.  ``cfg.remat`` checkpoints each encoder layer
(``torch.utils.checkpoint``), its recompute redrawing the first pass's
dropout masks.

:class:`TransformerLM` is the decoder-only causal LM (``token_embed``,
``pos_embed``, ``encoder``, ``ln_final``, the tied readout) that
sequence parallelism trains, and :func:`lm_loss_head` its next-token
loss; :func:`make_lm_trainable` builds its trainable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import NEG_INF
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten


@dataclasses.dataclass(unsafe_hash=True)
class TransformerConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.1
    dtype: Any = torch.bfloat16
    remat: bool = False
    attention_fn: Optional[Callable] = None  # (q, k, v, mask, dropout_rng) -> out
    # (local_len, device=) -> position ids on device; None = arange.
    # Sequence-parallel models pass parallel.sequence.global_positions:
    # ids past max_len are NaN-poisoned at the gather (the loss turns
    # NaN at once), and global_positions(max_len=...) rejects them first.
    position_fn: Optional[Callable] = None
    causal: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


# --------------------------------------------------------------------------- #
# flax's default initializers, drawn from a torch.Generator
# --------------------------------------------------------------------------- #
def lecun_normal(shape, fan_in, generator):
    """flax's default kernel init ``lecun_normal``: a normal truncated at
    two standard deviations, rescaled so the variance is ``1 /
    fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


def normal(shape, std, generator):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.normal_(0.0, std, generator=generator)


class Embed(nn.Module):
    """flax ``nn.Embed``'s table, drawn from its default init
    ``variance_scaling(1, "fan_in", "normal", out_axis=0)``: N(0, 1/H)."""

    def __init__(self, num_embeddings: int, features: int, generator):
        super().__init__()
        self.embedding = nn.Parameter(normal(
            (num_embeddings, features), 1.0 / math.sqrt(features),
            generator))


def dropout(x, rate: float, generator):
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    kept values by ``1 / (1 - rate)``; the identity at rate 0 or with no
    generator (deterministic)."""
    if rate == 0.0 or generator is None:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.empty(x.shape, device=x.device).bernoulli_(
        keep_prob, generator=generator).bool()
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def dot_product_attention(q, k, v, mask, *, dropout_rate=0.0,
                          dropout_rng=None, dtype=torch.bfloat16):
    """Plain einsum attention (softmax in fp32 for stability).

    ``q``/``k``/``v``: ``[..., L, heads, head_dim]``; ``mask``
    broadcastable to ``[..., heads, Lq, Lk]`` (True = visible).  Masked
    scores take the finite float32 minimum, as in the JAX package;
    ``dropout_rng`` is a ``torch.Generator`` (or ``None``), or a
    callable ``probs -> probs`` that applies its own dropout.
    """
    depth = q.shape[-1]
    scores = torch.einsum("...qhd,...khd->...hqk", q, k) / math.sqrt(depth)
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dtype)
    probs = (dropout_rng(probs) if callable(dropout_rng)
             else dropout(probs, dropout_rate, dropout_rng))
    return torch.einsum("...hqk,...khd->...qhd", probs, v.to(dtype))


# --------------------------------------------------------------------------- #
# flax layers
# --------------------------------------------------------------------------- #
class DenseGeneral(nn.Module):
    """flax ``Dense``/``DenseGeneral`` over the last ``len(in_shape)``
    axes: kernel ``in_shape + out_shape`` (lecun-normal over the
    flattened ``[prod(in), prod(out)]`` view), zero bias ``out_shape``;
    inputs, kernel and bias are cast to ``dtype`` before the product."""

    def __init__(self, in_shape, out_shape, dtype, generator):
        super().__init__()
        in_shape, out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype, self.n_in = dtype, len(in_shape)
        self.kernel = nn.Parameter(lecun_normal(
            in_shape + out_shape, math.prod(in_shape), generator))
        self.bias = nn.Parameter(torch.zeros(out_shape,
                                             device=generator.device))

    def forward(self, x):
        y = torch.tensordot(x.to(self.dtype), self.kernel.to(self.dtype),
                            dims=self.n_in)
        return y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: fp32 statistics with the fast variance
    ``max(0, E[x^2] - E[x]^2)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``, cast to ``dtype``."""

    def __init__(self, features: int, dtype, generator, eps: float = 1e-6):
        super().__init__()
        self.dtype, self.eps = dtype, eps
        self.scale = nn.Parameter(torch.ones(features,
                                             device=generator.device))
        self.bias = nn.Parameter(torch.zeros(features,
                                             device=generator.device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(self.dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        self.cfg = cfg
        self.qkv = DenseGeneral((cfg.hidden_size,),
                                (3, cfg.num_heads, cfg.head_dim), cfg.dtype,
                                generator)
        self.out = DenseGeneral((cfg.num_heads, cfg.head_dim),
                                (cfg.hidden_size,), cfg.dtype, generator)

    def forward(self, x, mask, generator=None):
        cfg = self.cfg
        q, k, v = self.qkv(x).unbind(-3)
        dropout_rng = (None if cfg.attention_dropout_rate == 0
                       else generator)
        if cfg.attention_fn is not None:
            out = cfg.attention_fn(q, k, v, mask, dropout_rng)
        else:
            out = dot_product_attention(
                q, k, v, mask, dropout_rate=cfg.attention_dropout_rate,
                dropout_rng=dropout_rng, dtype=cfg.dtype)
        return self.out(out)


class MlpBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        self.cfg = cfg
        self.wi = DenseGeneral((cfg.hidden_size,), (cfg.mlp_dim,), cfg.dtype,
                               generator)
        self.wo = DenseGeneral((cfg.mlp_dim,), (cfg.hidden_size,), cfg.dtype,
                               generator)

    def forward(self, x, generator=None):
        h = F.gelu(self.wi(x), approximate="tanh")
        h = dropout(h, self.cfg.dropout_rate, generator)
        return self.wo(h)


class EncoderLayer(nn.Module):
    """Post-norm encoder layer: attention, dropout, residual norm, MLP,
    dropout, residual norm."""

    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        self.cfg = cfg
        self.attention = SelfAttention(cfg, generator)
        self.ln_attention = LayerNorm(cfg.hidden_size, cfg.dtype, generator)
        self.mlp = MlpBlock(cfg, generator)
        self.ln_mlp = LayerNorm(cfg.hidden_size, cfg.dtype, generator)

    def forward(self, x, mask, generator=None):
        rate = self.cfg.dropout_rate
        a = dropout(self.attention(x, mask, generator), rate, generator)
        x = self.ln_attention(x + a)
        m = dropout(self.mlp(x, generator), rate, generator)
        return self.ln_mlp(x + m)


def _rematerialized(layer, x, mask, generator):
    """``layer(x, mask, generator)`` with its activations recomputed in
    the backward instead of kept.  The recompute runs on the weights of
    the first pass (under ``functional_call`` those are not the module's
    own), and it restores the generator's state from before the layer,
    so it redraws the first pass's dropout masks (JAX's ``nn.remat``
    reuses the layer's key).  Inside a captured window (a
    :class:`~autodist_tpu_torch.cuda_graph.GraphSeed` generator) that
    save and restore is not tested."""
    weights = dict(layer.named_parameters())
    state = None if generator is None else generator.get_state()
    passes = []

    def run(x):
        if passes and state is not None:
            generator.set_state(state)
        passes.append(1)
        return torch.func.functional_call(layer, weights,
                                          (x, mask, generator))

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class Encoder(nn.Module):
    """``layer_0`` ... ``layer_{num_layers-1}``, each rematerialized
    under ``cfg.remat``."""

    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        self.num_layers, self.remat = cfg.num_layers, cfg.remat
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(cfg, generator))

    def forward(self, x, mask, generator=None):
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            x = (_rematerialized(layer, x, mask, generator) if self.remat
                 else layer(x, mask, generator))
        return x


class TransformerLM(nn.Module):
    """Decoder-only causal LM: token and position embeddings, the causal
    encoder, a final norm and the readout tied to the token table.

    The positions come from ``cfg.position_fn`` (the global positions
    of a sequence chunk) or ``arange``; ids outside ``[0, max_len)`` are
    clamped for the gather and their rows set to NaN, so the loss goes
    NaN on the first step (a CUDA gather out of range would kill the
    process).  The readout multiplies in ``cfg.dtype``, as flax's
    ``Embed.attend`` promotes both operands to the module's dtype."""

    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.token_embed = Embed(cfg.vocab_size, H, generator)
        self.pos_embed = nn.Parameter(normal((cfg.max_len, H), 0.02,
                                             generator))
        self.encoder = Encoder(cfg, generator)
        self.ln_final = LayerNorm(H, cfg.dtype, generator)

    def forward(self, tokens, generator=None):
        cfg, dtype = self.cfg, self.cfg.dtype
        L, dev = tokens.shape[1], tokens.device
        if cfg.position_fn is not None:
            ids = cfg.position_fn(L, device=dev)
            oob = (ids < 0) | (ids >= cfg.max_len)
            pos = self.pos_embed[ids.clamp(0, cfg.max_len - 1)]
            pos = torch.where(oob[:, None], float("nan"), pos)
        else:
            pos = self.pos_embed[:L]
        table = self.token_embed.embedding.to(dtype)
        x = F.embedding(tokens.long(), table) + pos[None].to(dtype)
        x = dropout(x, cfg.dropout_rate, generator)
        causal = torch.ones(L, L, dtype=torch.bool, device=dev).tril()
        x = self.encoder(x, causal[None, None], generator)
        return self.ln_final(x) @ table.T


def lm_loss_head(logits, batch):
    """Next-token cross entropy with optional per-token weights ``w``:
    ``ll = logit[target] - logsumexp(logits)`` in fp32, over
    ``max(sum(w), 1)``; the metric ``accuracy`` is the weighted share of
    argmax hits."""
    targets = batch["y"].long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None])[..., 0] - lse
    weights = batch.get("w")
    weights = torch.ones_like(ll) if weights is None else weights.float()
    denom = torch.clamp(weights.sum(), min=1.0)
    loss = -(ll * weights).sum() / denom
    acc = ((logits.argmax(-1) == targets) * weights).sum() / denom
    return loss, {"accuracy": acc}


def make_lm_trainable(cfg: TransformerConfig, optimizer, generator, *,
                      device=None):
    """A Trainable for :class:`TransformerLM` with :func:`lm_loss_head`
    on batches ``{"x": tokens [B, L], "y": targets [B, L]}`` (and
    optionally ``"w"``), its parameters drawn from ``generator`` with
    flax's default initializers and placed on ``device`` (``None``: the
    card): the port's ``Trainable.from_flax(TransformerLM(cfg),
    lm_loss_head, ...)``.  Dropout draws from a generator seeded with
    the step's ``rng`` (or a captured window's ``GraphSeed``)."""
    dev = resolve_device(device)
    model = TransformerLM(cfg, generator).to(dev)
    params = unflatten({name.replace(".", "/"): p.detach()
                        for name, p in model.named_parameters()})
    stochastic = cfg.dropout_rate > 0 or cfg.attention_dropout_rate > 0

    def loss_fn(params, batch, rng):
        flat = {name.replace("/", "."): p
                for name, p in flatten_with_names(params)}
        gen = cuda_graph.dropout_generator(rng if stochastic else None,
                                           batch["x"].device)
        logits = torch.func.functional_call(model, flat, (batch["x"],),
                                            {"generator": gen})
        return lm_loss_head(logits, batch)

    return Trainable.from_loss_fn(loss_fn, params, optimizer, with_rng=True)
