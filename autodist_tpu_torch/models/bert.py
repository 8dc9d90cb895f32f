"""BERT for masked-LM pretraining.

Counterpart of ``autodist_tpu/models/bert.py``: embeddings (token,
position, segment), the shared encoder, and the MLM head that gathers
the masked positions (a static count per example), transforms them and
decodes against the tied token table (``Embed.attend``).  Parameter
names and layouts are flax's, so a JAX parameter tree converts leaf for
leaf (:func:`autodist_tpu_torch.interop.from_jax_params`):

``token_embed/embedding [V, H]``, ``pos_embed [max_len, H]``,
``segment_embed/embedding [type_vocab, H]``, ``ln_embed``,
``encoder/layer_i/...`` (see :mod:`~autodist_tpu_torch.models
.transformer`), ``mlm_dense``, ``mlm_ln``, ``mlm_bias [V]``.

The token table is cast to ``cfg.dtype`` once per forward and serves
both the lookup and the decode, as flax's ``promote_dtype`` does; the
logits are fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch import cuda_graph
from autodist_tpu_torch.capture import Trainable
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.models.transformer import (DenseGeneral, Embed,
                                                   Encoder, LayerNorm,
                                                   TransformerConfig,
                                                   dropout, normal)


def bert_base(**kw) -> TransformerConfig:
    return TransformerConfig(vocab_size=30522, hidden_size=768, num_layers=12,
                             num_heads=12, mlp_dim=3072, max_len=512, **kw)


def mlm_model_flops_per_example(cfg, seq_len: int, num_masked: int) -> float:
    """Matmul FLOPs of one MLM training example (forward x3), as
    ``bench.py`` counts them for its MFU: encoder matmuls (qkv 6H^2 +
    out 2H^2 + mlp 4 H mlp_dim per token), attention scores and values
    (4 L H per token), and the head (2H^2 transform + 2 H V tied decode
    per masked position)."""
    H, L, V, P = cfg.hidden_size, seq_len, cfg.vocab_size, num_masked
    per_token_layer = 8.0 * H * H + 4.0 * H * cfg.mlp_dim + 4.0 * L * H
    encoder_fwd = L * cfg.num_layers * per_token_layer
    head_fwd = P * (2.0 * H * H + 2.0 * H * V)
    return 3.0 * (encoder_fwd + head_fwd)


class BertModel(nn.Module):
    """Embeddings + encoder + MLM transform head."""

    def __init__(self, cfg: TransformerConfig, generator):
        super().__init__()
        self.cfg = cfg
        H, dev = cfg.hidden_size, generator.device
        self.token_embed = Embed(cfg.vocab_size, H, generator)
        self.pos_embed = nn.Parameter(normal((cfg.max_len, H), 0.02,
                                             generator))
        self.segment_embed = Embed(cfg.type_vocab_size, H, generator)
        self.ln_embed = LayerNorm(H, cfg.dtype, generator)
        self.encoder = Encoder(cfg, generator)
        self.mlm_dense = DenseGeneral((H,), (H,), cfg.dtype, generator)
        self.mlm_ln = LayerNorm(H, cfg.dtype, generator)
        self.mlm_bias = nn.Parameter(torch.zeros(cfg.vocab_size, device=dev))

    def forward(self, batch, generator=None):
        cfg, dtype = self.cfg, self.cfg.dtype
        tokens = batch["input_ids"]                   # [B, L]
        segments = batch.get("segment_ids")           # [B, L]
        mask = batch.get("input_mask")                # [B, L] 1 = real token
        L = tokens.shape[1]
        table = self.token_embed.embedding.to(dtype)
        x = F.embedding(tokens, table) + self.pos_embed[None, :L].to(dtype)
        if segments is not None:
            seg_table = self.segment_embed.embedding.to(dtype)
            x = x + one_hot(segments, seg_table.shape[0], dtype) @ seg_table
        x = dropout(self.ln_embed(x), cfg.dropout_rate, generator)
        attn_mask = None if mask is None else (mask[:, None, None, :] > 0)
        x = self.encoder(x, attn_mask, generator)
        # MLM head: gather the masked positions, transform, decode
        # against the tied table.
        pos = batch["masked_positions"].long()
        gathered = one_hot(pos, L, x.dtype) @ x       # [B, P, H]
        h = self.mlm_ln(F.gelu(self.mlm_dense(gathered), approximate="tanh"))
        return (h.to(dtype) @ table.T).float() + self.mlm_bias


def one_hot(ids, n: int, dtype):
    """``ids``' one-hot rows over ``n`` classes.  A lookup written as a
    product with them is exact, and its backward is a matmul that sums
    repeated ids in a fixed order: on the card, ``torch.gather``'s and
    ``F.embedding``'s backwards add a row picked many times (a position
    masked twice, a two-row segment table) in no fixed order, so two
    runs of one step would differ."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(dtype)


def mlm_loss_head(logits, batch):
    """Masked-LM cross entropy over the static masked positions:
    ``ll = logit[target] - logsumexp(logits)``, weighted, over
    ``max(sum(weights), 1)``."""
    labels = batch["masked_ids"].long()               # [B, P]
    weights = batch["masked_weights"]                 # [B, P]
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target = torch.gather(logits, -1, labels[..., None])[..., 0]
    ll = target - lse
    denom = torch.clamp(weights.sum(), min=1.0)
    loss = -(ll * weights).sum() / denom
    acc = ((logits.argmax(-1) == labels) * weights).sum() / denom
    return loss, {"mlm_accuracy": acc}


def make_mlm_trainable(cfg: TransformerConfig, optimizer, generator, *,
                       with_input_mask: bool = True, device=None):
    """A Trainable for BERT MLM, its parameters drawn from ``generator``
    with flax's default initializers and placed on ``device`` (``None``:
    the card).

    ``with_input_mask=False`` declares that batches come without
    ``input_mask`` — required by attention kernels that only take
    unpadded batches (the flash path).  With ``True`` such a kernel's
    rejection of the padding mask is raised here, as the JAX package's
    init raises it.  Dropout draws from a generator seeded with the
    step's ``rng`` (an integer), or from a captured window's
    :class:`~autodist_tpu_torch.cuda_graph.GraphSeed`, which the runner
    seeds alike before each replay."""
    fn = cfg.attention_fn
    if with_input_mask and getattr(fn, "_adt_flash", False) \
            and not fn.causal:
        raise ValueError(
            "flash attention supports only causal or no masking: build "
            "with with_input_mask=False and feed batches without "
            "input_mask")
    dev = resolve_device(device)
    model = BertModel(cfg, generator).to(dev)
    params = unflatten({name.replace(".", "/"): p.detach()
                        for name, p in model.named_parameters()})
    stochastic = cfg.dropout_rate > 0 or cfg.attention_dropout_rate > 0

    def loss(params, extra, batch, rng):
        flat = {name.replace("/", "."): p
                for name, p in flatten_with_names(params)}
        gen = cuda_graph.dropout_generator(
            rng if stochastic else None, batch["input_ids"].device)
        logits = torch.func.functional_call(model, flat, (batch,),
                                            {"generator": gen})
        l, metrics = mlm_loss_head(logits, batch)
        return l, extra, dict(metrics, loss=l)

    return Trainable(loss, params, optimizer,
                     sparse_params=("token_embed/embedding",))


def synthetic_mlm_batch(seed: int, batch_size, seq_len, num_masked,
                        vocab_size):
    """Random MLM batch with the exact structure of a real one: the JAX
    package's numpy stream for an integer seed, draw for draw."""
    r = np.random.RandomState(seed)
    return {
        "input_ids": r.randint(0, vocab_size, (batch_size, seq_len)).astype(np.int32),
        "segment_ids": r.randint(0, 2, (batch_size, seq_len)).astype(np.int32),
        "input_mask": np.ones((batch_size, seq_len), np.int32),
        "masked_positions": np.sort(
            r.randint(0, seq_len, (batch_size, num_masked)), axis=-1).astype(np.int32),
        "masked_ids": r.randint(0, vocab_size, (batch_size, num_masked)).astype(np.int32),
        "masked_weights": np.ones((batch_size, num_masked), np.float32),
    }
