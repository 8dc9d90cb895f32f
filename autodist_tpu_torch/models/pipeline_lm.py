"""The pipelined transformer LM's math, as the serving engine runs it.

Counterpart of ``autodist_tpu/models/pipeline_lm.py``.  Parameters are
a plain dict tree in the JAX package's logical layout
(``{"stages": ..., "shared": ...}``, each stage leaf stacked over
layers), so one tree converts between the packages leaf by leaf
(:mod:`autodist_tpu_torch.interop`) and the engine reads each layer as
``tree[...][layer]``:

* ``stages/attention/qkv/kernel`` ``[L, H, 3, heads, head_dim]``,
  ``.../bias`` ``[L, 3, heads, head_dim]``;
* ``stages/attention/out/kernel`` ``[L, heads, head_dim, H]``,
  ``.../bias`` ``[L, H]``;
* ``stages/mlp/wi/kernel`` ``[L, H, mlp]`` and ``stages/mlp/wo/kernel``
  ``[L, mlp, H]`` with their biases;
* ``stages/ln_attention`` and ``stages/ln_mlp`` ``{"scale", "bias"}``
  ``[L, H]``;
* ``shared/{embedding [V, H], pos_embed [max_len, H], ln_final_scale,
  ln_final_bias}``.

:func:`make_pipeline_lm_trainable` declares the model as a
:class:`~autodist_tpu_torch.capture.PipelineTrainable` (one encoder
layer per stage) for the ``Pipeline`` strategy, whose lowering passes
``model_axis`` (and ``comm_overlap``) to the stages under
``tensor_parallel > 1``: the layer then runs on its Megatron shards with
the boundaries of :mod:`autodist_tpu_torch.parallel.tensor`.

With dropout the trainable is ``stage_rng``: each mask is drawn
counter-based (:func:`keyed_dropout`), keyed on (global chunk, global
row, site, element), so the pipelined schedule draws the sequential
loss's masks for any microbatching and a captured window replays it
with no generator state.  The masks are not flax's (flax folds module
paths into its keys); the JAX package's contract, pipelined equals
sequential, is what holds.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from autodist_tpu_torch.capture import PipelineTrainable, stage_slice
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.models.losses import cross_entropy_from_logits
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   dot_product_attention,
                                                   lecun_normal)
from autodist_tpu_torch.ops import threefry
from autodist_tpu_torch.parallel.tensor import (
    column_parallel, row_parallel, vocab_parallel_cross_entropy,
    vocab_parallel_embedding)


def _layer_norm(x, scale, bias):
    """The loss head's norm: centred variance, eps 1e-6, fp32 result."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias


def _flax_layer_norm(x, p, dtype, eps=1e-6):
    """``flax.linen.LayerNorm`` numerics on a ``{"scale", "bias"}``
    dict: fp32 statistics with the mean-of-squares variance clamped at
    0 (not the centred formula of :func:`_layer_norm`), cast to
    ``dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dtype)


# The dropout sites of a layer, as flax's EncoderLayer applies them.
SITE_PROBS, SITE_ATTENTION, SITE_MLP_HIDDEN, SITE_MLP = range(4)


def keyed_dropout(x, rate: float, key, rows, site: int):
    """flax ``nn.Dropout`` (keep with probability ``1 - rate``, kept
    values scaled by ``1 / (1 - rate)``) with a counter-based mask: row
    ``b`` of ``x`` keys on ``fold_in(key, rows[b])`` and its element
    ``j`` draws ``threefry.bits_at(row key, site, j)``, kept iff the
    uniform in ``[0, 1)`` its top 23 bits make is below ``1 - rate``.
    No generator state: the mask is a function of ``(key, row, site,
    j)``.  The identity at rate 0 or with no key (eval)."""
    if rate == 0.0 or key is None:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    k0, k1 = threefry.fold_in(key, rows)                  # [rows]
    j = torch.arange(x[0].numel(), dtype=torch.int64, device=x.device)
    bits = threefry.bits_at((k0[:, None], k1[:, None]),
                            torch.full((), site, dtype=torch.int64,
                                       device=x.device), j[None, :])
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    keep = (u < 1.0 - rate).view(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _tp_encoder_layer(cfg: TransformerConfig, chunk, x, mask,
                      model_axis=None, comm_overlap=None, return_kv=False,
                      attend=None, drop=None):
    """One encoder layer, the JAX package's ``_tp_encoder_layer``: qkv
    projection, attention, out projection, post-norm, tanh-GELU MLP,
    post-norm.  With ``model_axis`` (an :class:`~autodist_tpu_torch
    .parallel.axis.Axis`), ``chunk`` holds the Megatron shards: qkv and
    ``wi`` are column-parallel (local heads and mlp features), attention
    runs on the local heads, and the out projection and ``wo`` are
    row-parallel, their partial products summed over the model group
    before the replicated bias, residual and norm; ``comm_overlap``
    selects the decomposed boundaries.  ``return_kv=True`` also returns
    the layer's k/v projections ``[B, L, heads, head_dim]`` (the serving
    prefill's cache fill).

    ``attend(q, k, v) -> out`` replaces the attention step (``mask`` is
    then unused): the serving engine's decode and chunk steps write the
    cache and attend over it there, so every serving path runs this one
    definition of the layer.

    ``drop(site, t, rate) -> t`` applies dropout at flax's four sites
    (the attention probabilities at ``attention_dropout_rate``, the
    attention output, the MLP hidden and the MLP output at
    ``dropout_rate``); ``None`` is the deterministic layer."""
    dtype = cfg.dtype
    att = chunk["attention"]
    x = x.to(dtype)
    tp = dict(model_axis=model_axis, comm_overlap=comm_overlap)

    def dropped(site, t, rate):
        return t if drop is None else drop(site, t, rate)

    probs_drop = None
    if drop is not None and cfg.attention_dropout_rate:
        def probs_drop(p):
            return drop(SITE_PROBS, p, cfg.attention_dropout_rate)
    qkv = column_parallel(x, att["qkv"]["kernel"].to(dtype),
                          att["qkv"]["bias"].to(dtype), **tp)
    q, k, v = qkv.unbind(-3)
    if attend is not None:
        out = attend(q, k, v)
    elif cfg.attention_fn is not None:
        out = cfg.attention_fn(q, k, v, mask, probs_drop)
    else:
        out = dot_product_attention(q, k, v, mask, dtype=dtype,
                                    dropout_rng=probs_drop)
    a = row_parallel(out, att["out"]["kernel"].to(dtype),
                     att["out"]["bias"].to(dtype), axes=2, **tp)
    a = dropped(SITE_ATTENTION, a, cfg.dropout_rate)
    x = _flax_layer_norm(x + a, chunk["ln_attention"], dtype)
    h = column_parallel(x, chunk["mlp"]["wi"]["kernel"].to(dtype),
                        chunk["mlp"]["wi"]["bias"].to(dtype), **tp)
    h = dropped(SITE_MLP_HIDDEN, F.gelu(h, approximate="tanh"),
                cfg.dropout_rate)
    m = row_parallel(h, chunk["mlp"]["wo"]["kernel"].to(dtype),
                     chunk["mlp"]["wo"]["bias"].to(dtype), **tp)
    m = dropped(SITE_MLP, m, cfg.dropout_rate)
    y = _flax_layer_norm(x + m, chunk["ln_mlp"], dtype)
    return (y, k, v) if return_kv else y


def sequential_logits(cfg: TransformerConfig, params, tokens):
    """Full-sequence next-token logits ``[B, L, V]`` (fp32) — the
    greedy full-recompute reference the serving streams are held to."""
    stages, shared = params["stages"], params["shared"]
    L = tokens.shape[1]
    x = vocab_parallel_embedding(tokens, shared["embedding"]) \
        + shared["pos_embed"][None, :L]
    mask = _pipeline_lm_mask(L, tokens.device)
    for i in range(cfg.num_layers):
        x = _tp_encoder_layer(cfg, stage_slice(stages, i), x, mask)
    x = _layer_norm(x, shared["ln_final_scale"], shared["ln_final_bias"])
    return x @ shared["embedding"].float().T


def init_pipeline_lm_params(cfg: TransformerConfig, generator, device=None):
    """Random fp32 parameters with the tree and shapes of the JAX
    package's ``make_pipeline_lm_trainable(cfg, ...).params`` (one stage
    per layer), drawn from ``generator`` with flax's default
    initializers: lecun-normal kernels, zero biases, unit norm scales,
    ``N(0, 0.02)`` embeddings.  The draws differ from ``jax.random``'s;
    to compare with the JAX package, convert its tree with
    :func:`~autodist_tpu_torch.interop.from_jax_params` instead.

    ``generator`` is a ``torch.Generator`` (its device is where the
    draws happen); ``device=None`` places the tree on the card."""
    dev = resolve_device(device)
    L, H, M = cfg.num_layers, cfg.hidden_size, cfg.mlp_dim
    heads, hd = cfg.num_heads, cfg.head_dim

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32,
                           device=generator.device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32,
                          device=generator.device)

    def normal(*shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=generator.device)
        return t.normal_(0.0, std, generator=generator)

    tree = {
        "stages": {
            "attention": {
                "qkv": {"kernel": lecun_normal((L, H, 3, heads, hd), H,
                                                generator),
                        "bias": zeros(L, 3, heads, hd)},
                "out": {"kernel": lecun_normal((L, heads, hd, H),
                                                heads * hd, generator),
                        "bias": zeros(L, H)},
            },
            "ln_attention": {"scale": ones(L, H), "bias": zeros(L, H)},
            "mlp": {
                "wi": {"kernel": lecun_normal((L, H, M), H, generator),
                       "bias": zeros(L, M)},
                "wo": {"kernel": lecun_normal((L, M, H), M, generator),
                       "bias": zeros(L, H)},
            },
            "ln_mlp": {"scale": ones(L, H), "bias": zeros(L, H)},
        },
        "shared": {
            "embedding": normal(cfg.vocab_size, H, std=0.02),
            "pos_embed": normal(cfg.max_len, H, std=0.02),
            "ln_final_scale": ones(H),
            "ln_final_bias": zeros(H),
        },
    }
    return tree_map(lambda t: t.to(dev), tree)


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pipeline_lm_mask(L: int, device):
    return torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=device))[None, None]


def make_pipeline_lm_trainable(cfg: TransformerConfig, optimizer, generator,
                               *, num_stages: int = None, device=None, **kw):
    """The pipelined causal LM as a :class:`~autodist_tpu_torch.capture
    .PipelineTrainable` (counterpart of the JAX package's
    ``make_pipeline_lm_trainable``): one encoder layer per stage,
    ``num_stages`` defaulting to ``cfg.num_layers``; the embedding, the
    position table and the final norm are the replicated shared
    parameters.  Parameters are drawn from ``generator`` by
    :func:`init_pipeline_lm_params` and placed on ``device`` (``None``:
    the card); to hold the model to the JAX package, set ``.params`` to
    :func:`~autodist_tpu_torch.interop.from_jax_params` of the JAX
    trainable's tree.  Batches are ``{"x": [B, L] tokens, "y": [B, L]
    next tokens}``.

    With dropout the trainable is ``stage_rng`` and each stage draws
    its masks keyed on (global chunk, global row)
    (:func:`keyed_dropout`); with ``tensor_parallel > 1`` a stage with
    dropout raises ``NotImplementedError``, as in the JAX package
    (masks over model-sharded intermediates cannot reproduce the
    sequential draw)."""
    num_stages = num_stages or cfg.num_layers
    needs_rng = bool(cfg.dropout_rate or cfg.attention_dropout_rate)
    params = init_pipeline_lm_params(
        dataclasses.replace(cfg, num_layers=num_stages), generator,
        device=device)

    def prologue(shared, batch, model_axis=None, comm_overlap=None):
        """Token + position embedding.  Under ``Pipeline(vocab_parallel=
        True)`` the lowering passes ``model_axis`` and
        ``shared["embedding"]`` is the local vocab shard: the masked
        shard lookup and its sum over the model axis."""
        tokens = batch["x"]
        L = tokens.shape[1]
        x = vocab_parallel_embedding(
            tokens, shared["embedding"], model_axis=model_axis,
            comm_overlap=comm_overlap).to(cfg.dtype)
        return x + shared["pos_embed"][None, :L].to(cfg.dtype)

    def stage_fn(chunk, x, rng_c=None, rows=None, model_axis=None,
                 comm_overlap=None):
        """One encoder layer, causal; with ``model_axis`` on the local
        Megatron shards.  With dropout, ``rng_c`` is the chunk's key
        (``None`` in eval) and ``rows`` the global rows of ``x``."""
        mask = _pipeline_lm_mask(x.shape[1], x.device)
        if model_axis is not None and needs_rng:
            # Dropout masks over model-sharded intermediates have
            # per-shard shapes; no keying reproduces the sequential
            # full-tensor draw, so the parity contract cannot hold.
            raise NotImplementedError(
                "tensor_parallel > 1 requires dropout_rate == "
                "attention_dropout_rate == 0 in the pipelined LM")
        drop = None
        if needs_rng and rng_c is not None:
            def drop(site, t, rate):
                return keyed_dropout(t, rate, rng_c, rows, site)
        return _tp_encoder_layer(cfg, chunk, x, mask, model_axis=model_axis,
                                 comm_overlap=comm_overlap, drop=drop)

    def loss_head(outputs, batch, shared, model_axis=None,
                  comm_overlap=None):
        """Tied-unembedding softmax cross-entropy: on full ``[B, L, V]``
        fp32 logits, or, under ``Pipeline(vocab_parallel=True)``
        (``model_axis`` set, ``shared["embedding"]`` the local vocab
        shard), the streaming epilogue, which never holds the
        full-vocab logits."""
        x = _layer_norm(outputs, shared["ln_final_scale"],
                        shared["ln_final_bias"])
        targets = batch["y"].long()
        if model_axis is None:
            logits = x @ shared["embedding"].float().T
            nll = cross_entropy_from_logits(logits, targets)
            pred = logits.argmax(-1)
        else:
            nll, pred = vocab_parallel_cross_entropy(
                x, shared["embedding"], targets, vocab_size=cfg.vocab_size,
                model_axis=model_axis, comm_overlap=comm_overlap)
        loss = nll.mean()
        acc = (pred == targets).float().mean()
        return loss, {"accuracy": acc}

    return PipelineTrainable(stage_fn, params["stages"], loss_head,
                             optimizer, num_stages=num_stages,
                             shared_params=params["shared"],
                             prologue=prologue, stage_rng=needs_rng, **kw)
