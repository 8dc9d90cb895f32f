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

Only the tensor-parallel-1 branch is ported; the training-side
``PipelineTrainable`` belongs to the training slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   dot_product_attention)
from autodist_tpu_torch.parallel.tensor import (column_parallel,
                                                row_parallel,
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


def layer_params(stages, layer: int):
    """The ``layer``-th slice of every stacked stage leaf."""
    if isinstance(stages, dict):
        return {k: layer_params(v, layer) for k, v in stages.items()}
    return stages[layer]


def _tp_encoder_layer(cfg: TransformerConfig, chunk, x, mask,
                      return_kv=False, attend=None):
    """One encoder layer at tensor parallel 1 — the JAX package's
    ``_tp_encoder_layer`` with ``model_axis=None``: qkv projection,
    attention, out projection, post-norm, tanh-GELU MLP, post-norm.
    ``return_kv=True`` also returns the layer's k/v projections
    ``[B, L, heads, head_dim]`` (the serving prefill's cache fill).

    ``attend(q, k, v) -> out`` replaces the attention step (``mask`` is
    then unused): the serving engine's decode and chunk steps write the
    cache and attend over it there, so every serving path runs this one
    definition of the layer."""
    dtype = cfg.dtype
    att = chunk["attention"]
    x = x.to(dtype)
    qkv = column_parallel(x, att["qkv"]["kernel"].to(dtype),
                          att["qkv"]["bias"].to(dtype))
    q, k, v = qkv.unbind(-3)
    if attend is not None:
        out = attend(q, k, v)
    elif cfg.attention_fn is not None:
        out = cfg.attention_fn(q, k, v, mask, None)
    else:
        out = dot_product_attention(q, k, v, mask, dtype=dtype)
    a = row_parallel(out, att["out"]["kernel"].to(dtype),
                     att["out"]["bias"].to(dtype), axes=2)
    x = _flax_layer_norm(x + a, chunk["ln_attention"], dtype)
    h = column_parallel(x, chunk["mlp"]["wi"]["kernel"].to(dtype),
                        chunk["mlp"]["wi"]["bias"].to(dtype))
    h = F.gelu(h, approximate="tanh")
    m = row_parallel(h, chunk["mlp"]["wo"]["kernel"].to(dtype),
                     chunk["mlp"]["wo"]["bias"].to(dtype))
    y = _flax_layer_norm(x + m, chunk["ln_mlp"], dtype)
    return (y, k, v) if return_kv else y


def sequential_logits(cfg: TransformerConfig, params, tokens):
    """Full-sequence next-token logits ``[B, L, V]`` (fp32) — the
    greedy full-recompute reference the serving streams are held to."""
    stages, shared = params["stages"], params["shared"]
    L = tokens.shape[1]
    x = vocab_parallel_embedding(tokens, shared["embedding"]) \
        + shared["pos_embed"][None, :L]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=tokens.device))[None, None]
    for i in range(cfg.num_layers):
        x = _tp_encoder_layer(cfg, layer_params(stages, i), x, mask)
    x = _layer_norm(x, shared["ln_final_scale"], shared["ln_final_bias"])
    return x @ shared["embedding"].float().T


def _lecun_normal(shape, fan_in, generator):
    """flax's default ``lecun_normal``: a normal truncated at two
    standard deviations, rescaled so the variance is ``1 / fan_in``."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


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
                "qkv": {"kernel": _lecun_normal((L, H, 3, heads, hd), H,
                                                generator),
                        "bias": zeros(L, 3, heads, hd)},
                "out": {"kernel": _lecun_normal((L, heads, hd, H),
                                                heads * hd, generator),
                        "bias": zeros(L, H)},
            },
            "ln_attention": {"scale": ones(L, H), "bias": zeros(L, H)},
            "mlp": {
                "wi": {"kernel": _lecun_normal((L, H, M), H, generator),
                       "bias": zeros(L, M)},
                "wo": {"kernel": _lecun_normal((L, M, H), M, generator),
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
