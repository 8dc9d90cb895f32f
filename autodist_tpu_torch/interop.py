"""Convert parameter trees between the two packages.

Four models so far, each with its own leaf list:

* the pipelined LM's logical tree (``make_pipeline_lm_trainable(...)
  .params`` or a ``checkpoint/export`` artifact's ``params/``; see
  :mod:`autodist_tpu_torch.models.pipeline_lm`);
* BERT's flax tree (``make_mlm_trainable(...).params``, named as
  ``capture.path_to_name`` names it, e.g.
  ``encoder/layer_0/attention/qkv/kernel`` ``[H, 3, heads, head_dim]``;
  see :mod:`autodist_tpu_torch.models.bert`);
* the MoE LM's flax tree (``make_moe_lm_trainable(...).params``, e.g.
  ``layer_0_moe/expert_wi`` ``[E, H, F]``; see
  :mod:`autodist_tpu_torch.models.moe_transformer`);
* ``TransformerLM``'s flax tree (``make_lm_trainable(...).params``:
  ``token_embed/embedding``, ``pos_embed``, ``encoder/layer_i/...`` as
  BERT's, ``ln_final/{scale,bias}``; see
  :mod:`autodist_tpu_torch.models.transformer`).

The JAX tree (numpy or JAX arrays) and the port's tree share names,
nesting and layouts leaf for leaf, so the conversion moves bytes and
nothing else: :func:`to_jax_params` of :func:`from_jax_params` gives
back the same arrays bit for bit.

A ``Pipeline(tensor_parallel=t)`` strategy shards stage variables over
the model axis, and under ``vocab_parallel`` the tied embedding's rows;
:func:`model_dims` reads which dim of each variable its partitioner
spec shards, and :func:`shard_params` cuts a rank's slices from a full
tree (the slice ``NamedSharding`` gives model index ``i``), zero-padding
the vocabulary to divide the model axis (:func:`pad_to_shards`); the
pipeline lowering cuts a pipe rank's chunks first and gathers both
back, the padding cut off (:func:`unpad`).  An
``ExpertParallel`` strategy shards the expert tables on their leading
dim: :func:`expert_dims` names them for :func:`shard_params`, and the
expert lowering gathers them back over the expert axis.
"""
from __future__ import annotations

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten

# Every leaf of the pipelined LM's logical tree, by "/"-joined path.
PIPELINE_LM_LEAVES = (
    "stages/attention/qkv/kernel", "stages/attention/qkv/bias",
    "stages/attention/out/kernel", "stages/attention/out/bias",
    "stages/ln_attention/scale", "stages/ln_attention/bias",
    "stages/mlp/wi/kernel", "stages/mlp/wi/bias",
    "stages/mlp/wo/kernel", "stages/mlp/wo/bias",
    "stages/ln_mlp/scale", "stages/ln_mlp/bias",
    "shared/embedding", "shared/pos_embed",
    "shared/ln_final_scale", "shared/ln_final_bias",
)


def _encoder_leaves(num_layers: int) -> tuple:
    """Every leaf of the flax encoder's ``encoder/layer_i`` subtrees."""
    dense = ("kernel", "bias")
    norm = ("scale", "bias")
    layer = ([f"attention/{m}/{p}" for m in ("qkv", "out") for p in dense]
             + [f"ln_attention/{p}" for p in norm]
             + [f"mlp/{m}/{p}" for m in ("wi", "wo") for p in dense]
             + [f"ln_mlp/{p}" for p in norm])
    return tuple(f"encoder/layer_{i}/{leaf}" for i in range(num_layers)
                 for leaf in layer)


def bert_leaves(num_layers: int) -> tuple:
    """Every leaf of BERT's flax tree at ``num_layers`` layers."""
    return (("token_embed/embedding", "pos_embed", "segment_embed/embedding",
             "ln_embed/scale", "ln_embed/bias", "mlm_dense/kernel",
             "mlm_dense/bias", "mlm_ln/scale", "mlm_ln/bias", "mlm_bias")
            + _encoder_leaves(num_layers))


def transformer_lm_leaves(num_layers: int) -> tuple:
    """Every leaf of ``TransformerLM``'s flax tree at ``num_layers``
    layers."""
    return (("token_embed/embedding", "pos_embed", "ln_final/scale",
             "ln_final/bias") + _encoder_leaves(num_layers))


def moe_lm_leaves(num_layers: int) -> tuple:
    """Every leaf of the MoE LM's flax tree at ``num_layers`` layers."""
    layer = ([f"attention/{m}/{p}" for m in ("qkv", "out")
              for p in ("kernel", "bias")]
             + [f"{ln}/{p}" for ln in ("ln_attention", "ln_moe")
                for p in ("scale", "bias")]
             + [f"moe/expert_{w}" for w in ("gate", "wi", "wo")])
    return (("token_embed/embedding", "pos_embed", "ln_final/scale",
             "ln_final/bias")
            + tuple(f"layer_{i}_{leaf}" for i in range(num_layers)
                    for leaf in layer))


def _check_leaves(flat):
    """The flat tree must be one model's tree exactly."""
    names = set(flat)
    layers = {n.split("/")[1] for n in names if n.startswith("encoder/")}
    moe_layers = {n.split("_")[1] for n in names if n.startswith("layer_")}
    want = set(bert_leaves(len(layers)) if "mlm_bias" in names
               else transformer_lm_leaves(len(layers)) if layers
               else moe_lm_leaves(len(moe_layers)) if moe_layers
               else PIPELINE_LM_LEAVES)
    if names == want:
        return
    raise ValueError(
        f"not a pipelined-LM, BERT, TransformerLM or MoE-LM parameter "
        f"tree: missing {sorted(want - names)}, unexpected "
        f"{sorted(names - want)}")


def _to_torch(a) -> torch.Tensor:
    a = np.array(a)                     # a writable host copy
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16: reinterpret
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_jax_params(tree, device=None):
    """The JAX package's logical tree (nested dicts of numpy or JAX
    arrays) as the port's tree of tensors on ``device`` (``None`` means
    the card), dtypes and layouts unchanged."""
    dev = resolve_device(device)
    flat = dict(flatten_with_names(tree))
    _check_leaves(flat)
    return unflatten({k: _to_torch(v).to(dev) for k, v in flat.items()})


def to_jax_params(params):
    """The port's tree as the JAX package's logical tree of numpy
    arrays (``jax.tree.map(jnp.asarray, ...)`` takes it from there)."""
    flat = dict(flatten_with_names(params))
    _check_leaves(flat)
    return unflatten({k: _to_numpy(v) for k, v in flat.items()})


def model_dims(strategy) -> dict:
    """``{variable name: dim}``: the dim each variable's partitioner
    spec shards over the model axis (variables it does not shard are
    absent).  A spec that shards several dims over it raises."""
    dims = {}
    for nc in strategy.node_configs:
        spec = nc.partitioner.spec if nc.partitioner else None
        found = [d for d, ax in enumerate(spec or ()) if ax == const.MODEL_AXIS]
        if len(found) > 1:
            raise ValueError(f"{nc.var_name}: spec {spec} shards several "
                             f"dims over the model axis")
        if found:
            dims[nc.var_name] = found[0]
    return dims


def expert_dims(strategy) -> dict:
    """``{variable name: 0}`` for each variable an ``ExpertParallel``
    strategy stores sharded on its leading (expert) dim."""
    return {nc.var_name: 0 for nc in strategy.node_configs
            if nc.partitioner is not None and nc.partitioner.spec
            and const.EXPERT_AXIS in nc.partitioner.spec}


def pad_to_shards(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``t`` zero-padded along ``dim`` to a multiple of ``size`` (the
    stored form of a vocab-sharded table whose vocabulary does not
    divide the model axis, JAX ``shared_padded_shape``)."""
    pad = (-t.shape[dim]) % size
    if not pad:
        return t
    shape = list(t.shape)
    shape[dim] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def shard_params(params, dims: dict, index: int, size: int, *, padded=()):
    """Shard ``index`` of ``size`` of a full tree: each variable in
    ``dims`` cut into ``size`` equal slices along its dim (a model
    shard, or a rank's local experts).  Variables named in ``padded``
    are zero-padded to divide first (:func:`pad_to_shards`); any other
    dim that does not divide raises.  :func:`unpad` takes a gathered
    padded variable back to its logical shape."""
    flat = dict(flatten_with_names(params))
    for name, d in dims.items():
        t = flat[name]
        if name in padded:
            t = pad_to_shards(t, d, size)
        n = t.shape[d]
        if n % size:
            raise ValueError(f"{name}: dim {d} of {n} does not divide by "
                             f"{size} shards")
        flat[name] = t.narrow(d, index * (n // size), n // size)
    return unflatten(flat)


def unpad(t: torch.Tensor, dim: int, logical: int) -> torch.Tensor:
    """A gathered padded variable cut back to ``logical`` rows along
    ``dim`` (JAX ``unpad_params``)."""
    return t.narrow(dim, 0, logical) if t.shape[dim] != logical else t
