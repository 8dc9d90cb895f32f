"""Convert the pipelined LM's parameters between the two packages.

The JAX package's logical tree (``make_pipeline_lm_trainable(...).params``
or a ``checkpoint/export`` artifact's ``params/``, as numpy arrays) and
the port's tree share names, nesting and layouts leaf for leaf (see
:mod:`autodist_tpu_torch.models.pipeline_lm`), so the conversion moves
bytes and nothing else: :func:`to_jax_params` of :func:`from_jax_params`
gives back the same arrays bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from autodist_tpu_torch.device import resolve_device

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


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def _unflatten(flat):
    tree: dict = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _check_leaves(flat):
    missing = sorted(set(PIPELINE_LM_LEAVES) - set(flat))
    extra = sorted(set(flat) - set(PIPELINE_LM_LEAVES))
    if missing or extra:
        raise ValueError(
            f"not a pipelined-LM parameter tree: missing {missing}, "
            f"unexpected {extra}")


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
    flat = _flatten(tree)
    _check_leaves(flat)
    return _unflatten({k: _to_torch(v).to(dev) for k, v in flat.items()})


def to_jax_params(params):
    """The port's tree as the JAX package's logical tree of numpy
    arrays (``jax.tree.map(jnp.asarray, ...)`` takes it from there)."""
    flat = _flatten(params)
    _check_leaves(flat)
    return _unflatten({k: _to_numpy(v) for k, v in flat.items()})
