"""Name and flatten helpers of the lowering.

Counterpart of the tree helpers in ``autodist_tpu/kernel/common.py``.
A parameter tree is a nested dict of tensors; a leaf's name is its
``/``-joined key path (``encoder/layer_0/attention/qkv/kernel``), and
leaves come in sorted-key order at every level — the order
``jax.tree_util`` flattens a dict in, so that variable indices (and with
them the AllReduce bucket groups) agree between the two packages.  The
collectives of that module belong to later slices.
"""
from __future__ import annotations


def flatten_with_names(tree, prefix: str = "") -> list:
    """``[(name, leaf), ...]`` of a nested dict in sorted-key order."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.extend(flatten_with_names(value, name + "/"))
        else:
            out.append((name, value))
    return out


def unflatten(flat) -> dict:
    """The nested dict of a ``{name: leaf}`` mapping."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree

