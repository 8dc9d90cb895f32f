"""Name, flatten, shard and accumulation helpers of the lowering.

Counterpart of ``autodist_tpu/kernel/common.py``.  A parameter tree is
a nested dict of tensors; a leaf's name is its ``/``-joined key path
(``encoder/layer_0/attention/qkv/kernel``), and leaves come in
sorted-key order at every level — the order ``jax.tree_util`` flattens
a dict in, so that variable indices (and with them the AllReduce bucket
groups) agree between the two packages.

The shard helpers are the synchronizers' vocabulary on an
:class:`~autodist_tpu_torch.parallel.axis.Axis` of ``n`` ranks: a flat
vector or one tensor dimension is zero-padded to a multiple of ``n``
(:func:`padded_flat_size`, :func:`padded_shape`), so every rank's chunk
has one length, and then reduce-scattered, gathered or sliced.  Padding
lanes carry zero gradients, so an element-wise optimizer leaves them at
zero.  :func:`all_gather_axis` is differentiable: its backward is the
transposed collective, a reduce-scatter that sums (the caller divides
by ``n`` for the replicas' mean), as JAX's transpose of ``all_gather``.
:func:`zero3_gather` is the same pair over a flat ZeRO-3 shard, at the
strategy's ``zero3_gather`` wire precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``: numpy's and ml_dtypes'
    spelling, which ``meta.json`` and the state manifests use."""
    return dtype if isinstance(dtype, str) else str(dtype).removeprefix(
        "torch.")


def state_leaves(tree, prefix: str = "") -> list:
    """``[(name, tensor), ...]`` of a training state: dicts in
    sorted-key order, lists and tuples by position, ``None`` and other
    non-tensors skipped (the names ``jax.tree_util`` paths give the JAX
    package's state)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix.rstrip("/"), tree)]
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in state_leaves(tree[key], f"{prefix}{key}/")]
    if isinstance(tree, (list, tuple)):
        return [x for i, item in enumerate(tree)
                for x in state_leaves(item, f"{prefix}{i}/")]
    return []


def map_state(fn, tree, prefix: str = ""):
    """``tree`` with every tensor leaf replaced by ``fn(name, leaf)``
    (names as :func:`state_leaves` gives them), in its own order."""
    if isinstance(tree, torch.Tensor):
        return fn(prefix.rstrip("/"), tree)
    if isinstance(tree, dict):
        return {key: map_state(fn, value, f"{prefix}{key}/")
                for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_state(fn, item, f"{prefix}{i}/")
                          for i, item in enumerate(tree))
    return tree


def match_var_by_suffix(leaf_name: str, var_names, shape_ok=None):
    """The variable an optimizer-state leaf belongs to: the longest
    variable name that is a ``/``-suffix of ``leaf_name``, among those
    ``shape_ok(name)`` admits (JAX ``match_var_by_suffix``); ``None``
    when none is."""
    candidates = sorted((v for v in var_names
                         if leaf_name == v or leaf_name.endswith("/" + v)),
                        key=len, reverse=True)
    for cand in candidates:
        if shape_ok is None or shape_ok(cand):
            return cand
    return None


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


# --------------------------------------------------------------------- #
# Padding
# --------------------------------------------------------------------- #
def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def padded_flat_size(size: int, n: int) -> int:
    """The smallest multiple of ``n`` at or above ``size`` (at least
    ``n``)."""
    return ceil_div(max(size, 1), n) * n


def pad_axis_to(x, axis: int, target: int):
    """``x`` zero-padded along ``axis`` to length ``target``."""
    extra = target - x.shape[axis]
    if extra == 0:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis % x.dim()) + [0, extra]
    return F.pad(x, pads)


def padded_shape(shape: tuple, axis: int, n: int) -> tuple:
    s = list(shape)
    s[axis] = padded_flat_size(s[axis], n)
    return tuple(s)


# --------------------------------------------------------------------- #
# Flat and axis shards over an Axis
# --------------------------------------------------------------------- #
def _flat_padded(x, n: int):
    flat = x.reshape(-1)
    return pad_axis_to(flat, 0, padded_flat_size(flat.numel(), n))


def reduce_scatter_flat(x, axis, mean: bool = True):
    """Flatten, pad and reduce-scatter: this rank's summed (``mean``:
    averaged) ``1/n`` flat chunk, the PS accumulator of the chunk it
    owns."""
    n = axis.size
    out = axis.psum_scatter(_flat_padded(x, n))
    return out / n if mean and n > 1 else out


def all_gather_flat(shard, axis, shape: tuple):
    """The inverse of :func:`reduce_scatter_flat`: the ranks' flat
    chunks gathered, the padding cut off, reshaped to ``shape``."""
    full = axis.all_gather(shard, dim=0)
    size = math.prod(shape) if shape else 1
    return full[:size].reshape(shape)


def local_flat_shard(x, axis):
    """This rank's flat ``1/n`` chunk of a replicated tensor."""
    flat = _flat_padded(x, axis.size)
    k = flat.numel() // axis.size
    return flat[axis.index * k:(axis.index + 1) * k]


def _scatter_dim(x, axis, dim: int):
    """The sum over ``axis`` of ``x``, whose ``dim`` divides by its
    size, scattered along ``dim``: this rank's ``1/n`` slice."""
    n = axis.size
    if n == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = axis.psum_scatter(front.reshape(-1))
    return out.view((front.shape[0] // n,) + front.shape[1:]).movedim(0, dim)


def reduce_scatter_axis(x, axis, dim: int, mean: bool = True):
    """``x`` padded along ``dim`` to a multiple of ``n`` and
    reduce-scattered along it (PartitionedAR's gradient)."""
    n = axis.size
    x = pad_axis_to(x, dim, padded_flat_size(x.shape[dim], n))
    out = _scatter_dim(x, axis, dim)
    return out / n if mean and n > 1 else out


class _GatherAxis(torch.autograd.Function):
    """All-gather along ``dim``, the padding cut to ``orig``; backward:
    the cotangent padded and reduce-scattered (a sum)."""

    @staticmethod
    def forward(ctx, shard, axis, dim, orig):
        ctx.args = (axis, dim, shard.shape[dim] * axis.size)
        full = axis.all_gather(shard, dim=dim)
        return full.narrow(dim, 0, orig) if full.shape[dim] != orig \
            else full

    @staticmethod
    def backward(ctx, g):
        axis, dim, padded = ctx.args
        return (_scatter_dim(pad_axis_to(g, dim, padded), axis, dim),
                None, None, None)


def all_gather_axis(shard, axis, dim: int, orig_dim: int):
    """The ranks' slices along ``dim`` gathered and trimmed back to
    ``orig_dim``.  Differentiable: the gradient that reaches ``shard``
    is the reduce-scattered sum of the full one."""
    if axis.size == 1:
        return shard.narrow(dim, 0, orig_dim) \
            if shard.shape[dim] != orig_dim else shard
    return _GatherAxis.apply(shard, axis, dim, orig_dim)


def local_axis_shard(x, axis, dim: int):
    """This rank's ``1/n`` slice of ``x`` along ``dim`` (padded)."""
    n = axis.size
    x = pad_axis_to(x, dim, padded_flat_size(x.shape[dim], n))
    k = x.shape[dim] // n
    return x.narrow(dim, axis.index * k, k)


# --------------------------------------------------------------------- #
# ZeRO-3: the parameter gathered on demand from its flat shard
# --------------------------------------------------------------------- #
def _zero3_gather_impl(shard, axis, shape: tuple, precision: str):
    if precision == "fp32":
        return all_gather_flat(shard, axis, shape)
    from autodist_tpu_torch.kernel import quantize as qz

    full = qz.quantized_all_gather_flat(shard, axis, precision)
    size = math.prod(shape) if shape else 1
    return full[:size].reshape(shape).to(shard.dtype)


def _zero3_scatter_impl(ct, axis, precision: str):
    if precision == "fp32":
        return reduce_scatter_flat(ct, axis, mean=False)
    from autodist_tpu_torch.kernel import quantize as qz

    return qz.quantized_psum_scatter_flat(
        _flat_padded(ct, axis.size), axis, precision).to(ct.dtype)


class _Zero3Gather(torch.autograd.Function):
    """The flat all-gather forward; backward: the cotangent
    reduce-scattered (a sum), both at the slot's precision."""

    @staticmethod
    def forward(ctx, shard, axis, shape, precision):
        ctx.args = (axis, precision)
        return _zero3_gather_impl(shard, axis, shape, precision)

    @staticmethod
    def backward(ctx, ct):
        axis, precision = ctx.args
        return _zero3_scatter_impl(ct, axis, precision), None, None, None


def zero3_gather(shard, axis, shape: tuple, precision: str = "fp32"):
    """One full parameter of ``shape`` from this rank's flat ZeRO-3
    shard (the :func:`local_flat_shard` layout over ``axis``).  Its
    gradient reaches ``shard`` reduce-scattered, a sum over the axis
    (divide by the replicas for their mean), so a parameter stored
    sharded gets a shard-shaped gradient.  ``precision``, the
    ``zero3_gather`` slot, narrows both ways: the forward carries int8
    levels with each source shard's scale (or bf16), the backward sums
    int8 levels on an fp16 wire (:mod:`~autodist_tpu_torch.kernel
    .quantize`)."""
    return _Zero3Gather.apply(shard, axis, tuple(int(d) for d in shape),
                              precision)


# --------------------------------------------------------------------- #
# Gradient accumulation
# --------------------------------------------------------------------- #
def _reduce_stacked(values: list):
    """One metric over the microbatches: float values averaged, integer
    counts summed, flags OR-ed (what one full batch would report)."""
    m = torch.stack([torch.as_tensor(v) for v in values])
    if m.is_floating_point() or m.is_complex():
        return m.mean(0)
    if m.dtype == torch.bool:
        return m.any(0)
    return m.sum(0)


def _slice_leaves(tree, i: int, accum: int, name: str = ""):
    """Slice ``i`` of ``accum`` of every leaf of a nest of dicts with a
    leading dim (else ``ValueError``); a 0-d leaf goes whole."""
    if isinstance(tree, dict):
        return type(tree)({k: _slice_leaves(v, i, accum, f"{name}/{k}"
                                            if name else k)
                           for k, v in tree.items()})
    if not tree.dim():
        return tree
    if tree.shape[0] % accum:
        raise ValueError(
            f"per-device batch {tree.shape[0]} (leaf {name!r}) not "
            f"divisible by accum_steps={accum}")
    size = tree.shape[0] // accum
    return tree.narrow(0, i * size, size)


def accumulate_microbatches(micro_fn, batch, rng, extra, accum: int):
    """``accum`` microbatches of this rank's ``batch`` in a Python loop
    over static slices (a CUDA graph captures it whole); returns
    ``(grads, new_extra, metrics)``.

    ``micro_fn(mb, rng, extra) -> (grads, new_extra, metrics)`` with
    ``grads`` a ``{name: tensor}`` dict, called on the slices in order.
    Each leaf (of a nest of dicts) with a leading dim splits into
    ``accum`` equal slices (else ``ValueError``); a 0-d leaf goes whole
    to every slice.  The gradients are averaged; metrics as
    :func:`_reduce_stacked` reduces them.  Slice ``i`` draws its dropout
    from the step seed folded with ``i`` (a captured window's
    :class:`~autodist_tpu_torch.cuda_graph.GraphSeed` goes whole: its
    one generator advances from slice to slice)."""
    from autodist_tpu_torch.cuda_graph import GraphSeed, fold_seed

    slices = [_slice_leaves(batch, i, accum) for i in range(accum)]
    g_sum, metric_list = None, []
    for i, mb in enumerate(slices):
        r = rng if isinstance(rng, GraphSeed) else fold_seed(rng, accum, i)
        grads, extra, metrics = micro_fn(mb, r, extra)
        g_sum = grads if g_sum is None else {
            nm: g_sum[nm] + g for nm, g in grads.items()}
        metric_list.append(metrics)
    grads = {nm: g / accum for nm, g in g_sum.items()}
    metrics = {k: _reduce_stacked([m[k] for m in metric_list])
               for k in metric_list[0]}
    return grads, extra, metrics
