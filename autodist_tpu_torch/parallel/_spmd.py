"""The shared step of the replicated-parameter lowerings.

Counterpart of ``autodist_tpu/parallel/_spmd.py``'s
``build_replicated_spmd`` at its plain-policy core.  The sequence and
expert lowerings differ only in placement (which variables are stored
sharded, how the batch leaves split, over which axes each gradient is
averaged); the step is this one, run eagerly in every process of the
job where the JAX package traces one ``shard_map`` program:

1. the loss and its gradients on this rank's part of the batch, with
   the dropout seed folded with the rank's joint index over
   ``sync_axes``, inside :func:`~autodist_tpu_torch.parallel.axis
   .axis_scope` binding every mesh axis by name (forward and backward);
2. each gradient averaged over the axis its variable's ``grad_sync``
   names, the variables of one axis in one flat fp32 all-reduce;
3. the optimizer update, alike on every rank;
4. float metrics and float ``extra`` leaves averaged over ``sync_axes``.

Gradient accumulation, ZeRO, the compressors and the ``grad`` and
``zero3_gather`` precision slots raise ``NotImplementedError`` here,
each naming its ROADMAP item: this is the one place they will be
filled in.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from autodist_tpu_torch import cuda_graph, optim
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.parallel.axis import axis_scope
from autodist_tpu_torch.strategy.ir import normalize_precision, not_ported

ZERO_ITEM = "ROADMAP Queue 1, slice 3 leftovers, item 4"
COMPRESSORS_ITEM = "ROADMAP Queue 1, slice 2 leftovers: compressors"
ACCUM_ITEM = "ROADMAP Queue 1, item 8: GradAccumulation"


def check_plain_policies(strategy, what: str):
    """Refuse a per-variable compressor, which the builder does not run
    yet, naming its item (a PS synchronizer, ZeRO, is refused when the
    strategy is read); JAX ``policies_from_node_configs`` resolves
    both."""
    for nc in strategy.node_configs:
        if nc.synchronizer.compressor not in ("", "none"):
            not_ported(f"gradient compressor {nc.synchronizer.compressor!r}"
                       f" on {nc.var_name} in the {what} lowering",
                       COMPRESSORS_ITEM)


def _mean_float_leaves(tree, axis):
    """Float tensors of a nest of dicts, lists and tuples averaged over
    ``axis``; everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return axis.pmean(tree) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _mean_float_leaves(v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_mean_float_leaves(v, axis) for v in tree)
    return tree


def build_replicated_spmd(trainable, mesh, *, sync_axes: Sequence[str],
                          batch_spec_fn: Optional[Callable] = None,
                          param_spec_fn: Optional[Callable] = None,
                          grad_sync: Optional[Callable] = None,
                          accum: int = 1, precision=None, plan=None,
                          device=None):
    """The train step of a (mostly) replicated-parameter strategy, as a
    :class:`~autodist_tpu_torch.kernel.lowering.Lowered` on ``device``
    (``None``: the card).

    Args:
      sync_axes: the mesh axes gradients and metrics are averaged over,
        and the dropout seed is folded over (their joint axis).
      batch_spec_fn: ``batch -> {leaf name: ((dim, Axis), ...)}``, the
        feed: each leaf cut along each dim over each axis
        (:meth:`Lowered.placement_of`); by default dim 0 over the joint
        ``sync_axes``.
      param_spec_fn: ``(name, leaf) -> (dim, Axis)`` to store a
        variable as this rank's slice along ``dim`` (gathered back by
        ``get_params``), or ``None`` to replicate it (the default for
        every variable).  The optimizer state follows the stored
        slice.
      grad_sync: ``(name, grad) -> (grad, Axis or None)``: the gradient
        to average and the axis to average it over, ``None`` for the
        joint ``sync_axes`` (the default for every variable).
      accum, precision: the strategy's accumulation count and precision
        policy; only ``accum == 1`` and the ``moe_a2a`` slot (which the
        expert lowering binds into its trainable) run yet.
    """
    if accum != 1:
        not_ported("gradient accumulation (accum_steps > 1)", ACCUM_ITEM)
    precision = normalize_precision(precision)
    if precision.get("grad"):
        not_ported("the 'grad' precision slot (an error-feedback "
                   "compressor on the gradient sync)", COMPRESSORS_ITEM)
    if precision.get("zero3_gather"):
        not_ported("the 'zero3_gather' precision slot (ZeRO-3)", ZERO_ITEM)
    from autodist_tpu_torch.kernel.lowering import Lowered, reduce_metrics

    dev, opt = resolve_device(device), trainable.optimizer
    sync = mesh.joint_axis(tuple(sync_axes))
    scope = {name: mesh.axis(name) for name in mesh.shape}
    names = [info.name for info in trainable.var_infos()]
    flat = dict(flatten_with_names(trainable.params))
    sharded = {}
    for name in names:
        spec = param_spec_fn(name, flat[name]) if param_spec_fn else None
        if spec is not None:
            dim, axis = spec
            if flat[name].shape[dim] % axis.size:
                raise ValueError(
                    f"{name}: dim {dim} of {tuple(flat[name].shape)} does "
                    f"not divide by the {axis.size}-way {axis.name!r} axis")
            sharded[name] = spec
    if grad_sync is None:
        grad_sync = lambda name, g: (g, None)              # noqa: E731

    def init_fn(params, extra):
        stored = {}
        for nm, t in flatten_with_names(params):
            if nm in sharded:
                dim, axis = sharded[nm]
                n = t.shape[dim] // axis.size
                t = t.narrow(dim, axis.index * n, n)
            stored[nm] = t.detach().to(dev).clone()
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt.init(stored),
                "extra": extra}

    def sync_grads(grads: dict) -> dict:
        """Each axis's variables in one flat fp32 mean, in the order of
        their first variable."""
        buckets: dict = {}
        for nm, g in grads.items():
            g, axis = grad_sync(nm, g)
            axis = sync if axis is None else axis
            buckets.setdefault(id(axis), (axis, {}))[1][nm] = g
        synced = {}
        for axis, group in buckets.values():
            synced.update(axis.pmean_all(group))
        return {nm: synced[nm] for nm in grads}

    def step_fn(state, batch, rng):
        params = state["params"]
        leaves = {nm: p.detach().requires_grad_(True)
                  for nm, p in params.items()}
        local_rng = cuda_graph.fold_seed(rng, sync.size, sync.index)
        with torch.enable_grad(), axis_scope(scope):
            loss, new_extra, metrics = trainable.loss(
                unflatten(leaves), state["extra"], batch, local_rng)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {nm: torch.zeros_like(params[nm]) if g is None else g
                 for nm, g in zip(leaves, grads)}
        updates, opt_state = opt.update(sync_grads(grads),
                                        state["opt_state"], params)
        new_state = {"step": state["step"] + 1,
                     "params": optim.apply_updates(params, updates),
                     "opt_state": opt_state,
                     "extra": _mean_float_leaves(new_extra, sync)}
        return new_state, reduce_metrics(metrics, mesh, axis=sync)

    def full_params(stored: dict) -> dict:
        out = {}
        for nm, t in stored.items():
            if nm in sharded:
                dim, axis = sharded[nm]
                t = axis.all_gather(t, dim=dim)
            out[nm] = t
        return out

    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn, full_params_fn=full_params,
                   batch_axis=sync, placement=batch_spec_fn)
