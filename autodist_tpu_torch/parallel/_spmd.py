"""The shared step of the replicated-parameter lowerings.

Counterpart of ``autodist_tpu/parallel/_spmd.py``'s
``build_replicated_spmd``.  The sequence and expert lowerings differ
only in placement (which variables are stored sharded, how the batch
leaves split, over which axes each gradient is averaged); the step is
this one, run eagerly in every process of the job where the JAX
package traces one ``shard_map`` program:

1. the loss and its gradients on this rank's part of the batch, with
   the dropout seed folded with the rank's joint index over
   ``sync_axes``, inside :func:`~autodist_tpu_torch.parallel.axis
   .axis_scope` binding every mesh axis by name (forward and backward),
   over ``accum`` microbatches where the strategy asks
   (:func:`~autodist_tpu_torch.kernel.common.accumulate_microbatches`);
2. each gradient synchronized: a variable with a compressor policy
   (:class:`VarPolicy`: a node's ``AllReduceSynchronizer(compressor=)``,
   or every variable under the ``grad`` precision slot's error-feedback
   compressor) through its compressor's all-reduce, with its own state
   row in ``state["sync_state"]``, then scaled; every other one
   averaged over the axis its ``grad_sync`` names, the variables of one
   axis in one flat fp32 all-reduce;
3. the optimizer update, alike on every rank;
4. metrics (floats averaged, counts summed, flags OR-ed) and float
   ``extra`` leaves averaged over ``sync_axes``.

ZeRO (a PS synchronizer, the ``zero3_gather`` slot) raises
``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from autodist_tpu_torch import cuda_graph, optim
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.kernel.compressor import Compressor
from autodist_tpu_torch.parallel.axis import axis_scope
from autodist_tpu_torch.strategy.ir import (PSSynchronizer,
                                            normalize_precision, not_ported)

ZERO_ITEM = "ROADMAP Queue 1, slice 3 leftovers, item 4"
# The grad slot's compressor for each narrowed precision.
GRAD_SLOT_COMPRESSORS = {"bf16": "bf16_ef", "int8": "int8_ef"}


@dataclasses.dataclass
class VarPolicy:
    """A variable's compressed gradient sync: ``compressor`` over
    ``axis`` (``None``: the builder's joint ``sync_axes``), the mean
    then multiplied by ``scale``."""

    compressor: str
    axis: Any = None
    scale: float = 1.0


def compressor_policies(strategy, what: str, axis_for=None,
                        scale_for=None) -> dict:
    """``{name: VarPolicy}`` of the node configs that name a compressor
    (JAX ``policies_from_node_configs``); ``axis_for(name)`` and
    ``scale_for(name)`` override the axis and the scale.  A PS
    synchronizer (ZeRO) raises, naming its item."""
    policies = {}
    for nc in strategy.node_configs:
        sync = nc.synchronizer
        if isinstance(sync, PSSynchronizer):
            not_ported(f"ZeRO (a PS synchronizer on {nc.var_name}) in the "
                       f"{what} lowering", ZERO_ITEM)
        if sync.compressor not in ("", "none"):
            Compressor.create(sync.compressor)      # the name, checked
            policies[nc.var_name] = VarPolicy(
                sync.compressor,
                axis_for(nc.var_name) if axis_for else None,
                scale_for(nc.var_name) if scale_for else 1.0)
    return policies


def build_replicated_spmd(trainable, mesh, *, sync_axes: Sequence[str],
                          batch_spec_fn: Optional[Callable] = None,
                          param_spec_fn: Optional[Callable] = None,
                          grad_sync: Optional[Callable] = None,
                          policies: Optional[dict] = None,
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
      policies: ``{name: VarPolicy}``, the compressed variables
        (:func:`compressor_policies`).
      accum: the microbatches a step.
      precision: the strategy's precision policy: the ``grad`` slot
        elects the matching error-feedback compressor for every
        variable without a policy, where the default ``grad_sync``
        applies (a custom one, the expert lowering's scaled rule,
        keeps its own sync, as in the JAX package); ``moe_a2a`` is the
        expert lowering's, bound into its trainable.
    """
    from autodist_tpu_torch.kernel.lowering import (Lowered,
                                                    mean_float_leaves,
                                                    reduce_metrics)

    precision = normalize_precision(precision)
    if precision.get("zero3_gather"):
        not_ported("the 'zero3_gather' precision slot (ZeRO-3)", ZERO_ITEM)
    dev, opt = resolve_device(device), trainable.optimizer
    sync = mesh.joint_axis(tuple(sync_axes))
    scope = {name: mesh.axis(name) for name in mesh.shape}
    names = [info.name for info in trainable.var_infos()]
    policies = dict(policies or {})
    if precision.get("grad") and grad_sync is None:
        comp = GRAD_SLOT_COMPRESSORS[precision["grad"]]
        policies.update({nm: VarPolicy(comp) for nm in names
                         if nm not in policies})
    comps = {nm: Compressor.create(pol.compressor)
             for nm, pol in policies.items()}
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

    def store(nm, t):
        if nm not in sharded:
            return t
        dim, axis = sharded[nm]
        n = t.shape[dim] // axis.size
        return t.narrow(dim, axis.index * n, n)

    def init_fn(params, extra):
        stored = {nm: store(nm, t).detach().to(dev).clone()
                  for nm, t in flatten_with_names(params)}
        rows = {nm: torch.as_tensor(comp.init_state_flat(
                    stored[nm].numel()), device=dev)
                for nm, comp in comps.items() if comp.stateful}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt.init(stored),
                "extra": extra, "sync_state": rows}

    def sync_grads(grads: dict, rows: dict):
        """The compressed variables one by one, then each plain axis's
        variables in one flat fp32 mean, in the order of their first
        variable; returns the synced gradients and the new rows."""
        buckets, synced, new_rows = {}, {}, dict(rows)
        for nm, g in grads.items():
            pol = policies.get(nm)
            if pol is None:
                g, axis = grad_sync(nm, g)
                axis = sync if axis is None else axis
                buckets.setdefault(id(axis), (axis, {}))[1][nm] = g
                continue
            comp = comps[nm]
            red, row = comp.allreduce(
                g.reshape(-1).float(), rows[nm] if comp.stateful else None,
                sync if pol.axis is None else pol.axis)
            if comp.stateful:
                new_rows[nm] = row
            red = red.view(g.shape).to(g.dtype)
            synced[nm] = red if pol.scale == 1.0 else red * pol.scale
        for axis, group in buckets.values():
            synced.update(axis.pmean_all(group))
        return {nm: synced[nm] for nm in grads}, new_rows

    def micro_grads(params, batch, rng, extra):
        leaves = {nm: p.detach().requires_grad_(True)
                  for nm, p in params.items()}
        with torch.enable_grad(), axis_scope(scope):
            loss, new_extra, metrics = trainable.loss(
                unflatten(leaves), extra, batch, rng)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {nm: torch.zeros_like(params[nm]) if g is None else g
                 for nm, g in zip(leaves, grads)}
        return grads, new_extra, metrics

    def step_fn(state, batch, rng):
        params = state["params"]
        local_rng = cuda_graph.fold_seed(rng, sync.size, sync.index)

        def micro(mb, r, extra):
            return micro_grads(params, mb, r, extra)

        if accum == 1:
            grads, new_extra, metrics = micro(batch, local_rng,
                                              state["extra"])
        else:
            grads, new_extra, metrics = common.accumulate_microbatches(
                micro, batch, local_rng, state["extra"], accum)
        synced, rows = sync_grads(grads, state["sync_state"])
        updates, opt_state = opt.update(synced, state["opt_state"], params)
        new_state = {"step": state["step"] + 1,
                     "params": optim.apply_updates(params, updates),
                     "opt_state": opt_state,
                     "extra": mean_float_leaves(new_extra, sync),
                     "sync_state": rows}
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
