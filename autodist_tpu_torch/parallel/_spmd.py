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
   a ZeRO-3 variable is stored as its flat shard and gathered into the
   loss by :func:`~autodist_tpu_torch.kernel.common.zero3_gather`, so
   its gradient arrives reduce-scattered;
2. each gradient synchronized by its :class:`VarPolicy` (resolved from
   the strategy's node configs by :func:`policies_from_node_configs`):
   ZeRO reduce-scatters it flat over its axes (a ZeRO-3 gradient is
   only divided: the gather's backward scattered it); a compressor runs
   its compressed all-reduce, with its own state row in
   ``state["sync_state"]``; every other variable is averaged over its
   axis, the variables of one axis in one flat fp32 all-reduce; the
   ``grad`` precision slot elects the error-feedback compressor for
   every variable without a policy where the default sync applies;
3. the optimizer update, on each ZeRO variable's flat ``1/n`` shard
   (its optimizer state lives there only), the others whole; ZeRO-1
   and 2 then all-gather the updated values, ZeRO-3 keeps the shard;
4. metrics (floats averaged, counts summed, flags OR-ed) and float
   ``extra`` leaves averaged over ``sync_axes``.

A ZeRO request on a variable the lowering already stores sharded
degrades to plain sync and is recorded on the returned
:class:`~autodist_tpu_torch.kernel.lowering.Lowered`
(``zero_degraded``), as the JAX package records it.  Its state manifest
is the ``replicated_spmd`` family's (JAX ``_spmd`` ``_state_manifest``):
a ZeRO-3 parameter and a ZeRO variable's optimizer state are flat
shards of their ZeRO axis, a variable the lowering stores sharded is
its axis's slice, a compressor's state one row a rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from autodist_tpu_torch import cuda_graph, optim
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.kernel.compressor import Compressor
from autodist_tpu_torch.parallel.axis import axis_scope
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer,
                                            PSSynchronizer,
                                            normalize_precision)

# The grad slot's compressor for each narrowed precision.
GRAD_SLOT_COMPRESSORS = {"bf16": "bf16_ef", "int8": "int8_ef"}


@dataclasses.dataclass(frozen=True)
class VarPolicy:
    """A variable's synchronization (JAX ``VarPolicy``): ``zero_axes``
    non-empty is ZeRO over those mesh axes at ``zero_stage`` (1 and 2
    run one program, the flat reduce-scatter and the gather after the
    update; 3 also stores the parameter as the flat shard);
    ``compressor`` a compressed all-reduce over ``sync_axes`` (``None``:
    the builder's; ``()``: no sync at all); the mean then multiplied by
    ``scale``."""

    zero_axes: tuple = ()
    zero_stage: int = 1
    compressor: str = "none"
    sync_axes: Optional[tuple] = None
    scale: float = 1.0


def ssp_staleness_from(strategy) -> int:
    """The largest ``staleness`` of the strategy's synchronous PS nodes:
    the bound the runner's host-side SSP gate enforces.  The gate does
    not depend on the lowering: inside one process group the step is
    lockstep anyway; the gate bounds the skew between processes."""
    return max((nc.synchronizer.staleness for nc in strategy.node_configs
                if isinstance(nc.synchronizer, PSSynchronizer)
                and nc.synchronizer.sync), default=0)


def policies_from_node_configs(strategy, mesh, *, replicated_axes,
                               axes_for: Optional[Callable] = None,
                               scale_for: Optional[Callable] = None,
                               sharded_vars=(), degraded: dict) -> dict:
    """``{name: VarPolicy}`` of a strategy's node configs (JAX
    ``policies_from_node_configs``).

    A PS synchronizer is ZeRO at its ``zero_stage`` over
    ``axes_for(name)`` (default ``replicated_axes``) where those axes
    hold more than one rank; an AllReduce one with a compressor runs it
    over the same axes; ``scale_for(name)`` scales the mean.  A ZeRO
    request on a variable in ``sharded_vars`` (stored sharded by the
    lowering: its optimizer state already shards with it) degrades to
    plain sync, its reason written into ``degraded``.  An asynchronous
    PS (``sync=False``) raises; a stale one is a synchronous PS here,
    its bound the runner's SSP gate's (:func:`ssp_staleness_from`)."""
    sharded_vars = set(sharded_vars)
    policies = {}
    for nc in strategy.node_configs:
        name, sync = nc.var_name, nc.synchronizer
        axes = tuple(axes_for(name)) if axes_for else tuple(replicated_axes)
        scale = float(scale_for(name)) if scale_for else 1.0
        if isinstance(sync, PSSynchronizer):
            if not sync.sync:
                raise NotImplementedError(
                    f"PS(sync=False) on {name}: asynchronous training does "
                    "not lower to a synchronous SPMD program; build through "
                    "AutoDist (which dispatches to AsyncPSRunner) or use "
                    "sync=True")
            stage = int(sync.zero_stage or 1)
            if stage not in (1, 2, 3):
                raise ValueError(
                    f"{name}: PSSynchronizer.zero_stage must be 1, 2 or 3 "
                    f"(got {stage})")
            if name in sharded_vars:
                degraded[name] = (
                    "parameter stored sharded by this lowering; optimizer "
                    f"state already shards with it — the ZeRO-{stage} (PS) "
                    "request degrades to plain sync")
                if scale != 1.0 or axes != tuple(replicated_axes):
                    policies[name] = VarPolicy(sync_axes=axes, scale=scale)
                continue
            if math.prod(mesh.shape.get(a, 1) for a in axes) > 1:
                policies[name] = VarPolicy(zero_axes=axes, zero_stage=stage,
                                           sync_axes=axes, scale=scale)
        elif isinstance(sync, AllReduceSynchronizer):
            comp = sync.compressor or "none"
            if comp != "none":
                Compressor.create(comp)          # the name, checked
                policies[name] = VarPolicy(compressor=comp, sync_axes=axes,
                                           scale=scale)
    return policies


def axis_over(mesh, names):
    """The :class:`~autodist_tpu_torch.parallel.axis.Axis` over mesh
    axes ``names``, taken in the mesh's order so that its index is the
    rank's place in the group (what a flat shard's reduce-scatter and
    gather agree on); the mesh keeps one group per set of names, made in
    the order the callers ask, the same on every rank."""
    return mesh.joint_axis(tuple(sorted(names, key=list(mesh.shape).index)))


@dataclasses.dataclass(frozen=True)
class UpdateSpace:
    """Where each gradient is reduced and each optimizer update runs,
    as both SPMD lowerings (this one and the pipeline's) keep them:
    ``zaxes`` the ZeRO axis of each ZeRO variable, ``zero3`` those of
    them stored as their flat shard, ``comps`` each compressed
    variable's :class:`~autodist_tpu_torch.kernel.compressor
    .Compressor`."""

    zaxes: dict
    zero3: frozenset
    comps: dict

    def _flat(self, nm) -> bool:
        return nm in self.zaxes and nm not in self.zero3

    def view(self, params: dict) -> dict:
        """The update space: a ZeRO-1/2 variable's flat shard of its
        stored tensor; the stored tensor otherwise (a ZeRO-3 one is its
        shard)."""
        return {nm: common.local_flat_shard(p, self.zaxes[nm])
                if self._flat(nm) else p for nm, p in params.items()}

    def init(self, opt, stored: dict, dev):
        """The optimizer state over the update space, and one state row
        a rank for each stateful compressor, as wide as its variable's
        stored tensor."""
        rows = {nm: torch.as_tensor(comp.init_state_flat(
                    stored[nm].numel()), device=dev)
                for nm, comp in self.comps.items() if comp.stateful}
        return opt.init(self.view(stored)), rows

    def zero_reduce(self, nm, g, n: int):
        """A ZeRO gradient summed into this rank's flat shard over its
        ZeRO axis and made the mean of its ``n`` replicas (a ZeRO-3 one
        arrives scattered by its gather's backward: only divided)."""
        if nm not in self.zero3:
            g = common.reduce_scatter_flat(g, self.zaxes[nm], mean=False)
        return g / n if n > 1 else g

    def compress(self, nm, g, rows: dict, new_rows: dict, axis):
        """A compressed variable's all-reduce over ``axis`` with its
        state row (the new row into ``new_rows``)."""
        comp = self.comps[nm]
        red, row = comp.allreduce(g.reshape(-1).float(),
                                  rows[nm] if comp.stateful else None, axis)
        if comp.stateful:
            new_rows[nm] = row
        return red.view(g.shape).to(g.dtype)

    def update(self, opt, synced: dict, opt_state, params: dict):
        """The optimizer step on the update space; each ZeRO-1/2
        variable all-gathered back to its stored shape.  Returns the new
        params and optimizer state."""
        u = self.view(params)
        updates, opt_state = opt.update(synced, opt_state, u)
        u_new = optim.apply_updates(u, updates)
        return {nm: common.all_gather_flat(x, self.zaxes[nm],
                                           tuple(params[nm].shape))
                if self._flat(nm) else x
                for nm, x in u_new.items()}, opt_state


def build_replicated_spmd(trainable, mesh, *, sync_axes: Sequence[str],
                          batch_spec_fn: Optional[Callable] = None,
                          param_spec_fn: Optional[Callable] = None,
                          grad_sync: Optional[Callable] = None,
                          policies: Optional[dict] = None,
                          zero_degraded: Optional[dict] = None,
                          unapplied: Optional[dict] = None,
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
        joint ``sync_axes`` (the default for every variable without a
        policy).
      policies: ``{name: VarPolicy}``
        (:func:`policies_from_node_configs`).
      zero_degraded, unapplied: the lowering's records, kept on the
        returned ``Lowered``.
      accum: the microbatches a step.
      precision: the strategy's precision policy: ``zero3_gather``
        narrows every ZeRO-3 gather and its backward scatter; the
        ``grad`` slot elects the matching error-feedback compressor for
        every variable without a policy, where the default
        ``grad_sync`` applies (a custom one, the expert lowering's
        scaled rule, keeps its own sync and the slot is recorded in
        ``unapplied``, as the JAX package leaves it unapplied).
    """
    from autodist_tpu_torch.kernel.lowering import (Lowered, flat_ops,
                                                    leaf_record,
                                                    mean_float_leaves,
                                                    reduce_metrics,
                                                    split_record)

    precision = normalize_precision(precision)
    zero3_precision = precision.get("zero3_gather", "fp32")
    unapplied = dict(unapplied or {})
    dev, opt = resolve_device(device), trainable.optimizer
    # The joint sync axis indexes in the order given (the dropout fold,
    # JAX ``axis_index(sync_axes)``); it serves the policies too where
    # that is the mesh's order (the mesh keeps it).
    sync = mesh.joint_axis(tuple(sync_axes))
    scope = {name: mesh.axis(name) for name in mesh.shape}
    infos = {info.name: info for info in trainable.var_infos()}
    policies = dict(policies or {})
    if precision.get("grad"):
        if grad_sync is None:
            comp = GRAD_SLOT_COMPRESSORS[precision["grad"]]
            policies.update({nm: VarPolicy(compressor=comp) for nm in infos
                             if nm not in policies})
        else:
            unapplied["grad"] = (
                "the lowering syncs gradients by its own per-variable rule "
                "(the expert lowering's 1/E-scaled data mean); the grad "
                "slot's blanket compressor is not applied, as in the JAX "
                "package")
    comps = {nm: Compressor.create(pol.compressor)
             for nm, pol in sorted(policies.items())
             if pol.compressor != "none"}
    flat = dict(flatten_with_names(trainable.params))
    sharded = {}
    for name in infos:
        spec = param_spec_fn(name, flat[name]) if param_spec_fn else None
        if spec is not None:
            dim, axis = spec
            if flat[name].shape[dim] % axis.size:
                raise ValueError(
                    f"{name}: dim {dim} of {tuple(flat[name].shape)} does "
                    f"not divide by the {axis.size}-way {axis.name!r} axis")
            sharded[name] = spec
    # Each policy's axes, one group per set, made in name order on
    # every rank.
    zaxes, paxes = {}, {}
    for name, pol in sorted(policies.items()):
        if pol.zero_axes:
            if name in sharded:
                raise ValueError(
                    f"{name}: ZeRO-{pol.zero_stage} requires a replicated "
                    "parameter; this lowering stores it sharded")
            zaxes[name] = axis_over(mesh, pol.zero_axes)
        elif pol.sync_axes:
            paxes[name] = axis_over(mesh, pol.sync_axes)
        elif pol.sync_axes is None:
            paxes[name] = sync

    space = UpdateSpace(zaxes, frozenset(
        nm for nm in zaxes
        if policies[nm].zero_stage >= 3 and zaxes[nm].size > 1), comps)

    shapes = {nm: tuple(info.shape) for nm, info in infos.items()}
    zero3_shapes = {nm: shapes[nm] for nm in infos if nm in space.zero3}
    if grad_sync is None:
        grad_sync = lambda name, g: (g, None)              # noqa: E731

    def store(nm, t):
        if nm in space.zero3:
            return common.local_flat_shard(t, zaxes[nm])
        if nm not in sharded:
            return t
        dim, axis = sharded[nm]
        n = t.shape[dim] // axis.size
        return t.narrow(dim, axis.index * n, n)

    def init_fn(params, extra):
        stored = {nm: store(nm, t).detach().to(dev).clone()
                  for nm, t in flatten_with_names(params)}
        opt_state, rows = space.init(opt, stored, dev)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt_state,
                "extra": extra, "sync_state": rows}

    def gather_full(leaves: dict) -> dict:
        """The loss's view: each ZeRO-3 shard gathered, in name order
        (eager PyTorch keeps program order, which the JAX package's
        chained gathers enforce on XLA)."""
        return {nm: common.zero3_gather(p, zaxes[nm], shapes[nm],
                                        zero3_precision)
                if nm in space.zero3 else p for nm, p in leaves.items()}

    def sync_grads(grads: dict, rows: dict):
        """The policied variables one by one in name order (ZeRO's flat
        reduce-scatter, a compressor's all-reduce), then each plain
        axis's variables in one flat fp32 mean, in the order of their
        first variable; returns the synced update-space gradients and
        the new rows."""
        buckets, synced, new_rows = {}, {}, dict(rows)
        for nm, g in grads.items():
            pol = policies.get(nm)
            if pol is None:
                g, axis = grad_sync(nm, g)
                axis = sync if axis is None else axis
                buckets.setdefault(id(axis), (axis, {}))[1][nm] = (g, 1.0)
                continue
            if nm in zaxes:
                red = space.zero_reduce(nm, g, zaxes[nm].size)
            elif nm not in paxes:
                red = g                        # replicated over no axis
            elif nm in comps:
                red = space.compress(nm, g, rows, new_rows, paxes[nm])
            else:
                axis = paxes[nm]
                buckets.setdefault(id(axis), (axis, {}))[1][nm] = (
                    g, pol.scale)
                continue
            synced[nm] = red if pol.scale == 1.0 else red * pol.scale
        for axis, group in buckets.values():
            means = axis.pmean_all({nm: g for nm, (g, _) in group.items()})
            synced.update({nm: means[nm] if s == 1.0 else means[nm] * s
                           for nm, (_, s) in group.items()})
        return {nm: synced[nm] for nm in grads}, new_rows

    def micro_grads(params, batch, rng, extra):
        leaves = {nm: p.detach().requires_grad_(True)
                  for nm, p in params.items()}
        with torch.enable_grad(), axis_scope(scope):
            loss, new_extra, metrics = trainable.loss(
                unflatten(gather_full(leaves)), extra, batch, rng)
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
        new_params, opt_state = space.update(opt, synced,
                                             state["opt_state"], params)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt_state": opt_state,
                     "extra": mean_float_leaves(new_extra, sync),
                     "sync_state": rows}
        return new_state, reduce_metrics(metrics, mesh, axis=sync)

    def eval_fn(state, batch, rng):
        """The eval loss on the full parameters, no update; the metrics
        reduced over the joint sync axis."""
        with torch.no_grad(), axis_scope(scope):
            _, _, metrics = trainable.eval_loss(
                unflatten(gather_full(state["params"])), state["extra"],
                batch, cuda_graph.fold_seed(rng, sync.size, sync.index))
        return reduce_metrics(metrics, mesh, axis=sync)

    def full_params(stored: dict) -> dict:
        """The logical tree: ZeRO-3 shards gathered and unpadded, the
        lowering's sharded variables gathered."""
        out = {}
        for nm, t in stored.items():
            if nm in space.zero3:
                t = common.all_gather_flat(t, zaxes[nm], shapes[nm])
            elif nm in sharded:
                dim, axis = sharded[nm]
                t = axis.all_gather(t, dim=dim)
            out[nm] = t
        return out

    world = math.prod(mesh.shape.values())
    everyone = "+".join(a for a, n in mesh.shape.items() if n > 1) or \
        next(iter(mesh.shape), "data")

    def u_local(nm) -> tuple:
        """A variable's update-space shape on this rank."""
        if nm in zaxes and zaxes[nm].size > 1:
            return (common.padded_flat_size(math.prod(shapes[nm]),
                                            zaxes[nm].size)
                    // zaxes[nm].size,)
        if nm in sharded:
            dim, axis = sharded[nm]
            return tuple(s // axis.size if d == dim else s
                         for d, s in enumerate(shapes[nm]))
        return shapes[nm]

    def layout_of(nm):
        """A variable's update-space leaf: its global shape, recipe and
        split."""
        if nm in zaxes and zaxes[nm].size > 1:
            glob = (common.padded_flat_size(math.prod(shapes[nm]),
                                            zaxes[nm].size),)
            return glob, flat_ops(glob, shapes[nm]), split_record(zaxes[nm], 0)
        if nm in sharded:
            dim, axis = sharded[nm]
            return shapes[nm], [], split_record(axis, dim)
        return shapes[nm], [], None

    def state_manifest(state):
        leaves, sync_rec = {}, {}
        for name, leaf in common.state_leaves(state):
            shape, ops, split = tuple(leaf.shape), [], None
            if name.startswith("params/") and name[7:] in shapes:
                nm = name[7:]
                if nm in space.zero3 or nm in sharded:
                    shape, ops, split = layout_of(nm)
            elif name.startswith("opt_state/"):
                local = shape
                var = common.match_var_by_suffix(
                    name, shapes, shape_ok=lambda v: local == u_local(v))
                if var is not None:
                    shape, ops, split = layout_of(var)
            elif name.startswith("sync_state/"):
                key = name[len("sync_state/"):]
                shape = (world, int(leaf.numel()))
                split = {"axis": everyone, "dim": 0, "ranks": world}
                pol = policies.get(key)
                sync_rec[name] = {"rows": world, "width": int(leaf.numel()),
                                  "compressor": pol.compressor if pol
                                  else "none"}
            leaves[name] = leaf_record(shape, leaf.dtype, ops, split)
        return {"family": "replicated_spmd", "leaves": leaves,
                "sync": sync_rec}

    sync_init = {nm: comp.init_state_flat(math.prod(u_local(nm)))
                 for nm, comp in comps.items() if comp.stateful}
    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn, full_params_fn=full_params,
                   eval_fn=eval_fn, batch_axis=sync, placement=batch_spec_fn,
                   zero3_shapes=zero3_shapes,
                   zero_degraded=dict(zero_degraded or {}),
                   unapplied=unapplied, state_manifest_fn=state_manifest,
                   sync_init=sync_init)
