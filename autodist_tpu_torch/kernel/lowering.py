"""Strategy lowering: Strategy IR -> one data-parallel train step.

Counterpart of ``autodist_tpu/kernel/lowering.py`` for its
``collective`` lowering.  Where the JAX package traces one
``shard_map`` program, the port runs the same step eagerly in each
process of the job, one process a replica of the data axis.  Each
variable's synchronizer resolves (:func:`make_plan`) to one of three
update spaces, where its optimizer update runs:

* ``U_REPLICATED`` (AllReduce): the full variable on every rank; its
  gradient joins an all-reduce bucket (``g{group}:{compressor}``),
  flattened into one fp32 vector with the bucket's other variables and
  averaged by the bucket's :mod:`~autodist_tpu_torch.kernel.compressor`;
* ``U_FLAT`` (PS, ZeRO-1): the parameter stays whole, its gradient is
  flattened, padded and reduce-scattered, and each rank updates its own
  flat ``1/n`` (optimizer state included), then all-gathers the
  updated values;
* ``U_AXIS``: a ``1/n`` slice along the partitioner's dimension.  With
  a PS synchronizer the parameter is *stored* as that slice (FSDP) and
  gathered on use by a differentiable all-gather, whose backward
  reduce-scatters the gradient (a sum, which the step divides by
  ``n``); a sparse table's lookups move touched rows only
  (:class:`~autodist_tpu_torch.ops.sparse.ShardedEmbedding`).  With an
  AllReduce synchronizer (PartitionedAR) the parameter stays whole and
  its gradient is reduce-scattered along the dimension.

A step is, in order: the loss and its gradients on this replica's part
of the batch (dropout seed folded with the replica index), over
``accum_steps`` microbatches where the strategy asks
(:func:`~autodist_tpu_torch.kernel.common.accumulate_microbatches`);
the buckets' compressed all-reduces (with one replica the no-op
compressor's all-reduce is skipped, flatten and all, as the JAX
package's ``n == 1`` bypass; any other compressor runs); the
update-space gradients and parameter views; the optimizer on the
update space; the way back to storage; the metrics (floats averaged,
integer counts summed, flags OR-ed) and the defensive mean of float
``extra`` leaves.  Compressor state lives in ``state["sync_state"]``,
one row a rank and bucket.  The step updates nothing in place.

The lowerings other than ``pipeline``, ``expert`` and ``sequence``
(:mod:`autodist_tpu_torch.parallel.pipeline`,
:mod:`autodist_tpu_torch.parallel.moe` and
:mod:`autodist_tpu_torch.parallel.sequence`, to which :func:`lower`
hands those strategies), an asynchronous or stale-synchronous PS and a
precision policy raise ``NotImplementedError`` naming their ROADMAP
item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from autodist_tpu_torch import const, cuda_graph, optim
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.kernel.compressor import Compressor
from autodist_tpu_torch.strategy.ir import (ASYNC_PS_ITEM,
                                            AllReduceSynchronizer,
                                            PSSynchronizer, not_ported)

# Update spaces: where a variable's optimizer update runs.
U_REPLICATED = "replicated"   # the full variable on every rank
U_FLAT = "flat"               # a flat 1/n chunk a rank (ZeRO-1, PS)
U_AXIS = "axis"               # a 1/n slice along one dimension


@dataclasses.dataclass
class VarPlan:
    """Resolved per-variable lowering decision."""

    name: str
    shape: tuple
    dtype: Any
    stored_sharded: bool          # params stored as this rank's slice
    split_axis: int               # the U_AXIS / storage dimension
    update: str                   # U_REPLICATED | U_FLAT | U_AXIS
    bucket: Optional[str]         # all-reduce bucket (None: no bucket)
    compressor: str = "none"
    sparse_lookup: bool = False   # a row-sharded table: the loss gets a
                                  # ShardedEmbedding (touched rows only)

    def stored_shape(self, n: int) -> tuple:
        """This rank's stored tensor's shape."""
        if not self.stored_sharded:
            return self.shape
        return self.local_update_shape(n)

    def update_shape(self, n: int) -> tuple:
        """The global update-space shape (padded to divide by ``n``)."""
        if self.update == U_REPLICATED:
            return self.shape
        if self.update == U_FLAT:
            return (common.padded_flat_size(math.prod(self.shape), n),)
        return common.padded_shape(self.shape, self.split_axis, n)

    def local_update_shape(self, n: int) -> tuple:
        """This rank's part of :meth:`update_shape`."""
        shape = list(self.update_shape(n))
        if self.update == U_FLAT:
            shape[0] //= n
        elif self.update == U_AXIS:
            shape[self.split_axis] //= n
        return tuple(shape)


@dataclasses.dataclass
class Plan:
    """The compiled strategy: per-variable plans and the buckets."""

    var_plans: dict
    num_replicas: int
    buckets: dict                 # bucket key -> ordered variable names
    bucket_compressor: dict       # bucket key -> compressor name


def make_plan(trainable, strategy, mesh) -> Plan:
    """Resolve a Strategy against a mesh.  A partitioner's shard count
    resolves to the data axis's size, whatever it says (the JAX
    package's mesh resolution)."""
    n = mesh.num_replicas
    gc = strategy.graph_config
    if gc.replicas not in (0, n):
        raise ValueError(f"strategy built for {gc.replicas} replicas; the "
                         f"mesh has {n}")
    if gc.lowering != "collective":
        raise NotImplementedError(
            f"the {gc.lowering!r} lowering is not ported yet (ROADMAP "
            f"Queue 1, item 8)")
    if any(size > 1 for ax, size in mesh.shape.items()
           if ax != const.DATA_AXIS):
        raise ValueError(f"the collective lowering runs on a data-only "
                         f"mesh; this one is {mesh.shape}")
    if gc.precision:
        raise NotImplementedError(
            "a collective precision policy on the collective lowering "
            "(the JAX package's collective lowering reads none; the "
            "compressors are AllReduce(compressor=...)) is not ported "
            "(ROADMAP Queue 1, slice 2 leftovers, item 3)")
    node_index = {nc.var_name: nc for nc in strategy.node_configs}
    var_plans, buckets, bucket_comp = {}, {}, {}
    for info in trainable.var_infos():
        node = node_index.get(info.name)
        sync = node.synchronizer if node else AllReduceSynchronizer()
        part = node.partitioner if node else None
        split_axis = -1
        if part is not None and part.num_shards > 1:
            split_axis = max(part.split_axis, 0)
        if isinstance(sync, PSSynchronizer):
            if not sync.sync:
                not_ported(f"PS(sync=False) on {info.name} (asynchronous "
                           f"training)", ASYNC_PS_ITEM)
            if sync.staleness > 0:
                not_ported(f"PS(staleness={sync.staleness}) on "
                           f"{info.name} (stale-synchronous training)",
                           ASYNC_PS_ITEM)
            if split_axis >= 0 and info.shape:
                plan = VarPlan(info.name, info.shape, info.dtype,
                               stored_sharded=True, split_axis=split_axis,
                               update=U_AXIS, bucket=None,
                               sparse_lookup=bool(node.is_sparse)
                               and split_axis == 0)
            else:
                plan = VarPlan(info.name, info.shape, info.dtype,
                               stored_sharded=False, split_axis=-1,
                               update=U_FLAT, bucket=None)
        else:
            Compressor.create(sync.compressor)      # the name, checked
            if split_axis >= 0 and info.shape:
                plan = VarPlan(info.name, info.shape, info.dtype,
                               stored_sharded=False, split_axis=split_axis,
                               update=U_AXIS, bucket=None,
                               compressor=sync.compressor)
            else:
                key = f"g{sync.group}:{sync.compressor}"
                plan = VarPlan(info.name, info.shape, info.dtype,
                               stored_sharded=False, split_axis=-1,
                               update=U_REPLICATED, bucket=key,
                               compressor=sync.compressor)
                buckets.setdefault(key, []).append(info.name)
                bucket_comp[key] = sync.compressor
        var_plans[info.name] = plan
    return Plan(var_plans=var_plans, num_replicas=n, buckets=buckets,
                bucket_compressor=bucket_comp)


def sync_state_init(plan: Plan) -> dict:
    """Each stateful compressor's first state row, a bucket (host
    numpy; every rank starts from the same row): the error-feedback
    residual, and PowerSGD's warm-started ``Q`` behind it."""
    rows = {}
    for key, names in plan.buckets.items():
        comp = Compressor.create(plan.bucket_compressor[key])
        if comp.stateful:
            total = sum(math.prod(plan.var_plans[nm].shape) for nm in names)
            rows[key] = comp.init_state_flat(total)
    return rows


def reduce_metrics(metrics: dict, mesh, axis=None) -> dict:
    """Metrics across replicas (``axis``, by default the data axis):
    floats averaged, integer counts summed, flags OR-ed, each kind in
    one all-reduce."""
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    axis = mesh.axis(const.DATA_AXIS) if axis is None else axis
    if axis.size == 1 or not metrics:
        return metrics
    floats = [k for k, v in metrics.items() if v.is_floating_point()]
    counts = [k for k in metrics if k not in floats]
    out = dict(metrics)
    if floats:
        stacked = axis.pmean(torch.stack([metrics[k].float()
                                          for k in floats]))
        out.update({k: stacked[i].to(metrics[k].dtype)
                    for i, k in enumerate(floats)})
    if counts:
        summed = axis.psum(torch.stack([metrics[k].long()
                                        for k in counts]))
        out.update({k: summed[i] > 0 if metrics[k].dtype == torch.bool
                    else summed[i].to(metrics[k].dtype)
                    for i, k in enumerate(counts)})
    return out


def mean_float_leaves(tree, axis):
    """Float tensors of a nest of dicts, lists and tuples averaged over
    ``axis``; everything else as it is."""
    if isinstance(tree, torch.Tensor):
        return axis.pmean(tree) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: mean_float_leaves(v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(mean_float_leaves(v, axis) for v in tree)
    return tree


@dataclasses.dataclass
class Lowered:
    """The lowered step and the state layout.  ``full_params_fn`` maps
    the stored ``{name: tensor}`` params to the full logical ones (a
    collective where variables are sharded; the identity otherwise);
    ``batch_axis`` is the :class:`~autodist_tpu_torch.parallel.axis
    .Axis` whose ranks each take a shard of the batch (``None``: the
    data axis); ``placement`` (``batch -> {leaf name: ((dim, Axis),
    ...)}``), where given, replaces that single batch axis per leaf
    (:meth:`placement_of`).

    The records of what the lowering did with the strategy's requests:
    ``zero3_shapes`` the logical shape of each variable stored as a
    flat ZeRO-3 shard (``full_params_fn`` returns it at that shape);
    ``zero_degraded`` each ZeRO request that degraded to plain sync,
    with its reason (JAX ``zero_degraded``); ``unapplied`` each
    precision slot or compressor the lowering has no boundary for or
    leaves unapplied, with its reason, where the JAX package drops it
    (its expert lowering's ``grad`` slot, a compressor on a pipeline
    without a data axis)."""

    plan: Any
    mesh: Any
    device: torch.device
    init_fn: Callable     # (params, extra) -> state
    step_fn: Callable     # (state, batch, rng) -> (state, metrics)
    full_params_fn: Optional[Callable] = None
    batch_axis: Any = None
    placement: Optional[Callable] = None
    zero3_shapes: dict = dataclasses.field(default_factory=dict)
    zero_degraded: dict = dataclasses.field(default_factory=dict)
    unapplied: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.batch_axis is None:
            self.batch_axis = self.mesh.axis(const.DATA_AXIS)

    def placement_of(self, batch) -> dict:
        """``{leaf name: ((dim, Axis), ...)}``: each leaf of a step's
        batch is cut along each ``dim`` over each axis, this rank
        keeping its contiguous slice (a leaf with fewer dims goes
        whole).  By default every leaf's dim 0 over ``batch_axis``."""
        if self.placement is not None:
            return self.placement(batch)
        return {name: ((0, self.batch_axis),) for name in batch}

    @property
    def host_staged(self) -> bool:
        """Whether the step's collectives on the card go through host
        memory: a gloo group of several ranks on any of its axes."""
        return any(axis.stages_through_host for axis in
                   (*self.mesh.axes.values(), self.batch_axis))

    @property
    def capturable(self) -> bool:
        """Whether ``run_steps`` records the window into one CUDA graph:
        the step runs on the card with no host round trip (one replica,
        or NCCL groups).  Otherwise it runs the steps in a host loop."""
        return self.device.type == "cuda" and not self.host_staged

    def init_state(self, trainable):
        return self.init_fn(trainable.params, trainable.extra)

    def full_params(self, params: dict) -> dict:
        return self.full_params_fn(params) if self.full_params_fn \
            else params


def lower(trainable, strategy, mesh, device=None) -> Lowered:
    """Build the train step for (trainable, strategy, mesh) on ``device``
    (``None``: the card): the data-parallel step here, the pipeline
    lowering for a ``Pipeline`` strategy, the expert lowering for an
    ``ExpertParallel`` one, the sequence lowering for a
    ``SequenceParallel`` one."""
    if strategy.graph_config.lowering == "pipeline":
        from autodist_tpu_torch.parallel.pipeline import lower_pipeline

        return lower_pipeline(trainable, strategy, mesh, device)
    if strategy.graph_config.lowering == "expert":
        from autodist_tpu_torch.parallel.moe import lower_expert_ir

        return lower_expert_ir(trainable, strategy, mesh, device)
    if strategy.graph_config.lowering == "sequence":
        from autodist_tpu_torch.parallel.sequence import lower_sequence_ir

        return lower_sequence_ir(trainable, strategy, mesh, device)
    from autodist_tpu_torch.ops.sparse import ShardedEmbedding

    plan = make_plan(trainable, strategy, mesh)
    n, dev, opt = plan.num_replicas, resolve_device(device), trainable.optimizer
    axis = mesh.axis(const.DATA_AXIS)
    vps = plan.var_plans
    accum = max(strategy.graph_config.accum_steps, 1)
    comps = {key: Compressor.create(name)
             for key, name in plan.bucket_compressor.items()}
    sync_init = sync_state_init(plan)

    def store(nm, t):
        vp = vps[nm]
        if not vp.stored_sharded:
            return t
        return common.local_axis_shard(t, axis, vp.split_axis)

    def u_param(nm, p):
        vp = vps[nm]
        if vp.update == U_REPLICATED or vp.stored_sharded:
            return p
        if vp.update == U_FLAT:
            return common.local_flat_shard(p, axis)
        return common.local_axis_shard(p, axis, vp.split_axis)

    def init_fn(params, extra):
        flat = dict(common.flatten_with_names(params))
        stored = {nm: store(nm, flat[nm].detach().to(dev)).clone()
                  for nm in vps}
        u_params = {nm: u_param(nm, p) for nm, p in stored.items()}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt.init(u_params),
                "extra": extra,
                "sync_state": {key: torch.as_tensor(row, device=dev)
                               for key, row in sync_init.items()}}

    def full(stored: dict, train: bool) -> dict:
        """Stored params to the loss's view: sharded variables gathered
        (a sparse table wrapped instead when ``train``)."""
        out = {}
        for nm, p in stored.items():
            vp = vps[nm]
            if vp.sparse_lookup and train:
                p = ShardedEmbedding(p, vp.shape[0], axis)
            elif vp.stored_sharded:
                p = common.all_gather_axis(p, axis, vp.split_axis,
                                           vp.shape[vp.split_axis])
            out[nm] = p
        return out

    def micro_grads(params, batch, rng, extra):
        leaves = {nm: p.detach().requires_grad_(True)
                  for nm, p in params.items()}
        with torch.enable_grad():
            loss, new_extra, metrics = trainable.loss(
                common.unflatten(full(leaves, True)), extra, batch, rng)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {nm: torch.zeros_like(params[nm]) if g is None else g
                 for nm, g in zip(leaves, grads)}
        return grads, new_extra, metrics

    def sync_buckets(grads: dict, sync_state: dict):
        """Each bucket's gradients as one flat fp32 vector through its
        compressor's all-reduce; returns the synced gradients and the
        new compressor rows."""
        synced, new_sync = {}, dict(sync_state)
        for key, names in plan.buckets.items():
            comp = comps[key]
            if n == 1 and type(comp) is Compressor:
                synced.update({nm: grads[nm] for nm in names})
                continue
            flat = torch.cat([grads[nm].reshape(-1).float()
                              for nm in names])
            reduced, row = comp.allreduce(
                flat, sync_state[key] if comp.stateful else None, axis)
            if comp.stateful:
                new_sync[key] = row
            offset = 0
            for nm in names:
                size = math.prod(vps[nm].shape)
                synced[nm] = reduced[offset:offset + size].view(
                    vps[nm].shape).to(grads[nm].dtype)
                offset += size
        return synced, new_sync

    def u_grad(nm, g, synced):
        vp = vps[nm]
        if vp.update == U_REPLICATED:
            return synced[nm]
        if vp.update == U_FLAT:
            return common.reduce_scatter_flat(g, axis)
        if vp.stored_sharded:
            # The gather's backward summed the replicas' gradients.
            return g / n if n > 1 else g
        return common.reduce_scatter_axis(g, axis, vp.split_axis)

    def to_store(nm, un):
        vp = vps[nm]
        if vp.update == U_REPLICATED or vp.stored_sharded:
            return un
        if vp.update == U_FLAT:
            return common.all_gather_flat(un, axis, vp.shape)
        return common.all_gather_axis(un, axis, vp.split_axis,
                                      vp.shape[vp.split_axis])

    def step_fn(state, batch, rng):
        params = state["params"]
        local_rng = cuda_graph.fold_seed(rng, n, mesh.replica)

        def micro(mb, r, extra):
            return micro_grads(params, mb, r, extra)

        if accum == 1:
            grads, new_extra, metrics = micro(batch, local_rng,
                                              state["extra"])
        else:
            grads, new_extra, metrics = common.accumulate_microbatches(
                micro, batch, local_rng, state["extra"], accum)
        synced, new_sync = sync_buckets(grads, state["sync_state"])
        u_grads = {nm: u_grad(nm, g, synced) for nm, g in grads.items()}
        u_params = {nm: u_param(nm, p) for nm, p in params.items()}
        updates, opt_state = opt.update(u_grads, state["opt_state"],
                                        u_params)
        u_new = optim.apply_updates(u_params, updates)
        new_state = {"step": state["step"] + 1,
                     "params": {nm: to_store(nm, u) for nm, u in
                                u_new.items()},
                     "opt_state": opt_state,
                     "extra": mean_float_leaves(new_extra, axis),
                     "sync_state": new_sync}
        return new_state, reduce_metrics(metrics, mesh)

    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn,
                   full_params_fn=lambda stored: full(stored, False))
