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

The replicas are the mesh's replica axes (:func:`replica_axes`):
``data``, or ``dcn x data`` on a multi-slice mesh, one joint
:class:`~autodist_tpu_torch.parallel.axis.Axis` whose ranks every
bucket, flat shard and slice above spans (``Plan.repl_axes``).

A step is, in order: the loss and its gradients on this replica's part
of the batch (dropout seed folded with the replica index; the replica
axes bound by name, forward and backward, so that model code may name
``data`` as flax's cross-replica BatchNorm does; the eval program binds
none), over
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

:func:`lower` hands the ``pipeline``, ``expert``, ``sequence`` and
``gspmd`` lowerings to :mod:`autodist_tpu_torch.parallel.pipeline`,
:mod:`autodist_tpu_torch.parallel.moe`,
:mod:`autodist_tpu_torch.parallel.sequence` and
:mod:`autodist_tpu_torch.kernel.gspmd`.  An asynchronous PS
(``sync=False``) raises: it is not one synchronous program, and
:class:`~autodist_tpu_torch.autodist.AutoDist` runs it on the
:class:`~autodist_tpu_torch.runner.AsyncPSRunner`.  A stale-synchronous
PS (``staleness > 0``) lowers to the synchronous step;
:meth:`~autodist_tpu_torch.autodist.AutoDist.lower` records its bound in
``Lowered.ssp_staleness`` (and the collective ``Plan.ssp_staleness``)
for the runner's host-side SSP gate.  A precision
policy trains the fp32 program, as in the JAX package, whose collective
lowering reads none; its slots are recorded in ``Lowered.unapplied``.

``Lowered.state_manifest(state)`` is the elastic state codec (below):
per leaf, the global stored shape, the recipe from it to the logical
form, and where the ranks' parts of it lie.
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
from autodist_tpu_torch.parallel.axis import axis_scope
from autodist_tpu_torch.resource import REPLICA_AXES
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer,
                                            PSSynchronizer,
                                            normalize_precision)

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
    ssp_staleness: int = 0        # max PSSynchronizer.staleness (the
                                  # runner's host-side SSP gate), stamped
                                  # by AutoDist.lower
    repl_axes: tuple = (const.DATA_AXIS,)   # ("dcn", "data") multi-slice


def replica_axes(mesh) -> tuple:
    """The data-parallel replica axes of a mesh: ``("dcn", "data")``
    where a cross-slice axis exists, else ``("data",)``; raises without
    a data axis (JAX ``replica_axes``)."""
    axes = tuple(a for a in REPLICA_AXES if a in mesh.shape)
    if const.DATA_AXIS not in axes:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no '{const.DATA_AXIS}' axis")
    return axes


def make_plan(trainable, strategy, mesh) -> Plan:
    """Resolve a Strategy against a mesh.  A partitioner's shard count
    resolves to the replica group's size, whatever it says (the JAX
    package's mesh resolution)."""
    repl = replica_axes(mesh)
    n = math.prod(mesh.shape[a] for a in repl)
    gc = strategy.graph_config
    if gc.replicas not in (0, n):
        raise ValueError(f"strategy built for {gc.replicas} replicas; the "
                         f"mesh has {n}")
    if gc.lowering != "collective":
        raise ValueError(f"make_plan resolves the collective lowering; "
                         f"this strategy's is {gc.lowering!r}")
    if any(size > 1 for ax, size in mesh.shape.items() if ax not in repl):
        raise ValueError(f"the collective lowering runs on a data-only "
                         f"mesh (dcn x data); this one is {mesh.shape}")
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
                # Asynchronous PS is another execution mode (host-side
                # push and pull, runner.AsyncPSRunner); training it
                # synchronously would misreport what was asked for.
                raise NotImplementedError(
                    f"PS(sync=False) on {info.name}: asynchronous training "
                    "does not lower to a synchronous SPMD program; build "
                    "through AutoDist (which dispatches to AsyncPSRunner) "
                    "or use sync=True")
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
                bucket_compressor=bucket_comp, repl_axes=repl)


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


def _flat_all_reduce(tensors: list, reduce, dtype) -> list:
    """``tensors`` (any shapes) through one all-reduce ``reduce`` of
    their flattened concatenation in ``dtype``; each comes back at its
    shape, in ``dtype``."""
    flat = reduce(torch.cat([t.reshape(-1).to(dtype) for t in tensors]))
    out, offset = [], 0
    for t in tensors:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def reduce_metrics(metrics: dict, mesh, axis=None) -> dict:
    """Metrics across replicas (``axis``, by default the replica group),
    leaf by leaf at any shape (a fetched tensor too): floats averaged,
    integer counts summed, flags OR-ed, each kind in one all-reduce."""
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    axis = mesh.replica_axis() if axis is None else axis
    if axis.size == 1 or not metrics:
        return metrics
    floats = [k for k, v in metrics.items() if v.is_floating_point()]
    counts = [k for k in metrics if k not in floats]
    out = dict(metrics)
    if floats:
        means = _flat_all_reduce([metrics[k] for k in floats], axis.pmean,
                                 torch.float32)
        out.update({k: m.to(metrics[k].dtype)
                    for k, m in zip(floats, means)})
    if counts:
        sums = _flat_all_reduce([metrics[k] for k in counts], axis.psum,
                                torch.int64)
        out.update({k: m > 0 if metrics[k].dtype == torch.bool
                    else m.to(metrics[k].dtype)
                    for k, m in zip(counts, sums)})
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


# --------------------------------------------------------------------------- #
# The state codec: the declarative stored <-> logical record of each leaf.
#
# Every lowering stores training state in its own layout (padding, flat
# ZeRO shards, one rank's slice).  A manifest leaf records, as the JAX
# package's does, the *global* stored shape (padding included), its
# dtype, the logical shape, and a recipe: a list of invertible ops from
# the stored to the logical form (JAX ``kernel/lowering.py``), applied
# by :mod:`autodist_tpu_torch.elastic.reshard` on the card or on the
# host, inverted mechanically for a target layout, and serialized in a
# checkpoint's sidecar.  Ops (forward = stored -> logical; each records
# its input shape; padding the inverse re-inserts is zero, as storage
# padding is):
#
# * ``reshape``    to ``shape``
# * ``slice``      the leading ``[0:s]`` of each dim, to ``shape``
# * ``index0``     ``arr[indices]`` along dim 0
# * ``flat_slice`` ``arr.reshape(-1)[:size]``
#
# A port rank holds only its part of a stored leaf, so each record has
# one field more than the JAX package's, ``split``: ``None`` where every
# rank holds the whole leaf, else ``{"axis": name, "dim": d, "ranks":
# n}``: the global stored leaf is the ranks' parts concatenated along
# ``d`` in the axis's rank order (a part with one dim fewer is one
# slice of ``d``: a compressor's state row), or a list of such records,
# outermost first, where a leaf splits over several mesh axes (a
# DTensor's placements).  An axis name joins mesh axes with ``+``
# (``data+seq``: their joint axis, row-major in the mesh's order).
# --------------------------------------------------------------------------- #
def _op_reshape(in_shape, shape):
    return {"op": "reshape", "in_shape": [int(d) for d in in_shape],
            "shape": [int(d) for d in shape]}


def _op_slice(in_shape, shape):
    return {"op": "slice", "in_shape": [int(d) for d in in_shape],
            "shape": [int(d) for d in shape]}


def _op_index0(in_shape, indices):
    return {"op": "index0", "in_shape": [int(d) for d in in_shape],
            "indices": [int(i) for i in indices]}


def _op_flat_slice(in_shape, size):
    return {"op": "flat_slice", "in_shape": [int(d) for d in in_shape],
            "size": int(size)}


def split_record(axis, dim: int) -> Optional[dict]:
    """The ``split`` of a leaf whose global form is the parts of
    ``axis``'s ranks along ``dim`` (``None`` on a one-rank axis)."""
    if axis.size == 1:
        return None
    return {"axis": axis.name, "dim": int(dim), "ranks": int(axis.size)}


def leaf_record(shape, dtype, ops=(), split=None) -> dict:
    """One manifest leaf: the global stored shape and dtype, the stored
    to logical ops, and the ranks' ``split``; ``logical_shape`` comes
    from replaying the ops on shapes."""
    shape = [int(d) for d in shape]
    logical = list(shape)
    for op in ops:
        if op["op"] in ("reshape", "slice"):
            logical = list(op["shape"])
        elif op["op"] == "index0":
            logical = [len(op["indices"])] + logical[1:]
        elif op["op"] == "flat_slice":
            logical = [op["size"]]
    return {"stored_shape": shape, "logical_shape": logical,
            "dtype": common.dtype_name(dtype), "ops": list(ops),
            "split": split}


def flat_ops(global_shape, logical) -> list:
    """The recipe of a flat (ZeRO) shard's global form: cut the padding,
    then reshape to the logical shape (none where they agree)."""
    logical = tuple(logical)
    if tuple(global_shape) == logical:
        return []
    size = math.prod(logical) if logical else 1
    return [_op_flat_slice(global_shape, size), _op_reshape((size,), logical)]


@dataclasses.dataclass
class Lowered:
    """The lowered step and the state layout.  ``full_params_fn`` maps
    the stored ``{name: tensor}`` params to the full logical ones (a
    collective where variables are sharded; the identity otherwise);
    ``batch_axis`` is the :class:`~autodist_tpu_torch.parallel.axis
    .Axis` whose ranks each take a shard of the batch (``None``: the
    replica group, ``dcn x data``); ``placement`` (``batch -> {leaf
    name: ((dim, Axis), ...)}``), where given, replaces that single
    batch axis per leaf (:meth:`placement_of`).

    ``eval_fn`` (``(state, batch, rng) -> metrics``) runs the
    trainable's ``eval_loss`` on the full parameters without an update
    and reduces the metrics across replicas; ``release``, where given,
    frees what the lowering holds beyond its state (the ``gspmd``
    lowering's one-rank process group), called by the runner's
    ``close()``.

    ``state_manifest_fn`` (``state -> manifest``) is the lowering's
    state codec (:meth:`state_manifest`); ``sync_init`` each stateful
    compressor's first state row (host numpy), what a reshard re-seeds
    rows from.  A manifest's ``split`` names an axis of the lowering's
    mesh, or a joint one (``data+seq``), which the mesh keeps.

    The records of what the lowering did with the strategy's requests:
    ``zero3_shapes`` the logical shape of each variable stored as a
    flat ZeRO-3 shard (``full_params_fn`` returns it at that shape);
    ``zero_degraded`` each ZeRO request that degraded to plain sync,
    with its reason (JAX ``zero_degraded``); ``unapplied`` each
    precision slot or compressor the lowering has no boundary for or
    leaves unapplied, with its reason, where the JAX package drops it
    (its expert lowering's ``grad`` slot, a compressor on a pipeline
    without a data axis).  ``ssp_staleness`` is the strategy's largest
    PS ``staleness``, the bound of the runner's host-side SSP gate (0:
    no gate), stamped by
    :meth:`~autodist_tpu_torch.autodist.AutoDist.lower` on every
    lowering."""

    plan: Any
    mesh: Any
    device: torch.device
    init_fn: Callable     # (params, extra) -> state
    step_fn: Callable     # (state, batch, rng) -> (state, metrics)
    full_params_fn: Optional[Callable] = None
    eval_fn: Optional[Callable] = None
    batch_axis: Any = None
    placement: Optional[Callable] = None
    zero3_shapes: dict = dataclasses.field(default_factory=dict)
    zero_degraded: dict = dataclasses.field(default_factory=dict)
    unapplied: dict = dataclasses.field(default_factory=dict)
    release: Optional[Callable] = None
    ssp_staleness: int = 0
    state_manifest_fn: Optional[Callable] = None
    sync_init: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.batch_axis is None:
            self.batch_axis = self.mesh.replica_axis()

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

    def init_state(self, trainable=None, *, params=None, extra=None):
        """The state for ``trainable``'s parameters and extra state, or
        for a logical ``params`` tree and ``extra`` (a portable
        checkpoint's), laid out for this lowering."""
        if trainable is not None:
            params, extra = trainable.params, trainable.extra
        return self.init_fn(params, extra)

    def full_params(self, params: dict) -> dict:
        return self.full_params_fn(params) if self.full_params_fn \
            else params

    def state_manifest(self, state) -> dict:
        """The elastic state-codec manifest of ``state`` (the codec
        comment above): ``{"family", "leaves": {name: record}, "sync":
        {name: {"rows", "width", "compressor"}}}``; only shapes and
        dtypes are read."""
        if self.state_manifest_fn is None:
            raise ValueError("this lowering records no state manifest")
        return self.state_manifest_fn(state)


def lower(trainable, strategy, mesh, device=None) -> Lowered:
    """Build the train step for (trainable, strategy, mesh) on ``device``
    (``None``: the card): the data-parallel step here, the pipeline
    lowering for a ``Pipeline`` strategy, the expert lowering for an
    ``ExpertParallel`` one, the sequence lowering for a
    ``SequenceParallel`` one, the DTensor lowering
    (:mod:`~autodist_tpu_torch.kernel.gspmd`) for a ``gspmd`` one."""
    if strategy.graph_config.lowering == "pipeline":
        from autodist_tpu_torch.parallel.pipeline import lower_pipeline

        return lower_pipeline(trainable, strategy, mesh, device)
    if strategy.graph_config.lowering == "expert":
        from autodist_tpu_torch.parallel.moe import lower_expert_ir

        return lower_expert_ir(trainable, strategy, mesh, device)
    if strategy.graph_config.lowering == "sequence":
        from autodist_tpu_torch.parallel.sequence import lower_sequence_ir

        return lower_sequence_ir(trainable, strategy, mesh, device)
    if strategy.graph_config.lowering == "gspmd":
        from autodist_tpu_torch.kernel.gspmd import lower_gspmd

        return lower_gspmd(trainable, strategy, mesh, device)
    from autodist_tpu_torch.ops.sparse import ShardedEmbedding

    plan = make_plan(trainable, strategy, mesh)
    n, dev, opt = plan.num_replicas, resolve_device(device), trainable.optimizer
    axis = mesh.replica_axis()
    named = {a: mesh.axis(a) for a in plan.repl_axes}
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
        # The loss runs with the replica axes bound, forward and
        # backward, as the JAX program runs it inside shard_map over
        # them: a model may name one (cross-replica BatchNorm).
        with torch.enable_grad(), axis_scope(named):
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
        local_rng = cuda_graph.fold_seed(rng, n, axis.index)

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
        return new_state, reduce_metrics(metrics, mesh, axis)

    def eval_fn(state, batch, rng):
        with torch.no_grad():
            _, _, metrics = trainable.eval_loss(
                common.unflatten(full(state["params"], False)),
                state["extra"], batch,
                cuda_graph.fold_seed(rng, n, axis.index))
        return reduce_metrics(metrics, mesh, axis)

    def state_manifest(state):
        """The collective family's manifest (JAX ``Lowered
        .state_manifest``): a stored-sharded parameter is the padded
        slice of the replica group, a U_FLAT variable's optimizer state its
        flat chunk, a U_AXIS one's its padded slice, a compressor's
        state one row a rank."""
        leaves, sync = {}, {}
        for name, leaf in common.state_leaves(state):
            shape, ops, split = tuple(leaf.shape), [], None
            if name.startswith("params/") and name[7:] in vps:
                vp = vps[name[7:]]
                if vp.stored_sharded:
                    shape = vp.update_shape(n)
                    if shape != vp.shape:
                        ops = [_op_slice(shape, vp.shape)]
                    split = split_record(axis, vp.split_axis)
            elif name.startswith("opt_state/"):
                local = shape
                var = common.match_var_by_suffix(
                    name, vps, shape_ok=lambda v: local
                    == vps[v].local_update_shape(n))
                vp = vps.get(var)
                if vp is not None and vp.update == U_FLAT:
                    shape = vp.update_shape(n)
                    ops = flat_ops(shape, vp.shape)
                    split = split_record(axis, 0)
                elif vp is not None and vp.update == U_AXIS:
                    shape = vp.update_shape(n)
                    if shape != vp.shape:
                        ops = [_op_slice(shape, vp.shape)]
                    split = split_record(axis, vp.split_axis)
            elif name.startswith("sync_state/"):
                key = name[len("sync_state/"):]
                shape = (n, int(leaf.numel()))
                split = {"axis": axis.name, "dim": 0, "ranks": n}
                sync[name] = {"rows": n, "width": int(leaf.numel()),
                              "compressor": plan.bucket_compressor.get(
                                  key, "none")}
            leaves[name] = leaf_record(shape, leaf.dtype, ops, split)
        return {"family": "collective", "leaves": leaves, "sync": sync}

    # The JAX package's collective lowering reads no precision policy
    # (its compressors are AllReduce(compressor=...)): the slots train
    # the fp32 program and are recorded as unapplied.
    unapplied = {slot: "the collective lowering has no precision boundary"
                 for slot in normalize_precision(
                     strategy.graph_config.precision)}
    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn,
                   full_params_fn=lambda stored: full(stored, False),
                   eval_fn=eval_fn, unapplied=unapplied,
                   state_manifest_fn=state_manifest, sync_init=sync_init)
