"""Strategy lowering: Strategy IR -> one data-parallel train step.

Counterpart of ``autodist_tpu/kernel/lowering.py`` for its
``collective`` lowering at the replicated update space — what an
``AllReduce`` strategy lowers to.  Where the JAX package traces one
``shard_map`` program, the port runs the same step eagerly in each
process of the job:

1. the loss and its gradients on this replica's shard of the batch,
   with the dropout seed folded with the replica index;
2. the AllReduce synchronizer, bucket by bucket (``g{group}:{compressor}``,
   as :func:`make_plan` groups variables): the gradients of a bucket are
   flattened into one fp32 vector, summed over the replicas with one
   ``torch.distributed.all_reduce`` and divided by their number (JAX's
   ``pmean``), and split back.  With one replica the all-reduce is the
   identity and is skipped, flatten and all (the JAX package's ``n ==
   1`` bypass);
3. the optimizer update on every replica alike;
4. metrics averaged across replicas (floats; integer counts summed,
   flags OR-ed).

The step updates nothing in place: it returns a new state.  Other
update spaces (``U_FLAT``, ``U_AXIS``), compressors, gradient
accumulation and the lowerings other than ``pipeline``, ``expert`` and
``sequence`` (:mod:`autodist_tpu_torch.parallel.pipeline`,
:mod:`autodist_tpu_torch.parallel.moe` and
:mod:`autodist_tpu_torch.parallel.sequence`, to which :func:`lower`
hands a ``Pipeline``, an ``ExpertParallel`` and a ``SequenceParallel``
strategy) raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch import const, cuda_graph, optim
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer

@dataclasses.dataclass
class VarPlan:
    """Resolved per-variable lowering decision: every variable is
    replicated and its gradient joins one all-reduce bucket."""

    name: str
    shape: tuple
    dtype: Any
    bucket: str                   # all-reduce bucket key


@dataclasses.dataclass
class Plan:
    """The compiled strategy: per-variable plans and the buckets."""

    var_plans: dict
    num_replicas: int
    buckets: dict                 # bucket key -> ordered variable names


def make_plan(trainable, strategy, mesh) -> Plan:
    """Resolve a Strategy against a mesh."""
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
            "a collective precision policy on the data-parallel gradient "
            "sync (its compressors) is not ported yet (ROADMAP Queue 1, "
            "slice 2 leftovers, item 3)")
    if gc.accum_steps != 1:
        raise NotImplementedError(
            "gradient accumulation is not ported yet (ROADMAP Queue 1, "
            "item 8: GradAccumulation)")
    node_index = {nc.var_name: nc for nc in strategy.node_configs}
    var_plans, buckets = {}, {}
    for info in trainable.var_infos():
        node = node_index.get(info.name)
        if node is not None and node.partitioner is not None:
            raise NotImplementedError(
                f"{info.name}: a partitioned variable in the collective "
                f"lowering (PartitionedAR, PartitionedPS, Parallax) is not "
                f"ported yet (ROADMAP Queue 1, item 8)")
        sync = node.synchronizer if node else AllReduceSynchronizer()
        if sync.compressor not in ("", "none"):
            raise NotImplementedError(
                f"{info.name}: gradient compressor {sync.compressor!r} is "
                f"not ported yet (ROADMAP Queue 1, slice 2 leftovers: "
                f"compressors)")
        key = f"g{sync.group}:{sync.compressor}"
        var_plans[info.name] = VarPlan(info.name, info.shape, info.dtype,
                                       bucket=key)
        buckets.setdefault(key, []).append(info.name)
    return Plan(var_plans=var_plans, num_replicas=n, buckets=buckets)


def reduce_metrics(metrics: dict, mesh, axis=None) -> dict:
    """Scalar float metrics averaged across replicas (``axis``, by
    default the data axis), in one all-reduce.  (The JAX package also
    sums integer counts and ORs flags; no ported loss returns those, so
    they are refused.)"""
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    for k, v in metrics.items():
        if not v.is_floating_point():
            raise TypeError(f"metric {k!r} is {v.dtype}: only float "
                            f"metrics are reduced across replicas")
    axis = mesh.axis(const.DATA_AXIS) if axis is None else axis
    if axis.size == 1 or not metrics:
        return metrics
    stacked = axis.pmean(torch.stack([v.float() for v in metrics.values()]))
    return {k: stacked[i].to(v.dtype)
            for i, (k, v) in enumerate(metrics.items())}


@dataclasses.dataclass
class Lowered:
    """The lowered step and the state layout.  ``full_params_fn`` maps
    the stored ``{name: tensor}`` params to the full logical ones (a
    collective where variables are sharded; the identity otherwise);
    ``batch_axis`` is the :class:`~autodist_tpu_torch.parallel.axis
    .Axis` whose ranks each take a shard of the batch (``None``: the
    data axis); ``placement`` (``batch -> {leaf name: ((dim, Axis),
    ...)}``), where given, replaces that single batch axis per leaf
    (:meth:`placement_of`)."""

    plan: Any
    mesh: Any
    device: torch.device
    init_fn: Callable     # (params, extra) -> state
    step_fn: Callable     # (state, batch, rng) -> (state, metrics)
    full_params_fn: Optional[Callable] = None
    batch_axis: Any = None
    placement: Optional[Callable] = None

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
    plan = make_plan(trainable, strategy, mesh)
    n, dev, opt = plan.num_replicas, resolve_device(device), trainable.optimizer
    names = list(plan.var_plans)

    def init_fn(params, extra):
        flat = dict(common.flatten_with_names(params))
        stored = {nm: flat[nm].detach().to(dev).clone() for nm in names}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt.init(stored),
                "extra": extra}

    def all_reduce_buckets(grads: dict) -> dict:
        if n == 1:
            return grads
        synced = {}
        for bucket in plan.buckets.values():
            flat = torch.cat([grads[nm].reshape(-1).float() for nm in bucket])
            dist.all_reduce(flat, group=mesh.group)
            flat = flat / n
            offset = 0
            for nm in bucket:
                vp = plan.var_plans[nm]
                size = math.prod(vp.shape)
                synced[nm] = flat[offset:offset + size].view(vp.shape).to(
                    grads[nm].dtype)
                offset += size
        return synced

    def step_fn(state, batch, rng):
        params = state["params"]
        leaves = {nm: p.detach().requires_grad_(True)
                  for nm, p in params.items()}
        local_rng = cuda_graph.fold_seed(rng, n, mesh.replica)
        with torch.enable_grad():
            loss, new_extra, metrics = trainable.loss(
                common.unflatten(leaves), state["extra"], batch, local_rng)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {nm: torch.zeros_like(params[nm]) if g is None else g
                 for nm, g in zip(names, grads)}
        updates, opt_state = opt.update(all_reduce_buckets(grads),
                                        state["opt_state"], params)
        new_state = {"step": state["step"] + 1,
                     "params": optim.apply_updates(params, updates),
                     "opt_state": opt_state, "extra": new_extra}
        return new_state, reduce_metrics(metrics, mesh)

    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn)
