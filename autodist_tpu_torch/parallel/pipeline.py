"""The ``pipeline`` lowering: GPipe and interleaved schedules over the
pipe axis, one process per pipe coordinate, with tensor parallelism
inside the stages.

Counterpart of ``lower_pipeline_ir``, ``_build_pipeline`` and
``pipeline_apply`` of ``autodist_tpu/parallel/pipeline.py``.  Every
process of the job runs the step on its (data, pipe, model) coordinate:

1. storage: pipe rank ``d`` of ``n`` keeps its ``V`` chunks (logical
   chunk ``v·n + d`` at row ``v``, the interleaved storage order of
   :func:`chunk_permutation`), cut to its model shard by the strategy's
   partitioner specs (:func:`autodist_tpu_torch.interop.shard_params`);
   shared variables are replicated on every rank, except under
   ``vocab_parallel``, where the tied table is stored as its ``[V_pad /
   tp, H]`` model shard, the vocabulary zero-padded to divide.  A ZeRO-3
   stage variable is stored as ``[V, padded_chunk / n_data]`` rows, each
   chunk's flat shard over the data axis, and a ZeRO-3 shared one as its
   flat shard over pipe x data;
2. the ZeRO-3 gathers: once a step (once an accumulation slice), before
   the ticks, shared leaves first and then the chunks in layer order,
   every rank in the same order (a gather a tick would run ``M`` times,
   and the bubble ticks would part the data peers' orders); their
   backward reduce-scatters run after the ticks, in the same order;
3. the schedule: every pipe rank walks the same ``num_ticks(M, n, V)``
   ticks.  Each tick it shifts its last output one step along the pipe
   ring (:meth:`~autodist_tpu_torch.parallel.axis.Axis.ppermute`; a
   rank with nothing to send sends zeros, so every send meets its
   receive) and runs its stage only where :func:`_tick_assignment`
   makes the tick valid: bubble ticks run nothing, so the model-axis
   collectives and the K3/K4 launches inside the stages do not grow
   with the bubble.  Global chunk 0 takes microbatch ``m`` of the
   prologue's output (run on the data shard, whose rows split into
   ``num_microbatches`` contiguous microbatches) instead of what
   arrived.  Only pipe rank 0 runs the prologue; the others take its
   output's shape and dtype from a run on meta tensors (no compute, no
   collective).  Activations are ``[B/M, L, H]``, and the stage function
   gets ``model_axis`` (and ``comm_overlap``) under ``tensor_parallel
   > 1``; under ``remat`` each stage call is a non-reentrant
   ``torch.utils.checkpoint``, recomputed (its model-axis rings
   included) in the backward;
4. the loss head runs once, on the last pipe rank, on the last chunk's
   ``M`` outputs, and back-propagates to one output gradient a
   microbatch.  Under ``vocab_parallel`` the prologue and the head get
   ``model_axis`` (and ``comm_overlap``): the masked shard lookup and
   the streaming cross-entropy of :mod:`autodist_tpu_torch.parallel
   .tensor`;
5. the backward walks the ticks in reverse with the same shape: a
   gradient shift the other way every tick, and on a valid tick one
   ``torch.autograd.grad`` of that tick's output against the cotangent
   that arrived (the last chunk's from the head), whose input gradient
   is sent back.  The ring itself carries no autograd edge: a rank
   whose received carry went unused would never run that edge's
   backward, and its neighbour's matching exchange would never happen;
6. forward and backward (remat's recompute too) run inside
   ``precision_scope`` and ``kernel_scope`` with the strategy's policy
   and election, as the JAX package opens them around its step;
   ``GradAccumulation`` runs the whole schedule once a slice;
7. the gradient sync, by each variable's policy
   (:func:`pipeline_policies`): shared gradients (the prologue's on
   pipe rank 0, the head's on rank ``n - 1``) are summed over the pipe
   axis, except a ZeRO one, whose one reduce-scatter over pipe x data
   sums and shards at once; a ZeRO stage gradient is reduce-scattered
   over data (a ZeRO-3 one is only divided: its gather's backward
   scattered it); a compressed one runs its compressor over data with
   its state row; the rest are averaged over data in one flat fp32
   all-reduce.  The functional optimizer updates each update-space
   shard, and ZeRO-1 and 2 all-gather the updated values.  A vocab
   shard's gradient is summed within its model coordinate and never
   over model: each model rank owns its rows.  The head's metrics are
   broadcast from the last pipe rank, then averaged over data.

At one pipe device the same schedule runs every (microbatch, chunk) in
order, what ``pipeline_apply`` computes there.  The strategy is checked
as ``lower_pipeline_ir`` checks it, with the same errors; what the port
does not run raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const, interop
from autodist_tpu_torch.capture import PipelineTrainable
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.kernel.compressor import Compressor
from autodist_tpu_torch.kernel.lowering import Lowered, reduce_metrics
from autodist_tpu_torch.parallel.tensor import (kernel_scope,
                                                normalize_comm_overlap,
                                                precision_scope)
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer,
                                            normalize_kernel,
                                            normalize_precision, not_ported)

_LEFTOVERS = "ROADMAP Queue 1, slice 3 leftovers"


# --------------------------------------------------------------------------- #
# The schedule (host math)
# --------------------------------------------------------------------------- #
def start_tick(m: int, c: int, *, num_devices: int, virtual_stages: int):
    """Tick at which chunk ``c`` of microbatch ``m`` runs."""
    n, V = num_devices, virtual_stages
    return n * V * (m // n) + m % n + c


def num_ticks(num_microbatches: int, num_devices: int,
              virtual_stages: int) -> int:
    """Total schedule ticks = start of the last (microbatch, chunk) + 1."""
    n, V, M = num_devices, virtual_stages, num_microbatches
    return start_tick(M - 1, n * V - 1, num_devices=n,
                      virtual_stages=V) + 1


def bubble_fraction(num_microbatches: int, num_devices: int,
                    virtual_stages: int) -> float:
    """Idle fraction of the schedule: (ticks - useful) / ticks, where a
    device's useful ticks are its M·V chunk computations."""
    T = num_ticks(num_microbatches, num_devices, virtual_stages)
    useful = num_microbatches * virtual_stages
    return (T - useful) / T


def _tick_assignment(t: int, device: int, *, n: int, V: int, M: int):
    """``(valid, m, v)`` processed by ``device`` at tick ``t``.

    Inverts ``start(m, c)``: with ``c = v·n + device``,
    ``t - device = (m mod n) + n·(v + V·⌊m/n⌋)``.
    """
    rel = max(t - device, 0)
    r, v, q = rel % n, (rel // n) % V, rel // (n * V)
    m = q * n + r
    return t >= device and m < M, min(m, M - 1), v


def chunk_permutation(n: int, V: int) -> np.ndarray:
    """``perm`` with storage row ``d·V + v`` = logical chunk ``v·n + d``:
    ``logical[perm]`` is the storage order whose rows ``d·V`` to
    ``d·V + V - 1`` are pipe rank ``d``'s V chunks."""
    return np.array([(r % V) * n + r // V for r in range(n * V)])


def chunk_permutation_inv(n: int, V: int) -> np.ndarray:
    """Inverse: ``storage[perm_inv]`` restores logical chunk order."""
    return np.array([(c % n) * V + c // n for c in range(n * V)])


@dataclasses.dataclass
class PipelinePlan:
    """The resolved pipeline strategy."""

    num_microbatches: int
    num_stages: int
    virtual_stages: int
    tensor_parallel: int
    model_dims: dict           # stage variable -> dim sharded over model
    vocab_dims: dict           # shared variable -> 0, its vocab sharded
    comm_overlap: object       # None or "matmul"
    precision: dict
    kernel: dict
    remat: bool = False        # each stage call recomputed in the backward
    accum: int = 1             # whole schedules a step (GradAccumulation)


def _accepts(fn, name: str) -> bool:
    """Whether ``fn`` takes keyword ``name`` (a callable whose signature
    cannot be read is trusted)."""
    try:
        return name in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return True


def _on_meta(tree):
    """A tree of tensors as meta tensors of the same shapes and dtypes."""
    if tree is None:
        return None
    return unflatten({nm: torch.empty_like(t, device="meta")
                      for nm, t in flatten_with_names(tree)})


def _one(values: set, what: str):
    """The one value a set of per-variable records agrees on, or None."""
    if len(values) > 1:
        raise ValueError(
            f"per-variable {what} disagree ({sorted(values)}); the stage "
            f"body lowers with one — set it on the graph config")
    return values.pop() if values else None


def make_pipeline_plan(trainable, strategy, mesh) -> PipelinePlan:
    """Resolve a ``Pipeline`` strategy against the mesh, with the JAX
    lowering's checks."""
    if not isinstance(trainable, PipelineTrainable):
        raise TypeError(
            "the pipeline strategy lowers stage-structured trainables; "
            "declare one with PipelineTrainable(stage_fn, stacked_params, "
            "loss_head, optimizer, num_stages=S)")
    cfg = strategy.graph_config
    par = cfg.parallel
    V = max(int(par.get("virtual_stages", 1)), 1)
    S = mesh.shape.get(const.PIPE_AXIS)
    if S is None or S * V != trainable.num_stages:
        raise ValueError(
            f"trainable declares {trainable.num_stages} stages; mesh pipe "
            f"axis has {S} devices x {V} virtual stages")
    tp_cfg = max(int(par.get("tensor_parallel", 1)), 1)
    tp_mesh = mesh.shape.get(const.MODEL_AXIS, 1)
    if tp_cfg > 1 and tp_mesh != tp_cfg:
        raise ValueError(
            f"strategy declares tensor_parallel={tp_cfg}; mesh "
            f"{const.MODEL_AXIS!r} axis has {tp_mesh} devices")

    def is_stage(name):
        return not trainable.has_shared or name.startswith("stages/")

    dims = interop.model_dims(strategy)
    stage_dims = {nm: d for nm, d in dims.items() if is_stage(nm)}
    vocab_dims = {nm: d for nm, d in dims.items() if not is_stage(nm)}
    for nm, d in vocab_dims.items():
        if d != 0:
            raise ValueError(
                f"{nm}: a shared variable shards over the model axis on "
                f"its vocabulary (dim 0) only; its spec shards dim {d}")
    if vocab_dims:
        for role in ("prologue", "loss_head"):
            if not _accepts(getattr(trainable, role), "model_axis"):
                raise ValueError(
                    f"vocab parallelism needs a vocab-parallel-aware "
                    f"{role}: it must accept model_axis= and use the "
                    "autodist_tpu_torch.parallel.tensor vocab primitives")
    if dims and tp_mesh == 1:
        raise ValueError(
            "strategy shards variables over the model axis but the mesh "
            f"has none: {dict(mesh.shape)}")
    parts = [nc.partitioner for nc in strategy.node_configs
             if nc.partitioner is not None]
    overlap = normalize_comm_overlap(par.get("comm_overlap")) or _one(
        {p.comm_overlap for p in parts if p.comm_overlap}, "comm_overlap")
    precision = dict(normalize_precision(cfg.precision))
    for slot, stage_vars in (("tp_psum", True), ("vocab_stats", False)):
        if slot in precision:
            continue
        # A hand-edited strategy may carry the slot only per variable:
        # stage variables the tp_psum slot, the vocab table vocab_stats.
        prec = _one({nc.partitioner.precision
                     for nc in strategy.node_configs
                     if nc.partitioner is not None
                     and is_stage(nc.var_name) == stage_vars
                     and nc.partitioner.precision not in (None, "fp32")},
                    f"{slot} precisions")
        if prec:
            precision[slot] = prec
    precision = normalize_precision(precision)
    kernel = normalize_kernel(cfg.kernel)
    if "quant_ring" in kernel:
        if precision.get("tp_psum") != "int8":
            raise ValueError(
                "kernel 'quant_ring' fuses q/dq into the int8 tp_psum "
                "ring; set collective_precision's tp_psum slot to "
                "'int8' (or drop the kernel election)")
        if overlap is not None:
            raise ValueError(
                "kernel 'quant_ring' replaces the monolithic tp_psum; "
                f"comm_overlap={overlap!r} routes the boundary through "
                "the decomposed rs+ag/matmul forms instead — pick one")
    if "collective_matmul" in kernel and overlap != "matmul":
        raise ValueError(
            "kernel 'collective_matmul' fuses the chunked ppermute "
            "ring; it requires comm_overlap='matmul' "
            f"(got {overlap!r})")
    # What this slice does not run.
    if overlap == "rsag":
        not_ported("comm_overlap='rsag'", f"{_LEFTOVERS}, item 3")
    if overlap and precision.get("tp_psum"):
        not_ported("a narrowed tp_psum precision under comm_overlap",
                   f"{_LEFTOVERS}, item 3")
    if overlap and vocab_dims and precision.get("vocab_stats"):
        not_ported("a narrowed vocab_stats precision under comm_overlap",
                   f"{_LEFTOVERS}, item 3")
    return PipelinePlan(
        num_microbatches=int(par.get("num_microbatches", 1)),
        num_stages=trainable.num_stages, virtual_stages=V,
        tensor_parallel=tp_mesh if stage_dims else 1, model_dims=stage_dims,
        vocab_dims=vocab_dims,
        comm_overlap=overlap, precision=precision,
        kernel={k: True for k in kernel
                if k in ("quant_ring", "collective_matmul")},
        remat=bool(par.get("remat", False)),
        accum=max(int(cfg.accum_steps), 1))


def pipeline_policies(trainable, strategy, mesh, plan: PipelinePlan):
    """The per-variable synchronizers of a pipeline strategy, as the JAX
    ``lower_pipeline_ir`` resolves them: ``(policies, zero_degraded,
    unapplied)``.

    A stage variable is replicated only across the data axis (it is
    pipe-sharded), a shared one across pipe x data: a PS synchronizer is
    ZeRO over those axes; on a model-sharded stage variable it degrades
    to plain sync (its optimizer state shards with it), recorded in
    ``zero_degraded``, as is a ZeRO-3 request on the vocab-sharded table
    (which shards its optimizer state over pipe x data within its model
    coordinate instead).  The ``grad`` slot elects its error-feedback
    compressor for every AllReduce variable without one.  A mesh
    without a data axis runs no compressor (the JAX lowering logs it);
    each such variable is recorded in ``unapplied``."""
    from autodist_tpu_torch.parallel._spmd import (GRAD_SLOT_COMPRESSORS,
                                                   VarPolicy,
                                                   policies_from_node_configs)

    d_axes = (const.DATA_AXIS,) if const.DATA_AXIS in mesh.shape else ()
    shared_axes = (const.PIPE_AXIS, *d_axes)

    def is_stage(name):
        return not trainable.has_shared or name.startswith("stages/")

    degraded: dict = {}
    policies = policies_from_node_configs(
        strategy, mesh, replicated_axes=shared_axes,
        axes_for=lambda nm: d_axes if is_stage(nm) else shared_axes,
        sharded_vars=set(plan.model_dims), degraded=degraded)
    for name in plan.vocab_dims:
        pol = policies.get(name)
        if pol is not None and pol.zero_axes and pol.zero_stage >= 3:
            degraded[name] = (
                "zero_stage=3 on the model-sharded table degrades to "
                "optimizer-state sharding: the parameter is already "
                "1/tp-sharded over the model axis; state shards over "
                "(model, pipe, data)")
    grad = plan.precision.get("grad")
    if grad:
        for nc in strategy.node_configs:
            sync = nc.synchronizer
            if (isinstance(sync, AllReduceSynchronizer)
                    and (sync.compressor or "none") == "none"
                    and nc.var_name not in policies):
                policies[nc.var_name] = VarPolicy(
                    compressor=GRAD_SLOT_COMPRESSORS[grad])
    unapplied = {}
    if not d_axes:
        unapplied = {nm: f"compressor {pol.compressor!r}: the mesh has no "
                         "data axis to compress over; synced uncompressed"
                     for nm, pol in sorted(policies.items())
                     if pol.compressor != "none"}
    return policies, degraded, unapplied


def lower_pipeline(trainable, strategy, mesh, device=None) -> Lowered:
    """The train step of a ``Pipeline`` strategy on ``device`` (``None``:
    the card)."""
    from autodist_tpu_torch.parallel._spmd import UpdateSpace, axis_over

    plan = make_pipeline_plan(trainable, strategy, mesh)
    policies, zero_degraded, unapplied = pipeline_policies(
        trainable, strategy, mesh, plan)
    dev, opt = resolve_device(device), trainable.optimizer
    M, V = plan.num_microbatches, plan.virtual_stages
    data = mesh.axis(const.DATA_AXIS)
    pipe = mesh.axis(const.PIPE_AXIS)
    model = mesh.axis(const.MODEL_AXIS)
    has_data = const.DATA_AXIS in mesh.shape
    n, d, n_d = pipe.size, pipe.index, data.size
    T = num_ticks(M, n, V)
    first, last = d == 0, d == n - 1
    has_shared = trainable.has_shared
    tp_kwargs, vp_kwargs = {}, {}
    if plan.tensor_parallel > 1:
        tp_kwargs["model_axis"] = model
        if plan.comm_overlap:
            tp_kwargs["comm_overlap"] = plan.comm_overlap
    if plan.vocab_dims:
        vp_kwargs["model_axis"] = model
        if plan.comm_overlap:
            vp_kwargs["comm_overlap"] = plan.comm_overlap
    logical = {nm: tuple(t.shape)
               for nm, t in flatten_with_names(trainable.params)}
    zero3_precision = plan.precision.get("zero3_gather", "fp32")

    def is_stage(name):
        return not has_shared or name.startswith("stages/")

    # ZeRO's axes: a stage variable's the data axis, a shared one's
    # pipe x data (one group a model coordinate), made in name order.
    groups: dict = {}
    zaxes = {nm: axis_over(mesh, pol.zero_axes, groups)
             for nm, pol in sorted(policies.items()) if pol.zero_axes}
    comps = {nm: Compressor.create(pol.compressor)
             for nm, pol in sorted(policies.items())
             if pol.compressor != "none" and has_data}
    # Stored as the ZeRO shard and gathered once a step: never a
    # model-sharded variable, whose request degrades.
    space = UpdateSpace(zaxes, frozenset(
        nm for nm in zaxes if policies[nm].zero_stage >= 3
        and nm not in plan.model_dims and nm not in plan.vocab_dims), comps)

    zero3_shapes = {nm: logical[nm] for nm in logical if nm in space.zero3}

    def stage_fn(chunk, x):
        if not plan.remat:
            return trainable.stage_fn(chunk, x, **tp_kwargs)
        # The recompute runs inside the backward's precision and kernel
        # scopes, and the pipelined trainables draw no randomness.
        return torch.utils.checkpoint.checkpoint(
            trainable.stage_fn, chunk, x, use_reentrant=False,
            preserve_rng_state=False, **tp_kwargs)

    def store(nm, t):
        """A ZeRO-3 variable's storage: a stage leaf's ``V`` chunks as
        ``[V, padded_chunk / n_d]`` rows, each chunk's flat data shard;
        a shared leaf's flat shard over pipe x data."""
        if nm not in space.zero3:
            return t
        if is_stage(nm):
            return torch.stack([common.local_flat_shard(t[v], zaxes[nm])
                                for v in range(V)])
        return common.local_flat_shard(t, zaxes[nm])

    def init_fn(params, extra):
        flat = dict(flatten_with_names(params))
        mine = torch.as_tensor(chunk_permutation(n, V)[d * V:(d + 1) * V])
        local = interop.shard_params(unflatten({
            nm: t.index_select(0, mine.to(t.device)) if is_stage(nm) else t
            for nm, t in flat.items()}),
            {**plan.model_dims, **plan.vocab_dims}, model.index, model.size,
            padded=plan.vocab_dims)
        stored = {nm: store(nm, t).detach().to(dev).clone()
                  for nm, t in flatten_with_names(local)}
        # The vocab table's update space is its flat shard within its
        # model coordinate.
        opt_state, rows = space.init(opt, stored, dev)
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt_state,
                "extra": extra, "sync_state": rows}

    def tree(leaves: dict, part: str):
        return unflatten(leaves)[part] if has_shared else unflatten(leaves)

    def first_input(shared, batch):
        """The prologue's output (or the batch key), split into the M
        microbatches.  Pipe rank 0 computes it; the other ranks need
        only its shape and dtype, from the prologue on meta tensors."""
        if trainable.prologue is None:
            x = batch[trainable.batch_key]
        elif first:
            x = trainable.prologue(shared, batch, **vp_kwargs)
        else:
            meta = trainable.prologue(_on_meta(shared), _on_meta(batch))
            x = torch.zeros(meta.shape, dtype=meta.dtype, device=dev)
        if not x.is_floating_point():
            raise TypeError(f"the pipeline's activations must be floating "
                            f"point; chunk 0 gets {x.dtype}")
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        return x, x.detach().split(B // M)

    def forward_ticks(chunks, mbs):
        """The forward schedule; each valid tick's (input leaf, output),
        by tick, and the last chunk's outputs, by microbatch."""
        zeros = torch.zeros_like(mbs[0])
        carry, saved, outs = zeros, {}, {}
        for t in range(T):
            recv = pipe.ppermute(carry, 1)
            valid, m, v = _tick_assignment(t, d, n=n, V=V, M=M)
            if not valid:
                carry = zeros
                continue
            src = mbs[m] if first and v == 0 else recv
            x = src.detach().requires_grad_()
            out = stage_fn(chunks[v], x)
            if out.shape != x.shape or out.dtype != x.dtype:
                raise ValueError(
                    f"stage activations must match the microbatch's shape "
                    f"and dtype (chunk 0 consumes the batch): got "
                    f"{tuple(out.shape)} {out.dtype} from "
                    f"{tuple(x.shape)} {x.dtype}")
            saved[t] = (x, out)
            carry = out.detach()
            if last and v == V - 1:
                outs[m] = carry
        return saved, outs

    def backward_ticks(saved, head_grads, chunk_leaves, zeros):
        """The reverse schedule; the stage leaves' gradients by chunk,
        and chunk 0's input gradients by microbatch."""
        grads = [dict.fromkeys(leaves) for leaves in chunk_leaves]
        g_first = [None] * M
        carry = zeros
        for t in reversed(range(T)):
            recv = pipe.ppermute(carry, -1)
            valid, m, v = _tick_assignment(t, d, n=n, V=V, M=M)
            if not valid:
                carry = zeros
                continue
            x, out = saved.pop(t)
            cot = head_grads[m] if last and v == V - 1 else recv
            leaves = chunk_leaves[v]
            gs = torch.autograd.grad(out, [x, *leaves.values()], cot,
                                     allow_unused=True)
            for nm, g in zip(leaves, gs[1:]):
                if g is not None:
                    acc = grads[v][nm]
                    grads[v][nm] = g if acc is None else acc + g
            g_x = zeros if gs[0] is None else gs[0]
            if first and v == 0:
                g_first[m], carry = g_x, zeros
            else:
                carry = g_x
        return grads, g_first

    metric_layout = []        # [(name, dtype)] of the head's metrics

    def broadcast_metrics(metrics):
        """The last pipe rank's metrics on every pipe rank (its names and
        dtypes are sent once, at the first step)."""
        if n == 1:
            return metrics
        if not metric_layout:
            obj = [[(k, v.dtype) for k, v in metrics.items()] if last
                   else None]
            dist.broadcast_object_list(obj, src=pipe.ranks[-1],
                                       group=pipe.group)
            metric_layout.extend(obj[0])
        vec = (torch.stack([metrics[k].float() for k, _ in metric_layout])
               if last else torch.zeros(len(metric_layout), device=dev))
        vec = pipe.psum(vec)
        return {k: vec[i].to(dt) for i, (k, dt) in enumerate(metric_layout)}

    def materialize(params):
        """The step's leaves: each ZeRO-3 shard gathered once, outside
        the tick loop (a gather a tick would run M times, and bubble
        ticks would break the data peers' common order): shared leaves
        first, then the stage chunks in layer order.  Returns the leaves
        (a gathered one detached, to be differentiated by the ticks) and
        ``[(shard, full, name, v)]`` of the gathers, for
        :func:`scatter_back`."""
        gathered = []

        def leaf(nm, shard, shape, v=None):
            if nm not in space.zero3:
                return shard.detach().requires_grad_()
            src = shard.detach().requires_grad_()
            full = common.zero3_gather(src, zaxes[nm], shape,
                                       zero3_precision)
            gathered.append((src, full, nm, v))
            return full.detach().requires_grad_()

        shared_leaves = {nm: leaf(nm, p, logical[nm])
                         for nm, p in params.items() if not is_stage(nm)}
        chunk_leaves = [{nm: leaf(nm, p[v], logical[nm][1:], v)
                         for nm, p in params.items() if is_stage(nm)}
                        for v in range(V)]
        return shared_leaves, chunk_leaves, gathered

    def scatter_back(gathered, shared_grads, stage_grads):
        """Each gathered leaf's gradient through its gather's backward
        (a reduce-scatter sum over its ZeRO axes), in gather order."""
        for src, full, nm, v in gathered:
            grads = shared_grads if v is None else stage_grads[v]
            g = grads[nm]
            grads[nm] = torch.autograd.grad(
                full, src, torch.zeros_like(full) if g is None else g)[0]

    def gradients(params, batch):
        """This rank's gradients of one whole schedule (in the update
        layout: a ZeRO-3 variable's shard) and the head's metrics."""
        shared_leaves, chunk_leaves, gathered = materialize(params)
        shared = tree(shared_leaves, "shared") if has_shared else None
        chunks = [tree(leaves, "stages") for leaves in chunk_leaves]
        x, mbs = first_input(shared, batch)
        saved, outs = forward_ticks(chunks, mbs)
        shared_grads = dict.fromkeys(shared_leaves)
        head_grads, metrics = [None] * M, {}
        if last:
            ins = [outs[m].requires_grad_() for m in range(M)]
            outputs = torch.cat(ins)
            loss, metrics = (trainable.loss_head(outputs, batch, shared,
                                                 **vp_kwargs)
                             if has_shared
                             else trainable.loss_head(outputs, batch))
            metrics = {k: torch.as_tensor(v).detach()
                       for k, v in dict(metrics, loss=loss).items()}
            gs = torch.autograd.grad(loss, [*ins, *shared_leaves.values()],
                                     allow_unused=True)
            head_grads = [torch.zeros_like(i) if g is None else g
                          for i, g in zip(ins, gs[:M])]
            shared_grads = dict(zip(shared_leaves, gs[M:]))
        grads, g_first = backward_ticks(saved, head_grads, chunk_leaves,
                                        torch.zeros_like(mbs[0]))
        if first and x.requires_grad:
            gs = torch.autograd.grad(x, list(shared_leaves.values()),
                                     torch.cat(g_first), allow_unused=True)
            for nm, g in zip(shared_leaves, gs):
                if g is not None:
                    acc = shared_grads[nm]
                    shared_grads[nm] = g if acc is None else acc + g
        scatter_back(gathered, shared_grads, grads)
        out = {}
        for nm, p in params.items():
            if is_stage(nm):
                out[nm] = torch.stack([
                    torch.zeros_like(p[v]) if grads[v][nm] is None
                    else grads[v][nm] for v in range(V)])
            else:
                g = shared_grads[nm]
                out[nm] = torch.zeros_like(p) if g is None else g
        return out, broadcast_metrics(metrics)

    def sync_grads(grads: dict, rows: dict):
        """Shared gradients summed over pipe (each pipe rank holds a
        different piece: the prologue's on rank 0, the head's on rank
        n - 1), in one flat all-reduce, except under ZeRO, whose one
        reduce-scatter over pipe x data sums and shards at once; then,
        in name order, each ZeRO gradient reduce-scattered (a ZeRO-3
        one only divided: its gather's backward scattered it) and each
        compressed one through its compressor over data; the rest
        averaged over data in one flat fp32 all-reduce.  A vocab
        shard's gradient is summed within its model coordinate only:
        each model rank owns its rows."""
        grads = dict(grads)
        grads.update(pipe.psum_all({nm: g for nm, g in grads.items()
                                    if not is_stage(nm)
                                    and nm not in zaxes}))
        out, plain, new_rows = {}, {}, dict(rows)
        for nm, g in grads.items():
            if nm in zaxes:
                # A shared gradient's scatter over pipe x data sums the
                # pipe ranks' pieces: only the data replicas average.
                out[nm] = space.zero_reduce(nm, g, n_d)
            elif nm in comps:
                out[nm] = space.compress(nm, g, rows, new_rows, data)
            else:
                plain[nm] = g
        out.update(data.pmean_all(plain))
        return {nm: out[nm] for nm in grads}, new_rows

    def step_fn(state, batch, rng):
        params = state["params"]

        def micro(mb, r, extra):
            # No stage draws randomness: the slice's seed goes unused.
            grads, metrics = gradients(params, mb)
            return grads, extra, metrics

        with torch.enable_grad(), precision_scope(plan.precision), \
                kernel_scope(plan.kernel):
            if plan.accum == 1:
                grads, metrics = gradients(params, batch)
            else:
                # Each accumulation slice runs the whole schedule.
                grads, _, metrics = common.accumulate_microbatches(
                    micro, batch, rng, None, plan.accum)
        synced, rows = sync_grads(grads, state["sync_state"])
        new_params, opt_state = space.update(opt, synced,
                                             state["opt_state"], params)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt_state": opt_state, "extra": state["extra"],
                     "sync_state": rows}
        return new_state, reduce_metrics(metrics, mesh)

    def full_params(stored: dict) -> dict:
        """The logical tree: ZeRO-3 shards gathered and unpadded, model
        shards gathered (a vocab table's padding cut off), then the pipe
        ranks' chunks gathered in storage order and put back in logical
        order."""
        inv = torch.as_tensor(chunk_permutation_inv(n, V))
        out = {}
        for nm, t in stored.items():
            if nm in space.zero3 and is_stage(nm):
                size = int(np.prod(logical[nm][1:], dtype=np.int64))
                t = zaxes[nm].all_gather(t, dim=1)[:, :size].reshape(
                    (V,) + logical[nm][1:])
            elif nm in space.zero3:
                t = common.all_gather_flat(t, zaxes[nm], logical[nm])
            if nm in plan.model_dims:
                t = model.all_gather(t, dim=plan.model_dims[nm])
            if nm in plan.vocab_dims:
                t = interop.unpad(model.all_gather(t), 0, logical[nm][0])
            if is_stage(nm) and n > 1:
                t = pipe.all_gather(t).index_select(0, inv.to(t.device))
            out[nm] = t
        return out

    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn, full_params_fn=full_params,
                   zero3_shapes=zero3_shapes, zero_degraded=zero_degraded,
                   unapplied=unapplied)
