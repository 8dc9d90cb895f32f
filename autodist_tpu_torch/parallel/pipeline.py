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
   prologue's output (a tensor or a dict of tensors, run on the data
   shard, whose rows split into ``num_microbatches`` contiguous
   microbatches) instead of what arrived.  Under ``stage_rng`` the
   chunk call gets the key of global chunk ``v·n + d`` and the
   microbatch's global rows (:func:`~autodist_tpu_torch.capture
   .stage_key`), so keyed draws do not depend on M, V or the data
   sharding; under ``stage_aux`` each valid tick's aux scalar enters
   the loss as ``aux / M``.  Only pipe rank 0 runs the prologue; the
   others take its output's shape and dtype from a run on meta tensors
   (no compute, no collective).  Activations are ``[B/M, L, H]``, and
   the stage function gets ``model_axis`` (and ``comm_overlap``) under
   ``tensor_parallel > 1``; under ``remat`` each stage call is a
   non-reentrant ``torch.utils.checkpoint``, recomputed (its
   model-axis rings included) in the backward;
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
   over model: each model rank owns its rows.  The head's metrics (its
   ``fetch`` tags among them, at any shape) are broadcast from the last
   pipe rank (the aux, summed over the pipe axis, added as
   ``aux_loss``), then averaged over data; a tag inside a stage
   raises.

The eval program (``Lowered.eval_fn``) is steps 2, 3 and 4 without a
gradient: the forward ticks and the head, its metrics reduced alike.

"Data" above is the replica group: ``dcn x data`` on a multi-slice mesh
(JAX ``pipeline.py``'s ``d_axes``), one joint axis that splits the batch
and carries every data-parallel reduction, ZeRO shard and compressor.

``Lowered.state_manifest`` is the ``pipeline`` family's (JAX
``_build_pipeline`` ``_state_manifest``): a stage leaf's global stored
form is the ``[C, ...]`` stack of its ``C = n·V`` chunks in storage
order (the pipe ranks' parts along dim 0, the model ranks' along the
model dim), whose recipe is the inverse chunk permutation (``index0``);
a ZeRO-3 stage leaf is ``[C, padded_chunk]`` flat rows (the ZeRO ranks'
parts along dim 1), cut, reshaped and permuted back; the vocab-sharded
table is its padded ``[V_pad, H]`` storage, sliced to the vocabulary; a
ZeRO-1/2 stage leaf's optimizer state is the pipe-major ``[n ·
padded]`` flat update space, the vocab table's the model-major one; a
compressor's rows are one a rank, with their compressor.

At one pipe device the same schedule runs every (microbatch, chunk) in
order, what ``pipeline_apply`` computes there.  The strategy is checked
as ``lower_pipeline_ir`` checks it, with the same errors.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from autodist_tpu_torch import const, interop
from autodist_tpu_torch import fetches as _fetches
from autodist_tpu_torch.capture import PipelineTrainable, stage_key
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
                                            normalize_precision)


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

    # The replica axes include dcn on a multi-slice mesh (a data-only
    # sync would skip the cross-slice exchange).
    d_axes = tuple(a for a in (const.DCN_AXIS, const.DATA_AXIS)
                   if a in mesh.shape)
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
    data = mesh.replica_axis()              # dcn x data
    pipe = mesh.axis(const.PIPE_AXIS)
    model = mesh.axis(const.MODEL_AXIS)
    has_data = any(a in mesh.shape for a in (const.DCN_AXIS,
                                             const.DATA_AXIS))
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
    zaxes = {nm: axis_over(mesh, pol.zero_axes)
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

    def stage_fn(chunk, x, keyed):
        # A fetch tag inside a stage raises, naming the tag.  ``keyed``
        # is ``(rng_c, rows)`` under stage_rng, else empty.
        with _fetches.refusing("a pipeline stage"):
            if not plan.remat:
                return trainable.stage_fn(chunk, x, *keyed, **tp_kwargs)
            # The recompute runs inside the backward's precision and
            # kernel scopes; keyed draws redraw the same masks.
            return torch.utils.checkpoint.checkpoint(
                trainable.stage_fn, chunk, x, *keyed, use_reentrant=False,
                preserve_rng_state=False, **tp_kwargs)

    def head(outputs, batch, shared):
        """The loss head on the last chunk's outputs: the loss and its
        metrics, ``loss`` and the head's fetch tags among them."""
        with _fetches.collecting() as fd:
            loss, metrics = (trainable.loss_head(outputs, batch, shared,
                                                 **vp_kwargs)
                             if has_shared
                             else trainable.loss_head(outputs, batch))
        metrics = _fetches.merge_into_metrics(dict(metrics, loss=loss), fd)
        return loss, {k: torch.as_tensor(v).detach()
                      for k, v in metrics.items()}

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
        """The prologue's output (or the batch key), a tensor or a dict
        of tensors: ``(its leaves, its spec, the M microbatches' leaves,
        the microbatch size)``.  Pipe rank 0 computes it; the other
        ranks need only its shapes and dtypes, from the prologue on
        meta tensors."""
        if trainable.prologue is None:
            x = batch[trainable.batch_key]
        elif first:
            x = trainable.prologue(shared, batch, **vp_kwargs)
        else:
            meta = trainable.prologue(_on_meta(shared), _on_meta(batch))
            x = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                               device=dev), meta)
        leaves, spec = tree_flatten(x)
        for leaf in leaves:
            if not leaf.is_floating_point():
                raise TypeError(f"the pipeline's activations must be "
                                f"floating point; chunk 0 gets {leaf.dtype}")
        B = leaves[0].shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        split = [leaf.detach().split(B // M) for leaf in leaves]
        return leaves, spec, [list(mb) for mb in zip(*split)], B // M

    def keyed_args(rng, row_offset, m, v, mb):
        """A chunk call's ``(rng_c, rows)`` under stage_rng: the key of
        global chunk ``v·n + d`` and the microbatch's global rows."""
        if not trainable.stage_rng:
            return ()
        rows = row_offset + m * mb + torch.arange(mb, device=dev)
        return stage_key(rng, v * n + d, dev), rows

    def forward_ticks(chunks, mbs, spec, mb, rng=None, row_offset=0):
        """The forward schedule: each valid tick's (input leaves, output
        leaves, aux), by tick; the last chunk's output leaves, by
        microbatch; this rank's aux summed over its valid ticks."""
        zeros = [torch.zeros_like(a) for a in mbs[0]]
        carry, saved, outs, aux_sum = zeros, {}, {}, None
        for t in range(T):
            recv = [pipe.ppermute(a, 1) for a in carry]
            valid, m, v = _tick_assignment(t, d, n=n, V=V, M=M)
            if not valid:
                carry = zeros
                continue
            src = mbs[m] if first and v == 0 else recv
            xs = [a.detach().requires_grad_() for a in src]
            res = stage_fn(chunks[v], tree_unflatten(xs, spec),
                           keyed_args(rng, row_offset, m, v, mb))
            out, aux = res if trainable.stage_aux else (res, None)
            out_leaves, out_spec = tree_flatten(out)
            if out_spec != spec or [(o.shape, o.dtype) for o in out_leaves] \
                    != [(a.shape, a.dtype) for a in xs]:
                raise ValueError(
                    f"stage activations must match the microbatch's "
                    f"structure, shapes and dtypes (chunk 0 consumes the "
                    f"batch): got {out_spec} "
                    f"{[(tuple(o.shape), o.dtype) for o in out_leaves]} "
                    f"from {spec} "
                    f"{[(tuple(a.shape), a.dtype) for a in xs]}")
            if aux is not None:
                aux = torch.as_tensor(aux, device=dev)
                aux_sum = aux.detach() if aux_sum is None \
                    else aux_sum + aux.detach()
            saved[t] = (xs, out_leaves, aux)
            carry = [o.detach() for o in out_leaves]
            if last and v == V - 1:
                outs[m] = carry
        return saved, outs, aux_sum

    def backward_ticks(saved, head_grads, chunk_leaves, zeros):
        """The reverse schedule; the stage leaves' gradients by chunk,
        and chunk 0's input gradients by microbatch.  A stage's aux
        enters the loss as ``aux / M``, on every rank."""
        grads = [dict.fromkeys(leaves) for leaves in chunk_leaves]
        g_first = [None] * M
        carry = zeros
        for t in reversed(range(T)):
            recv = [pipe.ppermute(a, -1) for a in carry]
            valid, m, v = _tick_assignment(t, d, n=n, V=V, M=M)
            if not valid:
                carry = zeros
                continue
            xs, out_leaves, aux = saved.pop(t)
            cot = head_grads[m] if last and v == V - 1 else recv
            outputs = [(o, g) for o, g in zip(out_leaves, cot)
                       if o.requires_grad]
            if aux is not None and aux.requires_grad:
                outputs.append((aux, torch.full_like(aux, 1.0 / M)))
            leaves = chunk_leaves[v]
            gs = (torch.autograd.grad([o for o, _ in outputs],
                                      [*xs, *leaves.values()],
                                      [g for _, g in outputs],
                                      allow_unused=True)
                  if outputs else [None] * (len(xs) + len(leaves)))
            for nm, g in zip(leaves, gs[len(xs):]):
                if g is not None:
                    acc = grads[v][nm]
                    grads[v][nm] = g if acc is None else acc + g
            g_x = [z if g is None else g for z, g in zip(zeros, gs)]
            if first and v == 0:
                g_first[m], carry = g_x, zeros
            else:
                carry = g_x
        return grads, g_first

    metric_layouts: dict = {}   # call site -> [(name, dtype, shape)]

    def broadcast_metrics(metrics, site: str):
        """The last pipe rank's metrics, at any shape, on every pipe
        rank (their names, dtypes and shapes are sent once a call site,
        at its first call)."""
        if n == 1:
            return metrics
        if site not in metric_layouts:
            obj = [[(k, v.dtype, tuple(v.shape)) for k, v in
                    metrics.items()] if last else None]
            dist.broadcast_object_list(obj, src=pipe.ranks[-1],
                                       group=pipe.group)
            metric_layouts[site] = obj[0]
        layout = metric_layouts[site]
        size = sum(math.prod(shape) for _, _, shape in layout)
        vec = (torch.cat([metrics[k].reshape(-1).float()
                          for k, _, _ in layout])
               if last else torch.zeros(size, device=dev))
        vec = pipe.psum(vec)
        out, offset = {}, 0
        for k, dt, shape in layout:
            numel = math.prod(shape)
            out[k] = vec[offset:offset + numel].view(shape).to(dt)
            offset += numel
        return out

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

    def with_aux(metrics, aux_sum):
        """Under stage_aux: ``aux_loss`` is every pipe rank's aux over
        its valid ticks, divided by M and summed over the pipe axis
        (replacing a head metric of that name), and ``loss`` gains it;
        without, the head's metrics as they are."""
        if not trainable.stage_aux:
            return metrics
        local = (torch.zeros((), device=dev) if aux_sum is None
                 else aux_sum.float() / M)
        aux = pipe.psum(local)
        return dict(metrics, aux_loss=aux, loss=metrics["loss"] + aux)

    def gradients(params, batch, rng=None, slice_idx=0):
        """This rank's gradients of one whole schedule (in the update
        layout: a ZeRO-3 variable's shard) and the head's metrics."""
        shared_leaves, chunk_leaves, gathered = materialize(params)
        shared = tree(shared_leaves, "shared") if has_shared else None
        chunks = [tree(leaves, "stages") for leaves in chunk_leaves]
        x, spec, mbs, mb = first_input(shared, batch)
        # The global index of this (data shard, accumulation slice)'s
        # first row: shards split the batch before accumulation slices
        # it.
        b_local = mb * M
        row_offset = b_local * (slice_idx + data.index * plan.accum)
        saved, outs, aux_sum = forward_ticks(chunks, mbs, spec, mb, rng,
                                             row_offset)
        shared_grads = dict.fromkeys(shared_leaves)
        zeros = [torch.zeros_like(a) for a in mbs[0]]
        head_grads, metrics = [None] * M, {}
        if last:
            ins = [[a.requires_grad_() for a in outs[m]] for m in range(M)]
            joined = tree_unflatten(
                [torch.cat(parts) for parts in zip(*ins)], spec)
            loss, metrics = head(joined, batch, shared)
            flat_ins = [a for per_m in ins for a in per_m]
            gs = torch.autograd.grad(
                loss, [*flat_ins, *shared_leaves.values()],
                allow_unused=True)
            k = len(zeros)
            head_grads = [[z if g is None else g
                           for z, g in zip(zeros, gs[m * k:(m + 1) * k])]
                          for m in range(M)]
            shared_grads = dict(zip(shared_leaves, gs[M * k:]))
        grads, g_first = backward_ticks(saved, head_grads, chunk_leaves,
                                        zeros)
        x_out = [(a, torch.cat([g[i] for g in g_first]))
                 for i, a in enumerate(x) if first and a.requires_grad]
        if x_out:
            gs = torch.autograd.grad([a for a, _ in x_out],
                                     list(shared_leaves.values()),
                                     [g for _, g in x_out],
                                     allow_unused=True)
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
        return out, with_aux(broadcast_metrics(metrics, "step"), aux_sum)

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

        slices = itertools.count()

        def micro(mb, _, extra):
            # Each accumulation slice runs the whole schedule in turn;
            # keyed draws take the step seed, their rows global (the
            # slice's place in the batch), so no slice seed is used.
            grads, metrics = gradients(params, mb, rng, next(slices))
            return grads, extra, metrics

        with torch.enable_grad(), precision_scope(plan.precision), \
                kernel_scope(plan.kernel):
            if plan.accum == 1:
                grads, metrics = gradients(params, batch, rng)
            else:
                grads, _, metrics = common.accumulate_microbatches(
                    micro, batch, rng, None, plan.accum)
        synced, rows = sync_grads(grads, state["sync_state"])
        new_params, opt_state = space.update(opt, synced,
                                             state["opt_state"], params)
        new_state = {"step": state["step"] + 1, "params": new_params,
                     "opt_state": opt_state, "extra": state["extra"],
                     "sync_state": rows}
        return new_state, reduce_metrics(metrics, mesh)

    def eval_fn(state, batch, rng):
        """The forward schedule and the loss head, no backward and no
        update; deterministic (no seed reaches the stages: ``rng`` goes
        unused).  The head's metrics broadcast from the last pipe rank,
        the aux added as in training, then averaged over data."""
        with torch.no_grad(), precision_scope(plan.precision), \
                kernel_scope(plan.kernel):
            shared_leaves, chunk_leaves, _ = materialize(state["params"])
            shared = tree(shared_leaves, "shared") if has_shared else None
            _, spec, mbs, mb = first_input(shared, batch)
            _, outs, aux_sum = forward_ticks(
                [tree(leaves, "stages") for leaves in chunk_leaves], mbs,
                spec, mb)
            metrics = {}
            if last:
                joined = tree_unflatten(
                    [torch.cat(parts) for parts in
                     zip(*[outs[m] for m in range(M)])], spec)
                _, metrics = head(joined, batch, shared)
            return reduce_metrics(with_aux(
                broadcast_metrics(metrics, "eval"), aux_sum), mesh)

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

    # --- the elastic state codec (JAX ``_state_manifest``) ------------- #
    from autodist_tpu_torch.kernel.lowering import (_op_flat_slice,
                                                    _op_index0, _op_reshape,
                                                    _op_slice, leaf_record,
                                                    split_record)

    C = n * V
    inv = [int(i) for i in chunk_permutation_inv(n, V)]
    flat_zero = {nm for nm in zaxes if nm not in space.zero3}

    def numel(shape) -> int:
        return max(int(np.prod(shape, dtype=np.int64)), 1)

    def padded_table(nm) -> tuple:
        """The vocab table's stored global shape: its vocabulary padded
        to divide the model axis."""
        rows = logical[nm][0]
        return (common.padded_flat_size(rows, model.size),) + logical[nm][1:]

    def splits(*records):
        out = [r for r in records if r is not None]
        return out or None

    def param_layout(nm):
        """A parameter's global stored shape, recipe and splits
        (outermost first)."""
        shape = logical[nm]
        if is_stage(nm):
            if nm in space.zero3:
                elems = numel(shape[1:])
                glob = (C, common.padded_flat_size(elems, zaxes[nm].size))
                return glob, [_op_slice(glob, (C, elems)),
                              _op_reshape((C, elems), shape),
                              _op_index0(shape, inv)], splits(
                    split_record(pipe, 0), split_record(zaxes[nm], 1))
            md = plan.model_dims.get(nm)
            return shape, [_op_index0(shape, inv)], splits(
                split_record(pipe, 0),
                None if md is None else split_record(model, md))
        if nm in space.zero3:
            size = numel(shape)
            glob = (common.padded_flat_size(size, zaxes[nm].size),)
            return glob, [_op_flat_slice(glob, size),
                          _op_reshape((size,), shape)], splits(
                split_record(zaxes[nm], 0))
        if nm in plan.vocab_dims:
            glob = padded_table(nm)
            return glob, ([_op_slice(glob, shape)] if glob != shape
                          else []), splits(split_record(model, 0))
        return shape, [], None

    def opt_layout(nm):
        """An optimizer leaf's global update-space shape, recipe and
        splits: the parameter's, except for a flat (ZeRO-1/2) shard."""
        if nm not in flat_zero:
            return param_layout(nm)
        shape, nz = logical[nm], zaxes[nm].size
        if is_stage(nm):
            local = numel(shape) // n
            padded = common.padded_flat_size(local, nz)
            return (n * padded,), [
                _op_reshape((n * padded,), (n, padded)),
                _op_slice((n, padded), (n, local)),
                _op_reshape((n, local), shape),
                _op_index0(shape, inv)], splits(
                split_record(pipe, 0), split_record(zaxes[nm], 0))
        if nm in plan.vocab_dims:
            table = padded_table(nm)
            tp = model.size
            local = numel(table) // tp
            padded = common.padded_flat_size(local, nz)
            ops = [_op_reshape((tp * padded,), (tp, padded)),
                   _op_slice((tp, padded), (tp, local)),
                   _op_reshape((tp, local), table)]
            if table != shape:
                ops.append(_op_slice(table, shape))
            return (tp * padded,), ops, splits(split_record(model, 0),
                                               split_record(zaxes[nm], 0))
        size = numel(shape)
        glob = (common.padded_flat_size(size, nz),)
        return glob, [_op_flat_slice(glob, size),
                      _op_reshape((size,), shape)], splits(
            split_record(zaxes[nm], 0))

    world = math.prod(mesh.shape.values())
    everyone = "+".join(a for a, k in mesh.shape.items() if k > 1) or \
        next(iter(mesh.shape), const.DATA_AXIS)

    def state_manifest(state):
        """The pipeline family's manifest (JAX ``_state_manifest``; the
        module docstring): per leaf its global stored shape, the recipe
        to the logical form and where the ranks' parts lie."""
        stored = dict(state["params"])

        def u_local(nm) -> tuple:
            t = stored[nm]
            if nm in flat_zero:
                nz = zaxes[nm].size
                return (common.padded_flat_size(t.numel(), nz) // nz,)
            return tuple(t.shape)

        leaves, sync = {}, {}
        for name, leaf in common.state_leaves(state):
            shape, ops, split = tuple(leaf.shape), [], None
            if name.startswith("params/") and name[7:] in logical:
                shape, ops, split = param_layout(name[7:])
            elif name.startswith("opt_state/"):
                local = shape
                var = common.match_var_by_suffix(
                    name, logical, shape_ok=lambda v: local == u_local(v))
                if var is not None:
                    shape, ops, split = opt_layout(var)
            elif name.startswith("sync_state/"):
                key = name[len("sync_state/"):]
                shape = (world, int(leaf.numel()))
                split = {"axis": everyone, "dim": 0, "ranks": world}
                sync[name] = {"rows": world, "width": int(leaf.numel()),
                              "compressor": policies[key].compressor}
            leaves[name] = leaf_record(shape, leaf.dtype, ops, split)
        return {"family": "pipeline", "leaves": leaves, "sync": sync}

    def row_width(nm) -> int:
        """A compressor row's width: the rank's stored variable."""
        shape = logical[nm]
        if is_stage(nm):
            md = plan.model_dims.get(nm)
            return numel(shape) // n // (model.size if md is not None else 1)
        if nm in plan.vocab_dims:
            return numel(padded_table(nm)) // model.size
        return numel(shape)

    sync_init = {nm: comp.init_state_flat(row_width(nm))
                 for nm, comp in comps.items() if comp.stateful}
    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn, full_params_fn=full_params,
                   eval_fn=eval_fn, zero3_shapes=zero3_shapes,
                   zero_degraded=zero_degraded,
                   unapplied=unapplied, state_manifest_fn=state_manifest,
                   sync_init=sync_init)
