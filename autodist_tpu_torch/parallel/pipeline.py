"""The ``pipeline`` lowering at one pipe device, with tensor parallelism
inside the stages.

Counterpart of ``lower_pipeline_ir`` and ``_build_pipeline`` of
``autodist_tpu/parallel/pipeline.py`` for a pipe axis of 1 (what the
port's resource spec accepts; the cross-process schedule is ROADMAP
Queue 1, slice 3 leftovers, item 1).  Every process of the job runs the
step on its (data, model) coordinate:

1. stage variables are stored as this rank's model shard, cut by the
   strategy's partitioner specs (:func:`autodist_tpu_torch.interop
   .shard_params`); shared variables are replicated;
2. the prologue runs on the data shard of the batch, whose rows split
   into ``num_microbatches`` contiguous microbatches; each goes through
   every stage in order (what ``pipeline_apply`` computes at one pipe
   device), with activations ``[B/M, L, H]`` at each boundary, and the
   stage function gets ``model_axis`` (and ``comm_overlap``) under
   ``tensor_parallel > 1``;
3. the outputs are concatenated and the loss head runs on the whole
   shard;
4. forward and backward run inside ``precision_scope`` and
   ``kernel_scope`` with the strategy's policy and election, as the JAX
   package opens them around its step;
5. stage and shared gradients are averaged over the data axis only (at
   one pipe device the JAX package's pipe-axis sum of shared gradients
   is the identity), in one flat fp32 all-reduce, and the functional
   optimizer updates each stored shard.

The strategy is checked as ``lower_pipeline_ir`` checks it, with the
same errors; what this slice does not run raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses

import torch

from autodist_tpu_torch import const, interop, optim
from autodist_tpu_torch.capture import PipelineTrainable, stage_slice
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import flatten_with_names, unflatten
from autodist_tpu_torch.kernel.lowering import Lowered, reduce_metrics
from autodist_tpu_torch.parallel.tensor import (kernel_scope,
                                                normalize_comm_overlap,
                                                precision_scope)
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer,
                                            normalize_kernel,
                                            normalize_precision, not_ported)

_LEFTOVERS = "ROADMAP Queue 1, slice 3 leftovers"


@dataclasses.dataclass
class PipelinePlan:
    """The resolved pipeline strategy."""

    num_microbatches: int
    num_stages: int
    tensor_parallel: int
    model_dims: dict           # stage variable -> dim sharded over model
    comm_overlap: object       # None or "matmul"
    precision: dict
    kernel: dict



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
    if any(not is_stage(name) for name in dims) or par.get("vocab_parallel"):
        not_ported("vocab parallelism (a model-sharded shared variable)",
                   f"{_LEFTOVERS}, item 2")
    if dims and tp_mesh == 1:
        raise ValueError(
            "strategy shards variables over the model axis but the mesh "
            f"has none: {dict(mesh.shape)}")
    parts = [nc.partitioner for nc in strategy.node_configs
             if nc.partitioner is not None]
    overlap = normalize_comm_overlap(par.get("comm_overlap")) or _one(
        {p.comm_overlap for p in parts if p.comm_overlap}, "comm_overlap")
    precision = dict(normalize_precision(cfg.precision))
    if "tp_psum" not in precision:
        # A hand-edited strategy may carry the slot only per variable.
        tp_prec = _one({nc.partitioner.precision
                        for nc in strategy.node_configs
                        if nc.partitioner is not None and is_stage(nc.var_name)
                        and nc.partitioner.precision not in (None, "fp32")},
                       "tp_psum precisions")
        if tp_prec:
            precision["tp_psum"] = tp_prec
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
    if par.get("remat"):
        not_ported("Pipeline(remat=True)", f"{_LEFTOVERS}, item 4")
    if par.get("zero_stage") or any(
            not isinstance(nc.synchronizer, AllReduceSynchronizer)
            for nc in strategy.node_configs):
        not_ported("ZeRO in the pipeline lowering", f"{_LEFTOVERS}, item 4")
    if precision.get("grad") or any(
            nc.synchronizer.compressor not in ("", "none")
            for nc in strategy.node_configs):
        not_ported("gradient compressors (and the 'grad' precision slot)",
                   "ROADMAP Queue 1, slice 2 leftovers, item 3")
    if overlap == "rsag":
        not_ported("comm_overlap='rsag'", f"{_LEFTOVERS}, item 3")
    if overlap and precision.get("tp_psum"):
        not_ported("a narrowed tp_psum precision under comm_overlap",
                   f"{_LEFTOVERS}, item 3")
    if cfg.accum_steps != 1:
        not_ported("gradient accumulation", "ROADMAP Queue 1, item 8")
    return PipelinePlan(
        num_microbatches=int(par.get("num_microbatches", 1)),
        num_stages=trainable.num_stages,
        tensor_parallel=tp_mesh if dims else 1, model_dims=dims,
        comm_overlap=overlap, precision=precision,
        kernel={k: True for k in kernel
                if k in ("quant_ring", "collective_matmul")})


def lower_pipeline(trainable, strategy, mesh, device=None) -> Lowered:
    """The train step of a ``Pipeline`` strategy on ``device`` (``None``:
    the card)."""
    plan = make_pipeline_plan(trainable, strategy, mesh)
    dev, opt = resolve_device(device), trainable.optimizer
    M, C = plan.num_microbatches, plan.num_stages
    data = mesh.axis(const.DATA_AXIS)
    model = mesh.axis(const.MODEL_AXIS)
    has_shared = trainable.has_shared
    tp_kwargs = {}
    if plan.tensor_parallel > 1:
        tp_kwargs["model_axis"] = model
        if plan.comm_overlap:
            tp_kwargs["comm_overlap"] = plan.comm_overlap

    def init_fn(params, extra):
        local = interop.shard_params(params, plan.model_dims, model.index,
                                     model.size)
        stored = {nm: t.detach().to(dev).clone()
                  for nm, t in flatten_with_names(local)}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt.init(stored),
                "extra": extra}

    def forward(tree, batch):
        stages = tree["stages"] if has_shared else tree
        shared = tree.get("shared") if has_shared else None
        x = trainable.prologue(shared, batch) \
            if trainable.prologue is not None else batch[trainable.batch_key]
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatches {M}")
        outs = []
        for mb in x.split(B // M):
            for c in range(C):
                mb = trainable.stage_fn(stage_slice(stages, c), mb,
                                        **tp_kwargs)
            outs.append(mb)
        outputs = torch.cat(outs)
        return (trainable.loss_head(outputs, batch, shared) if has_shared
                else trainable.loss_head(outputs, batch))

    def step_fn(state, batch, rng):
        del rng                      # no stage draws (PipelineTrainable)
        params = state["params"]
        leaves = {nm: p.detach().requires_grad_(True)
                  for nm, p in params.items()}
        with torch.enable_grad(), precision_scope(plan.precision), \
                kernel_scope(plan.kernel):
            loss, metrics = forward(unflatten(leaves), batch)
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        grads = {nm: torch.zeros_like(params[nm]) if g is None else g
                 for nm, g in zip(leaves, grads)}
        updates, opt_state = opt.update(data.pmean_all(grads),
                                        state["opt_state"], params)
        new_state = {"step": state["step"] + 1,
                     "params": optim.apply_updates(params, updates),
                     "opt_state": opt_state, "extra": state["extra"]}
        return new_state, reduce_metrics(dict(metrics, loss=loss), mesh)

    def full_params(stored: dict) -> dict:
        return {nm: model.all_gather(t, dim=plan.model_dims[nm])
                if nm in plan.model_dims else t
                for nm, t in stored.items()}

    return Lowered(plan=plan, mesh=mesh, device=dev, init_fn=init_fn,
                   step_fn=step_fn, full_params_fn=full_params)
