"""Mixture-of-Experts with expert parallelism over the ``expert`` mesh axis.

Counterpart of ``autodist_tpu/parallel/moe.py``: GShard top-2 gating
with a capacity per expert, the einsum dispatch and combine, and the
tiled all-to-all that carries tokens to the rank holding their expert
and back.  The all-to-all runs at the ``moe_a2a`` wire precision
(:func:`quantized_all_to_all`: exact, bf16, or the composed int8 of one
whole-payload scale) or as the fused int8 ring with ``a2a_ring`` elected
(:mod:`autodist_tpu_torch.kernel.a2a_ring`); each is an autograd
function whose backward is the transposed exchange at the same
precision.

:func:`lower_expert_ir` lowers an ``ExpertParallel`` strategy on the
shared replicated-parameter step (:mod:`autodist_tpu_torch.parallel
._spmd`).  Where the JAX package traces one ``shard_map`` program, every
process of the job runs the step on its (data, expert) coordinate; the
loss finds the expert axis by name (:func:`~autodist_tpu_torch.parallel
.axis.bound_axis`), bound around its forward and backward as
``shard_map`` binds the axis name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from autodist_tpu_torch import const, interop
from autodist_tpu_torch.kernel import quantize as qz
from autodist_tpu_torch.kernel.a2a_ring import ring_dispatch
from autodist_tpu_torch.strategy.ir import (normalize_kernel,
                                            normalize_precision)


def top2_gating(gate_logits, capacity: int):
    """GShard-style top-2 gating with capacity, op for op the JAX
    package's: ``gate_logits`` ``[G, E]`` -> ``(dispatch [G, E, C]
    bool, combine [G, E, C] float, aux_loss)``.  Ties go to the first
    expert (``argmax``), slots are given in token order (``cumsum``) and
    tokens past an expert's capacity are dropped."""
    G, E = gate_logits.shape
    probs = torch.softmax(gate_logits.float(), dim=-1)

    top1 = probs.argmax(-1)
    mask1 = F.one_hot(top1, E).float()
    probs_wo1 = probs * (1.0 - mask1)
    top2 = probs_wo1.argmax(-1)
    mask2 = F.one_hot(top2, E).float()

    # load-balancing auxiliary loss (GShard eq. (4))
    density = mask1.mean(0)
    density_proxy = probs.mean(0)
    aux_loss = (density * density_proxy).sum() * E

    # positions within each expert's capacity, first-come order
    pos1 = (torch.cumsum(mask1, dim=0) - 1.0) * mask1
    mask1 = mask1 * (pos1 < capacity)
    pos2 = (torch.cumsum(mask2, dim=0) - 1.0 + mask1.sum(0)[None]) * mask2
    mask2 = mask2 * (pos2 < capacity)

    w1 = (probs * mask1).sum(-1)
    w2 = (probs * mask2).sum(-1)
    denom = torch.maximum(w1 + w2, torch.full_like(w1, 1e-9))
    w1, w2 = w1 / denom, w2 / denom

    def onehot_pos(mask, pos, w):
        slot = F.one_hot((pos * mask).sum(-1).long(), capacity).float()
        return mask[:, :, None] * slot[:, None, :] * w[:, None, None]

    combine = onehot_pos(mask1, pos1, w1) + onehot_pos(mask2, pos2, w2)
    dispatch = combine > 0.0
    return dispatch, combine, aux_loss


# --------------------------------------------------------------------------- #
# The dispatch/combine exchange
# --------------------------------------------------------------------------- #
def _exchange(x, axis, split_axis, concat_axis, precision):
    """One tiled all-to-all at ``precision``: exact (``fp32``); ``bf16``
    cast around it; ``int8`` the whole local payload quantized against
    one abs-max scale, an ``int8`` all-to-all, the ``n`` scales
    all-gathered and each source block of the concat dim dequantized
    with its own."""
    if precision == "fp32":
        return axis.all_to_all(x, split_axis, concat_axis)
    if precision == "bf16":
        return axis.all_to_all(x.to(torch.bfloat16), split_axis,
                               concat_axis).to(x.dtype)
    n = axis.size
    xf = x.float()
    scale = qz.abs_max_scale(xf)
    q = axis.all_to_all(qz.quantize_levels(xf, scale).to(torch.int8),
                        split_axis, concat_axis)
    scales = axis.all_gather(scale.reshape(1))          # [n], source order
    c = x.shape[concat_axis]
    moved = q.float().movedim(concat_axis, 0)
    rest = tuple(moved.shape[1:])
    blocks = moved.reshape((n, c) + rest) * scales.reshape(
        (n,) + (1,) * (len(rest) + 1))
    return blocks.reshape((n * c,) + rest).movedim(0, concat_axis).to(
        x.dtype)


class _AllToAll(torch.autograd.Function):
    """The exchange, with the transposed exchange (split and concat
    swapped) at the same precision as its backward: the ``moe_a2a``
    policy covers both directions."""

    @staticmethod
    def forward(ctx, x, axis, split_axis, concat_axis, precision):
        ctx.args = (axis, concat_axis, split_axis, precision)
        return _exchange(x, axis, split_axis, concat_axis, precision)

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, *ctx.args), None, None, None, None


def quantized_all_to_all(x, axis, *, split_axis: int, concat_axis: int,
                         precision: Optional[str] = None):
    """Tiled all-to-all over ``axis`` under a ``moe_a2a`` wire precision:
    ``None``/``"fp32"`` exact, ``"bf16"`` or ``"int8"`` narrowed as a
    composed convert sandwich, the transposed exchange at the same
    precision as backward."""
    precision = "fp32" if precision is None else precision
    if precision not in qz.PRECISIONS:
        raise ValueError(f"moe_a2a precision {precision!r}; expected one "
                         f"of {list(qz.PRECISIONS)}")
    return _AllToAll.apply(x, axis, split_axis, concat_axis, precision)


# --------------------------------------------------------------------------- #
# The expert layer
# --------------------------------------------------------------------------- #
def expert_capacity(G: int, capacity_factor: float, E: int) -> int:
    """Slots per expert for ``G`` tokens over ``E`` experts (top-2):
    ``max(ceil(2 G capacity_factor / E), 4)``."""
    return max(int(math.ceil(2 * G * capacity_factor / E)), 4)


def _experts(xs, wi, wo):
    """``[E, C, M]`` tokens through each expert's tanh-GELU MLP, fp32."""
    h = F.gelu(torch.einsum("ecm,emh->ech", xs, wi.float()),
               approximate="tanh")
    return torch.einsum("ech,ehm->ecm", h, wo.float())


def expert_parallel_ffn(tokens, gate_w, expert_wi, expert_wo, axis, *,
                        capacity_factor: float = 2.0,
                        a2a_precision: Optional[str] = None,
                        a2a_kernel: bool = False):
    """The MoE FFN on this rank: ``tokens`` ``[G, M]`` local tokens,
    ``gate_w`` ``[M, E]`` replicated, ``expert_wi`` ``[E_local, M, H]``
    and ``expert_wo`` ``[E_local, H, M]`` this rank's experts, ``axis``
    the expert :class:`~autodist_tpu_torch.parallel.axis.Axis`.  Returns
    ``([G, M], aux_loss)``.  ``a2a_precision`` narrows the dispatch and
    combine wire; ``a2a_kernel`` takes the fused int8 ring for both."""
    G, M = tokens.shape
    E = expert_wi.shape[0] * axis.size
    capacity = expert_capacity(G, capacity_factor, E)

    def route(x, split_axis, concat_axis):
        if a2a_kernel:
            return ring_dispatch(x, axis, split_axis, concat_axis)
        return quantized_all_to_all(x, axis, split_axis=split_axis,
                                    concat_axis=concat_axis,
                                    precision=a2a_precision)

    dispatch, combine, aux = top2_gating(tokens @ gate_w, capacity)
    # local dispatch [E, C, M]; the all-to-all gives every rank its
    # E_local experts' slots from all ranks, [E_local, P*C, M]
    xs = torch.einsum("gm,gec->ecm", tokens.float(), dispatch.float())
    ys = _experts(route(xs, 0, 1), expert_wi, expert_wo)
    # back to the source ranks: [E, C, M]
    ys = route(ys, 1, 0)
    out = torch.einsum("ecm,gec->gm", ys, combine)
    return out.to(tokens.dtype), aux


def dense_moe_reference(tokens, gate_w, expert_wi, expert_wo,
                        capacity: int):
    """One process, every expert: the same gating and experts, no
    all-to-all."""
    dispatch, combine, aux = top2_gating(tokens @ gate_w, capacity)
    xs = torch.einsum("gm,gec->ecm", tokens.float(), dispatch.float())
    ys = _experts(xs, expert_wi, expert_wo)
    return torch.einsum("ecm,gec->gm", ys, combine).to(tokens.dtype), aux


# --------------------------------------------------------------------------- #
# The lowering
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ExpertPlan:
    """The resolved expert strategy."""

    expert_vars: tuple           # stored sharded on their leading dim
    expert_shards: int
    batch_axes: tuple            # the axes that shard the batch
    precision: Optional[str]     # moe_a2a
    kernel: bool                 # a2a_ring


def make_expert_plan(trainable, strategy, mesh) -> ExpertPlan:
    """Resolve an ``ExpertParallel`` strategy against the mesh, with the
    JAX lowering's checks.  The replica axes include ``dcn`` on a
    multi-slice mesh (a data-only sync would skip the cross-slice
    exchange).  ``expert_over_dcn`` lowers as any expert strategy: its
    mesh absorbs the slice dimension into the expert axis (no separate
    ``dcn`` axis), so the all-to-all spans slices; the flag records that
    placement (plan lint ADT061)."""
    cfg = strategy.graph_config
    if const.EXPERT_AXIS not in mesh.shape:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no {const.EXPERT_AXIS!r} axis")
    precision = normalize_precision(cfg.precision)
    E_shards = mesh.shape[const.EXPERT_AXIS]
    expert_vars = list(interop.expert_dims(strategy))
    infos = {v.name: v for v in trainable.var_infos()}
    for name in sorted(expert_vars):
        shape = infos[name].shape
        if not shape or shape[0] % E_shards:
            raise ValueError(
                f"expert variable {name} leading dim {shape} must divide "
                f"the {E_shards}-way expert axis")
    batch_axes = tuple(a for a in (const.DCN_AXIS, const.DATA_AXIS)
                       if a in mesh.shape) + (const.EXPERT_AXIS,)
    return ExpertPlan(expert_vars=tuple(sorted(expert_vars)),
                      expert_shards=E_shards, batch_axes=batch_axes,
                      precision=precision.get("moe_a2a"),
                      kernel=bool(normalize_kernel(cfg.kernel).get(
                          "a2a_ring")))


def lower_expert_ir(trainable, strategy, mesh, device=None):
    """The train step of an ``ExpertParallel`` strategy on ``device``
    (``None``: the card), counterpart of the JAX package's
    ``lower_expert_ir``, on the shared replicated-parameter step
    (:func:`~autodist_tpu_torch.parallel._spmd.build_replicated_spmd`):

    * expert tables are stored as this rank's slice of their leading
      (expert) dim; every other variable is replicated;
    * the batch shards over ``dcn x data x expert``, the dropout seed is
      folded with the rank's index on those axes, and the loss finds
      the expert axis by name (the builder binds it);
    * expert gradients are scaled by ``1 / E_shards`` (the objective is
      the mean over every token group) and averaged over ``dcn x data``
      only; every other gradient is averaged over ``dcn x data x
      expert``; each set in one flat fp32 all-reduce;
    * a node's PS synchronizer is ZeRO over ``dcn x data x expert`` on a
      replicated variable (its optimizer state, and at stage 3 the
      parameter, stored as a flat shard); on an expert table, whose
      state already shards with it, it degrades to the plain sync
      above and is recorded in ``Lowered.zero_degraded``, as the JAX
      package records it;
    * a node's compressor runs over the same axes, its mean then scaled
      (an expert variable on a mesh without a data axis has nothing to
      sync, as in the JAX package);
    * the ``grad`` precision slot is not applied: the scaled rule above
      is the lowering's own sync, which the JAX lowering keeps over the
      slot's blanket compressor; ``Lowered.unapplied`` records it;
    * metrics are averaged over ``dcn x data x expert``; ``accum_steps``
      microbatches a step.
    """
    from autodist_tpu_torch.parallel._spmd import (build_replicated_spmd,
                                                   policies_from_node_configs)

    plan = make_expert_plan(trainable, strategy, mesh)
    # Bind the dispatch/combine wire election into the trainable's slot;
    # an election without a slot would silently train at fp32.
    slot = getattr(trainable, "moe_a2a", None)
    if slot is not None:
        slot["precision"], slot["kernel"] = plan.precision, plan.kernel
    elif plan.precision or plan.kernel:
        raise ValueError(
            "strategy elects a moe_a2a wire policy "
            f"(precision={plan.precision!r}, a2a_ring={plan.kernel}) but "
            f"trainable {getattr(trainable, 'name', type(trainable).__name__)!r}"
            " has no moe_a2a binding slot (see make_moe_lm_trainable)")
    expert = mesh.axis(const.EXPERT_AXIS)
    sharded = set(plan.expert_vars)
    d_axes = plan.batch_axes[:-1]
    data = mesh.joint_axis(d_axes)          # dcn x data

    def param_spec(name, leaf):
        return (0, expert) if name in sharded else None

    def grad_sync(name, g):
        # None: the builder's joint dcn x data x expert axis.
        return (g / plan.expert_shards, data) if name in sharded \
            else (g, None)

    cfg = strategy.graph_config
    degraded: dict = {}
    policies = policies_from_node_configs(
        strategy, mesh, replicated_axes=plan.batch_axes,
        axes_for=lambda n: d_axes if n in sharded else plan.batch_axes,
        scale_for=lambda n: 1.0 / plan.expert_shards if n in sharded
        else 1.0, sharded_vars=sharded, degraded=degraded)
    return build_replicated_spmd(
        trainable, mesh, sync_axes=plan.batch_axes,
        param_spec_fn=param_spec, grad_sync=grad_sync, policies=policies,
        zero_degraded=degraded, accum=max(cfg.accum_steps, 1),
        precision={k: v for k, v in normalize_precision(cfg.precision)
                   .items() if k != "moe_a2a"},
        plan=plan, device=device)
