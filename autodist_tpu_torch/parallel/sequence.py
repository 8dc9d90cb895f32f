"""Sequence parallelism: train with the sequence dim sharded over ``seq``.

Counterpart of ``autodist_tpu/parallel/sequence.py``.  The ``seq`` mesh
axis shards activations along the token dimension; ring attention
(:mod:`autodist_tpu_torch.parallel.ring_attention`) rotates key/value
blocks around the axis so every token still attends globally, the
model positions its tokens with :func:`global_positions`, and gradients
are averaged over ``data x seq``: each rank's gradient of its local
token-mean loss averages to the whole sequence's objective when the
chunks are equal.

The step is the shared replicated-parameter one
(:func:`~autodist_tpu_torch.parallel._spmd.build_replicated_spmd`):
parameters replicate, token-dimension batch leaves split along dims 0
and 1 over ``(data, seq)``, other leaves along dim 0 over ``data``,
scalars go whole.  Long-context recipe::

    cfg = TransformerConfig(
        attention_fn=make_ring_flash_attention_fn(causal=True),
        position_fn=global_positions, ...)
    runner = AutoDist({"mesh": {"data": d, "seq": s}},
                      SequenceParallel()).build(make_lm_trainable(cfg, ...))
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.axis import bound_axis
from autodist_tpu_torch.strategy.ir import normalize_precision


def global_positions(local_len: int, *, seq_axis: str = const.SEQ_AXIS,
                     max_len: Optional[int] = None, device=None):
    """The global token positions of this rank's sequence chunk, on
    ``device``: what a sequence-parallel model feeds its positional
    embedding (a local ``arange`` would restart at 0 on every rank).

    ``max_len`` (the positional table's size) turns on the JAX
    package's static check that the global sequence ``shards x
    local_len`` fits the table: a table too small fails here instead of
    through :class:`~autodist_tpu_torch.models.transformer
    .TransformerLM`'s NaN guard."""
    axis = bound_axis(seq_axis)
    if max_len is not None and axis.size * local_len > max_len:
        raise ValueError(
            f"positional table max_len={max_len} does not cover the "
            f"global sequence: {axis.size} seq shards x {local_len} local "
            f"tokens = {axis.size * local_len}")
    return axis.index * local_len + torch.arange(local_len, device=device)


def _build_sequence(trainable, mesh, *, seq_leaves: Sequence[str],
                    seq_axis: str, data_axis: str, accum: int = 1,
                    policies=None, unapplied=None, precision=None,
                    plan=None, device=None):
    """The placement of both entries (the direct API and the strategy
    lowering) on the shared builder: a
    :class:`~autodist_tpu_torch.kernel.lowering.Lowered`."""
    from autodist_tpu_torch.parallel._spmd import build_replicated_spmd

    if seq_axis not in mesh.shape:
        raise ValueError(f"mesh {dict(mesh.shape)} has no {seq_axis!r} axis")
    has_data = data_axis in mesh.shape
    seq, data = mesh.axis(seq_axis), mesh.axis(data_axis)
    sync_axes = ((data_axis,) if has_data else ()) + (seq_axis,)

    def batch_spec_fn(batch) -> dict:
        matched = [name for name in batch
                   if name.split("/")[-1] in seq_leaves]
        if not matched:
            # Every leaf whole along seq would make ring attention treat
            # identical copies as distinct chunks: a wrong objective with
            # no error.  Demand an explicit match.
            raise ValueError(
                f"no batch leaf matches seq_leaves={tuple(seq_leaves)}; "
                "name the token-dimension leaves explicitly")
        return {name: ((0, data), (1, seq)) if name in matched
                else ((0, data),) for name in batch}

    return build_replicated_spmd(
        trainable, mesh, sync_axes=sync_axes, batch_spec_fn=batch_spec_fn,
        policies=policies, unapplied=unapplied, accum=accum,
        precision=precision, plan=plan, device=device)


def lower_sequence_parallel(trainable, mesh, *,
                            seq_leaves: Sequence[str] = ("x", "y"),
                            seq_axis: str = const.SEQ_AXIS,
                            data_axis: str = const.DATA_AXIS, device=None):
    """The train step with sequences sharded over ``seq_axis``, on
    ``device`` (``None``: the card): ``seq_leaves`` names the batch
    keys with a ``[B, L, ...]`` token dimension (split over both axes);
    other leaves split over the data axis only (scalars go whole).
    Parameters and optimizer state replicate; gradients average over
    ``data x seq``.  The model must attend globally through ring
    attention and position with :func:`global_positions`.  Returns the
    :class:`~autodist_tpu_torch.kernel.lowering.Lowered` step (for a
    runner: ``DistributedRunner(trainable, lowered)``)."""
    return _build_sequence(trainable, mesh, seq_leaves=tuple(seq_leaves),
                           seq_axis=seq_axis, data_axis=data_axis,
                           device=device)


def lower_sequence_ir(trainable, strategy, mesh, device=None):
    """The strategy entry: lower a ``lowering == "sequence"`` strategy
    (built by :class:`~autodist_tpu_torch.strategy.parallel_builders
    .SequenceParallel`), the form that flows through ``AutoDist.build``.
    Every variable is replicated across ``data x seq``, so a node's PS
    synchronizer is ZeRO over both axes (the largest sharding of its
    optimizer state, and at stage 3 of the parameter) and a compressor
    (or the ``grad`` slot's) averages over them; the ``zero3_gather``
    slot narrows the ZeRO-3 gathers.  The slots this lowering has no
    boundary for (``tp_psum``, ``vocab_stats``, ``moe_a2a``) are
    recorded on the ``Lowered`` as unapplied, where the JAX package
    leaves them unused."""
    from autodist_tpu_torch.parallel._spmd import policies_from_node_configs

    cfg = strategy.graph_config
    seq_axis = cfg.parallel.get("seq_axis", const.SEQ_AXIS)
    d_axes = (const.DATA_AXIS,) if const.DATA_AXIS in mesh.shape else ()
    precision = normalize_precision(cfg.precision)
    unapplied = {slot: "no such boundary in the sequence lowering"
                 for slot in precision
                 if slot not in ("grad", "zero3_gather")}
    # Nothing is stored sharded here, so no ZeRO request degrades.
    policies = policies_from_node_configs(
        strategy, mesh, replicated_axes=(*d_axes, seq_axis), degraded={})
    return _build_sequence(
        trainable, mesh,
        seq_leaves=tuple(cfg.parallel.get("seq_leaves", ("x", "y"))),
        seq_axis=seq_axis, data_axis=const.DATA_AXIS,
        accum=max(cfg.accum_steps, 1), policies=policies,
        unapplied=unapplied, precision=precision, plan=strategy,
        device=device)
