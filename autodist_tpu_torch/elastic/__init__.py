"""Elastic resharding: restore a checkpoint onto another mesh, survive a
preemption, swap strategies live.

The port's counterpart of ``autodist_tpu/elastic/``: every full
:class:`~autodist_tpu_torch.checkpoint.saver.Saver` save carries a
sidecar (the Strategy JSON, the mesh and the state-codec manifest);
:mod:`~autodist_tpu_torch.elastic.reshard` moves state between any two
layouts of the same trainable and optimizer, one leaf at a time;
:mod:`~autodist_tpu_torch.elastic.controller` drives the preemption ->
checkpoint -> resume loop and the live hot swap.
"""
from autodist_tpu_torch.elastic.reshard import (ReshardError,  # noqa: F401
                                                ReshardPlan, apply_ops,
                                                assemble_state, invert_ops,
                                                plan_reshard, reshard_state,
                                                shard_budget)
from autodist_tpu_torch.elastic.controller import (  # noqa: F401
    ElasticController)

__all__ = ["ReshardError", "ReshardPlan", "apply_ops", "assemble_state",
           "invert_ops", "plan_reshard", "reshard_state", "shard_budget",
           "ElasticController"]
