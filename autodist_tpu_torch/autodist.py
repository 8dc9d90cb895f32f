"""The user-facing facade: ``AutoDist(resource_spec, builder).build(trainable)``.

Counterpart of ``autodist_tpu/autodist.py``: build the strategy, lower
it against the resolved mesh, return the runner.  Every process of a
``torch.distributed`` job builds the same strategy from the same
trainable (the builders are deterministic), so there is no chief/worker
strategy hand-off and no strategy directory; ``strategy.to_json()`` is
the JAX package's JSON, to keep as one likes.  A strategy with an
asynchronous PS node (``PS(sync=False)``) builds an
:class:`~autodist_tpu_torch.runner.AsyncPSRunner`, whose workers push
gradients to a parameter server over the coordination service
(:mod:`autodist_tpu_torch.runtime.coordination`); a stale-synchronous
one (``PS(staleness=s)``) a
:class:`~autodist_tpu_torch.runner.DistributedRunner` whose ``step``
waits at the SSP gate.
"""
from __future__ import annotations

from typing import Optional

from autodist_tpu_torch.kernel.lowering import Lowered, Plan, lower
from autodist_tpu_torch.parallel._spmd import ssp_staleness_from
from autodist_tpu_torch.resource import ResourceSpec
from autodist_tpu_torch.runner import AsyncPSRunner, DistributedRunner
from autodist_tpu_torch.strategy import builders as _builders
from autodist_tpu_torch.strategy.ir import PSSynchronizer, Strategy


class AutoDist:
    """Entry object: ``AutoDist(resource_spec, strategy_builder)`` then
    ``build(trainable)`` -> runner.  The builder defaults to
    ``PSLoadBalancing()``; a builder's name takes its keyword arguments
    (``AutoDist(spec, "AllReduce", chunk_size=256)``).  ``device=None``
    runs on the card (this process's current CUDA device); pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU."""

    def __init__(self, resource_spec=None, strategy_builder=None, *,
                 device=None, **builder_kwargs):
        if not isinstance(resource_spec, ResourceSpec):
            resource_spec = ResourceSpec(resource_spec)
        if strategy_builder is None:
            strategy_builder = _builders.PSLoadBalancing()
        elif isinstance(strategy_builder, str):
            strategy_builder = _builders.create(strategy_builder,
                                                **builder_kwargs)
        self.resource_spec = resource_spec
        self.strategy_builder = strategy_builder
        self.device = device
        self._mesh = None

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = self.resource_spec.make_mesh()
        return self._mesh

    def build_or_load_strategy(self, trainable) -> Strategy:
        return self.strategy_builder.build(trainable, self.resource_spec)

    def lower(self, trainable, strategy: Optional[Strategy] = None) -> Lowered:
        strategy = strategy or self.build_or_load_strategy(trainable)
        lowered = lower(trainable, strategy, self.mesh, self.device)
        # The SSP bound, stamped once here for every lowering: a
        # lowering added later gets the host gate without having to
        # remember it.
        lowered.ssp_staleness = ssp_staleness_from(strategy)
        if isinstance(lowered.plan, Plan):
            lowered.plan.ssp_staleness = lowered.ssp_staleness
        return lowered

    def build(self, trainable, strategy: Optional[Strategy] = None, *,
              seed: int = 0, **runner_kwargs):
        """Lower and instantiate the runner; ``seed`` seeds its stream
        of per-step dropout seeds, ``runner_kwargs`` go to the runner
        (``ssp_worker=``, ``ssp_num_workers=``; the asynchronous
        runner's ``is_chief=``, ``publish_max_lag=``, ...).

        A strategy with any ``PS(sync=False)`` node builds an
        :class:`~autodist_tpu_torch.runner.AsyncPSRunner` at the largest
        staleness of those nodes (host-side push and pull: asynchrony
        is not one synchronous program); every other strategy a
        :class:`~autodist_tpu_torch.runner.DistributedRunner`."""
        strategy = strategy or self.build_or_load_strategy(trainable)
        async_nodes = [nc for nc in strategy.node_configs
                       if isinstance(nc.synchronizer, PSSynchronizer)
                       and not nc.synchronizer.sync]
        if async_nodes:
            runner = AsyncPSRunner(
                trainable, staleness=max(nc.synchronizer.staleness
                                         for nc in async_nodes),
                seed=seed, device=self.device, **runner_kwargs)
        else:
            runner = DistributedRunner(trainable,
                                       self.lower(trainable, strategy),
                                       seed=seed, **runner_kwargs)
        runner.strategy = strategy
        return runner
