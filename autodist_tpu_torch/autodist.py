"""The user-facing facade: ``AutoDist(resource_spec, builder).build(trainable)``.

Counterpart of ``autodist_tpu/autodist.py``: build the strategy, lower
it against the resolved mesh, return the runner.  In a job that a
:class:`~autodist_tpu_torch.runtime.cluster.Cluster` launched, the
chief (no ``AUTODIST_TPU_WORKER``) builds the strategy and publishes it
on the coordination service as ``strategy/<id>``; a worker launched
with ``AUTODIST_TPU_STRATEGY_ID`` loads that strategy with a blocking
get instead of building its own (the JAX hand-off without the strategy
directory: the port has none, so a worker with no service raises).
The hand-off is taken once: it is the strategy of the worker's first
build, as the launch meant; every later build in the process (a resume
or a hot swap onto another builder) builds from its own builder.
Elsewhere every process builds the same strategy from the same
trainable (the builders are deterministic).  A strategy whose
``graph_config.mesh_axes`` factor the same world in another way lowers
on that factorization (:meth:`AutoDist._mesh_for`).

A strategy with an asynchronous PS node (``PS(sync=False)``) builds an
:class:`~autodist_tpu_torch.runner.AsyncPSRunner`, whose workers push
gradients to a parameter server over the coordination service
(:mod:`autodist_tpu_torch.runtime.coordination`); a stale-synchronous
one (``PS(staleness=s)``) a
:class:`~autodist_tpu_torch.runner.DistributedRunner` whose ``step``
waits at the SSP gate.
"""
from __future__ import annotations

import math
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel.lowering import Lowered, Plan, lower
from autodist_tpu_torch.parallel._spmd import ssp_staleness_from
from autodist_tpu_torch.resource import ResourceSpec
from autodist_tpu_torch.runner import AsyncPSRunner, DistributedRunner
from autodist_tpu_torch.strategy import builders as _builders
from autodist_tpu_torch.strategy.ir import PSSynchronizer, Strategy
from autodist_tpu_torch.utils import logging

# The launch-time strategy ids this process has loaded (each is taken
# once; see the module docstring).
_HANDED_OFF: set = set()


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
        self._mesh_cache: dict = {}

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = self.resource_spec.make_mesh()
        return self._mesh

    def _mesh_for(self, strategy: Strategy):
        """The mesh ``strategy`` lowers on: the spec's, unless the
        strategy's ``graph_config.mesh_axes`` factor the same world
        another way (an elected candidate, or a chief's hand-off of
        one); a record that does not factor the world falls back to the
        spec's mesh."""
        declared = dict(strategy.graph_config.mesh_axes or {})
        if declared:
            try:
                resolved = self.resource_spec.resolved_mesh_shape()
                n = self.resource_spec.num_devices()
            except (ValueError, RuntimeError):
                resolved = None
            if (resolved is not None and declared != resolved
                    and all(isinstance(v, int) and v > 0
                            for v in declared.values())
                    and math.prod(declared.values()) == n):
                key = tuple(declared.items())
                if key not in self._mesh_cache:
                    self._mesh_cache[key] = self.resource_spec.with_mesh(
                        declared).make_mesh()
                return self._mesh_cache[key]
        return self.mesh

    def build_or_load_strategy(self, trainable) -> Strategy:
        """The chief builds the strategy and publishes it on the
        coordination service (when one is configured); a worker with
        ``AUTODIST_TPU_STRATEGY_ID`` loads the chief's by a blocking
        get (60 s) the first time, and builds from its builder after."""
        from autodist_tpu_torch.runtime import coordination

        strategy_id = const.ENV.AUTODIST_TPU_STRATEGY_ID.val
        is_chief = not const.ENV.AUTODIST_TPU_WORKER.val
        client = coordination.service_client()
        if not is_chief and strategy_id and strategy_id not in _HANDED_OFF:
            if client is None:
                raise RuntimeError(
                    f"worker {const.ENV.AUTODIST_TPU_WORKER.val!r} was "
                    f"launched with strategy {strategy_id!r} but no "
                    "coordination service (AUTODIST_TPU_COORD_SERVICE): "
                    "the port has no strategy directory to load it from")
            data = client.get(f"strategy/{strategy_id}", timeout_ms=60000)
            if not data:
                raise TimeoutError(f"strategy/{strategy_id} was not "
                                   "published on the coordination service")
            _HANDED_OFF.add(strategy_id)
            return Strategy.from_json(data.decode())
        strategy = self.strategy_builder.build(trainable, self.resource_spec)
        if is_chief and client is not None:
            try:
                client.put(f"strategy/{strategy.id}",
                           strategy.to_json().encode())
            except OSError as e:
                logging.warning("could not publish strategy %s on the "
                                "coordination service (%s)", strategy.id, e)
        return strategy

    def lower(self, trainable, strategy: Optional[Strategy] = None) -> Lowered:
        strategy = strategy or self.build_or_load_strategy(trainable)
        lowered = lower(trainable, strategy, self._mesh_for(strategy),
                        self.device)
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
