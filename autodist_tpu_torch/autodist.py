"""The user-facing facade: ``AutoDist(resource_spec, builder).build(trainable)``.

Counterpart of ``autodist_tpu/autodist.py``: build the strategy, lower
it against the resolved mesh, return the runner.  Every process of a
``torch.distributed`` job builds the same strategy from the same
trainable (the builders are deterministic), so there is no chief/worker
hand-off, no coordination service and no strategy directory;
``strategy.to_json()`` is the JAX package's JSON, to keep as one likes.
"""
from __future__ import annotations

from typing import Optional

from autodist_tpu_torch.kernel.lowering import Lowered, lower
from autodist_tpu_torch.resource import ResourceSpec
from autodist_tpu_torch.runner import DistributedRunner
from autodist_tpu_torch.strategy import builders as _builders
from autodist_tpu_torch.strategy.ir import Strategy


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
        return lower(trainable, strategy, self.mesh, self.device)

    def build(self, trainable, strategy: Optional[Strategy] = None, *,
              seed: int = 0) -> DistributedRunner:
        """Lower and instantiate the runner; ``seed`` seeds its stream
        of per-step dropout seeds."""
        strategy = strategy or self.build_or_load_strategy(trainable)
        runner = DistributedRunner(trainable, self.lower(trainable, strategy),
                                   seed=seed)
        runner.strategy = strategy
        return runner
