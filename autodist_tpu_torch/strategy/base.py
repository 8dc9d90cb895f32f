"""StrategyBuilder base, as ``autodist_tpu/strategy/base.py`` has it:
``build(trainable, resource_spec) -> Strategy``."""
from __future__ import annotations

import abc

from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.ir import GraphConfig, Strategy


class StrategyBuilder(abc.ABC):
    """Base for all strategy builders."""

    @abc.abstractmethod
    def build(self, trainable, resource_spec) -> Strategy:
        ...

    @staticmethod
    def num_replicas(resource_spec) -> int:
        """Data-parallel replica count: the data axis."""
        return resource_spec.resolved_mesh_shape().get(const.DATA_AXIS, 1)

    def _graph_config(self, resource_spec) -> GraphConfig:
        shape = resource_spec.resolved_mesh_shape()
        return GraphConfig(replicas=self.num_replicas(resource_spec),
                           mesh_axes=dict(shape))
