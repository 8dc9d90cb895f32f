"""StrategyBuilder base, as ``autodist_tpu/strategy/base.py`` has it:
``build(trainable, resource_spec) -> Strategy``, and the greedy
byte-size bin packing of the load-balancing builders."""
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
        """Data-parallel replica count: the data axis times the ``dcn``
        (cross-slice) axis on multi-slice topologies."""
        shape = resource_spec.resolved_mesh_shape()
        return shape.get(const.DATA_AXIS, 1) * shape.get(const.DCN_AXIS, 1)

    def _graph_config(self, resource_spec) -> GraphConfig:
        shape = resource_spec.resolved_mesh_shape()
        return GraphConfig(replicas=self.num_replicas(resource_spec),
                           mesh_axes=dict(shape))


def greedy_assign(infos, num_bins: int):
    """Greedy bin packing by byte size (at least 1), largest first onto
    the least-loaded bin (ties to the lowest bin, in the order
    ``sorted`` keeps): ``{var_name: bin}``, as the JAX package
    assigns."""
    def load(info):
        return max(info.byte_size, 1)

    loads = [0] * max(num_bins, 1)
    assignment = {}
    for info in sorted(infos, key=load, reverse=True):
        i = loads.index(min(loads))
        assignment[info.name] = i
        loads[i] += load(info)
    return assignment
