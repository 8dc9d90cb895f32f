"""The strategy builder catalog: ``AllReduce``, ``Pipeline``,
``ExpertParallel`` and ``SequenceParallel`` so far.

Counterpart of ``autodist_tpu/strategy/builders.py``.  ``AllReduce``
emits the same node configs as the JAX builder (variable ``i`` in
bucket ``i // chunk_size``), so the two packages' strategies for the
same model serialize alike; ``Pipeline``, ``ExpertParallel`` and
``SequenceParallel`` live in
:mod:`~autodist_tpu_torch.strategy.parallel_builders`.  Gradient
compressors and the other builders raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer, NodeConfig,
                                            Strategy)
from autodist_tpu_torch.strategy.parallel_builders import (ExpertParallel,
                                                           Pipeline,
                                                           SequenceParallel)

# Builders of the JAX package and where the port brings them.
NOT_PORTED = {
    **{name: "ROADMAP Queue 1, item 8: the rest of the data-parallel zoo"
       for name in ("PS", "PSLoadBalancing", "PartitionedPS",
                    "UnevenPartitionedPS", "PartitionedAR",
                    "RandomAxisPartitionAR", "Parallax", "GradAccumulation",
                    "ZeRO", "Sharded", "TensorParallel", "FSDPSharded")},
    "AutoStrategy": "ROADMAP Queue 1, item 10: simulator and plan lint",
}


class AllReduce(StrategyBuilder):
    """Dense all-reduce with bucketing (reference
    ``all_reduce_strategy.py:21-91``)."""

    def __init__(self, chunk_size=128, compressor="none"):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if compressor not in ("none", "", None):
            raise NotImplementedError(
                f"gradient compressor {compressor!r} is not ported yet "
                f"(ROADMAP Queue 1, slice 2 leftovers: compressors)")
        self.chunk_size = chunk_size
        self.compressor = "none"

    def build(self, trainable, resource_spec):
        nodes = [NodeConfig(var_name=info.name,
                            synchronizer=AllReduceSynchronizer(
                                compressor=self.compressor,
                                group=idx // self.chunk_size),
                            is_sparse=info.is_sparse)
                 for idx, info in enumerate(trainable.var_infos())]
        return Strategy(node_configs=nodes,
                        graph_config=self._graph_config(resource_spec))


BUILDERS = {"AllReduce": AllReduce, "Pipeline": Pipeline,
            "ExpertParallel": ExpertParallel,
            "SequenceParallel": SequenceParallel}


def create(name: str, **kw) -> StrategyBuilder:
    """Builder factory by name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"strategy builder {name!r} is not ported yet ({NOT_PORTED[name]})")
    if name not in BUILDERS:
        raise ValueError(f"unknown strategy builder {name!r}; have "
                         f"{sorted(BUILDERS) + sorted(NOT_PORTED)}")
    return BUILDERS[name](**kw)
