"""The strategy builder catalog: the data-parallel zoo, ``Pipeline``,
``ExpertParallel`` and ``SequenceParallel``.

Counterpart of ``autodist_tpu/strategy/builders.py``.  Every builder
emits the node configs the JAX builder emits for the same trainable
and resource spec (bucket groups, shard tags, partition strings, random
axes), so the two packages' strategies serialize alike:

==========================  ==========================================
builder                     lowering (:mod:`~autodist_tpu_torch.kernel
                            .lowering`)
==========================  ==========================================
PS, PSLoadBalancing         ZeRO-1: each rank owns a flat ``1/n`` of
                            every gradient and of the optimizer state;
                            updated parameters all-gathered
PartitionedPS,              FSDP: parameters stored split along dim 0,
UnevenPartitionedPS         gathered on use (a sparse table: touched
                            rows only)
AllReduce                   bucketed mean, optionally compressed
PartitionedAR,              ZeRO-2: gradients reduce-scattered along a
RandomAxisPartitionAR       dim, sharded update, parameters gathered
Parallax                    dense variables AllReduce, sparse ones
                            PartitionedPS on the vocabulary dim
GradAccumulation            any of them over ``steps`` microbatches
ZeRO                        stage 1 PS, 2 PartitionedAR, 3
                            PartitionedPS
==========================  ==========================================

``Pipeline``, ``ExpertParallel`` and ``SequenceParallel`` live in
:mod:`~autodist_tpu_torch.strategy.parallel_builders`, ``Sharded``,
``TensorParallel`` and ``FSDPSharded`` in
:mod:`~autodist_tpu_torch.strategy.gspmd_builders`; ``AutoStrategy``
raises ``NotImplementedError`` naming its ROADMAP item.
"""
from __future__ import annotations

import hashlib

from autodist_tpu_torch.strategy.base import StrategyBuilder, greedy_assign
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer, NodeConfig,
                                            PartitionerConfig, PSSynchronizer,
                                            Strategy)
from autodist_tpu_torch.strategy.gspmd_builders import (FSDPSharded,
                                                        Sharded,
                                                        TensorParallel)
from autodist_tpu_torch.strategy.parallel_builders import (ExpertParallel,
                                                           Pipeline,
                                                           SequenceParallel)

# Builders of the JAX package and where the port brings them.
NOT_PORTED = {
    "AutoStrategy": "ROADMAP Queue 1, item 10: simulator and plan lint",
}


def _partition_str(shape, axis: int, num_shards: int) -> str:
    parts = ["1"] * max(len(shape), 1)
    parts[axis] = str(num_shards)
    return ",".join(parts)


class PS(StrategyBuilder):
    """Every variable synchronized PS-style (reference
    ``ps_strategy.py:21-77``)."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0):
        self.local_proxy_variable = local_proxy_variable
        self.sync = sync
        self.staleness = staleness

    def _node(self, info, dest: str = "") -> NodeConfig:
        return NodeConfig(
            var_name=info.name,
            synchronizer=PSSynchronizer(
                reduction_destination=dest,
                local_replication=self.local_proxy_variable,
                sync=self.sync, staleness=self.staleness),
            is_sparse=info.is_sparse)

    def build(self, trainable, resource_spec):
        return Strategy(node_configs=[self._node(i)
                                      for i in trainable.var_infos()],
                        graph_config=self._graph_config(resource_spec))


class PSLoadBalancing(PS):
    """PS with greedy byte-size load balancing (reference
    ``ps_lb_strategy.py:23-117``); the bin becomes the
    ``reduction_destination`` tag, provenance only: the ZeRO-1 lowering
    spreads every variable evenly over the ranks."""

    def build(self, trainable, resource_spec):
        infos = trainable.var_infos()
        assignment = greedy_assign(infos, self.num_replicas(resource_spec))
        return Strategy(
            node_configs=[self._node(i, dest=f"shard:{assignment[i.name]}")
                          for i in infos],
            graph_config=self._graph_config(resource_spec))


class PartitionedPS(PSLoadBalancing):
    """Axis-partitioned PS, FSDP (reference
    ``partitioned_ps_strategy.py:28-135``): a variable whose
    ``split_axis`` has 2 or more entries is stored split over the data
    axis; the rest take flat PS."""

    def __init__(self, local_proxy_variable=False, sync=True, staleness=0,
                 split_axis=0):
        super().__init__(local_proxy_variable, sync, staleness)
        self.split_axis = split_axis

    def num_shards(self, info, n: int) -> int:
        if not info.shape or len(info.shape) <= self.split_axis:
            return 1
        if info.shape[self.split_axis] < 2:
            return 1
        return n

    def build(self, trainable, resource_spec):
        n = self.num_replicas(resource_spec)
        infos = trainable.var_infos()
        assignment = greedy_assign(infos, n)
        nodes = []
        for info in infos:
            node = self._node(info, dest=f"shard:{assignment[info.name]}")
            shards = self.num_shards(info, n)
            if shards > 1:
                node.partitioner = PartitionerConfig(
                    partition_str=_partition_str(info.shape, self.split_axis,
                                                 shards))
            nodes.append(node)
        return Strategy(node_configs=nodes,
                        graph_config=self._graph_config(resource_spec))


class UnevenPartitionedPS(PartitionedPS):
    """The reference's uneven shard count (the smallest non-divisor of
    dim 0 from 2, ``uneven_partition_ps_strategy.py:126-135``) recorded
    in the strategy; the lowering splits over the data axis all the
    same, the last shard padded."""

    def num_shards(self, info, n: int) -> int:
        if not info.shape or len(info.shape) <= self.split_axis:
            return 1
        dim = info.shape[self.split_axis]
        if dim < 2:
            return 1
        for i in range(2, dim):
            if dim % i:
                return i
        return dim


class AllReduce(StrategyBuilder):
    """Dense all-reduce with bucketing and an optional compressor
    (reference ``all_reduce_strategy.py:21-91``): variable ``i`` in
    bucket ``i // chunk_size``."""

    def __init__(self, chunk_size=128, compressor="none"):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = chunk_size
        self.compressor = compressor

    def build(self, trainable, resource_spec):
        nodes = [NodeConfig(var_name=info.name,
                            synchronizer=AllReduceSynchronizer(
                                compressor=self.compressor,
                                group=idx // self.chunk_size),
                            is_sparse=info.is_sparse)
                 for idx, info in enumerate(trainable.var_infos())]
        return Strategy(node_configs=nodes,
                        graph_config=self._graph_config(resource_spec))


class PartitionedAR(StrategyBuilder):
    """Partition, then all-reduce each shard: the gradient
    reduce-scattered along ``split_axis``, ZeRO-2 (reference
    ``partitioned_all_reduce_strategy.py:25-130``)."""

    def __init__(self, chunk_size=128, compressor="none", split_axis=0):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = chunk_size
        self.compressor = compressor
        self.split_axis = split_axis

    def _choose_axis(self, info) -> int:
        if info.shape and len(info.shape) > self.split_axis \
                and info.shape[self.split_axis] >= 2:
            return self.split_axis
        return -1

    def build(self, trainable, resource_spec):
        n = self.num_replicas(resource_spec)
        nodes = []
        for idx, info in enumerate(trainable.var_infos()):
            axis = self._choose_axis(info)
            node = NodeConfig(
                var_name=info.name,
                synchronizer=AllReduceSynchronizer(
                    compressor=self.compressor,
                    group=idx // self.chunk_size),
                is_sparse=info.is_sparse)
            if axis >= 0 and n > 1:
                node.partitioner = PartitionerConfig(
                    partition_str=_partition_str(info.shape, axis, n))
            nodes.append(node)
        return Strategy(node_configs=nodes,
                        graph_config=self._graph_config(resource_spec))


class RandomAxisPartitionAR(PartitionedAR):
    """PartitionedAR on a per-variable random dim of 2 or more entries
    (reference ``random_axis_partition_all_reduce_strategy.py:26-141``),
    drawn from ``md5(f"{seed}:{name}")`` so every process agrees."""

    def __init__(self, chunk_size=128, compressor="none", seed=0):
        super().__init__(chunk_size, compressor)
        self.seed = seed

    def _choose_axis(self, info) -> int:
        cand = [i for i, d in enumerate(info.shape) if d >= 2]
        if not cand:
            return -1
        h = int(hashlib.md5(f"{self.seed}:{info.name}".encode()).hexdigest(),
                16)
        return cand[h % len(cand)]


class Parallax(StrategyBuilder):
    """Hybrid (reference ``parallax_strategy.py:24-71``): dense
    variables AllReduce, sparse ones a PS partitioned on the vocabulary
    dim, their lookups moving touched rows only."""

    def __init__(self, chunk_size=128, compressor="none",
                 local_proxy_variable=False, sync=True, staleness=0):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.chunk_size = chunk_size
        self.compressor = compressor
        self.local_proxy_variable = local_proxy_variable
        self.sync = sync
        self.staleness = staleness

    def build(self, trainable, resource_spec):
        n = self.num_replicas(resource_spec)
        infos = trainable.var_infos()
        assignment = greedy_assign([i for i in infos if i.is_sparse], n)
        nodes, dense_idx = [], 0
        for info in infos:
            if info.is_sparse:
                node = NodeConfig(
                    var_name=info.name,
                    synchronizer=PSSynchronizer(
                        reduction_destination=f"shard:{assignment[info.name]}",
                        local_replication=self.local_proxy_variable,
                        sync=self.sync, staleness=self.staleness),
                    is_sparse=True)
                if info.shape and info.shape[0] >= 2 and n > 1:
                    node.partitioner = PartitionerConfig(
                        partition_str=_partition_str(info.shape, 0, n))
            else:
                node = NodeConfig(
                    var_name=info.name,
                    synchronizer=AllReduceSynchronizer(
                        compressor=self.compressor,
                        group=dense_idx // self.chunk_size))
                dense_idx += 1
            nodes.append(node)
        return Strategy(node_configs=nodes,
                        graph_config=self._graph_config(resource_spec))


class GradAccumulation(StrategyBuilder):
    """Any builder over ``steps`` microbatches a step: the gradients of
    this rank's batch slices averaged before the one synchronization
    and optimizer update."""

    def __init__(self, builder=None, steps: int = 2):
        if steps < 1:
            raise ValueError("accumulation steps must be >= 1")
        if builder is None:
            builder = PSLoadBalancing()        # the AutoDist default
        elif isinstance(builder, str):
            builder = create(builder)
        self.builder = builder
        self.steps = steps

    def build(self, trainable, resource_spec):
        strategy = self.builder.build(trainable, resource_spec)
        strategy.graph_config.accum_steps = self.steps
        return strategy


class ZeRO(StrategyBuilder):
    """Weight-update sharding by stage: 1 PS (optimizer state), 2
    PartitionedAR (gradients), 3 PartitionedPS (parameters)."""

    def __init__(self, stage=1, **kw):
        if stage not in (1, 2, 3):
            raise ValueError("ZeRO stage must be 1, 2 or 3")
        self._impl = {1: PS, 2: PartitionedAR, 3: PartitionedPS}[stage](**kw)

    def build(self, trainable, resource_spec):
        return self._impl.build(trainable, resource_spec)


BUILDERS = {
    "PS": PS,
    "PSLoadBalancing": PSLoadBalancing,
    "PartitionedPS": PartitionedPS,
    "UnevenPartitionedPS": UnevenPartitionedPS,
    "AllReduce": AllReduce,
    "PartitionedAR": PartitionedAR,
    "RandomAxisPartitionAR": RandomAxisPartitionAR,
    "Parallax": Parallax,
    "ZeRO": ZeRO,
    "GradAccumulation": GradAccumulation,
    "Pipeline": Pipeline,
    "ExpertParallel": ExpertParallel,
    "SequenceParallel": SequenceParallel,
    "Sharded": Sharded,
    "TensorParallel": TensorParallel,
    "FSDPSharded": FSDPSharded,
}


def create(name: str, **kw) -> StrategyBuilder:
    """Builder factory by name."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"strategy builder {name!r} is not ported yet ({NOT_PORTED[name]})")
    if name not in BUILDERS:
        raise ValueError(f"unknown strategy builder {name!r}; have "
                         f"{sorted(BUILDERS) + sorted(NOT_PORTED)}")
    return BUILDERS[name](**kw)
