"""The GSPMD strategy builders: rule-based mesh sharding of variables,
lowered on DTensor (:mod:`autodist_tpu_torch.kernel.gspmd`).

Counterpart of ``autodist_tpu/strategy/gspmd_builders.py``: the same
rules, the same node configs (a ``PartitionerConfig(spec=...)`` per
matching variable, an AllReduce synchronizer, or PS under ZeRO-1) and
``lowering="gspmd"``, so the two packages' strategies serialize alike.
"""
from __future__ import annotations

import re
from typing import Optional, Sequence

from autodist_tpu_torch import const
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer, NodeConfig,
                                            PartitionerConfig, PSSynchronizer,
                                            Strategy)


class Sharded(StrategyBuilder):
    """Shard variables by ``(regex, per-dim mesh-axis spec)`` rules; the
    first matching rule wins, unmatched variables are replicated (data
    parallelism through the sharded batch).

    ``zero_stage=1`` (alias ``zero1=True``) emits PS synchronizers: the
    lowering shards each such variable's optimizer state over the data
    axes as well (GSPMD ZeRO-1).  Stages 2 and 3 raise: under this
    lowering the sharded-parameter layout is :class:`FSDPSharded`."""

    def __init__(self, rules: Sequence[tuple] = (), *,
                 zero_stage: int = None, zero1: bool = None):
        from autodist_tpu_torch.strategy.parallel_builders import \
            _resolve_zero_stage

        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        stage = _resolve_zero_stage(zero_stage, zero1)
        if stage > 1:
            raise ValueError(
                f"zero_stage={stage} under the gspmd lowering: use "
                "FSDPSharded (the GSPMD-native sharded-parameter layout) "
                "or the pipeline builder's zero_stage knob")
        self.zero1 = bool(stage)

    def spec_for(self, info) -> Optional[list]:
        for pat, spec in self.rules:
            if pat.search(info.name):
                return list(spec)
        return None

    def build(self, trainable, resource_spec):
        nodes = []
        for info in trainable.var_infos():
            node = NodeConfig(var_name=info.name,
                              synchronizer=(PSSynchronizer() if self.zero1
                                            else AllReduceSynchronizer()),
                              is_sparse=info.is_sparse)
            spec = self.spec_for(info)
            if spec is not None:
                if len(spec) != len(info.shape):
                    raise ValueError(
                        f"rule spec {spec} does not match rank of "
                        f"{info.name} {info.shape}")
                node.partitioner = PartitionerConfig(spec=spec)
            nodes.append(node)
        gc = self._graph_config(resource_spec)
        gc.lowering = "gspmd"
        return Strategy(node_configs=nodes, graph_config=gc)


# Megatron rules for the names of the port's transformer and BERT.
TRANSFORMER_TP_RULES = (
    (r"(^|/)qkv/kernel$", [None, None, const.MODEL_AXIS, None]),
    (r"(^|/)out/kernel$", [const.MODEL_AXIS, None, None]),
    (r"(^|/)wi/kernel$", [None, const.MODEL_AXIS]),
    (r"(^|/)wo/kernel$", [const.MODEL_AXIS, None]),
    (r"(^|/)(token_embed|embedding)/embedding$", [const.MODEL_AXIS, None]),
)


class TensorParallel(Sharded):
    """Megatron tensor parallelism for the bundled transformer stack;
    ``extra_rules`` go before the defaults."""

    def __init__(self, extra_rules: Sequence[tuple] = (), *,
                 zero_stage: int = None, zero1: bool = None):
        super().__init__(tuple(extra_rules) + TRANSFORMER_TP_RULES,
                         zero_stage=zero_stage, zero1=zero1)


class FSDPSharded(Sharded):
    """GSPMD-native FSDP: dim 0 of every variable of at least
    ``min_size`` elements (and at least 2 rows) sharded over the data
    axis."""

    def __init__(self, min_size: int = 1024):
        super().__init__(())
        self.min_size = min_size

    def spec_for(self, info):
        if info.size >= self.min_size and info.shape \
                and info.shape[0] >= 2:
            return [const.DATA_AXIS] + [None] * (len(info.shape) - 1)
        return None
