"""The Strategy IR: the serializable distribution strategy.

Counterpart of ``autodist_tpu/strategy/ir.py``.  Ported:

* the serving engine's normalizers (``normalize_kernel``,
  ``normalize_kv_layout``, ``normalize_prefill_chunk``,
  ``normalize_prefix_caching``, ``normalize_speculative``), with the
  same canonical forms and the same errors;
* the core of the IR: :class:`AllReduceSynchronizer`,
  :class:`PSSynchronizer`, :class:`PartitionerConfig` (the
  data-parallel zoo's single-axis ``partition_str`` form and the
  mesh-axis ``spec`` form the ``Pipeline`` builder writes),
  :class:`NodeConfig`, :class:`GraphConfig` with the per-collective
  precision policy (:func:`normalize_precision`) and the kernel slot,
  and :class:`Strategy`, whose JSON is the JAX package's byte for byte
  (same keys, same order, same ``indent=1``), so a strategy either
  package writes reads back in the other.

A ``PSSynchronizer`` with ``sync=False`` or ``staleness > 0`` reads
back; the lowering refuses it (:data:`ASYNC_PS_ITEM`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel import KERNEL_CHOICES
from autodist_tpu_torch.kernel.quantize import (PRECISIONS,
                                                UnknownPrecisionError)


class UnknownKernelError(ValueError):
    """A kernel name outside :data:`~autodist_tpu_torch.kernel
    .KERNEL_CHOICES`."""


def normalize_kernel(policy) -> dict:
    """Canonicalize a fused-kernel election.

    ``None``/``{}``/``False``/``""`` -> ``{}``; ``True``/``"all"``
    elects every kernel; a bare name or an iterable of names elects
    those; a dict keeps only truthy entries.  The canonical form maps
    each elected name to ``True``.  Unknown names raise
    :class:`UnknownKernelError`.
    """
    if policy in (None, False, "", {}, (), []):
        return {}
    if policy is True or policy == "all":
        return {k: True for k in KERNEL_CHOICES}
    if isinstance(policy, str):
        policy = (policy,)
    if isinstance(policy, dict):
        names = [k for k, v in policy.items() if v]
    elif isinstance(policy, (list, tuple, set, frozenset)):
        names = list(policy)
    else:
        raise UnknownKernelError(
            f"kernel election must be a name, an iterable of names, or "
            f"a name->bool dict; got {type(policy).__name__}")
    out = {}
    for name in names:
        if name not in KERNEL_CHOICES:
            raise UnknownKernelError(
                f"unknown kernel {name!r}; expected one of "
                f"{list(KERNEL_CHOICES)}")
        out[name] = True
    return {k: True for k in KERNEL_CHOICES if k in out}


KV_LAYOUTS = ("dense", "paged")


class UnknownKVLayoutError(ValueError):
    """A kv_layout outside :data:`KV_LAYOUTS`."""


def normalize_kv_layout(value) -> str:
    """``None``/``""`` -> ``"dense"``; unknown names raise
    :class:`UnknownKVLayoutError`."""
    if value in (None, ""):
        return "dense"
    if value not in KV_LAYOUTS:
        raise UnknownKVLayoutError(
            f"unknown kv_layout {value!r}; expected one of "
            f"{list(KV_LAYOUTS)}")
    return str(value)


def normalize_prefill_chunk(value):
    """``None``/``0``/``False`` -> ``None`` (single-shot prefill); a
    positive int is the chunk length in tokens.  Anything else raises
    ``ValueError``."""
    if value in (None, 0, False, ""):
        return None
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(
            f"prefill_chunk must be None or a positive int (tokens per "
            f"prefill chunk); got {value!r}")
    return int(value)


def normalize_prefix_caching(value) -> bool:
    """Truthy -> ``True``, anything falsy -> ``False``."""
    return bool(value)


def normalize_speculative(value):
    """``None``/``0``/``False`` -> ``None`` (vanilla decode); a positive
    int is the number of draft tokens per verify step.  Anything else
    raises ``ValueError``."""
    if value in (None, 0, False, ""):
        return None
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ValueError(
            f"speculative must be None or a positive int (draft tokens "
            f"per verify step); got {value!r}")
    return int(value)


# The collective boundary classes a precision policy names, in the JAX
# package's order: dp gradient sync, tensor-parallel activation sums,
# vocab-epilogue statistics, ZeRO-3 gathers, MoE all-to-alls.
PRECISION_BOUNDARIES = ("grad", "tp_psum", "vocab_stats", "zero3_gather",
                        "moe_a2a")


def normalize_precision(policy) -> dict:
    """Canonicalize a per-collective precision request.

    ``None``/``{}``/``"fp32"`` -> ``{}``; a bare string applies one
    precision to every boundary class; a dict maps boundary ->
    precision.  Explicit ``"fp32"`` entries are dropped so the canonical
    form is minimal.  Unknown boundaries or values raise
    :class:`~autodist_tpu_torch.kernel.quantize.UnknownPrecisionError`.
    """
    if policy in (None, "", "fp32"):
        return {}
    if isinstance(policy, str):
        if policy not in PRECISIONS:
            raise UnknownPrecisionError(
                f"unknown collective precision {policy!r}; expected one "
                f"of {list(PRECISIONS)}")
        return {b: policy for b in PRECISION_BOUNDARIES}
    if not isinstance(policy, dict):
        raise UnknownPrecisionError(
            f"collective precision must be a string or a per-boundary "
            f"dict, got {type(policy).__name__}")
    out = {}
    for boundary, value in policy.items():
        if boundary not in PRECISION_BOUNDARIES:
            raise UnknownPrecisionError(
                f"unknown collective boundary {boundary!r}; expected one "
                f"of {list(PRECISION_BOUNDARIES)}")
        if value not in PRECISIONS:
            raise UnknownPrecisionError(
                f"{boundary}: unknown precision {value!r}; expected one "
                f"of {list(PRECISIONS)}")
        if value != "fp32":
            out[boundary] = value
    return out


# --------------------------------------------------------------------------- #
# Synchronizer, partitioner, node, graph and strategy records
# --------------------------------------------------------------------------- #
def not_ported(what: str, where: str):
    """Raise the ``NotImplementedError`` of what a later item brings."""
    raise NotImplementedError(f"{what} is not ported yet ({where})")


@dataclasses.dataclass
class AllReduceSynchronizer:
    """Dense gradient all-reduce over the data axis; ``group`` is the
    bucket id of the flatten-concat merge."""

    kind: str = "allreduce"
    compressor: str = "none"
    group: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)


# Where asynchronous PS and the stale-synchronous gate come.
ASYNC_PS_ITEM = "ROADMAP Queue 1, item 8: AsyncPSRunner and the SSP gate"


@dataclasses.dataclass
class PSSynchronizer:
    """Sharded-state synchronization, parameter-server semantics on the
    data axis: each rank owns ``1/n`` of a variable's flattened
    gradient (reduce-scattered), runs the optimizer on it and all-gathers
    the updated values (ZeRO-1); with an axis partitioner the parameter
    itself is stored sharded (FSDP).  ``reduction_destination`` is the
    load balancer's shard tag (provenance only); ``local_replication``
    is a no-op (parameters are gathered every step); ``zero_stage`` the
    cost model's record.  ``sync=False`` and ``staleness > 0`` read
    back but do not lower (:data:`ASYNC_PS_ITEM`)."""

    kind: str = "ps"
    reduction_destination: str = ""
    local_replication: bool = False
    sync: bool = True
    staleness: int = 0
    zero_stage: int = 1

    def to_dict(self):
        return dataclasses.asdict(self)


SYNCHRONIZER_TYPES = {"allreduce": AllReduceSynchronizer,
                      "ps": PSSynchronizer}


def synchronizer_from_dict(d: dict):
    d = dict(d)
    kind = d.get("kind", "allreduce")
    if kind not in SYNCHRONIZER_TYPES:
        raise ValueError(f"unknown synchronizer kind {kind!r}")
    return SYNCHRONIZER_TYPES[kind](**d)


@dataclasses.dataclass
class PartitionerConfig:
    """How one variable is split over the mesh: ``partition_str``
    (``"1,4,1"``: a split count a dimension, one dimension split, the
    data-parallel zoo's form; the lowering maps the split onto the data
    axis whatever its count) or ``spec``, one mesh axis name (or
    ``None``) per dimension, e.g. ``["pipe", None, "model"]``;
    ``comm_overlap`` and ``precision`` record the variable's model-axis
    boundary for the cost model, as in the JAX package."""

    partition_str: str = ""
    mesh_axis: str = const.DATA_AXIS
    spec: Optional[list] = None
    comm_overlap: Optional[str] = None
    precision: Optional[str] = None

    @property
    def partition_list(self) -> list:
        if not self.partition_str:
            return []
        return [int(x) for x in self.partition_str.split(",")]

    @property
    def split_axis(self) -> int:
        """The one split dimension (``-1`` for none)."""
        axes = [i for i, n in enumerate(self.partition_list) if n > 1]
        if len(axes) > 1:
            raise ValueError(f"single-axis partitioning only (got "
                             f"{self.partition_str!r})")
        return axes[0] if axes else -1

    @property
    def num_shards(self) -> int:
        return max(self.partition_list, default=1)

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        prec = d.get("precision")
        if prec is not None and prec not in PRECISIONS:
            raise UnknownPrecisionError(
                f"partitioner precision {prec!r}: expected one of "
                f"{list(PRECISIONS)} (or null)")
        return cls(**d)


@dataclasses.dataclass
class NodeConfig:
    """Per-variable distribution choice."""

    var_name: str
    synchronizer: AllReduceSynchronizer | PSSynchronizer = dataclasses.field(
        default_factory=AllReduceSynchronizer)
    partitioner: Optional[PartitionerConfig] = None
    is_sparse: bool = False

    def to_dict(self):
        return {
            "var_name": self.var_name,
            "synchronizer": self.synchronizer.to_dict(),
            "partitioner": (self.partitioner.to_dict() if self.partitioner
                            else None),
            "is_sparse": self.is_sparse,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(var_name=d["var_name"],
                   synchronizer=synchronizer_from_dict(d["synchronizer"]),
                   partitioner=(PartitionerConfig.from_dict(d["partitioner"])
                                if d.get("partitioner") else None),
                   is_sparse=d.get("is_sparse", False))


@dataclasses.dataclass
class GraphConfig:
    """Graph-level config: ``replicas`` is the data-parallel degree,
    ``mesh_axes`` the mesh the strategy assumes, ``lowering`` the path
    (``"collective"`` or ``"pipeline"``), ``parallel`` the lowering's
    knobs, ``precision`` the per-collective wire precision policy and
    ``kernel`` the kernel election."""

    replicas: int = 1
    mesh_axes: dict = dataclasses.field(default_factory=dict)
    lowering: str = "collective"
    accum_steps: int = 1
    parallel: dict = dataclasses.field(default_factory=dict)
    precision: dict = dataclasses.field(default_factory=dict)
    kernel: dict = dataclasses.field(default_factory=dict)

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(replicas=d.get("replicas", 1),
                   mesh_axes=dict(d.get("mesh_axes", {})),
                   lowering=d.get("lowering", "collective"),
                   accum_steps=d.get("accum_steps", 1),
                   parallel=dict(d.get("parallel", {})),
                   precision=normalize_precision(d.get("precision")),
                   kernel=normalize_kernel(d.get("kernel")))


@dataclasses.dataclass
class Strategy:
    """The full serializable strategy: ID'd, JSON-serializable."""

    node_configs: list = dataclasses.field(default_factory=list)
    graph_config: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    id: str = ""

    def __post_init__(self):
        if not self.id:
            self.id = self._gen_id()

    def _gen_id(self) -> str:
        h = hashlib.md5(json.dumps(
            [n.to_dict() for n in self.node_configs], sort_keys=True
        ).encode()).hexdigest()[:12]
        return f"{time.strftime('%Y%m%dT%H%M%S')}-{h}"

    def to_json(self) -> str:
        return json.dumps({
            "id": self.id,
            "node_configs": [n.to_dict() for n in self.node_configs],
            "graph_config": self.graph_config.to_dict(),
        }, indent=1)

    @classmethod
    def from_json(cls, s: str) -> "Strategy":
        d = json.loads(s)
        return cls(id=d["id"],
                   node_configs=[NodeConfig.from_dict(n)
                                 for n in d["node_configs"]],
                   graph_config=GraphConfig.from_dict(d["graph_config"]))
