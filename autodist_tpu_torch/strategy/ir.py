"""The Strategy IR: the serializable distribution strategy.

Counterpart of ``autodist_tpu/strategy/ir.py``.  Ported:

* the serving engine's normalizers (``normalize_kernel``,
  ``normalize_kv_layout``, ``normalize_prefill_chunk``,
  ``normalize_prefix_caching``, ``normalize_speculative``), with the
  same canonical forms and the same errors;
* the data-parallel core of the IR: :class:`AllReduceSynchronizer`,
  :class:`NodeConfig`, :class:`GraphConfig` and :class:`Strategy`, whose
  JSON is the JAX package's byte for byte (same keys, same order, same
  ``indent=1``), so a strategy either package writes reads back in the
  other.

``PSSynchronizer``, partitioners and per-collective precision policies
raise ``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time

from autodist_tpu_torch.kernel import KERNEL_CHOICES


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


# --------------------------------------------------------------------------- #
# Synchronizer, node, graph and strategy records
# --------------------------------------------------------------------------- #
def _not_ported(what: str, where: str):
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


def synchronizer_from_dict(d: dict):
    d = dict(d)
    kind = d.get("kind", "allreduce")
    if kind == "ps":
        _not_ported("the PS synchronizer (PS, ZeRO, PartitionedPS)",
                    "ROADMAP Queue 1, item 8")
    if kind != "allreduce":
        raise ValueError(f"unknown synchronizer kind {kind!r}")
    return AllReduceSynchronizer(**d)


@dataclasses.dataclass
class NodeConfig:
    """Per-variable distribution choice.  Its JSON keeps the JAX
    package's ``"partitioner": null`` (no variable is partitioned)."""

    var_name: str
    synchronizer: AllReduceSynchronizer = dataclasses.field(
        default_factory=AllReduceSynchronizer)
    is_sparse: bool = False

    def to_dict(self):
        return {
            "var_name": self.var_name,
            "synchronizer": self.synchronizer.to_dict(),
            "partitioner": None,
            "is_sparse": self.is_sparse,
        }

    @classmethod
    def from_dict(cls, d):
        if d.get("partitioner"):
            _not_ported("variable partitioning (PartitionedAR, "
                        "PartitionedPS, Parallax)",
                        "ROADMAP Queue 1, item 8")
        return cls(var_name=d["var_name"],
                   synchronizer=synchronizer_from_dict(d["synchronizer"]),
                   is_sparse=d.get("is_sparse", False))


@dataclasses.dataclass
class GraphConfig:
    """Graph-level config: ``replicas`` is the data-parallel degree,
    ``mesh_axes`` the mesh the strategy assumes."""

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
        if d.get("precision") not in (None, "", "fp32", {}):
            _not_ported("per-collective precision policies",
                        "ROADMAP Queue 1, slice 3")
        return cls(replicas=d.get("replicas", 1),
                   mesh_axes=dict(d.get("mesh_axes", {})),
                   lowering=d.get("lowering", "collective"),
                   accum_steps=d.get("accum_steps", 1),
                   parallel=dict(d.get("parallel", {})),
                   precision={},
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
