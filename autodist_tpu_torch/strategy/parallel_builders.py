"""The ``Pipeline`` strategy builder, with Megatron tensor parallelism
inside each stage, and the ``ExpertParallel`` and ``SequenceParallel``
builders.

Counterpart of ``autodist_tpu/strategy/parallel_builders.py``
``Pipeline``, :data:`PIPELINE_TP_RULES`, :data:`PIPELINE_VOCAB_RULES`,
``ExpertParallel`` and ``SequenceParallel``.  The builder emits the JAX
builder's node configs (every stage variable partitioned ``["pipe",
...]`` with the model-axis dims its tp rule names, shared variables
replicated or, under ``vocab_parallel``, the tied table ``["model",
None]``) and graph config (``lowering="pipeline"``, the schedule
knobs, the precision policy and the kernel election), so the two
packages' strategies for the same model serialize alike, and it runs the
same build-time checks with the same errors.

The lowering runs GPipe (``virtual_stages=1``) and interleaved
schedules over any pipe axis, one process per pipe coordinate
(:mod:`autodist_tpu_torch.parallel.pipeline`).  Every builder emits
its per-variable synchronizers as the JAX builders do
(:func:`_default_sync`: ZeRO at ``zero_stage``, a compressor, or the
``zero_min_bytes`` mix of both).
"""
from __future__ import annotations

import inspect
import logging
import re
from typing import Sequence

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.tensor import normalize_comm_overlap
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import (AllReduceSynchronizer, NodeConfig,
                                            PartitionerConfig, PSSynchronizer,
                                            Strategy, normalize_kernel,
                                            normalize_precision)

# Megatron rules for the stage variables, matched against the name with
# its per-stage shape (the stacked leaf minus its leading stage dim):
# the JAX package's TRANSFORMER_TP_RULES without the embedding rule, and
# the column-parallel biases, which shard with their kernels.
PIPELINE_TP_RULES = (
    (r"(^|/)qkv/kernel$", [None, None, const.MODEL_AXIS, None]),
    (r"(^|/)out/kernel$", [const.MODEL_AXIS, None, None]),
    (r"(^|/)wi/kernel$", [None, const.MODEL_AXIS]),
    (r"(^|/)wo/kernel$", [const.MODEL_AXIS, None]),
    (r"(^|/)qkv/bias$", [None, const.MODEL_AXIS, None]),
    (r"(^|/)wi/bias$", [const.MODEL_AXIS]),
)

# Vocab-parallel rules for the shared variables (the tied embedding,
# ``shared/embedding``): dim 0, the vocabulary, shards over the model
# axis; a vocabulary that does not divide is zero-padded by the
# lowering.
PIPELINE_VOCAB_RULES = (
    (r"(^|/)embedding$", [const.MODEL_AXIS, None]),
)



class Pipeline(StrategyBuilder):
    """Microbatched pipeline parallelism over the ``pipe`` mesh axis,
    with ``tensor_parallel=t`` Megatron shards over the ``model`` axis
    inside each stage (stage variables matching ``tp_rules``).

    ``comm_overlap="matmul"`` (or ``True``) runs the row-parallel
    boundaries as the collective-matmul ring; ``vocab_parallel=True``
    shards the shared tied table's vocabulary over the model axis
    (``vocab_rules``, default :data:`PIPELINE_VOCAB_RULES`; recorded
    and without effect at ``tensor_parallel=1``), whose prologue and
    loss head must accept ``model_axis=``; ``collective_precision``
    narrows the boundaries (``{"tp_psum": "int8", "vocab_stats":
    "bf16"}``); ``kernel`` elects
    the fused kernels: ``quant_ring`` needs the int8 ``tp_psum`` and the
    blocking form, ``collective_matmul`` needs ``comm_overlap="matmul"``.
    ``zero_stage`` (or ``zero1``), ``compressor=`` and ``zero_min_bytes``
    name each variable's synchronizer (:func:`_default_sync`: ZeRO over
    the data axis for a stage variable, over pipe x data for a shared
    one; a model-sharded variable's request degrades in the lowering,
    which records it); the ``grad`` slot elects the error-feedback
    compressor, the ``zero3_gather`` slot narrows ZeRO-3's gathers;
    ``remat=True`` recomputes each stage call in the backward; a
    ``GradAccumulation`` around the builder runs the whole schedule
    once an accumulation slice.
    """

    def __init__(self, num_microbatches: int = 1, virtual_stages: int = 1,
                 *, zero_stage: int = None, zero1: bool = None,
                 compressor: str = "none", zero_min_bytes=None,
                 remat: bool = False, tensor_parallel: int = 1,
                 tp_rules: Sequence[tuple] = None, comm_overlap=None,
                 vocab_parallel: bool = False, vocab_rules=None,
                 collective_precision=None, kernel=None):
        if num_microbatches < 1:
            raise ValueError("num_microbatches must be >= 1")
        if virtual_stages < 1:
            raise ValueError("virtual_stages must be >= 1")
        if tensor_parallel < 1:
            raise ValueError("tensor_parallel must be >= 1")
        self.num_microbatches = num_microbatches
        self.virtual_stages = virtual_stages
        self.remat = remat
        self.tensor_parallel = tensor_parallel
        self.tp_rules = [(re.compile(pat), list(spec))
                         for pat, spec in (tp_rules if tp_rules is not None
                                           else PIPELINE_TP_RULES)]
        self.vocab_parallel = bool(vocab_parallel)
        self.vocab_rules = [(re.compile(pat), list(spec))
                            for pat, spec in (vocab_rules if vocab_rules
                                              is not None
                                              else PIPELINE_VOCAB_RULES)]
        self.comm_overlap = normalize_comm_overlap(comm_overlap)
        self.precision = normalize_precision(collective_precision)
        _check_grad_precision(self.precision, compressor)
        self.kernel = normalize_kernel(kernel)
        if "quant_ring" in self.kernel:
            if tensor_parallel <= 1 \
                    or self.precision.get("tp_psum") != "int8":
                raise ValueError(
                    "kernel 'quant_ring' fuses q/dq into the int8 "
                    "tp_psum ring: it needs tensor_parallel > 1 and "
                    "collective_precision's tp_psum slot at 'int8'")
            if self.comm_overlap is not None:
                raise ValueError(
                    "kernel 'quant_ring' replaces the monolithic "
                    "tp_psum; comm_overlap routes the boundary through "
                    "the decomposed forms instead — pick one")
        if "collective_matmul" in self.kernel and (
                tensor_parallel <= 1 or self.comm_overlap != "matmul"):
            raise ValueError(
                "kernel 'collective_matmul' fuses the chunked ppermute "
                "ring: it needs tensor_parallel > 1 and "
                "comm_overlap='matmul'")
        # ZeRO over the data axes (stage variables) or pipe x data
        # (shared ones): 1 shards the optimizer state, 2 runs the same
        # program, 3 also stores the parameters as flat shards.
        self.zero_stage = _resolve_zero_stage(zero_stage, zero1)
        self.make_sync = _default_sync(self.zero_stage, compressor,
                                       zero_min_bytes)

    def _tp_spec_for(self, name: str, stage_shape: tuple, tp: int):
        """Per-stage model-axis spec of a stage variable, or None: the
        first name-matching rule of the right rank wins, and its sharded
        dims must divide by ``tp``."""
        for pat, spec in self.tp_rules:
            if not pat.search(name) or len(spec) != len(stage_shape):
                continue
            for dim, axis in zip(stage_shape, spec):
                if axis == const.MODEL_AXIS and dim % tp:
                    raise ValueError(
                        f"{name}: per-stage dim {dim} does not divide by "
                        f"tensor_parallel={tp} (rule spec {spec})")
            return list(spec)
        return None

    def build(self, trainable, resource_spec):
        shape = resource_spec.resolved_mesh_shape()
        if const.PIPE_AXIS not in shape:
            raise ValueError(
                f"Pipeline needs a {const.PIPE_AXIS!r} mesh axis; spec "
                f"resolves to {shape} — declare e.g. "
                "mesh: {data: ..., pipe: ...}")
        num_stages = getattr(trainable, "num_stages", None)
        if num_stages is None:
            raise ValueError(
                "Pipeline lowers stage-structured trainables; declare one "
                "with PipelineTrainable(stage_fn, stacked_params, "
                "loss_head, optimizer, num_stages=S)")
        if num_stages != shape[const.PIPE_AXIS] * self.virtual_stages:
            raise ValueError(
                f"trainable declares {num_stages} stages; mesh pipe axis "
                f"has {shape[const.PIPE_AXIS]} devices x "
                f"{self.virtual_stages} virtual stages")
        tp = self.tensor_parallel
        if tp > 1 and shape.get(const.MODEL_AXIS, 1) != tp:
            raise ValueError(
                f"Pipeline(tensor_parallel={tp}) needs a "
                f"{const.MODEL_AXIS!r} mesh axis of that size; spec "
                f"resolves to {shape} — declare e.g. "
                "mesh: {data: ..., pipe: ..., model: ...}")
        if tp > 1 and self.comm_overlap:
            try:
                sig = inspect.signature(
                    getattr(trainable, "stage_fn", None)).parameters
            except (TypeError, ValueError):  # partials, builtins: trust it
                sig = {"comm_overlap": None}
            if "comm_overlap" not in sig:
                raise ValueError(
                    f"comm_overlap={self.comm_overlap!r} needs an "
                    "overlap-aware stage_fn: it must accept comm_overlap= "
                    "and route it to its row/column-parallel boundaries "
                    "(autodist_tpu_torch.parallel.tensor primitives)")
        has_shared = getattr(trainable, "has_shared", False)
        if tp > 1 and self.vocab_parallel:
            # The lowering hands the prologue and the loss head local
            # vocab shards: both must accept model_axis=.
            if not has_shared:
                raise ValueError(
                    "vocab_parallel=True shards the shared embedding/"
                    "unembedding; this trainable declares no shared_params")
            for role in ("prologue", "loss_head"):
                try:
                    sig = inspect.signature(
                        getattr(trainable, role, None)).parameters
                except (TypeError, ValueError):  # partials: trust it
                    sig = {"model_axis": None}
                if "model_axis" not in sig:
                    raise ValueError(
                        f"vocab_parallel=True needs a vocab-parallel-aware "
                        f"{role}: it must accept model_axis= and use the "
                        "autodist_tpu_torch.parallel.tensor vocab "
                        "primitives (vocab_parallel_embedding / "
                        "vocab_parallel_cross_entropy)")
                if self.comm_overlap and "comm_overlap" not in sig:
                    raise ValueError(
                        f"comm_overlap={self.comm_overlap!r} with "
                        f"vocab_parallel=True needs the {role} to accept "
                        "comm_overlap= and route it to the epilogue psums")
        nodes, tp_matched, vocab_matched = [], [], []
        for info in trainable.var_infos():
            node = NodeConfig(var_name=info.name,
                              synchronizer=self.make_sync(info),
                              is_sparse=info.is_sparse)
            # Stage variables shard on the pipe axis (their leading
            # stage dim), plus the model axis on the dims their tp rule
            # names; shared variables replicate.
            if not has_shared or info.name.startswith("stages/"):
                tail = [None] * (max(len(info.shape), 1) - 1)
                overlap = tp_prec = None
                if tp > 1:
                    tp_tail = self._tp_spec_for(info.name,
                                                tuple(info.shape[1:]), tp)
                    if tp_tail is not None:
                        tail = tp_tail
                        tp_matched.append(info.name)
                        overlap = self.comm_overlap
                        tp_prec = self.precision.get("tp_psum")
                node.partitioner = PartitionerConfig(
                    mesh_axis=const.PIPE_AXIS,
                    spec=[const.PIPE_AXIS] + tail,
                    comm_overlap=overlap, precision=tp_prec)
            elif self.vocab_parallel and tp > 1:
                # A shared variable the vocab rules name shards dim 0
                # over the model axis; the rest replicate.
                for pat, spec in self.vocab_rules:
                    if pat.search(info.name) and len(spec) == len(info.shape):
                        node.partitioner = PartitionerConfig(
                            mesh_axis=const.MODEL_AXIS, spec=list(spec),
                            comm_overlap=self.comm_overlap,
                            precision=self.precision.get("vocab_stats"))
                        vocab_matched.append(info.name)
                        break
            nodes.append(node)
        if tp > 1 and self.vocab_parallel and not vocab_matched:
            raise ValueError(
                "Pipeline(vocab_parallel=True): no shared variable "
                "matched the vocab rules; name the tied table "
                "'embedding' (PIPELINE_VOCAB_RULES) or pass vocab_rules=...")
        if tp > 1 and not tp_matched:
            raise ValueError(
                f"Pipeline(tensor_parallel={tp}): no stage variable "
                "matched the tp rules; name the projections "
                "qkv/out/wi/wo (PIPELINE_TP_RULES) or pass tp_rules=...")
        cfg = self._graph_config(resource_spec)
        cfg.lowering = "pipeline"
        cfg.parallel = {"num_microbatches": self.num_microbatches,
                        "virtual_stages": self.virtual_stages,
                        "remat": self.remat,
                        "tensor_parallel": tp,
                        "comm_overlap": self.comm_overlap,
                        "vocab_parallel": self.vocab_parallel,
                        "zero_stage": self.zero_stage}
        cfg.precision = dict(self.precision)
        cfg.kernel = dict(self.kernel)
        return Strategy(node_configs=nodes, graph_config=cfg)


_EXPERT_NAME_RE = re.compile(r"(expert|moe)", re.IGNORECASE)


def _check_grad_precision(precision: dict, compressor):
    """The precision policy's grad slot elects an error-feedback
    compressor, so it conflicts with an explicit ``compressor=`` (the
    JAX builders' check)."""
    if precision.get("grad") and (compressor or "none") != "none":
        raise ValueError(
            "collective_precision's 'grad' slot elects an error-"
            "feedback compressor; pass either it or compressor=, "
            "not both")


def _default_sync(zero_stage: int, compressor: str, zero_min_bytes=None):
    """The per-variable synchronizer a parallel builder emits, as a
    function of the variable's :class:`~autodist_tpu_torch.capture
    .VarInfo` (JAX ``_default_sync``): a PS synchronizer, ZeRO at
    ``zero_stage``, or an AllReduce one with ``compressor``.
    ``zero_min_bytes`` mixes them: a variable of at least that many
    bytes in its declared dtype gets ZeRO (at ``zero_stage``, stage 1
    by default), a smaller one the compressed all-reduce.  ZeRO and a
    compressor exclude each other per variable unless
    ``zero_min_bytes`` splits the variables between them."""
    comp = compressor or "none"
    if zero_stage and comp != "none" and zero_min_bytes is None:
        raise ValueError(
            f"zero_stage={zero_stage} and compressor are mutually "
            "exclusive per variable: PS (ZeRO) sync reduces at full "
            "precision; compression is an AllReduce knob (zero_min_bytes "
            "composes them: large vars ZeRO-staged, small vars "
            "compressed)")
    stage = zero_stage or 1

    def sync_for(info):
        if zero_min_bytes is not None:
            if info.byte_size >= zero_min_bytes:
                return PSSynchronizer(zero_stage=stage)
            return AllReduceSynchronizer(compressor=comp)
        if zero_stage:
            return PSSynchronizer(zero_stage=zero_stage)
        return AllReduceSynchronizer(compressor=comp)

    return sync_for


def _resolve_zero_stage(zero_stage, zero1) -> int:
    """The JAX builders' ZeRO request: ``zero_stage`` in {0, 1, 2, 3}, or
    the deprecated ``zero1`` alias."""
    if zero1 is not None and zero_stage is not None:
        raise ValueError(
            "pass either zero_stage= or the deprecated zero1= alias, "
            "not both")
    if zero1 is not None:
        return 1 if zero1 else 0
    if zero_stage is None:
        return 0
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(
            f"zero_stage must be 0 (off), 1, 2 or 3; got {zero_stage!r}")
    return int(zero_stage)


class ExpertParallel(StrategyBuilder):
    """Expert parallelism (MoE) over the ``expert`` mesh axis.

    Variables with a leading expert dimension, named in
    ``expert_params`` (path-suffix match) or auto-detected (the name
    contains ``expert``/``moe``, rank >= 3, the leading dim divides the
    expert axis; a rank-2 gate is never auto-sharded), are stored
    sharded across experts; everything else replicates, the expert axis
    doubling as a batch axis.  The model routes its tokens through
    :func:`autodist_tpu_torch.parallel.moe.expert_parallel_ffn`.
    ``collective_precision={"moe_a2a": ...}`` narrows the dispatch and
    combine wire; ``kernel=("a2a_ring",)`` takes the fused int8 ring and
    needs the int8 ``moe_a2a`` slot.

    ``zero_stage`` (or ``zero1``), ``compressor=`` and
    ``zero_min_bytes`` name each variable's synchronizer
    (:func:`_default_sync`); ZeRO on an expert table degrades to plain
    sync in the lowering, which records it.

    ``expert_over_dcn=True`` declares that the expert axis spans slices
    (nodes): the mesh absorbs the slice dimension into the expert axis,
    with no separate ``dcn`` axis, so the all-to-all crosses the network
    between nodes every microbatch (plan lint ADT061 flags it).  It
    needs a multi-slice spec (``topology.num_slices > 1`` or a ``dcn``
    axis) and refuses the ``a2a_ring`` kernel, a ring within a node.
    The JAX builder's checks run, with its errors.
    """

    def __init__(self, expert_params: Sequence[str] = (),
                 detect: bool = True, *, zero_stage: int = None,
                 zero1: bool = None, compressor: str = "none",
                 zero_min_bytes=None, collective_precision=None,
                 num_experts: int = None, capacity_factor: float = 2.0,
                 expert_over_dcn: bool = False, kernel=None):
        self.expert_params = tuple(expert_params)
        self.detect = detect
        self.zero_stage = _resolve_zero_stage(zero_stage, zero1)
        self.precision = normalize_precision(collective_precision)
        _check_grad_precision(self.precision, compressor)
        self.num_experts = num_experts
        self.capacity_factor = float(capacity_factor)
        if self.capacity_factor <= 0:
            raise ValueError(
                f"capacity_factor must be > 0, got {capacity_factor}")
        self.expert_over_dcn = bool(expert_over_dcn)
        self.kernel = normalize_kernel(kernel)
        for k in self.kernel:
            if k in ("quant_ring", "collective_matmul"):
                raise ValueError(
                    f"kernel {k!r} fuses a tensor-parallel ring; the "
                    "expert lowering has no tp_psum/matmul boundary — "
                    "use the Pipeline builder")
        if "a2a_ring" in self.kernel:
            if self.precision.get("moe_a2a") != "int8":
                raise ValueError(
                    "kernel 'a2a_ring' fuses q/dq into the s8 "
                    "dispatch/combine ring: it needs "
                    "collective_precision's moe_a2a slot at 'int8'")
            if self.expert_over_dcn:
                raise ValueError(
                    "kernel 'a2a_ring' is an ICI ring; it cannot span "
                    "slices — drop expert_over_dcn or the kernel")
        self.make_sync = _default_sync(self.zero_stage, compressor,
                                       zero_min_bytes)

    def build(self, trainable, resource_spec):
        shape = resource_spec.resolved_mesh_shape()
        if const.EXPERT_AXIS not in shape:
            raise ValueError(
                f"ExpertParallel needs an {const.EXPERT_AXIS!r} mesh axis; "
                f"spec resolves to {shape} — declare e.g. "
                "mesh: {expert: ...}")
        E = shape[const.EXPERT_AXIS]
        if self.num_experts is not None and self.num_experts % E:
            raise ValueError(
                f"num_experts={self.num_experts} must divide the "
                f"{E}-way expert axis (each device holds E/axis experts)")
        # expert_over_dcn's mesh absorbs the slice dimension into the
        # expert axis: the check is against the topology's slice count.
        n_slices = max(int(getattr(resource_spec, "num_slices", 1) or 1), 1)
        if self.expert_over_dcn and n_slices <= 1 \
                and shape.get(const.DCN_AXIS, 1) <= 1:
            raise ValueError(
                "expert_over_dcn declares the expert axis spans slices, "
                f"but the spec resolves single-slice ({shape})")
        nodes, matched = [], set()
        for i in trainable.var_infos():
            named = bool(self.detect and _EXPERT_NAME_RE.search(i.name))
            explicit = any(i.name == p or i.name.endswith("/" + p)
                           for p in self.expert_params)
            auto = named and len(i.shape) >= 3 and i.shape[0] % E == 0
            if (not explicit and not auto and named and len(i.shape) == 2
                    and i.shape[0] % E == 0):
                logging.getLogger(__name__).info(
                    "%s: rank-2 tensor in an expert-named scope is NOT "
                    "auto-sharded (could be a gate); pass "
                    "expert_params=(%r,) if it is a per-expert table",
                    i.name, i.name.rsplit("/", 1)[-1])
            node = NodeConfig(var_name=i.name,
                              synchronizer=self.make_sync(i),
                              is_sparse=i.is_sparse)
            if explicit or auto:
                matched.add(i.name)
                node.partitioner = PartitionerConfig(
                    mesh_axis=const.EXPERT_AXIS,
                    spec=[const.EXPERT_AXIS] + [None] * (len(i.shape) - 1))
            nodes.append(node)
        for p in self.expert_params:
            if not any(n == p or n.endswith("/" + p) for n in matched):
                raise ValueError(
                    f"expert_params entry {p!r} matched no variable "
                    f"(have {[i.name for i in trainable.var_infos()]})")
        if not matched:
            raise ValueError(
                "ExpertParallel found no expert variables: pass "
                "expert_params=... or name them with 'expert'/'moe'")
        cfg = self._graph_config(resource_spec)
        cfg.lowering = "expert"
        cfg.parallel = {
            "num_experts": (self.num_experts if self.num_experts
                            is not None else E),
            "capacity_factor": self.capacity_factor,
            "expert_over_dcn": self.expert_over_dcn,
            "zero_stage": self.zero_stage,
        }
        cfg.precision = dict(self.precision)
        cfg.kernel = dict(self.kernel)
        return Strategy(node_configs=nodes, graph_config=cfg)


class SequenceParallel(StrategyBuilder):
    """Sequence parallelism over the ``seq`` mesh axis (e.g. ``mesh:
    {data: 2, seq: 4}``): token-dimension batch leaves (named by
    ``seq_leaves``) split over ``data x seq``, parameters replicate, and
    gradients are averaged over both axes.  The model attends globally
    (:mod:`autodist_tpu_torch.parallel.ring_attention`) and positions
    its tokens with :func:`autodist_tpu_torch.parallel.sequence
    .global_positions`.

    ``zero_stage`` (or ``zero1``), ``compressor=`` and
    ``zero_min_bytes`` name each variable's synchronizer
    (:func:`_default_sync`); ``collective_precision``'s ``grad`` slot
    elects the error-feedback compressor for every variable without
    one, and its ``zero3_gather`` slot narrows the ZeRO-3 gathers.
    The JAX builder's checks run, with its errors.
    """

    def __init__(self, seq_leaves: Sequence[str] = ("x", "y"), *,
                 zero_stage: int = None, zero1: bool = None,
                 compressor: str = "none", zero_min_bytes=None,
                 collective_precision=None):
        self.seq_leaves = tuple(seq_leaves)
        self.zero_stage = _resolve_zero_stage(zero_stage, zero1)
        self.precision = normalize_precision(collective_precision)
        _check_grad_precision(self.precision, compressor)
        self.make_sync = _default_sync(self.zero_stage, compressor,
                                       zero_min_bytes)

    def build(self, trainable, resource_spec):
        shape = resource_spec.resolved_mesh_shape()
        if const.SEQ_AXIS not in shape:
            raise ValueError(
                f"SequenceParallel needs a {const.SEQ_AXIS!r} mesh axis; "
                f"spec resolves to {shape} — declare e.g. "
                "mesh: {data: ..., seq: ...}")
        nodes = [NodeConfig(var_name=i.name,
                            synchronizer=self.make_sync(i),
                            is_sparse=i.is_sparse)
                 for i in trainable.var_infos()]
        cfg = self._graph_config(resource_spec)
        cfg.lowering = "sequence"
        cfg.parallel = {"seq_leaves": list(self.seq_leaves)}
        cfg.precision = dict(self.precision)
        return Strategy(node_configs=nodes, graph_config=cfg)
