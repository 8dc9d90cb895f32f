"""autodist-tpu on PyTorch and CUDA: the port of ``autodist_tpu``.

The package mirrors the JAX package's layout so each module's
counterpart is found under the same name, and it imports torch and
numpy only — never JAX and never ``autodist_tpu``.  Entry points run on
the card (``device=None`` means ``"cuda"``) unless the caller passes
``device="cpu"``; every Pallas kernel on a ported path is a hand-written
CUDA kernel in ``kernel/csrc/``, built with ``nvcc`` at first use.

Ported so far: the serving path of the pipelined LM (dense and paged KV
cache, chunked prefill, continuous batching) with the flash-decode and
paged flash-prefill kernels; the data-parallel training path with the
whole strategy zoo of the collective lowering
(``AutoDist(spec).build(make_mlm_trainable(...))``, by default
``PSLoadBalancing``, or with ``PS``, ``PartitionedPS``,
``UnevenPartitionedPS``, ``AllReduce(compressor=...)``,
``PartitionedAR``, ``RandomAxisPartitionAR``, ``Parallax``,
``GradAccumulation`` or ``ZeRO``; ``runner.run_steps``) with the
flash-attention forward and backward kernels; pipeline-parallel training of the pipelined LM over a pipe
axis, GPipe and interleaved, with Megatron tensor parallelism inside the
stages (``AutoDist({"mesh": {"data": d, "pipe": p, "model": t}},
Pipeline(num_microbatches=M, virtual_stages=V, tensor_parallel=t,
...)).build(make_pipeline_lm_trainable(...))``) with the quantized-ring
and collective-matmul hop kernels;
expert-parallel training of the MoE LM (``AutoDist({"mesh":
{"data": d, "expert": e}}, ExpertParallel(...)).build(
make_moe_lm_trainable(...))``) with the quantized all-to-all ring's hop
kernel; and sequence-parallel training of the causal LM over a seq
axis (``AutoDist({"mesh": {"data": d, "seq": s}},
SequenceParallel()).build(make_lm_trainable(cfg, ...))``, the config's
``attention_fn`` a ring from :mod:`autodist_tpu_torch.parallel
.ring_attention` and its ``position_fn``
:func:`~autodist_tpu_torch.parallel.sequence.global_positions`) with
the flash-attention kernels per ring chunk.  ROADMAP.md lists what
comes next.
"""
from autodist_tpu_torch import optim
from autodist_tpu_torch.autodist import AutoDist
from autodist_tpu_torch.capture import PipelineTrainable, Trainable, VarInfo
from autodist_tpu_torch.interop import from_jax_params, to_jax_params
from autodist_tpu_torch.models.moe_transformer import (MoeConfig,
                                                       make_moe_lm_trainable)
from autodist_tpu_torch.models.pipeline_lm import (init_pipeline_lm_params,
                                                   make_pipeline_lm_trainable)
from autodist_tpu_torch.models.transformer import (TransformerConfig,
                                                   TransformerLM,
                                                   lm_loss_head,
                                                   make_lm_trainable)
from autodist_tpu_torch.resource import ResourceSpec
from autodist_tpu_torch.runner import DistributedRunner, stack_steps
from autodist_tpu_torch.serving import (ContinuousBatcher, ServingEngine,
                                        serve)
from autodist_tpu_torch.strategy.builders import (
    PS, AllReduce, ExpertParallel, GradAccumulation, Parallax, PartitionedAR,
    PartitionedPS, Pipeline, PSLoadBalancing, RandomAxisPartitionAR,
    SequenceParallel, UnevenPartitionedPS, ZeRO)
from autodist_tpu_torch.strategy.ir import Strategy

__all__ = ["AutoDist", "Trainable", "PipelineTrainable", "VarInfo",
           "ResourceSpec", "DistributedRunner", "stack_steps", "Strategy",
           "AllReduce", "PS", "PSLoadBalancing", "PartitionedPS",
           "UnevenPartitionedPS", "PartitionedAR", "RandomAxisPartitionAR",
           "Parallax", "GradAccumulation", "ZeRO", "Pipeline",
           "ExpertParallel", "SequenceParallel",
           "optim", "serve",
           "ServingEngine", "ContinuousBatcher", "TransformerConfig",
           "init_pipeline_lm_params", "make_pipeline_lm_trainable",
           "MoeConfig", "make_moe_lm_trainable", "TransformerLM",
           "lm_loss_head", "make_lm_trainable", "from_jax_params",
           "to_jax_params"]
