"""autodist-tpu on PyTorch and CUDA: the port of ``autodist_tpu``.

The package mirrors the JAX package's layout so each module's
counterpart is found under the same name, and it imports torch and
numpy only — never JAX and never ``autodist_tpu``.  Entry points run on
the card (``device=None`` means ``"cuda"``) unless the caller passes
``device="cpu"``; every Pallas kernel on a ported path is a hand-written
CUDA kernel in ``kernel/csrc/``, built with ``nvcc`` at first use.

Ported so far: the serving path of the pipelined LM (dense and paged KV
cache, chunked prefill, continuous batching) with the flash-decode and
paged flash-prefill kernels.  ROADMAP.md lists what comes next.
"""
from autodist_tpu_torch.interop import from_jax_params, to_jax_params
from autodist_tpu_torch.models.pipeline_lm import init_pipeline_lm_params
from autodist_tpu_torch.models.transformer import TransformerConfig
from autodist_tpu_torch.serving import (ContinuousBatcher, ServingEngine,
                                        serve)

__all__ = ["serve", "ServingEngine", "ContinuousBatcher",
           "TransformerConfig", "init_pipeline_lm_params",
           "from_jax_params", "to_jax_params"]
