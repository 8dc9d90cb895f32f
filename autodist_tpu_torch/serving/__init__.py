"""Batched inference for the pipelined LM on one GPU.

* :mod:`~autodist_tpu_torch.serving.kv_cache` — dense and paged KV
  cache, in-place writers, block allocator;
* :mod:`~autodist_tpu_torch.serving.engine` — prefill / decode windows
  through the flash-decode and flash-prefill kernels;
* :mod:`~autodist_tpu_torch.serving.batcher` — continuous batching.

Typical use::

    import torch
    from autodist_tpu_torch import serving, init_pipeline_lm_params

    params = init_pipeline_lm_params(cfg, torch.Generator().manual_seed(0))
    engine = serving.serve(cfg, params=params, kv_layout="paged")
    batcher = serving.ContinuousBatcher(engine)
    rid = batcher.submit([1, 5, 3], max_new_tokens=32, eos_id=2)
    out = batcher.run()[rid].tokens
"""
from autodist_tpu_torch.serving.batcher import (FINISH_REASONS, Completion,
                                                ContinuousBatcher,
                                                OverloadedError, Request)
from autodist_tpu_torch.serving.engine import DecodeWindow, ServingEngine
from autodist_tpu_torch.serving.kv_cache import (BlockAllocator, KVCache,
                                                 PagedKVCache,
                                                 PoolExhaustedError,
                                                 init_cache,
                                                 init_paged_cache)

__all__ = [
    "ServingEngine", "ContinuousBatcher", "Request", "Completion",
    "FINISH_REASONS", "OverloadedError", "DecodeWindow", "KVCache",
    "init_cache", "serve", "PagedKVCache", "init_paged_cache",
    "BlockAllocator", "PoolExhaustedError",
]


def serve(cfg, *, params, device=None, **engine_kwargs) -> ServingEngine:
    """Build a :class:`ServingEngine` from a logical ``params`` tree on
    ``device`` (``None``: the card).  The JAX package's ``runner=``,
    ``artifact=`` and ``strategy=`` forms are not ported yet (ROADMAP
    Queue 1, slice 4: the rest of serving)."""
    return ServingEngine(cfg, params, device=device, **engine_kwargs)
