"""Batched inference for the pipelined LM, on one GPU or on a
tensor-parallel group of ranks.

* :mod:`~autodist_tpu_torch.serving.kv_cache` — dense and paged KV
  cache, in-place writers, the refcounted block allocator and the
  prefix keys;
* :mod:`~autodist_tpu_torch.serving.engine` — prefill / decode windows
  through the flash kernels, each one CUDA-graph replay on the card;
  seeded sampling, prefix caching with copy-on-write, speculative
  decoding;
* :mod:`~autodist_tpu_torch.serving.batcher` — continuous batching.

Typical use::

    import torch
    from autodist_tpu_torch import serving, init_pipeline_lm_params

    params = init_pipeline_lm_params(cfg, torch.Generator().manual_seed(0))
    engine = serving.serve(cfg, params=params, kv_layout="paged")
    batcher = serving.ContinuousBatcher(engine)
    rid = batcher.submit([1, 5, 3], max_new_tokens=32, eos_id=2)
    out = batcher.run()[rid].tokens

At tensor parallel 2, every rank of a 2-rank ``torch.distributed`` job
runs the same lines with ``serving.serve(cfg, params=params,
tensor_parallel=2, vocab_parallel=True)``.  ``serving.serve(cfg,
runner=runner, strategy=strategy)`` serves a trained runner with the
strategy's serving knobs, ``serving.serve(cfg, artifact=path)`` an
:func:`~autodist_tpu_torch.checkpoint.export_model` artifact;
``temperature=0.9, top_k=40`` samples (the request's ``seed=`` keys its
stream), ``prefix_caching=True`` shares prompt prefixes (paged),
``speculative=4, draft_cfg=..., draft_params=...`` decodes with a
draft.
"""
from autodist_tpu_torch.serving.batcher import (FINISH_REASONS, Completion,
                                                ContinuousBatcher,
                                                OverloadedError, Request)
from autodist_tpu_torch.serving.engine import (DecodeWindow, ServingEngine,
                                               seed_engine_kwargs)
from autodist_tpu_torch.serving.kv_cache import (BlockAllocator, KVCache,
                                                 PagedKVCache,
                                                 PoolExhaustedError,
                                                 init_cache,
                                                 init_paged_cache,
                                                 prefix_block_keys)

__all__ = [
    "ServingEngine", "ContinuousBatcher", "Request", "Completion",
    "FINISH_REASONS", "OverloadedError", "DecodeWindow", "KVCache",
    "init_cache", "serve", "PagedKVCache", "init_paged_cache",
    "BlockAllocator", "PoolExhaustedError", "prefix_block_keys",
    "seed_engine_kwargs",
]


def serve(cfg, *, params=None, runner=None, artifact=None, strategy=None,
          **engine_kwargs) -> ServingEngine:
    """Build a :class:`ServingEngine` from whichever form the trained
    model is in: a logical ``params`` tree, a live ``runner`` (its
    ``get_params()``, any training strategy), or an export ``artifact``
    directory (its ``params/``).  A training ``strategy``
    seeds the serving knobs from its Strategy IR (``tensor_parallel``,
    ``vocab_parallel``, ``comm_overlap``, ``kv_layout`` and the ladder's
    ``prefill_chunk``, ``prefix_caching``, ``speculative``) unless given
    explicitly.  ``device`` (``None``: the card) and every other knob go
    to the engine."""
    sources = [s for s in (params, runner, artifact) if s is not None]
    if len(sources) != 1:
        raise ValueError(
            "serve() needs exactly one of params=, runner=, artifact=")
    if runner is not None:
        return ServingEngine.from_runner(runner, cfg, strategy=strategy,
                                         **engine_kwargs)
    engine_kwargs = seed_engine_kwargs(engine_kwargs, strategy)
    if artifact is not None:
        return ServingEngine.from_artifact(artifact, cfg, **engine_kwargs)
    return ServingEngine(cfg, params, **engine_kwargs)
