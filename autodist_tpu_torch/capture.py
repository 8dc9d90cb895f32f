"""Capture layer: the model/optimizer structure strategies are built from.

Counterpart of ``autodist_tpu/capture.py``.  A :class:`Trainable`
bundles the pure loss function, the initial parameter tree (a nested
dict of tensors, named as flax names it) and an optimizer from
:mod:`autodist_tpu_torch.optim` (:meth:`Trainable.from_loss_fn` wraps a
plain ``loss_fn(params, batch)``); :meth:`Trainable.var_infos` is the
per-variable inventory the strategy builders consume, in the order and
under the names the JAX package gives (``/``-joined, sorted keys).

The loss contract is the JAX package's: ``loss(params, extra, batch,
rng) -> (loss, new_extra, metrics)``, with ``rng`` an integer seed for
the step's dropout (``None`` for none) in place of a JAX key; in a
window captured as a CUDA graph it is a
:class:`~autodist_tpu_torch.cuda_graph.GraphSeed` (read it through
:func:`~autodist_tpu_torch.cuda_graph.dropout_generator`).
:class:`PipelineTrainable` declares a model in stage form for the
``Pipeline`` strategy.  The ``fetch`` plane belongs to a later slice.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Sequence

from autodist_tpu_torch.kernel.common import flatten_with_names

_STAGE_ITEM = "ROADMAP Queue 1, slice 3 leftovers, item 6"


@dataclasses.dataclass(frozen=True)
class VarInfo:
    """Per-variable facts for strategy building."""

    name: str
    shape: tuple
    dtype: Any
    is_sparse: bool  # embedding-style row access

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def byte_size(self) -> int:
        return self.size * self.dtype.itemsize


# Embedding-style variables by name and shape, as in the JAX package.
_SPARSE_NAME_RE = re.compile(r"(embed|embedding|lookup|vocab)", re.IGNORECASE)
_SPARSE_MIN_ROWS = 8192


class Trainable:
    """The unit strategies are built for and lowering consumes."""

    def __init__(self, loss: Callable, params: Any, optimizer: Any, *,
                 extra: Any = None, sparse_params: Sequence[str] = ()):
        self.loss = loss
        self.params = params
        self.optimizer = optimizer
        self.extra = extra
        self._explicit_sparse = set(sparse_params)

    @classmethod
    def from_loss_fn(cls, loss_fn, params, optimizer, *, with_rng=False,
                     **kw):
        """Wrap ``loss_fn(params, batch)`` (or ``(params, batch, rng)``
        with ``with_rng``) returning a scalar loss or ``(loss,
        metrics)``; the metrics gain ``loss``."""

        def canonical(p, extra, batch, rng):
            out = loss_fn(p, batch, rng) if with_rng else loss_fn(p, batch)
            loss, metrics = out if isinstance(out, tuple) else (out, {})
            return loss, extra, dict(metrics, loss=loss)

        return cls(canonical, params, optimizer, **kw)

    def var_infos(self) -> list:
        infos = []
        for name, leaf in flatten_with_names(self.params):
            sparse = name in self._explicit_sparse or bool(
                _SPARSE_NAME_RE.search(name) and leaf.dim() == 2
                and leaf.shape[0] >= _SPARSE_MIN_ROWS)
            infos.append(VarInfo(name=name, shape=tuple(leaf.shape),
                                 dtype=leaf.dtype, is_sparse=sparse))
        return infos


class PipelineTrainable(Trainable):
    """A trainable declared in pipeline-stage form (counterpart of the
    JAX package's ``PipelineTrainable``):

    * ``stage_fn(chunk_params, x) -> x``: one stage; every stage shares
      it, each with its slice of ``stacked_params`` (a tree whose leaves
      carry a leading ``num_stages`` dim);
    * ``loss_head(outputs, batch) -> (loss, metrics)`` (or ``(outputs,
      batch, shared)`` with ``shared_params``);
    * ``prologue(shared, batch) -> x`` (optional): the first stage's
      input, from the replicated ``shared_params`` (an LM's embedding).

    The inherited ``loss`` is the sequential execution (stage 0 to S - 1
    on one device), the reference the ``Pipeline`` lowering is held to.
    Per-stage auxiliary losses (``stage_aux``) and per-(stage, row)
    random draws (``stage_rng``) are not ported yet (ROADMAP Queue 1,
    slice 3 leftovers, item 6).
    """

    def __init__(self, stage_fn, stacked_params, loss_head, optimizer, *,
                 num_stages: int, batch_key: str = "x",
                 stage_aux: bool = False, shared_params=None,
                 prologue=None, stage_rng: bool = False, **kw):
        if stage_aux or stage_rng:
            raise NotImplementedError(
                f"PipelineTrainable(stage_aux=, stage_rng=) is not ported "
                f"yet ({_STAGE_ITEM})")
        sizes = {leaf.shape[0] if leaf.dim() else None
                 for _, leaf in flatten_with_names(stacked_params)}
        if sizes != {num_stages}:
            raise ValueError(
                f"stacked_params leading dims {sorted(sizes, key=str)} != "
                f"num_stages {num_stages}")
        if prologue is not None and shared_params is None:
            raise ValueError("a prologue needs shared_params to act on")
        self.stage_fn = stage_fn
        self.loss_head = loss_head
        self.num_stages = num_stages
        self.batch_key = batch_key
        self.shared_params = shared_params
        self.prologue = prologue
        self.has_shared = shared_params is not None
        has_shared = self.has_shared

        def sequential_loss(params, extra, batch, rng):
            stages = params["stages"] if has_shared else params
            shared = params.get("shared") if has_shared else None
            x = prologue(shared, batch) if prologue is not None \
                else batch[batch_key]
            for i in range(num_stages):
                x = stage_fn(stage_slice(stages, i), x)
            loss, metrics = (loss_head(x, batch, shared) if has_shared
                             else loss_head(x, batch))
            return loss, extra, dict(metrics, loss=loss)

        params = ({"stages": stacked_params, "shared": shared_params}
                  if has_shared else stacked_params)
        super().__init__(sequential_loss, params, optimizer, **kw)


def stage_slice(stages, i: int):
    """The ``i``-th slice of every stacked stage leaf (a view)."""
    if isinstance(stages, dict):
        return {k: stage_slice(v, i) for k, v in stages.items()}
    return stages[i]
