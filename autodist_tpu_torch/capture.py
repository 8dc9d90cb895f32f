"""Capture layer: the model/optimizer structure strategies are built from.

Counterpart of ``autodist_tpu/capture.py``.  A :class:`Trainable`
bundles the pure loss function, the initial parameter tree (a nested
dict of tensors, named as flax names it) and an optimizer from
:mod:`autodist_tpu_torch.optim`; :meth:`Trainable.var_infos` is the
per-variable inventory the strategy builders consume, in the order and
under the names the JAX package gives (``/``-joined, sorted keys).

The loss contract is the JAX package's: ``loss(params, extra, batch,
rng) -> (loss, new_extra, metrics)``, with ``rng`` an integer seed for
the step's dropout (``None`` for none) in place of a JAX key.  The
``fetch`` plane and ``PipelineTrainable`` belong to later slices.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Sequence

from autodist_tpu_torch.kernel.common import flatten_with_names


@dataclasses.dataclass(frozen=True)
class VarInfo:
    """Per-variable facts for strategy building."""

    name: str
    shape: tuple
    dtype: Any
    is_sparse: bool  # embedding-style row access


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

    def var_infos(self) -> list:
        infos = []
        for name, leaf in flatten_with_names(self.params):
            sparse = name in self._explicit_sparse or bool(
                _SPARSE_NAME_RE.search(name) and leaf.dim() == 2
                and leaf.shape[0] >= _SPARSE_MIN_ROWS)
            infos.append(VarInfo(name=name, shape=tuple(leaf.shape),
                                 dtype=leaf.dtype, is_sparse=sparse))
        return infos
