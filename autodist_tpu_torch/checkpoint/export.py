"""Serving export: a trained model as a portable inference artifact.

Counterpart of ``autodist_tpu/checkpoint/export.py``.  The artifact is a
directory of three things:

* ``params/params.pt``: the parameters at logical names and unpadded
  shapes (``runner.get_params()`` under any strategy), a nested dict of
  CPU tensors that ``torch.load(..., weights_only=True)`` reads with
  ``torch`` alone;
* ``apply.pt2``: the inference function ``apply_fn(params, *inputs)``
  as a ``torch.export`` program that takes the parameters as an input
  (in place of the JAX package's StableHLO);
* ``meta.json``: the inputs' and the parameters' shapes and dtypes,
  with the JAX package's keys.

The apply program is traced on the plain route, with the parameters and
the sample inputs on the CPU: a kernel wrapper runs its plain PyTorch
version on CPU tensors, and ``torch.export`` cannot trace into the
``ctypes`` library a kernel launch goes through (the JAX exporter
likewise lowers for its ``("cpu", "tpu")`` platforms, not for one chip's
kernels).  :func:`load_exported` runs the program on the CPU, or on
another device through ``torch.export``'s device pass.  A serving engine
reads only ``params/`` (:meth:`~autodist_tpu_torch.serving.engine
.ServingEngine.from_artifact`), and runs its kernels itself.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel.common import (dtype_name, flatten_with_names,
                                              unflatten)
from autodist_tpu_torch.resource import _world

_log = logging.getLogger(__name__)
_APPLY_FILE = "apply.pt2"
_META_FILE = "meta.json"
_PARAMS_DIR = "params"
_PARAMS_FILE = "params.pt"


def parse_dtype(name) -> torch.dtype:
    """The ``torch.dtype`` a ``meta.json`` or sidecar string names
    (``"float32"``, ``"bfloat16"``, ``"torch.int32"``, or a numpy
    dtype); an unknown name raises ``ValueError`` naming it."""
    if isinstance(name, torch.dtype):
        return name
    if isinstance(name, np.dtype):
        name = name.name
    found = getattr(torch, str(name).removeprefix("torch."), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"meta.json names dtype {name!r}, which torch "
                         "cannot rebuild")
    return found


def _spec(t: torch.Tensor) -> dict:
    return {"shape": list(t.shape), "dtype": dtype_name(t.dtype)}


class _Apply(torch.nn.Module):
    """``apply_fn`` as a module, the parameters an input."""

    def __init__(self, apply_fn):
        super().__init__()
        self.apply_fn = apply_fn

    def forward(self, params, *inputs):
        return self.apply_fn(params, *inputs)


def export_model(path: str, apply_fn: Callable, params: Any,
                 sample_inputs: Sequence[Any], *,
                 runner: Optional[Any] = None) -> str:
    """Write a serving artifact to ``path``; returns ``path``.

    ``apply_fn(params, *inputs) -> outputs`` is the pure inference
    function.  ``params`` is a logical tree, or ``None`` with a live
    ``runner``, whose ``get_params()`` (unpadded, logical, a gather where
    the strategy shards: every rank calls this) is exported.
    ``sample_inputs`` fix the traced inputs' shapes and dtypes.  Rank 0
    of a job writes the files."""
    if runner is not None:
        params = runner.get_params()
    params = unflatten({nm: torch.as_tensor(t).detach().cpu()
                        for nm, t in flatten_with_names(params)})
    inputs = tuple(torch.as_tensor(x).cpu() for x in sample_inputs)
    if _world()[1] != 0:
        return path
    os.makedirs(os.path.join(path, _PARAMS_DIR), exist_ok=True)
    # 1. The parameters at logical names, readable with torch alone.
    torch.save(params, os.path.join(path, _PARAMS_DIR, _PARAMS_FILE))
    # 2. The apply program, the parameters an input, traced on the CPU.
    with torch.no_grad():
        program = torch.export.export(_Apply(apply_fn), (params, *inputs))
    # The program keeps its example inputs, the parameters among them:
    # params/ holds those already.
    program.example_inputs = None
    torch.export.save(program, os.path.join(path, _APPLY_FILE))
    # 3. The manifest.
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump({"inputs": [_spec(x) for x in inputs],
                   "num_inputs": len(inputs),
                   "params": unflatten({nm: _spec(t) for nm, t in
                                        flatten_with_names(params)})},
                  f, indent=2)
    _log.info("serving export written to %s", path)
    return path


def _check_params(params: dict, meta: dict) -> None:
    """The restored tree against the manifest's shapes and dtypes."""
    spec = meta.get("params")
    if spec is None:
        return
    got = {nm: (tuple(t.shape), t.dtype)
           for nm, t in flatten_with_names(params)}
    if got != _flatten_spec(spec):
        raise ValueError("the artifact's params/ does not match its "
                         "meta.json (shapes or dtypes differ)")


def _flatten_spec(spec, prefix: str = "") -> dict:
    out = {}
    for key in sorted(spec):
        d = spec[key]
        if set(d) == {"shape", "dtype"}:
            out[prefix + key] = (tuple(d["shape"]), parse_dtype(d["dtype"]))
        else:
            out.update(_flatten_spec(d, prefix + key + "/"))
    return out


def _read_meta(path: str) -> dict:
    meta_path = os.path.join(path, _META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_exported_params(path: str, device=None) -> dict:
    """The ``params/`` tree of an artifact (logical names, unpadded
    shapes), on ``device`` (the CPU by default): what a serving engine,
    which lays the parameters out itself, needs."""
    file = os.path.join(path, _PARAMS_DIR, _PARAMS_FILE)
    if not os.path.exists(file):
        raise FileNotFoundError(f"{path!r} holds no {_PARAMS_DIR}/"
                                f"{_PARAMS_FILE}: not an export artifact")
    params = torch.load(file, map_location=device or "cpu",
                        weights_only=True)
    _check_params(params, _read_meta(path))
    return params


class ExportedModel:
    """A loaded serving artifact: ``model(*inputs) -> outputs``."""

    def __init__(self, call, params, meta):
        self._call = call
        self.params = params
        self.meta = meta

    def __call__(self, *inputs):
        return self._call(self.params, *inputs)


def load_exported(path: str, device=None) -> ExportedModel:
    """Load an artifact written by :func:`export_model` onto ``device``
    (``None``: the card; ``"cpu"`` runs it on the CPU): the program moved
    there by ``torch.export``'s device pass, the parameters copied."""
    dev = resolve_device(device)
    program = torch.export.load(os.path.join(path, _APPLY_FILE))
    meta = _read_meta(path)
    params = load_exported_params(path, dev)
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    module = program.module()

    def call(p, *inputs):
        return module(p, *(torch.as_tensor(x).to(dev) for x in inputs))

    return ExportedModel(call, params, meta)
