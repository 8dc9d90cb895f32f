"""The reshard engine: move training state between strategy layouts.

The port's counterpart of ``autodist_tpu/elastic/reshard.py``.  Given a
source layout (a live lowering's state, or a checkpoint's rank files
and its sidecar's manifest) and a target lowering, it checks the two
state-codec manifests (:meth:`~autodist_tpu_torch.kernel.lowering
.Lowered.state_manifest`) before any data moves (ADT070 errors raise
:class:`ReshardError`; ADT071 re-seeds compressor rows), then moves the
state one leaf at a time:

1. the source's global stored leaf: its ranks' parts joined along each
   ``split`` of its record;
2. the source recipe (stored -> logical), then the target's inverted
   recipe (logical -> target global stored), in the target's dtype;
3. this rank's part of that, cut along each ``split`` of the target's
   record.

Every lowering family's manifest takes this path: the collective,
``replicated_spmd`` and ``simple`` ones, and the ``pipeline`` one,
whose leaves carry the interleave permutation (``index0``), the padded
vocab table and ZeRO-3 rows (``slice``, ``flat_slice``) and split over
pipe, then model or a ZeRO axis (a ZeRO-1/2 state's two splits on one
dim nest: the ZeRO ranks' parts join first, then the pipe ranks').

Two routes, as in the JAX package:

* **fast** (source and target meshes are the same ranks: a live hot
  swap): step 1 is an all-gather over the split axis's group on the
  card, so the transient is one leaf, never a second whole state;
* **staged** (the rank sets differ: a shrink or a grow from a
  checkpoint): leaves stream through the host one
  at a time, each source part read from its rank's ``rank<r>.pt``
  mapped into memory (``torch.load(..., mmap=True)``: only that leaf's
  pages are read); the host working set is one leaf, recorded as
  ``peak_host_bytes``.

Every reshard records a ``kind="reshard"`` event (route, leaves,
recoded leaves, logical bytes, ``peak_host_bytes``, re-seeded rows,
milliseconds) and the ``reshard/bytes_moved`` and
``reshard/peak_host_bytes`` gauges.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import time
from typing import Callable, Optional

import numpy as np
import torch

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.analysis import (LintReport, lint_reshard,
                                         sync_rows_transferable)
from autodist_tpu_torch.checkpoint.export import parse_dtype
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.resource import rank_at
from autodist_tpu_torch.utils import logging


def spec_for_layout(mesh_axes, fallback_devices: int = 1) -> dict:
    """The mesh shape a recorded factorization (a sidecar's
    ``mesh_axes``, a strategy's ``graph_config.mesh_axes``) names: the
    axes as they are, or a data axis of ``fallback_devices`` where none
    is recorded."""
    mesh_axes = {a: int(n) for a, n in dict(mesh_axes or {}).items()}
    return mesh_axes or {"data": max(int(fallback_devices), 1)}


class ReshardError(ValueError):
    """The source and target layouts are incompatible (carries the
    :class:`~autodist_tpu_torch.analysis.LintReport`)."""

    def __init__(self, report):
        self.report = report
        super().__init__(report.render(title="reshard compatibility"))


# --------------------------------------------------------------------------- #
# The recipe-op interpreter (forward = stored -> logical) and its inverse,
# on torch tensors (on the card or on the host).
# --------------------------------------------------------------------------- #
def _pad_to(arr, shape):
    shape = tuple(int(d) for d in shape)
    if tuple(arr.shape) == shape:
        return arr
    out = arr.new_zeros(shape)
    out[tuple(slice(0, s) for s in arr.shape)] = arr
    return out


def apply_ops(arr, ops):
    """``arr`` through a recipe-op chain."""
    for op in ops:
        kind = op["op"]
        if kind == "reshape":
            arr = arr.reshape(tuple(op["shape"]))
        elif kind == "slice":
            arr = arr[tuple(slice(0, int(s)) for s in op["shape"])]
        elif kind == "index0":
            arr = arr.index_select(0, torch.as_tensor(
                op["indices"], dtype=torch.long, device=arr.device))
        elif kind == "flat_slice":
            arr = arr.reshape(-1)[:int(op["size"])]
        elif kind == "pad":
            arr = _pad_to(arr, op["shape"])
        elif kind == "pad_flat":
            shape = tuple(op["shape"])
            size = math.prod(shape) if shape else 1
            arr = _pad_to(arr.reshape(-1), (size,)).reshape(shape)
        else:
            raise ValueError(f"unknown recipe op {kind!r}")
    return arr


def invert_ops(ops) -> list:
    """The logical -> stored chain of a stored -> logical recipe (the
    padding it re-inserts is zero)."""
    inv = []
    for op in reversed(list(ops)):
        kind = op["op"]
        if kind == "reshape":
            inv.append({"op": "reshape", "shape": list(op["in_shape"])})
        elif kind == "slice":
            inv.append({"op": "pad", "shape": list(op["in_shape"])})
        elif kind == "index0":
            order = sorted(range(len(op["indices"])),
                           key=op["indices"].__getitem__)
            inv.append({"op": "index0", "indices": order})
        elif kind == "flat_slice":
            inv.append({"op": "pad_flat", "shape": list(op["in_shape"])})
        else:
            raise ValueError(f"recipe op {kind!r} is not invertible")
    return inv


def splits_of(record) -> list:
    """A leaf record's ``split`` as a list, outermost first."""
    split = record.get("split")
    if split is None:
        return []
    return list(split) if isinstance(split, list) else [split]


def _join(parts, dim: int, ndim: int):
    """The parts of one split joined along ``dim``; parts with a dim
    fewer than the global form are its slices (compressor rows)."""
    if parts[0].dim() < ndim:
        return torch.stack(parts, dim)
    return torch.cat(parts, dim) if len(parts) > 1 else parts[0]


def _part(arr, split: dict, index: int):
    """Part ``index`` of ``arr`` along a split."""
    return arr.chunk(int(split["ranks"]), dim=int(split["dim"]))[index]


# --------------------------------------------------------------------------- #
# Planning
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ReshardPlan:
    """Per-leaf routes and the compatibility report, computed before
    any data moves."""

    report: LintReport
    routes: dict                 # path -> "noop" | "recode"
    sync_transfer: set           # sync_state paths moved verbatim
    sync_reinit: set             # sync_state paths re-seeded on the target
    bytes_logical: int = 0       # total logical payload bytes

    @property
    def ok(self) -> bool:
        return self.report.ok

    def require_ok(self):
        if not self.report.ok:
            raise ReshardError(self.report)
        return self


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=parse_dtype(dtype)).element_size()


def plan_reshard(source_manifest: dict, target_manifest: dict
                 ) -> ReshardPlan:
    """Lint the two manifests (ADT070, ADT071) and classify every
    leaf's route; raises nothing (gate on :meth:`ReshardPlan
    .require_ok`), so that one call shows every finding."""
    report = lint_reshard(source_manifest, target_manifest)
    src, dst = source_manifest["leaves"], target_manifest["leaves"]
    src_sync = source_manifest.get("sync", {})
    dst_sync = target_manifest.get("sync", {})
    routes, transfer, reinit, nbytes = {}, set(), set(), 0
    for path in sorted(set(src) & set(dst)):
        s, d = src[path], dst[path]
        if path in dst_sync:
            same = path in src_sync and sync_rows_transferable(
                src_sync[path], dst_sync[path])
            (transfer if same else reinit).add(path)
            continue
        routes[path] = ("noop" if s["ops"] == d["ops"]
                        and s["stored_shape"] == d["stored_shape"]
                        else "recode")
        elems = math.prod(s["logical_shape"]) if s["logical_shape"] else 1
        nbytes += elems * _itemsize(s["dtype"])
    reinit |= set(dst_sync) - set(src_sync) - transfer
    return ReshardPlan(report=report, routes=routes, sync_transfer=transfer,
                       sync_reinit=reinit, bytes_logical=int(nbytes))


def shard_budget(*lowered_state_pairs) -> int:
    """The largest element count one rank stores of a leaf, over the
    given ``(lowered, state)`` pairs: the granularity the fast route's
    transient stays at (one gathered leaf at a time)."""
    return max([1] + [int(t.numel()) for _, state in lowered_state_pairs
                      for _, t in common.state_leaves(state)])


# --------------------------------------------------------------------------- #
# The ranks' parts: where they are, and who holds which
# --------------------------------------------------------------------------- #
def _axis(lowered, name: str):
    """The :class:`~autodist_tpu_torch.parallel.axis.Axis` a split names
    on ``lowered``'s mesh (a joint axis as the lowering made it: the
    mesh keeps each)."""
    return lowered.mesh.joint_axis(tuple(name.split("+")))


def _my_part(arr, record: dict, lowered):
    """This rank's part of a global stored leaf, per the target record's
    splits (outermost first)."""
    for split in splits_of(record):
        arr = _part(arr, split, _axis(lowered, split["axis"]).index)
    return arr


def _sync_row(rows, record: dict, lowered):
    """This rank's compressor row of the global ``[rows, width]``."""
    (split,) = splits_of(record)
    return rows[_axis(lowered, split["axis"]).index]


def _sync_seed(lowered, path: str, record: dict, like):
    """A re-seeded compressor row: the target's init row (a zero
    residual where it records none)."""
    key = path.split("/", 1)[1]
    row = (lowered.sync_init or {}).get(key)
    out = (torch.zeros(like.shape, dtype=like.dtype) if row is None
           else torch.as_tensor(row).to(like.dtype))
    return out.to(lowered.device)


def _same_ranks(src_lowered, dst_lowered) -> bool:
    """Whether both meshes cover the same ranks of this job."""
    return (math.prod(src_lowered.mesh.shape.values())
            == math.prod(dst_lowered.mesh.shape.values())
            and src_lowered.mesh.grouped and dst_lowered.mesh.grouped)


class FileSource:
    """The global stored leaves of a full checkpoint step: each rank's
    ``rank<r>.pt`` mapped into memory once, each leaf joined from the
    parts its writers hold (``mesh``: the writers' mesh shape)."""

    def __init__(self, step_dir: str, manifest: dict, mesh: dict):
        self.step_dir, self.manifest, self.mesh = step_dir, manifest, mesh
        self._ranks: dict = {}

    @property
    def payload0(self) -> dict:
        """Rank 0's payload (its seed stream and step)."""
        return self._load(0)[0]

    def _load(self, rank: int) -> dict:
        if rank not in self._ranks:
            payload = torch.load(
                os.path.join(self.step_dir, f"rank{rank}.pt"),
                map_location="cpu", mmap=True, weights_only=False)
            self._ranks[rank] = (payload, dict(common.state_leaves(
                payload["state"])))
        return self._ranks[rank]

    def unreadable(self) -> list:
        """``(rank, what)`` for each writer whose ``rank<r>.pt`` cannot
        be read or lacks a leaf the manifest declares (every writer
        holds every leaf, its own part of each)."""
        declared = set(self.manifest["leaves"])
        bad = []
        for r in range(math.prod(int(n) for n in self.mesh.values())):
            try:
                leaves = self._load(r)[1]
            except (OSError, RuntimeError, EOFError,
                    pickle.UnpicklingError) as e:
                bad.append((r, f"unreadable ({type(e).__name__}: {e})"))
                continue
            missing = sorted(declared - set(leaves))
            if missing:
                bad.append((r, f"missing {len(missing)} leaves, e.g. "
                               f"{missing[0]!r}"))
        return bad

    def __call__(self, name: str):
        record = self.manifest["leaves"][name]
        splits = splits_of(record)
        ndim = len(record["stored_shape"])

        def build(level: int, coords: dict):
            if level == len(splits):
                return self._load(rank_at(self.mesh, coords))[1][name]
            split = splits[level]
            names = split["axis"].split("+")
            parts = []
            for i in range(int(split["ranks"])):
                sub = [int(self.mesh[a]) for a in names]
                at = dict(coords)
                for a, c in zip(names, np.unravel_index(i, sub)):
                    at[a] = int(c)
                parts.append(build(level + 1, at))
            return _join(parts, int(split["dim"]), ndim)

        return build(0, {})


class LiveSource:
    """The global stored leaves of a live state: each leaf's parts
    gathered over its split axes' groups (innermost first), on the
    state's device."""

    def __init__(self, lowered, state, manifest: dict):
        self.lowered, self.manifest = lowered, manifest
        self.leaves = dict(common.state_leaves(state))

    def __call__(self, name: str):
        arr = self.leaves[name]
        record = self.manifest["leaves"][name]
        ndim = len(record["stored_shape"])
        for split in reversed(splits_of(record)):
            axis = _axis(self.lowered, split["axis"])
            if arr.dim() < ndim:
                arr = arr.unsqueeze(int(split["dim"]))
            arr = axis.all_gather(arr.contiguous(), dim=int(split["dim"]))
        return arr


# --------------------------------------------------------------------------- #
# Execution
# --------------------------------------------------------------------------- #
def _convert(read: Callable, src_m: dict, dst_m: dict, plan: ReshardPlan,
             dst_lowered, template, *, staged: bool):
    """The target state: the template's structure, each leaf converted
    (steps 1-3 of the module docstring).  Returns ``(state, peak host
    bytes)``; the source's leaves are read once each, in the
    template's order."""
    dst_sync = dst_m.get("sync", {})
    dev = dst_lowered.device
    peak = 0

    def build(name, like):
        nonlocal peak
        rec_d = dst_m["leaves"][name]
        if name in dst_sync:
            if name not in plan.sync_transfer:
                return _sync_seed(dst_lowered, name, rec_d, like)
            rows = read(name)
            peak = max(peak, int(rows.nbytes) if staged else 0)
            return _sync_row(rows, rec_d, dst_lowered).to(
                dev, like.dtype).clone()
        rec_s = src_m["leaves"][name]
        glob = read(name)
        held = [glob]
        arr = glob
        if plan.routes.get(name) != "noop":
            arr = apply_ops(arr, rec_s["ops"])
            held.append(arr)
            arr = apply_ops(arr, invert_ops(rec_d["ops"]))
            held.append(arr)
        arr = _my_part(arr.to(parse_dtype(rec_d["dtype"])), rec_d,
                       dst_lowered)
        out = arr.to(dev).clone()
        if staged:
            peak = max(peak, sum(int(t.nbytes) for t in held)
                       + int(out.nbytes if out.device.type == "cpu" else 0))
        return out

    state = common.map_state(build, template)
    return state, peak


def build_convert_fn(src_lowered, src_state, dst_lowered, template, *,
                     plan: Optional[ReshardPlan] = None):
    """The fast route as a function ``convert(src_state) -> dst_state``
    (both meshes the same ranks), and its plan."""
    src_m = src_lowered.state_manifest(src_state)
    dst_m = dst_lowered.state_manifest(template)
    plan = (plan or plan_reshard(src_m, dst_m)).require_ok()

    def convert(state):
        return _convert(LiveSource(src_lowered, state, src_m), src_m, dst_m,
                        plan, dst_lowered, template, staged=False)[0]

    return convert, plan


def reshard_state(src_lowered, src_state, dst_lowered, template):
    """``src_state`` (the source lowering's layout) moved onto the
    target lowering's by the fast route; ``template`` is a state of the
    target's layout (its runner's state, or a tree of ``meta`` tensors
    of its shapes and dtypes), whose structure the result takes.  Both
    lowerings are this job's, on the same ranks; a source on other ranks
    restores from a checkpoint (:meth:`~autodist_tpu_torch.checkpoint
    .Saver.restore_elastic`)."""
    t0 = time.perf_counter()
    if not _same_ranks(src_lowered, dst_lowered):
        raise ValueError(
            f"the source mesh {dict(src_lowered.mesh.shape)} and the "
            f"target mesh {dict(dst_lowered.mesh.shape)} are not the same "
            "ranks of this job: a live reshard moves state within one "
            "job; restore another job's state from its checkpoint "
            "(Saver.restore_elastic)")
    convert, plan = build_convert_fn(src_lowered, src_state, dst_lowered,
                                     template)
    state = convert(src_state)
    _record(plan, "fast", t0, peak_host=0)
    return state


def assemble_state(dst_lowered, read: Callable, src_manifest: dict,
                   template, *, plan: Optional[ReshardPlan] = None,
                   t0: Optional[float] = None) -> dict:
    """The staged route from a reader of global stored leaves (a
    :class:`FileSource`): every target leaf converted one at a time on
    the host and placed; returns the target state."""
    t0 = time.perf_counter() if t0 is None else t0
    dst_m = dst_lowered.state_manifest(template)
    plan = (plan or plan_reshard(src_manifest, dst_m)).require_ok()
    state, peak = _convert(read, src_manifest, dst_m, plan, dst_lowered,
                           template, staged=True)
    _record(plan, "staged", t0, peak_host=peak)
    return state


def meta_template(state):
    """``state``'s structure with ``meta`` tensors of its shapes and
    dtypes: a reshard's template that holds no memory."""
    return common.map_state(
        lambda _, t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        state)


def _record(plan: ReshardPlan, route: str, t0: float, *, peak_host: int):
    dt = time.perf_counter() - t0
    recoded = sum(1 for r in plan.routes.values() if r == "recode")
    telemetry.gauge("reshard/bytes_moved").set(plan.bytes_logical)
    telemetry.gauge("reshard/peak_host_bytes").set(peak_host)
    telemetry.record_event(
        "reshard", route=route, leaves=len(plan.routes), recoded=recoded,
        bytes_moved=plan.bytes_logical, peak_host_bytes=peak_host,
        sync_reinit=len(plan.sync_reinit), duration_ms=dt * 1e3)
    logging.info(
        "reshard (%s route): %d leaves (%d recoded), %.1f MB logical, "
        "peak host %.1f MB, %d compressor row(s) re-seeded, %.0f ms",
        route, len(plan.routes), recoded, plan.bytes_logical / 1e6,
        peak_host / 1e6, len(plan.sync_reinit), dt * 1e3)
