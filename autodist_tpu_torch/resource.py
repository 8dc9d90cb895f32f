"""Resource model: the spec of the GPUs a job runs on, and its mesh.

Counterpart of ``autodist_tpu/resource.py``, cut to the data-parallel
path: one process per GPU in a ``torch.distributed`` job.  The spec
``{}`` (or ``None``) means every process of the job is one replica on
the ``data`` axis: ``data`` is the process group's world size, or 1
without a process group.  ``{"mesh": {"data": n}}`` states the same
and must match the world size.  :attr:`ResourceSpec.chip` is the
card's :class:`ChipSpec`; only the H100 has one.  Other mesh axes,
other ``topology`` keys and ``multihost`` blocks belong to later slices
(ROADMAP Queue 1, slice 3 and items 8-9) and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from autodist_tpu_torch import const


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card constants for MFU and roofline math."""

    name: str
    peak_bf16_tflops: float      # dense, per card
    peak_fp32_tflops: float      # the CUDA cores, no TF32
    hbm_gb: float
    hbm_gbps: float              # device-memory bandwidth


# H100 SXM: NVIDIA's data sheet (dense rates, 700 W).
H100 = ChipSpec("h100", peak_bf16_tflops=989.0, peak_fp32_tflops=67.0,
                hbm_gb=80, hbm_gbps=3350)


@dataclasses.dataclass
class Mesh:
    """The resolved mesh: axis sizes, the replica group and this
    process's place in it."""

    shape: dict
    group: Any = None            # torch.distributed group (None: one rank)
    rank: int = 0

    @property
    def num_replicas(self) -> int:
        return self.shape[const.DATA_AXIS]


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ResourceSpec:
    """Parses and validates the spec; factory for the mesh."""

    def __init__(self, spec: Optional[Mapping[str, Any]] = None):
        spec = dict(spec or {})
        unknown = set(spec) - {"topology", "mesh"}
        if unknown:
            raise NotImplementedError(
                f"resource spec keys {sorted(unknown)} are not ported yet "
                f"(ROADMAP Queue 1, item 9: runtime and multi-host)")
        topo = dict(spec.get("topology") or {})
        if set(topo) - {"num_devices"}:
            raise NotImplementedError(
                f"topology keys {sorted(set(topo) - {'num_devices'})} are "
                f"not ported yet (ROADMAP Queue 1, slice 3)")
        self._requested_devices = topo.get("num_devices")
        self.mesh_shape: dict = dict(spec.get("mesh") or {})
        for ax in self.mesh_shape:
            if ax not in const.ALL_AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; valid axes: "
                                 f"{const.ALL_AXES}")
            if ax != const.DATA_AXIS:
                raise NotImplementedError(
                    f"mesh axis {ax!r} is not ported yet (ROADMAP Queue 1, "
                    f"slice 3: tensor and pipeline parallel)")

    @property
    def chip(self) -> ChipSpec:
        """The card's constants; raises on any card but an H100."""
        name = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "no CUDA device")
        if "H100" not in name:
            raise NotImplementedError(f"no ChipSpec for {name!r}; only the "
                                      f"H100 has one")
        return H100

    def num_devices(self) -> int:
        """The job's world size (one process per GPU); a declared
        ``topology.num_devices`` must equal it."""
        world, _ = _world()
        if self._requested_devices not in (None, world):
            raise ValueError(
                f"spec declares {self._requested_devices} devices; the "
                f"process group has {world} (one process per GPU)")
        return world

    def resolved_mesh_shape(self) -> dict:
        n = self.num_devices()
        shape = dict(self.mesh_shape) or {const.DATA_AXIS: n}
        if shape[const.DATA_AXIS] != n:
            raise ValueError(f"mesh shape {shape} does not match {n} "
                             f"devices")
        return shape

    def make_mesh(self) -> Mesh:
        world, rank = _world()
        group = dist.group.WORLD if world > 1 else None
        return Mesh(shape=self.resolved_mesh_shape(), group=group, rank=rank)
