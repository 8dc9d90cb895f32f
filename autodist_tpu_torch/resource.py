"""Resource model: the spec of the GPUs a job runs on, and its mesh.

Counterpart of ``autodist_tpu/resource.py``: one process per rank of a
``torch.distributed`` job.  The spec ``{}`` (or ``None``) means every
process of the job is one replica on the ``data`` axis: ``data`` is the
process group's world size, or 1 without a process group.  ``{"mesh":
{"data": d, "pipe": p, "model": t}}`` (or ``{"data": d, "expert": e}``,
or ``{"data": d, "seq": s}``) lays the job out as a mesh whose sizes
multiply to the world size; ranks map to mesh coordinates row-major over the declared axes, as the JAX
package reshapes its device list (declare ``model``, ``expert`` or
``seq`` last to put each such group on adjacent ranks: ``{"data",
"pipe", "model"}`` puts each model pair of a pipe coordinate on
neighbouring ranks, ``{"data": 2, "seq": 2}`` each seq pair).
:meth:`ResourceSpec.make_mesh` builds one process group per axis line
(:class:`~autodist_tpu_torch.parallel.axis.Axis`; ``mesh.axis("pipe")``
is this rank's pipe line, the ring the pipe schedule shifts activations
along), and :meth:`Mesh.joint_axis` one over several axes (``data x
expert``).

:attr:`ResourceSpec.chip` is the card's :class:`ChipSpec`; only the H100
has one.  The ``dcn`` axis, other ``topology`` keys and ``multihost``
blocks belong to later items and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.axis import Axis


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


# Mesh axes the port lays out, and where the others come.
_PORTED_AXES = (const.DATA_AXIS, const.PIPE_AXIS, const.MODEL_AXIS,
                const.EXPERT_AXIS, const.SEQ_AXIS)
_AXIS_ITEMS = {
    const.DCN_AXIS: "ROADMAP Queue 1, item 9: runtime and multi-host",
}


@dataclasses.dataclass
class Mesh:
    """The resolved mesh: axis sizes and one
    :class:`~autodist_tpu_torch.parallel.axis.Axis` per axis of more
    than one rank."""

    shape: dict
    axes: dict = dataclasses.field(default_factory=dict)
    rank: int = 0

    def axis(self, name: str) -> Axis:
        """The named axis (a one-rank axis where the mesh has none)."""
        return self.axes.get(name) or Axis(name)

    def joint_axis(self, names) -> Axis:
        """One axis over several mesh axes (``lax.axis_index`` of a
        tuple): its index is this rank's coordinates on ``names``
        row-major, its group the ranks that differ only on them.  Every
        process of the job must call it, in the same order (a new group
        is collective).  The group's collectives are reductions; its
        rank order is the global one."""
        names = tuple(n for n in names if self.shape.get(n, 1) > 1)
        if len(names) <= 1:
            return self.axis(names[0]) if names else Axis("+".join(names))
        order, sizes = list(self.shape), list(self.shape.values())
        dims = [order.index(n) for n in names]
        sub = [sizes[d] for d in dims]
        size, world = math.prod(sub), math.prod(sizes)
        coords = np.unravel_index(self.rank, sizes)
        index = int(np.ravel_multi_index([coords[d] for d in dims], sub))
        mine = None
        others = [range(s) if d not in dims else (0,)
                  for d, s in enumerate(sizes)]
        for line in itertools.product(*others):
            ranks = []
            for j in range(size):
                at = list(line)
                for d, c in zip(dims, np.unravel_index(j, sub)):
                    at[d] = int(c)
                ranks.append(int(np.ravel_multi_index(at, sizes)))
            group = (dist.group.WORLD if size == world
                     else dist.new_group(ranks))
            if self.rank in ranks:
                mine = Axis("+".join(names), size=size, index=index,
                            ranks=tuple(ranks), group=group)
        return mine

    @property
    def num_replicas(self) -> int:
        return self.shape.get(const.DATA_AXIS, 1)

    @property
    def replica(self) -> int:
        """This process's index on the data axis."""
        return self.axis(const.DATA_AXIS).index

    @property
    def group(self) -> Any:
        """The data axis's process group (``None`` at one replica)."""
        return self.axis(const.DATA_AXIS).group


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
                f"not ported yet (ROADMAP Queue 1, item 9: runtime and "
                f"multi-host)")
        self._requested_devices = topo.get("num_devices")
        self.mesh_shape: dict = dict(spec.get("mesh") or {})
        for ax in self.mesh_shape:
            if ax not in const.ALL_AXES:
                raise ValueError(f"unknown mesh axis {ax!r}; valid axes: "
                                 f"{const.ALL_AXES}")
            if ax not in _PORTED_AXES:
                raise NotImplementedError(
                    f"mesh axis {ax!r} is not ported yet ({_AXIS_ITEMS[ax]})")

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
        """The mesh shape; ``{}`` means one data axis over the world.
        The sizes must multiply to the world."""
        n = self.num_devices()
        shape = dict(self.mesh_shape) or {const.DATA_AXIS: n}
        if math.prod(shape.values()) != n:
            raise ValueError(f"mesh shape {shape} does not match {n} "
                             f"devices")
        return shape

    def make_mesh(self) -> Mesh:
        """The mesh and its axis groups.  Every process of the job must
        call it (``torch.distributed.new_group`` is collective), in the
        same order as the others."""
        world, rank = _world()
        shape = self.resolved_mesh_shape()
        names, sizes = list(shape), list(shape.values())
        coords = np.unravel_index(rank, sizes) if sizes else ()
        axes = {}
        for i, name in enumerate(names):
            if sizes[i] == 1:
                continue
            others = [range(s) if j != i else (0,)
                      for j, s in enumerate(sizes)]
            for line in itertools.product(*others):
                ranks = []
                for k in range(sizes[i]):
                    at = list(line)
                    at[i] = k
                    ranks.append(int(np.ravel_multi_index(at, sizes)))
                group = (dist.group.WORLD if sizes[i] == world
                         else dist.new_group(ranks))
                if rank in ranks:
                    axes[name] = Axis(name, size=sizes[i],
                                      index=int(coords[i]),
                                      ranks=tuple(ranks), group=group)
        return Mesh(shape=shape, axes=axes, rank=rank)

