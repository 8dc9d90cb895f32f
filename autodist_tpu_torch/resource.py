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
has one.  ``topology.platform`` is ``"gpu"``, ``"cpu"`` or ``"auto"``;
``topology.generation`` is ``"h100"`` or ``"auto"`` (the card's name
decides; an unknown name warns and falls back to it, as the JAX
package's ``_detect_generation`` does).

A ``multihost`` block (``coordinator``, ``num_processes``,
``process_id``, each defaulting to its ``AUTODIST_TPU_*`` variable, and
``local_rank`` / ``local_processes``, defaulting to torchrun's
``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; a
:class:`~autodist_tpu_torch.runtime.cluster.Cluster` fills both in)
makes the job span processes: :meth:`ResourceSpec.bootstrap` joins
this process to the job's ``torch.distributed`` group at
``tcp://<coordinator>``, over NCCL where every rank of this host has a
card of its own, else over gloo (the CPU, or ranks sharing a card:
NCCL refuses two ranks on one device).  The choice is made from the
device count and the ranks on the host, never by catching a failure.
Where the ranks on the host are not given, a job that fits this host's
cards one rank a card is taken to be on this host; a larger one raises
(it may span hosts, or share cards: the count decides the backend).
Until it has bootstrapped, a multihost spec plans on its declared
``topology.num_devices`` and raises without one, as the JAX package
does.

Multi-slice: ``dcn`` is the outermost replica axis, the JAX package's
cross-slice axis.  On H100s a slice is one node's NVLink domain, and
slices are joined over InfiniBand or Ethernet.  ``{"topology":
{"num_slices": s}}`` without a ``mesh`` resolves to ``{"dcn": s,
"data": n / s}``; ``{"mesh": {"dcn": d, "data": n, ...}}`` declares it.
The replica group is ``dcn x data`` (:meth:`Mesh.replica_axis`): every
lowering reduces its gradients, shards its ZeRO state and splits its
batch over it.  Where an NCCL job spans hosts, :meth:`ResourceSpec
.make_mesh` checks that each ``dcn`` coordinate's ranks are one host's
(the counterpart of ``create_hybrid_device_mesh``; the ranks are
node-major, as torchrun numbers them) and raises a ``ValueError``
naming the hosts where the row-major layout does not do that.  Gloo
ranks, and ranks that share one host, carry no slice topology: they
keep the plain row-major layout, as the JAX package keeps the reshape
for simulated devices.
"""
from __future__ import annotations

import copy
import dataclasses
import datetime
import itertools
import math
import os
import socket
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import const
from autodist_tpu_torch.parallel.axis import Axis
from autodist_tpu_torch.utils import logging


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
CHIP_SPECS = {"h100": H100}
PLATFORMS = ("auto", "gpu", "cpu")
# The replica axes, outermost first (JAX ``replica_axes``).
REPLICA_AXES = (const.DCN_AXIS, const.DATA_AXIS)


def _check_axes(mesh_shape: Mapping[str, int]):
    for ax in mesh_shape:
        if ax not in const.ALL_AXES:
            raise ValueError(f"unknown mesh axis {ax!r}; valid axes: "
                             f"{const.ALL_AXES}")


@dataclasses.dataclass
class Mesh:
    """The resolved mesh: axis sizes and one
    :class:`~autodist_tpu_torch.parallel.axis.Axis` per axis of more
    than one rank."""

    shape: dict
    axes: dict = dataclasses.field(default_factory=dict)
    rank: int = 0
    grouped: bool = True      # False: a layout without process groups
    _joints: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    def axis(self, name: str) -> Axis:
        """The named axis (a one-rank axis where the mesh has none)."""
        return self.axes.get(name) or Axis(name)

    def joint_axis(self, names) -> Axis:
        """One axis over several mesh axes (``lax.axis_index`` of a
        tuple): its index is this rank's coordinates on ``names``
        row-major, its group the ranks that differ only on them.  Every
        process of the job must call it, in the same order (a new group
        is collective); the mesh keeps each joint axis, so a second call
        makes no group.  The group's collectives are reductions; its
        rank order is the global one (names in the mesh's order make
        its gathers follow the index too)."""
        names = tuple(n for n in names if self.shape.get(n, 1) > 1)
        if len(names) <= 1:
            return self.axis(names[0]) if names else Axis("+".join(names))
        if names not in self._joints:
            self._joints[names] = self._make_joint(names)
        return self._joints[names]

    def _make_joint(self, names) -> Axis:
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
            group = (None if not self.grouped
                     else dist.group.WORLD if size == world
                     else dist.new_group(ranks))
            if self.rank in ranks:
                mine = Axis("+".join(names), size=size, index=index,
                            ranks=tuple(ranks), group=group)
        return mine

    def replica_axis(self) -> Axis:
        """The replica group, ``dcn x data``, as one axis (its ranks in
        the mesh's order): what the data-parallel lowerings reduce
        gradients, shard ZeRO state and split the batch over.  The data
        axis itself where there is no ``dcn`` axis of more than one
        rank."""
        if self.num_replicas == 1:
            return self.axis(const.DATA_AXIS)
        order = list(self.shape)
        return self.joint_axis(tuple(sorted(
            (a for a in REPLICA_AXES if a in self.shape), key=order.index)))

    @property
    def num_replicas(self) -> int:
        return math.prod(self.shape.get(a, 1) for a in REPLICA_AXES)


def layout_mesh(shape: Mapping[str, int], rank: int = 0) -> Mesh:
    """The mesh of ``shape`` as rank ``rank`` sees it, with no process
    groups: the sizes and indices a lowering's plan and state manifest
    read, for a job that is not this one (a checkpoint's writers)."""
    shape = {a: int(n) for a, n in shape.items()}
    sizes = list(shape.values())
    coords = np.unravel_index(rank, sizes) if sizes else ()
    axes = {}
    for i, (name, size) in enumerate(shape.items()):
        if size > 1:
            ranks = []
            for k in range(size):
                at = [int(c) for c in coords]
                at[i] = k
                ranks.append(int(np.ravel_multi_index(at, sizes)))
            axes[name] = Axis(name, size=size, index=int(coords[i]),
                              ranks=tuple(ranks))
    return Mesh(shape=shape, axes=axes, rank=rank, grouped=False)


def rank_at(shape: Mapping[str, int], coords: Mapping[str, int]) -> int:
    """The rank at mesh coordinates ``coords`` (an axis not named: 0)."""
    sizes = [int(n) for n in shape.values()]
    return int(np.ravel_multi_index(
        [int(coords.get(a, 0)) for a in shape], sizes)) if sizes else 0


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ResourceSpec:
    """Parses and validates the spec; factory for the mesh."""

    def __init__(self, spec: Optional[Mapping[str, Any]] = None):
        spec = dict(spec or {})
        unknown = set(spec) - {"topology", "mesh", "multihost"}
        if unknown:
            raise ValueError(f"unknown resource spec keys {sorted(unknown)}")
        topo = dict(spec.get("topology") or {})
        extra = set(topo) - {"num_devices", "platform", "generation",
                             "num_slices"}
        if extra:
            raise ValueError(f"unknown topology keys {sorted(extra)}")
        # Multi-slice: the outer replica axis rides the network between
        # nodes (a slice is one node's NVLink domain).
        self.num_slices: int = int(topo.get("num_slices", 1))
        if self.num_slices < 1:
            raise ValueError(f"topology.num_slices must be >= 1, got "
                             f"{self.num_slices}")
        self.platform: str = topo.get("platform", "auto")
        if self.platform not in PLATFORMS:
            raise ValueError(f"topology.platform {self.platform!r}; "
                             f"expected one of {PLATFORMS}")
        self.generation: str = str(topo.get("generation", "auto")).lower()
        self._requested_devices = topo.get("num_devices")
        self.mesh_shape: dict = dict(spec.get("mesh") or {})
        _check_axes(self.mesh_shape)
        mh = dict(spec.get("multihost") or {})
        unknown = set(mh) - {"coordinator", "num_processes", "process_id",
                             "local_rank", "local_processes"}
        if unknown:
            raise ValueError(f"unknown multihost keys {sorted(unknown)}")
        self.coordinator: str = mh.get(
            "coordinator", const.ENV.AUTODIST_TPU_COORDINATOR.val)
        self.num_processes: int = int(mh.get(
            "num_processes", const.ENV.AUTODIST_TPU_NUM_PROCESSES.val))
        self.process_id: int = int(mh.get(
            "process_id", const.ENV.AUTODIST_TPU_PROCESS_ID.val))
        local_rank = mh.get("local_rank", os.environ.get("LOCAL_RANK"))
        local = mh.get("local_processes", os.environ.get("LOCAL_WORLD_SIZE"))
        self.local_rank: Optional[int] = (None if local_rank is None
                                          else int(local_rank))
        self.local_processes: Optional[int] = (None if local is None
                                               else int(local))
        if not 0 <= self.process_id < max(self.num_processes, 1):
            raise ValueError(f"multihost process_id {self.process_id} is "
                             f"not a rank of {self.num_processes}")
        self._bootstrapped = False

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1

    @property
    def chip(self) -> ChipSpec:
        """The card's constants: the declared generation's, else the
        card's own; raises on any card but an H100."""
        if self.generation in CHIP_SPECS:
            return CHIP_SPECS[self.generation]
        if self.generation != "auto":
            logging.warning(
                "unrecognized chip generation %r (valid: %s); falling back "
                "to the card's name", self.generation, sorted(CHIP_SPECS))
        name = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                else "no CUDA device")
        if "H100" not in name:
            raise NotImplementedError(f"no ChipSpec for {name!r}; only the "
                                      f"H100 has one")
        return H100

    def num_devices(self) -> int:
        """The job's world size (one process per GPU); a declared
        ``topology.num_devices`` must equal it.  A multihost spec that
        has not bootstrapped plans on its declared count and raises
        without one: counting the world would join the job mid-plan.  A
        process with no process group plans on a declared count too (a
        chief planning before its workers start, as the JAX package
        does); :meth:`make_mesh` then needs the world to match."""
        if self.is_multihost and not self._bootstrapped:
            if self._requested_devices is None:
                raise ValueError(
                    "multihost planning needs an explicit device inventory: "
                    "declare topology.num_devices (the global count), or "
                    "bootstrap() first")
            return int(self._requested_devices)
        if self._requested_devices is not None and not (
                dist.is_available() and dist.is_initialized()):
            return int(self._requested_devices)
        world, _ = _world()
        if self._requested_devices not in (None, world):
            raise ValueError(
                f"spec declares {self._requested_devices} devices; the "
                f"process group has {world} (one process per GPU)")
        return world

    def resolved_mesh_shape(self) -> dict:
        """The mesh shape; ``{}`` means one data axis over the world,
        split as ``dcn x data`` where the topology declares slices.  The
        sizes must multiply to the world."""
        n = self.num_devices()
        shape = dict(self.mesh_shape)
        if not shape and self.num_slices > 1:
            if n % self.num_slices:
                raise ValueError(f"{n} devices do not divide into "
                                 f"{self.num_slices} slices")
            shape = {const.DCN_AXIS: self.num_slices,
                     const.DATA_AXIS: n // self.num_slices}
        shape = shape or {const.DATA_AXIS: n}
        if math.prod(shape.values()) != n:
            raise ValueError(f"mesh shape {shape} does not match {n} "
                             f"devices")
        return shape

    def with_mesh(self, mesh_shape: Mapping[str, int]) -> "ResourceSpec":
        """A copy of this spec with another factorization of the same
        job (platform, generation, devices, slice count and multihost
        state shared)."""
        _check_axes(mesh_shape)
        clone = copy.copy(self)
        clone.mesh_shape = dict(mesh_shape)
        return clone

    def three_d(self) -> tuple:
        """The resolved ``(dp, pp, tp)`` degrees, ``dp`` folding the
        ``dcn`` axis in (both are data parallelism); a mesh with another
        axis of more than one rank is not such a factorization."""
        shape = self.resolved_mesh_shape()
        extra = {a: s for a, s in shape.items() if s > 1 and a not in (
            const.DATA_AXIS, const.DCN_AXIS, const.PIPE_AXIS,
            const.MODEL_AXIS)}
        if extra:
            raise ValueError(f"not a (data, pipe, model) factorization: "
                             f"mesh also carries {extra}")
        return (shape.get(const.DATA_AXIS, 1) * shape.get(const.DCN_AXIS, 1),
                shape.get(const.PIPE_AXIS, 1), shape.get(const.MODEL_AXIS, 1))

    @property
    def card_index(self) -> int:
        """This process's card under NCCL: ``local_rank``, else its rank
        among ``local_processes`` a host, else ``process_id``."""
        if self.local_rank is not None:
            return self.local_rank
        return self.process_id % (self.local_processes or self.num_processes)

    def backend(self) -> str:
        """The job's ``torch.distributed`` backend: NCCL where this
        host's ranks each have a card of their own, gloo on the CPU or
        where ranks share a card."""
        if self.platform == "cpu" or not torch.cuda.is_available():
            return "gloo"
        cards, local = torch.cuda.device_count(), self.local_processes
        if local is None:
            if self.num_processes > cards:
                raise ValueError(
                    f"a job of {self.num_processes} processes on a host of "
                    f"{cards} card(s): declare how many of its ranks run on "
                    "this host (multihost.local_processes and local_rank, "
                    "or LOCAL_WORLD_SIZE and LOCAL_RANK as torchrun sets "
                    "them; a Cluster launch fills them in), which decides "
                    "NCCL (one rank a card) or gloo (ranks sharing a card)")
            local = self.num_processes
        return "nccl" if cards >= local else "gloo"

    def bootstrap(self):
        """Join this process to the job's process group (a multihost
        spec; nothing otherwise).  Idempotent, and latched only after
        success, so that a coordinator not up yet can be retried.  Under
        NCCL this process's card is ``cuda:<card_index>``."""
        if self._bootstrapped:
            return
        if self.is_multihost:
            if dist.is_initialized():
                if (dist.get_world_size(), dist.get_rank()) != \
                        (self.num_processes, self.process_id):
                    raise ValueError(
                        f"this process already belongs to a job of "
                        f"{dist.get_world_size()} rank(s) as rank "
                        f"{dist.get_rank()}; the spec says rank "
                        f"{self.process_id} of {self.num_processes}")
            else:
                if not self.coordinator:
                    raise ValueError(
                        "a multihost spec needs multihost.coordinator (or "
                        "AUTODIST_TPU_COORDINATOR): the host:port rank 0 "
                        "serves the job's rendezvous on")
                backend = self.backend()
                if backend == "nccl":
                    torch.cuda.set_device(self.card_index)
                logging.info("init_process_group(%s, tcp://%s, rank %d of %d)",
                             backend, self.coordinator, self.process_id,
                             self.num_processes)
                dist.init_process_group(
                    backend, init_method=f"tcp://{self.coordinator}",
                    rank=self.process_id, world_size=self.num_processes,
                    timeout=datetime.timedelta(seconds=300))
        self._bootstrapped = True

    def to_dict(self) -> dict:
        return {
            "topology": {"platform": self.platform,
                         "generation": self.generation,
                         "num_devices": self._requested_devices},
            "mesh": dict(self.mesh_shape),
            "multihost": {"coordinator": self.coordinator,
                          "num_processes": self.num_processes,
                          "process_id": self.process_id},
        }

    def make_mesh(self) -> Mesh:
        """The mesh and its axis groups (a multihost spec bootstraps
        first).  Every process of the job must call it
        (``torch.distributed.new_group`` is collective), in the same
        order as the others."""
        self.bootstrap()
        world, rank = _world()
        shape = self.resolved_mesh_shape()
        if math.prod(shape.values()) != world:
            raise ValueError(
                f"mesh {shape} needs {math.prod(shape.values())} ranks; the "
                f"process group has {world} (one process per GPU)")
        if shape.get(const.DCN_AXIS, 1) > 1 and world > 1 \
                and dist.get_backend() == "nccl":
            check_slice_layout(shape, _hosts_of_ranks())
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
        mesh = Mesh(shape=shape, axes=axes, rank=rank)
        mesh.replica_axis()       # the dcn x data group, made by every rank
        return mesh


def _hosts_of_ranks() -> list:
    """Each rank's host name, in rank order (one ``all_gather_object``
    over the default group)."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    return hosts


def check_slice_layout(shape: Mapping[str, int], hosts) -> None:
    """Where the ranks span hosts (``hosts``: each rank's host, in rank
    order), each ``dcn`` coordinate's ranks must be one host's and each
    host one coordinate's: the row-major layout of ``shape`` must put
    the cross-slice axis on the slice boundaries, or the data axis's
    collectives would cross the slow links (JAX
    ``create_hybrid_device_mesh``).  Ranks on one host carry no slice
    topology and pass."""
    hosts = list(hosts)
    if len(set(hosts)) <= 1 or shape.get(const.DCN_AXIS, 1) <= 1:
        return
    sizes = [int(n) for n in shape.values()]
    dcn_dim = list(shape).index(const.DCN_AXIS)
    by_coord: dict = {}
    for r, host in enumerate(hosts):
        c = int(np.unravel_index(r, sizes)[dcn_dim])
        by_coord.setdefault(c, set()).add(host)
    owners: dict = {}
    for c, held in by_coord.items():
        for host in held:
            owners.setdefault(host, set()).add(c)
    if any(len(held) > 1 for held in by_coord.values()) or \
            any(len(cs) > 1 for cs in owners.values()):
        layout = "; ".join(f"dcn {c}: {', '.join(sorted(held))}"
                           for c, held in sorted(by_coord.items()))
        raise ValueError(
            f"mesh {dict(shape)} does not put each dcn coordinate on one "
            f"host ({layout}): declare dcn first with one coordinate a "
            f"host ({len(set(hosts))} hosts: {', '.join(sorted(set(hosts)))})"
            ", and launch the ranks node-major (torchrun's order)")

