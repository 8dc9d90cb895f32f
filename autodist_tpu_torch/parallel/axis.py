"""One mesh axis as a ``torch.distributed`` group: the collectives of
stage code.

The JAX package names a mesh axis inside ``shard_map`` and calls
``lax.axis_index``, ``axis_size``, ``ppermute``, ``psum``,
``psum_scatter``, ``all_gather``, ``all_to_all``, ``pmax`` and ``pmin``
on it.  The port builds
one :class:`Axis` per mesh axis (:meth:`autodist_tpu_torch.resource
.ResourceSpec.make_mesh`): the process group of the ranks that differ
only along that axis, its size, and this rank's index in it.  Ranks map
to mesh coordinates in the JAX package's order (row-major over the
declared axes, as ``np.array(devices).reshape(shape)`` lays them out),
so model shard ``i`` is the slice ``NamedSharding`` gives device ``i``
and a ring sends ``i -> i + 1``.

A group of one rank makes every collective the identity.  With a gloo
group and CUDA tensors, each transfer is staged through host memory:
the tensor is copied to the host, the gloo collective runs there, and
the result is copied back.  That is how several ranks share one card
(NCCL refuses two ranks on one device); it is chosen by the group's
backend, never by catching a failure.

Model code finds an axis by name, as JAX code names one inside
``shard_map``: a lowering opens :func:`axis_scope` around its forward
and backward, and :func:`bound_axis` (``global_positions``, ring
attention, the MoE layer) returns the axis bound to a name, or raises
outside a scope, as an unbound axis name does in JAX.
:func:`ring_shift` is the differentiable ``ppermute`` of one step
around an axis.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Axis:
    """A mesh axis: ``size`` ranks, this rank at ``index``, ``ranks``
    the global ranks in axis order, ``group`` their process group
    (``None`` for a one-rank axis)."""

    name: str
    size: int = 1
    index: int = 0
    ranks: tuple = (0,)
    group: Any = None

    # ---------------- transport ----------------------------------------- #
    @property
    def stages_through_host(self) -> bool:
        """Whether this axis's collectives on CUDA tensors go through
        host memory (a gloo group of more than one rank).  Such a step
        makes host round trips and cannot be captured in a CUDA
        graph."""
        return self.size > 1 and dist.get_backend(self.group) == "gloo"

    def _staged(self, x) -> bool:
        """Whether this transfer goes through host memory: a gloo group
        given CUDA tensors."""
        return x.is_cuda and self.stages_through_host

    def _on_wire(self, x, *, copy: bool = False):
        """``x`` where the collective reads it: a host copy when staged,
        else ``x`` itself (a fresh copy with ``copy=True``, for
        collectives that write their input)."""
        if self._staged(x):
            return x.to("cpu", memory_format=torch.contiguous_format)
        return x.clone(memory_format=torch.contiguous_format) if copy \
            else x.contiguous()

    # ---------------- collectives --------------------------------------- #
    def psum(self, x):
        """Sum over the axis (a new tensor)."""
        if self.size == 1:
            return x
        buf = self._on_wire(x, copy=True)
        dist.all_reduce(buf, group=self.group)
        return buf.to(x.device)

    def pmax(self, x):
        """Max over the axis.  bf16 and fp16 travel as fp32 (exact for
        a max)."""
        return self._extremum(x, dist.ReduceOp.MAX)

    def pmin(self, x):
        """Min over the axis (the argmax election's smallest winning
        id).  Integers travel as they are, bf16 and fp16 as fp32."""
        return self._extremum(x, dist.ReduceOp.MIN)

    def _extremum(self, x, op):
        if self.size == 1:
            return x
        wire = x if not x.is_floating_point() else x.float()
        buf = self._on_wire(wire, copy=True)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(device=x.device, dtype=x.dtype)

    def pmean(self, x):
        """Sum over the axis divided by its size."""
        return self.psum(x) / self.size if self.size > 1 else x

    def pmean_all(self, tensors: dict) -> dict:
        """Every tensor of ``{name: tensor}`` averaged over the axis in
        one flat fp32 all-reduce, each cast back to its dtype."""
        return self.psum_all(tensors, mean=True)

    def psum_all(self, tensors: dict, mean: bool = False) -> dict:
        """Every tensor of ``{name: tensor}`` summed (``mean``: averaged)
        over the axis in one flat fp32 all-reduce, each cast back to its
        dtype."""
        if self.size == 1 or not tensors:
            return tensors
        names = list(tensors)
        flat = torch.cat([tensors[n].reshape(-1).float() for n in names])
        flat = self.pmean(flat) if mean else self.psum(flat)
        out, offset = {}, 0
        for n in names:
            size = tensors[n].numel()
            out[n] = flat[offset:offset + size].view(tensors[n].shape).to(
                tensors[n].dtype)
            offset += size
        return out

    def all_gather(self, x, dim: int = 0):
        """The axis's ``x`` concatenated along ``dim`` in axis order
        (``lax.all_gather(..., tiled=True)``)."""
        if self.size == 1:
            return x
        src = self._on_wire(x)
        bufs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(bufs, src, group=self.group)
        return torch.cat(bufs, dim=dim).to(x.device)

    def psum_scatter(self, flat):
        """Reduce-scatter of a flat payload whose length divides the
        axis size: this rank's chunk of the sum
        (``lax.psum_scatter(..., tiled=True)``).  One
        ``reduce_scatter_tensor`` on NCCL; elsewhere taken from a full
        all-reduce, which every backend has (gloo has no
        reduce-scatter); the chunk's values are the same."""
        if self.size == 1:
            return flat
        chunk = flat.shape[0] // self.size
        if chunk * self.size != flat.shape[0]:
            raise ValueError(f"psum_scatter: length {flat.shape[0]} does not "
                             f"divide by the axis size {self.size}")
        if flat.is_cuda and dist.get_backend(self.group) == "nccl":
            out = flat.new_empty(chunk)
            dist.reduce_scatter_tensor(out, flat.contiguous(),
                                       group=self.group)
            return out
        summed = self.psum(flat)
        return summed[self.index * chunk:(self.index + 1) * chunk].clone()

    def ppermute(self, x, shift: int = 1):
        """Send ``x`` ``shift`` ranks along the ring (``i -> i + shift``)
        and return what rank ``i - shift`` sent."""
        if self.size == 1:
            return x
        src = self._on_wire(x)
        dst = torch.empty_like(src)
        nxt = self.ranks[(self.index + shift) % self.size]
        prv = self.ranks[(self.index - shift) % self.size]
        ops = [dist.P2POp(dist.isend, src, nxt, group=self.group),
               dist.P2POp(dist.irecv, dst, prv, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return dst.to(x.device)

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        """Tiled all-to-all (``lax.all_to_all(..., tiled=True)``): ``x``
        splits into ``size`` equal chunks along ``split_axis``, chunk
        ``j`` goes to rank ``j``, and the chunks that arrive concatenate
        along ``concat_axis`` in source order.  One
        ``all_to_all_single`` on the split-axis-major layout."""
        if self.size == 1:
            return x
        n = self.size
        if x.shape[split_axis] % n:
            raise ValueError(
                f"all_to_all split dim {x.shape[split_axis]} (axis "
                f"{split_axis}) must divide the {n}-way {self.name!r} axis")
        src = self._on_wire(x.movedim(split_axis, 0))
        dst = torch.empty_like(src)
        dist.all_to_all_single(dst, src, group=self.group)
        parts = dst.to(x.device).view((n, src.shape[0] // n) + src.shape[1:])
        return torch.cat([p.movedim(0, split_axis) for p in parts],
                         dim=concat_axis)


# --------------------------------------------------------------------------- #
# Named axes in model code
# --------------------------------------------------------------------------- #
# The axes bound by the innermost open axis_scope, by name.  A module
# global and not a context variable: the autograd engine runs a CUDA
# backward (and the recompute of a checkpointed layer) on its own
# thread, which must see the axes the step bound.
_bound: dict = {}


@contextlib.contextmanager
def axis_scope(axes: Mapping[str, Axis]):
    """Bind ``{name: Axis}`` for the model code that runs inside the
    ``with`` body, forward and backward (the lowering's counterpart of
    the mesh axis names ``shard_map`` binds).  Scopes nest; the inner
    one's names win, and leaving it restores the outer ones."""
    global _bound
    prev = _bound
    _bound = {**prev, **axes}
    try:
        yield
    finally:
        _bound = prev


def bound_axis(name: str) -> Axis:
    """The axis :func:`axis_scope` bound to ``name``; raises outside
    one, as an unbound axis name does in JAX."""
    axis = _bound.get(name)
    if axis is None:
        raise NameError(
            f"unbound axis name: {name!r}; model code that names a mesh "
            f"axis runs inside a lowering that binds it (AutoDist with a "
            f"strategy whose mesh has a {name!r} axis)")
    return axis


class _RingShift(torch.autograd.Function):
    """``ppermute(x, +1)`` forward; the transpose, ``ppermute(g, -1)``,
    backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.ppermute(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.ppermute(g.contiguous(), -1), None


def ring_shift(x, axis: Axis):
    """``x`` sent one rank along ``axis`` (``i -> i + 1``); the gradient
    travels back (``i -> i - 1``), JAX's transpose of ``ppermute``."""
    return _RingShift.apply(x, axis)
