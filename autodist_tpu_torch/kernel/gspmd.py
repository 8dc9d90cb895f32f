"""The ``gspmd`` lowering on DTensor: variables sharded over the mesh by
rules, the communication derived from the placements.

Counterpart of ``autodist_tpu/kernel/gspmd.py``.  Where the JAX package
jits the step with ``NamedSharding``s and lets XLA insert the
collectives, the port lifts the step onto DTensor, PyTorch's
counterpart:

* a ``DeviceMesh`` over the job's ranks with the mesh's axes, in the
  row-major order of :mod:`autodist_tpu_torch.parallel.axis` (model
  shard ``i`` is what ``NamedSharding`` gives device ``i``);
* each variable's placements from its node config (:func:`node_spec`);
  a dim that does not divide its mesh axes is replicated with a warning
  (JAX ``param_spec``);
* the runner's state holds plain local shards, as under the other
  lowerings (``Saver``, fetches, ``get_params``, ``export_model`` and
  the CUDA-graph runner see plain tensors); the step lifts them with
  ``DTensor.from_local`` and the batch as ``Shard(0)`` over the data
  axis (a 0-d leaf replicated), runs the trainable's loss on the
  DTensors, and differentiates the local leaves: ``from_local``'s
  backward hands each leaf its gradient reduced to the variable's
  placements (JAX ``constrain(grads, p_specs)``);
* the optimizer runs on local shards in each variable's update space:
  its placements, or under a PS synchronizer the ZeRO-1 state
  placements (JAX ``opt_spec_for``: dim 0 extended over the data axis,
  else the first free divisible dim), the updated piece then
  all-gathered over the data axis back to the variable's shard;
* ``accum_steps`` slices the batch
  (:func:`~autodist_tpu_torch.kernel.common.accumulate_microbatches`);
  compressors and ``zero_stage > 1`` warn, as in JAX, and train the
  plain program; ``PS(sync=False)`` raises (it is the
  :class:`~autodist_tpu_torch.runner.AsyncPSRunner`'s), and a stale PS
  trains the synchronous program, its bound stamped by ``AutoDist`` for
  the runner's SSP gate.

Kernels that take raw pointers never see a DTensor: the flash-attention
adapter runs its kernel under ``local_map`` on each rank's heads
(:func:`~autodist_tpu_torch.ops.flash_attention.make_attention_fn`).
The metrics are replicated scalars of the global batch, as JAX's.

Three computations DTensor (torch 2.11) does not do as GSPMD would are
rewritten at this boundary, for the loss's duration only
(:class:`_DTensorGaps`), so that model code sees no DTensor: a
``tensordot`` whose kernel is split on an output dim past the first
(qkv's heads) has that dim moved to the front for the product, as the
product's flatten of the output dims keeps a split only on the
outermost; an embedding lookup in a vocab-split table is summed at once
(its masked partial sum, left pending, conflicts with the next operand
DTensor partitions to match it); and a ``gather``, ``logsumexp`` or
``argmax`` along a split dim (the vocabulary of an LM head's logits)
has that dim made whole first, a ``gather`` then running on each
rank's pieces: DTensor's own gather masks a split dim's partial values
as an embedding lookup's.

Its state manifest is the JAX package's ``simple`` family's: every leaf
stored at its logical shape (identity recipes), each leaf's ``split``
read from its placements (and a PS variable's state from its extra
split over the data axis).

The job's default process group must hold the mesh's ranks; a process
with none gets a one-rank group (gloo on the CPU, NCCL on the card),
which the runners built on it share and the last one's ``close()``
destroys.  On the card a gloo group of several ranks carries DTensor's
reductions but not its all-gathers (torch 2.11 crashes in them), so
several ranks share no card here: one rank a card over NCCL.
"""
from __future__ import annotations

import logging
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from autodist_tpu_torch import const, optim
from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.kernel import common
from autodist_tpu_torch.kernel.lowering import Lowered, leaf_record
from autodist_tpu_torch.strategy.ir import PSSynchronizer

_log = logging.getLogger(__name__)


def node_spec(node, ndim: int) -> list:
    """A variable's per-dim spec from its node config: each entry
    ``None``, a mesh axis name or a tuple of names."""
    part = node.partitioner if node else None
    spec = [None] * ndim
    if part is None:
        return spec
    if part.spec is not None:
        if len(part.spec) != ndim:
            raise ValueError(
                f"{node.var_name}: sharding spec {part.spec} has "
                f"{len(part.spec)} entries for a rank-{ndim} tensor")
        return [tuple(a) if isinstance(a, list) else a for a in part.spec]
    if part.num_shards > 1 and ndim > 0:
        spec[max(part.split_axis, 0)] = part.mesh_axis
    return spec


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


# The lowerings holding the one-rank default group a lowering made for
# a process that had none.
_one_rank_users = 0


def _hold_group(dev):
    """The job's default group, or where the process has none a one-rank
    group shared by the lowerings that hold it.  Returns the release
    (``None`` for the job's own group): the last release destroys the
    group."""
    global _one_rank_users
    if dist.is_initialized() and not _one_rank_users:
        return None
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    _one_rank_users += 1
    released = []

    def release():
        global _one_rank_users
        if released:
            return
        released.append(True)
        _one_rank_users -= 1
        if not _one_rank_users and dist.is_initialized():
            dist.destroy_process_group()

    return release


class GspmdLayout:
    """The mesh, its ``DeviceMesh`` and this rank's coordinates; specs
    to DTensor placements and local shards."""

    def __init__(self, mesh, dev):
        from torch.distributed.device_mesh import DeviceMesh

        self.names = list(mesh.shape)
        self.sizes = [int(mesh.shape[a]) for a in self.names]
        world = math.prod(self.sizes)
        self.release = _hold_group(dev)
        if dist.get_world_size() != world:
            if self.release:
                self.release()
            raise ValueError(
                f"the mesh {dict(mesh.shape)} has {world} ranks; the "
                f"process group has {dist.get_world_size()}")
        self.coords = [int(c) for c in np.unravel_index(
            dist.get_rank(), self.sizes)]
        self.dmesh = DeviceMesh(dev.type, torch.arange(world).view(
            *self.sizes), mesh_dim_names=tuple(self.names))

    def size_of(self, entry) -> int:
        return math.prod(self.sizes[self.names.index(a)]
                         for a in axes_of(entry))

    def placements(self, spec) -> tuple:
        """One placement a mesh dim: ``Shard(d)`` where dim ``d`` of the
        spec names that axis, else ``Replicate()``.  A dim over several
        axes splits in mesh order (the first axis outermost)."""
        from torch.distributed.tensor import Replicate, Shard

        out = [Replicate()] * len(self.names)
        for d, entry in enumerate(spec):
            for a in axes_of(entry):
                if a not in self.names:
                    raise ValueError(f"spec {spec} names mesh axis {a!r}; "
                                     f"the mesh has {self.names}")
                out[self.names.index(a)] = Shard(d)
        return tuple(out)

    def local(self, t, placements):
        """This rank's shard of a full tensor (DTensor's even split)."""
        for i, p in enumerate(placements):
            if p.is_shard():
                t = t.chunk(self.sizes[i], dim=p.dim)[self.coords[i]]
        return t

    def lift(self, t, placements, shape):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.dmesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))


class _DTensorGaps(torch.overrides.TorchFunctionMode):
    """The loss's products on DTensors rewritten where DTensor does not
    compute them as GSPMD would (the module docstring): a ``tensordot``
    whose kernel is split on an output dim past the first, an embedding
    lookup in a split table, and a ``gather``, ``logsumexp`` or
    ``argmax`` along a split dim.  A tensor made whole is kept for the
    mode's life, so that the three reading one LM head's logits share
    one all-gather."""

    def __init__(self):
        super().__init__()
        self._whole = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if func is torch.tensordot and isinstance(args[1], DTensor):
            return _tensordot(*args, **kwargs)
        if func is F.embedding and isinstance(args[1], DTensor):
            return _reduced(func(*args, **kwargs))
        dim = _reduced_dim(func, args, kwargs)
        if dim is not None and isinstance(args[0], DTensor):
            args = (self.whole(args[0], dim), *args[1:])
            if func in _GATHERS and len(args) == 3 and not kwargs \
                    and isinstance(args[2], DTensor):
                return _local_gather(*args)
        return func(*args, **kwargs)

    def whole(self, x, dim: int):
        """``x`` with dim ``dim`` replicated (the rest as it was)."""
        from torch.distributed.tensor import Replicate

        dim %= x.dim()
        if not any(p.is_shard(dim) for p in x.placements):
            return x
        key = (id(x), dim)
        if key not in self._whole:
            self._whole[key] = (x, x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard(dim) else p
                for p in x.placements]))
        return self._whole[key][1]


def _reduced(x):
    """``x`` with its partial placements summed (replicated)."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


_GATHERS = (torch.gather, torch.Tensor.gather)


def _local_gather(x, dim: int, index):
    """``torch.gather(x, dim, index)`` on each rank's pieces: ``x`` and
    ``index`` split alike along the dims where they match in size (the
    batch), every other mesh dim replicated.  DTensor's own strategy
    may split a whole ``x`` along ``dim`` into a masked partial sum,
    whose mask buffer conflicts with the next such gather's (torch
    2.11)."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    dim %= x.dim()
    pl = tuple(q if q.is_shard() and q.dim != dim and p == q
               and x.shape[q.dim] == index.shape[q.dim] else Replicate()
               for p, q in zip(x.placements, index.placements))
    mesh = x.device_mesh
    x, index = x.redistribute(mesh, pl), index.redistribute(mesh, pl)
    fn = local_map(lambda t, i: torch.gather(t, dim, i),
                   out_placements=list(pl), in_placements=(pl, pl),
                   device_mesh=mesh)
    return fn(x, index)


def _reduced_dim(func, args, kwargs):
    """The one dim a ``gather``, ``logsumexp`` or ``argmax`` call
    indexes or reduces (``None``: another function, or another form)."""
    if func in (*_GATHERS, torch.logsumexp, torch.Tensor.logsumexp,
                torch.argmax, torch.Tensor.argmax):
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        if isinstance(dim, (list, tuple)) and len(dim) == 1:
            dim = dim[0]
        return dim if isinstance(dim, int) else None
    return None


def _tensordot(a, b, dims=2, out=None):
    """``torch.tensordot(a, b, dims)`` with ``b``'s split output dim
    past the first (if any) moved to the front of its outputs for the
    product and back after."""
    if out is not None or not isinstance(dims, int):
        return torch.tensordot(a, b, dims=dims, out=out)
    lead = next((p.dim for p in b.placements
                 if p.is_shard() and p.dim > dims), None)
    if lead is None:
        return torch.tensordot(a, b, dims=dims)
    y = torch.tensordot(a, b.movedim(lead, dims), dims=dims)
    first = y.dim() - (b.dim() - dims)
    return y.movedim(first, first + lead - dims)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def lower_gspmd(trainable, strategy, mesh, device=None) -> Lowered:
    """The train step of a ``gspmd`` strategy on ``device`` (``None``:
    the card)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    dev, opt = resolve_device(device), trainable.optimizer
    nodes = {nc.var_name: nc for nc in strategy.node_configs}
    for nc in strategy.node_configs:
        if isinstance(nc.synchronizer, PSSynchronizer) \
                and not nc.synchronizer.sync:
            raise NotImplementedError(
                f"PS(sync=False) on {nc.var_name}: asynchronous "
                "training does not lower to one SPMD program; build "
                "through AutoDist (AsyncPSRunner) or use sync=True")
    ps_vars = {nc.var_name for nc in strategy.node_configs
               if isinstance(nc.synchronizer, PSSynchronizer)}
    ignored = sorted(nc.var_name for nc in strategy.node_configs
                     if getattr(nc.synchronizer, "compressor", "none")
                     not in ("", "none"))
    if ignored:
        _log.warning(
            "gspmd lowering ignores compressor config on %d variable(s), "
            "e.g. %s — use the collective lowering for compressed "
            "gradients", len(ignored), ignored[0])
    staged = sorted(nc.var_name for nc in strategy.node_configs
                    if isinstance(nc.synchronizer, PSSynchronizer)
                    and int(nc.synchronizer.zero_stage or 1) > 1)
    if staged:
        _log.warning(
            "gspmd lowering realizes PS as ZeRO-1 state sharding only; "
            "zero_stage>1 on %d variable(s), e.g. %s, lowers with "
            "stage-1 semantics (params/grads stay unsharded) — use "
            "FSDPSharded for the GSPMD sharded-parameter layout or the "
            "pipeline lowering's zero_stage", len(staged), staged[0])
    if const.DATA_AXIS not in mesh.shape:
        raise ValueError(
            f"mesh {dict(mesh.shape)} has no '{const.DATA_AXIS}' axis")
    layout = GspmdLayout(mesh, dev)
    n_repl = mesh.shape[const.DATA_AXIS]
    data_axis = mesh.axis(const.DATA_AXIS)
    shapes = {info.name: tuple(info.shape)
              for info in trainable.var_infos()}

    def param_spec(name):
        shape = shapes[name]
        spec = node_spec(nodes.get(name), len(shape))
        for d, entry in enumerate(spec):
            n = layout.size_of(entry)
            if entry is not None and shape[d] % n:
                _log.warning(
                    "%s: dim %d (size %d) not divisible by mesh axis %r "
                    "(size %d); replicating that dim", name, d, shape[d],
                    entry, n)
                spec[d] = None
        return spec

    def update_spec(name, spec):
        """JAX ``opt_spec_for``: a PS variable's state also shards over
        the data axis, extending dim 0 (beside a model axis already
        there when divisible), else the first free divisible dim."""
        shape = shapes[name]
        if name not in ps_vars or not shape:
            return spec
        axes0 = axes_of(spec[0])
        if const.DATA_AXIS in axes0:
            return spec
        if shape[0] % (layout.size_of(spec[0]) * n_repl) == 0:
            return [(*axes0, const.DATA_AXIS) if axes0
                    else const.DATA_AXIS] + spec[1:]
        for d in range(1, len(shape)):
            if spec[d] is None and shape[d] % n_repl == 0:
                return spec[:d] + [const.DATA_AXIS] + spec[d + 1:]
        _log.warning(
            "%s: PS (ZeRO-1) requested but no dim of %s (spec %s) can "
            "shard over the %d-way data axes; state stays %s", name,
            shape, spec, n_repl, spec)
        return spec

    p_specs = {nm: param_spec(nm) for nm in shapes}
    u_specs = {nm: update_spec(nm, spec) for nm, spec in p_specs.items()}
    p_pl = {nm: layout.placements(s) for nm, s in p_specs.items()}
    u_pl = {nm: layout.placements(s) for nm, s in u_specs.items()}
    d_dim = layout.names.index(const.DATA_AXIS)
    batch_pl = tuple(Shard(0) if i == d_dim else Replicate()
                     for i in range(len(layout.names)))
    replicated = (Replicate(),) * len(layout.names)
    accum = max(int(strategy.graph_config.accum_steps), 1)

    def init_fn(params, extra):
        flat = dict(common.flatten_with_names(params))
        stored = {nm: layout.local(flat[nm].detach().to(dev),
                                   p_pl[nm]).clone()
                  for nm in shapes}
        u_params = {nm: to_update(nm, p) for nm, p in stored.items()}
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "params": stored, "opt_state": opt.init(u_params),
                "extra": extra, "sync_state": {}}

    def lift_batch(batch):
        out = {}
        for name, x in batch.items():
            if x.dim() == 0:
                out[name] = layout.lift(x, replicated, x.shape)
            else:
                shape = (x.shape[0] * n_repl,) + tuple(x.shape[1:])
                out[name] = layout.lift(x, batch_pl, shape)
        return out

    def plain(metrics):
        """The loss's metrics as replicated local tensors."""
        out = {}
        for k, v in metrics.items():
            if isinstance(v, DTensor):
                v = v.full_tensor()
            out[k] = torch.as_tensor(v).detach()
        return out

    def run_loss(params, batch, rng, extra, train):
        """The loss on the lifted params and batch; a plain tensor the
        model makes (a causal mask) counts as replicated."""
        leaves = {nm: p.detach().requires_grad_(train)
                  for nm, p in params.items()}
        lifted = {nm: layout.lift(leaf, p_pl[nm], shapes[nm])
                  for nm, leaf in leaves.items()}
        fn = trainable.loss if train else trainable.eval_loss
        with _DTensorGaps():
            loss, new_extra, metrics = fn(common.unflatten(lifted), extra,
                                          lift_batch(batch), rng)
        if isinstance(loss, DTensor):
            loss = loss.redistribute(layout.dmesh, replicated)
        return leaves, loss, new_extra, metrics

    def micro(params):
        def fn(mb, rng, extra):
            with torch.enable_grad(), implicit_replication():
                leaves, loss, new_extra, metrics = run_loss(
                    params, mb, rng, extra, True)
                grads = torch.autograd.grad(loss, list(leaves.values()),
                                            allow_unused=True)
            grads = {nm: torch.zeros_like(params[nm]) if g is None else g
                     for nm, g in zip(leaves, grads)}
            return grads, new_extra, plain(metrics)
        return fn

    def state_dim(nm):
        """The dim a PS variable's update space splits over the data
        axis beyond its placements (``None``: the same space)."""
        p, u = p_pl[nm][d_dim], u_pl[nm][d_dim]
        return u.dim if u.is_shard() and not p.is_shard() else None

    def to_update(nm, t):
        """A local shard in a variable's placements to its update space:
        its data coordinate's piece along :func:`state_dim` (inside the
        model split, as JAX's ``(model, data)`` entry orders them)."""
        dim = state_dim(nm)
        if dim is None:
            return t
        return t.chunk(n_repl, dim=dim)[layout.coords[d_dim]]

    def to_store(nm, t):
        """The updated piece back to the variable's local shard: an
        all-gather over the data axis along :func:`state_dim`."""
        dim = state_dim(nm)
        return t if dim is None else data_axis.all_gather(t, dim=dim)

    def step_fn(state, batch, rng):
        params = state["params"]
        if accum == 1:
            grads, new_extra, metrics = micro(params)(batch, rng,
                                                      state["extra"])
        else:
            grads, new_extra, metrics = common.accumulate_microbatches(
                micro(params), batch, rng, state["extra"], accum)
        u_grads = {nm: to_update(nm, g) for nm, g in grads.items()}
        u_params = {nm: to_update(nm, p) for nm, p in params.items()}
        updates, opt_state = opt.update(u_grads, state["opt_state"],
                                        u_params)
        u_new = optim.apply_updates(u_params, updates)
        new_state = {"step": state["step"] + 1,
                     "params": {nm: to_store(nm, u)
                                for nm, u in u_new.items()},
                     "opt_state": opt_state,
                     "extra": new_extra, "sync_state": {}}
        return new_state, metrics

    def eval_fn(state, batch, rng):
        with torch.no_grad(), implicit_replication():
            _, _, _, metrics = run_loss(state["params"], batch, rng,
                                        state["extra"], False)
        return plain(metrics)

    def full_params(stored):
        return {nm: layout.lift(t.contiguous(), p_pl[nm], shapes[nm])
                .full_tensor() for nm, t in stored.items()}

    def splits(nm, update: bool):
        """A variable's ``split`` records, outermost first: its
        placements in mesh order (``GspmdLayout.local``), then, for its
        optimizer state, the data split of :func:`state_dim`."""
        out = [{"axis": layout.names[i], "dim": p.dim,
                "ranks": layout.sizes[i]}
               for i, p in enumerate(p_pl[nm])
               if p.is_shard() and layout.sizes[i] > 1]
        if update and state_dim(nm) is not None and n_repl > 1:
            out.append({"axis": const.DATA_AXIS, "dim": state_dim(nm),
                        "ranks": n_repl})
        return out[0] if len(out) == 1 else (out or None)

    def local_shape(nm, update: bool) -> tuple:
        shape = list(shapes[nm])
        for i, p in enumerate(p_pl[nm]):
            if p.is_shard():
                shape[p.dim] //= layout.sizes[i]
        if update and state_dim(nm) is not None:
            shape[state_dim(nm)] //= n_repl
        return tuple(shape)

    def state_manifest(state):
        leaves = {}
        for name, leaf in common.state_leaves(state):
            shape, split = tuple(leaf.shape), None
            if name.startswith("params/") and name[7:] in shapes:
                shape, split = shapes[name[7:]], splits(name[7:], False)
            elif name.startswith("opt_state/"):
                local = shape
                var = common.match_var_by_suffix(
                    name, shapes,
                    shape_ok=lambda v: local == local_shape(v, True))
                if var is not None:
                    shape, split = shapes[var], splits(var, True)
            leaves[name] = leaf_record(shape, leaf.dtype, (), split)
        return {"family": "simple", "leaves": leaves, "sync": {}}

    lowered = Lowered(plan=None, mesh=mesh, device=dev, init_fn=init_fn,
                      step_fn=step_fn, full_params_fn=full_params,
                      eval_fn=eval_fn, release=layout.release,
                      state_manifest_fn=state_manifest)
    lowered.layout = layout
    lowered.param_specs, lowered.update_specs = p_specs, u_specs
    return lowered
