"""Input pipeline: per-rank sharding and a prefetching device loader.

Counterpart of ``autodist_tpu/data.py``.  A background thread stays
ahead of the card by cutting and copying the next batches while the
current step runs, hiding the host-to-device transfer behind compute.

* :class:`DataLoader` wraps any iterable or ``step -> batch`` callable
  of host batches (dicts of numpy arrays or tensors) and hands the
  runner batches already cut for this rank and on its device, in the
  runner's placed form, so :meth:`~autodist_tpu_torch.runner
  .DistributedRunner.step` cuts nothing again.  With ``global_batches``
  the source yields the global batch (what ``runner.step`` takes) and
  each rank keeps its slice of every leaf the lowering splits
  (:meth:`~autodist_tpu_torch.kernel.lowering.Lowered.placement_of`) and
  the whole of the others; without it the source yields this rank's own
  data, placed as it is.  On the card each leaf is copied into a pinned
  host buffer and from there with ``non_blocking=True`` on a side
  stream; the consumer's stream waits on the copy's event, the tensor
  is ``record_stream``-ed on it, and a pinned buffer is reused only
  after its copy has finished.
* :func:`shard_batch`: this rank's contiguous slice of a global batch.
* :func:`synthetic`: marks a ``step -> batch`` function as a source.
* :class:`TokenFile` and :func:`lm_window_loader`: random windows of a
  flat binary token file, through the port's native reader
  (``runtime/native/dataio.cc``, built by the host compiler at first
  use) or a numpy memmap with the same semantics.

Usage::

    loader = DataLoader(source, runner.mesh, lowered=runner.lowered,
                        global_batches=True)
    for batch in loader:                  # cut and on the card
        runner.step(batch)
"""
from __future__ import annotations

import itertools
import queue
import threading
import weakref
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from autodist_tpu_torch.device import resolve_device
from autodist_tpu_torch.resource import _world
from autodist_tpu_torch.runner import _Placed, batch_size, cut_leaf


def shard_batch(batch, *, process_index: Optional[int] = None,
                process_count: Optional[int] = None):
    """This rank's contiguous slice of a global host batch (dim 0 of
    every leaf that has one; scalars whole).  A no-op in a one-rank
    job."""
    world, rank = _world()
    pc = world if process_count is None else process_count
    if pc == 1:
        return batch
    pi = rank if process_index is None else process_index

    def slc(x):
        x = np.asarray(x)
        if x.ndim == 0:
            return x
        if x.shape[0] % pc:
            raise ValueError(
                f"global batch dim {x.shape[0]} not divisible by "
                f"{pc} processes")
        k = x.shape[0] // pc
        return x[pi * k:(pi + 1) * k]

    return {key: slc(x) for key, x in batch.items()}


class _PinnedPool:
    """Pinned host buffers by (shape, dtype), each with the event of its
    last copy: a buffer is handed out again only after that copy has
    finished."""

    def __init__(self):
        self._free: dict = {}

    def take(self, t: torch.Tensor) -> torch.Tensor:
        key = (tuple(t.shape), t.dtype)
        for i, (buf, event) in enumerate(self._free.get(key, ())):
            if event is None or event.query():
                del self._free[key][i]
                return buf
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

    def give(self, buf: torch.Tensor, event) -> None:
        self._free.setdefault((tuple(buf.shape), buf.dtype), []).append(
            (buf, event))


class DataLoader:
    """Prefetching loader over an iterable (or ``step -> batch``
    callable) of host batches; see the module docstring.

    ``lowered`` (the runner's) says how each leaf is cut under
    ``global_batches`` (a pipe-, seq- or expert-axis mesh cuts other
    than dim 0 over data) and where batches go (``lowered.device``);
    without it leaves cut dim 0 over the mesh's replica group (``dcn x
    data`` on a multi-slice mesh, JAX ``replica_axes``) and go to
    ``device`` (``None``: the card).  ``buffer_size`` batches are kept
    in flight."""

    def __init__(self, source: Iterable | Callable[[int], Any], mesh,
                 *, buffer_size: int = 2, global_batches: bool = False,
                 num_batches: Optional[int] = None, lowered=None,
                 device=None):
        if buffer_size < 1:
            raise ValueError("buffer_size must be >= 1")
        self.mesh = mesh
        self.buffer_size = buffer_size
        self.global_batches = global_batches
        self.num_batches = num_batches
        self.lowered = lowered
        self.device = (lowered.device if lowered is not None
                       else resolve_device(device))
        self._source = source

    def _batches(self) -> Iterator[Any]:
        if callable(self._source):
            for i in itertools.count():
                if self.num_batches is not None and i >= self.num_batches:
                    return
                yield self._source(i)
        else:
            src = self._source if self.num_batches is None \
                else itertools.islice(self._source, self.num_batches)
            yield from src

    def _cut(self, batch) -> dict:
        """This rank's host tensors of one batch (views where possible)."""
        if not self.global_batches:
            return {key: torch.as_tensor(x) for key, x in batch.items()}
        if self.lowered is not None:
            cuts = self.lowered.placement_of(batch)
        else:
            # The whole replica group: dcn x data on a multi-slice mesh.
            repl = self.mesh.replica_axis()
            cuts = {key: ((0, repl),) for key in batch}
        return {key: cut_leaf(key, x, cuts[key])
                for key, x in batch.items()}

    def _place_cuda(self, host: dict, stream, pool: _PinnedPool):
        """The batch on the card, copied from pinned buffers on
        ``stream``; returns it and the copies' event."""
        out, pinned = {}, []
        for key, t in host.items():
            buf = pool.take(t)
            buf.copy_(t)
            pinned.append(buf)
            with torch.cuda.stream(stream):
                out[key] = torch.empty(t.shape, dtype=t.dtype,
                                       device=self.device)
                out[key].copy_(buf, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        for buf in pinned:
            pool.give(buf, event)
        return _Placed(out), event

    def __iter__(self) -> Iterator[Any]:
        q: "queue.Queue" = queue.Queue(maxsize=self.buffer_size)
        done = object()
        err: list = []
        stop = threading.Event()
        cuda = self.device.type == "cuda"
        device = self.device
        if cuda and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device) if cuda else None

        def worker():
            pool = _PinnedPool()
            try:
                if cuda:
                    torch.cuda.set_device(device)
                for b in self._batches():
                    host = self._cut(b)
                    item = (self._place_cuda(host, stream, pool) if cuda
                            else (_Placed(host), None))
                    # fit's throughput counts the batch's examples
                    item[0].examples = batch_size(b)
                    if not put(item):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                put(done)

        def put(item) -> bool:
            """Queue ``item`` unless the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        t = threading.Thread(target=worker, daemon=True,
                             name="autodist-torch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    if err:
                        raise err[0]
                    return
                placed, event = item
                if event is not None:
                    current = torch.cuda.current_stream(device)
                    current.wait_event(event)
                    for x in placed.values():
                        x.record_stream(current)
                yield placed
        finally:
            stop.set()
            t.join()


def synthetic(make_batch: Callable[[int], Any]) -> Callable[[int], Any]:
    """Adapter marking a ``step -> batch`` function as a loader source."""
    return make_batch


# --------------------------------------------------------------------------- #
# Token-file IO (native mmap reader)
# --------------------------------------------------------------------------- #
_dio_lib = None
_dio_lock = threading.Lock()


def _load_dio():
    """The native data-IO library, built at first use, with its C
    signatures declared once."""
    global _dio_lib
    with _dio_lock:
        if _dio_lib is not None:
            return _dio_lib
        import ctypes

        from autodist_tpu_torch.runtime import native

        lib = native.load("dataio")
        lib.dio_open.restype = ctypes.c_void_p
        lib.dio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dio_num_items.restype = ctypes.c_longlong
        lib.dio_num_items.argtypes = [ctypes.c_void_p]
        lib.dio_gather.restype = ctypes.c_int
        lib.dio_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_void_p]
        lib.dio_prefetch.restype = ctypes.c_int
        lib.dio_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int, ctypes.c_longlong]
        lib.dio_close.argtypes = [ctypes.c_void_p]
        _dio_lib = lib
        return lib


class TokenFile:
    """Random-window reader over a flat binary token array on disk.

    Native route (``runtime/native/dataio.cc``): windows are memcpy'd
    out of an mmap and upcoming windows are warmed with
    ``madvise(WILLNEED)``.  ``native=None`` takes a numpy memmap with
    the same semantics where the library cannot be built or opened;
    ``native=True`` requires the native route and raises otherwise.
    """

    def __init__(self, path: str, dtype=np.int32, *,
                 native: Optional[bool] = None):
        self.path = path
        self.dtype = np.dtype(dtype)
        self._lib = None
        self._h = None
        self._mm = None
        if native is None or native:
            try:
                import ctypes

                lib = _load_dio()
                h = lib.dio_open(path.encode(), self.dtype.itemsize)
                if not h:
                    raise OSError(f"dio_open failed for {path!r} "
                                  "(missing/empty, or size not a multiple "
                                  f"of itemsize {self.dtype.itemsize})")
                self._lib, self._h = lib, ctypes.c_void_p(h)
                weakref.finalize(self, lib.dio_close, self._h)
            except Exception:
                if native:  # explicitly requested: do not mask
                    raise
        if self._h is None:
            self._mm = np.memmap(path, dtype=self.dtype, mode="r")

    def __len__(self) -> int:
        if self._h is not None:
            return int(self._lib.dio_num_items(self._h))
        return len(self._mm)

    def gather(self, offsets, window: int) -> np.ndarray:
        """``[n, window]`` array of the windows starting at ``offsets``."""
        offsets = np.ascontiguousarray(offsets, np.int64)
        out = np.empty((len(offsets), window), self.dtype)
        if self._h is not None:
            import ctypes

            rc = self._lib.dio_gather(
                self._h, offsets.ctypes.data_as(ctypes.c_void_p),
                len(offsets), window,
                out.ctypes.data_as(ctypes.c_void_p))
            if rc != 0:
                raise IndexError(
                    f"window out of bounds (file has {len(self)} items)")
            return out
        n = len(self._mm)
        for i, off in enumerate(offsets):
            # off > n - window, not off + window > n: the sum can wrap
            # int64 for adversarial offsets.
            if off < 0 or window > n or off > n - window:
                raise IndexError(
                    f"window out of bounds (file has {n} items)")
            out[i] = self._mm[off:off + window]
        return out

    def prefetch(self, offsets, window: int) -> None:
        """Warm the page cache for upcoming windows (a no-op on the
        memmap route, which has only the OS readahead)."""
        if self._h is not None:
            import ctypes

            offsets = np.ascontiguousarray(offsets, np.int64)
            self._lib.dio_prefetch(
                self._h, offsets.ctypes.data_as(ctypes.c_void_p),
                len(offsets), window)


def lm_window_loader(path: str, *, batch_size: int, seq_len: int,
                     dtype=np.int32, seed: int = 0,
                     native: Optional[bool] = None
                     ) -> Callable[[int], Any]:
    """``step -> {"x", "y"}`` source over random windows of a token file
    (``y`` is ``x`` shifted one token).  Batch ``t + 1``'s pages are
    prefetched while batch ``t`` is consumed; feed it through
    :class:`DataLoader` for the device half of the pipeline."""
    tokens = TokenFile(path, dtype, native=native)
    n = len(tokens)
    if n < seq_len + 1:
        raise ValueError(f"{path!r} has {n} tokens < seq_len+1")

    def offsets_for(step: int) -> np.ndarray:
        # Deterministic in (seed, step), not a stateful stream: a resumed
        # job (fit shifts the source by the restored step) continues the
        # data order instead of replaying windows from the seed.
        rng = np.random.RandomState(np.array([seed, step], np.uint32))
        return rng.randint(0, n - seq_len, size=batch_size).astype(np.int64)

    def source(step: int):
        offs = offsets_for(step)
        tokens.prefetch(offsets_for(step + 1), seq_len + 1)
        w = tokens.gather(offs, seq_len + 1)
        return {"x": np.ascontiguousarray(w[:, :-1]),
                "y": np.ascontiguousarray(w[:, 1:])}

    return source
