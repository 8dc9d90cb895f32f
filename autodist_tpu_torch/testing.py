"""Multi-rank jobs on one machine: start the ranks, end them cleanly.

The port's multi-rank tests and ``chip_smoke.py`` run small
``torch.distributed`` jobs, one process per rank, joined by a file
store.  Each rank calls :func:`init_rank` first and :func:`end_rank`
last.  :func:`end_rank` holds every rank at a barrier until all of them
are done (their last collective and any result write), then destroys
the default group, which shuts down every group the mesh made, newest
first.  Without that barrier a rank that finished first tore down its
gloo group while a peer still worked, and under load one of the two
aborted in C++ (``terminate called without an active exception``,
SIGABRT).

:func:`launch` starts the ranks of a script as subprocesses, each
rank's output in a log file; its ``join`` waits for them all and raises
:class:`RankFailed` naming every rank that exited non-zero, with its
whole log, after stopping the others.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent


def init_rank(rank: int, world: int, store: str, backend: str = "gloo"):
    """Join the job: a process group of ``world`` ranks over the file
    store at the path ``store``."""
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)


def end_rank():
    """Leave the job cleanly: a barrier (every rank has finished its
    collectives and writes), then the default group and with it every
    other group.  Call it only on success: a rank that failed exits
    instead, and its peers are stopped by the launcher."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        import torch

        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()


class RankFailed(AssertionError):
    """A rank of a :func:`launch` job exited non-zero."""


def launch(script: str, world: int, args=(), *, tmp, timeout: float = 300):
    """Start ``world`` processes running ``python -c script rank world
    store *args`` from the repository root, with a file store and
    per-rank logs under ``tmp``.  Returns ``join()``, which waits for
    every rank and raises :class:`RankFailed` with each failed rank's
    whole log (stopping the others), or on ``timeout`` seconds."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / "store"
    env = dict(os.environ, PYTHONPATH=str(REPO), PYTHONFAULTHANDLER="1")
    logs, procs = [], []
    for rank in range(world):
        log = tmp / f"rank{rank}.log"
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(rank), str(world),
                 str(store), *map(str, args)], cwd=REPO, env=env,
                stdout=f, stderr=subprocess.STDOUT))
        logs.append(log)

    def join():
        deadline, late = time.monotonic() + timeout, False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    late = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        failed = [(r, p.returncode) for r, p in enumerate(procs)
                  if p.returncode != 0]
        if failed:
            why = f"not done after {timeout} s; " if late else ""
            raise RankFailed(why + "\n".join(
                f"rank {r} of {world} exited with {rc}"
                f"{' (stopped)' if rc == -9 else ''}; its log:\n"
                f"{logs[r].read_text()}" for r, rc in failed))

    return join
