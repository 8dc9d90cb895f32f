"""The fault vocabulary the checkpoint layer records into.

The port's counterpart of the two pieces of
``autodist_tpu/runtime/faults.py`` the :class:`~autodist_tpu_torch
.checkpoint.saver.Saver` needs: :func:`fault_target` names this process
in ``kind="fault"`` telemetry records, and :func:`install_ckpt_write_fail`
injects checkpoint-write failures, the way the retry, degrade and typed
error paths are proven.  Fault plans, the injector and the chaos matrix
belong to ROADMAP item 9 (runtime and multi-host).
"""
from __future__ import annotations

import os

WORKER_ENV = "AUTODIST_TPU_WORKER"


def fault_target() -> str:
    """This process's name in fault records: a worker's host marker
    (``$AUTODIST_TPU_WORKER``), else ``"chief"``."""
    return os.environ.get(WORKER_ENV) or "chief"


def install_ckpt_write_fail(saver, times: int = 1,
                            where: str = "save") -> dict:
    """Arm a ``Saver`` so its next ``times`` checkpoint operations raise
    an injected ``OSError``: ``where="save"`` fails the write itself
    (the path the retry policy wraps), ``where="commit"`` fails the join
    of an async write (the path that must surface with the failed step).
    Returns the countdown (``{"left": n}``)."""
    store = saver._store
    countdown = {"left": int(times)}
    if where not in ("save", "commit"):
        raise ValueError(f"where={where!r}; expected 'save' or 'commit'")
    name = "write" if where == "save" else "join"
    orig = getattr(store, name)

    def failing(*args, **kwargs):
        if countdown["left"] > 0:
            countdown["left"] -= 1
            raise OSError(f"injected ckpt_write_fail ({where}, "
                          f"{countdown['left']} more to come)")
        return orig(*args, **kwargs)

    setattr(store, name, failing)
    return countdown
