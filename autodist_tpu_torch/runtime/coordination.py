"""Host coordination service: the Python binding over ``native/coord.cc``.

The port's copy of ``autodist_tpu/runtime/coordination.py``.  The
reference built its between-graph control plane out of TensorFlow C++
runtime primitives: size-1 FIFO token queues as sync barriers,
depth-``staleness`` queues for stale-synchronous parallel (SSP) training
(``ps_synchronizer.py:335-458``), and SFTP file drops for the
chief-to-worker strategy handoff (``coordinator.py:66-90``).  Here those
are a standalone C++ TCP service (``native/coord.cc``, the JAX package's
wire protocol, so either package's client talks to the other's server):
the chief process runs a :class:`CoordServer`; every process connects a
:class:`CoordClient` for

* **KV with blocking get**: strategy handoff, config distribution, the
  asynchronous PS's published parameters;
* **named barriers**: job-level sync points outside the step;
* **FIFO byte queues**: the token-queue pattern, and the asynchronous
  PS's gradient queue;
* **SSP progress tracking**: :class:`SSPController` below.

The library is built by the host compiler at first use
(:mod:`autodist_tpu_torch.runtime.native`).
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading
import time
import weakref
from typing import Callable, Optional

from autodist_tpu_torch import const, telemetry
from autodist_tpu_torch.runtime.retry import RetryError, RetryPolicy

_log = logging.getLogger(__name__)
_lib = None

OK, TIMEOUT, ERROR = 0, 1, 2


class CoordUnavailableError(OSError):
    """The coordination service stayed unreachable through the client's
    whole reconnect-and-retry budget.  Typed, so that callers can tell
    "the control plane is gone" from "this one request failed"."""


# Reconnect budget for a CoordClient call that hits a dropped or stale
# socket (a chief restart, a bounced server, a TCP reset): a few quick
# attempts spanning ~10 s.  The happy path never touches it.
DEFAULT_COORD_RETRY = RetryPolicy(max_attempts=4, base_delay_s=0.25,
                                  cap_delay_s=2.0, deadline_s=30.0)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from autodist_tpu_torch.runtime import native

    lib = native.load("coord")
    vp, cp, i64, u32 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
                        ctypes.c_uint32)
    out = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(u32)]
    sigs = {
        "coord_server_start": (vp, [cp, ctypes.c_int, cp]),
        "coord_server_adopt": (vp, [ctypes.c_int, cp]),
        "coord_server_port": (ctypes.c_int, [vp]),
        "coord_server_stop": (None, [vp]),
        "coord_client_connect": (vp, [cp, ctypes.c_int, ctypes.c_int, cp]),
        "coord_client_close": (None, [vp]),
        "coord_client_shutdown": (None, [vp]),
        "coord_put": (ctypes.c_int, [vp, cp, cp, u32]),
        "coord_get": (ctypes.c_int, [vp, cp, i64, *out]),
        "coord_barrier": (ctypes.c_int, [vp, cp, i64, i64]),
        "coord_counter_add": (ctypes.c_int,
                              [vp, cp, i64, ctypes.POINTER(i64)]),
        "coord_queue_put": (ctypes.c_int, [vp, cp, cp, u32]),
        "coord_queue_get": (ctypes.c_int, [vp, cp, i64, *out]),
        "coord_ssp_register": (ctypes.c_int, [vp, cp]),
        "coord_ssp_report": (ctypes.c_int, [vp, cp, i64]),
        "coord_ssp_wait": (ctypes.c_int, [vp, i64, i64]),
        "coord_free": (None, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    return lib


def reserve_coord_port(bind_host: Optional[str] = None):
    """Reserve an ephemeral coordination port by holding it: bind a
    listening socket on port 0 and return it still bound.  The kernel's
    ephemeral allocator never hands a bound port to anyone else, so two
    concurrent spawns never elect the same port; hand the held socket to
    ``CoordServer(listen_sock=...)``, which adopts the fd (the port is
    never released between election and serve).

    ``SO_REUSEADDR`` does not share the port (it never permits a second
    live listener); accepted connections inherit it, so that after a
    chief bounce the server-side sockets lingering in FIN-WAIT-2 do not
    stop the same port from being bound again."""
    import socket

    if bind_host is None:
        bind_host = const.ENV.AUTODIST_TPU_COORD_BIND.val
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((bind_host or "0.0.0.0", 0))
        sock.listen(128)
    except OSError:
        sock.close()
        raise
    return sock


class CoordServer:
    """In-process native coordination server (run by the chief).

    Every connection authenticates with a shared-secret ``token`` before
    any other request is served.  Default token:
    ``AUTODIST_TPU_COORD_TOKEN``, else a fresh ``secrets`` token exported
    to this process's environment, so that in-process clients and
    launched workers inherit it.  ``bind_host`` restricts the listening
    interface (``AUTODIST_TPU_COORD_BIND``; default all interfaces).

    ``listen_sock`` (a held socket from :func:`reserve_coord_port`)
    hands an already-bound listening fd to the native server, which
    takes ownership of it."""

    def __init__(self, port: int = 0, bind_host: Optional[str] = None,
                 token: Optional[str] = None, listen_sock=None):
        self._lib = _load()
        self._handle = None
        if bind_host is None:
            bind_host = const.ENV.AUTODIST_TPU_COORD_BIND.val
        if token is None:
            token = const.ENV.AUTODIST_TPU_COORD_TOKEN.val
            if not token:
                import secrets

                token = secrets.token_hex(16)
                os.environ["AUTODIST_TPU_COORD_TOKEN"] = token
        self.token = token
        if listen_sock is not None:
            fd = listen_sock.detach()          # the native side owns it
            os.set_inheritable(fd, False)
            self._handle = self._lib.coord_server_adopt(fd, token.encode())
            if not self._handle:
                os.close(fd)
                raise OSError(
                    "could not adopt the reserved coordination socket")
        else:
            self._handle = self._lib.coord_server_start(
                (bind_host or "").encode(), port, token.encode())
        if not self._handle:
            raise OSError(f"could not start coordination server on port "
                          f"{port}")
        self.port = self._lib.coord_server_port(self._handle)

    def stop(self):
        if self._handle:
            self._lib.coord_server_stop(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class CoordClient:
    """Client of the coordination service.

    One instance a thread: requests are serialized on one TCP
    connection, so a blocking call (``get``, ``barrier``, ``queue_get``,
    ``ssp_wait``) stalls other calls on the same client.  The native
    calls release the GIL (ctypes), so a thread blocked in one does not
    stall the others."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 connect_timeout_ms: int = 10000,
                 token: Optional[str] = None,
                 retry: Optional[RetryPolicy] = DEFAULT_COORD_RETRY):
        self._lib = _load()
        self._handle = None
        self._shutdown = False
        if token is None:
            token = const.ENV.AUTODIST_TPU_COORD_TOKEN.val
        self._host, self._port = host, port
        self._token = token or ""
        self._connect_timeout_ms = connect_timeout_ms
        self._retry = retry
        self._handle = self._lib.coord_client_connect(
            host.encode(), port, connect_timeout_ms, self._token.encode())
        if not self._handle:
            raise OSError(
                f"could not connect to coordinator {host}:{port} "
                "(unreachable or token rejected)")

    def _reconnect(self):
        """Drop the (presumed dead) native client and dial again with
        the original connection parameters."""
        if self._handle:
            self._lib.coord_client_close(self._handle)
            self._handle = None
        handle = self._lib.coord_client_connect(
            self._host.encode(), self._port, self._connect_timeout_ms,
            self._token.encode())
        if not handle:
            raise OSError(f"could not reconnect to coordinator "
                          f"{self._host}:{self._port}")
        self._handle = handle

    def _call(self, op: Callable, describe: str):
        """Run one RPC closure; a failed call (dropped socket, server
        bounce, stale connection) reconnects and retries under the
        client's :class:`~autodist_tpu_torch.runtime.retry.RetryPolicy`,
        raising :class:`CoordUnavailableError` when the budget is spent.
        The happy path is the one native call.

        Retried ops are at-least-once: a request the server processed
        whose OK response died with the socket is sent again after the
        reconnect, so a ``counter_add``, ``queue_put`` or ``barrier``
        may land twice across a reconnect race.  A caller needing
        at-most-once passes ``retry=None`` and handles the raw
        ``OSError`` itself."""
        try:
            return op()
        except OSError:
            if self._retry is None or self._shutdown or not self._handle:
                raise    # opted out, or a deliberate cross-thread wake

            def reconnect_and_retry():
                if self._shutdown:   # woken mid-retry: stop dialing
                    raise RetryError(f"{describe}: client shut down",
                                     attempts=0)
                self._reconnect()
                return op()

            telemetry.counter("coord/reconnects").inc()
            try:
                result = self._retry.call(reconnect_and_retry,
                                          describe=describe)
            except (RetryError, OSError) as e:
                if isinstance(e, RetryError):
                    telemetry.counter("coord/unavailable").inc()
                raise CoordUnavailableError(
                    f"coordination service {self._host}:{self._port} "
                    f"unavailable: {e}") from e
            telemetry.counter("coord/reconnect_successes").inc()
            return result

    def close(self):
        """Free the native client.  Only the owning thread may call
        this: freeing while another thread is blocked in a call on it is
        a use-after-free (use :meth:`shutdown` across threads)."""
        if self._handle:
            self._lib.coord_client_close(self._handle)
            self._handle = None

    def shutdown(self):
        """Wake any call blocked on this client (it fails with
        ``OSError``) without freeing the native object; safe from any
        thread."""
        self._shutdown = True
        if self._handle:
            self._lib.coord_client_shutdown(self._handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # reclaim the socket when the owner thread is gone
        try:
            self.close()
        except Exception:
            pass

    # ------------------------------------------------------------------ #
    def put(self, key: str, value: bytes):
        def op():
            if self._lib.coord_put(self._handle, key.encode(), value,
                                   len(value)) != OK:
                raise OSError(f"put({key}) failed")
        return self._call(op, f"put({key})")

    def _pop(self, native, key: str, timeout_ms: int, what: str):
        """A blocking read (``get`` or ``queue_get``): the value, or
        ``None`` on a genuine timeout.  A premature timeout (the server
        answers ``TIMEOUT`` to every blocked read when it shuts down) is
        treated as a dropped connection, retried with the remaining
        budget."""
        deadline = None if timeout_ms < 0 \
            else time.monotonic() + timeout_ms / 1e3

        def op():
            remaining = timeout_ms if deadline is None else max(
                int((deadline - time.monotonic()) * 1e3), 0)
            out = ctypes.c_void_p()
            out_len = ctypes.c_uint32()
            st = native(self._handle, key.encode(), remaining,
                        ctypes.byref(out), ctypes.byref(out_len))
            if st == TIMEOUT:
                if deadline is None or time.monotonic() < deadline - 0.05:
                    raise OSError(f"{what}({key}): premature timeout "
                                  "(server shutting down?)")
                return None
            if st != OK:
                raise OSError(f"{what}({key}) failed")
            return self._take(out, out_len)
        return self._call(op, f"{what}({key})")

    def get(self, key: str, timeout_ms: int = 0) -> Optional[bytes]:
        """The value, waiting up to ``timeout_ms`` (-1: forever) for it
        to appear; ``None`` on a timeout."""
        return self._pop(self._lib.coord_get, key, timeout_ms, "get")

    def barrier(self, name: str, num_participants: int,
                timeout_ms: int = -1) -> bool:
        def op():
            st = self._lib.coord_barrier(self._handle, name.encode(),
                                         num_participants, timeout_ms)
            if st == ERROR:
                raise OSError(f"barrier({name}) failed")
            return st == OK
        return self._call(op, f"barrier({name})")

    def counter_add(self, key: str, delta: int = 1) -> int:
        def op():
            out = ctypes.c_int64()
            if self._lib.coord_counter_add(self._handle, key.encode(),
                                           delta, ctypes.byref(out)) != OK:
                raise OSError(f"counter_add({key}) failed")
            return out.value
        return self._call(op, f"counter_add({key})")

    def queue_put(self, key: str, value: bytes):
        def op():
            if self._lib.coord_queue_put(self._handle, key.encode(), value,
                                         len(value)) != OK:
                raise OSError(f"queue_put({key}) failed")
        return self._call(op, f"queue_put({key})")

    def queue_get(self, key: str, timeout_ms: int = -1) -> Optional[bytes]:
        """The queue's head, popped, waiting up to ``timeout_ms`` (-1:
        forever); ``None`` on a timeout."""
        return self._pop(self._lib.coord_queue_get, key, timeout_ms,
                         "queue_get")

    def ssp_register(self, worker: str):
        def op():
            if self._lib.coord_ssp_register(self._handle,
                                            worker.encode()) != OK:
                raise OSError("ssp_register failed")
        return self._call(op, "ssp_register")

    def ssp_report(self, worker: str, step: int):
        def op():
            if self._lib.coord_ssp_report(self._handle, worker.encode(),
                                          step) != OK:
                raise OSError("ssp_report failed")
        return self._call(op, "ssp_report")

    def ssp_wait(self, step: int, staleness: int) -> bool:
        """Block until every registered worker has completed step
        ``step - 1 - staleness``; False on the server's 10-minute
        timeout.  Not retried through a reconnect: a reconnected client
        would wait on a roster it registered on another connection;
        callers see the raw failure and register again."""
        st = self._lib.coord_ssp_wait(self._handle, step, staleness)
        if st == ERROR:
            raise OSError("ssp_wait failed")
        return st == OK

    # ------------------------------------------------------------------ #
    def _take(self, out, out_len) -> bytes:
        if not out or out_len.value == 0:
            return b""
        data = ctypes.string_at(out, out_len.value)
        self._lib.coord_free(out)
        return data


# One default client a thread: a CoordClient serializes its requests on
# one connection, so sharing one across threads would let a blocking
# call stall every other caller.  The registry holds weak references, so
# the clients of exited threads are reclaimed (CoordClient.__del__
# closes the socket) instead of accumulating.
_tls = threading.local()
_service_clients: "weakref.WeakSet[CoordClient]" = weakref.WeakSet()
_service_clients_lock = threading.Lock()


def service_client() -> Optional[CoordClient]:
    """This thread's client of the service named by
    ``AUTODIST_TPU_COORD_SERVICE`` (``host:port``), or ``None`` when no
    service is configured or it cannot be reached."""
    addr = const.ENV.AUTODIST_TPU_COORD_SERVICE.val
    if not addr:
        return None
    cached = getattr(_tls, "client", None)
    if cached is not None:
        if (cached._handle and not cached._shutdown
                and getattr(_tls, "addr", None) == addr):
            return cached
        cached.close()   # ours: a stale address or shut down; replace it
        _tls.client = None
    host, _, port = addr.rpartition(":")
    try:
        client = CoordClient(host or "127.0.0.1", int(port))
    except (OSError, ValueError) as e:
        _log.warning("coordination service %s unreachable (%s); "
                     "continuing without it", addr, e)
        return None
    _tls.client, _tls.addr = client, addr
    with _service_clients_lock:
        _service_clients.add(client)
    return client


def reset_service_client():
    """Wake and retire every cached default client (when the service
    shuts down).  Other threads' clients are only shut down, never freed
    from here (a blocked call may hold them); each owner closes or
    replaces its own at its next use.  This thread's client is closed."""
    own = getattr(_tls, "client", None)
    with _service_clients_lock:
        for c in list(_service_clients):
            if c is not own:
                try:
                    c.shutdown()
                except OSError:
                    pass
        _service_clients.clear()
    if own is not None:
        own.close()
    _tls.client = None
    _tls.addr = None


class SSPController:
    """The stale-synchronous-parallel gate around a worker's step loop
    (the reference's depth-``staleness`` token queues,
    ``ps_synchronizer.py:387-458``)::

        ssp = SSPController(client, worker="host3", staleness=3)
        for step in range(n):
            ssp.start_step(step)   # blocks while > staleness ahead
            runner.step(batch)
            ssp.finish_step(step)

    ``staleness=0`` is bulk-synchronous lockstep.  ``num_workers``, when
    given, barriers until that many workers have registered, so that an
    early starter cannot run ahead before its peers register.  Each wait
    goes to the ``ssp/gate_wait_s`` histogram (how long this worker
    waited for its slowest peer), each timed-out one to the
    ``ssp/gate_timeouts`` counter."""

    def __init__(self, client: CoordClient, worker: str, staleness: int,
                 num_workers: Optional[int] = None,
                 register_timeout_ms: int = 600000):
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self.client = client
        self.worker = worker
        self.staleness = staleness
        client.ssp_register(worker)
        if num_workers is not None:
            if not client.barrier("ssp/registered", num_workers,
                                  timeout_ms=register_timeout_ms):
                raise TimeoutError(
                    f"only some of the {num_workers} SSP workers registered "
                    f"within {register_timeout_ms}ms")

    def start_step(self, step: int) -> bool:
        t0 = time.perf_counter()
        ok = self.client.ssp_wait(step, self.staleness)
        telemetry.histogram("ssp/gate_wait_s").observe(
            time.perf_counter() - t0)
        if not ok:
            telemetry.counter("ssp/gate_timeouts").inc()
        return ok

    def finish_step(self, step: int):
        self.client.ssp_report(self.worker, step)
