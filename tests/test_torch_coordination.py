"""The port's coordination service (``runtime/coordination.py`` over its
copy of ``native/coord.cc``), case for case with
``tests/unit/test_coordination.py``: KV with blocking get, counters,
FIFO queues, barriers, the SSP gate's timing (the reference's c9 case:
a slow worker sleeps, the fast one must block exactly where the
staleness bound says), a large value, authentication, the bind host,
reconnect and retry, and the held-socket port election.  One more case
holds the two packages' copies of the wire protocol to each other: the
JAX client against the port's server, and the port's client against the
JAX server.
"""
import os
import socket
import struct
import threading
import time

import pytest

from autodist_tpu_torch import telemetry
from autodist_tpu_torch.runtime.coordination import (CoordClient,
                                                     CoordServer,
                                                     CoordUnavailableError,
                                                     SSPController,
                                                     reserve_coord_port)
from autodist_tpu_torch.runtime.retry import RetryPolicy


@pytest.fixture()
def server():
    with CoordServer() as s:
        yield s


def client(server):
    return CoordClient("127.0.0.1", server.port, token=server.token)


def test_kv_put_get(server):
    with client(server) as c:
        c.put("strategy/abc", b"json-bytes")
        assert c.get("strategy/abc") == b"json-bytes"
        assert c.get("missing", timeout_ms=50) is None


def test_kv_blocking_get_unblocks_on_put(server):
    """A worker blocks on a key until the chief publishes it."""
    got = {}

    def worker():
        with client(server) as c:
            got["val"] = c.get("strategy/late", timeout_ms=5000)

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.15)
    with client(server) as c:
        c.put("strategy/late", b"s1")
    t.join(timeout=5)
    assert got["val"] == b"s1"


def test_counter(server):
    with client(server) as c:
        assert c.counter_add("steps", 1) == 1
        assert c.counter_add("steps", 5) == 6
        assert c.counter_add("other", 2) == 2


def test_queue_fifo_and_blocking(server):
    with client(server) as c:
        c.queue_put("tokens", b"a")
        c.queue_put("tokens", b"b")
        assert c.queue_get("tokens") == b"a"
        assert c.queue_get("tokens") == b"b"
        assert c.queue_get("tokens", timeout_ms=50) is None
    got = {}

    def popper():
        with client(server) as c:
            got["val"] = c.queue_get("later", timeout_ms=5000)

    t = threading.Thread(target=popper)
    t.start()
    time.sleep(0.15)
    with client(server) as c:
        c.queue_put("later", b"z")
    t.join(timeout=5)
    assert got["val"] == b"z"


def test_barrier_three_participants(server):
    n = 3
    release_times = []

    def participant(delay):
        with client(server) as c:
            time.sleep(delay)
            assert c.barrier("start", n, timeout_ms=10000)
            release_times.append(time.monotonic())

    threads = [threading.Thread(target=participant, args=(d,))
               for d in (0.0, 0.1, 0.3)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(release_times) == n
    # Nobody released before the last participant arrived (~0.3 s), and
    # all released together.
    assert min(release_times) - t0 > 0.25
    assert max(release_times) - min(release_times) < 0.2


def test_barrier_reusable(server):
    """The generation counter lets one name serve every step."""
    n = 2
    done = []

    def participant():
        with client(server) as c:
            for _ in range(3):
                assert c.barrier("step", n, timeout_ms=10000)
            done.append(True)

    threads = [threading.Thread(target=participant) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(done) == n


def test_barrier_timeout(server):
    with client(server) as c:
        assert not c.barrier("lonely", 2, timeout_ms=100)


def test_ssp_timing_bounded_staleness(server):
    """c9: staleness=2 lets the fast worker run at most 3 steps ahead;
    it blocks on step 3 until the slow worker finishes step 0.  Each
    wait is observed in the ``ssp/gate_wait_s`` histogram."""
    staleness = 2
    fast_step_starts = {}
    slow_started = threading.Event()
    waits = telemetry.histogram("ssp/gate_wait_s")
    seen = len(waits.values)

    def fast():
        with client(server) as c:
            ssp = SSPController(c, "fast", staleness, num_workers=2)
            slow_started.wait(5)
            for step in range(5):
                assert ssp.start_step(step)
                fast_step_starts[step] = time.monotonic()
                ssp.finish_step(step)

    def slow():
        with client(server) as c:
            slow_started.set()
            ssp = SSPController(c, "slow", staleness, num_workers=2)
            for step in range(5):
                assert ssp.start_step(step)
                time.sleep(0.3)
                ssp.finish_step(step)

    t0 = time.monotonic()
    ts = [threading.Thread(target=fast), threading.Thread(target=slow)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert fast_step_starts[2] - t0 < 0.25
    assert fast_step_starts[3] - t0 > 0.25
    assert fast_step_starts[4] - t0 > 0.55
    assert len(waits.values) - seen == 10
    assert max(list(waits.values)[seen:]) > 0.2


def test_ssp_zero_staleness_is_lockstep(server):
    """staleness=0: no worker starts step k + 1 before every worker
    finished step k."""
    order = []

    def worker(name, delay):
        with client(server) as c:
            ssp = SSPController(c, name, staleness=0, num_workers=2)
            for step in range(3):
                assert ssp.start_step(step)
                order.append((name, step))
                time.sleep(delay)
                ssp.finish_step(step)

    ts = [threading.Thread(target=worker, args=("fast", 0.0)),
          threading.Thread(target=worker, args=("slow", 0.1))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    last_of, first_of = {}, {}
    for i, (_, step) in enumerate(order):
        last_of[step] = i
    for i, (_, step) in reversed(list(enumerate(order))):
        first_of[step] = i
    for k in range(2):
        assert last_of[k] < first_of[k + 1]


def test_ssp_negative_staleness_raises(server):
    with client(server) as c:
        with pytest.raises(ValueError, match="staleness must be >= 0"):
            SSPController(c, "w", -1)


def test_large_value_roundtrip(server):
    """A 100 MB value: above the JAX copy's 64 MiB frame, below one
    BERT-base fp32 tree (the asynchronous PS's blob)."""
    blob = bytes(range(256)) * (100 * 4096)
    with client(server) as c:
        c.put("big", blob)
        assert c.get("big") == blob
        c.queue_put("bigq", blob)
        assert c.queue_get("bigq") == blob


def test_auth_rejects_wrong_token(server):
    """A connection with a bad (or missing) token is refused before it
    can touch barriers, KV or queues."""
    with pytest.raises(OSError, match="token rejected|could not connect"):
        CoordClient("127.0.0.1", server.port, connect_timeout_ms=2000,
                    token="wrong-" + server.token)
    c = CoordClient("127.0.0.1", server.port, connect_timeout_ms=2000,
                    token="")
    with pytest.raises(OSError):
        c.put("k", b"v")
    c.close()
    with client(server) as c:
        c.put("k", b"v")
        assert c.get("k") == b"v"


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@pytest.mark.parametrize("token", ["a-token", ""])
def test_a_declared_frame_commits_no_memory_it_was_not_sent(token):
    """A peer declares a 2 GiB frame and sends 64 bytes of it.  Before
    its token matched, the server drops the connection at the length
    field; a server with no token grows the frame's buffer only as its
    bytes arrive.  Either way the service goes on serving."""
    with CoordServer(token=token) as s:
        before = _rss_bytes()
        with socket.create_connection(("127.0.0.1", s.port),
                                      timeout=5) as sock:
            sock.sendall(struct.pack("<IBH", (2 << 30) - 1, 10, 0)
                         + b"x" * 64)
            if token:
                try:
                    got = sock.recv(1)
                except ConnectionResetError:
                    got = b""
                assert got == b""       # dropped, no response
            else:
                sock.settimeout(0.3)
                with pytest.raises(socket.timeout):
                    sock.recv(1)        # still reading the frame
            assert _rss_bytes() - before < 64 << 20
        with CoordClient("127.0.0.1", s.port, token=token) as c:
            c.put("k", b"v")
            assert c.get("k") == b"v"


def test_bind_host_restricts_interface():
    with CoordServer(bind_host="127.0.0.1") as s:
        with CoordClient("127.0.0.1", s.port, token=s.token) as c:
            c.put("x", b"1")
            assert c.get("x") == b"1"


def test_happy_path_never_reconnects(server, monkeypatch):
    """With no fault the retry policy changes nothing: the client never
    dials a reconnect, and no reconnect counter moves."""
    before = telemetry.counter("coord/reconnects").value
    with client(server) as c:
        dialed = []
        monkeypatch.setattr(c, "_reconnect", lambda: dialed.append(1))
        c.put("k", b"v")
        assert c.get("k") == b"v"
        assert c.counter_add("n", 1) == 1
        assert dialed == []
    assert telemetry.counter("coord/reconnects").value == before


def test_reconnect_on_server_bounce_mid_get():
    """A client blocked in ``get`` survives the server stopping and
    starting again on the same port, and receives the value published
    after the bounce; the reconnect counters move."""
    s = CoordServer()
    port, token = s.port, s.token
    c = CoordClient("127.0.0.1", port, token=token,
                    retry=RetryPolicy(max_attempts=10, base_delay_s=0.2,
                                      cap_delay_s=0.5, deadline_s=30.0,
                                      seed=0))
    before = (telemetry.counter("coord/reconnects").value,
              telemetry.counter("coord/reconnect_successes").value)
    got = {}
    t = threading.Thread(
        target=lambda: got.update(v=c.get("late", timeout_ms=20000)))
    t.start()
    try:
        time.sleep(0.3)          # the get is blocked server-side
        s.stop()                 # ... and its socket just died
        time.sleep(0.3)
        s = CoordServer(port=port, token=token)
        with CoordClient("127.0.0.1", port, token=token) as pub:
            pub.put("late", b"value")
        t.join(timeout=25)
        assert not t.is_alive(), "client never recovered from the bounce"
        assert got.get("v") == b"value"
        assert telemetry.counter("coord/reconnects").value == before[0] + 1
        assert (telemetry.counter("coord/reconnect_successes").value
                == before[1] + 1)
    finally:
        c.close()
        s.stop()


def test_exhausted_retries_raise_typed_unavailable():
    assert issubclass(CoordUnavailableError, OSError)
    s = CoordServer()
    c = CoordClient("127.0.0.1", s.port, token=s.token,
                    retry=RetryPolicy(max_attempts=2, base_delay_s=0.05,
                                      cap_delay_s=0.05, seed=0))
    before = telemetry.counter("coord/unavailable").value
    s.stop()
    with pytest.raises(CoordUnavailableError, match="unavailable"):
        c.put("k", b"v")
    assert telemetry.counter("coord/unavailable").value == before + 1
    c.close()


def test_retry_opt_out_keeps_raw_oserror():
    s = CoordServer()
    c = CoordClient("127.0.0.1", s.port, token=s.token, retry=None)
    s.stop()
    with pytest.raises(OSError) as ei:
        c.put("k", b"v")
    assert not isinstance(ei.value, CoordUnavailableError)
    c.close()


def test_concurrent_spawns_reserve_distinct_ports():
    """``reserve_coord_port`` keeps each elected port bound until its
    server adopts the fd, so concurrent spawns never elect one port."""
    n = 12
    socks = [reserve_coord_port() for _ in range(n)]
    ports = [sock.getsockname()[1] for sock in socks]
    assert len(set(ports)) == n, f"duplicate reserved ports: {ports}"
    servers: list = [None] * n
    errors: list = [None] * n

    def adopt(i):
        try:
            servers[i] = CoordServer(listen_sock=socks[i])
        except Exception as e:    # noqa: BLE001 — surfaced below
            errors[i] = e

    threads = [threading.Thread(target=adopt, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    try:
        assert errors == [None] * n, errors
        for i, s in enumerate(servers):
            assert s.port == ports[i]
            with CoordClient("127.0.0.1", s.port, token=s.token) as c:
                c.put("spawn/port", str(ports[i]).encode())
                assert c.get("spawn/port") == str(ports[i]).encode()
    finally:
        for s in servers:
            if s is not None:
                s.stop()


def test_service_client_is_one_a_thread(monkeypatch):
    """``service_client`` gives each thread its own client of the
    advertised service; ``reset_service_client`` wakes another thread's
    blocked client without freeing it, and closes this thread's."""
    from autodist_tpu_torch.runtime import coordination

    with CoordServer() as s:
        monkeypatch.setenv("AUTODIST_TPU_COORD_SERVICE",
                           f"127.0.0.1:{s.port}")
        monkeypatch.setenv("AUTODIST_TPU_COORD_TOKEN", s.token)
        coordination.reset_service_client()
        mine = coordination.service_client()
        assert coordination.service_client() is mine
        out = {}

        def other():
            c = coordination.service_client()
            out["client"] = c
            try:
                c.queue_get("never", timeout_ms=-1)
            except OSError as e:
                out["woken"] = e

        t = threading.Thread(target=other)
        t.start()
        time.sleep(0.3)
        assert out["client"] is not mine
        coordination.reset_service_client()
        t.join(timeout=10)
        assert not t.is_alive() and "woken" in out
        assert mine._handle is None                  # ours: closed
        assert out["client"]._handle is not None     # theirs: only woken
        assert coordination.service_client() is not mine
        coordination.reset_service_client()
        monkeypatch.delenv("AUTODIST_TPU_COORD_SERVICE")
        assert coordination.service_client() is None


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_the_packages_speak_one_protocol(server_side):
    """The JAX client against the port's server, and the port's client
    against the JAX server: KV, blocking get, counters, queues, a
    barrier and an SSP wait agree."""
    from autodist_tpu.runtime import coordination as jcoord

    token = "cross-package-token"
    srv = (CoordServer if server_side == "port" else jcoord.CoordServer)(
        token=token)
    try:
        p = CoordClient("127.0.0.1", srv.port, token=token)
        j = jcoord.CoordClient("127.0.0.1", srv.port, token=token)
        p.put("from/port", b"p" * 1000)
        j.put("from/jax", b"j" * 1000)
        assert j.get("from/port") == b"p" * 1000
        assert p.get("from/jax") == b"j" * 1000
        assert p.get("absent", timeout_ms=50) is None
        assert j.counter_add("n", 2) == 2 and p.counter_add("n", 3) == 5
        for i in range(3):
            (p if i % 2 else j).queue_put("q", bytes([i]))
        assert [p.queue_get("q"), j.queue_get("q"), p.queue_get("q")] \
            == [b"\x00", b"\x01", b"\x02"]
        assert j.queue_get("q", timeout_ms=50) is None
        # A barrier of one client of each package.
        got = {}
        t = threading.Thread(
            target=lambda: got.update(b=j.barrier("both", 2, 5000)))
        t.start()
        assert p.barrier("both", 2, 5000)
        t.join(timeout=10)
        assert got["b"]
        # SSP: the port's worker waits for the JAX worker's progress.
        p.ssp_register("port")
        j.ssp_register("jax")
        p.ssp_report("port", 1)
        t = threading.Thread(target=lambda: got.update(w=p.ssp_wait(2, 0)))
        t.start()
        time.sleep(0.3)
        assert t.is_alive(), "the gate opened before the JAX worker's step"
        j.ssp_report("jax", 1)
        t.join(timeout=10)
        assert got["w"] is True
        p.close()
        j.close()
    finally:
        srv.stop()
