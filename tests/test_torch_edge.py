"""The port's network edge (``dcf_tpu_torch.serve.edge``) against
``dcf_tpu``'s, byte for byte and over loopback TCP.

Frames: every DCFE codec of the port encodes, on the same seeded
inputs, exactly the bytes ``dcf_tpu.serve.edge`` encodes (REQUEST,
SHARE, ERROR with every wire code, PING / PONG with and without the
load block, REGISTER carrying DCFK frames of proto 0, 1 and 2, DIGEST
in both modes, SYNC), and each package decodes the other's frames to
the same values; an ERROR frame decodes to the same error class with
the same ``retry_after_s`` and evicted flag in both.  Interop: a port
``EdgeServer`` (``walk``, B1's plain version) answers a ``dcf_tpu``
``EdgeClient`` and a ``dcf_tpu`` ``EdgeServer`` (its ``numpy`` facade)
answers a port ``EdgeClient``, plain and TLS, XOR and add16, both
parties, x = alpha included, every share equal to the port's numpy
oracle.  Then the edge's contracts on the port: the token bucket's
refill schedule, tenant classes and hinted refusals, byte flips,
truncations and oversized prefixes dying typed on one connection, the
``edge.read`` / ``edge.accept`` seams, the slow-loris bound, TLS
refusing plaintext and pinning clients, the PONG load block, the
ring-epoch fence on the wire, the open- and closed-loop generators over
the wire, and one scripted sequence whose metrics snapshot equals
``dcf_tpu``'s key for key.  Tolerance: exact byte equality; counters
and gauges equal.  Every socket binds port 0 and every wait is bounded.
"""

import pathlib
import socket
import struct

import numpy as np
import pytest

import dcf_tpu.errors as jerrors
import dcf_tpu.serve.edge as jedge
from dcf_tpu.serve.loadgen import open_loop as j_open_loop

import dcf_tpu_torch.errors as perrors
import dcf_tpu_torch.serve.edge as pedge
from dcf_tpu_torch import Dcf
from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    DcfError,
    QueueFullError,
    RingEpochError,
    ShapeError,
)
from dcf_tpu_torch.serve import (
    EdgeClient,
    EdgeClientPool,
    EdgeServer,
    ServeConfig,
    TenantSpec,
)
from dcf_tpu_torch.serve.loadgen import (
    closed_loop,
    open_loop,
    reconcile_against_rollup,
)
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.testing.faults import FakeClock
from tests.torch_net import (
    CK,
    LAM,
    NB,
    PKGS,
    PORT,
    REF,
    WAIT_S,
    assert_shares,
    make_bundle,
    oracle,
    points,
    raw_exchange,
    service,
    serve_in_threads,
    wait_for,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

TLS_DIR = pathlib.Path(__file__).parent / "data" / "tls"
TLS_SERVER = dict(tls_cert=str(TLS_DIR / "server.pem"),
                  tls_key=str(TLS_DIR / "server.key"))
TLS_CLIENT = dict(tls=True, tls_ca=str(TLS_DIR / "ca.pem"))


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0xED6E)


@pytest.fixture(scope="module")
def bundles(rng):
    return {"edge-a": make_bundle(rng), "edge-b": make_bundle(rng),
            "edge-add": make_bundle(rng, "add16")}


# --------------------------------------------------------------- frames


def _frame_cases(rng):
    """``{name: (encode(edge_module, pkg_obj) -> bytes, decoder name)}``
    over seeded inputs; key-material frames come from the port's host
    keygen and cross to ``dcf_tpu`` by their DCFK bytes."""
    xs = rng.integers(0, 256, (5, NB), dtype=np.uint8)
    y = rng.integers(0, 256, (2, 5, LAM), dtype=np.uint8)
    fac = Dcf(NB, LAM, CK, backend="numpy", device="cpu")
    kb = make_bundle(rng).to_bytes()
    mic = fac.mic([(3, 900), (40000, 1 << 16)],
                  rng.integers(0, 256, (2, LAM), dtype=np.uint8),
                  rng=rng).to_bytes()
    dpf = Dcf(1, 32, CK, device="cpu").dpf(
        np.array([[9], [200]], np.uint8), rng=rng,
        device=False).to_bytes()
    load = (12, 1 << 20, True, 7, 3, 1)
    cases = {
        "request": (lambda e: e.encode_request(
            77, "gold", "kéy", 1, 0, 12.5, xs.data, NB, 5,
            epoch=9), "decode_request"),
        "request-defaults": (lambda e: e.encode_request(
            1, "", "edge-a", 0, 255, None, xs.data, NB, 5),
            "decode_request"),
        "share": (lambda e: b"".join(
            bytes(p) for p in e.encode_share(5, y)), "decode_response"),
        "ping": (lambda e: e.encode_ping(3), "decode_ping"),
        "ping-epoch-load": (lambda e: e.encode_ping(
            4, epoch=6, want_load=True), "decode_ping"),
        "pong": (lambda e: e.encode_pong(3, 11), "decode_response"),
        "pong-load": (lambda e: e.encode_pong(4, 6, load=load),
                      "decode_response"),
        "register-proto0": (lambda e: e.encode_register(
            8, "dcf-key", kb), "decode_register"),
        "register-proto1": (lambda e: e.encode_register(
            9, "mic-key", mic, generation=5, proto=True, epoch=3),
            "decode_register"),
        "register-proto2": (lambda e: e.encode_register(
            10, "dpf-key", dpf, generation=2, proto=True),
            "decode_register"),
        "digest-0": (lambda e: e.encode_digest(
            11, {"b": 7, "a": 2, "é": 1}, mode=0), "decode_digest"),
        "digest-1": (lambda e: e.encode_digest(12, {}, mode=1),
                     "decode_digest"),
        "sync": (lambda e: e.encode_sync(13, [
            ("a", 3, False, kb), ("m", 4, True, mic),
            ("z", 9, False, b"")]), "decode_response"),
    }
    for code in sorted(jedge.WIRE_CODES):
        for hint in (None, 0.25):
            cases[f"error-{code}-{hint}"] = (
                lambda e, c=code, h=hint: e.encode_error(
                    21, c, f"refused {c}", h), "decode_response")
    return cases


FRAME_NAMES = sorted(_frame_cases(np.random.default_rng(0)))


def _canon(value):
    """Decoded frames as comparable plain values (memoryviews and
    arrays to bytes, namedtuples to tuples)."""
    if isinstance(value, dict):
        return {k: _canon(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return tuple(_canon(v) for v in value)
    if isinstance(value, (memoryview, bytearray)):
        return bytes(value)
    if isinstance(value, np.ndarray):
        return (value.shape, value.tobytes())
    return value


@pytest.mark.parametrize("name", FRAME_NAMES)
def test_frames_byte_equal_and_decoded_both_ways(name):
    """Each codec: the port's bytes equal ``dcf_tpu``'s on the same
    inputs, and each package decodes the other's frame (envelope
    stripped) to the same values."""
    enc, dec = _frame_cases(np.random.default_rng(0xF4A))[name]
    wire_p, wire_j = enc(pedge), enc(jedge)
    assert isinstance(wire_p, bytes) and wire_p == wire_j
    (body_len,) = struct.unpack_from("<I", wire_p, 0)
    body = wire_p[4:]
    assert body_len == len(body)
    got_p = _canon(getattr(pedge, dec)(bytearray(body)))
    got_j = _canon(getattr(jedge, dec)(bytearray(body)))
    assert got_p == got_j


def test_wire_taxonomy_equal_to_dcf_tpu():
    """The code table, the internal-only set and the code each error
    class crosses the wire as are ``dcf_tpu``'s, class name for class
    name; the first-match order maps every typed error."""
    assert {c: k.__name__ for c, k in pedge.WIRE_CODES.items()} == \
        {c: k.__name__ for c, k in jedge.WIRE_CODES.items()}
    assert {k.__name__ for k in pedge.WIRE_INTERNAL_ONLY} == \
        {k.__name__ for k in jedge.WIRE_INTERNAL_ONLY}
    names = [n for n in jerrors.__all__
             if isinstance(getattr(jerrors, n), type)
             and issubclass(getattr(jerrors, n), jerrors.DcfError)]
    assert names and set(names) <= set(perrors.__all__)
    for n in names:
        jcls, pcls = getattr(jerrors, n), getattr(perrors, n)
        for kw in ({}, {"evicted": True}):
            if kw and jcls is not jerrors.QueueFullError:
                continue
            if n == "LockOrderError":
                je, pe = jcls("x"), pcls("x")
            else:
                je, pe = jcls("x", **kw), pcls("x", **kw)
            assert pedge._code_for(pe) == jedge._code_for(je), (n, kw)
    assert pedge._code_for(ValueError("v")) == pedge.E_BAD_REQUEST
    assert pedge._code_for(KeyError("k")) == pedge.E_INTERNAL


@pytest.mark.parametrize("code", sorted(jedge.WIRE_CODES))
def test_error_frames_raise_the_same_class_both_ways(code):
    """An ERROR frame from either package, decoded and re-raised by
    either client path: the same class, ``retry_after_s``, evicted flag
    and ``wire_code``."""
    for hint in (None, 1.5):
        for enc in (pedge, jedge):
            body = enc.encode_error(9, code, "no", hint)[4:]
            outs = []
            for dec in (pedge, jedge):
                kind, req_id, c, retry, msg = dec.decode_response(body)
                assert (kind, req_id, c, msg) == ("error", 9, code, "no")
                err = dec._raise_wire(c, retry, msg)
                outs.append((type(err).__name__,
                             getattr(err, "retry_after_s", None),
                             getattr(err, "evicted", None),
                             err.wire_code))
            assert outs[0] == outs[1], (code, hint)
    evicted = pedge._raise_wire(pedge.E_EVICTED, 1.0, "x")
    assert isinstance(evicted, QueueFullError) and evicted.evicted
    assert pedge._code_for(evicted) == pedge.E_EVICTED
    assert pedge._raise_wire(pedge.E_QUEUE_FULL, None, "y").evicted is False


def test_frame_decoders_refuse_mangled_frames_typed(rng):
    """A truncated, CRC-broken or version-bumped frame dies
    ``KeyFormatError`` in the port's decoders, as in ``dcf_tpu``'s."""
    xs = rng.integers(0, 256, (3, NB), dtype=np.uint8)
    body = bytearray(pedge.encode_request(1, "", "k", 0, 255, None,
                                          xs.data, NB, 3)[4:])
    for mangled in (body[:10], body[:-1], bytes(body[:-4]) + b"\0" * 4,
                    body[:4] + struct.pack("<H", 1) + body[6:]):
        for dec in (pedge, jedge):
            with pytest.raises(ValueError):
                dec.decode_request(bytearray(mangled))
    with pytest.raises(perrors.KeyFormatError, match="crc32"):
        pedge.decode_request(bytearray(bytes(body[:-4]) + b"\0" * 4))


# ------------------------------------------------------ interop over TCP


@pytest.mark.parametrize("tls", [False, True], ids=["plain", "tls"])
@pytest.mark.parametrize("group", ["xor", "add16"])
@pytest.mark.parametrize("server,client", [
    ("port", "dcf_tpu"), ("dcf_tpu", "port"), ("port", "port")])
def test_interop_shares_equal_the_oracle(server, client, group, tls,
                                         bundles, rng):
    """A server of one package answers a client of the other: both
    parties' shares, x = alpha included, byte-equal to the port's
    numpy oracle."""
    spkg, cpkg = PKGS[server], PKGS[client]
    name = "edge-add" if group == "add16" else "edge-a"
    svc = service(spkg, bundles)
    srv = spkg.edge.EdgeServer(svc, **(TLS_SERVER if tls else {})).start()
    try:
        with cpkg.edge.EdgeClient(*srv.address, n_bytes=NB,
                                  **(TLS_CLIENT if tls else {})) as c:
            for m in (1, 13, 37):
                xs = points(rng, m)
                assert_shares(lambda b: c.evaluate(
                    name, xs, b=b, timeout=WAIT_S), bundles[name], xs)
    finally:
        srv.close()
        svc.close()


def test_tls_pipelined_from_threads_over_one_connection(bundles, rng):
    """Four threads pipelining 12 requests each over ONE TLS client
    (the reader thread and the submitters share one OpenSSL object):
    every share arrives and equals the oracle."""
    svc = service(PORT, bundles)
    srv = EdgeServer(svc, **TLS_SERVER).start()
    xs = [points(rng, int(m)) for m in rng.integers(1, 20, 48)]
    try:
        with EdgeClient(*srv.address, n_bytes=NB, **TLS_CLIENT) as c:
            def run(t):
                futs = [(i, c.submit("edge-b", xs[i], b=i % 2))
                        for i in range(t, 48, 4)]
                return [(i, f.result(WAIT_S)) for i, f in futs]

            for part in serve_in_threads(run, 4):
                for i, y in part:
                    assert np.array_equal(
                        y, oracle(bundles["edge-b"], i % 2, xs[i]))
    finally:
        srv.close()
        svc.close()


def test_tls_plaintext_refused_counted_and_client_pinning(bundles, rng):
    """A plaintext client against the TLS port dies typed on its own
    connection, counted (a bounded poll on the reader thread's
    counter), and the accept loop serves the next TLS client; with
    ``tls_client_ca`` only a client presenting the CA-signed cert
    completes the handshake."""
    svc = service(PORT, bundles)
    srv = EdgeServer(svc, **TLS_SERVER).start()
    xs = points(rng, 6)
    try:
        before = svc.metrics_snapshot()["edge_connection_errors_total"]
        with pytest.raises((BackendUnavailableError, OSError)):
            plain = EdgeClient(*srv.address, n_bytes=NB)
            try:
                plain.evaluate("edge-a", xs, b=0, timeout=10)
            finally:
                plain.close()
        wait_for(lambda: svc.metrics_snapshot()[
            "edge_connection_errors_total"] > before,
            "the plaintext connection's error count")
        with EdgeClient(*srv.address, n_bytes=NB, **TLS_CLIENT) as c:
            assert_shares(lambda b: c.evaluate(
                "edge-a", xs, b=b, timeout=WAIT_S), bundles["edge-a"], xs)
    finally:
        srv.close()
    pinned = EdgeServer(svc, tls_client_ca=str(TLS_DIR / "ca.pem"),
                        **TLS_SERVER).start()
    try:
        with pytest.raises((BackendUnavailableError, OSError)):
            c = EdgeClient(*pinned.address, n_bytes=NB, **TLS_CLIENT)
            try:
                c.evaluate("edge-a", xs, b=0, timeout=10)
            finally:
                c.close()
        with EdgeClient(*pinned.address, n_bytes=NB,
                        tls_cert=str(TLS_DIR / "client.pem"),
                        tls_key=str(TLS_DIR / "client.key"),
                        **TLS_CLIENT) as c:
            assert c.evaluate("edge-a", xs, b=0,
                              timeout=WAIT_S).shape == (1, 6, LAM)
    finally:
        pinned.close()
        svc.close()


def test_tls_and_edge_config_contracts(bundles):
    with pytest.raises(ValueError, match="BOTH"):
        ServeConfig(tls_cert="cert.pem")
    with pytest.raises(ValueError, match="tls_client_ca"):
        ServeConfig(tls_client_ca="ca.pem")
    with pytest.raises(ValueError, match="BOTH"):
        EdgeClient("127.0.0.1", 1, n_bytes=NB, tls=True, tls_cert="c.pem")
    svc = service(PORT, bundles, start=False)
    try:
        with pytest.raises(ValueError, match="read_timeout_s"):
            EdgeServer(svc, read_timeout_s=-1)
        with pytest.raises(ValueError, match="max_frame_bytes"):
            EdgeServer(svc, max_frame_bytes=4)
        with pytest.raises(ValueError, match="BOTH"):
            EdgeServer(svc, tls_cert=TLS_SERVER["tls_cert"])
        with pytest.raises(ValueError, match="pool size"):
            EdgeClientPool("127.0.0.1", 1, n_bytes=NB, size=0)
        with pytest.raises(perrors.StaleStateError):
            EdgeServer(svc).address
    finally:
        svc.close()


# ------------------------------------------------- tenants and buckets


def test_token_bucket_refill_schedule_equal_to_dcf_tpu():
    """The exact refill schedule (refusal hints are times to refill,
    an oversized request is refused even against a full bucket), and
    the same admit sequence as ``dcf_tpu``'s bucket over a seeded
    schedule."""
    clk = FakeClock(100.0)
    tb = pedge.TokenBucket(10.0, 20, clk())
    assert tb.admit(20, clk()) == 0.0
    assert tb.admit(5, clk()) == pytest.approx(0.5)
    clk.advance(0.5)
    assert tb.admit(5, clk()) == 0.0
    assert tb.admit(100, clk()) == pytest.approx(10.0)
    full = pedge.TokenBucket(10.0, 20, clk())
    assert full.admit(1000, clk()) == pytest.approx(98.0)
    assert full.admit(20, clk()) == 0.0
    assert pedge.TokenBucket(0.0, 0, clk()).admit(10 ** 9, clk()) == 0.0
    with pytest.raises(ValueError):
        pedge.TokenBucket(-1.0, 0, 0.0)
    r = np.random.default_rng(5)
    p, j = pedge.TokenBucket(64.0, 16, 0.0), jedge.TokenBucket(64.0, 16, 0.0)
    t = 0.0
    for _ in range(300):
        t += float(r.exponential(0.05))
        pts = int(r.integers(1, 24))
        assert p.admit(pts, t) == j.admit(pts, t)


def test_tenant_classes_and_hinted_refusals(bundles, rng):
    """Tenants map onto the existing classes: under brownout bronze
    (BATCH) is refused where silver serves, a frame may demote below
    its tenant's class but never promote above it, and the bucket's
    refusal carries its time to refill."""
    svc = service(PORT, bundles, tenants=(
        TenantSpec("gold", "critical"), TenantSpec("silver", "normal"),
        TenantSpec("bronze", "batch"),
        TenantSpec("capped", "normal", points_per_sec=5.0,
                   burst_points=8)))
    srv = EdgeServer(svc).start()
    xs = points(rng, 8)
    try:
        host, port = srv.address
        with EdgeClient(host, port, n_bytes=NB, tenant="capped") as c:
            assert c.evaluate("edge-a", xs, timeout=WAIT_S).shape == \
                (1, 8, LAM)
            with pytest.raises(QueueFullError) as ei:
                c.evaluate("edge-a", xs, timeout=WAIT_S)
            # 1.6 s to refill: a host slow enough to refill the bucket
            # between two requests would have to stall 1.6 s, not 0.16
            assert ei.value.retry_after_s == pytest.approx(8 / 5.0,
                                                           rel=0.5)
            assert ei.value.wire_code == pedge.E_RATE_LIMITED
        svc.queue.set_brownout(True)
        with EdgeClient(host, port, n_bytes=NB, tenant="gold") as gold, \
                EdgeClient(host, port, n_bytes=NB,
                           tenant="silver") as silver, \
                EdgeClient(host, port, n_bytes=NB,
                           tenant="bronze") as bronze:
            assert silver.evaluate("edge-a", xs,
                                   timeout=WAIT_S).shape == (1, 8, LAM)
            with pytest.raises(QueueFullError) as ei:
                bronze.evaluate("edge-a", xs, timeout=WAIT_S,
                                priority="critical")
            assert ei.value.retry_after_s == pytest.approx(
                svc.config.brownout_clear_s)
            with pytest.raises(QueueFullError):
                gold.evaluate("edge-a", xs, timeout=WAIT_S,
                              priority="batch")
            assert gold.evaluate("edge-a", xs,
                                 timeout=WAIT_S).shape == (1, 8, LAM)
        svc.queue.set_brownout(False)
        with EdgeClient(host, port, n_bytes=NB, tenant="nobody") as c:
            with pytest.raises(ValueError, match="unknown tenant"):
                c.evaluate("edge-a", xs, timeout=WAIT_S)
            # a request-level refusal: the connection still answers
            assert c.ping(timeout=WAIT_S)
        snap = svc.metrics_snapshot()
        assert snap["edge_tenant_refusals_total{tenant=capped}"] == 1
        assert snap["edge_tenant_refusals_total{tenant=bronze}"] == 0
        assert snap["edge_tenant_requests_total{tenant=silver}"] == 1
    finally:
        srv.close()
        svc.close()


def test_open_edge_honors_explicit_class_and_shape_refusal(bundles, rng):
    """Without a tenant table the frame's class reaches the service
    verbatim (a router's forwarded CRITICAL stays CRITICAL), and a
    point width other than the service's is refused ``ShapeError``."""
    from dcf_tpu_torch.serve import Priority

    svc = service(PORT, bundles)
    seen = []
    real = svc.submit_bytes

    def spying(key_id, data, b=0, deadline_ms=None,
               priority=Priority.NORMAL):
        seen.append(priority)
        return real(key_id, data, b=b, deadline_ms=deadline_ms,
                    priority=priority)

    svc.submit_bytes = spying
    srv = EdgeServer(svc).start()
    try:
        xs = points(rng, 2)
        with EdgeClient(*srv.address, n_bytes=NB) as c:
            for pri in ("critical", None, "batch"):
                c.evaluate("edge-a", xs, priority=pri, timeout=WAIT_S)
        assert seen == [Priority.CRITICAL, Priority.NORMAL,
                        Priority.BATCH]
        with EdgeClient(*srv.address, n_bytes=NB + 1) as c:
            with pytest.raises(ShapeError):
                c.evaluate("edge-a", np.zeros((2, NB + 1), np.uint8),
                           timeout=WAIT_S)
    finally:
        srv.close()
        svc.close()


# ------------------------------------------------------------ wire fuzz


def _request_frame(key_id, xs) -> bytes:
    return pedge.encode_request(7, "", key_id, 0, 255, None,
                                np.ascontiguousarray(xs).data, NB,
                                xs.shape[0])


def test_byte_flips_die_typed_on_one_connection(bundles, rng):
    """Seeded byte flips of a valid REQUEST: every mutation ends as an
    ERROR frame and/or a closed connection, never a SHARE; a healthy
    connection keeps serving throughout."""
    svc = service(PORT, bundles)
    srv = EdgeServer(svc).start()
    xs = points(rng, 5)
    frame = _request_frame("edge-a", xs)
    try:
        with EdgeClient(*srv.address, n_bytes=NB) as healthy:
            for off, xor in zip(rng.integers(0, len(frame), 24),
                                rng.integers(1, 256, 24)):
                frames = raw_exchange(
                    srv.address, faults.corrupt(frame, int(off), int(xor)),
                    pedge.decode_response)
                assert all(f[0] == "error" for f in frames), (off, xor)
                assert np.array_equal(
                    healthy.evaluate("edge-a", xs, b=0, timeout=WAIT_S),
                    oracle(bundles["edge-a"], 0, xs))
    finally:
        srv.close()
        svc.close()


def test_truncations_and_oversized_prefix_die_typed(bundles, rng):
    svc = service(PORT, bundles)
    srv = EdgeServer(svc, max_frame_bytes=1 << 16).start()
    xs = points(rng, 5)
    frame = _request_frame("edge-a", xs)
    try:
        for cut in sorted({int(c) for c in rng.integers(1, len(frame), 8)}):
            frames = raw_exchange(srv.address, frame[:cut],
                                  pedge.decode_response)
            assert all(f[0] == "error" for f in frames)
        wire_before = svc.metrics_snapshot()["edge_wire_errors_total"]
        frames = raw_exchange(srv.address, struct.pack("<I", 1 << 20),
                              pedge.decode_response)
        assert len(frames) == 1
        kind, _, code, _, msg = frames[0]
        assert (kind, code) == ("error", pedge.E_WIRE)
        assert "length prefix" in msg
        wait_for(lambda: svc.metrics_snapshot()[
            "edge_wire_errors_total"] > wire_before, "the wire error")
        with EdgeClient(*srv.address, n_bytes=NB) as c:
            assert c.evaluate("edge-a", xs, timeout=WAIT_S).shape == \
                (1, 5, LAM)
    finally:
        srv.close()
        svc.close()


def test_edge_read_and_accept_seams(bundles, rng):
    """An armed ``edge.read`` ends exactly the connection whose read
    fired (typed at its client); an armed ``edge.accept`` is counted
    and the loop keeps accepting."""
    svc = service(PORT, bundles)
    srv = EdgeServer(svc).start()
    xs = points(rng, 4)
    try:
        host, port = srv.address
        a = EdgeClient(host, port, n_bytes=NB)
        b = EdgeClient(host, port, n_bytes=NB)
        for c in (a, b):
            assert c.evaluate("edge-a", xs, timeout=WAIT_S).shape == \
                (1, 4, LAM)
        with faults.inject_schedule("edge.read", window_evals=1):
            with pytest.raises(DcfError):
                a.evaluate("edge-a", xs, timeout=WAIT_S)
        assert b.evaluate("edge-a", xs, timeout=WAIT_S).shape == \
            (1, 4, LAM)
        a.close()
        b.close()
        with faults.inject_schedule("edge.accept",
                                    window_evals=1) as sched:
            for _ in range(2):
                with EdgeClient(host, port, n_bytes=NB) as c:
                    assert c.evaluate("edge-a", xs, timeout=WAIT_S
                                      ).shape == (1, 4, LAM)
            assert sched.failed == 1
        assert svc.metrics_snapshot()["edge_accept_errors_total"] >= 1
        assert svc.metrics_snapshot()["edge_connection_errors_total"] >= 1
    finally:
        srv.close()
        svc.close()


def test_read_timeout_bounds_slow_loris(bundles, rng):
    """``read_timeout_s``: a peer stalling mid-frame costs at most the
    bound before its connection dies counted; a healthy one serves."""
    svc = service(PORT, bundles)
    srv = EdgeServer(svc, read_timeout_s=0.2).start()
    xs = points(rng, 4)
    try:
        loris = socket.create_connection(srv.address, timeout=WAIT_S)
        loris.sendall(_request_frame("edge-a", xs)[:9])
        wait_for(lambda: svc.metrics_snapshot()[
            "edge_connection_errors_total"] >= 1, "the stalled reader")
        loris.close()
        with EdgeClient(*srv.address, n_bytes=NB) as c:
            assert c.evaluate("edge-a", xs, timeout=WAIT_S).shape == \
                (1, 4, LAM)
    finally:
        srv.close()
        svc.close()


# ------------------------------------------- load block, epoch fence


@pytest.mark.parametrize("server", ["port", "dcf_tpu"])
def test_pong_load_block_carries_load_report(server, bundles, rng):
    """``ping_load`` asks for the responder's ``LoadSample``: the port
    client reads the same numbers the service's ``load_report`` gives,
    from either package's server."""
    pkg = PKGS[server]
    svc = service(pkg, bundles, start=False, max_queued_points=1000)
    for _ in range(3):
        svc.submit("edge-a", points(rng, 5))
    srv = pkg.edge.EdgeServer(svc).start()
    try:
        with EdgeClient(*srv.address, n_bytes=NB) as c:
            epoch, load = c.ping_load(timeout=WAIT_S)
        assert epoch == 0
        assert tuple(load) == tuple(svc.load_report())
        assert (load.queue_points, load.queue_limit,
                load.brownout) == (15, 1000, False)
    finally:
        srv.close()
        svc.close(drain=False)


def test_ring_epoch_fence_in_process_and_on_the_wire(bundles, rng):
    """A fenced PING adopts a newer epoch; an older one is refused
    ``RingEpochError`` in process and ``E_EPOCH`` on the wire (PING,
    REQUEST and REGISTER), counted; epoch 0 is unfenced; an unadmitted
    request cannot teach the shard an epoch."""
    svc = service(PORT, bundles, tenants=(TenantSpec("t", "normal"),))
    srv = EdgeServer(svc).start()
    xs = points(rng, 3)
    try:
        assert svc.ring_epoch == 0 and svc.check_ring_epoch(0) == 0
        with EdgeClient(*srv.address, n_bytes=NB, tenant="t") as c:
            assert c.ping(timeout=WAIT_S, epoch=5)
            assert svc.ring_epoch == 5
            with pytest.raises(RingEpochError) as ei:
                c.ping(timeout=WAIT_S, epoch=3)
            assert ei.value.wire_code == pedge.E_EPOCH
            assert ei.value.retry_after_s is not None
            with pytest.raises(RingEpochError):
                c.submit_bytes("edge-a", xs.data, b=0,
                               epoch=4).result(WAIT_S)
            with pytest.raises(RingEpochError):
                c.register_frame("k2", bundles["edge-b"].to_bytes(),
                                 timeout=WAIT_S, epoch=2)
            y = c.submit_bytes("edge-a", xs.data, b=0,
                               epoch=5).result(WAIT_S)
            assert np.array_equal(y, oracle(bundles["edge-a"], 0, xs))
            assert c.ping(timeout=WAIT_S)  # epoch 0: unfenced
        with EdgeClient(*srv.address, n_bytes=NB, tenant="x") as c:
            with pytest.raises(ValueError, match="unknown tenant"):
                c.submit_bytes("edge-a", xs.data, epoch=99).result(WAIT_S)
        assert svc.ring_epoch == 5
        with pytest.raises(RingEpochError):
            svc.check_ring_epoch(4)
        snap = svc.metrics_snapshot()
        assert snap["serve_ring_epoch"] == 5
        assert snap["serve_epoch_fenced_total"] == 4
    finally:
        srv.close()
        svc.close()


# ---------------------------------------------------- load generators


def test_open_loop_over_the_wire_reconciles_and_drains(bundles, rng):
    """Poisson arrivals through an ``EdgeClient``: every arrival lands
    in one bucket, ``sent`` / shed / expired reconcile against the
    service's metrics, and the draws follow ``dcf_tpu``'s schedule
    (the same seed offers the same attempts to an in-process target)."""
    svc = service(PORT, bundles, max_delay_ms=0.5)
    srv = EdgeServer(svc).start()
    try:
        base = svc.metrics_snapshot()
        with EdgeClient(*srv.address, n_bytes=NB) as c:
            res = open_loop(c, ["edge-a", "edge-b"], rate_rps=200.0,
                            duration_s=0.5, min_points=1, max_points=8,
                            seed=11, deadline_ms=5000.0)
        snap = svc.metrics_snapshot()
        rec = reconcile_against_rollup(res, base, snap)
        assert rec["reconciled"], rec
        assert res.attempts == res.shed + res.ok + res.expired + res.failed
        assert res.ok > 0 and res.failed == 0
        assert set(res.latency_quantiles()) == {"p50_s", "p90_s", "p99_s"}
    finally:
        srv.close()
        svc.close()
    with pytest.raises(ValueError, match="rate_rps"):
        open_loop(None, ["k"], rate_rps=0, duration_s=1, min_points=1,
                  max_points=2)
    with pytest.raises(ValueError, match="request-size"):
        open_loop(None, ["k"], rate_rps=1, duration_s=1, min_points=3,
                  max_points=2)

    class Counting:
        n_bytes = NB

        def __init__(self):
            self.sizes = []

        def submit(self, key_id, xs, b=0, deadline_ms=None, priority=None):
            self.sizes.append((key_id, xs.shape[0], xs.tobytes()))
            raise QueueFullError("shed", retry_after_s=0.1)

    a, b = Counting(), Counting()
    ra = open_loop(a, ["x", "y"], rate_rps=400.0, duration_s=0.2,
                   min_points=1, max_points=9, seed=3)
    j_open_loop(b, ["x", "y"], rate_rps=400.0, duration_s=0.2,
                min_points=1, max_points=9, seed=3)
    n = min(len(a.sizes), len(b.sizes))
    assert n > 10 and a.sizes[:n] == b.sizes[:n]
    assert ra.shed == ra.shed_hinted == len(a.sizes)


def test_closed_loop_one_edge_client_per_thread(bundles, rng):
    """``closed_loop(clients=)``: each thread drives its own TCP
    connection; nothing fails and the sheds reconcile."""
    svc = service(PORT, bundles)
    srv = EdgeServer(svc).start()
    clients = [EdgeClient(*srv.address, n_bytes=NB) for _ in range(3)]
    try:
        base = svc.metrics_snapshot()
        res = closed_loop(svc, ["edge-a", "edge-b"], duration_s=0.4,
                          concurrency=3, min_points=1, max_points=16,
                          seed=5, clients=clients)
        rec = reconcile_against_rollup(res, base, svc.metrics_snapshot())
        assert rec["reconciled"] and res.requests_failed == 0
        assert res.requests_ok > 0
        # The writer counts a response after its send returns, so the
        # client may read the last one before it is counted: wait for it.
        wait_for(lambda: svc.metrics_snapshot()["edge_responses_total"]
                 >= res.requests_ok, "every response counted")
        snap = svc.metrics_snapshot()
        assert snap["edge_connections_total"] == 3
        assert snap["edge_responses_total"] >= res.requests_ok
        with pytest.raises(ValueError, match="one target per thread"):
            closed_loop(svc, ["edge-a"], duration_s=0.1, concurrency=2,
                        min_points=1, max_points=2, clients=clients)
    finally:
        for c in clients:
            c.close()
        srv.close()
        svc.close()


# ------------------------------------------------- the pinned snapshot


def _scripted_edge_snapshot(pkg, bundles, rng_seed) -> dict:
    """One deterministic edge sequence on a ``FakeClock``: served,
    rate-limited, unknown-tenant, wrong-width and fenced requests, a
    load probe, a registration and a digest; the service pumped by
    hand.  Returns the service's snapshot after the edge closed."""
    rng = np.random.default_rng(rng_seed)
    clk = pkg.faults.FakeClock(100.0)
    tenants = (pkg.serve.TenantSpec("gold", "critical"),
               pkg.serve.TenantSpec("bronze", "batch", points_per_sec=64.0,
                                    burst_points=16))
    svc = pkg.serve.DcfService(
        Dcf(NB, LAM, CK, backend="numpy", device="cpu")
        if pkg is PORT else REF.dcf(),
        pkg.serve.ServeConfig(max_batch=32, max_delay_ms=1.0,
                              tenants=tenants), clock=clk)
    for name in ("edge-a", "edge-b"):
        svc.register_key(name, pkg.bundle(bundles[name]))
    srv = pkg.edge.EdgeServer(svc).start()
    addr = srv.address
    gold = EdgeClient(*addr, n_bytes=NB, tenant="gold")
    bronze = EdgeClient(*addr, n_bytes=NB, tenant="bronze")

    def served(client, key, m, b):
        xs = rng.integers(0, 256, (m, NB), dtype=np.uint8)
        before = svc.metrics.counter("serve_requests_total").value
        fut = client.submit(key, xs, b=b)
        wait_for(lambda: svc.metrics.counter(
            "serve_requests_total").value > before, "the queued request")
        svc.pump()
        assert np.array_equal(fut.result(WAIT_S),
                              oracle(bundles[key], b, xs))

    served(gold, "edge-a", 8, 0)
    served(bronze, "edge-b", 16, 1)
    with pytest.raises(QueueFullError):
        bronze.evaluate("edge-b", rng.integers(0, 256, (4, NB), np.uint8),
                        timeout=WAIT_S)
    with EdgeClient(*addr, n_bytes=NB, tenant="nobody") as c:
        with pytest.raises(ValueError):
            c.evaluate("edge-a", np.zeros((2, NB), np.uint8),
                       timeout=WAIT_S)
    with EdgeClient(*addr, n_bytes=NB + 1, tenant="gold") as c:
        with pytest.raises(ShapeError):
            c.evaluate("edge-a", np.zeros((2, NB + 1), np.uint8),
                       timeout=WAIT_S)
    assert gold.ping(timeout=WAIT_S, epoch=3)
    with pytest.raises(RingEpochError):
        gold.ping(timeout=WAIT_S, epoch=2)
    gold.ping_load(timeout=WAIT_S)
    gen = gold.register_frame("edge-c", bundles["edge-add"].to_bytes(),
                              timeout=WAIT_S)
    assert gold.pull_digest(timeout=WAIT_S)["edge-c"] == gen
    served(gold, "edge-a", 3, 1)
    gold.close()
    bronze.close()
    srv.close()
    return svc.metrics_snapshot()


def test_edge_metrics_snapshot_equal_to_dcf_tpu_key_for_key(bundles):
    """The same scripted edge sequence on both packages' ``numpy``
    facades: the two ``metrics_snapshot()``s are equal key for key."""
    snap_p = _scripted_edge_snapshot(PORT, bundles, 31)
    snap_j = _scripted_edge_snapshot(REF, bundles, 31)
    assert sorted(snap_p) == sorted(snap_j)
    diff = {k: (snap_p[k], snap_j[k]) for k in snap_p
            if snap_p[k] != snap_j[k]}
    assert diff == {}
    assert snap_p["edge_tenant_refusals_total{tenant=bronze}"] == 1
    assert snap_p["edge_control_frames_total"] == 5
