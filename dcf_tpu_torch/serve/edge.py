"""Network edge: a zero-copy DCFE wire path for the serving tier.

Counterpart of ``dcf_tpu/serve/edge.py``: the same frames byte for
byte, the same wire codes, metric names and typed errors, so a client
of either package talks to a server of the other
(``tests/test_torch_edge.py``).  The evaluation behind it is the
port's ``DcfService`` on the card.

This module is the dependency-light TCP front: a length-prefixed binary protocol (stdlib
``socket`` + ``threading`` only — the container bakes nothing else)
that carries DCFE-framed evaluation requests end to end, with the
ingest path going buffer-protocol straight into the batcher's staged
layout:

    socket ──recv_into──► per-frame bytearray ──memoryview──►
    batcher.ingest_points ──► Request.xs (a VIEW, no copy) ──►
    gather_batch ──► the padded pow-2 device batch

Zero per-point Python objects exist anywhere on that path: the one
host copy is the socket read into the frame buffer, the next is the
span gather into the padded batch (which the in-process path pays
too).  Responses are serialized straight from the fetched result
planes — the uint8 [K, M, lam] array's own buffer is handed to
``sendmsg`` behind an incremental CRC, never an intermediate
list-of-ints.

Wire format (all integers little-endian; every frame is a ``u32``
body-length envelope followed by the body)::

    0   4   magic  b"DCFE"
    4   2   version (u16, currently 2 — v2 added the ring-epoch
            field to REQUEST/PING/REGISTER; both ends of every
            link in this repo speak v2, v1 is refused typed)
    6   1   type    (u8: 1=REQUEST  2=SHARE  3=ERROR)

    REQUEST body (type 1):
    7   8   req_id      u64  client-chosen; responses echo it
    15  1   party       u8   0 or 1
    16  1   priority    u8   0/1/2 = CRITICAL/NORMAL/BATCH,
                             255 = the tenant's class (the default)
    17  8   deadline_ms f64  <= 0 = none (relative, like ``submit``)
    25  4   m           u32  points in this request
    29  2   n_bytes     u16  bytes per point (must match the service)
    31  1   tenant_len  u8
    32  1   key_len     u8
    33  4   epoch       u32  ring epoch the sender routed on (0 = un-
                             fenced: direct clients, solo services)
    37      tenant      utf-8 [tenant_len]
    ..      key_id      utf-8 [key_len]
    ..      xs payload  raw packed points, m * n_bytes
    end-4   crc32       u32 of ALL prior body bytes (zlib.crc32)

    SHARE body (type 2):
    7   8   req_id  u64
    15  2   k       u16  output rows (K keys, or m intervals)
    17  4   m       u32
    21  2   lam     u16
    23      share bytes  k * m * lam (C order)
    end-4   crc32   u32 of all prior body bytes

    ERROR body (type 3):
    7   8   req_id        u64  0 = connection-level (not a request)
    15  2   code          u16  see WIRE_CODES
    17  8   retry_after_s f64  < 0 = no hint
    25  2   msg_len       u16
    27      message       utf-8
    end-4   crc32         u32 of all prior body bytes

Decoding is strict, DCFK-style: bounds-checked field by field, exact
total size, CRC verified — any violation is ``KeyFormatError`` naming
the field.  A FRAMING violation (bad magic/length/CRC) additionally
closes the connection: after it the byte stream cannot be trusted to
re-synchronize.  Request-level refusals (unknown key, shed load, rate
limit) keep the connection — framing was intact.

Tenancy (the tenant table lives in ``ServeConfig.tenants``, a tuple of
``serve.TenantSpec`` — it maps tenants onto the EXISTING CRITICAL/
NORMAL/BATCH classes, never a second policy): a request's effective
class is its tenant's class, demotable per request but never
promotable above it.  Per-tenant admission is a points-per-second
token bucket on the injectable clock, applied BEFORE the shared queue:
a refusal costs the shared service nothing and carries the exact
time-to-refill as its ``retry_after_s``.  An empty table (the
default) admits every tenant unlimited, defaulting to NORMAL but
honoring a frame's EXPLICIT class verbatim — the open edge is "no
policy", which is what lets a pod router forward its already-admitted
effective class to a shard without the shard re-clamping it; a
configured table refuses unknown tenants typed and enforces
the never-promote cap.

Refusals and failures cross the wire as typed ERROR frames: the code
maps back to the ``dcf_tpu_torch.errors`` class on the client
(``EdgeClient`` re-raises the real ``QueueFullError`` /
``CircuitOpenError`` / ``DeadlineExceededError`` ... with
``retry_after_s`` attached), so a remote caller sees exactly the typed
taxonomy an in-process caller sees.

Failure injection: the ``edge.accept`` / ``edge.read`` seams
(``dcf_tpu_torch.testing.faults``) fire before each accept and each
connection recv — a raising read handler kills ONE connection typed
(the accept loop and every other tenant's connection survive), and
``faults.latency`` armed at ``edge.read`` is the slow-client seam:
each blocking read advances the injectable clock, so a stalled sender
trips the existing deadline/watchdog path instead of wedging the
worker.

TLS: ``ServeConfig.tls_cert``/``tls_key`` (or
the same ``EdgeServer`` kwargs) wrap every accepted connection in
stdlib ``ssl``; ``tls_client_ca`` PINS clients — only peers
presenting a cert signed by that CA complete the handshake (the
router<->shard link hardening).  The handshake is deferred to the
reader thread, so a plaintext or unpinned peer is a counted
per-connection failure, never a wedged accept loop.  ``EdgeClient``
takes ``tls=/tls_ca=/tls_cert=/tls_key=``; ``EdgeClientPool`` (the
reusable reconnect-with-backoff transport the pod router forwards
through) passes them along.

Control frames (the pod self-healing tier): beside REQUEST/
SHARE/ERROR the protocol carries four lightweight control verbs —

* **PING** (type 4) / **PONG** (type 5): the health prober's liveness
  round trip.  Answered straight off the reader thread, admission-free
  by design: a shard in brownout is ALIVE (it is shedding load on
  purpose), and refusing pings there would make the router mark it
  DOWN and promote replicas against a host that is serving CRITICAL
  traffic fine.  PONG doubles as the generic ack (its ``value`` field
  carries the registration generation for REGISTER).

  Load piggyback (``load_report``): a PING may append a
  one-byte flags field with bit 0 set (``want_load``), asking the
  responder to append a fixed ``LoadSample`` block to its PONG —
  queue points vs bound, the brownout latch, and the cumulative
  shed / tenant-refusal / key-factory-pool-miss counters, the demand
  signals ``dcf_tpu``'s capacity controller aggregates (the port's
  health prober keeps the freshest sample per shard).  Both extensions are
  version-gated by SIZE: a load-free v2 PING/PONG keeps its exact
  legacy length and parses unchanged (old shards keep probing clean),
  and a responder without a load surface simply answers with the base
  PONG — the sampler reads "no sample", never an error.
* **REGISTER** (type 6): a DCFK frame forwarded by reference —
  ``(key_id, generation, proto flag, frame bytes)``.  ``generation=0``
  asks the receiver to MINT one (the owner-side registration);
  ``generation>0`` is the replica/anti-entropy spelling: apply with
  the owner's generation preserved, fenced by the monotonic-generation
  guard (a frame at or below the local generation dies typed
  ``StaleStateError`` / ``E_STALE`` — an old partition side is
  structurally unable to roll a key back).  Not tenant-gated:
  registration is an operator/router action authenticated by the TLS
  client-pinning story, not the evaluation admission table.
* **DIGEST** (type 7) / **SYNC** (type 8): the anti-entropy exchange.
  Mode 1 asks for the peer's ``{key_id: generation}`` digest (SYNC
  entries with zero-length frames); mode 0 carries the caller's digest
  and the SYNC response returns only frames whose generation is
  STRICTLY newer — the pull half of partition healing
  (``serve.replicate``).

Epoch fencing: every ring-membership change is committed under a
monotonic **ring epoch** (``DcfRouter.set_ring(..., epoch=)``).
Forwarded REQUEST and REGISTER frames (and the health prober's PINGs)
carry the sender's epoch; a shard tracks the
highest epoch it has seen (``DcfService.check_ring_epoch`` — adoption
is monotonic-max, the same first-writer discipline the generation
fence uses) and REFUSES any fenced frame carrying an older one, typed
``RingEpochError`` / ``E_EPOCH`` with a retry hint.  A router still
routing on a pre-change ring is therefore *structurally* unable to
double-serve a key against a conflicting placement — the
generation fence's discipline lifted from keys to membership.  Epoch 0
means unfenced (direct clients, solo deployments): the check is
skipped, exactly as generation 0 means "mint here" on REGISTER.
Epoch adoption, like REGISTER itself, is an operator/router action
authenticated by the TLS client-pinning story, not the tenant table.

Partition seam: a client constructed with ``tags=(local,
peer)`` fires ``net.partition`` before each dial and each frame send
(``testing.faults.partition`` is the canonical handler — it raises
``OSError`` for cut pairs, which the client contains as transport
death), so the pod soaks can cut and heal router<->shard links
deterministically.  Untagged clients never fire it.

Clocking: admission math (buckets, deadlines) uses the service's
injectable clock, never ``time.*`` (dcflint determinism).  Server-side
socket reads BLOCK by default — the right behavior for trusted/idle
keep-alive peers; against hostile ones, ``EdgeServer(read_timeout_s=N)``
bounds every recv (wall-clock by nature, like any socket timeout), so
a slow-loris peer holding a half-sent frame costs at most N seconds of
one reader thread before its connection dies typed and counted.  The
per-connection response backlog is bounded either way
(``_Conn.MAX_PENDING_RESPONSES``), and a frame buffer is at most
``max_frame_bytes``.
"""

from __future__ import annotations

import queue
import select
import socket
import ssl
import struct
import threading
import zlib
from collections import namedtuple

import numpy as np

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    BatchTimeoutError,
    CircuitOpenError,
    DcfError,
    DeadlineExceededError,
    KeyFormatError,
    KeyQuarantinedError,
    LockOrderError,
    MeshUnavailableError,
    NativeBuildError,
    QueueFullError,
    RingEpochError,
    ShapeError,
    StaleStateError,
    StandbyExhaustedError,
)
from dcf_tpu_torch.serve.admission import (
    Priority,
    ServeFuture,
    TenantSpec,
    parse_priority,
)
from dcf_tpu_torch.serve.metrics import Metrics, labeled
from dcf_tpu_torch.testing.faults import fire
from dcf_tpu_torch.utils.benchtime import monotonic

__all__ = ["EdgeServer", "EdgeClient", "EdgeClientPool", "TokenBucket",
           "LoadSample", "WIRE_CODES", "MAGIC", "VERSION", "T_REQUEST",
           "T_SHARE", "T_ERROR", "T_PING", "T_PONG", "T_REGISTER",
           "T_DIGEST", "T_SYNC", "encode_request", "encode_error",
           "encode_ping", "encode_pong", "encode_register",
           "encode_digest", "encode_sync"]

MAGIC = b"DCFE"
VERSION = 2  # v2: REQUEST/PING/REGISTER carry a ring epoch

T_REQUEST = 1
T_SHARE = 2
T_ERROR = 3
T_PING = 4      # liveness probe (the health prober's frame)
T_PONG = 5      # ping/register ack; ``value`` carries the generation
T_REGISTER = 6  # DCFK frame forwarding (mint / fenced replica apply)
T_DIGEST = 7    # anti-entropy digest exchange request
T_SYNC = 8      # anti-entropy response: strictly-newer frames

_PREFIX = struct.Struct("<I")        # the length envelope
_FRAME_HEAD = struct.Struct("<HB")   # version, type (after the magic)
_BODY_MIN = 4 + _FRAME_HEAD.size     # magic + version + type
_REQ_HEAD = struct.Struct("<QBBdIHBBI")  # ..., tenant_len, key_len, epoch
_RES_HEAD = struct.Struct("<QHIH")
_ERR_HEAD = struct.Struct("<QHdH")
_PING_HEAD = struct.Struct("<QI")    # req_id, ring epoch (0 = unfenced)
_PING_FLAGS = struct.Struct("<B")    # optional: bit 0 = want_load
_PONG_HEAD = struct.Struct("<QQ")    # req_id, value
_PONG_LOAD = struct.Struct("<QQBQQQ")  # optional LoadSample block:
#   queue_points, queue_limit, brownout (u8 bool), shed_total,
#   refusals_total, pool_misses — appended only when the PING asked
#   (want_load) AND the responder has a load surface; version-gated
#   by size, so a load-free v2 PONG parses unchanged

# One shard's demand signals, sampled off a PING/PONG round trip
# (``DcfService.load_report``; the health prober keeps the freshest
# per shard).  Counters are CUMULATIVE (a reader differences
# consecutive samples);
# ``queue_limit`` is the shard's configured queue-points bound, so
# ``queue_points / queue_limit`` is its queue fraction.
LoadSample = namedtuple("LoadSample", [
    "queue_points", "queue_limit", "brownout", "shed_total",
    "refusals_total", "pool_misses"])
_REG_HEAD = struct.Struct("<QQIBB")  # req_id, generation, epoch, proto,
#                                      key_len
_DIG_HEAD = struct.Struct("<QBI")    # req_id, mode, entry count
_DIG_ENTRY = struct.Struct("<QB")    # generation, key_len
_SYNC_HEAD = struct.Struct("<QI")    # req_id, entry count
_SYNC_ENTRY = struct.Struct("<QBBI")  # generation, proto, key_len, frame_len
_CRC = struct.Struct("<I")
_PRI_DEFAULT = 255  # "the tenant's class" priority byte

# Typed wire error codes <-> the dcf_tpu_torch.errors taxonomy.  The server
# serializes the code for the exception it caught; the client
# re-raises the mapped class (retry_after_s re-attached where the
# class carries one).  E_RATE_LIMITED is a QueueFullError flavor —
# the refusal happened at the tenant bucket, before the shared queue.
E_INTERNAL = 1
E_WIRE = 2
E_SHAPE = 3
E_BAD_REQUEST = 4
E_QUEUE_FULL = 5
E_RATE_LIMITED = 6
E_DEADLINE = 7
E_CIRCUIT_OPEN = 8
E_UNAVAILABLE = 9
E_UNKNOWN_TENANT = 10
E_TIMEOUT = 11
E_EVICTED = 12  # QueueFullError's post-ACCEPTANCE spelling: the
#                 request was admitted (and counted) before a
#                 higher-priority submit took its room — load
#                 accounting must not retract a "sent" for it
E_STALE = 13  # StaleStateError's own code: a hot-swap
#               racing a forwarded eval is a KEY-level race the caller
#               resolves by retrying the same target — the router must
#               be able to tell it from E_UNAVAILABLE, which is a
#               backend-down signal it treats as failover pressure
E_EPOCH = 14  # RingEpochError: the SENDER's ring is stale —
#               a membership change committed a newer epoch than the
#               one this frame carries.  Neither a shard-health signal
#               (the shard is fine) nor a key-level outcome: the
#               sender must refresh its ring before retrying
E_MESH_UNAVAILABLE = 15  # MeshUnavailableError: the pod's
#               device-mesh co-evaluation tier cannot take the batch
#               (worker down, group epoch fenced, no group) while the
#               caller FORCED co-evaluation.  Distinct from
#               E_UNAVAILABLE: route-mode still serves — the caller's
#               recovery is "retry without forcing the mesh", not
#               "back off from a dead backend"

#: code -> exception class the client raises (see ``_raise_wire``).
WIRE_CODES = {
    E_INTERNAL: DcfError,
    E_WIRE: KeyFormatError,
    E_SHAPE: ShapeError,
    E_BAD_REQUEST: ValueError,
    E_QUEUE_FULL: QueueFullError,
    E_RATE_LIMITED: QueueFullError,
    E_DEADLINE: DeadlineExceededError,
    E_CIRCUIT_OPEN: CircuitOpenError,
    E_UNAVAILABLE: BackendUnavailableError,
    E_UNKNOWN_TENANT: ValueError,
    E_TIMEOUT: BatchTimeoutError,
    E_EVICTED: QueueFullError,
    E_STALE: StaleStateError,
    E_EPOCH: RingEpochError,
    E_MESH_UNAVAILABLE: MeshUnavailableError,
}

#: Taxonomy classes that DELIBERATELY cross the wire as ``E_INTERNAL``
#: (via the ``DcfError`` entry in ``_EXC_CODES``): build/disk/test-
#: harness faults that no remote caller can act on distinctly, so a
#: dedicated code would be dead protocol surface.  The wire-taxonomy-
#: sync dcflint pass enforces that every ``dcf_tpu_torch.errors`` class is
#: either wire-coded or declared here — a NEW typed error cannot ship
#: with its wire behavior undecided.
WIRE_INTERNAL_ONLY = frozenset({
    NativeBuildError,       # build/load fault: host-local, operator-fixed
    KeyQuarantinedError,    # disk-frame fault: surfaces via store reports
    StandbyExhaustedError,  # operator scale-out misuse: never request-path
    LockOrderError,         # test-harness detector: never constructed live
})

_EXC_CODES = (
    # Order matters: first match wins, subclasses before bases.
    (QueueFullError, E_QUEUE_FULL),
    (DeadlineExceededError, E_DEADLINE),
    (CircuitOpenError, E_CIRCUIT_OPEN),
    (BatchTimeoutError, E_TIMEOUT),
    (KeyFormatError, E_WIRE),
    (ShapeError, E_SHAPE),
    (RingEpochError, E_EPOCH),
    (StaleStateError, E_STALE),
    (MeshUnavailableError, E_MESH_UNAVAILABLE),
    (BackendUnavailableError, E_UNAVAILABLE),
    (DcfError, E_INTERNAL),
    (ValueError, E_BAD_REQUEST),
)


def _code_for(exc: BaseException) -> int:
    if isinstance(exc, QueueFullError) and getattr(exc, "evicted",
                                                   False):
        return E_EVICTED
    for cls, code in _EXC_CODES:
        if isinstance(exc, cls):
            return code
    return E_INTERNAL


class _Disconnect(DcfError, ConnectionError):
    """A peer vanished mid-frame (EOF inside an envelope or body) —
    a per-connection event, typed so the containment handlers can
    tell it from a framing violation."""


class _TlsDuplex:
    """A TLS socket shared by a reader and a writer thread, with at
    most ONE OpenSSL call in flight on it.

    An OpenSSL connection object is not safe for concurrent use, and
    both ends of an edge link read on one thread while another writes.
    Under TLS 1.3 the server's NewSessionTicket messages reach the
    client after the handshake; the client's reader processes them
    inside its blocking read while the submitting thread writes a
    request on the same object, and under CPU load the two interleave
    so that the request never reaches the server (the server's reader
    waits for a frame, the service sits idle, the caller's
    ``result(timeout)`` expires).  Here the socket is non-blocking,
    every SSL call runs under one lock, and the waits for readiness
    (``select``) run outside it, so a blocked read never holds up a
    write.  ``timeout_s`` bounds each wait like a socket timeout (None
    = block), raising ``TimeoutError`` (an ``OSError``)."""

    __slots__ = ("_sock", "_lock", "_timeout")

    def __init__(self, sock: ssl.SSLSocket, timeout_s: float | None):
        sock.setblocking(False)
        self._sock = sock
        self._lock = threading.Lock()
        self._timeout = timeout_s

    def _wait(self, want_write: bool) -> None:
        fd = self._sock.fileno()
        if fd < 0:
            # dcflint: disable=typed-error a closed socket is transport
            # death, which the edge's readers and writers contain as
            # OSError exactly like a plain socket's
            raise OSError("TLS socket closed")
        poller = select.poll()
        poller.register(fd, select.POLLOUT if want_write
                        else select.POLLIN)
        if not poller.poll(None if self._timeout is None
                           else self._timeout * 1e3):
            # dcflint: disable=typed-error the socket-timeout contract:
            # TimeoutError is the OSError a timed-out plain recv raises
            raise TimeoutError(
                f"TLS socket not ready within {self._timeout} s")

    def recv_into(self, view, nbytes: int) -> int:
        while True:
            with self._lock:
                try:
                    # dcflint: disable=blocking-under-lock the socket is
                    # non-blocking: the call returns or raises SSLWant*
                    return self._sock.recv_into(view, nbytes)
                except ssl.SSLWantReadError:
                    want_write = False
                except ssl.SSLWantWriteError:
                    want_write = True
            self._wait(want_write)

    def sendall(self, data) -> None:
        view = memoryview(data).cast("B")
        while view.nbytes:
            with self._lock:
                try:
                    # dcflint: disable=blocking-under-lock non-blocking,
                    # as in recv_into; the waits run outside the lock
                    view = view[self._sock.send(view):]
                    continue
                except ssl.SSLWantWriteError:
                    want_write = True
                except ssl.SSLWantReadError:
                    want_write = False
            self._wait(want_write)


def _sendmsg_all(sock, parts: list) -> None:
    """``sendmsg`` with the ``sendall`` guarantee: a blocking TCP
    socket may still accept only part of a large gather write, so loop
    over the remainder without flattening the parts (the share payload
    is referenced by buffer the whole way — no intermediate copy
    unless the kernel short-writes).  ``sock`` is a plain socket or a
    ``_TlsDuplex``."""
    views = [memoryview(p).cast("B") if not isinstance(p, memoryview)
             else p.cast("B") for p in parts]
    if isinstance(sock, _TlsDuplex):
        # TLS has no scatter-gather send: join once and sendall.  The
        # copy is inherent to TLS anyway — every byte is re-encrypted
        # into the record layer — so the zero-copy claim is scoped to
        # the plaintext transport, and the TLS knob trades that copy
        # for the wire staying confidential.
        sock.sendall(b"".join(views))
        return
    total = sum(v.nbytes for v in views)
    sent = sock.sendmsg(views)
    while sent < total:
        total -= sent
        while sent:
            if sent >= views[0].nbytes:
                sent -= views[0].nbytes
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0
        sent = sock.sendmsg(views)


# ------------------------------------------------------------ codecs


def _frame(body_parts) -> bytes:
    """Envelope + body + CRC from byte pieces (one join, no
    re-serialization of the pieces themselves).  Pieces are flattened
    to byte views first — ``len()`` of a 2D memoryview counts rows,
    not bytes."""
    views = [memoryview(p).cast("B") for p in body_parts]
    crc = 0
    for v in views:
        crc = zlib.crc32(v, crc)
    body_len = sum(v.nbytes for v in views) + _CRC.size
    return b"".join([_PREFIX.pack(body_len), *views,
                     _CRC.pack(crc)])


def _request_parts(req_id: int, tenant: str, key_id: str, party: int,
                   priority: int, deadline_ms: float | None,
                   payload, n_bytes: int, m: int,
                   epoch: int = 0) -> list:
    """The ONE REQUEST-body encoding (validation included), as byte
    pieces with the payload referenced by buffer: ``encode_request``
    joins them into a frame; ``EdgeClient.submit_bytes`` hands them to
    the scatter-gather send.  Two encoders would drift.  ``epoch``
   : the ring epoch the sender routed on; 0 = unfenced."""
    tb = tenant.encode("utf-8")
    kb_name = key_id.encode("utf-8")
    if len(tb) > 255 or len(kb_name) > 255:
        raise ShapeError("tenant/key_id must encode to <= 255 bytes")
    if not 0 <= int(party) <= 255:
        # Validated here, not by struct.pack: submit_bytes relies on
        # encoding failures being raised BEFORE a future registers
        raise ShapeError(f"party byte must fit u8, got {party}")
    if epoch < 0:
        raise ShapeError(f"ring epoch must be >= 0, got {epoch}")
    head = MAGIC + _FRAME_HEAD.pack(VERSION, T_REQUEST) + _REQ_HEAD.pack(
        req_id, int(party), priority,
        -1.0 if deadline_ms is None else float(deadline_ms),
        m, n_bytes, len(tb), len(kb_name), int(epoch))
    return [head, tb, kb_name, memoryview(payload)]


def encode_request(req_id: int, tenant: str, key_id: str, party: int,
                   priority: int, deadline_ms: float | None,
                   payload, n_bytes: int, m: int,
                   epoch: int = 0) -> bytes:
    """One REQUEST frame (envelope included).  ``payload`` is any
    buffer-protocol object of ``m * n_bytes`` packed point bytes."""
    return _frame(_request_parts(req_id, tenant, key_id, party,
                                 priority, deadline_ms, payload,
                                 n_bytes, m, epoch))


def encode_share(req_id: int, y: np.ndarray) -> list[bytes]:
    """SHARE frame pieces for ``sendmsg``: the fetched uint8
    [k, m, lam] planes are referenced by buffer — no intermediate
    list-of-ints, no payload copy (the kernel gathers the pieces)."""
    k, m, lam = y.shape
    if y.dtype != np.uint8:
        raise ShapeError(f"share planes must be uint8, got {y.dtype}")
    view = memoryview(np.ascontiguousarray(y)).cast("B")
    head = MAGIC + _FRAME_HEAD.pack(VERSION, T_SHARE) + _RES_HEAD.pack(
        req_id, k, m, lam)
    crc = zlib.crc32(view, zlib.crc32(head))
    body_len = len(head) + view.nbytes + _CRC.size
    return [_PREFIX.pack(body_len), head, view, _CRC.pack(crc)]


def encode_error(req_id: int, code: int, message: str,
                 retry_after_s: float | None = None) -> bytes:
    mb = message.encode("utf-8")[:4096]
    head = MAGIC + _FRAME_HEAD.pack(VERSION, T_ERROR) + _ERR_HEAD.pack(
        req_id, code,
        -1.0 if retry_after_s is None else float(retry_after_s),
        len(mb))
    return _frame([head, mb])


def encode_ping(req_id: int, epoch: int = 0,
                want_load: bool = False) -> bytes:
    """One PING frame (the health prober's liveness probe).
    ``epoch``: the prober's ring epoch — probes DISSEMINATE
    membership epochs, so shards converge on a committed epoch within
    about one probe interval; 0 = unfenced liveness only.
    ``want_load``: ask the responder to append its
    ``LoadSample`` to the PONG — encoded as a trailing flags byte, so
    a load-free ping keeps the exact legacy frame size."""
    if epoch < 0:
        raise ShapeError(f"ring epoch must be >= 0, got {epoch}")
    head = MAGIC + _FRAME_HEAD.pack(VERSION, T_PING) + _PING_HEAD.pack(
        req_id, int(epoch))
    parts = [head]
    if want_load:
        parts.append(_PING_FLAGS.pack(1))
    return _frame(parts)


def encode_pong(req_id: int, value: int = 0, load=None) -> bytes:
    """PING/REGISTER ack; ``value`` echoes the registration generation
    (for REGISTER) or the receiver's current ring epoch (for PING).
    ``load``: a ``LoadSample`` (or 6-tuple) to
    append — only a PING that asked (``want_load``) gets one; None
    keeps the exact legacy frame size."""
    head = MAGIC + _FRAME_HEAD.pack(VERSION, T_PONG) + _PONG_HEAD.pack(
        req_id, value)
    parts = [head]
    if load is not None:
        qp, ql, bo, shed, refused, misses = load
        parts.append(_PONG_LOAD.pack(
            int(qp), int(ql), 1 if bo else 0, int(shed), int(refused),
            int(misses)))
    return _frame(parts)


def encode_register(req_id: int, key_id: str, frame, generation: int = 0,
                    proto: bool = False, epoch: int = 0) -> bytes:
    """One REGISTER frame: a DCFK v2/v3 frame forwarded by reference
    (``frame`` is any buffer-protocol object — the bundle bytes are
    never re-materialized here).  ``generation=0`` = mint at the
    receiver (the owner-side registration); ``generation>0`` = the
    fenced replica/anti-entropy apply, owner's generation preserved.
    ``epoch``: the sender's ring epoch; 0 = unfenced."""
    kb_name = key_id.encode("utf-8")
    if len(kb_name) > 255:
        raise ShapeError("key_id must encode to <= 255 bytes")
    if generation < 0:
        raise ShapeError(f"generation must be >= 0, got {generation}")
    if epoch < 0:
        raise ShapeError(f"ring epoch must be >= 0, got {epoch}")
    head = MAGIC + _FRAME_HEAD.pack(VERSION, T_REGISTER) + _REG_HEAD.pack(
        req_id, int(generation), int(epoch), int(bool(proto)),
        len(kb_name))
    return _frame([head, kb_name, memoryview(frame)])


def encode_digest(req_id: int, digest: dict, mode: int = 0) -> bytes:
    """One DIGEST frame carrying ``{key_id: generation}``.  ``mode=0``:
    "here is my digest, send me strictly-newer frames"; ``mode=1``:
    "report your digest" (the response's SYNC entries then carry
    zero-length frames).  Entries are emitted in sorted key order —
    deterministic bytes for a given digest."""
    if mode not in (0, 1):
        raise ShapeError(f"digest mode must be 0 or 1, got {mode}")
    parts = [MAGIC + _FRAME_HEAD.pack(VERSION, T_DIGEST)
             + _DIG_HEAD.pack(req_id, mode, len(digest))]
    for key_id in sorted(digest):
        kb_name = key_id.encode("utf-8")
        if len(kb_name) > 255:
            raise ShapeError("key_id must encode to <= 255 bytes")
        parts.append(_DIG_ENTRY.pack(int(digest[key_id]), len(kb_name)))
        parts.append(kb_name)
    return _frame(parts)


def encode_sync(req_id: int, entries) -> bytes:
    """One SYNC frame: ``entries`` is a list of ``(key_id, generation,
    proto, frame)`` tuples (``frame`` = DCFK bytes, or ``b""`` for a
    digest-only reply)."""
    entries = list(entries)
    parts = [MAGIC + _FRAME_HEAD.pack(VERSION, T_SYNC)
             + _SYNC_HEAD.pack(req_id, len(entries))]
    for key_id, generation, proto, frame in entries:
        kb_name = key_id.encode("utf-8")
        view = memoryview(frame).cast("B") if frame else memoryview(b"")
        if len(kb_name) > 255:
            raise ShapeError("key_id must encode to <= 255 bytes")
        parts.append(_SYNC_ENTRY.pack(int(generation), int(bool(proto)),
                                      len(kb_name), view.nbytes))
        parts.append(kb_name)
        if view.nbytes:
            parts.append(view)
    return _frame(parts)


def _check_body(body, claims: str) -> memoryview:
    """Shared strict-decode head: magic, version, CRC over the whole
    body — ``KeyFormatError`` naming the field, DCFK discipline."""
    view = memoryview(body)
    if view.nbytes < _BODY_MIN + _CRC.size:
        raise KeyFormatError(
            f"truncated frame: {view.nbytes} bytes cannot hold the "
            f"DCFE header and CRC ({claims})")
    if bytes(view[:4]) != MAGIC:
        raise KeyFormatError(
            f"bad magic: expected {MAGIC!r}, got {bytes(view[:4])!r} "
            "(not a DCFE frame)")
    version, _ = _FRAME_HEAD.unpack_from(view, 4)
    if version != VERSION:
        raise KeyFormatError(
            f"unsupported DCFE version {version} (this reader handles "
            f"{VERSION})")
    (crc_stored,) = _CRC.unpack_from(view, view.nbytes - _CRC.size)
    crc_actual = zlib.crc32(view[:view.nbytes - _CRC.size])
    if crc_stored != crc_actual:
        raise KeyFormatError(
            f"crc32 mismatch: trailer records {crc_stored:#010x}, frame "
            f"hashes to {crc_actual:#010x} — the wire bytes are corrupt")
    return view


def decode_request(body) -> dict:
    """Strict REQUEST decode.  Returns the header fields plus
    ``payload``: a zero-copy ``memoryview`` of the packed xs bytes
    inside ``body`` (the caller owns the buffer's lifetime)."""
    view = _check_body(body, "a request")
    _, ftype = _FRAME_HEAD.unpack_from(view, 4)
    if ftype != T_REQUEST:
        raise KeyFormatError(
            f"frame type {ftype} is not a request (server side only "
            "accepts type 1)")
    if view.nbytes < _BODY_MIN + _REQ_HEAD.size + _CRC.size:
        raise KeyFormatError(
            f"truncated frame: {view.nbytes} bytes cannot hold a "
            "request header")
    (req_id, party, priority, deadline_ms, m, n_bytes, tenant_len,
     key_len, epoch) = _REQ_HEAD.unpack_from(view, _BODY_MIN)
    off = _BODY_MIN + _REQ_HEAD.size
    end = view.nbytes - _CRC.size
    claims = f"m={m}, n_bytes={n_bytes}"
    for name, size in (("tenant", tenant_len), ("key_id", key_len),
                       ("xs payload", m * n_bytes)):
        if off + size > end:
            raise KeyFormatError(
                f"truncated frame: section {name!r} needs bytes "
                f"[{off}, {off + size}) but the payload ends at {end} "
                f"(header claims {claims})")
        off += size
    if off != end:
        raise KeyFormatError(
            f"oversized frame: {end - off} trailing bytes after the xs "
            "payload (corrupt header or concatenated frames)")
    off = _BODY_MIN + _REQ_HEAD.size
    tenant = bytes(view[off:off + tenant_len]).decode("utf-8",
                                                      "replace")
    off += tenant_len
    key_id = bytes(view[off:off + key_len]).decode("utf-8", "replace")
    off += key_len
    return {
        "req_id": req_id, "tenant": tenant, "key_id": key_id,
        "party": party, "priority": priority,
        "deadline_ms": deadline_ms if deadline_ms > 0 else None,
        "m": m, "n_bytes": n_bytes, "epoch": epoch,
        "payload": view[off:end],
    }


def decode_ping(body) -> tuple:
    """Strict PING decode -> ``(req_id, epoch, want_load)`` (epoch 0 =
    unfenced liveness only).  Exactly TWO sizes are legal: the legacy
    load-free frame and the one-flags-byte extension —
    anything else dies typed like every other mangled frame."""
    view = _check_body(body, "a ping")
    _, ftype = _FRAME_HEAD.unpack_from(view, 4)
    if ftype != T_PING:
        raise KeyFormatError(f"frame type {ftype} is not a ping")
    base = _BODY_MIN + _PING_HEAD.size + _CRC.size
    if view.nbytes not in (base, base + _PING_FLAGS.size):
        raise KeyFormatError(
            f"ping frame must be exactly {base} bytes (or "
            f"{base + _PING_FLAGS.size} with the load-request flags), "
            f"got {view.nbytes}")
    req_id, epoch = _PING_HEAD.unpack_from(view, _BODY_MIN)
    want_load = False
    if view.nbytes == base + _PING_FLAGS.size:
        (flags,) = _PING_FLAGS.unpack_from(
            view, _BODY_MIN + _PING_HEAD.size)
        if flags & ~1:
            raise KeyFormatError(
                f"ping flags {flags:#x} set reserved bits")
        want_load = bool(flags & 1)
    return req_id, epoch, want_load


def decode_register(body) -> dict:
    """Strict REGISTER decode.  ``frame`` is a zero-copy ``memoryview``
    of the DCFK bytes inside ``body`` (the caller owns the buffer)."""
    view = _check_body(body, "a register")
    _, ftype = _FRAME_HEAD.unpack_from(view, 4)
    if ftype != T_REGISTER:
        raise KeyFormatError(f"frame type {ftype} is not a register")
    if view.nbytes < _BODY_MIN + _REG_HEAD.size + _CRC.size:
        raise KeyFormatError(
            f"truncated frame: {view.nbytes} bytes cannot hold a "
            "register header")
    req_id, generation, epoch, proto, key_len = _REG_HEAD.unpack_from(
        view, _BODY_MIN)
    if proto not in (0, 1):
        raise KeyFormatError(
            f"register proto flag must be 0 or 1, got {proto}")
    off = _BODY_MIN + _REG_HEAD.size
    end = view.nbytes - _CRC.size
    if off + key_len > end:
        raise KeyFormatError(
            f"truncated frame: section 'key_id' needs bytes "
            f"[{off}, {off + key_len}) but the payload ends at {end}")
    key_id = bytes(view[off:off + key_len]).decode("utf-8", "replace")
    off += key_len
    if off >= end:
        raise KeyFormatError(
            "register frame carries no DCFK payload (a zero-byte "
            "frame cannot be a key)")
    return {"req_id": req_id, "key_id": key_id,
            "generation": generation, "proto": bool(proto),
            "epoch": epoch, "frame": view[off:end]}


def decode_digest(body) -> tuple:
    """Strict DIGEST decode -> ``(req_id, mode, {key_id: generation})``."""
    view = _check_body(body, "a digest")
    _, ftype = _FRAME_HEAD.unpack_from(view, 4)
    if ftype != T_DIGEST:
        raise KeyFormatError(f"frame type {ftype} is not a digest")
    if view.nbytes < _BODY_MIN + _DIG_HEAD.size + _CRC.size:
        raise KeyFormatError(
            f"truncated frame: {view.nbytes} bytes cannot hold a "
            "digest header")
    req_id, mode, count = _DIG_HEAD.unpack_from(view, _BODY_MIN)
    if mode not in (0, 1):
        raise KeyFormatError(
            f"digest mode must be 0 or 1, got {mode}")
    off = _BODY_MIN + _DIG_HEAD.size
    end = view.nbytes - _CRC.size
    digest: dict = {}
    for i in range(count):
        if off + _DIG_ENTRY.size > end:
            raise KeyFormatError(
                f"truncated frame: digest entry {i} needs bytes "
                f"[{off}, {off + _DIG_ENTRY.size}) but the payload "
                f"ends at {end} (header claims {count} entries)")
        generation, key_len = _DIG_ENTRY.unpack_from(view, off)
        off += _DIG_ENTRY.size
        if off + key_len > end:
            raise KeyFormatError(
                f"truncated frame: digest entry {i}'s key_id "
                f"overruns the payload (header claims {count} entries)")
        key_id = bytes(view[off:off + key_len]).decode("utf-8",
                                                       "replace")
        off += key_len
        digest[key_id] = generation
    if off != end:
        raise KeyFormatError(
            f"oversized frame: {end - off} trailing bytes after "
            f"{count} digest entries")
    return req_id, mode, digest


def _decode_sync_entries(view: memoryview, off: int, end: int,
                         count: int) -> list:
    entries = []
    for i in range(count):
        if off + _SYNC_ENTRY.size > end:
            raise KeyFormatError(
                f"truncated frame: sync entry {i} needs bytes "
                f"[{off}, {off + _SYNC_ENTRY.size}) but the payload "
                f"ends at {end} (header claims {count} entries)")
        generation, proto, key_len, frame_len = _SYNC_ENTRY.unpack_from(
            view, off)
        if proto not in (0, 1):
            raise KeyFormatError(
                f"sync entry {i} proto flag must be 0 or 1, got {proto}")
        off += _SYNC_ENTRY.size
        if off + key_len + frame_len > end:
            raise KeyFormatError(
                f"truncated frame: sync entry {i}'s sections overrun "
                f"the payload (header claims {count} entries)")
        key_id = bytes(view[off:off + key_len]).decode("utf-8",
                                                       "replace")
        off += key_len
        frame = bytes(view[off:off + frame_len])
        off += frame_len
        entries.append((key_id, generation, bool(proto), frame))
    if off != end:
        raise KeyFormatError(
            f"oversized frame: {end - off} trailing bytes after "
            f"{count} sync entries")
    return entries


def decode_response(body) -> tuple:
    """Client-side strict decode: ``("share", req_id, y)``,
    ``("error", req_id, code, retry_after_s, message)``,
    ``("pong", req_id, value)`` or ``("sync", req_id, entries)``."""
    view = _check_body(body, "a response")
    _, ftype = _FRAME_HEAD.unpack_from(view, 4)
    end = view.nbytes - _CRC.size
    if ftype == T_SHARE:
        if view.nbytes < _BODY_MIN + _RES_HEAD.size + _CRC.size:
            raise KeyFormatError("truncated frame: no share header")
        req_id, k, m, lam = _RES_HEAD.unpack_from(view, _BODY_MIN)
        off = _BODY_MIN + _RES_HEAD.size
        if off + k * m * lam != end:
            raise KeyFormatError(
                f"share payload size mismatch: header claims "
                f"k={k}, m={m}, lam={lam} but {end - off} bytes follow")
        y = np.frombuffer(view[off:end], dtype=np.uint8)
        return ("share", req_id, y.reshape(k, m, lam))
    if ftype == T_ERROR:
        if view.nbytes < _BODY_MIN + _ERR_HEAD.size + _CRC.size:
            raise KeyFormatError("truncated frame: no error header")
        req_id, code, retry, msg_len = _ERR_HEAD.unpack_from(
            view, _BODY_MIN)
        off = _BODY_MIN + _ERR_HEAD.size
        if off + msg_len != end:
            raise KeyFormatError(
                f"error message size mismatch: header claims "
                f"{msg_len} bytes but {end - off} follow")
        msg = bytes(view[off:end]).decode("utf-8", "replace")
        return ("error", req_id, code,
                retry if retry >= 0 else None, msg)
    if ftype == T_PONG:
        base = _BODY_MIN + _PONG_HEAD.size + _CRC.size
        if view.nbytes not in (base, base + _PONG_LOAD.size):
            raise KeyFormatError(
                f"pong frame must be exactly {base} bytes (or "
                f"{base + _PONG_LOAD.size} with the load block), "
                f"got {view.nbytes}")
        req_id, value = _PONG_HEAD.unpack_from(view, _BODY_MIN)
        if view.nbytes == base:
            return ("pong", req_id, value)
        qp, ql, bo, shed, refused, misses = _PONG_LOAD.unpack_from(
            view, _BODY_MIN + _PONG_HEAD.size)
        if bo > 1:
            raise KeyFormatError(
                f"pong brownout byte must be 0 or 1, got {bo}")
        return ("pong", req_id,
                (value, LoadSample(qp, ql, bool(bo), shed, refused,
                                   misses)))
    if ftype == T_SYNC:
        if view.nbytes < _BODY_MIN + _SYNC_HEAD.size + _CRC.size:
            raise KeyFormatError("truncated frame: no sync header")
        req_id, count = _SYNC_HEAD.unpack_from(view, _BODY_MIN)
        entries = _decode_sync_entries(
            view, _BODY_MIN + _SYNC_HEAD.size, end, count)
        return ("sync", req_id, entries)
    raise KeyFormatError(
        f"frame type {ftype} is not a response (client side accepts "
        "types 2, 3, 5 and 8)")


# ------------------------------------------------------ admission


class TokenBucket:
    """Per-tenant points-per-second admission on the injectable clock.

    ``admit(points, now)`` returns 0.0 when admitted (tokens consumed)
    or the retry-after hint in seconds — the EXACT time until the
    bucket would hold ``points`` tokens, so a refused client's backoff
    is a schedule, not a guess.  A request larger than the bucket
    capacity is refused UNCONDITIONALLY — ``points > burst`` can never
    be admitted, full bucket or not, or an oversized request would
    bypass the rate limit entirely; its hint is the (unreachable)
    time-to-``points``, always positive: split the request or raise
    the burst.  Thread-safe: several connections may serve one tenant.
    """

    __slots__ = ("rate", "burst", "_tokens", "_last", "_lock")

    def __init__(self, points_per_sec: float, burst_points: float,
                 now: float):
        if points_per_sec < 0:
            # api-edge: bucket contract (0 disables rate limiting)
            raise ValueError(
                f"points_per_sec must be >= 0, got {points_per_sec}")
        self.rate = float(points_per_sec)
        self.burst = float(burst_points) if burst_points > 0 \
            else max(self.rate, 1.0)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._tokens = self.burst
        # guarded-by: _lock
        self._last = float(now)

    def admit(self, points: int, now: float) -> float:
        if self.rate <= 0:
            return 0.0
        with self._lock:
            elapsed = max(now - self._last, 0.0)
            self._tokens = min(self.burst,
                               self._tokens + elapsed * self.rate)
            self._last = now
            if points <= self._tokens:
                self._tokens -= points
                return 0.0
            # points > tokens: refused.  For points > burst this is
            # ALWAYS positive even against a full bucket — clamping
            # the hint at capacity would return 0.0 there, which the
            # caller reads as "admitted": a zero-token rate-limit
            # bypass for any request sized above the burst.
            return (points - self._tokens) / self.rate


class _Tenant:
    """One resolved tenant: its class, its bucket, its metric series."""

    __slots__ = ("spec", "bucket", "c_requests", "c_points",
                 "c_refusals")

    def __init__(self, spec: TenantSpec, metrics: Metrics, now: float):
        self.spec = spec
        self.bucket = TokenBucket(spec.points_per_sec,
                                  spec.burst_points, now)
        name = spec.name
        self.c_requests = metrics.counter(labeled(
            "edge_tenant_requests_total", tenant=name))
        self.c_points = metrics.counter(labeled(
            "edge_tenant_points_total", tenant=name))
        self.c_refusals = metrics.counter(labeled(
            "edge_tenant_refusals_total", tenant=name))


# ------------------------------------------------------ the server


class _Conn:
    """One accepted connection: a reader thread decoding frames and
    submitting, a writer thread streaming completions back.  All
    failures are PER-CONNECTION: they end these two threads, never the
    accept loop or another connection."""

    #: Response-backlog bound per connection: a peer that pipelines
    #: requests but never reads responses would otherwise grow the
    #: out-queue (completed futures + their frame buffers) without
    #: limit while the writer sits in ``sendall`` on the full socket.
    #: At the bound the READER blocks instead — TCP backpressure
    #: propagates to the slow peer, and memory per connection stays
    #: bounded.  (The admission queue bounds only UNSERVED points, so
    #: it cannot provide this.)
    MAX_PENDING_RESPONSES = 256

    def __init__(self, server: "EdgeServer", sock: socket.socket,
                 peer: str):
        self._srv = server
        self._sock = sock
        # What reads and writes go through: the socket itself, or,
        # once the reader has finished a TLS handshake, a _TlsDuplex.
        self._io = sock
        self._peer = peer
        # Deliberately lock-free (hence no guarded-by annotations):
        # the cross-thread state is ``_out`` — a queue.Queue, which
        # owns its synchronization — and ``_closing``, a monotonic
        # False->True sentinel both loops only poll (a stale read
        # costs one extra 0.1 s put slice, never correctness).
        self._out: queue.Queue = queue.Queue(self.MAX_PENDING_RESPONSES)
        self._closing = False
        self._reader = threading.Thread(
            target=self._read_loop, name=f"edge-read-{peer}",
            daemon=True)
        self._writer = threading.Thread(
            target=self._write_loop, name=f"edge-write-{peer}",
            daemon=True)

    def start(self) -> None:
        self._reader.start()
        self._writer.start()

    def close(self) -> None:
        """Server-initiated shutdown: unblock both threads."""
        self._closing = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already gone
        self._sock.close()
        try:
            self._out.put_nowait(None)
        except queue.Full:
            pass  # the writer is mid-backlog; the closed socket ends it

    def nudge(self) -> None:
        """The graceful half of a shutdown: queue the writer's end
        sentinel so it delivers the responses queued before it, then
        exits.  ``EdgeServer.close(drain_s=)`` nudges every connection
        before it joins any writer, so the flush has one shared
        deadline, not one per connection."""
        try:
            self._out.put_nowait(None)
        except queue.Full:
            pass  # a full backlog still drains; the join bounds it

    def join_writer(self, timeout: float) -> None:
        self._writer.join(timeout)

    def _enqueue(self, item) -> None:
        """Reader-side put honouring the backlog bound: blocks in
        slices so a server/connection close can always free the reader
        (the closed socket ends the writer, which may never drain)."""
        while not self._closing:
            try:
                self._out.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def join(self, timeout: float | None = None) -> None:
        self._reader.join(timeout)
        self._writer.join(timeout)

    # -- receive path --------------------------------------------------

    def _recv_into(self, view: memoryview) -> None:
        got = 0
        while got < len(view):
            fire("edge.read", self._peer, len(view) - got)
            n = self._io.recv_into(view[got:], len(view) - got)
            if n == 0:
                # dcflint: disable=typed-error _Disconnect IS a
                # DcfError subclass (module-local, so the containment
                # handler can tell a vanished peer from a framing
                # violation without string matching)
                raise _Disconnect(
                    f"peer {self._peer} disconnected mid-frame "
                    f"({got}/{len(view)} bytes of the section)")
            got += n

    def _read_frame(self) -> bytearray | None:
        """One envelope + body; ``None`` on a clean EOF between
        frames.  The body buffer is FRESH per frame: the decoded xs
        payload stays aliased by the queued request until its batch
        is gathered, so the buffer must never be reused."""
        prefix = bytearray(_PREFIX.size)
        fire("edge.read", self._peer, _PREFIX.size)
        n = self._io.recv_into(prefix, _PREFIX.size)
        if n == 0:
            return None  # clean close between frames
        if n < _PREFIX.size:
            self._recv_into(memoryview(prefix)[n:])
        (body_len,) = _PREFIX.unpack(prefix)
        if not _BODY_MIN + _CRC.size <= body_len \
                <= self._srv.max_frame_bytes:
            raise KeyFormatError(
                f"length prefix {body_len} outside "
                f"[{_BODY_MIN + _CRC.size}, "
                f"{self._srv.max_frame_bytes}] (oversized or mangled "
                "envelope)")
        body = bytearray(body_len)
        self._recv_into(memoryview(body))
        return body

    def _read_loop(self) -> None:
        srv = self._srv
        try:
            if isinstance(self._sock, ssl.SSLSocket):
                # Deferred TLS handshake (see the accept loop): a
                # peer speaking plaintext, or one without the pinned
                # client cert, fails HERE — an SSLError is an OSError,
                # so the containment below counts it and ends only
                # this connection.  read_timeout_s bounds the
                # handshake like any other read.
                self._sock.do_handshake()
                self._io = _TlsDuplex(self._sock,
                                      self._srv.read_timeout_s or None)
            while not self._closing:
                body = self._read_frame()
                if body is None:
                    break
                srv._c_frames.inc()
                self._handle_frame(body)
        except KeyFormatError as e:
            # Framing violation (bad magic/length/CRC, from the
            # envelope read or the frame decode): answer typed, then
            # hang up — after a mangled frame the stream cannot be
            # trusted to re-synchronize on the next envelope.
            srv._c_wire_errors.inc()
            self._enqueue(encode_error(0, E_WIRE, str(e)))
        except _Disconnect:
            srv._c_conn_errors.inc()
        except OSError:
            # fallback-ok: socket teardown (server close or peer
            # reset) ends the connection; the accept loop and the
            # other connections are untouched.
            if not self._closing:
                srv._c_conn_errors.inc()
        except Exception as e:  # fallback-ok: ANY per-connection
            # failure (e.g. an armed edge.read fault) must end THIS
            # connection typed, never the accept loop or another
            # tenant's connection.
            srv._c_conn_errors.inc()
            self._enqueue(encode_error(0, E_INTERNAL,
                                       f"{type(e).__name__}: {e}"))
        finally:
            self._enqueue(None)  # writer drains what is queued, then
            srv._forget(self)   # the connection is gone

    def _handle_frame(self, body: bytearray) -> None:
        """Dispatch one decoded-length frame by type.  ``_read_frame``
        already bounds ``body`` at >= the header size, so the type
        peek cannot overrun; a corrupt type byte lands in a decoder
        whose CRC/type check dies ``KeyFormatError`` — the framing
        kill, exactly like any other mangled frame."""
        ftype = body[6]  # after magic (4) + version (2)
        if ftype == T_REQUEST:
            self._handle_request(body)
        elif ftype == T_PING:
            req_id, epoch, want_load = decode_ping(body)
            srv = self._srv
            srv._c_control.inc()
            # Admission-free by design: liveness, not serving capacity
            # (a shard in brownout is alive and must answer probes —
            # see the module docstring's control-frame section).  A
            # fenced ping (epoch > 0) adopts-or-refuses like any other
            # fenced frame: probes are how epochs disseminate, and a
            # STALE prober must learn its ring is old, not keep
            # confirming a membership view the pod has moved past.
            try:
                current = self._check_epoch(epoch)
            except Exception as e:  # fallback-ok: the typed E_EPOCH
                # refusal is a request-level outcome; the connection
                # survives (framing was intact)
                srv._c_refused.inc()
                self._enqueue(encode_error(
                    req_id, _code_for(e), str(e),
                    getattr(e, "retry_after_s", None)))
                return
            load = None
            report = getattr(srv._service, "load_report", None)
            if want_load and callable(report):
                try:
                    load = report()
                except Exception:  # fallback-ok: the probe is
                    # LIVENESS first — a load surface failing must
                    # degrade to "no sample", never an unanswered ping
                    load = None
            self._enqueue(("ctl", encode_pong(req_id, current,
                                              load=load)))
        elif ftype == T_REGISTER:
            self._handle_register(body)
        elif ftype == T_DIGEST:
            self._handle_digest(body)
        else:
            raise KeyFormatError(
                f"frame type {ftype} is not a server-side frame "
                "(server side accepts types 1, 4, 6 and 7)")

    def _check_epoch(self, epoch: int, adopt: bool = True) -> int:
        """The ring-epoch fence: adopt-or-refuse ``epoch``
        against the service's observed maximum.  Returns the service's
        current epoch (0 when the target has no epoch surface — a
        router door, or a pre-membership service); raises the typed
        ``RingEpochError`` for a stale sender.  Epoch 0 frames are
        unfenced and skip the check entirely.  ``adopt=False`` =
        refuse-only (the REQUEST path's pre-admission check — see
        ``DcfService.check_ring_epoch``)."""
        check = getattr(self._srv._service, "check_ring_epoch", None)
        if check is None:
            return 0
        if not epoch:
            return int(getattr(self._srv._service, "ring_epoch", 0))
        return int(check(epoch, adopt=adopt))

    def _handle_register(self, body: bytearray) -> None:
        req = decode_register(body)
        srv = self._srv
        req_id = req["req_id"]
        srv._c_control.inc()
        try:
            # The membership fence runs FIRST: a registration routed on
            # a stale ring must not mint/apply against a placement the
            # pod has moved past (it would be healed by anti-entropy,
            # but structurally refusing it is what makes a stale
            # router's writes impossible rather than merely repaired).
            self._check_epoch(req["epoch"])
            if req["generation"]:
                apply_fn = getattr(srv._service, "apply_replica_frame",
                                   None)
                if apply_fn is None:
                    # api-edge: surface contract — this endpoint (e.g.
                    # a pod router's own door when the frame carries a
                    # forced generation it should never see) does not
                    # accept replica applies
                    raise ValueError(
                        "this endpoint does not accept replica "
                        "REGISTER frames (no apply_replica_frame "
                        "surface)")
                gen = apply_fn(req["key_id"], req["frame"],
                               req["generation"], proto=req["proto"])
            else:
                mint_fn = getattr(srv._service, "register_frame", None)
                if mint_fn is None:
                    # api-edge: surface contract
                    raise ValueError(
                        "this endpoint does not accept REGISTER "
                        "frames (no register_frame surface)")
                gen = mint_fn(req["key_id"], req["frame"],
                              proto=req["proto"])
        except Exception as e:  # fallback-ok: a refused registration
            # (fenced generation -> E_STALE, geometry mismatch, corrupt
            # DCFK payload) is a REQUEST-level outcome — answer typed,
            # keep the connection (framing was intact).
            srv._c_refused.inc()
            self._enqueue(encode_error(
                req_id, _code_for(e), str(e),
                getattr(e, "retry_after_s", None)))
            return
        self._enqueue(("ctl", encode_pong(req_id, int(gen))))

    def _handle_digest(self, body: bytearray) -> None:
        req_id, mode, digest = decode_digest(body)
        srv = self._srv
        srv._c_control.inc()
        try:
            if mode == 1:
                dig_fn = getattr(srv._service, "replication_digest",
                                 None)
                if dig_fn is None:
                    # api-edge: surface contract (a router holds no
                    # registrations to digest)
                    raise ValueError(
                        "this endpoint holds no registrations to "
                        "digest (no replication_digest surface)")
                entries = [(k, g, False, b"")
                           for k, g in sorted(dig_fn().items())]
            else:
                sync_fn = getattr(srv._service, "sync_frames", None)
                if sync_fn is None:
                    # api-edge: surface contract
                    raise ValueError(
                        "this endpoint cannot serve an anti-entropy "
                        "pull (no sync_frames surface)")
                entries = sync_fn(digest)
        except Exception as e:  # fallback-ok: request-level outcome,
            # answered typed; the connection survives
            srv._c_refused.inc()
            self._enqueue(encode_error(
                req_id, _code_for(e), str(e),
                getattr(e, "retry_after_s", None)))
            return
        self._enqueue(("ctl", encode_sync(req_id, entries)))

    def _handle_request(self, body: bytearray) -> None:
        req = decode_request(body)
        srv = self._srv
        req_id = req["req_id"]

        def refuse(code: int, msg: str,
                   retry_after_s: float | None = None) -> None:
            srv._c_refused.inc()
            self._enqueue(encode_error(req_id, code, msg,
                                       retry_after_s))

        if req["n_bytes"] != srv.n_bytes:
            refuse(E_SHAPE,
                   f"point width {req['n_bytes']} != service domain "
                   f"{srv.n_bytes} bytes")
            return
        if req["party"] not in (0, 1):
            refuse(E_BAD_REQUEST,
                   f"party must be 0 or 1, got {req['party']}")
            return
        try:
            # Epoch fence BEFORE tenant admission, refuse-only: a
            # stale router's forward must not consume a tenant's token
            # budget on a request this shard will structurally refuse
            # — but an UNADMITTED sender must not be able to ADOPT
            # either (one forged frame with a huge epoch would fence
            # out the real router); adoption runs post-admission.
            self._check_epoch(req["epoch"], adopt=False)
        except Exception as e:  # fallback-ok: typed E_EPOCH refusal —
            # request-level, the connection survives
            refuse(_code_for(e), str(e),
                   getattr(e, "retry_after_s", None))
            return
        tenant = srv._resolve_tenant(req["tenant"])
        if tenant is None:
            refuse(E_UNKNOWN_TENANT,
                   f"unknown tenant {req['tenant']!r}: the service's "
                   "tenant table does not name it")
            return
        pri = req["priority"]
        if pri == _PRI_DEFAULT:
            eff = tenant.spec.priority
        elif pri in (0, 1, 2):
            if tenant is srv._default_tenant:
                # The OPEN edge (no tenant table) honors the frame's
                # class verbatim: an empty table is "no policy", and
                # the router->shard link depends on the forwarded
                # class surviving the hop — the tenant cap is a
                # CONFIGURED-table rule, not a default clamp (a clamp
                # here would silently demote every routed CRITICAL
                # request to NORMAL on its shard).
                eff = Priority(pri)
            else:
                # A request may demote below its tenant class, never
                # promote above it (larger enum value = lower class).
                eff = Priority(max(pri, tenant.spec.priority.value))
        else:
            refuse(E_BAD_REQUEST,
                   f"priority byte must be 0/1/2 or 255, got {pri}")
            return
        tenant.c_requests.inc()
        now = srv._clock()
        retry = tenant.bucket.admit(req["m"], now)
        if retry > 0:
            tenant.c_refusals.inc()
            refuse(E_RATE_LIMITED,
                   f"tenant {tenant.spec.name!r} over its "
                   f"{tenant.bucket.rate:g} points/s admission rate",
                   retry_after_s=retry)
            return
        try:
            # Admitted: NOW a newer epoch is adopted (the refuse-only
            # half already ran pre-admission).  A membership commit
            # landing BETWEEN the two checks can make the sender stale
            # here — still a typed request-level refusal.
            self._check_epoch(req["epoch"])
        except Exception as e:  # fallback-ok: typed E_EPOCH refusal
            refuse(_code_for(e), str(e),
                   getattr(e, "retry_after_s", None))
            return
        try:
            fut = srv._service.submit_bytes(
                req["key_id"], req["payload"], b=req["party"],
                deadline_ms=req["deadline_ms"], priority=eff)
        except Exception as e:  # fallback-ok: a refused submit
            # (QueueFullError, unknown key, shape violation) is a
            # REQUEST-level outcome — answer typed, keep the
            # connection (framing was intact).
            srv._c_refused.inc()
            self._enqueue(encode_error(
                req_id, _code_for(e), str(e),
                getattr(e, "retry_after_s", None)))
            return
        tenant.c_points.inc(req["m"])
        # The frame buffer rides with the future: the payload view
        # aliases it until the batch gather copies the spans out.
        self._enqueue((req_id, fut, body))

    # -- response path -------------------------------------------------

    def _write_loop(self) -> None:
        srv = self._srv
        try:
            while True:
                item = self._out.get()
                if item is None:
                    break
                if isinstance(item, (bytes, bytearray)):
                    self._io.sendall(item)
                    srv._c_errors_sent.inc()
                    continue
                if item[0] == "ctl":  # PONG/SYNC control responses
                    self._io.sendall(item[1])
                    srv._c_responses.inc()
                    continue
                req_id, fut, _body = item
                try:
                    y = fut.result()
                except Exception as e:  # fallback-ok: a failed
                    # request (deadline, breaker, retries exhausted)
                    # crosses the wire as a typed ERROR frame; the
                    # connection survives.
                    self._io.sendall(encode_error(
                        req_id, _code_for(e), str(e),
                        getattr(e, "retry_after_s", None)))
                    srv._c_errors_sent.inc()
                    continue
                _sendmsg_all(self._io, encode_share(req_id, y))
                srv._c_responses.inc()
        except OSError:
            # fallback-ok: the peer stopped reading (reset/close) —
            # per-connection, contained; queued futures complete in
            # the service regardless (results are simply undeliverable)
            if not self._closing:
                srv._c_conn_errors.inc()
        finally:
            # The writer IS the out-queue's only consumer: mark the
            # connection closing so a reader blocked in _enqueue on a
            # full backlog (slow peer that then died) exits its slice
            # loop instead of spinning forever against a queue nobody
            # will ever drain.
            self._closing = True
            self._sock.close()


class EdgeServer:
    """The serving tier's TCP front (see the module docstring).

    ``EdgeServer(service).start()`` binds and spawns the accept loop;
    ``address`` is the bound ``(host, port)`` (port 0 picks a free
    one).  Tenancy and rate limits come from the service's
    ``ServeConfig.tenants``; all admission math runs on the service's
    injectable clock.  ``close()`` stops accepting, hangs up every
    connection, and joins the threads.
    """

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 *, max_frame_bytes: int = 64 << 20, backlog: int = 64,
                 read_timeout_s: float = 0.0,
                 tls_cert: str | None = None, tls_key: str | None = None,
                 tls_client_ca: str | None = None):
        if max_frame_bytes < _BODY_MIN + _CRC.size:
            # api-edge: config contract — a bound below one empty
            # frame refuses everything
            raise ValueError(
                f"max_frame_bytes must be >= {_BODY_MIN + _CRC.size}, "
                f"got {max_frame_bytes}")
        if read_timeout_s < 0:
            # api-edge: config contract (0 = block forever, the
            # trusted-peer default; a positive bound is the
            # slow-loris guard — note it also hangs up idle
            # keep-alive connections at the same horizon)
            raise ValueError(
                f"read_timeout_s must be >= 0, got {read_timeout_s}")
        self.read_timeout_s = float(read_timeout_s)
        self._service = service
        self._host = host
        self._port = port
        self.max_frame_bytes = int(max_frame_bytes)
        self._backlog = int(backlog)
        # The point width comes from the service-like target: a
        # DcfService exposes it as a property; the pod router
        # (serve.router) carries its own — anything with n_bytes,
        # _clock, metrics, config.tenants and submit_bytes can sit
        # behind this server (the router speaks DCFE on both
        # sides by fronting itself with this exact class).
        self.n_bytes = int(service.n_bytes)
        self._clock = service._clock
        self.metrics = service.metrics
        # TLS: explicit kwargs override the
        # service config's tls_* knobs (None = inherit).  cert+key arm
        # the server context; tls_client_ca additionally PINS clients —
        # only peers presenting a cert signed by that CA complete the
        # handshake (the router<->shard link hardening).
        cfg = getattr(service, "config", None)
        cert = tls_cert if tls_cert is not None \
            else getattr(cfg, "tls_cert", "")
        key = tls_key if tls_key is not None \
            else getattr(cfg, "tls_key", "")
        client_ca = tls_client_ca if tls_client_ca is not None \
            else getattr(cfg, "tls_client_ca", "")
        if bool(cert) != bool(key):
            # api-edge: TLS config contract — half a keypair serves
            # nothing; failing loudly beats a plaintext surprise
            raise ValueError(
                "TLS needs BOTH tls_cert and tls_key (got only one)")
        if client_ca and not cert:
            # api-edge: TLS config contract — client pinning without a
            # server identity is not a mode ssl offers
            raise ValueError(
                "tls_client_ca requires tls_cert/tls_key")
        self._tls_ctx: ssl.SSLContext | None = None
        if cert:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key)
            # No TLS 1.3 session tickets: no client of the edge resumes
            # a session, and a ticket is a post-handshake message that
            # a client reads on one thread while it writes on another
            # (see _TlsDuplex) — ``dcf_tpu``'s client has no such guard.
            ctx.num_tickets = 0
            if client_ca:
                ctx.load_verify_locations(client_ca)
                ctx.verify_mode = ssl.CERT_REQUIRED
            self._tls_ctx = ctx
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._conns: set[_Conn] = set()
        self._listener: socket.socket | None = None
        self._acceptor: threading.Thread | None = None
        self._closing = False
        self._draining = False
        now = self._clock()
        self._tenants = {
            spec.name: _Tenant(spec, self.metrics, now)
            for spec in service.config.tenants}
        # The open-edge default: no table -> every tenant serves as
        # NORMAL, unlimited, under one shared metric identity.
        self._default_tenant = (None if self._tenants else _Tenant(
            TenantSpec(name="default"), self.metrics, now))
        m = self.metrics
        self._c_connections = m.counter("edge_connections_total")
        self._g_open = m.gauge("edge_connections_open")
        self._c_accept_errors = m.counter("edge_accept_errors_total")
        self._c_conn_errors = m.counter("edge_connection_errors_total")
        self._c_wire_errors = m.counter("edge_wire_errors_total")
        self._c_frames = m.counter("edge_frames_total")
        self._c_refused = m.counter("edge_refused_total")
        self._c_responses = m.counter("edge_responses_total")
        self._c_errors_sent = m.counter("edge_errors_sent_total")
        self._c_control = m.counter("edge_control_frames_total")

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "EdgeServer":
        if self._listener is not None:
            return self
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, self._port))
        sock.listen(self._backlog)
        self._listener = sock
        self._acceptor = threading.Thread(
            target=self._accept_loop, name="edge-accept", daemon=True)
        self._acceptor.start()
        return self

    @property
    def address(self) -> tuple[str, int]:
        if self._listener is None:
            raise StaleStateError("edge server not started")
        return self._listener.getsockname()[:2]

    def stop_accepting(self) -> None:
        """Shut the listener down but leave live connections OPEN: the
        first half of a graceful shutdown.  New dials are refused, the
        service drains so queued requests complete, and the writers
        deliver those responses over the still-open links before
        ``close()`` tears them down.  Idempotent; ``close()`` calls
        it."""
        self._draining = True
        listener = self._listener
        if listener is not None:
            try:
                listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # never connected / already down
            listener.close()
        if self._acceptor is not None:
            self._acceptor.join(5.0)

    def close(self, drain_s: float = 0.0) -> None:
        """Tear the edge down: stop accepting, hang up every
        connection, join the threads.  Idempotent.  ``drain_s`` > 0 is
        the graceful spelling: after the listener stops, each
        connection's writer gets up to that long, in all, to flush its
        queued responses (the futures behind them must already be
        complete: drain the service first) before the hard close."""
        self._closing = True
        self.stop_accepting()
        with self._lock:
            conns = list(self._conns)
        if drain_s > 0:
            # Sentinel every writer FIRST, then join against ONE shared
            # deadline: K peers that stopped reading cost at most
            # drain_s in all, not K * drain_s.
            for c in conns:
                c.nudge()
            deadline = monotonic() + drain_s
            for c in conns:
                c.join_writer(max(0.0, deadline - monotonic()))
        for c in conns:
            c.close()
        for c in conns:
            c.join(5.0)

    def __enter__(self) -> "EdgeServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -- internals -----------------------------------------------------

    def _resolve_tenant(self, name: str) -> _Tenant | None:
        if self._default_tenant is not None:
            return self._default_tenant
        return self._tenants.get(name)

    def _forget(self, conn: _Conn) -> None:
        with self._lock:
            self._conns.discard(conn)
            self._g_open.set(len(self._conns))

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                fire("edge.accept")
                sock, addr = self._listener.accept()
            except OSError:
                # fallback-ok: close() or stop_accepting() shut the
                # listener down, or a transient accept failure — the
                # loop survives the latter and exits on the former.
                if self._closing or self._draining:
                    return
                self._c_accept_errors.inc()
                continue
            except Exception:  # fallback-ok: an armed edge.accept
                # fault models EMFILE-style accept errors; count and
                # keep accepting — live connections are untouched.
                self._c_accept_errors.inc()
                continue
            conn = None
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                1)
                if self._tls_ctx is not None:
                    # Wrap WITHOUT handshaking: the handshake blocks on
                    # peer bytes, and it must cost a reader thread, not
                    # the accept loop (the reader performs it as its
                    # first read — a plaintext or unpinned peer dies
                    # there as a counted per-connection failure).
                    sock = self._tls_ctx.wrap_socket(
                        sock, server_side=True,
                        do_handshake_on_connect=False)
                if self.read_timeout_s:
                    # The slow-loris bound: a recv blocking past this
                    # dies as a per-connection OSError (counted,
                    # contained) — a half-sent frame cannot pin a
                    # reader thread and its frame buffer forever.
                    sock.settimeout(self.read_timeout_s)
                conn = _Conn(self, sock, f"{addr[0]}:{addr[1]}")
                with self._lock:
                    if self._closing:
                        sock.close()
                        return
                    self._conns.add(conn)
                    n_open = len(self._conns)
                self._c_connections.inc()
                self._g_open.set(n_open)
                conn.start()
            except Exception:  # fallback-ok: a peer that reset before
                # setup, or thread/fd pressure at conn.start() — one
                # bad accepted socket is a per-connection failure, and
                # the accept loop must outlive it ('never a dead
                # accept loop', same contract the edge.accept seam
                # pins).
                self._c_accept_errors.inc()
                if conn is not None:
                    with self._lock:
                        self._conns.discard(conn)
                        self._g_open.set(len(self._conns))
                try:
                    sock.close()
                except OSError:
                    pass  # already gone


# ------------------------------------------------------ the client


def _raise_wire(code: int, retry_after_s: float | None, msg: str):
    cls = WIRE_CODES.get(code, DcfError)
    if cls is QueueFullError:
        err = cls(msg, retry_after_s=retry_after_s,
                  evicted=code == E_EVICTED)
    elif cls in (CircuitOpenError, RingEpochError, MeshUnavailableError):
        err = cls(msg, retry_after_s=retry_after_s)
    elif cls is ValueError:
        # api-edge: the server flagged a request-contract violation
        # (unknown key/tenant, bad party) — builtin semantics, exactly
        # what the in-process call site would have raised.
        err = ValueError(msg)
    else:
        err = cls(msg)
    # The raw wire code rides along: two codes can map to
    # one class (E_QUEUE_FULL vs E_RATE_LIMITED, E_UNAVAILABLE vs a
    # local transport death, which carries NO wire_code), and the
    # router's suspicion policy is keyed on the code, not the class.
    err.wire_code = code
    return err


class EdgeClient:
    """A pipelining DCFE client: ``submit`` returns a ``ServeFuture``
    completed by a reader thread matching ``req_id``s, so one
    connection can carry many requests in flight (the open-loop
    loadgen's shape) or be driven closed-loop (submit -> result).
    Typed failures arrive as the real ``dcf_tpu_torch.errors`` classes, with
    ``retry_after_s`` re-attached where the taxonomy carries one.

    Not a pool: one instance = one TCP connection.  ``n_bytes`` is the
    service's point width (the client cannot discover it over the
    wire; passing the wrong one is refused typed by the server).
    """

    def __init__(self, host: str, port: int, *, n_bytes: int,
                 tenant: str = "", connect_timeout: float = 30.0,
                 max_frame_bytes: int = 256 << 20, tls: bool = False,
                 tls_ca: str = "", tls_cert: str = "",
                 tls_key: str = "", tags: tuple | None = None):
        self.n_bytes = int(n_bytes)
        self.tenant = tenant
        # Partition seam identity: ``(local, peer)`` tags —
        # when set, every dial and every frame send fires
        # ``net.partition`` so the chaos harness can cut this link
        # (the handler raises OSError, contained as transport death).
        self._tags = tuple(tags) if tags is not None else None
        if self._tags is not None:
            fire("net.partition", *self._tags)
        # Response-frame sanity bound (mirrors the server's request
        # knob): a SHARE payload is k*m*lam — raise this when a
        # large-lambda service legitimately returns more than 256 MiB
        # per response, or an oversized VALID share would tear the
        # connection down as a framing error.
        self.max_frame_bytes = int(max_frame_bytes)
        ctx: ssl.SSLContext | None = None
        if tls or tls_ca or tls_cert:
            # TLS: ``tls_ca`` pins the server —
            # the handshake verifies its cert chains to that CA (the
            # cert's SAN must cover ``host``, IP or name).  Without a
            # CA the link is encrypted but UNAUTHENTICATED — lab-only,
            # stated here so nobody mistakes it for pinning.
            # ``tls_cert``/``tls_key`` present a client cert for
            # servers that pin clients (``tls_client_ca``).  Context
            # construction precedes the dial: a bad TLS config must
            # fail loudly, not after a connect timeout.
            if bool(tls_cert) != bool(tls_key):
                # api-edge: TLS config contract (half a keypair)
                raise ValueError(
                    "client TLS needs BOTH tls_cert and tls_key")
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            if tls_ca:
                ctx.load_verify_locations(tls_ca)
                ctx.check_hostname = True
            else:
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            if tls_cert:
                ctx.load_cert_chain(tls_cert, tls_key)
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout)
        if ctx is not None:
            self._sock = ctx.wrap_socket(self._sock,
                                         server_hostname=host)
        # Blocking from here on: the reader parks in recv between
        # responses (close() unblocks it); waiting bounds belong to
        # ``ServeFuture.result(timeout)``, not the transport.
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # Reads and writes go through the socket, or for TLS through a
        # _TlsDuplex: the reader thread and the submitting threads
        # share one OpenSSL object.
        self._io = (self._sock if ctx is None
                    else _TlsDuplex(self._sock, None))
        self._lock = threading.Lock()       # id/pending/closed state
        self._send_lock = threading.Lock()  # frame writes stay whole
        # guarded-by: _lock
        self._pending: dict[int, ServeFuture] = {}
        # guarded-by: _lock
        self._next_id = 1
        # guarded-by: _lock
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="edge-client-read",
            daemon=True)
        self._reader.start()

    # -- submission ----------------------------------------------------

    def submit(self, key_id: str, xs, b: int = 0,
               deadline_ms: float | None = None,
               priority=None) -> ServeFuture:
        """Wire twin of ``DcfService.submit`` (``priority=None`` =
        the tenant's class).  Thread-safe."""
        xs = np.ascontiguousarray(np.asarray(xs, dtype=np.uint8))
        if xs.ndim != 2 or xs.shape[1] != self.n_bytes:
            raise ShapeError(
                f"xs must be [M, {self.n_bytes}], got {xs.shape}")
        if xs.shape[0] < 1:
            raise ShapeError("cannot submit an empty request")
        return self.submit_bytes(key_id, xs.data, m=xs.shape[0], b=b,
                                 deadline_ms=deadline_ms,
                                 priority=priority)

    def submit_bytes(self, key_id: str, data, m: int | None = None,
                     b: int = 0, deadline_ms: float | None = None,
                     priority=None, epoch: int = 0) -> ServeFuture:
        """Wire twin of ``DcfService.submit_bytes`` — and the pod
        router's relay path: ``data`` (any buffer-protocol
        object of ``m`` packed ``n_bytes``-wide points; ``m`` derived
        when omitted) is sent BY REFERENCE via the scatter-gather
        write, so a forwarded request's payload crosses this hop as a
        ``memoryview`` of the upstream frame buffer — no join, no
        re-materialization.  The caller must keep ``data`` alive until
        this call returns (the send completes synchronously).
        ``epoch``: the ring epoch the sender routed on —
        the router passes its current one; direct callers leave 0
        (unfenced)."""
        view = memoryview(data).cast("B")
        if m is None:
            if view.nbytes == 0 or view.nbytes % self.n_bytes:
                raise ShapeError(
                    f"payload of {view.nbytes} bytes is not a positive "
                    f"multiple of n_bytes={self.n_bytes}")
            m = view.nbytes // self.n_bytes
        if m < 1 or m * self.n_bytes != view.nbytes:
            raise ShapeError(
                f"payload holds {view.nbytes} bytes, not m={m} points "
                f"of {self.n_bytes}")
        pri = _PRI_DEFAULT if priority is None \
            else parse_priority(priority).value
        with self._lock:
            if self._closed:
                raise BackendUnavailableError(
                    "edge connection is closed")
            req_id = self._next_id
            self._next_id += 1
        # Encode BEFORE registering: an encoding failure (a key_id
        # over the 255-byte field, a bad party byte) must not leave an
        # orphaned never-completed future in _pending for the
        # connection's lifetime.  The burned req_id is harmless.
        views = [memoryview(p).cast("B") for p in _request_parts(
            req_id, self.tenant, key_id, b, pri, deadline_ms, view,
            self.n_bytes, m, epoch)]
        crc = 0
        for v in views:
            crc = zlib.crc32(v, crc)
        body_len = sum(v.nbytes for v in views) + _CRC.size
        fut = ServeFuture()
        with self._lock:
            if self._closed:
                raise BackendUnavailableError(
                    "edge connection is closed")
            self._pending[req_id] = fut
        try:
            with self._send_lock:
                if self._tags is not None:
                    fire("net.partition", *self._tags)
                _sendmsg_all(self._io,
                             [_PREFIX.pack(body_len), *views,
                              _CRC.pack(crc)])
        except OSError as e:
            # A failed send means the TRANSPORT is gone, not just this
            # request: mark the connection closed and fail every
            # pending future typed, or a pooled caller would keep
            # retrying a dead connection forever (``closed`` stays the
            # reliable reconnect signal).
            err = BackendUnavailableError(
                f"edge connection lost on send: {e}")
            self._fail_pending(err)
            raise err from e
        return fut

    # -- control frames ------------------------------------------------

    def _roundtrip(self, encode, timeout: float | None):
        """Register a future, send one control frame (``encode(req_id)
        -> frame bytes``), wait for its response.  Send failures take
        the submit path's transport-death containment; a TIMEOUT prunes
        the pending entry (a prober timing out every interval must not
        grow ``_pending`` without bound — a late response to a pruned
        id is dropped by the reader, harmless)."""
        with self._lock:
            if self._closed:
                raise BackendUnavailableError(
                    "edge connection is closed")
            req_id = self._next_id
            self._next_id += 1
        # Encode BEFORE registering: same orphaned-future rule as
        # submit_bytes.
        wire = encode(req_id)
        fut = ServeFuture()
        with self._lock:
            if self._closed:
                raise BackendUnavailableError(
                    "edge connection is closed")
            self._pending[req_id] = fut
        try:
            with self._send_lock:
                if self._tags is not None:
                    fire("net.partition", *self._tags)
                # dcflint: disable=blocking-under-lock _send_lock exists
                # precisely to serialize whole-frame socket writes —
                # interleaved partial frames from two submitting threads
                # would corrupt the stream for every request in flight.
                # It guards no other state and is never nested inside
                # another lock, so contenders wait on peer I/O by design.
                self._io.sendall(wire)
        except OSError as e:
            err = BackendUnavailableError(
                f"edge connection lost on send: {e}")
            self._fail_pending(err)
            raise err from e
        try:
            return fut.result(timeout)
        except TimeoutError:
            with self._lock:
                self._pending.pop(req_id, None)
            raise

    def ping(self, timeout: float | None = None,
             epoch: int = 0) -> bool:
        """One PING round trip (the health prober's liveness
        probe).  Returns True, or raises — transport death typed
        ``BackendUnavailableError``, an unanswered probe the builtin
        ``TimeoutError``, a stale fenced probe the typed
        ``RingEpochError`` (``epoch`` is the prober's ring
        epoch; 0 = unfenced liveness only)."""
        self._roundtrip(lambda rid: encode_ping(rid, epoch), timeout)
        return True

    def ping_epoch(self, timeout: float | None = None,
                   epoch: int = 0) -> int:
        """PING returning the PEER's current ring epoch (the PONG
        value): how a membership bench checks that the pod converged
        on an epoch over the wire.  Failure modes are ``ping``'s."""
        return int(self._roundtrip(
            lambda rid: encode_ping(rid, epoch), timeout))

    def ping_load(self, timeout: float | None = None,
                  epoch: int = 0) -> tuple:
        """PING asking for the peer's demand signals
        (``want_load``).  Returns ``(peer_epoch, LoadSample | None)`` —
        None when the peer has no load surface (an older shard, or a
        router front): the probe itself still succeeded.  Failure
        modes are ``ping``'s."""
        out = self._roundtrip(
            lambda rid: encode_ping(rid, epoch, want_load=True),
            timeout)
        if isinstance(out, tuple):
            value, load = out
            return int(value), load
        return int(out), None

    def register_frame(self, key_id: str, frame, generation: int = 0,
                       proto: bool = False,
                       timeout: float | None = None,
                       epoch: int = 0) -> int:
        """Forward one DCFK frame for registration.
        ``generation=0`` mints at the receiver (owner registration);
        ``generation>0`` is the fenced replica apply — a receiver
        already at or past that generation raises the real
        ``StaleStateError`` here (``E_STALE``).  ``epoch`` fences the
        registration against membership staleness (``E_EPOCH``,
        0 = unfenced).  Returns the generation the key is
        registered under."""
        return int(self._roundtrip(
            lambda rid: encode_register(rid, key_id, frame,
                                        generation, proto, epoch),
            timeout))

    def pull_digest(self, timeout: float | None = None) -> dict:
        """The peer's live ``{key_id: generation}`` registration
        digest (anti-entropy, mode 1 — no frame bytes move)."""
        entries = self._roundtrip(
            lambda rid: encode_digest(rid, {}, mode=1), timeout)
        return {k: g for k, g, _p, _f in entries}

    def sync_newer(self, digest: dict,
                   timeout: float | None = None) -> list:
        """Anti-entropy pull (mode 0): send ``digest`` and receive
        ``(key_id, generation, proto, frame)`` entries for every key
        the peer holds at a STRICTLY newer generation."""
        return self._roundtrip(
            lambda rid: encode_digest(rid, dict(digest), mode=0),
            timeout)

    def evaluate(self, key_id: str, xs, b: int = 0,
                 deadline_ms: float | None = None,
                 timeout: float | None = None,
                 priority=None) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(key_id, xs, b, deadline_ms,
                           priority).result(timeout)

    # -- the reader ----------------------------------------------------

    def _recv_into(self, view: memoryview) -> int:
        got = 0
        while got < len(view):
            n = self._io.recv_into(view[got:], len(view) - got)
            if n == 0:
                return got
            got += n
        return got

    def _read_loop(self) -> None:
        try:
            while True:
                prefix = bytearray(_PREFIX.size)
                if self._recv_into(memoryview(prefix)) < _PREFIX.size:
                    break  # server hung up
                (body_len,) = _PREFIX.unpack(prefix)
                if not _BODY_MIN + _CRC.size <= body_len \
                        <= self.max_frame_bytes:
                    raise KeyFormatError(
                        f"length prefix {body_len} is not a frame "
                        f"(bound {self.max_frame_bytes})")
                body = bytearray(body_len)
                if self._recv_into(memoryview(body)) < body_len:
                    break  # mid-frame EOF: fail pending below
                kind, req_id, *rest = decode_response(body)
                # Claim the future under the lock: an unlocked pop could race _fail_pending's
                # swap-and-fail — both sides claiming the same future,
                # one completing it with a result while the other
                # fails it.  Holding _lock makes exactly one claimant
                # win per future.
                with self._lock:
                    fut = self._pending.pop(req_id, None)
                if kind in ("share", "pong", "sync"):
                    if fut is not None:
                        fut.set_result(rest[0])
                elif fut is not None:
                    code, retry, msg = rest
                    fut.set_exception(_raise_wire(code, retry, msg))
                elif req_id == 0:
                    # A connection-level error frame: the server is
                    # about to hang up; every pending request dies
                    # with the typed cause.
                    code, retry, msg = rest
                    self._fail_pending(_raise_wire(code, retry, msg))
        except Exception as e:  # fallback-ok: the reader must fail
            # every pending future on ANY teardown (socket error,
            # mangled frame) instead of leaving waiters hanging.
            self._fail_pending(BackendUnavailableError(
                f"edge connection lost: {type(e).__name__}: {e}"))
            return
        finally:
            self._fail_pending(BackendUnavailableError(
                "edge connection closed"))

    @property
    def closed(self) -> bool:
        """True once the connection is dead (peer/server hung up, a
        wire error, or ``close()``): pending futures have been failed
        typed and further ``submit`` calls raise.  The reconnect
        signal for pooled clients — a request-level typed failure
        (deadline, shed, breaker) leaves the connection OPEN and this
        False."""
        # dcflint: disable=guarded-by monitoring snapshot: one atomic
        # bool read; submit/roundtrip re-check under _lock before
        # registering a future
        return self._closed

    def _fail_pending(self, error: BaseException) -> None:
        with self._lock:
            self._closed = True
            pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(error)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass  # already gone
        self._sock.close()
        self._reader.join(5.0)

    def __enter__(self) -> "EdgeClient":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class EdgeClientPool:
    """A bounded, reconnecting pool of ``EdgeClient`` connections to
    ONE target: the reusable transport the pod router forwards through
    (and the smoke's edge and pod legs drive).

    Semantics:

    * at most ``size`` live connections, leased round-robin — a lease
      prefers a live slot and only DIALS when the slot it lands on is
      empty or its client reports ``closed`` (the reconnect signal:
      transport death fails every pending future typed and
      latches ``closed``; request-level typed failures leave the
      connection open and the pool alone);
    * dial failures back off exponentially on the INJECTABLE clock
      (``reconnect_backoff_s`` doubling up to ``max_backoff_s``) —
      while the target stays dark every lease fails typed
      ``BackendUnavailableError`` immediately, without burning a
      connect timeout per request; the first successful dial resets
      the backoff;
    * no internal request retry: a submit that fails is the CALLER's
      typed outcome (the router's failover policy decides what happens
      next — the transport must not make that call for it).

    ``reconnects``/``dials`` are plain counters the benches read
    (``reconnects`` counts dials that REPLACED a dead client, i.e. the
    reconnect stat).  Thread-safe.
    """

    def __init__(self, host: str, port: int, *, n_bytes: int,
                 tenant: str = "", size: int = 2, clock=monotonic,
                 connect_timeout: float = 5.0,
                 reconnect_backoff_s: float = 0.05,
                 max_backoff_s: float = 2.0,
                 max_frame_bytes: int = 256 << 20, tls: bool = False,
                 tls_ca: str = "", tls_cert: str = "",
                 tls_key: str = "", tags: tuple | None = None):
        if size < 1:
            # api-edge: pool config contract
            raise ValueError(f"pool size must be >= 1, got {size}")
        if reconnect_backoff_s <= 0 or max_backoff_s < reconnect_backoff_s:
            # api-edge: pool config contract — a zero base would make
            # "dark" unrepresentable and hammer a dead target
            raise ValueError(
                f"need 0 < reconnect_backoff_s <= max_backoff_s, got "
                f"{reconnect_backoff_s}/{max_backoff_s}")
        self.host, self.port = host, int(port)
        self.n_bytes = int(n_bytes)
        self.tenant = tenant
        self.size = int(size)
        self._clock = clock
        self._connect_timeout = float(connect_timeout)
        self._base_backoff = float(reconnect_backoff_s)
        self._max_backoff = float(max_backoff_s)
        self._client_kwargs = dict(
            n_bytes=self.n_bytes, tenant=tenant,
            connect_timeout=self._connect_timeout,
            max_frame_bytes=max_frame_bytes, tls=tls, tls_ca=tls_ca,
            tls_cert=tls_cert, tls_key=tls_key, tags=tags)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._slots: list[EdgeClient | None] = [None] * self.size
        # guarded-by: _lock
        self._rr = 0
        # guarded-by: _lock
        self._backoff = 0.0
        # guarded-by: _lock
        self._dark_until: float | None = None
        # guarded-by: _lock
        self._closed = False
        self.reconnects = 0  # dials that replaced a dead client
        self.dials = 0       # every successful connect

    def _lease(self) -> EdgeClient:
        with self._lock:
            if self._closed:
                raise BackendUnavailableError(
                    f"pool to {self.host}:{self.port} is closed")
            # One full round-robin scan for a LIVE slot first: a dead
            # slot must not force a dial while healthy connections sit
            # idle beside it.
            for _ in range(self.size):
                i = self._rr
                self._rr = (self._rr + 1) % self.size
                c = self._slots[i]
                if c is not None and not c.closed:
                    return c
            # Every slot is empty or dead: dial into the current slot,
            # honoring the dark-target backoff on the injectable clock.
            now = self._clock()
            if self._dark_until is not None and now < self._dark_until:
                raise BackendUnavailableError(
                    f"target {self.host}:{self.port} is dark; next "
                    f"dial in {self._dark_until - now:.3f}s "
                    "(reconnect backoff)")
            i = self._rr
            self._rr = (self._rr + 1) % self.size
            replacing = self._slots[i] is not None
            try:
                fresh = EdgeClient(self.host, self.port,
                                   **self._client_kwargs)
            except OSError as e:
                self._backoff = min(
                    max(2 * self._backoff, self._base_backoff),
                    self._max_backoff)
                self._dark_until = now + self._backoff
                raise BackendUnavailableError(
                    f"cannot connect to {self.host}:{self.port} "
                    f"(backing off {self._backoff:.3f}s): {e}") from e
            self._backoff = 0.0
            self._dark_until = None
            self._slots[i] = fresh
            self.dials += 1
            if replacing:
                self.reconnects += 1
            return fresh

    def submit(self, key_id: str, xs, b: int = 0,
               deadline_ms: float | None = None,
               priority=None) -> ServeFuture:
        return self._lease().submit(key_id, xs, b=b,
                                    deadline_ms=deadline_ms,
                                    priority=priority)

    def submit_bytes(self, key_id: str, data, m: int | None = None,
                     b: int = 0, deadline_ms: float | None = None,
                     priority=None, epoch: int = 0) -> ServeFuture:
        return self._lease().submit_bytes(key_id, data, m=m, b=b,
                                          deadline_ms=deadline_ms,
                                          priority=priority,
                                          epoch=epoch)

    def evaluate(self, key_id: str, xs, b: int = 0,
                 deadline_ms: float | None = None,
                 timeout: float | None = None,
                 priority=None) -> np.ndarray:
        return self.submit(key_id, xs, b, deadline_ms,
                           priority).result(timeout)

    # -- control frames (the health/replication surface) ---------------

    def ping(self, timeout: float | None = None,
             epoch: int = 0) -> bool:
        """One PING round trip through a leased connection — the
        health prober's probe.  While the target is dark the lease
        fails typed inside the backoff without dialing, so probe
        frequency against a dead host is bounded by ``max_backoff_s``
        (recovery detection is therefore at most one backoff late —
        and the UP transition clamps the backoff so REQUESTS never
        wait it out; see ``reset_backoff``)."""
        return self._lease().ping(timeout, epoch=epoch)

    def ping_epoch(self, timeout: float | None = None,
                   epoch: int = 0) -> int:
        """``EdgeClient.ping_epoch`` through a leased connection."""
        return self._lease().ping_epoch(timeout, epoch=epoch)

    def ping_load(self, timeout: float | None = None,
                  epoch: int = 0) -> tuple:
        """``EdgeClient.ping_load`` through a leased connection — the
        health prober's load-sampling probe."""
        return self._lease().ping_load(timeout, epoch=epoch)

    def register_frame(self, key_id: str, frame, generation: int = 0,
                       proto: bool = False,
                       timeout: float | None = None,
                       epoch: int = 0) -> int:
        return self._lease().register_frame(key_id, frame, generation,
                                            proto, timeout,
                                            epoch=epoch)

    def pull_digest(self, timeout: float | None = None) -> dict:
        return self._lease().pull_digest(timeout)

    def sync_newer(self, digest: dict,
                   timeout: float | None = None) -> list:
        return self._lease().sync_newer(digest, timeout)

    def reset_backoff(self) -> None:
        """Clamp the dial backoff to zero: the
        health prober just CONFIRMED the target is up, so a pool that
        accumulated the full exponential backoff during a long outage
        must not keep failing leases fast until it drains — the next
        lease dials immediately."""
        with self._lock:
            self._backoff = 0.0
            self._dark_until = None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            slots, self._slots = self._slots, [None] * self.size
        for c in slots:
            if c is not None:
                c.close()

    def __enter__(self) -> "EdgeClientPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
