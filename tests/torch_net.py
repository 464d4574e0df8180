"""Shared pieces of the port's network-tier tests (``test_torch_edge``,
``test_torch_pod``, ``test_torch_selfheal``, ``test_torch_mesh``).

``PORT`` and ``REF`` bundle one package's serving classes, so a test
can build a shard, a router or a client from either side and mix them:
a port ``EdgeServer`` behind a ``dcf_tpu`` router, a ``dcf_tpu`` shard
behind a port router.  Port shards serve from ``walk`` (B1's plain
version, ``device="cpu"``); ``dcf_tpu`` shards from its ``numpy``
facade.  Every bundle is made by the port's host keygen and crosses to
``dcf_tpu`` through its DCFK frame; every share is held against the
port's numpy oracle, party by party.  Every wait is bounded."""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass

import numpy as np

import dcf_tpu.serve as jserve
import dcf_tpu.serve.edge as jedge
from dcf_tpu import Dcf as JDcf
from dcf_tpu.keys import KeyBundle as JKeyBundle
from dcf_tpu.protocols import ProtocolBundle as JProtocolBundle
from dcf_tpu.protocols.dpf import DpfBundle as JDpfBundle
from dcf_tpu.testing import faults as jfaults

import dcf_tpu_torch.serve as pserve
import dcf_tpu_torch.serve.edge as pedge
from dcf_tpu_torch import Dcf
from dcf_tpu_torch.backends.numpy_backend import eval_batch_np
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.testing import faults as pfaults

NB, LAM = 2, 16
#: 18 cipher keys: lam >= 32 uses ciphers 0 and 17.
CK = [bytes((5 * i + 3 * j) % 256 for j in range(32)) for i in range(18)]
PRG = HirosePrgNp(LAM, CK)
#: Bounded waits: no socket test may wait on the clock unbounded.
WAIT_S = 30.0


@dataclass(frozen=True)
class Pkg:
    """One package's serving classes."""

    name: str
    serve: object   # the ``serve`` package
    edge: object    # ``serve.edge``
    faults: object  # ``testing.faults``

    def dcf(self):
        if self.name == "port":
            return Dcf(NB, LAM, CK, backend="walk", device="cpu")
        return JDcf(NB, LAM, CK, backend="numpy")

    def bundle(self, kb):
        """``kb`` (a port bundle) as this package's object, through its
        DCFK frame."""
        if self.name == "port":
            return kb
        if hasattr(kb, "combine_masks"):
            return JProtocolBundle.from_bytes(kb.to_bytes())
        if getattr(kb, "WIRE_PROTO", 0) == 2:
            return JDpfBundle.from_bytes(kb.to_bytes())
        return JKeyBundle.from_bytes(kb.to_bytes())


PORT = Pkg("port", pserve, pedge, pfaults)
REF = Pkg("dcf_tpu", jserve, jedge, jfaults)
PKGS = {"port": PORT, "dcf_tpu": REF}


def make_bundle(rng, group: str = "xor", alpha=(0x80, 0x00)):
    """One single-key port bundle (host keygen) with a known alpha."""
    fac = Dcf(NB, LAM, CK, backend="numpy", device="cpu")
    alphas = np.array([alpha], np.uint8)
    return fac.gen(alphas, rng.integers(0, 256, (1, LAM), dtype=np.uint8),
                   rng=rng, group=group, device=False)


def points(rng, m: int, alpha=(0x80, 0x00)) -> np.ndarray:
    """``m`` random points with x = alpha first."""
    xs = rng.integers(0, 256, (m, NB), dtype=np.uint8)
    xs[0] = alpha
    return xs


def oracle(kb, b: int, xs) -> np.ndarray:
    return eval_batch_np(PRG, b, kb.for_party(b), xs)


def assert_shares(get, kb, xs) -> None:
    """``get(b)`` is party b's share: each must equal the oracle's."""
    for b in (0, 1):
        y = get(b)
        want = oracle(kb, b, xs)
        assert y.dtype == np.uint8 and np.array_equal(y, want), b


def service(pkg: Pkg, bundles=None, *, start=True, clock=None, **knobs):
    knobs.setdefault("max_batch", 32)
    knobs.setdefault("max_delay_ms", 1.0)
    dcf = pkg.dcf()
    if clock is None:
        svc = dcf.serve(**knobs)
    else:
        svc = pkg.serve.DcfService(dcf, pkg.serve.ServeConfig(**knobs),
                                   clock=clock)
    for name, kb in (bundles or {}).items():
        svc.register_key(name, pkg.bundle(kb))
    if start:
        svc.start()
    return svc


def wait_for(pred, what: str, timeout: float = WAIT_S) -> None:
    """Poll ``pred`` until true, failing after ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def read_frames(sock, decode) -> list:
    """Drain a raw socket to EOF and strictly decode every frame on it
    (a reset counts as EOF: the server hanging up on a mangled frame)."""
    data = b""
    while True:
        try:
            chunk = sock.recv(1 << 16)
        except (ConnectionResetError, socket.timeout):
            break
        if not chunk:
            break
        data += chunk
    frames, off = [], 0
    while off < len(data):
        (body_len,) = struct.unpack_from("<I", data, off)
        frames.append(decode(data[off + 4:off + 4 + body_len]))
        off += 4 + body_len
    return frames


def raw_exchange(addr, payload: bytes, decode) -> list:
    s = socket.create_connection(addr, timeout=WAIT_S)
    try:
        s.sendall(payload)
        s.shutdown(socket.SHUT_WR)
        s.settimeout(WAIT_S)
        return read_frames(s, decode)
    finally:
        s.close()


class Pod:
    """``n`` in-process shards (a ``DcfService`` + ``EdgeServer`` over
    loopback TCP each, of package ``shard_pkg``) behind a router of
    package ``router_pkg``.  ``bundles`` register on each key's owner and
    replica directly (the warm replica a durable store gives)."""

    def __init__(self, shard_pkg: Pkg, router_pkg: Pkg, n: int = 3,
                 bundles=None, router_kw=None, service_kw=None):
        self.shard_pkg, self.router_pkg = shard_pkg, router_pkg
        self.svcs, self.servers, specs = [], [], []
        for i in range(n):
            svc = service(shard_pkg, **(service_kw or {}))
            srv = shard_pkg.edge.EdgeServer(svc).start()
            self.svcs.append(svc)
            self.servers.append(srv)
            specs.append(router_pkg.serve.ShardSpec(f"shard-{i}",
                                                    *srv.address))
        self.map = router_pkg.serve.ShardMap(specs)
        self._index = {s.host_id: i for i, s in enumerate(specs)}
        for name, kb in (bundles or {}).items():
            for spec in self.map.placement(name, replicas=1):
                self.svc_of(spec.host_id).register_key(
                    name, shard_pkg.bundle(kb))
        kw = dict(probe_fail_n=2, probe_recover_m=2,
                  reconnect_backoff_s=0.01, max_backoff_s=0.05,
                  probe_interval_s=0.05)
        kw.update(router_kw or {})
        self.router = router_pkg.serve.DcfRouter(self.map, n_bytes=NB,
                                                 **kw)

    def svc_of(self, host_id):
        return self.svcs[self._index[host_id]]

    def key_owned_by(self, host_id, prefix="pod-key"):
        for n in range(10_000):
            name = f"{prefix}-{n}"
            if self.map.owner(name).host_id == host_id:
                return name
        raise AssertionError(f"no key of {host_id} found")

    def kill(self, host_id):
        """A shard's death: its edge torn down, its service abandoned."""
        i = self._index[host_id]
        self.servers[i].close()
        self.svcs[i].close(drain=False)

    def pump_until(self, host_id, state, rounds=200):
        for _ in range(rounds):
            if self.router.health.pump()[host_id] == state:
                return True
            time.sleep(0.02)
        return False

    def close(self):
        self.router.close()
        for srv in self.servers:
            srv.close()
        for svc in self.svcs:
            try:
                svc.close(drain=False)
            except Exception:  # fallback-ok: teardown of a killed shard
                pass


def serve_in_threads(fn, n: int) -> list:
    """Run ``fn(i)`` on ``n`` threads; return their results in order
    (re-raising the first failure)."""
    out = [None] * n
    errs = []

    def run(i):
        try:
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a client thread hung"
    if errs:
        raise errs[0]
    return out
