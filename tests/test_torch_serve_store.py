"""The port's durable key store against ``dcf_tpu``'s, in both directions.

A store directory written by the port's ``serve.store.KeyStore`` is
restored by ``dcf_tpu``'s, and the reverse, with the same frames (plain
XOR v2, additive v4, MIC ``ProtocolBundle`` and DPF frames) and the same
generations; the same sequence of puts and deletes leaves byte-identical
manifests and frame files in both packages.  Then the port alone: torn
writes and corrupt frames are quarantined typed, a crash before the
rename keeps the old state, the monotonic-generation guard,
``DcfService.restore_keys`` after a close, a fresh process's generation
floor, and a restored service serving byte-identical shares.
Tolerance: exact byte equality."""

import os

import numpy as np
import pytest

from dcf_tpu import Dcf as JDcf
from dcf_tpu.keys import KeyBundle as JKeyBundle
from dcf_tpu.protocols import ProtocolBundle as JProtocolBundle
from dcf_tpu.protocols import decode_proto_frame as jdecode
from dcf_tpu.serve import DcfService as JDcfService
from dcf_tpu.serve import ServeConfig as JServeConfig
from dcf_tpu.serve.store import KeyStore as JKeyStore
from dcf_tpu.testing import faults as jfaults

from dcf_tpu_torch import Bound, Dcf
from dcf_tpu_torch.errors import (
    KeyFormatError,
    KeyQuarantinedError,
    ShapeError,
)
from dcf_tpu_torch.serve import DcfService, KeyStore, ServeConfig
from dcf_tpu_torch.serve.store import MANIFEST_NAME
from dcf_tpu_torch.testing import faults
from dcf_tpu_torch.testing.faults import FakeClock
from tests.torch_threads import one_torch_thread  # noqa: F401

NB, LAM = 2, 16
CK = [bytes((7 * i + j) % 256 for j in range(32)) for i in range(18)]


def facade(backend="numpy", nb=NB, lam=LAM) -> Dcf:
    return Dcf(nb, lam, CK, backend=backend, device="cpu")


def material(rng) -> dict:
    """key_id -> (bundle, protocol) of every frame kind the store holds."""
    fac = facade()
    out = {}
    for name, group, bnd in (("xor-lt", "xor", Bound.LT_BETA),
                             ("add16-gt", "add16", Bound.GT_BETA)):
        out[name] = (fac.gen(rng.integers(0, 256, (2, NB), dtype=np.uint8),
                             rng.integers(0, 256, (2, LAM), dtype=np.uint8),
                             bound=bnd, rng=rng, group=group,
                             device=False), None)
    pb = fac.mic([(3, 900), (40000, 1 << 16)],
                 rng.integers(0, 256, (2, LAM), dtype=np.uint8), rng=rng)
    out["mic"] = (pb.keys, pb)
    dpf = Dcf(1, 32, CK, device="cpu").dpf(
        np.array([[9], [200]], np.uint8), rng=rng, device=False)
    out["dpf/q"] = (dpf, None)
    return out


def jax_twins(items) -> dict:
    """The same key material as ``dcf_tpu`` objects, through the frames."""
    out = {}
    for key_id, (kb, pb) in items.items():
        if pb is not None:
            jpb = JProtocolBundle.from_bytes(pb.to_bytes())
            out[key_id] = (jpb.keys, jpb)
        elif hasattr(kb, "WIRE_PROTO"):
            out[key_id] = (jdecode(kb.to_bytes()), None)
        else:
            out[key_id] = (JKeyBundle.from_bytes(kb.to_bytes()), None)
    return out


def _frames(root) -> dict:
    return {f: open(os.path.join(root, f), "rb").read()
            for f in sorted(os.listdir(root))}


def _write(store_cls, root, items) -> None:
    store = store_cls(str(root))
    for gen, (key_id, (kb, pb)) in enumerate(sorted(items.items()), 1):
        store.put(key_id, kb, protocol=pb, generation=gen)
    store.put("xor-lt", items["xor-lt"][0], generation=9)  # a hot swap
    store.delete("dpf/q")


@pytest.mark.parametrize("direction", ["port->dcf_tpu", "dcf_tpu->port"])
def test_store_restores_across_packages(direction, tmp_path):
    rng = np.random.default_rng(1)
    items = material(rng)
    writer, reader = ((KeyStore, JKeyStore) if direction == "port->dcf_tpu"
                      else (JKeyStore, KeyStore))
    # dcf_tpu's store writes its own objects
    _write(writer, tmp_path / "w",
           jax_twins(items) if writer is JKeyStore else items)
    store = reader(str(tmp_path / "w"))
    loaded, quarantined = store.load_all()
    assert quarantined == {}
    assert sorted(loaded) == ["add16-gt", "mic", "xor-lt"]
    assert store.digest() == {"add16-gt": 1, "mic": 3, "xor-lt": 9}
    for key_id, (kb, pb, _gen) in loaded.items():
        want_kb, want_pb = items[key_id]
        assert kb.to_bytes() == want_kb.to_bytes()
        if want_pb is not None:
            assert pb.to_bytes() == want_pb.to_bytes()
    assert store.max_generation() == 9


def test_same_operations_give_identical_store_bytes(tmp_path):
    rng = np.random.default_rng(2)
    items = material(rng)
    _write(KeyStore, tmp_path / "p", items)
    _write(JKeyStore, tmp_path / "j", jax_twins(items))
    mine, theirs = _frames(tmp_path / "p"), _frames(tmp_path / "j")
    assert mine == theirs
    assert MANIFEST_NAME in mine and len(mine) == 4


def test_torn_write_and_corrupt_frames_quarantined_typed(tmp_path):
    rng = np.random.default_rng(3)
    items = material(rng)
    store = KeyStore(str(tmp_path))
    store.put("good", items["xor-lt"][0], generation=1)
    with faults.inject("store.write", handler=faults.torn_write(25)):
        store.put("torn", items["add16-gt"][0], generation=2)
    store.put("flipped", items["mic"][0], protocol=items["mic"][1],
              generation=3)
    path = os.path.join(store.root, store._read_manifest()["flipped"]["file"])
    data = open(path, "rb").read()
    open(path, "wb").write(faults.corrupt(data, len(data) // 2))
    with pytest.raises(KeyQuarantinedError, match="torn"):
        store.load("torn")
    loaded, quarantined = store.load_all()
    assert sorted(loaded) == ["good"]
    assert sorted(quarantined) == ["flipped"]
    with pytest.raises(ValueError, match="no durable frame"):
        store.load("torn")
    assert len(store.quarantined_files()) == 2
    assert store._metrics.snapshot()["serve_store_quarantined_total"] == 2
    store.put("x", items["xor-lt"][0], generation=4)
    with open(os.path.join(store.root, MANIFEST_NAME), "r+b") as fh:
        fh.seek(12)
        fh.write(b"\xff")
    with pytest.raises(KeyFormatError, match="manifest"):
        store.key_ids()


def test_crash_before_rename_and_monotonic_guard(tmp_path):
    rng = np.random.default_rng(4)
    items = material(rng)
    kb = items["xor-lt"][0]
    store = KeyStore(str(tmp_path))
    store.put("k", kb, generation=5)
    for seam in ("store.write", "store.manifest"):
        with faults.inject(seam, exc=OSError("power cut")):
            with pytest.raises(OSError):
                store.put("k", items["add16-gt"][0], generation=6)
        assert store.generation_of("k") == 5
        assert store.load("k")[0].to_bytes() == kb.to_bytes()
    store.put("k", items["add16-gt"][0], generation=3)  # stale: dropped
    assert store.generation_of("k") == 5
    assert store.sweep_orphans() >= 1  # the crashed publishes' debris
    with pytest.raises(ShapeError):
        store.put("k", kb.for_party(0), generation=7)
    assert oct(os.stat(os.path.join(store.root, MANIFEST_NAME)).st_mode
               & 0o777) == "0o600"


def _svc(dcf, store_dir, clock=None):
    return DcfService(dcf, ServeConfig(store_dir=str(store_dir),
                                       max_batch=32),
                      clock=clock if clock is not None else FakeClock())


def _serve(svc, key_id, xs):
    futs = [svc.submit(key_id, xs, b=b) for b in (0, 1)]
    svc.pump()
    return [f.result(0) for f in futs]


@pytest.mark.parametrize("backend", ["walk", "prefix", "cpu"])
def test_restore_keys_serves_the_same_bytes(backend, tmp_path):
    """Durable registration, close, a new service on the store,
    ``restore_keys``: generations preserved, shares byte-identical."""
    rng = np.random.default_rng(5)
    dcf = facade(backend)
    kb = dcf.gen(rng.integers(0, 256, (1, NB), dtype=np.uint8),
                 rng.integers(0, 256, (1, LAM), dtype=np.uint8), rng=rng)
    pb = dcf.mic([(5, 700), (65000, 30)],
                 rng.integers(0, 256, (2, LAM), dtype=np.uint8), rng=rng)
    xs = rng.integers(0, 256, (21, NB), dtype=np.uint8)
    first = _svc(dcf, tmp_path)
    first.register_key("k", kb, durable=True)
    first.register_key("m", pb, durable=True)
    first.register_key("volatile", kb)
    before = {k: _serve(first, k, xs) for k in ("k", "m")}
    gens = first.replication_digest()
    first.close()
    second = _svc(facade(backend), tmp_path)
    report = second.restore_keys()
    assert report.restored == {"k": gens["k"], "m": gens["m"]}
    assert report.quarantined == {}
    assert second.key_ids() == ["k", "m"]
    for key_id, ys in before.items():
        for y, w in zip(_serve(second, key_id, xs), ys):
            assert np.array_equal(y, w), key_id
    # A post-restore hot swap mints past every restored generation.
    second.register_key("k", kb.for_party(0).__class__(
        s0s=kb.s0s.copy(), cw_s=kb.cw_s, cw_v=kb.cw_v, cw_t=kb.cw_t,
        cw_np1=kb.cw_np1), durable=True)
    assert second.replication_digest()["k"] > max(report.restored.values())


def test_generation_floor_and_jax_restore_of_port_service(tmp_path):
    """A fresh process on an existing store registers durably BEFORE
    restoring: its generation is floored past the manifest's; then
    ``dcf_tpu``'s service restores what the port's wrote, and serves the
    same shares."""
    rng = np.random.default_rng(6)
    dcf = facade("walk")
    keys = [dcf.gen(rng.integers(0, 256, (1, NB), dtype=np.uint8),
                    rng.integers(0, 256, (1, LAM), dtype=np.uint8),
                    rng=rng) for _ in range(3)]
    a = _svc(dcf, tmp_path)
    for i, kb in enumerate(keys[:2]):
        a.register_key(f"k{i}", kb, durable=True)
    a.close()
    b = _svc(facade("walk"), tmp_path)
    b.register_key("k2", keys[2], durable=True)
    assert b.replication_digest()["k2"] == 3
    assert KeyStore(str(tmp_path)).digest() == {"k0": 1, "k1": 2, "k2": 3}
    assert b.restore_keys().restored == {"k0": 1, "k1": 2, "k2": 3}
    with pytest.raises(ValueError, match="store"):
        DcfService(dcf, ServeConfig()).register_key("x", keys[0],
                                                    durable=True)
    jsvc = JDcfService(JDcf(NB, LAM, CK, backend="numpy"),
                       JServeConfig(store_dir=str(tmp_path), max_batch=32),
                       clock=jfaults.FakeClock())
    report = jsvc.restore_keys()
    assert report.restored == {"k0": 1, "k1": 2, "k2": 3}
    xs = rng.integers(0, 256, (11, NB), dtype=np.uint8)
    for key_id in ("k0", "k2"):
        for y, w in zip(_serve(b, key_id, xs), _serve(jsvc, key_id, xs)):
            assert np.array_equal(y, w)
    b.unregister_key("k1")
    assert "k1" not in KeyStore(str(tmp_path)).key_ids()
