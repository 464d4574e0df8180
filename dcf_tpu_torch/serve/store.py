"""Durable key store: DCFK frames on disk + a CRC'd manifest.

Counterpart of ``dcf_tpu/serve/store.py``, line for line, over the
port's DCFK codec: the manifest bytes, frame names and frames are the
same, so a store directory written by either package restores in the
other (``tests/test_torch_serve_store.py``).

DCF keys are per-session cryptographic assets whose generation is the
expensive offline phase (Boyle et al.) — without a store a
``DcfService`` restart forgets every registered bundle, forcing a full
regen.  This module is the process-lifecycle half of the resilience story: keys
registered ``durable=True`` survive a crash, and
``KeyRegistry.restore(store)`` brings them back with their generations
intact, so a restarted host serves the same key shard it died with and
re-keygens nothing.

On-disk layout (one directory, created ``0o700``)::

    <root>/
      MANIFEST.dcfm            the CRC'd manifest (layout below)
      <digest>-g<gen>.dcfk     one DCFK v2/v3 frame per durable key
      <...>.quarantined-<n>    frames set aside by the quarantine path

* **Frames** are the existing wire formats verbatim — ``KeyBundle``
  v2 for plain keys, ``ProtocolBundle`` v3 for protocol keys — so the
  store inherits their CRC32 trailers and strict field-naming decode;
  there is exactly one codec per format in the repo.  The filename
  carries a digest of the key id plus the GENERATION, so a hot-swap
  writes a NEW file and flips the manifest afterwards: no crash window
  can pair new key bytes with an old generation (the aliasing the registry's
  snapshot guard exists to prevent, extended across process death).
* **Every publish is write-fsync-rename**: the payload goes to a temp
  file in the same directory (``os.open`` with ``0o600`` — key frames
  on disk are key material), is flushed and fsynced, and only then
  atomically renamed over the destination; the directory is fsynced
  after.  A crash at ANY point leaves either the old state or the new
  state, never a torn visible file.  ``put_many``/``delete_many``
  batch the manifest side: every frame in a refill batch is
  still published individually, but ONE manifest flip makes the whole
  batch visible — the key factory's amortization of the fsync cost
  without giving up the crash guarantee (a kill mid-batch leaves the
  previous manifest and some orphan frames, never a torn pool).  The
  ``store.write`` / ``store.manifest`` fault seams fire between fsync
  and rename (``testing.faults``: raise = crash pre-publish, ``torn_write`` =
  a partial write made durable for the quarantine path to find).
* **The manifest** maps ``key_id -> (file, generation, proto flag,
  party count)`` and is itself framed: magic ``DCFM``, version, exact
  body length, JSON body (sorted keys — deterministic bytes for a
  given state), CRC32 trailer.  Any mutation dies with a typed
  ``KeyFormatError`` naming the field — a store whose index cannot be
  trusted must fail loudly, not serve a guess.
* **Quarantine**: a frame that fails validation at read time is set
  ASIDE, not skipped — the file is renamed ``.quarantined-<n>``, its
  manifest entry dropped, ``serve_store_quarantined_total`` bumped,
  and ``KeyQuarantinedError`` raised (cause-chained to the underlying
  ``KeyFormatError``).  ``KeyRegistry.restore`` catches it PER KEY:
  one damaged frame is never silently skipped and never fatal to the
  other keys.

Thread safety: one lock per store serializes every mutation (the
write-through path runs on whatever thread calls ``register_key``).
Determinism: no clocks, no RNG — file contents are a pure function of
the store's logical state.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field

from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    KeyFormatError,
    KeyQuarantinedError,
    ShapeError,
)
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.serve.metrics import Metrics
from dcf_tpu_torch.testing.faults import fire

__all__ = ["KeyStore", "RestoreReport", "MANIFEST_NAME"]

MANIFEST_NAME = "MANIFEST.dcfm"
_MANIFEST_MAGIC = b"DCFM"
_MANIFEST_VERSION = 1
_MANIFEST_HEADER = "<HI"  # version, body length (after the 4-byte magic)
_MANIFEST_HEADER_SIZE = 4 + struct.calcsize(_MANIFEST_HEADER)
_CRC_SIZE = 4
_FRAME_SUFFIX = ".dcfk"


@dataclass
class RestoreReport:
    """What a warm restart brought back: ``restored`` maps key_id to
    its preserved generation; ``quarantined`` maps key_id to the typed
    failure message of the frame that was set aside; ``repooled``
    maps ``~pool/...`` frame ids to their preserved
    generations — un-claimed key-factory supply routed back into its
    pools by ``DcfService.restore_keys`` instead of the serving
    registry."""

    restored: dict = field(default_factory=dict)
    quarantined: dict = field(default_factory=dict)
    repooled: dict = field(default_factory=dict)

    def __repr__(self) -> str:  # names and counts only, never contents
        return (f"RestoreReport(restored={sorted(self.restored)}, "
                f"quarantined={sorted(self.quarantined)}, "
                f"repooled={sorted(self.repooled)})")


def _frame_name(key_id: str, generation: int) -> str:
    """Deterministic frame filename: a digest of the key id (ids are
    caller-chosen and may contain path separators) plus the generation
    — a hot-swap lands in a NEW file, so no crash window can pair new
    frame bytes with a stale manifest generation."""
    digest = hashlib.sha256(key_id.encode("utf-8")).hexdigest()[:16]
    return f"{digest}-g{int(generation)}{_FRAME_SUFFIX}"


class KeyStore:
    """Durable DCFK frame store under one directory (module docstring).

    ``put``/``delete`` are the write-through surface the service uses;
    ``load`` is the strict read (quarantines on corruption);
    ``key_ids``/``generation_of`` read the manifest.  All operations
    re-read the manifest from disk — the file is the source of truth,
    so two processes taking turns (crash, restart) always see the last
    published state.
    """

    def __init__(self, root: str, *, metrics: Metrics | None = None):
        self.root = str(root)
        self._lock = threading.Lock()
        self._metrics = metrics if metrics is not None else Metrics()
        os.makedirs(self.root, mode=0o700, exist_ok=True)
        m = self._metrics
        self._c_writes = m.counter("serve_store_writes_total")
        self._c_deletes = m.counter("serve_store_deletes_total")
        self._c_quarantined = m.counter("serve_store_quarantined_total")
        self._g_keys = m.gauge("serve_store_keys")
        # A pre-existing store's key count is visible from the first
        # snapshot, not only after the first mutation.
        with self._lock:
            try:
                self._g_keys.set(len(self._read_manifest()))
            except KeyFormatError:
                pass  # surfaced typed on the first real read

    def __repr__(self) -> str:
        return f"KeyStore(root={self.root!r})"

    # -- atomic publish -----------------------------------------------------

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return  # platforms without directory fds: rename still atomic
        try:
            os.fsync(fd)
        except OSError:
            pass  # directory fsync unsupported: best effort
        finally:
            os.close(fd)

    def _publish(self, name: str, data: bytes, seam: str,
                 key_id: str) -> None:
        """Write-fsync-rename ``data`` into ``<root>/<name>``.  The
        temp file is created ``0o600`` (frames are key material) in the
        SAME directory so the rename is atomic on every filesystem."""
        path = os.path.join(self.root, name)
        tmp = path + ".tmp"
        # O_TRUNC, not O_EXCL: a temp file a previous crash left behind
        # must not wedge every later publish of the same name.
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            os.fsync(fh.fileno())
        fire(seam, key_id, tmp)
        os.replace(tmp, path)
        self._fsync_dir()

    # -- manifest codec -----------------------------------------------------

    def _manifest_bytes(self, entries: dict) -> bytes:
        body = json.dumps({"keys": entries}, sort_keys=True,
                          separators=(",", ":")).encode("utf-8")
        head = _MANIFEST_MAGIC + struct.pack(
            _MANIFEST_HEADER, _MANIFEST_VERSION, len(body))
        return head + body + struct.pack("<I", zlib.crc32(head + body))

    def _read_manifest(self) -> dict:
        """Strict manifest decode -> ``{key_id: entry}``; a missing
        manifest is an empty store, anything malformed raises
        ``KeyFormatError`` naming the offending field (the index of a
        key store must be trusted or rejected, never guessed at)."""
        path = os.path.join(self.root, MANIFEST_NAME)
        try:
            with open(path, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            return {}
        if len(data) < _MANIFEST_HEADER_SIZE + _CRC_SIZE:
            raise KeyFormatError(
                f"truncated manifest: {len(data)} bytes, the DCFM "
                f"header + CRC need {_MANIFEST_HEADER_SIZE + _CRC_SIZE}")
        if data[:4] != _MANIFEST_MAGIC:
            raise KeyFormatError(
                f"bad manifest magic: expected {_MANIFEST_MAGIC!r}, "
                f"got {bytes(data[:4])!r}")
        version, body_len = struct.unpack_from(_MANIFEST_HEADER, data, 4)
        if version != _MANIFEST_VERSION:
            raise KeyFormatError(
                f"unsupported manifest version {version} (this reader "
                f"handles {_MANIFEST_VERSION})")
        want = _MANIFEST_HEADER_SIZE + body_len + _CRC_SIZE
        if len(data) != want:
            raise KeyFormatError(
                f"manifest size mismatch: header claims a {body_len}-"
                f"byte body ({want} total), frame is {len(data)} bytes")
        payload_end = len(data) - _CRC_SIZE
        (crc_stored,) = struct.unpack_from("<I", data, payload_end)
        crc_actual = zlib.crc32(data[:payload_end])
        if crc_stored != crc_actual:
            raise KeyFormatError(
                f"manifest crc32 mismatch: trailer records "
                f"{crc_stored:#010x}, frame hashes to {crc_actual:#010x}")
        try:
            doc = json.loads(data[_MANIFEST_HEADER_SIZE:payload_end])
        except ValueError as e:
            raise KeyFormatError(
                f"manifest body is not valid JSON ({e})") from e
        if not isinstance(doc, dict) \
                or not isinstance(doc.get("keys"), dict):
            raise KeyFormatError(
                "manifest body must be an object with a 'keys' map")
        entries = doc["keys"]
        for key_id, ent in entries.items():
            self._check_entry(key_id, ent)
        return entries

    @staticmethod
    def _check_entry(key_id, ent) -> None:
        if not isinstance(key_id, str) or not key_id:
            raise KeyFormatError(
                f"manifest key id must be a non-empty string, "
                f"got {key_id!r}")
        if not isinstance(ent, dict):
            raise KeyFormatError(
                f"manifest entry for {key_id!r} must be an object")
        fname = ent.get("file")
        if not isinstance(fname, str) \
                or fname != os.path.basename(fname) \
                or not fname.endswith(_FRAME_SUFFIX):
            # A path-traversing or alien filename in a tampered
            # manifest must die here, not open an arbitrary path.
            raise KeyFormatError(
                f"manifest entry for {key_id!r} has a bad 'file' field: "
                f"{fname!r} (want a bare *{_FRAME_SUFFIX} name)")
        gen = ent.get("generation")
        if not isinstance(gen, int) or isinstance(gen, bool) or gen < 0:
            raise KeyFormatError(
                f"manifest entry for {key_id!r} has a bad 'generation' "
                f"field: {gen!r} (want an int >= 0)")
        if not isinstance(ent.get("proto"), bool):
            raise KeyFormatError(
                f"manifest entry for {key_id!r} has a bad 'proto' "
                f"field: {ent.get('proto')!r} (want a bool)")
        if ent.get("parties") not in (1, 2):
            raise KeyFormatError(
                f"manifest entry for {key_id!r} has a bad 'parties' "
                f"field: {ent.get('parties')!r} (want 1 or 2)")

    def _write_manifest(self, entries: dict) -> None:
        self._publish(MANIFEST_NAME, self._manifest_bytes(entries),
                      "store.manifest", "")
        self._g_keys.set(len(entries))

    # -- the write-through surface ------------------------------------------

    def put(self, key_id: str, bundle: KeyBundle, protocol=None,
            generation: int = 0, drop=()) -> None:
        """Persist ``key_id``'s frame durably (frame first, manifest
        second — a crash between the two leaves the previous manifest
        pointing at the previous file: consistent old state, one
        orphan frame for ``sweep_orphans``).  ``protocol``: the
        ``ProtocolBundle`` wrapper when the key is a protocol key (the
        v3 frame then carries the combine masks; ``bundle`` must be
        its inner ``KeyBundle``).  ``generation``: the registry
        generation the frame is published under — restore hands it
        back verbatim.

        ``drop``: key ids whose entries are removed in the
        SAME manifest flip that publishes this one — the durable pool
        CLAIM path folds the spent ``~pool/...`` frame's delete into
        the session key's publish, so no crash window exists in which
        both the claimed pool frame and its durable session copy are
        manifest-visible (restoring both would hand the same key
        material to a second session — cross-session reuse, not a
        hygiene cost).  Unknown ids are ignored."""
        if bundle.s0s.shape[1] != 2:
            raise ShapeError(
                f"put({key_id!r}) wants the full two-party bundle — a "
                "restored service serves both parties")
        if protocol is not None and protocol.keys is not bundle:
            raise ShapeError(
                f"put({key_id!r}): protocol.keys is not the bundle "
                "being persisted — the frame would desync from the "
                "registry entry")
        if not key_id:
            # api-edge: store naming contract at the serve edge
            raise ValueError("key_id must be a non-empty string")
        payload = (protocol.to_bytes() if protocol is not None
                   else bundle.to_bytes())
        # A self-describing protocol frame (DpfBundle carries
        # WIRE_PROTO) is flagged proto in the manifest even without a
        # wrapper, so load() routes it through the proto dispatcher.
        is_proto = (protocol is not None
                    or getattr(bundle, "WIRE_PROTO", 0) != 0)
        fname = _frame_name(key_id, generation)
        with self._lock:
            entries = self._read_manifest()
            prev = entries.get(key_id)
            if prev is not None and prev["generation"] > generation:
                # A stale write-through: two concurrent durable
                # hot-swaps of the same key serialize on this lock in
                # arbitrary order, and persisting the OLDER generation
                # last would silently roll the key back at the next
                # restore.  Generations are the registry's total order
                # per key — the newest durable publish wins, always.
                return
            dropped = [entries.pop(d) for d in dict.fromkeys(drop)
                       if d != key_id and d in entries]
            self._publish(fname, payload, "store.write", key_id)
            entries[key_id] = {
                "file": fname,
                "generation": int(generation),
                "proto": is_proto,
                "parties": 2,
            }
            self._write_manifest(entries)
            self._c_writes.inc()
            if prev is not None and prev["file"] != fname:
                self._unlink_quiet(prev["file"])
            for ent in dropped:
                if ent["file"] != fname:
                    self._unlink_quiet(ent["file"])
                    self._c_deletes.inc()

    def put_many(self, items) -> int:
        """Batched durable publish: persist every ``(key_id, bundle,
        protocol, generation)`` in ``items`` with ONE manifest flip — each
        frame is still written write-fsync-rename individually (the
        ``store.write`` seam fires per frame), but the batch becomes visible
        atomically when the single manifest publish renames into place.  A
        crash anywhere between the first frame write and the manifest flip
        leaves the PREVIOUS manifest intact: old state, a few orphan frames for
        ``sweep_orphans`` — never a torn pool.  Per-key semantics match ``put``
        exactly (two-party contract, protocol desync check, the
        monotonic-generation guard: a stale item is skipped, not rolled back).
        Returns the number of keys actually published (stale items
        excluded)."""
        staged = []
        for key_id, bundle, protocol, generation in items:
            if bundle.s0s.shape[1] != 2:
                raise ShapeError(
                    f"put_many({key_id!r}) wants the full two-party "
                    "bundle — a restored service serves both parties")
            if protocol is not None and protocol.keys is not bundle:
                raise ShapeError(
                    f"put_many({key_id!r}): protocol.keys is not the "
                    "bundle being persisted — the frame would desync "
                    "from the registry entry")
            if not key_id:
                # api-edge: store naming contract at the serve edge
                raise ValueError("key_id must be a non-empty string")
            payload = (protocol.to_bytes() if protocol is not None
                       else bundle.to_bytes())
            is_proto = (protocol is not None
                        or getattr(bundle, "WIRE_PROTO", 0) != 0)
            staged.append((key_id, payload, is_proto, int(generation)))
        if not staged:
            return 0
        with self._lock:
            entries = self._read_manifest()
            replaced, published = [], 0
            for key_id, payload, is_proto, generation in staged:
                prev = entries.get(key_id)
                if prev is not None and prev["generation"] > generation:
                    continue  # the monotonic guard, per key (see put)
                fname = _frame_name(key_id, generation)
                self._publish(fname, payload, "store.write", key_id)
                if prev is not None and prev["file"] != fname:
                    replaced.append(prev["file"])
                entries[key_id] = {
                    "file": fname,
                    "generation": generation,
                    "proto": is_proto,
                    "parties": 2,
                }
                published += 1
            if published:
                self._write_manifest(entries)  # ONE flip for the batch
                self._c_writes.inc(published)
                for fname in replaced:
                    self._unlink_quiet(fname)
            return published

    def delete_many(self, key_ids) -> int:
        """Drop many keys' durable frames with ONE manifest flip (the
        key factory's batched reclaim of claimed pool frames — a
        per-claim ``delete`` would put a manifest fsync on every
        registration).  Same ordering rule as ``delete``: manifest
        first, then the unlinks, so the published state never
        references a missing file.  Unknown ids are ignored.  Returns
        the number of keys removed."""
        with self._lock:
            entries = self._read_manifest()
            dropped = [entries.pop(key_id) for key_id in dict.fromkeys(
                key_ids) if key_id in entries]
            if not dropped:
                return 0
            self._write_manifest(entries)
            for ent in dropped:
                self._unlink_quiet(ent["file"])
            self._c_deletes.inc(len(dropped))
            return len(dropped)

    def delete(self, key_id: str) -> bool:
        """Drop ``key_id``'s durable frame (manifest first — a crash
        between manifest and unlink leaves an orphan frame, swept
        later — so the published state never references a missing
        file).  Returns whether the key was stored."""
        with self._lock:
            entries = self._read_manifest()
            ent = entries.pop(key_id, None)
            if ent is None:
                return False
            self._write_manifest(entries)
            self._unlink_quiet(ent["file"])
            self._c_deletes.inc()
            return True

    def _unlink_quiet(self, fname: str) -> None:
        try:
            os.unlink(os.path.join(self.root, fname))
        except OSError:
            pass  # already gone (crash window): the manifest is truth

    # -- the restore surface ------------------------------------------------

    def key_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._read_manifest())

    def generation_of(self, key_id: str) -> int:
        with self._lock:
            entries = self._read_manifest()
            if key_id not in entries:
                # api-edge: unknown-name lookup contract at the serve edge
                raise ValueError(f"no durable frame stored under {key_id!r}")
            return entries[key_id]["generation"]

    def load(self, key_id: str):
        """Read back ``key_id`` -> ``(bundle, protocol, generation)``
        with the full wire-format validation.  A frame that fails it —
        truncated, byte-flipped, missing, or inconsistent with its
        manifest entry — is QUARANTINED (renamed aside, manifest entry
        dropped, counter bumped) and surfaces as the typed
        ``KeyQuarantinedError``; the store's other keys are untouched."""
        with self._lock:
            entries = self._read_manifest()
            ent = entries.get(key_id)
            if ent is None:
                # api-edge: unknown-name lookup contract at the serve edge
                raise ValueError(f"no durable frame stored under {key_id!r}")
            return self._load_locked(key_id, ent, entries)

    def load_all(self) -> tuple[dict, dict]:
        """Bulk read for warm restart: ONE manifest read/validation,
        then every frame — ``(loaded: {key_id: (bundle, protocol,
        generation)}, quarantined: {key_id: message})``.  Per-key
        ``load`` calls would re-read and re-validate the whole manifest
        each time (the per-operation re-read is the crash-consistency
        rule for MUTATIONS), making a restore over n keys O(n^2)
        manifest parses on exactly the startup path this store exists
        to make cheap."""
        loaded: dict = {}
        quarantined: dict = {}
        with self._lock:
            entries = self._read_manifest()
            for key_id in sorted(entries):
                try:
                    loaded[key_id] = self._load_locked(
                        key_id, entries[key_id], entries)
                except KeyQuarantinedError as e:
                    quarantined[key_id] = str(e)
        return loaded, quarantined

    def _load_locked(self, key_id: str, ent: dict, entries: dict):
        try:
            with open(os.path.join(self.root, ent["file"]),
                      "rb") as fh:
                data = fh.read()
        except FileNotFoundError as e:
            # The file the manifest references is GONE — that is
            # store damage, quarantine-worthy.  Any other OSError
            # (EMFILE, EACCES, transient fd pressure) propagates
            # UNTOUCHED: quarantining on a condition that clears on
            # retry would permanently destroy a valid durable key —
            # exactly the data loss the store exists to prevent.
            self._quarantine_locked(key_id, ent, entries)
            raise KeyQuarantinedError(
                f"durable frame for {key_id!r} has vanished "
                f"({e}); manifest entry dropped") from e
        try:
            if ent["proto"]:
                from dcf_tpu_torch.protocols import (
                    ProtocolBundle,
                    decode_proto_frame,
                )

                obj = decode_proto_frame(data)
                if isinstance(obj, ProtocolBundle):
                    pb, kb = obj, obj.keys
                else:  # DpfBundle: self-contained, no wrapper record
                    pb, kb = None, obj
            else:
                pb = None
                kb = KeyBundle.from_bytes(data)
            if kb.s0s.shape[1] != ent["parties"]:
                raise KeyFormatError(
                    f"frame stores {kb.s0s.shape[1]} parties, the "
                    f"manifest records {ent['parties']}")
        except KeyFormatError as e:
            self._quarantine_locked(key_id, ent, entries)
            raise KeyQuarantinedError(
                f"durable frame for {key_id!r} failed validation "
                f"and was quarantined ({e})") from e
        return kb, pb, ent["generation"]

    def replicate_to(self, other: "KeyStore", key_id: str, *,
                     retries: int = 3, backoff_s: float = 0.05,
                     sleep=None) -> int:
        """Replicate ``key_id``'s durable frame into ``other``
        PRESERVING its generation: the pod provisioning
        primitive — a key placed by the shard ring is written to its
        owner's store and replicated to its replica's, so the host
        CRITICAL traffic fails over to has already restored the key,
        same bytes, same generation, at its next warm start.

        Validation first (``load`` — a frame this store would
        quarantine must not propagate its damage), then ``other``'s
        own atomic-publish + monotonic-generation discipline applies:
        a replica already holding a NEWER generation keeps it.
        Returns the generation replicated.

        Bounded retry: the destination publish is
        retried up to ``retries`` times on a TRANSIENT ``OSError``
        (replica stores live on network mounts in a real pod — a
        one-packet blip must not abort a whole ring migration), with
        ``backoff_s`` doubling between attempts; each retry bumps
        ``serve_store_replicate_retries_total``, and exhaustion raises
        typed ``BackendUnavailableError`` with the last ``OSError``
        cause-chained.  Typed validation failures
        (``KeyQuarantinedError``/``KeyFormatError``) are NEVER retried
        — re-reading damage does not repair it.  ``sleep``: injectable
        for deterministic tests (defaults to ``time.sleep``; pass a
        no-op to retry without waiting)."""
        if retries < 0:
            # api-edge: retry contract (0 = single attempt)
            raise ValueError(f"retries must be >= 0, got {retries}")
        repl_frame = self.load(key_id)  # (bundle, protocol, generation)
        bundle, protocol, generation = repl_frame
        if sleep is None:
            import time

            sleep = time.sleep
        c_retries = self._metrics.counter(
            "serve_store_replicate_retries_total")
        delay = float(backoff_s)
        last: OSError | None = None
        for attempt in range(retries + 1):
            if attempt:
                c_retries.inc()
                sleep(delay)
                delay *= 2
            try:
                other.put(key_id, bundle, protocol=protocol,
                          generation=generation)
                return generation
            except KeyFormatError:
                raise  # destination-side validation: not transient
            except OSError as e:
                last = e
        raise BackendUnavailableError(
            f"replicating {key_id!r} to {other.root!r} failed after "
            f"{retries + 1} attempts (last: {type(last).__name__}: "
            f"{last})") from last

    def quarantine(self, key_id: str) -> None:
        """Set ``key_id``'s stored frame aside explicitly — for callers
        that reject a frame on grounds the codec cannot see (e.g. the
        registry's party check at restore).  A no-op for unknown keys
        or an unreadable manifest (the next real read raises typed)."""
        with self._lock:
            try:
                entries = self._read_manifest()
            except KeyFormatError:
                return
            ent = entries.get(key_id)
            if ent is not None:
                self._quarantine_locked(key_id, ent, entries)

    def digest(self) -> dict:
        """The durable ``{key_id: generation}`` map."""
        with self._lock:
            return {key_id: ent["generation"]
                    for key_id, ent in self._read_manifest().items()}

    def max_generation(self) -> int:
        """The highest generation any stored frame carries (0 for an
        empty or unreadable store).  A store-backed registry floors its
        generation counter on this at construction, BEFORE any restore:
        a fresh process registering durably into an existing store must
        never mint a generation at or below one the manifest already
        records — ``put``'s monotonic guard would silently drop the
        write-through, un-acking an acked durable registration."""
        with self._lock:
            try:
                entries = self._read_manifest()
            except KeyFormatError:
                return 0  # surfaced typed on the first real read
            return max((ent["generation"] for ent in entries.values()),
                       default=0)

    def _quarantine_locked(self, key_id: str, ent: dict,
                           entries: dict) -> None:
        """Set a damaged frame aside: rename to the first free
        ``.quarantined-<n>`` suffix (preserved for forensics — the
        damage pattern IS the evidence), drop the manifest entry, bump
        the counter.  Never raises: quarantine must not fail the
        failure path."""
        path = os.path.join(self.root, ent["file"])
        n = 0
        while os.path.exists(f"{path}.quarantined-{n}"):
            n += 1
        try:
            os.replace(path, f"{path}.quarantined-{n}")
        except OSError:
            pass  # the frame file itself is gone: nothing to set aside
        entries.pop(key_id, None)
        try:
            self._write_manifest(entries)
        except Exception:  # fallback-ok: quarantine must not fail the
            # failure path — if the manifest publish itself dies here
            # (disk full, or the armed store.manifest seam), the stale
            # entry keeps pointing at the renamed-away file, which the
            # next load re-quarantines via FileNotFoundError; the typed
            # KeyQuarantinedError still reaches the caller either way,
            # and an untyped escape would abort restore for EVERY key.
            pass
        self._c_quarantined.inc()

    def quarantined_files(self) -> list[str]:
        """The set-aside frames currently on disk (basenames, sorted)."""
        with self._lock:
            return sorted(f for f in os.listdir(self.root)
                          if ".quarantined-" in f)

    def sweep_orphans(self) -> int:
        """Remove frame/temp files the manifest does not reference —
        the debris of crash windows between a frame publish and its
        manifest flip (or between a manifest flip and an unlink).
        Quarantined files are kept.  Returns the count removed."""
        with self._lock:
            entries = self._read_manifest()
            live = {ent["file"] for ent in entries.values()}
            live.add(MANIFEST_NAME)
            removed = 0
            for f in os.listdir(self.root):
                if f in live or ".quarantined-" in f:
                    continue
                if f.endswith(_FRAME_SUFFIX) or f.endswith(".tmp"):
                    self._unlink_quiet(f)
                    removed += 1
            return removed
