"""Top-level facade of the port.

Counterpart of ``Dcf`` in ``dcf_tpu/api.py`` (its lines 294-711 and
``eval`` at :1084), for the slice of it this package carries:

    >>> dcf = Dcf(n_bytes=16, lam=256, cipher_keys=keys)      # on the card
    >>> bundle = dcf.gen(alphas, betas)                       # K keys
    >>> y0 = dcf.eval(0, bundle, xs)                          # uint8 [K, M, 256]

and the point-function side (``Dcf.dpf`` / ``eval_all`` / ``pir_query``,
its lines 979-1080):

    >>> dpf = Dcf(n_bytes=3, lam=32, cipher_keys=keys)
    >>> q = dpf.pir_query([17, 4711])                        # 2 queries
    >>> y, t = dpf.eval_all(0, q)                            # kernel B6

and the interval protocols (``Dcf.interval`` / ``mic`` / ``piecewise`` and
``eval_interval`` / ``eval_mic`` / ``eval_piecewise``, its lines 860-975;
``protocols``):

    >>> pb = dcf.mic([(10, 200), (60000, 300)], betas)       # 4 keys, K-packed
    >>> y0 = dcf.eval_mic(0, pb, xs)                         # uint8 [2, M, lam]

Backends (``backend=``):

    auto     walk for lam = 16 and 32, hybrid for lam >= 48
    walk     the from-root walk (backends.walk_backend): lam = 16 on kernel
             B1, lam = 32 on kernel E1 (``dcf_tpu``'s bitsliced backend
             there)
    prefix   lam = 16: kernels B2 + B3, per-key frontier of the top k
             levels, built once per party, then the remaining n - k levels
             per point (backends.prefix_backend; shared points)
    hybrid   lam >= 48 (a multiple of 16), XOR group, shared points: the
             32-byte narrow walk (kernel B4) and the GF(2) wide tail (W1);
             ``backend_opts={"prefix_levels": k}`` walks the top k narrow
             levels once per party instead (kernels B5a + B5b)
             (backends.large_lambda)
    keylanes lam = 16, XOR group, shared points: kernel B8, many keys at
             few points (the secure-ReLU shape); one two-party key image
             serves both parties (backends.keylanes_backend)
    numpy    the host oracle (backends.numpy_backend)
    cpu      the C++ host core (``native.NativeDcf``: AES-NI, threaded),
             XOR group: keygen and evaluation on the host; without a
             working g++ build it raises ``NativeBuildError``

lam = 32 serves DCF keys under ``auto`` = ``walk`` (keygen on kernel G2,
evaluation on E1), ``numpy`` and ``cpu``, and the DPF methods
(full-domain evaluation on kernel B6) under any of the three; ``prefix``,
``keylanes`` and ``hybrid`` refuse it, as ``dcf_tpu``'s do.

Everything runs on the card (``device="cuda"``, the default) unless the
caller passes ``device="cpu"``, where the kernels' plain PyTorch versions
run.  Without CUDA, a facade that was not asked for the CPU raises.  An
explicitly named backend is what runs: there is no fallback chain and no
canary-driven degrade, so a failing device path surfaces as an error.

Keygen follows the facade's device too: ``gen``, ``dpf`` and ``pir_query``
take ``device=None`` (the default), which runs a keygen kernel where one
exists -- G1 for XOR keys at lam = 16, G2 at lam = 32, B7a and W2 (the
wide tail) at lam >= 48, B7b for DPF keys at lam = 32 -- and the numpy
host walk where none does (additive groups, DPF keys at other widths), as
``dcf_tpu`` routes those.
``device=False`` always names the host walk; ``device=True`` names the
kernel and raises where there is none.

The protocol keygen methods take ``device=False`` by default, as in
``dcf_tpu``: the host walk.  ``device=True`` runs the keygen kernel of the
width for XOR keys (G1, G2, or B7a and W2) and raises where no kernel has
the algebra (additive groups).

Serving (``Dcf.serve``, ``dcf_tpu_torch.serve``): an online service over
this facade -- ragged point batches from any thread, coalesced into
padded batches on the facade's device, hot key images kept resident:

    >>> svc = dcf.serve(max_batch=1 << 14, max_delay_ms=2.0)
    >>> svc.register_key("model/relu-7", bundle)
    >>> with svc:                       # worker thread
    ...     y0 = svc.submit("model/relu-7", xs, b=0).result()

``reset_backend_health`` (module function or method) is the shared
invalidation path: it drops the cached backend state of every live
facade and service (their residencies and frontier caches).  The port
keeps no health verdicts, so that is all it does: the next eval
re-stages on a fresh instance of the same backend.

A device mesh (``mesh=``, ``parallel.make_mesh``) shards the batch over
cards: keys over the mesh's ``keys`` axis, points over ``points``
(``dcf_tpu``'s api.py:302-332 and :555-593):

    >>> dcf = Dcf(16, 16, keys, mesh=make_mesh())             # every card

``auto`` picks ``walk`` at lam <= 32 and ``hybrid`` at lam >= 48 there,
``prefix`` and ``keylanes`` take lam = 16, and the host backends (``cpu``,
``numpy``) have no mesh-sharded variant.  The mesh carries the devices:
``device=`` beside it must agree with them, and keygen runs on the mesh's
first device.  ``dcf_tpu``'s JAX backend names (``jax``, ``bitsliced``,
``pallas``) are not in this package: their from-root walk is ``walk``.
"""

from __future__ import annotations

import warnings
import weakref
from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import resolve_device
from dcf_tpu_torch.errors import ShapeError
from dcf_tpu_torch.gen import gen_batch, gen_on_device, random_s0s
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import HirosePrgNp
from dcf_tpu_torch.protocols.dpf import (
    DPF_DEVICE_LAM,
    DpfBundle,
    dpf_gen_batch,
    dpf_gen_on_device,
)
from dcf_tpu_torch.protocols.keygen import ProtocolBundle, gen_interval_bundle
from dcf_tpu_torch.protocols.piecewise import partition_intervals
from dcf_tpu_torch.spec import (
    Bound,
    ReferenceContractWarning,
    hirose_used_cipher_indices,
)
from dcf_tpu_torch.utils.tracing import span

__all__ = ["Dcf", "reset_backend_health", "register_reset_listener"]

_BACKENDS = ("numpy", "cpu", "walk", "prefix", "hybrid", "keylanes")

# Backend names of the JAX facade that this package does not carry yet,
# with the ROADMAP.md item that ports them.
_LATER = {
    "jax": "not queued: its byte-level XLA walk has no counterpart; "
           "backend 'walk' evaluates the same keys",
    "bitsliced": "none: its lam <= 32 counterpart is backend 'walk'",
    "pallas": "none: its kernel is ported as backend 'walk'",
}

# backend_opts of the JAX package's hybrid backend that have no meaning
# here, and why.
_HYBRID_JAX_OPTS = {
    "col_chunk": "it chunks the columns of the JAX wide tail's int8 "
                 "matrix-unit product; kernel W1 tiles its columns itself",
    "narrow": "it picks the JAX narrow walk's XLA or Pallas form; the port "
              "has one narrow walk, kernel B4",
    "interpret": "the Pallas interpreter is a JAX tool; on the CPU the port "
                 "runs the kernels' plain versions (device='cpu')",
    "host_levels": "the hybrid frontier is built on the device (kernel "
                   "B5a); use prefix_levels",
}


# The one invalidation path for cached backend state, as in ``dcf_tpu``
# (its api.py:258-285): every live Dcf (its eval backends and shipped
# bundles) and every serving tier's DcfService (its device residencies
# and frontier cache) registers here, weakly, and gets
# ``_on_backend_health_reset()`` when ``reset_backend_health`` runs.
_RESET_LISTENERS: "weakref.WeakSet" = weakref.WeakSet()


def register_reset_listener(obj) -> None:
    """Subscribe ``obj`` (held weakly) to backend-health resets; it must
    define ``_on_backend_health_reset()``, which drops any cached state
    tied to a backend instance (staged images, backend instances).
    ``Dcf`` instances and ``serve.DcfService`` register themselves."""
    _RESET_LISTENERS.add(obj)


def reset_backend_health() -> None:
    """Invalidate every registered holder of backend-derived cached
    state: live facades drop their backend instances and re-ship on
    their next eval, and serving tiers evict their device-resident key
    images and cached frontiers.  ``dcf_tpu``'s function also forgets
    its canary verdicts; the port has no canary and no fallback chain,
    so there is nothing else to forget, and a re-staged key runs on the
    same backend as before."""
    for obj in list(_RESET_LISTENERS):
        obj._on_backend_health_reset()


def _mesh_device(mesh, device):
    """The facade's device under a mesh: the mesh's first device (keygen
    runs there).  A ``device`` given beside the mesh must agree with
    every position's device (the same type, and the same card where it
    names one)."""
    devs = list(mesh.devices.reshape(-1))
    if device is not None:
        want = torch.device(device)
        for d in devs:
            if d.type != want.type or (want.index is not None
                                       and d.index != want.index):
                # api-edge: documented mesh/device contract at the
                # facade edge
                raise ValueError(
                    f"device={device!r} does not agree with the mesh's "
                    f"device {d}; the mesh carries the devices")
    return resolve_device(devs[0])


class Dcf:
    """Runtime-configured DCF over one domain size and one lam."""

    def __init__(self, n_bytes: int, lam: int, cipher_keys: Sequence[bytes],
                 backend: str = "auto", backend_opts: dict | None = None,
                 device=None, mesh=None):
        if n_bytes < 1:
            # api-edge: constructor argument contract
            raise ValueError("n_bytes must be >= 1")
        if lam < 16 or lam % 16:
            # api-edge: constructor lam contract (reference parity)
            raise ValueError(f"lam must be a multiple of 16 bytes, got {lam}")
        name = backend if backend != "auto" else (
            "walk" if lam <= 32 else "hybrid")
        if mesh is not None and name in ("cpu", "numpy"):
            # api-edge: documented backend-name contract at the facade edge
            raise ValueError(
                f"backend {name!r} has no mesh-sharded variant (cpu/numpy "
                "are host paths); use walk, prefix, keylanes or hybrid")
        if name not in _BACKENDS:
            later = _LATER.get(name)
            # api-edge: documented backend-name contract at the facade edge
            raise ValueError(
                f"backend {name!r} is not in this package; it has "
                f"{', '.join(_BACKENDS)} and auto"
                + (f" (ROADMAP.md: {later})" if later else ""))
        if name in ("prefix", "keylanes") and lam != 16:
            # api-edge: documented backend/shape contract at the facade edge
            raise ValueError(
                f"the {name} backend supports lam=16 only (got {lam}); use "
                + ("walk" if lam == 32 else "hybrid"))
        if name == "walk" and lam > 32:
            # api-edge: documented backend/shape contract at the facade edge
            raise ValueError(
                f"the walk backend supports lam=16 and lam=32 (got {lam}); "
                "use hybrid")
        if name == "hybrid" and lam < 48:
            # api-edge: documented backend/shape contract at the facade edge
            raise ValueError(
                f"the hybrid (large-lambda) backend wants lam >= 48 (got "
                f"{lam}); use walk" + (" or prefix" if lam == 16 else ""))
        self._backend_opts = dict(backend_opts or {})
        if self._backend_opts and name in ("numpy", "cpu", "keylanes"):
            # api-edge: documented backend_opts contract at the facade edge
            raise ValueError(
                f"backend_opts {sorted(self._backend_opts)} do not apply to "
                f"the {name} backend"
                + (": the JAX keylanes kernel's tiling (m_tile, kw_tile, "
                   "level_chunk) has no counterpart in kernel B8"
                   if name == "keylanes" else ""))
        if name == "hybrid":
            for opt in sorted(self._backend_opts):
                if opt != "prefix_levels":
                    # api-edge: documented backend_opts contract at the facade edge
                    raise ValueError(
                        f"backend_opts {opt!r} does not apply to the port's "
                        "hybrid backend: "
                        + _HYBRID_JAX_OPTS.get(opt, "unknown option; it "
                                               "takes prefix_levels"))
        self.n_bytes = n_bytes
        self.lam = lam
        self.cipher_keys = list(cipher_keys)
        self.backend_name = name
        self.mesh = mesh
        self.device = (resolve_device(device) if mesh is None
                       else _mesh_device(mesh, device))
        # The facade is the API edge: the contract warning fires once here;
        # the nested constructions below are silenced.
        hirose_used_cipher_indices(lam, len(self.cipher_keys))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            self._prg = HirosePrgNp(lam, self.cipher_keys)
            self._native = None
            if name == "cpu":
                from dcf_tpu_torch.native import NativeDcf

                self._native = NativeDcf(lam, self.cipher_keys)
        # One backend per party, each holding its own shipped key image.
        self._eval_backends: dict = {}
        self._shipped_bundle: dict = {}
        self._dpf_evalall = None  # built by the first eval_all on the device
        register_reset_listener(self)

    # -- backend-health invalidation (the one shared path) -------------------

    def _on_backend_health_reset(self) -> None:
        """Drop every backend-derived cache this facade holds; the next
        eval builds and ships afresh, on the same backend."""
        self._eval_backends.clear()
        self._shipped_bundle.clear()
        self._dpf_evalall = None

    def reset_backend_health(self) -> None:
        """Instance spelling of :func:`reset_backend_health`: invalidates
        every registered cache holder, this facade's backend slots and
        every serving tier's residencies included."""
        reset_backend_health()

    def serve(self, config=None, **knobs):
        """An online evaluation service over this facade, on its device
        (``dcf_tpu_torch.serve``; ``dcf_tpu``'s ``Dcf.serve``, its
        api.py:732-852):

            >>> svc = dcf.serve(max_batch=1 << 14, max_delay_ms=2.0,
            ...                 device_bytes_budget=256 << 20)
            >>> svc.register_key("model/relu-7", bundle)
            >>> with svc:                       # worker thread
            ...     y0 = svc.submit("model/relu-7", xs, b=0).result()

        Pass a ``serve.ServeConfig`` or its fields as keywords; see
        ``dcf_tpu_torch/serve/service.py`` for the knobs (micro-batch
        coalescing, LRU device residency, the frontier cache, admission
        control, circuit breakers and brownout, the durable store, the
        key factory's pools).  ``submit(..., priority=)`` takes
        CRITICAL / NORMAL / BATCH; classes decide who is shed under
        overload, never dispatch order.  A retry after a failed batch
        re-stages on the same backend: nothing demotes."""
        from dcf_tpu_torch.serve import DcfService, ServeConfig

        if config is not None and knobs:
            # api-edge: either a config object or keywords, not both
            raise ValueError("pass either config= or individual knobs")
        if config is None:
            config = ServeConfig(**knobs)
        return DcfService(self, config)

    @staticmethod
    def _keygen_on_device(device, kernel: bool, why: str) -> bool:
        """Whether a keygen call runs its kernel: ``device=None`` where
        one exists, ``True`` always (raising ``why`` where none does),
        ``False`` never."""
        if device is None:
            return kernel
        if device and not kernel:
            # api-edge: documented device= keygen route contract
            raise ValueError(why)
        return bool(device)

    def gen(self, alphas: np.ndarray, betas: np.ndarray,
            s0s: np.ndarray | None = None,
            bound: Bound = Bound.LT_BETA,
            rng: np.random.Generator | None = None,
            device: bool | None = None, group: str = "xor") -> KeyBundle:
        """Generate K keys: alphas uint8 [K, n_bytes], betas uint8
        [K, lam].  s0s (uint8 [K, 2, lam]) default to fresh random seeds
        from ``rng`` (OS entropy if None).  Returns the two-party bundle;
        ship ``bundle.for_party(b)`` to party b.  ``group`` selects the
        output group (xor, add8, add16, add32).

        XOR keys run on the facade's device by default (``gen.
        gen_on_device``: kernel G1 at lam = 16, G2 at lam = 32, B7a and W2
        (the wide tail) at lam >= 48, their plain versions under
        ``device="cpu"``); additive groups take the host walk, as no keygen
        kernel has their algebra.  ``device=False`` names the host walk,
        ``device=True`` the kernel (an additive group then raises).  The
        bytes are the same.  Under
        ``backend="cpu"`` keygen stays on the host unless ``device=True``
        names the kernel: XOR keys on the C++ core (``NativeDcf.
        gen_batch``), additive groups on the numpy walk, as ``dcf_tpu``
        routes them."""
        on_device = self._keygen_on_device(
            False if self._native is not None and device is None else device,
            group == "xor",
            f"no keygen kernel has the additive algebra of group {group!r} "
            "(in this package or in dcf_tpu); call gen() with device=None "
            "or False for the host walk")
        alphas = np.asarray(alphas, dtype=np.uint8)
        betas = np.asarray(betas, dtype=np.uint8)
        if alphas.ndim != 2 or alphas.shape[1] != self.n_bytes:
            raise ShapeError(f"alphas must be [K, {self.n_bytes}]")
        s0s = self._fresh_s0s(alphas.shape[0], s0s, rng)
        if on_device:
            return gen_on_device(self.lam, self.cipher_keys, alphas, betas,
                                 s0s, bound, device=self.device)
        if self._native is not None and group == "xor":
            return self._native.gen_batch(alphas, betas, s0s, bound)
        return gen_batch(self._prg, alphas, betas, s0s, bound, group=group)

    def eval_backend(self, b: int = 0):
        """The backend instance serving party ``b`` (the one two-party
        instance for keylanes), constructed if absent (``None`` for
        numpy and cpu).  The way to the staged API (``stage`` /
        ``eval_staged`` / ``staged_to_bytes``) once ``eval`` has shipped
        the key image."""
        if self.backend_name in ("numpy", "cpu"):
            return None
        slot = "kl" if self.backend_name == "keylanes" else int(b)
        be = self._eval_backends.get(slot)
        if be is None:
            be = self._eval_backends[slot] = self.new_eval_backend()
        return be

    def new_eval_backend(self):
        """A fresh backend instance of this facade's selection, holding
        its own device key image (``None`` for numpy and cpu, which
        evaluate on the host in ``eval``).  ``protocols.MicEvaluator``
        keeps one per (bundle, party), so many protocol bundles stay on
        the card at once without taking the facade's per-party slots."""
        if self.backend_name in ("numpy", "cpu"):
            return None
        if self.mesh is not None:
            return self._new_sharded_backend()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            if self.backend_name == "walk":
                from dcf_tpu_torch.backends.walk_backend import WalkBackend

                return WalkBackend(self.lam, self.cipher_keys,
                                   device=self.device, **self._backend_opts)
            if self.backend_name == "keylanes":
                from dcf_tpu_torch.backends.keylanes_backend import (
                    KeyLanesBackend)

                return KeyLanesBackend(self.lam, self.cipher_keys,
                                       device=self.device)
            if self.backend_name == "prefix":
                from dcf_tpu_torch.backends.prefix_backend import (
                    PrefixBackend)

                return PrefixBackend(self.lam, self.cipher_keys,
                                     device=self.device,
                                     **self._backend_opts)
            from dcf_tpu_torch.backends.large_lambda import (
                LargeLambdaBackend)

            return LargeLambdaBackend(self.lam, self.cipher_keys,
                                      device=self.device,
                                      **self._backend_opts)

    def _new_sharded_backend(self):
        """The mesh-sharded counterpart of this facade's backend
        (``dcf_tpu_torch.parallel``), over ``self.mesh``."""
        from dcf_tpu_torch import parallel

        cls = {"walk": parallel.ShardedWalkBackend,
               "prefix": parallel.ShardedPrefixBackend,
               "keylanes": parallel.ShardedKeyLanesBackend,
               "hybrid": parallel.ShardedLargeLambdaBackend}[
                   self.backend_name]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            return cls(self.lam, self.cipher_keys, self.mesh,
                       **self._backend_opts)

    def eval(self, b: int, bundle: KeyBundle, xs: np.ndarray) -> np.ndarray:
        """Party ``b`` batch evaluation: xs uint8 [M, n_bytes] (shared) or
        [K, M, n_bytes] (per key; walk, numpy and cpu only).  Returns uint8
        [K, M, lam]; reconstruct with the bundle's group add of both
        parties' outputs.

        ``bundle`` may be the two-party bundle (restricted to party ``b``
        here; its key image is shipped once per party and reused while
        the caller passes the same object) or ``bundle.for_party(b)``."""
        with span("eval"):
            xs = np.asarray(xs, dtype=np.uint8)
            if self.backend_name == "keylanes":
                # One two-party image serves both parties (the correction
                # words are shared, the reference's src/lib.rs:269-272).
                if bundle.s0s.shape[1] != 2:
                    raise ShapeError(
                        "the keylanes backend wants the full two-party "
                        "bundle (its key image is shared between parties)")
                be = self.eval_backend(b)
                if self._shipped_bundle.get("kl") is not bundle:
                    be.put_bundle(bundle)
                    self._shipped_bundle["kl"] = bundle
                return be.eval(int(b), xs)
            kb = (bundle.for_party(b) if bundle.s0s.shape[1] == 2
                  else bundle)
            if self.backend_name == "cpu":
                if kb.group != "xor":
                    raise ShapeError(
                        f"the cpu (native) backend is XOR-only; bundle has "
                        f"group {kb.group!r} — use numpy/bitsliced/pallas")
                return self._native.eval(b, kb, xs)
            if self.backend_name == "numpy":
                from dcf_tpu_torch.backends.numpy_backend import (
                    eval_batch_np)

                return eval_batch_np(self._prg, b, kb, xs)
            be = self.eval_backend(b)
            # Keyed on the caller's object by identity, and the object is
            # kept in the entry, so a freed bundle's reused address cannot
            # hit.
            if self._shipped_bundle.get(int(b)) is not bundle:
                be.put_bundle(kb)
                self._shipped_bundle[int(b)] = bundle
            return be.eval(b, xs)

    # -- DPF / PIR: point functions and full-domain evaluation ---------------

    def _fresh_s0s(self, k_num: int, s0s, rng) -> np.ndarray:
        """The caller's root seeds, or K fresh pairs from ``rng`` (OS
        entropy if None)."""
        if s0s is not None:
            return s0s
        return random_s0s(
            k_num, self.lam,
            # dcflint: disable=determinism fresh key seeds MUST be
            # unpredictable (OS entropy); pass rng= to reproduce
            rng if rng is not None else np.random.default_rng())

    def dpf(self, alphas: np.ndarray, betas: np.ndarray | None = None,
            s0s: np.ndarray | None = None,
            rng: np.random.Generator | None = None,
            device: bool | None = None) -> DpfBundle:
        """Generate K DPF keys for ``f(x) = beta_k * 1_{x == alpha_k}``.

        The GGM walk minus the comparison accumulation (no ``cw_v``):
        alphas uint8 [K, n_bytes], betas uint8 [K, lam] (default all ones;
        PIR reads only the leaf t bits), s0s uint8 [K, 2, lam] fresh
        random root seeds (from ``rng``, OS entropy if None).  Returns the
        two-party ``DpfBundle`` (DCFK v3 ``proto=2`` on the wire; ship
        ``bundle.for_party(b)``).  Evaluate point by point with
        ``protocols.dpf.dpf_eval_points`` or over the whole domain with
        ``eval_all``.

        At lam = 32 the keys are made on the facade's device by default
        (kernel B7b, ``protocols.dpf.dpf_gen_on_device``; its plain
        version under ``device="cpu"``); other widths take the host walk,
        which ``device=False`` names at any width.  ``device=True`` where
        there is no kernel raises."""
        on_device = self._keygen_on_device(
            device, self.lam == DPF_DEVICE_LAM,
            f"DPF keygen has a kernel at lam={DPF_DEVICE_LAM} only (got "
            f"lam={self.lam}); call dpf() with device=None or False for "
            "the host walk")
        alphas = np.asarray(alphas, dtype=np.uint8)
        if alphas.ndim != 2 or alphas.shape[1] != self.n_bytes:
            raise ShapeError(f"alphas must be [K, {self.n_bytes}]")
        if betas is None:
            betas = np.full((alphas.shape[0], self.lam), 0xFF,
                            dtype=np.uint8)
        betas = np.asarray(betas, dtype=np.uint8)
        s0s = self._fresh_s0s(alphas.shape[0], s0s, rng)
        if on_device:
            return dpf_gen_on_device(self.lam, self.cipher_keys, alphas,
                                     betas, s0s, device=self.device)
        return dpf_gen_batch(self._prg, alphas, betas, s0s)

    def eval_all(self, b: int, bundle: DpfBundle, device: bool = True):
        """Party ``b``'s full-domain DPF evaluation: every leaf at once,
        about 2^(n+1) PRG calls instead of n * 2^n per-point walks.

        Returns ``(y, t)`` on the host: leaf shares uint8 [K, 2^n_bits,
        lam] and leaf t bits uint8 [K, 2^n_bits], in bitreverse_n leaf
        order (position p holds domain point bitreverse(p);
        ``workloads.pir.PirDatabase`` orders its records the same way).
        XOR the two parties: ``y0 ^ y1`` is beta at alpha and 0
        elsewhere, ``t0 ^ t1`` the one-hot selection vector.

        By default the evaluation follows the facade's device, as ``eval``
        does: kernel B6 through ``backends.evalall.DpfEvalAll`` on the
        card (its plain version under ``device="cpu"``), fetched back to
        host bytes.  B6 exists at lam = 32 only; any other lam raises
        unless the caller names the host: ``device=False`` runs the
        portable numpy expansion (any lam) and touches no device.  PIR
        servers use ``DpfEvalAll`` directly and keep the leaves on the
        device."""
        from dcf_tpu_torch.backends.evalall import (
            DpfEvalAll,
            dpf_finalize_np,
            dpf_tree_expand_np,
            leaves_to_bytes,
        )

        kb = bundle.for_party(b) if bundle.s0s.shape[1] == 2 else bundle
        if not device:
            s, t = dpf_tree_expand_np(self._prg, kb, b, kb.n_bits)
            return dpf_finalize_np(kb, s, t), t
        if self.lam != DPF_DEVICE_LAM:
            # api-edge: documented eval_all device-width contract
            raise ValueError(
                f"eval_all has a kernel at lam={DPF_DEVICE_LAM} only (got "
                f"lam={self.lam}); pass device=False for the host expansion")
        if self._dpf_evalall is None:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", ReferenceContractWarning)
                self._dpf_evalall = DpfEvalAll(
                    self.lam, self.cipher_keys, device=self.device)
        return leaves_to_bytes(
            *self._dpf_evalall.eval_party(b, kb, kb.n_bits))

    def pir_query(self, indices, s0s: np.ndarray | None = None,
                  rng: np.random.Generator | None = None,
                  n_bits: int | None = None,
                  device: bool | None = None) -> DpfBundle:
        """Client-side 2-server-PIR query keygen: one DPF key pair per
        record index, the keys ``workloads.pir.pir_query_bundle`` makes on
        the host, made as ``dpf`` makes them (``device=``: kernel B7b at
        lam = 32 by default).  ``n_bits`` is the database's domain,
        2^n_bits records; it defaults to the facade's own 8 * n_bytes and
        may be any depth whose byte-granular key domain that is
        (8 * n_bytes - 7 .. 8 * n_bytes).  Register the returned bundle
        with both servers, collect ``PirServer.answer(key_id, b)`` from
        each, and XOR the shares (``workloads.pir.pir_reconstruct``): the
        record comes back bit-exact while neither server learns which
        one."""
        from dcf_tpu_torch.workloads.pir import pir_query_alphas

        n_key = 8 * self.n_bytes
        n_bits = n_key if n_bits is None else int(n_bits)
        if not n_key - 8 < n_bits <= n_key:
            # api-edge: documented PIR database-domain contract at the facade edge
            raise ValueError(
                f"a 2^{n_bits}-record database wants keys over "
                f"{(n_bits + 7) // 8} bytes, this facade has n_bytes="
                f"{self.n_bytes}")
        return self.dpf(pir_query_alphas(indices, n_bits), s0s=s0s, rng=rng,
                        device=device)

    # -- protocols: IC / MIC / piecewise (``protocols``) ---------------------

    def _protocol_gen(self, rng, device: bool = False, group: str = "xor"):
        """The K-batched keygen closure ``gen_interval_bundle`` calls: this
        facade's ``gen`` with the protocol's rng, device and group."""
        def gen_fn(alphas, betas, bound: Bound):
            return self.gen(alphas, betas, bound=bound, rng=rng,
                            device=device, group=group)

        return gen_fn

    def interval(self, p: int, q: int, beta: np.ndarray,
                 bound: Bound = Bound.LT_BETA,
                 rng: np.random.Generator | None = None,
                 device: bool = False, group: str = "xor") -> ProtocolBundle:
        """Keys for interval containment ``1_{p <= x < q} * beta``.

        ``p`` / ``q``: ints in ``[0, 2^n_bits]`` (``q = 2^n_bits`` makes
        ``[p, N)`` expressible); ``p > q`` is the wraparound interval
        ``[p, N) ∪ [0, q)`` and ``p == q`` is empty.  ``beta``: uint8
        [lam].  Returns a two-party ``protocols.ProtocolBundle`` packing
        the two bound keys on the K axis: ship ``pb.for_party(b)`` and
        evaluate with :meth:`eval_interval`; group-add both parties'
        outputs to reconstruct (XOR in the default group).  ``bound``
        picks the DCF bound family that realizes the keys (same
        reconstruction either way); ``group`` the output group, where
        the additive groups give arithmetic shares of the indicator (the
        fixed-point gates' building block).  ``device``: as for
        :meth:`mic`."""
        beta = np.asarray(beta, dtype=np.uint8).reshape(1, -1)
        return gen_interval_bundle(
            self._protocol_gen(rng, device, group), [(p, q)], beta,
            self.n_bytes, bound, group)

    def mic(self, intervals, betas: np.ndarray,
            bound: Bound = Bound.LT_BETA,
            rng: np.random.Generator | None = None,
            device: bool = False, group: str = "xor") -> ProtocolBundle:
        """Keys for multiple interval containment over ``m`` intervals.

        ``intervals``: a sequence of ``(p, q)`` int pairs (the convention
        of :meth:`interval`; each output row is independent, so overlap
        is merely redundant); ``betas``: uint8 [m, lam].  The 2m
        interval-bound DCF keys pack into one K-axis bundle, evaluated
        with :meth:`eval_mic` (facade path) or ``protocols.MicEvaluator``
        (staged, the combine on the card).  Reconstruction: group-add
        both parties' [m, M, lam] outputs.  ``device=False`` (the
        default) runs the host walk; ``device=True`` runs the 2m-key
        keygen on the card (XOR keys: kernel G1 at lam = 16, G2 at
        lam = 32, byte-identical to the host walk) and raises where no
        kernel has the algebra."""
        return gen_interval_bundle(
            self._protocol_gen(rng, device, group), intervals,
            np.asarray(betas, dtype=np.uint8), self.n_bytes, bound,
            group)

    def piecewise(self, cuts, values: np.ndarray,
                  rng: np.random.Generator | None = None,
                  device: bool = False, group: str = "xor") -> ProtocolBundle:
        """Keys for a piecewise-constant function (spline lookup table).

        ``cuts``: strictly increasing breakpoints in ``[0, 2^n_bits)``
        (the last piece wraps around the domain top; with ``cuts[0] ==
        0`` that is the standard table over [0, N)); ``values``: uint8
        [m, lam], piece i's output.  Builds the MIC over the induced
        partition; :meth:`eval_piecewise` group-reduces the per-piece
        rows to one [M, lam] share per party.  In an additive ``group``
        the result is an arithmetic share of the piece value: the spline
        sigmoid gate (``protocols.fixedpoint``) is a client of this."""
        intervals = partition_intervals(list(cuts), 8 * self.n_bytes)
        return gen_interval_bundle(
            self._protocol_gen(rng, device, group), intervals,
            np.asarray(values, dtype=np.uint8), self.n_bytes,
            Bound.LT_BETA, group)

    def eval_interval(self, b: int, pb: ProtocolBundle,
                      xs: np.ndarray) -> np.ndarray:
        """Party ``b``'s IC share uint8 [M, lam] (see :meth:`interval`)."""
        from dcf_tpu_torch.protocols.ic import eval_interval

        return eval_interval(self, b, pb, np.asarray(xs, dtype=np.uint8))

    def eval_mic(self, b: int, pb: ProtocolBundle,
                 xs: np.ndarray) -> np.ndarray:
        """Party ``b``'s per-interval MIC shares uint8 [m, M, lam] (see
        :meth:`mic`): the 2m keys evaluate as one K-packed batch on this
        facade's backend, then the pair-combine and the public-correction
        mask apply (``protocols.combine``, fault seam
        ``protocols.combine``)."""
        from dcf_tpu_torch.protocols.mic import eval_mic

        return eval_mic(self, b, pb, np.asarray(xs, dtype=np.uint8))

    def eval_piecewise(self, b: int, pb: ProtocolBundle,
                       xs: np.ndarray) -> np.ndarray:
        """Party ``b``'s piecewise-lookup share uint8 [M, lam] (see
        :meth:`piecewise`)."""
        from dcf_tpu_torch.protocols.piecewise import eval_piecewise

        return eval_piecewise(self, b, pb, np.asarray(xs, dtype=np.uint8))
