"""ctypes bindings of the port's C++ host core (``dcf_core.cpp`` here).

Counterpart of ``dcf_tpu/native/__init__.py`` (its lines 85-303): the same
C core, the port's own copy, behind the same ``NativeDcf`` (``has_aesni``,
``prg_gen``, ``gen_batch``, ``eval``).  It is the host keygen and
evaluation of ``Dcf(..., backend="cpu")``, and the byte anchor and
single-core rate of ``bench_torch.py``.

Built with g++ at first use into ``dcf_tpu_torch/_build/native/``
(listed in ``.gitignore``), never beside the source.  A library's file
name carries a digest of ``dcf_core.cpp``, the flags and, for the AES-NI
build, the compiler's ``-march=native`` target macros, so an edited source
or another host's CPU gets its own build and a stale library is never
loaded.  The AES-NI build (``-march=native``) is the default; only where
it fails to build or load does the portable S-box build serve, with a
``BackendFallbackWarning``.  Both give the same bytes.  Where neither
builds, ``NativeBuildError`` is raised: nothing falls back to another
keygen or evaluation path.

Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Sequence

import numpy as np

from dcf_tpu_torch.errors import (
    BackendFallbackWarning,
    NativeBuildError,
    ShapeError,
)
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.prg import PrgOut
from dcf_tpu_torch.spec import Bound, hirose_used_cipher_indices
from dcf_tpu_torch.testing.faults import InjectedFault, fire

__all__ = ["NativeDcf", "BUILD_DIR", "build", "load"]

SOURCE = Path(__file__).resolve().parent / "dcf_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared",
          "-pthread")

# Loaded libraries by variant (portable or not), and the variants whose
# build or load failed in this process, so that a host without a
# toolchain does not start the compiler again on every NativeDcf.
_LIBS: dict[bool, ctypes.CDLL] = {}
_FAILED: set[bool] = set()

_P = ctypes.c_void_p
_SIGNATURES = {
    "dcf_has_aesni": ([], ctypes.c_int),
    "dcf_prg_sizeof": ([], ctypes.c_uint32),
    "dcf_prg_init": ([_P, ctypes.c_uint32, _P, ctypes.c_uint32],
                     ctypes.c_int),
    "dcf_prg_gen_batch": ([_P, ctypes.c_uint64] + [_P] * 7, None),
    "dcf_gen_batch": ([_P, ctypes.c_uint32, ctypes.c_uint32, _P, _P, _P,
                       ctypes.c_int, _P, _P, _P, _P, ctypes.c_int], None),
    "dcf_eval_batch": ([_P, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
                        ctypes.c_uint64, _P, _P, _P, _P, _P, _P,
                        ctypes.c_int, _P, ctypes.c_int], None),
}


def _cxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found is None:
        raise NativeBuildError(
            "no C++ compiler (g++ or c++) on PATH to build the native core")
    return found


def _lib_path(cxx: str, portable: bool) -> Path:
    """The library of one variant: its name carries a digest of the
    source, the flags and (AES-NI build) the target's macros."""
    flags = _FLAGS if portable else (*_FLAGS, "-march=native")
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    if not portable:
        macros = subprocess.run(
            [cxx, "-march=native", "-E", "-dM", "-x", "c++", "-"],
            input="", capture_output=True, text=True, timeout=60)
        if macros.returncode:
            raise NativeBuildError(
                f"{cxx} -march=native failed:\n{macros.stderr}")
        h.update(macros.stdout.encode())
    name = "libdcf_portable" if portable else "libdcf"
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(portable: bool = False) -> Path:
    """Compile one variant of the core if it is not built yet; returns its
    path.  Raises ``NativeBuildError`` with the compiler's output.  Fault
    seam: ``faults.fire("native.build", portable)``."""
    try:
        fire("native.build", portable)
        cxx = _cxx()
        out = _lib_path(cxx, portable)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        flags = _FLAGS if portable else (*_FLAGS, "-march=native")
        proc = subprocess.run([cxx, *flags, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired, InjectedFault) as e:
        raise NativeBuildError(
            f"native build ({'portable' if portable else 'AES-NI'}) failed: "
            f"{type(e).__name__}: {e}") from e
    if proc.returncode:
        raise NativeBuildError(
            f"native build ({'portable' if portable else 'AES-NI'}) failed "
            f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(portable: bool = False) -> ctypes.CDLL:
    """The loaded core, built if needed.  The AES-NI build degrades to the
    portable build on a build or load failure, with a
    ``BackendFallbackWarning``; a portable failure raises
    ``NativeBuildError``.  Fault seam: ``faults.fire("native.load",
    portable)``."""
    lib = _LIBS.get(portable)
    if lib is not None:
        return lib
    if portable in _FAILED:
        if not portable:
            return load(portable=True)
        raise NativeBuildError(
            "portable native core unavailable (it failed earlier in this "
            "process)")
    try:
        path = build(portable)
        fire("native.load", portable)
        lib = ctypes.CDLL(str(path))
    except (NativeBuildError, OSError, InjectedFault) as e:
        _FAILED.add(portable)
        if portable:
            if isinstance(e, NativeBuildError):
                raise
            raise NativeBuildError(
                f"portable native core failed to load: {e}") from e
        warnings.warn(BackendFallbackWarning(
            "native (AES-NI)", "native (portable S-box)", e), stacklevel=2)
        return load(portable=True)
    for fn, (argtypes, restype) in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[portable] = lib
    return lib


def _c(a: np.ndarray) -> np.ndarray:
    """A C-contiguous uint8 array the foreign call may read; the caller
    keeps it bound while the call runs."""
    return np.ascontiguousarray(a, dtype=np.uint8)


class NativeDcf:
    """DCF keygen and evaluation on the C++ core (XOR group).

    The numpy layer's contract: the same structure-of-arrays
    ``KeyBundle`` in, the same uint8 [K, M, lam] shares out, bit-exact
    with every other backend.  ``num_threads`` defaults to the host's
    cores."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes],
                 num_threads: int | None = None, portable: bool = False):
        hirose_used_cipher_indices(lam, len(cipher_keys))
        if any(len(k) != 32 for k in cipher_keys):
            # api-edge: constructor cipher-key contract
            raise ValueError("all cipher keys must be 32 bytes (AES-256)")
        self.lam = lam
        self.num_threads = num_threads or os.cpu_count() or 1
        self._lib = load(portable)
        self._prg = ctypes.create_string_buffer(self._lib.dcf_prg_sizeof())
        keys = np.frombuffer(b"".join(cipher_keys), dtype=np.uint8).copy()
        rc = self._lib.dcf_prg_init(self._prg, lam, keys.ctypes.data,
                                    len(cipher_keys))
        if rc != 0:
            # api-edge: C-core init rejected the (lam, keys) arguments
            raise ValueError(f"dcf_prg_init failed with code {rc}")

    @property
    def has_aesni(self) -> bool:
        return bool(self._lib.dcf_has_aesni())

    def prg_gen(self, seeds: np.ndarray) -> PrgOut:
        """Batched PRG: the expansion ``ops.prg.HirosePrgNp.gen`` gives."""
        lam = self.lam
        if seeds.dtype != np.uint8 or seeds.shape[-1] != lam:
            raise ShapeError(f"seeds must be uint8 [..., {lam}]")
        shape = seeds.shape[:-1]
        batch = int(np.prod(shape))
        flat = _c(seeds.reshape(batch, lam))
        s_l, v_l, s_r, v_r = (np.empty((batch, lam), np.uint8)
                              for _ in range(4))
        t_l, t_r = np.empty(batch, np.uint8), np.empty(batch, np.uint8)
        self._lib.dcf_prg_gen_batch(
            self._prg, batch, flat.ctypes.data, *(
                a.ctypes.data for a in (s_l, v_l, t_l, s_r, v_r, t_r)))
        return PrgOut(s_l=s_l.reshape(*shape, lam),
                      v_l=v_l.reshape(*shape, lam), t_l=t_l.reshape(shape),
                      s_r=s_r.reshape(*shape, lam),
                      v_r=v_r.reshape(*shape, lam), t_r=t_r.reshape(shape))

    def gen_batch(self, alphas: np.ndarray, betas: np.ndarray,
                  s0s: np.ndarray, bound: Bound,
                  num_threads: int | None = None) -> KeyBundle:
        """K keys: the contract of ``gen.gen_batch`` in the XOR group."""
        if alphas.ndim != 2:
            raise ShapeError("alphas must be [K, n_bytes]")
        k_num, n_bytes = alphas.shape
        lam = self.lam
        if betas.shape != (k_num, lam) or s0s.shape != (k_num, 2, lam):
            raise ShapeError("alphas/betas/s0s shape mismatch")
        if any(a.dtype != np.uint8 for a in (alphas, betas, s0s)):
            raise ShapeError("alphas/betas/s0s must be uint8")
        n = 8 * n_bytes
        cw_s = np.empty((k_num, n, lam), np.uint8)
        cw_v = np.empty((k_num, n, lam), np.uint8)
        cw_t = np.empty((k_num, n, 2), np.uint8)
        cw_np1 = np.empty((k_num, lam), np.uint8)
        alphas_c, betas_c, s0s_c = _c(alphas), _c(betas), _c(s0s)
        self._lib.dcf_gen_batch(
            self._prg, k_num, n_bytes, alphas_c.ctypes.data,
            betas_c.ctypes.data, s0s_c.ctypes.data,
            1 if bound is Bound.GT_BETA else 0, cw_s.ctypes.data,
            cw_v.ctypes.data, cw_t.ctypes.data, cw_np1.ctypes.data,
            num_threads or self.num_threads)
        return KeyBundle(s0s=s0s_c.copy(), cw_s=cw_s, cw_v=cw_v, cw_t=cw_t,
                         cw_np1=cw_np1)

    def eval(self, b: int, bundle: KeyBundle, xs: np.ndarray,
             num_threads: int | None = None) -> np.ndarray:
        """Party ``b``'s shares uint8 [K, M, lam]; xs uint8 [M, n_bytes]
        (shared by the keys) or [K, M, n_bytes].  ``bundle`` is the
        two-party bundle (restricted to party ``b`` here) or
        ``bundle.for_party(b)``; XOR group only."""
        if bundle.s0s.shape[1] == 2:
            bundle = bundle.for_party(b)
        if bundle.group != "xor":
            raise ShapeError(
                f"the native core is XOR-only; bundle has group "
                f"{bundle.group!r}")
        k_num, n, lam = bundle.cw_s.shape
        if lam != self.lam:
            raise ShapeError("bundle lam mismatch")
        if xs.dtype != np.uint8:
            raise ShapeError("xs must be uint8")
        shared = xs.ndim == 2
        m = xs.shape[0] if shared else xs.shape[1]
        if xs.ndim not in (2, 3) or xs.shape[-1] * 8 != n or (
                not shared and xs.shape[0] != k_num):
            raise ShapeError("xs shape mismatch with bundle")
        ys = np.empty((k_num, m, lam), np.uint8)
        s0, cw_s, cw_v, cw_t, cw_np1, xs_c = (_c(a) for a in (
            bundle.s0s[:, 0, :], bundle.cw_s, bundle.cw_v, bundle.cw_t,
            bundle.cw_np1, xs))
        self._lib.dcf_eval_batch(
            self._prg, int(b), k_num, n // 8, m, s0.ctypes.data,
            cw_s.ctypes.data, cw_v.ctypes.data, cw_t.ctypes.data,
            cw_np1.ctypes.data, xs_c.ctypes.data, 1 if shared else 0,
            ys.ctypes.data, num_threads or self.num_threads)
        return ys
