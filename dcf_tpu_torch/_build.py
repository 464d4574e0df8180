"""Builds the CUDA kernels under ``csrc/`` and loads them through ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for Hopper by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

at first use, into ``_build/`` beside this file (listed in
``.gitignore``).  A library's file name carries a digest of its sources
and flags, so an edited source is rebuilt and a stale library is never
loaded.  ``build()`` starts one nvcc per missing library, all at once, and
waits for every one of them.  The compiler's output, with ptxas' register
and spill report, is kept beside each library as ``<name>-<digest>.log``.

Nothing here runs at import time: the CPU tests import every module of the
package on hosts with no nvcc and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from dcf_tpu_torch.errors import BackendUnavailableError

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "build_log"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("walk_eval", "tree_expand", "prefix_eval", "narrow_walk",
           "wide_xor", "hybrid_state", "hybrid_prefix", "evalall_expand",
           "pir_answer", "keygen_walk", "keygen_wide", "keylanes_eval",
           "walk32_eval")
_HEADERS = ("dcf_walk.cuh", "narrow_walk.cuh", "keygen_walk.cuh",
            "aes_banked.cuh", "pir_answer.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Loaded libraries by kernel name: a process-wide handle cache, as a
# dlopen'd library is process-wide anyway.
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin/nvcc as PyTorch resolves it, else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BackendUnavailableError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu", *_HEADERS):
        h.update((CSRC / fname).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output of kernel ``name``'s current build ('' if it
    has not been built here)."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build(names=KERNELS) -> float:
    """Build every library of ``names`` that is missing, one nvcc per
    source, all started together.  Returns the wall seconds spent.  Raises
    ``BackendUnavailableError`` with the compiler's output if one fails."""
    todo = [name for name in names if not _lib_path(name).exists()]
    # dcflint: disable=determinism the build's wall time is a report for
    # the bench layer (chip_smoke, cli); no result depends on it
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    try:
        for name in todo:
            out = _lib_path(name)
            # Each process writes its own library and log and renames
            # them into place: concurrent builds of one source (a pod's
            # shard processes) never share a file.
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = open(out.with_name(f"{out.stem}.{os.getpid()}.log.tmp"),
                       "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, out, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            os.replace(log.name, out.with_suffix(".log"))
            if rc == 0:
                os.replace(tmp, out)
            else:
                failed.append((name, rc))
    finally:
        for _, _, _, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed:
        detail = "\n".join(f"--- {name} (nvcc rc={rc}) ---\n{build_log(name)}"
                           for name, rc in failed)
        raise BackendUnavailableError(f"kernel build failed:\n{detail}")
    return time.perf_counter() - t0  # dcflint: disable=determinism report


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of kernel library ``name``, built if
    needed, with its argument types set and an int return."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
