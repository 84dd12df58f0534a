"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``ipoke_tpu_torch/csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface under ``build/ipoke_tpu_torch/`` at
the repository root, at first use, and ``ctypes`` loads it.  The library name
carries a hash of the sources and flags, so an edited source is rebuilt and a
stale library is never loaded.  A missing ``nvcc`` or a failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ipoke_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (argtypes), each returns the cudaError_t of its launch
SIGNATURES = {
    "nice_net_u": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "nice_net_train_u": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "macow_unit_inverse": (_P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _F, _P),
}

_lib = None
build_seconds = None  # wall time of this process's build (None: not built)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the ipoke_tpu_torch CUDA "
            "kernels are built from ipoke_tpu_torch/csrc at first use and need "
            "the CUDA toolkit")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libipoke_kernels_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists;
    returns its path.  The compiler's report (registers, shared memory,
    spills from ``-Xptxas=-v``) is kept beside it as ``<lib>.log``."""
    global build_seconds
    nvcc = find_nvcc()
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *map(str, sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    log = res.stdout + res.stderr
    out.with_suffix(".so.log").write_text(" ".join(cmd) + "\n" + log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={res.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and declared for ctypes."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")
