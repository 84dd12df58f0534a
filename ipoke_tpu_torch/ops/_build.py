"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``ipoke_tpu_torch/csrc/*.cu`` for ``sm_90a`` (one
process per source, in parallel) and links them into one
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

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ipoke_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (argtypes), each returns the cudaError_t of its launch
SIGNATURES = {
    "nice_net_u": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "nice_net_u_split": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "macow_unit_inverse": (_P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "macow_unit_inverse_smem_bytes": (_I, _I, _I, _I, _I, _I),
    "macow_unit_inverse_max_clusters": (_I, _I, _I, _I, _I, _I),
    "masked_conv_inverse": (_P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "masked_conv_inverse_streamed_at": (_I, _I, _I, _I, _I, _I),
    "masked_conv_inverse_smem_bytes": (_I, _I, _I, _I, _I, _I),
    "masked_conv_inverse_max_clusters": (_I, _I, _I, _I, _I, _I),
    "spade_gn": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "spade_gn_max_clusters": (_I, _I, _I, _I, _I, _I),
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
    returns its path.  One ``nvcc`` per source, all started together, then
    one link.  The compiler's report (registers, shared memory, spills from
    ``-Xptxas=-v``) is kept beside the library as ``<lib>.log``."""
    global build_seconds
    nvcc = find_nvcc()
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    cmds, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o",
               str(BUILD_DIR / f"{src.stem}.{tag}.o"), str(src)]
        cmds.append(cmd)
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    objs = [cmd[-2] for cmd in cmds]
    tmp = out.with_suffix(f".{tag}")
    cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs])
    results = [(p.communicate()[0], p.returncode) for p in procs]
    if all(rc == 0 for _, rc in results):
        res = subprocess.run(cmds[-1], capture_output=True, text=True)
        results.append((res.stdout + res.stderr, res.returncode))
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    log = "\n".join(" ".join(cmd) + "\n" + text
                    for cmd, (text, _) in zip(cmds, results))
    out.with_suffix(".so.log").write_text(log)
    if any(rc != 0 for _, rc in results):
        raise RuntimeError(f"nvcc failed:\n{log}")
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


def aligned(t):
    """``t`` contiguous on a 16-byte boundary, as the kernels' vector and
    bulk copies need: a view at another offset is copied.  The caller holds
    the result until its launch is queued."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {err}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise while autograd records through a kernel that has no backward.
    A kernel's output comes through ctypes and carries no ``grad_fn``, so a
    gradient would be lost silently; the JAX package's counterparts have no
    autodiff and fail when traced."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward; call it under "
            "torch.no_grad() or on tensors that do not require grad")
