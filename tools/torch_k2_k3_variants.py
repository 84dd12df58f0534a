#!/usr/bin/env python3
"""Time K2 (``ipoke_tpu_torch/csrc/macow_unit_inverse.cu``) and K3
(``csrc/spade_gn.cu``) against variants of their own sources on one NVIDIA
GPU, all in one process, so that they share a card.

    python3 tools/torch_k2_k3_variants.py

Each variant is a text substitution in one source, built with nvcc into
``build/k2_k3_variants/<name>/`` and loaded with ctypes in place of the
port's library.  A variant that keeps the function is held against the
plain version (K2 within 1e-4 at ``chip_smoke.py``'s K2 cases, B = 40,
hid = 4C, 128 conditioning channels; K3 within 3e-2 abs + rel at its bf16
decode levels) and must repeat bitwise; an ablation (a name starting with
``ablate``) drops a piece of the work to show its cost, and only its error
is printed.  Then each kernel's time per call (CUDA events over 50 calls,
the variants of one kernel in turns, three rounds): K2 at the 8x8 units
with C = 32, 18 and 4, K3 at the four decode levels (N = 400, bf16).
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ipoke_tpu_torch.ops import _build, masked_conv, spade_gn  # noqa: E402

K2_SRC, K3_SRC = "macow_unit_inverse.cu", "spade_gn.cu"
HC_OLD = """  for (int i = 0; i < H; ++i, ++g) {
    const int row = reverse ? H - 1 - i : i;
    const int start = reverse ? row + 1 : row;
    // this row's conditioning term, in flight during the dot
    float hmu[AMAX], hls[AMAX];
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const int idx = tid + a * THREADS;
      hmu[a] = hls[a] = 0.f;
      if (idx < n_aff) {
        const float* p = hcm + ((size_t)row * W + idx / C) * twoC + idx % C;
        hmu[a] = __ldg(p);
        hls[a] = __ldg(p + C);
      }
    }
"""
HC_NEW = """  // the conditioning term of a row, loaded a whole row ahead of its use
  float hmu[AMAX], hls[AMAX];
  auto load_hc = [&](int row) {
#pragma unroll
    for (int a = 0; a < AMAX; ++a) {
      const int idx = tid + a * THREADS;
      if (idx < n_aff) {
        const float* p = hcm + ((size_t)row * W + idx / C) * twoC + idx % C;
        hmu[a] = __ldg(p);
        hls[a] = __ldg(p + C);
      }
    }
  };
#pragma unroll
  for (int a = 0; a < AMAX; ++a) hmu[a] = hls[a] = 0.f;
  load_hc(reverse ? H - 1 : 0);
  for (int i = 0; i < H; ++i, ++g) {
    const int row = reverse ? H - 1 - i : i;
    const int start = reverse ? row + 1 : row;
"""
AFF_OLD = """            (cur[(row * W + w) * C + c] - mu) / (scale + 1e-12f);
      }
    }
    __syncthreads();
  }
}"""
AFF_NEW = """            (cur[(row * W + w) * C + c] - mu) / (scale + 1e-12f);
      }
    }
    if (i + 1 < H) load_hc(reverse ? row - 1 : row + 1);
    __syncthreads();
  }
}"""
PF_OLD = """    if constexpr (VEC * sizeof(T) == 16)
      if (tid == 0 && npix > 0 && f % s.T == 0 && n_clusters >= s.T) {"""
VARIANTS = {
    "k2": (K2_SRC, []),
    # two CTAs of 512 threads per item: 64 hidden units each, one CTA per SM
    "k2_cluster2": (K2_SRC, [
        ("CLUSTER = 4;", "CLUSTER = 2;"), ("THREADS = 256;", "THREADS = 512;"),
        ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")]),
    # the out product's j loop not unrolled
    "k2_out_rolled": (K2_SRC, [("#pragma unroll 4\n        for (int j = 0; j < nj; j += 4) {",
                                "        for (int j = 0; j < nj; j += 4) {")]),
    # each row's conditioning term loaded in the row before
    "k2_hc_row_ahead": (K2_SRC, [(HC_OLD, HC_NEW), (AFF_OLD, AFF_NEW)]),
    # a CTA barrier in place of the row's cluster barrier
    "ablate_k2_cluster_barrier": (K2_SRC, [
        ("    cluster.sync();  // every CTA's partial of this row is written",
         "    __syncthreads();")]),
    # the CTA's own partial four times in place of the peers' (no DSMEM read)
    "ablate_k2_dsmem_reads": (K2_SRC, [("cluster.map_shared_rank(xp, r)", "xp")]),
    # no tap products (the window is still read)
    "ablate_k2_tap_fma": (K2_SRC, [(
        "                acc[k] = fmaf(v.x, wr[q][0][dx], acc[k]);\n"
        "                acc[k] = fmaf(v.y, wr[q][1][dx], acc[k]);\n"
        "                acc[k] = fmaf(v.z, wr[q][2][dx], acc[k]);\n"
        "                acc[k] = fmaf(v.w, wr[q][3][dx], acc[k]);\n",
        "                acc[k] += v.x;\n")]),
    # no out product
    "ablate_k2_out_product": (K2_SRC, [("for (int j = 0; j < nj; j += 4) {",
                                        "for (int j = 0; j < 0; j += 4) {")]),
    # no conditioning term loaded
    "ablate_k2_hc_loads": (K2_SRC, [
        ("        hmu[a] = __ldg(p);\n        hls[a] = __ldg(p + C);\n", "")]),
    "k3": (K3_SRC, []),
    # no L2 prefetch of gamma and beta
    "k3_no_prefetch": (K3_SRC, [(PF_OLD, PF_OLD.replace(
        "f % s.T == 0 && n_clusters >= s.T", "false"))]),
    # the prefetch at a clip's first frame with any number of clusters
    "k3_prefetch_clip_start": (K3_SRC, [(PF_OLD, PF_OLD.replace(" && n_clusters >= s.T", ""))]),
    # the prefetch in every frame
    "k3_prefetch_every_frame": (K3_SRC, [(PF_OLD, PF_OLD.replace(
        " && f % s.T == 0 && n_clusters >= s.T", ""))]),
    # 8 and 2 chunks a slice
    "k3_nch8": (K3_SRC, [("constexpr int NCH = 4;", "constexpr int NCH = 8;")]),
    "k3_nch2": (K3_SRC, [("constexpr int NCH = 4;", "constexpr int NCH = 2;")]),
}
K2_CASES = ((8, 32), (8, 18), (8, 4), (16, 32))  # (H = W, C)
K2_TIMED = ((8, 32), (8, 18), (8, 4))
K3_CASES = ((128, 64), (64, 128), (32, 256), (16, 256))  # (S, Ch), bf16
K3_TIMED = K3_CASES
OUT = ROOT / "build" / "k2_k3_variants"


def build(name):
    source, subs = VARIANTS[name]
    src = (_build.CSRC / source).read_text()
    for old, new in subs:
        assert old in src, (name, old)
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / source).write_text(src)
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                          "-shared", "-o", str(d / "lib.so"), str(d / source)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    report = sorted({line.split(":", 1)[-1].strip()
                     for line in (res.stdout + res.stderr).splitlines()
                     if "registers" in line or "spill" in line})
    lib = ctypes.CDLL(str(d / "lib.so"))
    for fn, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
    return lib, report


def ms_per_call(fn, iters=50):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def unit_operands(dev, gen, s, c, b=40, ch=128):
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    hid = 4 * c
    mcf = [{"w_shift": randn(2, 3, c, hid) * (6 * c) ** -0.5,
            "out": {"v": randn(1, 1, hid + ch, 2 * c) * 0.05,
                    "g": randn(2 * c) * 0.3, "b": randn(2 * c) * 0.1}}
           for _ in range(4)]
    for p in mcf[2:]:  # C/D store the kernel dims swapped
        p["w_shift"] = p["w_shift"].transpose(0, 1).contiguous()
    an = [{"log_scale": randn(c) * 0.05, "bias": randn(c) * 0.05} for _ in range(2)]
    y, h = randn(b, s, s, c), randn(b, s, s, ch)
    return (y, *masked_conv.pack_unit(h, mcf, an, b, s, s), 1.0)


def spade_operands(dev, gen, s, ch):
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return ((randn(400, s, s, ch) * 2.0 + 0.5).bfloat16(),
            (randn(40, s, s, ch) * 0.5).bfloat16(),
            (randn(40, s, s, ch) * 0.5).bfloat16(), 16)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(build, VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    kernels = {
        K2_SRC: (masked_conv.macow_unit_inverse_cuda, masked_conv.macow_unit_inverse_plain,
                 {c: unit_operands(dev, gen, *c) for c in K2_CASES}, K2_TIMED,
                 lambda got, want: (got - want).abs().max().item() <= 1e-4),
        K3_SRC: (spade_gn.spade_gn_cuda, spade_gn.spade_gn_plain,
                 {c: spade_operands(dev, gen, *c) for c in K3_CASES}, K3_TIMED,
                 lambda got, want: bool(((got.float() - want.float()).abs()
                                         <= 3e-2 * (1 + want.float().abs())).all())),
    }
    for name, (lib, report) in built.items():
        cuda, plain, args, _, ok = kernels[VARIANTS[name][0]]
        _build._lib = lib
        errs = []
        for case, a in args.items():
            got, want = cuda(*a), plain(*a)
            errs.append((got.float() - want.float()).abs().max().item())
            if not name.startswith("ablate") and not (ok(got, want) and torch.equal(got, cuda(*a))):
                raise AssertionError(f"{name} {case}: off the plain version or not repeatable")
        print(f"{name}: ptxas {'; '.join(report)}; max error at {list(args)}: "
              + ", ".join(f"{e:.2e}" for e in errs)
              + ("" if name.startswith("ablate") else ", two calls bitwise equal"))
    for source, (cuda, _, args, timed, _) in kernels.items():
        names = [n for n in built if VARIANTS[n][0] == source]
        times = {n: {c: [] for c in timed} for n in names}
        for _ in range(3):
            for n in names:
                _build._lib = built[n][0]
                for c in timed:
                    times[n][c].append(ms_per_call(lambda: cuda(*args[c])))
        for n, by_case in times.items():
            print(f"{n} ms per call: " + "; ".join(
                f"{c} " + ", ".join(f"{t:.4f}" for t in ts) for c, ts in by_case.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
