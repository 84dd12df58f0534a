#!/usr/bin/env python3
"""Time K5 (``ipoke_tpu_torch/csrc/masked_conv_inverse.cu``) against its
cluster sizes and variants of its own source on one NVIDIA GPU, all in one
process, so that they share a card.

    python3 tools/torch_k5_variants.py

Each variant is a text substitution in the source, built with nvcc into
``build/k5_variants/<name>/`` and loaded with ctypes in place of the port's
library, and a cluster size per hidden width (None: the plan,
``masked_conv.k5_cluster``).  A variant that keeps the function is held
against the plain version within 1e-4 and must repeat bitwise; an ablation
(a name starting with ``ablate``) drops a piece of the work to show its
cost, and only its error is printed.  The cases are one flow at B = 40,
hid = 4C, 128 conditioning channels: the level-0 flow (8x8, C = 32), the
8x16 latent of the cINN inverse in orders A (8 rows of 16 columns) and C
(16 rows of 8) at C = 32, and order A at C = 16 and C = 4.  Then each
variant's time per launch (CUDA events over 50 launches through the C
entry point alone, the variants in turns, three rounds), and the plan's
time per call of the Python wrapper, whose host work (checks, aligned
copies, the output, the ctypes call) can exceed a short kernel's.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ipoke_tpu_torch.ops import _build, masked_conv  # noqa: E402

SRC = "masked_conv_inverse.cu"
PLAN = masked_conv.k5_cluster
ROW_LOOP = "  for (int i = 0; i < H; ++i) {\n    const int row = reverse ? H - 1 - i : i;"
# (source substitutions, cluster size by hid or None for the plan)
VARIANTS = {
    "k5": ([], None),
    # more CTAs per item than the plan: 8 at hid = 128, 4 at 64, 2 at 16
    "k5_wider_cluster": ([], lambda hid: 2 * PLAN(hid)),
    # partials pushed into every peer's shared memory (k slots a parity),
    # then read locally, in place of pulled from the peers
    "k5_push_partials": ([
        ("round4(2 * d.W * 2 * d.C)", "round4(2 * d.k * d.W * 2 * d.C)"),
        ("float* xp = xpart + (i & 1) * W * twoC;",
         "float* xp = xpart + (i & 1) * d.k * W * twoC;"),
        ("if (wb + u * wstep < W) xp[(wb + u * wstep) * twoC + k_out] = acc[u];",
         "if (wb + u * wstep < W)\n"
         "            for (int r = 0; r < d.k; ++r)\n"
         "              cluster.map_shared_rank(xp + rank * W * twoC, r)"
         "[(wb + u * wstep) * twoC + k_out] = acc[u];"),
        ("const float* pr = (r == rank ? xp : cluster.map_shared_rank(xp, r)) + w * twoC;",
         "const float* pr = xp + (r * W + w) * twoC;")], None),
    # the weight slice's bulk copies issued by warp 0 alone
    "k5_fetch_warp0": ([
        ("for (int r = tid; r < taps; r += THREADS)",
         "for (int r = tid; r < taps && tid < 32; r += 32)"),
        ("if (tid == THREADS - 1)\n      bulk_load(wh", "if (tid == 0)\n      bulk_load(wh")],
        None),
    # up to 255 registers a thread (one CTA's worth of registers per SM)
    "k5_regs255": ([("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 1)")],
                   None),
    # no rows: launch, weight slice, ring and the final cluster barrier
    "ablate_k5_rows": ([(ROW_LOOP, ROW_LOOP.replace("i < H", "i < 0"))], None),
    # no weight slice copied (the kernel waits on an empty transaction)
    "ablate_k5_weight_fetch": ([
        ("mbar_expect_tx(bb, (uint32_t)(taps + twoC) * nj * 4)", "mbar_expect_tx(bb, 0)"),
        ("  if (nj > 0) {\n    for (int r = tid;", "  if (false) {\n    for (int r = tid;")],
     None),
    # the row's cluster barrier also in clusters of one CTA
    "k5_cluster_barrier_at_k1": ([
        ("if (d.k > 1) cluster.sync(); else __syncthreads();", "cluster.sync();")], None),
    # a CTA barrier in place of the row's cluster barrier
    "ablate_k5_cluster_barrier": ([
        ("if (d.k > 1) cluster.sync(); else __syncthreads();", "__syncthreads();")], None),
    # the CTA's own partial k times in place of the peers' (no DSMEM read)
    "ablate_k5_dsmem_reads": ([("cluster.map_shared_rank(xp, r)", "xp")], None),
    # no tap products (the window is still read)
    "ablate_k5_tap_fma": ([(
        "                acc[c] = fmaf(v.x, wr[q][0][dx], acc[c]);\n"
        "                acc[c] = fmaf(v.y, wr[q][1][dx], acc[c]);\n"
        "                acc[c] = fmaf(v.z, wr[q][2][dx], acc[c]);\n"
        "                acc[c] = fmaf(v.w, wr[q][3][dx], acc[c]);\n",
        "                acc[c] += v.x;\n")], None),
    # no window read in the tap dot (the products stay)
    "ablate_k5_window_loads": ([(
        "const float4 v = *reinterpret_cast<const float4*>(src + col * Cp);",
        "const float4 v = make_float4(col, col + 1.f, qq, (float)(size_t)src);")], None),
    # no tanhf or division in the affine
    "ablate_k5_affine_math": ([(
        "        const float scale = tanhf(ls * 0.5f) * alpha + 1.0f;\n"
        "        const float v = (yv[a] - mu) / (scale + 1e-12f);\n",
        "        const float v = yv[a] - mu + ls;\n")], None),
    # no out product
    "ablate_k5_out_product": ([("for (int j = 0; j < nj; j += 4) {",
                                "for (int j = 0; j < 0; j += 4) {")], None),
    # no y or hc loaded
    "ablate_k5_row_loads": ([
        ("        yv[a] = __ldg(yb + (size_t)row * n_aff + idx);\n"
         "        hmu[a] = __ldg(p);\n        hls[a] = __ldg(p + C);\n", "")], None),
}
# (H, W, C, order) at B = 40, hid = 4C, Ch = 128
CASES = ((8, 8, 32, "A"), (8, 16, 32, "A"), (8, 16, 32, "C"), (8, 16, 16, "A"),
         (8, 16, 4, "A"))
OUT = ROOT / "build" / "k5_variants"


def build(name):
    subs, _ = VARIANTS[name]
    src = (_build.CSRC / SRC).read_text()
    for old, new in subs:
        assert old in src, (name, old)
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / SRC).write_text(src)
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                          "-shared", "-o", str(d / "lib.so"), str(d / SRC)],
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


def operands(dev, gen, hh, ww, c, order, b=40, ch=128):
    """Packed scan-space inputs of one flow, as ``chip_smoke.py`` makes them."""
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    hid, transposed = 4 * c, order in "CD"
    params = {"w_shift": randn(*((3, 2) if transposed else (2, 3)), c, hid) * (6 * c) ** -0.5,
              "out": {"v": randn(1, 1, hid + ch, 2 * c) * 0.05,
                      "g": randn(2 * c) * 0.3, "b": randn(2 * c) * 0.1}}
    y, h = randn(b, hh, ww, c), randn(b, hh, ww, ch)
    ys = (y.transpose(1, 2) if transposed else y).contiguous()
    packed = [t.contiguous() for t in masked_conv.pack_mcf(
        F.elu(h), params, transposed, b, hh, ww)]
    return (ys, *packed, 1.0, order in "BD")


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
    args = {case: operands(dev, gen, *case) for case in CASES}

    def use(name):
        _build._lib = built[name][0]
        masked_conv.k5_cluster = VARIANTS[name][1] or PLAN

    for name, (_, report) in built.items():
        use(name)
        errs = []
        for case, a in args.items():
            got = masked_conv.masked_conv_inverse_cuda(*a)
            want = masked_conv.masked_conv_inverse_plain(*a)
            errs.append((got - want).abs().max().item())
            if not name.startswith("ablate") and not (
                    errs[-1] <= 1e-4 and torch.equal(got, masked_conv.masked_conv_inverse_cuda(*a))):
                raise AssertionError(f"{name} {case}: off the plain version or not repeatable")
        print(f"{name}: ptxas {'; '.join(report)}; clusters of "
              f"{[masked_conv.k5_cluster(4 * c) for _, _, c, _ in CASES]}; max error at "
              f"{list(args)}: " + ", ".join(f"{e:.2e}" for e in errs)
              + ("" if name.startswith("ablate") else ", two calls bitwise equal"))

    def launch(case):
        """The C entry point alone on the case's inputs (as the wrapper
        passes them), for the current variant and cluster size."""
        y, w_shift, w_hid, hc, alpha, reverse = args[case]
        b, hh, ww, c = y.shape
        x = torch.empty_like(y)
        k = masked_conv.k5_cluster(4 * c)
        cargs = (y.data_ptr(), w_shift.data_ptr(), w_hid.data_ptr(), hc.data_ptr(),
                 x.data_ptr(), None, b, hh, ww, c, 4 * c, 2, 3, alpha, int(reverse), k,
                 torch.cuda.current_stream().cuda_stream)
        fn = _build._lib.masked_conv_inverse

        def run():
            _build.check(fn(*cargs), "masked_conv_inverse")
            return x  # held until the launches are timed
        return run

    times = {n: {c: [] for c in CASES} for n in built}
    wrapper = {c: [] for c in CASES}
    for _ in range(3):
        for n in built:
            use(n)
            for c in CASES:
                times[n][c].append(ms_per_call(launch(c)))
        use("k5")
        for c in CASES:
            wrapper[c].append(ms_per_call(lambda: masked_conv.masked_conv_inverse_cuda(*args[c])))
    masked_conv.k5_cluster = PLAN
    for n, by_case in times.items():
        print(f"{n} ms per launch: " + "; ".join(
            f"{c} " + ", ".join(f"{t:.4f}" for t in ts) for c, ts in by_case.items()))
    print("k5 ms per wrapper call: " + "; ".join(
        f"{c} " + ", ".join(f"{t:.4f}" for t in ts) for c, ts in wrapper.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
