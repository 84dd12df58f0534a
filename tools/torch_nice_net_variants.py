#!/usr/bin/env python3
"""Time K1 (``ipoke_tpu_torch/csrc/nice_net.cu``) against variants of its own
source on one NVIDIA GPU, all in one process, so that they share a card.

    python3 tools/torch_nice_net_variants.py

Each variant is a text substitution in the source, built with nvcc into
``build/nice_net_variants/<name>/`` and loaded with ctypes in place of the
port's library.  For each: the error of u, a and b against the plain version
at the level-0 shapes and at ragged ones, u bitwise equal over two calls,
then K1's time per call (CUDA events over 50 calls, the variants and the
bf16 ``torch.matmul`` chain in turns, four rounds) and each stage's time
(``torch.profiler``) at M = 2560 and 5120 (C1 = 16, Hid = 2048, Cout = 32).
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from ipoke_tpu_torch.ops import _build, nice_net  # noqa: E402

VARIANTS = {
    "shipped": [],
    # the accurate expm1f in the ELU epilogue
    "expm1f": [("return v > 0.f ? v : __expf(v) - 1.f;",
                "return v > 0.f ? v : expm1f(v);")],
    # two CTAs per SM with a 3-stage ring each
    "2cta_3stages": [("STAGES = 4;", "STAGES = 3;"),
                     ("__launch_bounds__(THREADS, 1)", "__launch_bounds__(THREADS, 2)")],
}
RAGGED = ((100, 5, 128, 3), (2577, 16, 384, 32), (100, 30, 128, 32), (512, 16, 256, 32))
OUT = ROOT / "build" / "nice_net_variants"


def build(name):
    src = (_build.CSRC / "nice_net.cu").read_text()
    for old, new in VARIANTS[name]:
        assert old in src, (name, old)
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "nice_net.cu").write_text(src)
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                          str(d / "lib.so"), str(d / "nice_net.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(d / "lib.so"))
    lib.nice_net_u.argtypes = list(_build.SIGNATURES["nice_net_u"])
    lib.nice_net_u.restype = ctypes.c_int
    return lib


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


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(zip(VARIANTS, ex.map(build, VARIANTS)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1)

    def operands(m, c1, hid, cout):
        randn = lambda *s: torch.randn(s, generator=gen, device=dev)
        return (randn(m, 9 * c1).bfloat16(),
                (randn(9 * c1, hid) * (9 * c1) ** -0.5).bfloat16(),
                (randn(hid, hid) * hid ** -0.5).bfloat16(),
                (randn(hid, 9 * cout) * (9 * hid) ** -0.5).bfloat16())

    shapes = {m: operands(m, 16, 2048, 32) for m in (2560, 5120)}
    ragged = [operands(*case) for case in RAGGED]
    for name, lib in libs.items():
        _build._lib = lib
        errs = []
        for x in [shapes[2560], *ragged]:
            got = nice_net.nice_net_train_cuda(*x)
            want = nice_net.nice_net_train_plain(*x)
            errs.append(max((g.float() - w.float()).abs().max().item()
                            for g, w in zip(got, want)))
            if not torch.equal(got[0], nice_net.nice_net_cuda(*x)):
                raise AssertionError(f"{name}: u not bitwise equal over two calls")
        print(f"{name}: max error of u, a, b at level 0 and {RAGGED}: "
              + ", ".join(f"{e:.2e}" for e in errs) + "; u bitwise equal over calls")
    chain = lambda x: F.elu(F.elu(x[0] @ x[1]) @ x[2]) @ x[3]
    times = {name: {m: [] for m in shapes} for name in [*libs, "bf16 chain"]}
    for _ in range(4):
        for name in times:
            for m, x in shapes.items():
                if name == "bf16 chain":
                    times[name][m].append(ms_per_call(lambda: chain(x)))
                else:
                    _build._lib = libs[name]
                    times[name][m].append(ms_per_call(lambda: nice_net.nice_net_cuda(*x)))
    for name, by_m in times.items():
        print(f"{name} ms per call: " + "; ".join(
            f"M={m} " + ", ".join(f"{t:.4f}" for t in ts) for m, ts in by_m.items()))
    for name, lib in libs.items():
        _build._lib = lib
        line = []
        for m, x in shapes.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(30):
                    nice_net.nice_net_cuda(*x)
                torch.cuda.synchronize()
            stages = sorted((e.key[e.key.find("nice_net_stage"):][:17],
                             e.self_device_time_total / e.count / 1e3)
                            for e in prof.key_averages() if "nice_net_stage" in e.key)
            line.append(f"M={m} " + ", ".join(f"{k} {t:.4f}" for k, t in stages))
        print(f"{name} ms per stage: " + "; ".join(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
