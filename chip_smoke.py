#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sampling path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  (a) device: the card's name and power limit (nvidia-smi); CUDA required.
  (b) build: the CUDA kernels from ipoke_tpu_torch/csrc (nvcc, sm_90a).
  (c) each kernel against its plain PyTorch version on the card, at the
      shipped shapes, TF32 off for the plain side: max error and both times.
  (d) the SMALL config end to end in bf16: the same weights and z on the
      card (kernels) and on the CPU (plain versions); frames compared, and
      the kernel launch counts of the card's pass checked.
  (e) the SHIPPED config (128 px, B=40, T=10, the 1054.43M-param cINN) in
      bf16: one pass with the launch counts zeroed before and read after
      (the main path's run), then 3 timed passes.

The line before the last is ``{"kernels": [...]}``: per kernel its route,
source, the TPU kernel it replaces, its launches in the SHIPPED pass, its
largest error over the phase (c) cases, and ``ms``/``plain_ms`` per call at
the first phase (c) case (the level-0 shapes; K3: the 128 px decode level).
The last line is ``{"ok": true, "device": {...}}``.
"""

import copy
import json
import subprocess
import sys
import time

import torch

K1_CASES = ((16, 32), (30, 4))  # (C1, Cout): level-0 step coupling, prior
K2_CASES = (32, 4)              # MCF channels C at the first and last level
K3_CASES = ((128, 64), (64, 128), (32, 256), (16, 256))  # (S, Ch) of the decode
K1_TOL, K2_TOL, K3_TOL = 5e-2, 1e-4, 3e-2
# SMALL, card vs CPU, both bf16, couplings perturbed at 0.03: each side sits
# within bf16 noise of the fp32 result, and they round at different places
# (cuDNN vs oneDNN conv sums, kernel vs plain sum order).  On the CPU, bf16 vs
# fp32 at this config differs by 0.12 max / 0.0073 mean on the frames (tanh
# bounds them to [-1, 1]); two bf16 runs may sit on opposite sides, so the
# bound is twice that with margin.  A wrong kernel moves the flow output by
# O(1) everywhere and the mean far past it.
SMALL_PERTURB = 0.03
SMALL_MAX_TOL, SMALL_MEAN_TOL = 0.25, 2e-2


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


def check_close(name, got, want, tol, rel=0.0):
    err = (got.float() - want.float()).abs()
    bound = tol + rel * want.float().abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"{name}: max error {err.max().item():.3e} over "
                             f"tolerance {tol} (+{rel}*|want|)")
    return err.max().item()


def phase_kernels(dev):
    from ipoke_tpu_torch.ops import masked_conv, nice_net, spade_gn

    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    out = {}

    m, hid = 40 * 8 * 8, 2048
    errs, times = [], []
    for c1, cout in K1_CASES:
        zcol = randn(m, 9 * c1).bfloat16()
        w1 = (randn(9 * c1, hid) * (9 * c1) ** -0.5).bfloat16()
        w2 = (randn(hid, hid) * hid ** -0.5).bfloat16()
        wp = (randn(hid, 9 * cout) * (9 * hid) ** -0.5).bfloat16()
        got = nice_net.nice_net_cuda(zcol, w1, w2, wp)
        want = nice_net.nice_net_plain(zcol, w1, w2, wp)
        err = check_close(f"K1 C1={c1} Cout={cout}", got, want, K1_TOL, K1_TOL)
        ms = cuda_ms(lambda: nice_net.nice_net_cuda(zcol, w1, w2, wp), 20)
        plain = cuda_ms(lambda: nice_net.nice_net_plain(zcol, w1, w2, wp), 20)
        print(f"K1 nice_net M={m} C1={c1} Hid={hid} Cout={cout}: max_abs_err "
              f"{err:.3e} (tol {K1_TOL} abs+rel), kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms")
        errs.append(err)
        times.append((ms, plain))
    out["nice_net"] = (max(errs), *times[0])

    errs, times = [], []
    b, s, ch = 40, 8, 128
    for c in K2_CASES:
        hid = 4 * c
        mcf = []
        for _ in range(4):
            v = randn(1, 1, hid + ch, 2 * c) * 0.05
            mcf.append({"w_shift": randn(2, 3, c, hid) * (6 * c) ** -0.5,
                        "out": {"v": v, "g": randn(2 * c) * 0.3,
                                "b": randn(2 * c) * 0.1}})
        for p in mcf[2:]:  # C/D store the kernel dims swapped
            p["w_shift"] = p["w_shift"].transpose(0, 1).contiguous()
        an = [{"log_scale": randn(c) * 0.05, "bias": randn(c) * 0.05}
              for _ in range(2)]
        y, h = randn(b, s, s, c), randn(b, s, s, ch)
        packed = masked_conv.pack_unit(h, mcf, an, b, s, s)
        got = masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)
        want = masked_conv.macow_unit_inverse_plain(y, *packed, 1.0)
        err = check_close(f"K2 C={c}", got, want, K2_TOL)
        ms = cuda_ms(lambda: masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0), 20)
        plain = cuda_ms(lambda: masked_conv.macow_unit_inverse_plain(y, *packed, 1.0), 3)
        print(f"K2 macow_unit_inverse B={b} H=W={s} C={c} hid={hid} Ch={ch}: "
              f"max_abs_err {err:.3e} (tol {K2_TOL}), kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms")
        errs.append(err)
        times.append((ms, plain))
    out["macow_unit_inverse"] = (max(errs), *times[0])

    errs, times = [], []
    for s, ch in K3_CASES:
        x = (randn(400, s, s, ch) * 2.0 + 0.5).bfloat16()
        gamma, beta = (randn(40, s, s, ch) * 0.5).bfloat16(), (randn(40, s, s, ch) * 0.5).bfloat16()
        got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
        want = spade_gn.spade_gn_plain(x, gamma, beta, 16)
        err = check_close(f"K3 S={s} Ch={ch}", got, want, K3_TOL, K3_TOL)
        ms = cuda_ms(lambda: spade_gn.spade_gn_cuda(x, gamma, beta, 16), 20)
        plain = cuda_ms(lambda: spade_gn.spade_gn_plain(x, gamma, beta, 16), 10)
        print(f"K3 spade_gn N=400 S={s} Ch={ch} G=16 bf16: max_abs_err "
              f"{err:.3e} (tol {K3_TOL} abs+rel), kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms")
        errs.append(err)
        times.append((ms, plain))
    out["spade_gn"] = (max(errs), *times[0])
    return out


def expected_launches(cfg):
    steps = sum(cfg["num_steps"])
    return {"nice_net": 4 * steps + len(cfg["num_steps"]),
            "macow_unit_inverse": 4 * steps,
            "spade_gn": len(cfg["dec_ch"]) - 1}


def check_launches(name, want):
    from ipoke_tpu_torch import ops

    got = dict(ops.LAUNCHES)
    print(f"{name} kernel launches: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{name}: launches {got} != {want}")
    return got


def phase_small(dev):
    from ipoke_tpu_torch import entry, ops

    cfg = entry.SMALL
    gen = torch.Generator().manual_seed(0)
    model_cpu = entry.build(cfg, "cpu", gen)
    entry.perturb(model_cpu, gen, SMALL_PERTURB, SMALL_PERTURB)
    model_f32 = copy.deepcopy(model_cpu)
    model_cpu = model_cpu.to(torch.bfloat16)
    model_gpu = copy.deepcopy(model_cpu).to(dev)
    batch_cpu = entry.make_batch(cfg, "cpu", torch.bfloat16, seed=0)
    batch_gpu = {k: v.to(dev) for k, v in batch_cpu.items()}
    s = cfg["min_spatial"]
    z = torch.randn((cfg["batch_size"], s, s, cfg["z_dim"]),
                    generator=gen).bfloat16()

    ops.reset_launches()
    t0 = time.perf_counter()
    frames = model_gpu.forward_sample(batch_gpu, cfg["T"], z=z.to(dev))
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    check_launches("SMALL", expected_launches(cfg))
    t0 = time.perf_counter()
    ref = model_cpu.forward_sample(batch_cpu, cfg["T"], z=z)
    t_cpu = time.perf_counter() - t0
    shape = (cfg["batch_size"], cfg["T"], cfg["spatial"], cfg["spatial"], 3)
    if tuple(frames.shape) != shape or not bool(torch.isfinite(frames).all()):
        raise AssertionError(f"SMALL frames {tuple(frames.shape)} not finite {shape}")
    diff = (frames.cpu().float() - ref.float()).abs()
    ref32 = model_f32.forward_sample(
        {k: v.float() for k, v in batch_cpu.items()}, cfg["T"], z=z.float())
    drift = (ref.float() - ref32).abs()
    print(f"SMALL CPU bf16 vs CPU fp32 (bf16 noise): frames max "
          f"{drift.max().item():.3e} mean {drift.mean().item():.3e}")
    with torch.no_grad():
        motion = lambda m, b, zz: m.flow.inverse(
            m.flow_params.tree(), zz, m.embed_conditioning(b))
        m_err = max_err(motion(model_gpu, batch_gpu, z.to(dev)).cpu(),
                        motion(model_cpu, batch_cpu, z))
    print(f"SMALL bf16 card vs CPU: frames max_abs_err {diff.max().item():.3e} "
          f"mean_abs_err {diff.mean().item():.3e} (tol max {SMALL_MAX_TOL}, "
          f"mean {SMALL_MEAN_TOL}); flow output max_abs_err {m_err:.3e}; "
          f"card pass {t_gpu:.2f} s (first, with compiles), CPU pass {t_cpu:.2f} s")
    if diff.max().item() > SMALL_MAX_TOL or diff.mean().item() > SMALL_MEAN_TOL:
        raise AssertionError("SMALL: card frames disagree with the CPU port")


def phase_shipped(dev, smi):
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.flows import count_params

    cfg = entry.SHIPPED
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = entry.build(cfg, dev, gen)
    entry.perturb(model, gen)
    model = model.to(torch.bfloat16)
    batch = entry.make_batch(cfg, dev, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_flow = count_params(model.flow_params.tree())
    print(f"SHIPPED built in {time.perf_counter() - t0:.1f} s: flow params "
          f"{n_flow / 1e6:.2f}M")
    if round(n_flow / 1e6, 2) != 1054.43:
        raise AssertionError(f"flow params {n_flow} != 1054.43M")

    ops.reset_launches()  # the main path's run
    frames = model.forward_sample(batch, cfg["T"], gen)
    torch.cuda.synchronize()
    launches = check_launches("SHIPPED pass", expected_launches(cfg))
    shape = (cfg["batch_size"], cfg["T"], cfg["spatial"], cfg["spatial"], 3)
    if tuple(frames.shape) != shape or not bool(torch.isfinite(frames).all()):
        raise AssertionError(f"SHIPPED frames {tuple(frames.shape)}: want "
                             f"finite {shape}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.forward_sample(batch, cfg["T"], gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * sum(times) / len(times)
    print(f"SHIPPED bf16 B={cfg['batch_size']} T={cfg['T']} "
          f"{cfg['spatial']}px: {ms:.1f} ms/pass "
          f"({', '.join(f'{1e3 * t:.1f}' for t in times)}), "
          f"{cfg['batch_size'] / (ms / 1e3):.2f} clips/s on {smi}; frames "
          f"{tuple(frames.shape)} finite")
    return launches


def main():
    # (a) device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # (b) build
    from ipoke_tpu_torch.ops import _build

    lib = _build.build()
    _build.load()
    print(f"built {lib.name} in {_build.build_seconds or 0.0:.1f} s")
    for line in lib.with_suffix(".so.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # (c) kernels vs plain versions
    kernels = phase_kernels(dev)
    # (d) SMALL end to end
    phase_small(dev)
    # (e) SHIPPED
    launches = phase_shipped(dev, smi)

    meta = {
        "nice_net": ("cuda", "ipoke_tpu_torch/csrc/nice_net.cu",
                     "ipoke_tpu/ops/nice_net.py:127"),
        "macow_unit_inverse": ("cuda", "ipoke_tpu_torch/csrc/macow_unit_inverse.cu",
                               "ipoke_tpu/ops/masked_conv.py:215"),
        "spade_gn": ("triton", "ipoke_tpu_torch/ops/spade_gn.py",
                     "ipoke_tpu/ops/spade_gn.py:232"),
    }
    rows = []
    for name, (route, source, replaces) in meta.items():
        err, ms, plain = kernels[name]
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
