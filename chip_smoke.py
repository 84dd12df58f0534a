#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sampling pass, second-stage train step,
first-stage VAE-GAN train step, conv third stage, CLI, ``--test`` modes, FC
tower and FC third stage on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

  (a) device: the card's name and power limit (nvidia-smi); CUDA required.
  (b) build: the CUDA kernels from ipoke_tpu_torch/csrc (nvcc, sm_90a).
  (c) each kernel against its plain PyTorch version on the card, at the
      shipped shapes, TF32 off for the plain side: max error and both times;
      K1 at the level-0 step coupling, a prior, the 8x16 latent's level 0
      and SMALL's Hid = 256; K2 at the 8x8 units of the first, a middle and
      the last level (C = 32, 18, 4) and a 16x16 latent, with its shared
      memory (held against ``k2_smem_bytes``) and the clusters the card
      holds at once; K3 at the four decode levels in bf16 and the 128 px
      level in fp32, with its cluster plan; each case's bound and share of
      it, and two calls bitwise equal; then K3's backward at the 32 px
      level in bf16 and fp32: gradients through K3 and the portable VJP
      against autograd of the plain version.
  (c') K4 against its plain version (u, a, b), its u bitwise equal to K1's,
      and autograd gradients through K4 against autograd of the plain
      coupling net, in bf16.
  (c) K5 against its plain version: the level-0 flow and the 8x16 latent
      in orders A-D, C=4 at 8x8 and 8x16, C=16 at 8x16 and a 32x32x32
      latent; each with two calls bitwise equal, its shared memory (held
      against ``k5_smem_bytes``), its cluster size and the clusters the
      card holds at once, its time, bound and share of it.
  (c'') K2 against the per-flow route (4 K5 + 2 ActNorm inverses) on one
      level-0 unit with perturbed out convs and ActNorms; both timed.
  (d) the SMALL config sampling end to end in bf16: the same weights and z
      on the card (kernels) and on the CPU (plain versions); frames
      compared, and the kernel launch counts of the card's pass checked.
  (e) the SHIPPED config (128 px, B=40, T=10, the 1054.43M-param cINN) in
      bf16: one sampling pass with the launch counts zeroed before and read
      after (the sampling path's run), then 3 timed passes, then one under
      ``torch.profiler``: device time by kernel against the pass's wall
      time, and K1's, K2's and K3's device time over the pass.
  (f) the SMALL config trained 3 steps in bf16 with fp32 masters at a
      constant lr, card against CPU from the same post-DDI weights: losses
      compared, launch counts of every card step checked.
  (g) the SHIPPED config trained: fp32 DDI on the batch, couplings
      perturbed, bf16 params with fp32 AMSGrad masters; one step with the
      launch counts zeroed before and read after (the train path's run),
      then 3 steps timed with CUDA events: ms/step, clips/s, peak memory;
      then one step split into its parts on the host clock (each closed by
      a synchronize) and one under ``torch.profiler``: device launches,
      device time by kernel, against the step's wall time, and K1/K4's
      device time per call and per stage kernel.
  (h) the SHIPPED-width cINN at a non-square 8x16 latent, where no unit
      fits K2 and every masked-conv flow goes through K5: an fp32 round
      trip (forward, then inverse with the launch counts checked), then in
      bf16 one inverse with the launch counts zeroed before and read after
      (this path's run), 3 timed inverses and one under ``torch.profiler``:
      device launches, device time against the inverse's wall time, and
      K1's and K5's device time per call; then the SMALL-width flow inverse
      at 8x16 in bf16, card against CPU.
  (i) the first-stage VAE-GAN train step (config/first_stage.yaml: 64 px,
      B=20, T=10, fp32): (i1) K3 at the decoder's training shapes (fp32,
      20 frames, one modulation per frame, 16/32/64 px) against its plain
      version, bitwise repeated, with its bound, and its backward; (i2) the
      TINY config 3 steps card against CPU; (i3) the yaml config: one step
      with the launch counts zeroed before and read after (this path's run),
      every net checked to move, 3 steps timed with CUDA events (ms/step,
      clips/s, peak memory), a host split of one step and a
      ``torch.profiler`` table of one step with K3's in-situ time.
  (j) the conv third stage (config/flow_motion.yaml and flow_vae.yaml, fp32):
      (j1) K2 without conditioning rows at the bridge's units (B=32, 8x8,
      C=32 and 28) and K3 at the flow-to-video decode's levels (320 frames
      of 32 clips), each against its plain version, bitwise repeated, with
      its bound; (j2) FLOW_MOTION_TINY card against CPU: hallucinated flow,
      video from flow, 2 bridge and 2 flow-VAE steps by the (i2) rule; (j3)
      FLOW_MOTION at full width (the bridge over the 1054.43M-param cINN at
      64 px, B=32): hallucinated flow, video from flow, the bridge step and
      the flow-VAE step (B=64), each with the launch counts zeroed before
      and read after (the path's run), then 3 timed runs with the peak
      memory; a host split of one bridge step and a ``torch.profiler``
      table of one video pass with K2's and K3's in-situ time.
  (k) the port's CLI, ``ipoke_tpu_torch.main.run(argv)``, through the conv
      pipeline on a synthetic 64 px PlantDataset tree written by the port's
      ``make_synthetic_dataset``, from the shipped YAMLs (data, epochs,
      CLI_BATCHES train and 1 val batch, frozen run dirs and second_stage's
      depth changed; widths as shipped): k1 img_encoder, k2 poke_encoder,
      k3 first_stage, k4 second_stage (bf16 with fp32 masters, B=40; one
      epoch, a restore check that the state a resume loads is the run's own
      bit for bit, then --resume for one more epoch: step and lr count go
      on, DDI does not rerun), k5 flow_vae and flow_motion over k4's and
      k5's runs.  Each run with the launch counts zeroed before and read
      after (the CLI path's run, checked against ``expected_cli_launches``);
      per run ms/step after the first, the loader's wait per step, the
      wait in each step's closing synchronize and its cudaMalloc calls, a
      host probe (us per launch of a one-element add, just before the
      run), validation seconds and metrics (finite), checkpoint bytes and
      save seconds, restore seconds, peak memory.  The tree and run dirs live in
      a temporary directory (``cli_tree``) that is removed after phase (l).
  (l) the ``--test`` modes: (l1) LPIPS (3 and 2 channels) and PoseResNet-50
      on 400 frames at 64 px, I3D on 8 clips of (10, 64, 64), and the MSE,
      VGG and LPIPS diversity scores, card against the CPU port (fp32, TF32
      off; tolerances at ``EVAL_TOL``), with the card's ms per call; (l2)
      ``main.run([... "--test", mode, "--debug"])`` for samples, fvd,
      accuracy, diversity, control_sensitivity, transfer and kps_acc on
      (k)'s second-stage run (the YAML's batch of 40: data.test_batch_size),
      each with the launch counts zeroed before and read after (the path
      ``test_<mode>``) and held against ``expected_test_launches``, its
      artifacts and finite metrics checked, seconds per mode and per
      sampling pass, peak memory; then ``--test realism`` raises.  Alone:
      ``_build.load()``, then ``with cli_tree() as tree:``
      ``phase_cli(dev, smi, tree)``, ``phase_eval_nets(dev, smi)``,
      ``phase_test_modes(dev, smi, tree)`` (~3 min of command time).
      The modes sample in fp32 on the mixed second stage too (its bf16
      weights upcast, the batch uncast, as the JAX package's modes do), so
      K1 runs in none of them.  Every ``main.run`` of (k), (l) and (m)
      starts with both TF32 switches on and must leave them off
      (``run_cli``).
  (m) the FC tower (fp32): (m1) K3 at the FC generator's levels (8x8x256,
      16x16x128, 32x32x64) in training (20 frames, one modulation each)
      and sampling (400 frames of 40 clips), against its plain version,
      bitwise repeated, with its bound, and its backward at 32 px; (m2)
      ``entry.FC_TINY`` card against the CPU port by the (i2) rule: 2 FCAE
      (BigAE VAE-GAN) steps, 2 first_stage_fc steps, the flat flow's
      forward and inverse, a second_stage_fc sampling pass and 2 of its
      steps; (m3) ``main.run`` from the shipped YAMLs on (k)'s tree
      (``FC_RUNS``; widths and batches as shipped, 1 epoch of CLI_BATCHES
      train and 1 val batch, the FC baseline's runs at 32 px, the size its
      four dec_channels render), each run recorded as in (k) with its
      launches against ``expected_cli_launches`` (path ``fc_<run>``), then
      second_stage_fc's restore check and ``--resume``; (m4) the seven
      ``--test`` modes on (m3)'s second_stage_fc run (path
      ``test_fc_<mode>``).  The conv runs' dirs are removed before (m3).
      Alone: ``_build.load()``, then ``phase_fc_kernels(dev)``,
      ``phase_fc_tiny(dev)``, and ``with cli_tree() as tree:``
      ``phase_fc_cli(dev, smi, tree)``, ``phase_test_modes(dev, smi, tree,
      fc=True)``.
  (n) the FC third stage (config/third_stage_fc.yaml, fp32): (n1) K3 at its
      sample_video decode's levels (320 frames of 32 clips) against its
      plain version, bitwise repeated, with its bound; (n2)
      ``entry.FC_THIRD_TINY`` card against the CPU port, unconditioned and
      conditioned: 2 steps by the (i2) rule, the residual-seeded extract, a
      base-sampled flow and sample_video's frames within FC_TINY_TOL; (n3)
      ``main.run`` of the YAML at its width (the 0.69G-param flat INN, B =
      32, 32 px as the FC second stage it sits on) on a 32 px
      flow_encoder_fc run and (m3)'s runs, recorded as in (k) (paths
      ``fc_third_<run>``), its restore check and ``--resume``; (n4)
      ``--test realism`` and ``accuracy`` on it (paths
      ``test_fc_third_<mode>``, no kernel), sample_video at B = 32, T = 10
      with the launch counts zeroed before and read after (path
      ``third_stage_fc_sample_video``: K3 once a decode level), 3 timed
      calls and a ``torch.profiler`` table with K3's in-situ time; then the
      YAML with ``general.conditional`` for one epoch.  (m3)'s 64 px BigAE
      runs are removed before (n3), each third-stage run once read.  Alone:
      ``_build.load()``, ``phase_fc_third_kernels(dev)``,
      ``phase_fc_third_tiny(dev)``, and after (m3) in the same ``cli_tree``
      ``phase_fc_third_cli(dev, smi, tree)``, ``phase_fc_third_test(dev,
      smi, tree)``.

The line before the last is ``{"kernels": [...]}``: per kernel its route,
source, the TPU kernel it replaces, its launches in the main-path runs
(their sum, and per path), its largest error over the phase (c)/(c') cases,
``ms``/``plain_ms`` per call at the first case (the level-0 shapes; K3: the
128 px decode level; K5: the level-0 flow in order A; device times, see
``cuda_ms``), and its bound there: the larger of the bytes it must move
over 3.35 TB/s and its operations over the peak rate of their type (989
TFLOP/s bf16, 67 TFLOP/s fp32).  The last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import json
import math
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# K1/K4 (M, C1, Hid, Cout): the level-0 step coupling, a prior, the level-0
# coupling of the 8x16 latent (phase h), SMALL's level-0 coupling
K1_CASES = ((2560, 16, 2048, 32), (2560, 30, 2048, 4), (5120, 16, 2048, 32),
            (512, 16, 256, 32))
# K2 (H = W, C) at B = 40, hid = 4C, 128 conditioning channels: the first,
# a middle and the last level's 8x8 unit, and a 16x16 latent
K2_CASES = ((8, 32), (8, 18), (8, 4), (16, 32))
# K3 (S, Ch, dtype) at N = 400 frames of 40 clips, 16 groups: the four decode
# levels in bf16, and the 128 px level in fp32 (slices too large to keep)
K3_CASES = ((128, 64, torch.bfloat16), (64, 128, torch.bfloat16),
            (32, 256, torch.bfloat16), (16, 256, torch.bfloat16),
            (128, 64, torch.float32))
# K5 (B, H, W, C, Ch, order): the level-0 flow in all four orders (A/B
# kernel (2, 3), C/D stored (3, 2)), the 8x16 latent of phase (h) in all
# four orders, the last level's C=4 (clusters of 1) at 8x8 and 8x16, C=16
# at 8x16 (clusters of 2), and a 32x32x32 latent that K2 cannot hold
K5_CASES = (*((40, 8, 8, 32, 128, o) for o in "ABCD"),
            *((40, 8, 16, 32, 128, o) for o in "ABCD"),
            (40, 8, 8, 4, 128, "A"), (40, 8, 16, 4, 128, "C"),
            (40, 8, 16, 16, 128, "A"), (40, 32, 32, 32, 128, "A"))
# K3 at the first-stage decoder's training shapes (S, Ch): fp32, the frame
# batch B = 20 rendered one frame at a time, so one modulation per frame
# (t = 1), 16 groups
K3_TRAIN_CASES = ((16, 256), (32, 128), (64, 64))
K3_TRAIN_FRAMES = 20
# K3's backward at the 32 px decode level (S, Ch, frames, clips): autograd
# through spade_gn_modulate (K3 forward, the portable VJP) against autograd
# of spade_gn_plain, in bf16 and fp32
K3_GRAD_CASE = (32, 256, 400, 40)
K1_TOL, K2_TOL, K5_TOL = 5e-2, 1e-4, 1e-4
# K3 against its plain version, abs + rel: bf16 rounds the normalised value
# and each op of the modulation once; the statistics' sums run in another
# order (one bf16 step where normed sits on a rounding edge)
K3_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
# K4's gradients vs autograd of the plain coupling net, both bf16: each
# tensor's max error over its max magnitude.  The two sides round the hidden
# activations and their cotangents to bf16 at different sums (kernel vs
# cuDNN/cuBLAS order), ~2^-8 relative each; a wrong backward is off by O(1).
K4_GRAD_TOL = 5e-2
HBM_BYTES_PER_S, BF16_FLOPS, FP32_FLOPS = 3.35e12, 989e12, 67e12
# ~25 ms at the H100's 1.98 GHz boost clock: longer than the host takes to
# queue one timing's calls of a kernel wrapper
SLEEP_CYCLES = 50_000_000
# SMALL train, card vs CPU, both bf16 from the same post-DDI weights, 3 steps
# at lr 1e-3: relative loss difference.  One step moves the loss by ~60%;
# on the CPU, bf16 against fp32 differs by 5-8% over these steps; card and
# CPU round at different places (cuDNN/cuBLAS vs oneDNN sums, K4 vs plain).
SMALL_TRAIN_LR, SMALL_TRAIN_TOL = 1e-3, 5e-2
# SMALL, card vs CPU, both bf16, couplings perturbed at 0.03: each side sits
# within bf16 noise of the fp32 result, and they round at different places
# (cuDNN vs oneDNN conv sums, kernel vs plain sum order).  On the CPU, bf16 vs
# fp32 at this config differs by 0.12 max / 0.0073 mean on the frames (tanh
# bounds them to [-1, 1]); two bf16 runs may sit on opposite sides, so the
# bound is twice that with margin.  A wrong kernel moves the flow output by
# O(1) everywhere and the mean far past it.
SMALL_PERTURB = 0.03
SMALL_MAX_TOL, SMALL_MEAN_TOL = 0.25, 2e-2
# (h) the latent where no unit fits K2
NONSQUARE = (8, 16)
# (h) SHIPPED-width fp32 round trip z -> forward -> inverse at 8x16, TF32
# off, couplings perturbed at entry.perturb's 0.01: max |x - z| read 9.3e-6
# on an H100 (|y| up to 8): fp32 rounding through 50 steps of near-identity
# couplings.  The bound is ten times that; a wrong K5 row, tap or order
# breaks the inverse by O(1).
ROUNDTRIP_TOL = 1e-4
# (h) SMALL-width flow inverse at 8x16, card vs CPU, both bf16, couplings
# perturbed at SMALL_PERTURB, z and h N(0, 1).  On the CPU, bf16 against
# fp32 of this flow output differs by 0.41 / 0.48 max and 0.022 / 0.021 mean
# (seeds 0 / 1, outputs up to 8 in magnitude); the two bf16 sides may sit on
# opposite sides of the fp32 result, so the bound is twice that with margin.
# A wrong kernel moves the output by O(1) everywhere and the mean far past it.
SMALL_FLOW_MAX_TOL, SMALL_FLOW_MEAN_TOL = 1.0, 5e-2
# (i2) first-stage TINY, card vs CPU, fp32, TF32 off, lr 1e-3: 3 steps, each
# from the same state (the CPU's params, u and Adam moments are loaded into
# the card's nets before the next step), so each step compares fp32 rounding
# only.  Per step:
# * metrics: |card - CPU| <= FS_TINY_TOL * (1 + |CPU|);
# * gradients, as Adam's first moments, leaf by leaf: |card - CPU| <= 3e-4
#   |CPU| + 1e-4 RMS(net's moments) sqrt(numel), the rule of the CPU test
#   against the jitted JAX step (1.3e-4 seen there; the floor covers biases
#   that a one-channel-per-group norm cancels, whose gradient is rounding);
# * params: every entry within 2 lr, at most 1% of a net's entries more than
#   lr / 10 apart.  Adam moves each entry by ~lr whatever its gradient's
#   size, so a gradient of the wrong sign reads only 2 lr: the moments are
#   what hold the backward (cuDNN dgrad, the R1 double backward, GroupNorm).
# On the CPU, fp32 against float64 holds the same rule at the same weights,
# batch and draws (tests/test_torch_first_stage.py).  The batch is the plain
# synthetic one: with N(0, 0.01^2) added per pixel (as the JAX parity test
# adds, against XLA's tie routing in max-pool) fp32 parts from float64 by
# more than the rule on the CPU too, in the generator's first moments.
FS_TINY_LR, FS_TINY_TOL = 1e-3, 1e-3
# (j1) K2 without conditioning rows at the bridge's units (H = W, C): B = 32,
# hid = 4C, the two levels of config/flow_motion.yaml (factor 8: C = 32, then
# 28), out-conv gains drawn at 0.1 (an unconditioned unit with gains of 0.3
# can diverge: tools/torch_k2_f64.py); and K3 in fp32 at the flow-to-video
# decode's levels (S, Ch) of 320 frames of 32 clips
K2_BRIDGE_CASES, K2_BRIDGE_B, K2_BRIDGE_GAIN = ((8, 32), (8, 28)), 32, 0.1
K3_VIDEO_CASES, K3_VIDEO_CLIPS, K3_VIDEO_T = ((16, 256), (32, 128), (64, 64)), 32, 10
# (j2) FLOW_MOTION_TINY, card vs CPU, fp32, TF32 off, the same weights and
# noise tensors, the bridge's and the cINN's couplings perturbed at 0.1:
# hallucinated flow and video frames within TS_TINY_TOL abs + rel (both
# sides fp32, summing in other orders: cuDNN vs oneDNN convs, K2 and K3 vs
# their plain versions; 5.7e-6 and 1.7e-5 read on an NVIDIA H100 80GB HBM3
# at 700 W; a wrong kernel moves the output by O(1)); 2 bridge and 2
# flow-VAE steps at lr TS_LR by the (i2) rule, each from the CPU's state,
# every spectral-norm u and sigma within TS_TINY_TOL
TS_PERTURB, TS_LR, TS_TINY_TOL = 0.1, 1e-3, 1e-3


def cuda_ms(fn, iters):
    """Mean device time of ``fn`` over ``iters`` calls, after one warm call.
    The calls are queued behind a sleep kernel of ``SLEEP_CYCLES``, so that
    the host's work in each call (checks, copies, the launch) leaves no gap
    between them on the card, as long as the host queues them within the
    sleep: the events time the device alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
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


def bound(nbytes, ops, peak):
    """(bound_ms, bound_by): the least time for ``nbytes`` of device memory
    traffic and ``ops`` operations at ``peak`` per second."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def nice_work(m, k1, hid, n, train):
    """(bytes, flops) of K1 (K4 with ``train``): bf16 zcol and weights read
    once, u written in fp32 (and a, b in bf16)."""
    nbytes = 2 * (m * k1 + k1 * hid + hid * hid + hid * n) + 4 * m * n
    if train:
        nbytes += 2 * 2 * m * hid
    return nbytes, 2 * m * (k1 * hid + hid * hid + hid * n)


def unit_work(b, s, c, hid):
    """(bytes, flops) of K2 in fp32: per MCF and pixel 6 tap dots C -> hid
    and the hid -> 2C out dot (hc is precomputed); y and x, the 4 flows'
    weights, hc and the ActNorms once each."""
    pix = b * s * s
    nbytes = 4 * (2 * pix * c + 4 * 6 * c * hid + 4 * hid * 2 * c
                  + 4 * pix * 2 * c + 4 * c)
    return nbytes, 4 * pix * 2 * (6 * c * hid + hid * 2 * c)


def spade_work(frames, clips, s, ch, itemsize):
    """(bytes, flops) of K3 at one level: x and out (``frames``), gamma and
    beta (``clips``) once each; ~8 fp32 operations per element (statistics,
    normalise, modulate)."""
    n_x, n_m = frames * s * s * ch, clips * s * s * ch
    return itemsize * (2 * n_x + 2 * n_m), 8 * n_x


def k5_work(b, hh, ww, c, hid):
    """(bytes, flops) of K5 in fp32: per pixel 6 tap dots C -> hid and the
    hid -> 2C out dot (hc is precomputed); y, x, hc and the flow's weights
    once each."""
    pix = b * hh * ww
    return (4 * (2 * pix * c + 6 * c * hid + hid * 2 * c + pix * 2 * c),
            pix * 2 * (6 * c * hid + hid * 2 * c))


def row(err, times, work, peak):
    ms, plain = times
    bound_ms, bound_by = bound(*work, peak)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def k3_row(name, x, gamma, beta, tol, dtype_flops=FP32_FLOPS):
    """K3 against its plain version at one shape: two calls bitwise equal,
    device times, bound and share of it."""
    from ipoke_tpu_torch.ops import spade_gn

    n, s, _, ch = x.shape
    got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
    err = check_close(name, got, spade_gn.spade_gn_plain(x, gamma, beta, 16), tol, tol)
    if not torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, 16)):
        raise AssertionError(f"{name}: two calls differ")
    ms = cuda_ms(lambda: spade_gn.spade_gn_cuda(x, gamma, beta, 16), 50)
    plain = cuda_ms(lambda: spade_gn.spade_gn_plain(x, gamma, beta, 16), 20)
    bound_ms, bound_by = bound(*spade_work(n, gamma.shape[0], s, ch, x.element_size()),
                               dtype_flops)
    k, resident = spade_gn.spade_gn_plan(s * s, ch, x.element_size())
    print(f"{name} G=16: max_abs_err {err:.3e} (tol {tol} abs+rel), two calls bitwise "
          f"equal, kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; {100 * bound_ms / ms:.1f}% of it); clusters of {k}, slices "
          f"{'kept in' if resident else 'streamed past'} shared memory")
    return {"N": n, "clips": gamma.shape[0], "S": s, "Ch": ch, "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def phase_kernels(dev):
    from ipoke_tpu_torch.ops import _build, masked_conv, nice_net, spade_gn

    gen = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    out = {}

    errs, times = [], []
    for m, c1, hid, cout in K1_CASES:
        zcol = randn(m, 9 * c1).bfloat16()
        w1 = (randn(9 * c1, hid) * (9 * c1) ** -0.5).bfloat16()
        w2 = (randn(hid, hid) * hid ** -0.5).bfloat16()
        wp = (randn(hid, 9 * cout) * (9 * hid) ** -0.5).bfloat16()
        got = nice_net.nice_net_cuda(zcol, w1, w2, wp)
        want = nice_net.nice_net_plain(zcol, w1, w2, wp)
        err = check_close(f"K1 M={m} C1={c1} Hid={hid} Cout={cout}", got, want,
                          K1_TOL, K1_TOL)
        if not torch.equal(got, nice_net.nice_net_cuda(zcol, w1, w2, wp)):
            raise AssertionError(f"K1 M={m} C1={c1}: two calls differ")
        ms = cuda_ms(lambda: nice_net.nice_net_cuda(zcol, w1, w2, wp), 20)
        plain = cuda_ms(lambda: nice_net.nice_net_plain(zcol, w1, w2, wp), 20)
        print(f"K1 nice_net M={m} C1={c1} Hid={hid} Cout={cout}: max_abs_err "
              f"{err:.3e} (tol {K1_TOL} abs+rel), two calls bitwise equal, "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
        errs.append(err)
        times.append((ms, plain))
    m, c1, hid, cout = K1_CASES[0]
    out["nice_net"] = row(max(errs), times[0],
                          nice_work(m, 9 * c1, hid, 9 * cout, False), BF16_FLOPS)
    # a yardstick, used nowhere in the port: the same chain as three bf16
    # cuBLAS products with ELU between them (it keeps a and b too, as K4)
    zcol = randn(m, 9 * c1).bfloat16()
    w1 = (randn(9 * c1, hid) * (9 * c1) ** -0.5).bfloat16()
    w2 = (randn(hid, hid) * hid ** -0.5).bfloat16()
    wp = (randn(hid, 9 * cout) * (9 * hid) ** -0.5).bfloat16()
    chain = cuda_ms(lambda: F.elu(F.elu(zcol @ w1) @ w2) @ wp, 20)
    print(f"bf16 chain of three torch.matmul, M={m} C1={c1} Hid={hid} "
          f"Cout={cout}: {chain:.4f} ms")
    out["nice_net"]["bf16_matmul_chain_ms"] = chain

    errs, times = [], []
    b, ch = 40, 128
    lib = _build.load()
    for s, c in K2_CASES:
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
        err = check_close(f"K2 {s}x{s} C={c}", got, want, K2_TOL)
        if not torch.equal(got, masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)):
            raise AssertionError(f"K2 {s}x{s} C={c}: two calls differ")
        ms = cuda_ms(lambda: masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0), 20)
        plain = cuda_ms(lambda: masked_conv.macow_unit_inverse_plain(y, *packed, 1.0), 2)
        bound_ms, _ = bound(*unit_work(b, s, c, hid), FP32_FLOPS)
        smem = masked_conv.k2_smem_bytes(s, s, c, hid, 2, 3)
        if lib.macow_unit_inverse_smem_bytes(s, s, c, hid, 2, 3) != smem:
            raise AssertionError(f"K2 {s}x{s} C={c}: kernel and k2_smem_bytes disagree")
        print(f"K2 macow_unit_inverse B={b} H=W={s} C={c} hid={hid} Ch={ch}: "
              f"max_abs_err {err:.3e} (tol {K2_TOL}), two calls bitwise equal, "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {1e3 * bound_ms:.2f} "
              f"us ({100 * bound_ms / ms:.1f}% of it); {smem} B of shared memory "
              f"per CTA, {lib.macow_unit_inverse_max_clusters(s, s, c, hid, 2, 3)} "
              f"clusters of {masked_conv.K2_CLUSTER} resident at once")
        errs.append(err)
        times.append((ms, plain))
    s, c = K2_CASES[0]
    out["macow_unit_inverse"] = row(max(errs), times[0], unit_work(b, s, c, 4 * c),
                                    FP32_FLOPS)

    errs, times = [], []
    for s, ch, dtype in K3_CASES:
        x = (randn(400, s, s, ch) * 2.0 + 0.5).to(dtype)
        gamma = (randn(40, s, s, ch) * 0.5).to(dtype)
        beta = (randn(40, s, s, ch) * 0.5).to(dtype)
        tol, name = K3_TOL[dtype], str(dtype).replace("torch.", "")
        got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
        want = spade_gn.spade_gn_plain(x, gamma, beta, 16)
        err = check_close(f"K3 S={s} Ch={ch} {name}", got, want, tol, tol)
        if not torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, 16)):
            raise AssertionError(f"K3 S={s} Ch={ch} {name}: two calls differ")
        del got, want
        ms = cuda_ms(lambda: spade_gn.spade_gn_cuda(x, gamma, beta, 16), 20)
        plain = cuda_ms(lambda: spade_gn.spade_gn_plain(x, gamma, beta, 16), 5)
        work = spade_work(400, 40, s, ch, x.element_size())
        bound_ms, _ = bound(*work, FP32_FLOPS)
        k, resident = spade_gn.spade_gn_plan(s * s, ch, x.element_size())
        clusters = lib.spade_gn_max_clusters(s * s, ch, 16, int(dtype == torch.bfloat16),
                                             k, int(resident))
        print(f"K3 spade_gn N=400 S={s} Ch={ch} G=16 {name}: max_abs_err "
              f"{err:.3e} (tol {tol} abs+rel), two calls bitwise equal, kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.4f} ms "
              f"({100 * bound_ms / ms:.1f}% of it); clusters of {k}, slices "
              f"{'kept in' if resident else 'streamed past'} shared memory, "
              f"{clusters} clusters resident at once")
        errs.append(err)
        times.append((ms, plain))
        del x, gamma, beta
    s, ch, dtype = K3_CASES[0]
    out["spade_gn"] = row(max(errs), times[0], spade_work(400, 40, s, ch, 2),
                          FP32_FLOPS)

    # K3's backward: the gradients of sum(out * r) through K3 and the
    # portable VJP against autograd of the plain version
    s, ch, n, clips = K3_GRAD_CASE
    for dtype in (torch.bfloat16, torch.float32):
        tol, name = K3_TOL[dtype], str(dtype).replace("torch.", "")
        x = (randn(n, s, s, ch) * 2.0 + 0.5).to(dtype)
        gamma = (randn(clips, s, s, ch) * 0.5).to(dtype)
        beta = (randn(clips, s, s, ch) * 0.5).to(dtype)
        r = randn(n, s, s, ch)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
            loss = (fn(*leaves, 16).float() * r).sum()
            return torch.autograd.grad(loss, leaves)

        got = grads(spade_gn.spade_gn_modulate)
        want = grads(spade_gn.spade_gn_plain)
        err = max(check_close(f"K3 grad {g} S={s} Ch={ch} {name}", a, b, tol, tol)
                  for g, a, b in zip(("x", "gamma", "beta"), got, want))
        del got, want
        ms = cuda_ms(lambda: grads(spade_gn.spade_gn_modulate), 5)
        plain = cuda_ms(lambda: grads(spade_gn.spade_gn_plain), 5)
        print(f"K3 spade_gn backward N={n} S={s} Ch={ch} G=16 {name}: gradients "
              f"of x, gamma, beta through K3 + the portable VJP vs autograd of "
              f"the plain version, max_abs_err {err:.3e} (tol {tol} abs+rel); "
              f"forward + backward {ms:.4f} ms, plain {plain:.4f} ms")
        out["spade_gn"]["grad_max_abs_err_" + name] = err
        del x, gamma, beta, r
    return out


def phase_k4(dev):
    """(c') K4: outputs against the plain version, u bitwise K1's, autograd
    gradients against the plain coupling net; kernel and plain times."""
    from ipoke_tpu_torch.flows.macow import NICE2d
    from ipoke_tpu_torch.ops import nice_net

    gen = torch.Generator(device=dev).manual_seed(2)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    errs, times = [], []
    for m, c1, hid, cout in K1_CASES:
        zcol = randn(m, 9 * c1).bfloat16()
        w1 = (randn(9 * c1, hid) * (9 * c1) ** -0.5).bfloat16()
        w2 = (randn(hid, hid) * hid ** -0.5).bfloat16()
        wp = (randn(hid, 9 * cout) * (9 * hid) ** -0.5).bfloat16()
        u, a, b = nice_net.nice_net_train_cuda(zcol, w1, w2, wp)
        want = nice_net.nice_net_train_plain(zcol, w1, w2, wp)
        err = max(check_close(f"K4 {name} M={m} C1={c1} Hid={hid} Cout={cout}",
                              got, ref, K1_TOL, K1_TOL)
                  for name, got, ref in zip("uab", (u, a, b), want))
        if not torch.equal(u, nice_net.nice_net_cuda(zcol, w1, w2, wp)):
            raise AssertionError(f"K4 u M={m} C1={c1} is not bitwise K1's")
        ms = cuda_ms(lambda: nice_net.nice_net_train_cuda(zcol, w1, w2, wp), 20)
        plain = cuda_ms(lambda: nice_net.nice_net_train_plain(zcol, w1, w2, wp), 20)
        print(f"K4 nice_net_train M={m} C1={c1} Hid={hid} Cout={cout}: u, a, b "
              f"max_abs_err {err:.3e} (tol {K1_TOL} abs+rel), u bitwise equal "
              f"to K1's; kernel {ms:.4f} ms, plain {plain:.4f} ms")
        errs.append(err)
        times.append((ms, plain))

    # gradients of sum(sin(raw)) at the level-0 step coupling, bf16
    m, c1, hid, cout = K1_CASES[0]
    nice = NICE2d(2 * c1, hidden_channels=hid)
    params = nice.init(gen, dev)
    params["out"]["g"] = randn(*params["out"]["g"].shape) * 0.3
    params["out"]["b"] = randn(*params["out"]["b"].shape) * 0.1
    leaves = lambda p: [p["w1"], p["w2"], p["out"]["v"], p["out"]["g"],
                        p["out"]["b"]]
    z = randn(40, 8, 8, c1).bfloat16()
    grads = []
    for fn in (lambda p, zz: nice_net.nice_net_raw_train(p, zz, None),
               lambda p, zz: nice._raw(p, zz, None)):
        p = {"w1": params["w1"].bfloat16().requires_grad_(),
             "w2": params["w2"].bfloat16().requires_grad_(),
             "out": {k: v.bfloat16().requires_grad_()
                     for k, v in params["out"].items()}}
        zz = z.clone().requires_grad_()
        loss = torch.sin(fn(p, zz).float()).sum()
        grads.append(torch.autograd.grad(loss, leaves(p) + [zz]))
    rel = []
    for name, got, want in zip(("w1", "w2", "out.v", "out.g", "out.b", "z"), *grads):
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"K4 grad {name}: dtype {got.dtype}, want bf16")
        r = max_err(got, want) / want.float().abs().max().item()
        if not bool(torch.isfinite(got).all()) or r > K4_GRAD_TOL:
            raise AssertionError(f"K4 grad {name}: max error / max |want| "
                                 f"{r:.3e} over {K4_GRAD_TOL}")
        rel.append(f"{name} {r:.2e}")
    print(f"K4 autograd grads vs plain _raw autograd (bf16, max error / max "
          f"|want|, tol {K4_GRAD_TOL}): " + ", ".join(rel))
    return {"nice_net_train": row(max(errs), times[0],
                                  nice_work(m, 9 * c1, hid, 9 * cout, True),
                                  BF16_FLOPS)}


def phase_k5(dev):
    """(c) K5 against its plain version on packed inputs in scan space;
    (c'') K2 against the per-flow route on one unit; kernel and plain
    times."""
    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.flows.base import Chain
    from ipoke_tpu_torch.flows.macow import make_macow_unit
    from ipoke_tpu_torch.ops import _build, masked_conv

    gen = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    lib = _build.load()
    errs, times = [], []
    for b, hh, ww, c, ch, order in K5_CASES:
        hid, transposed, reverse = 4 * c, order in "CD", order in "BD"
        ks = (3, 2) if transposed else (2, 3)  # C/D store the kernel swapped
        params = {"w_shift": randn(*ks, c, hid) * (6 * c) ** -0.5,
                  "out": {"v": randn(1, 1, hid + ch, 2 * c) * 0.05,
                          "g": randn(2 * c) * 0.3, "b": randn(2 * c) * 0.1}}
        y, h = randn(b, hh, ww, c), randn(b, hh, ww, ch)
        ys = (y.transpose(1, 2) if transposed else y).contiguous()
        packed = [t.contiguous() for t in masked_conv.pack_mcf(
            F.elu(h), params, transposed, b, hh, ww)]
        args = (ys, *packed, 1.0, reverse)
        name = f"K5 {order} B={b} {hh}x{ww} C={c}"
        got = masked_conv.masked_conv_inverse_cuda(*args)
        want = masked_conv.masked_conv_inverse_plain(*args)
        err = check_close(name, got, want, K5_TOL)
        if not torch.equal(got, masked_conv.masked_conv_inverse_cuda(*args)):
            raise AssertionError(f"{name}: two calls differ")
        sw = ys.shape[2]  # the row width in scan space
        k = masked_conv.k5_cluster(hid)
        smem = masked_conv.k5_smem_bytes(sw, c, hid, 2, 3, k)
        if lib.masked_conv_inverse_smem_bytes(sw, c, hid, 2, 3, k) != smem:
            raise AssertionError(f"{name}: kernel and k5_smem_bytes disagree")
        errs.append(err)
        ms = cuda_ms(lambda: masked_conv.masked_conv_inverse_cuda(*args), 20)
        bound_ms, bound_by = bound(*k5_work(b, hh, ww, c, hid), FP32_FLOPS)
        line = (f"K5 masked_conv_inverse order {order} B={b} H={hh} W={ww} C={c} "
                f"hid={hid} Ch={ch}: max_abs_err {err:.3e} (tol {K5_TOL}), two "
                f"calls bitwise equal, kernel {ms:.4f} ms, bound "
                f"{1e3 * bound_ms:.2f} us ({bound_by}; {100 * bound_ms / ms:.1f}% "
                f"of it); clusters of {k}, {smem} B of shared memory per CTA, "
                f"{lib.masked_conv_inverse_max_clusters(sw, c, hid, 2, 3, k)} "
                f"clusters resident at once")
        if not times:  # the level-0 flow, order A
            times = (ms, cuda_ms(lambda: masked_conv.masked_conv_inverse_plain(*args), 3))
            line += f"; plain {times[1]:.4f} ms"
        print(line)
    b, hh, ww, c, ch, _ = K5_CASES[0]
    out = row(max(errs), times, k5_work(b, hh, ww, c, 4 * c), FP32_FLOPS)

    # (c'') the level-0 unit (C=32, kernel (2, 3), 128 conditioning
    # channels, hid 128, 8x8, B=40), out convs and ActNorms perturbed: K2
    # in one launch against the chain inverse (4 K5 + 2 ActNorm^-1)
    unit = make_macow_unit(32, (2, 3), h_channels=128)
    uparams = unit.init(gen, dev)
    for p in uparams:
        if "out" in p:
            p["out"]["g"], p["out"]["b"] = randn(64) * 0.3, randn(64) * 0.1
        else:
            p["log_scale"], p["bias"] = randn(32) * 0.05, randn(32) * 0.05
    y, h = randn(40, 8, 8, 32), randn(40, 8, 8, 128)
    k2 = lambda: unit.inverse(uparams, y, h)
    per_flow = lambda: Chain.inverse(unit, uparams, y, h)
    ops.reset_launches()
    got, want = k2(), per_flow()
    torch.cuda.synchronize()
    if (ops.LAUNCHES["macow_unit_inverse"], ops.LAUNCHES["masked_conv_inverse"]) != (1, 4):
        raise AssertionError(f"(c'') launches {ops.LAUNCHES}: want K2 1, K5 4")
    err = check_close("K2 vs per-flow route", got, want, K2_TOL)
    ms_k2, ms_flow = cuda_ms(k2, 20), cuda_ms(per_flow, 20)
    print(f"K2 vs per-flow route (4 K5 + 2 ActNorm^-1) on the level-0 unit "
          f"B=40 8x8 C=32 hid=128 Ch=128: max_abs_err {err:.3e} (tol {K2_TOL}); "
          f"unit inverse with packing: K2 {ms_k2:.4f} ms, per-flow {ms_flow:.4f} ms")
    out.update(unit_k2_vs_per_flow_err=err, unit_k2_ms=ms_k2, unit_per_flow_ms=ms_flow)
    return {"masked_conv_inverse": out}


def expected_launches(cfg):
    """Per sampling pass."""
    steps = sum(cfg["num_steps"])
    return {"nice_net": 4 * steps + len(cfg["num_steps"]),
            "nice_net_train": 0, "macow_unit_inverse": 4 * steps,
            "masked_conv_inverse": 0, "spade_gn": len(cfg["dec_ch"]) - 1}


def expected_train_launches(cfg):
    """Per train step: the remat's no-grad pass runs K1 in each step's 4
    couplings, its recompute K4, and the priors K4 directly."""
    steps = sum(cfg["num_steps"])
    return {"nice_net": 4 * steps,
            "nice_net_train": 4 * steps + len(cfg["num_steps"]),
            "macow_unit_inverse": 0, "masked_conv_inverse": 0, "spade_gn": 0}


def expected_flow_launches(cfg, bf16):
    """Per flow inverse at a latent where no unit fits K2: each step's 4
    units run 4 K5 each; K1 runs in bf16 only (its family, as on the TPU)."""
    steps = sum(cfg["num_steps"])
    return {"nice_net": 4 * steps + len(cfg["num_steps"]) if bf16 else 0,
            "nice_net_train": 0, "macow_unit_inverse": 0,
            "masked_conv_inverse": 16 * steps, "spade_gn": 0}


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
    entry.perturb(model_cpu.flow_params, gen, SMALL_PERTURB, SMALL_PERTURB)
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
    entry.perturb(model.flow_params, gen)
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
    # one pass under the profiler: the card's busy share, and K1's, K2's and
    # K3's device time over all their levels
    _, kernels = profiled("SHIPPED sampling pass",
                          lambda: model.forward_sample(batch, cfg["T"], gen))
    for name, key, calls in (("K1", "nice_net_stage", launches["nice_net"]),
                             ("K2", "macow_unit_inverse_kernel",
                              launches["macow_unit_inverse"]),
                             ("K3", "spade_gn_kernel", launches["spade_gn"])):
        report_in_situ(kernels, "the pass", name, key, calls)
    return launches


def phase_small_train(dev):
    """(f) SMALL, 3 train steps, card against CPU from the same weights."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.train import SecondStageTrainer

    cfg = entry.SMALL
    gen = torch.Generator().manual_seed(0)
    model = entry.build(cfg, "cpu", gen)
    batch = entry.make_batch(cfg, "cpu", seed=0)
    SecondStageTrainer(model, SMALL_TRAIN_LR).ddi(batch)  # fp32
    entry.perturb(model.flow_params, gen, SMALL_PERTURB, SMALL_PERTURB)
    models = {"card": copy.deepcopy(model).to(dev), "cpu": model,
              "cpu fp32": copy.deepcopy(model)}
    models["cpu fp32"].config["training"]["mixed_prec_master"] = False
    want = expected_train_launches(cfg)
    losses = {}
    for name, m in models.items():
        trainer = SecondStageTrainer(m, SMALL_TRAIN_LR)
        trainer.start()
        b = {k: v.to(dev if name == "card" else "cpu") for k, v in batch.items()}
        losses[name] = []
        for step in range(3):
            ops.reset_launches()
            # no generator: the motion latent is mu on both sides
            loss = trainer.train_step(b)["flow_loss"].item()
            if name == "card":
                torch.cuda.synchronize()
                check_launches(f"SMALL train step {step}", want)
            losses[name].append(loss)
    rel = [abs(a - c) / abs(c) for a, c in zip(losses["card"], losses["cpu"])]
    drift = [abs(a - c) / abs(c) for a, c in zip(losses["cpu"], losses["cpu fp32"])]
    print(f"SMALL train bf16, 3 steps at lr {SMALL_TRAIN_LR}: card losses "
          f"{losses['card']}, CPU {losses['cpu']} (rel diff "
          f"{', '.join(f'{r:.2e}' for r in rel)}, tol {SMALL_TRAIN_TOL}); CPU "
          f"fp32 {losses['cpu fp32']} (bf16 drift "
          f"{', '.join(f'{r:.2e}' for r in drift)})")
    if not all(map(math.isfinite, losses["card"])) or max(rel) > SMALL_TRAIN_TOL:
        raise AssertionError("SMALL train: card losses disagree with the CPU port")


def profiled(name, fn):
    """Run ``fn`` once under ``torch.profiler``; print its device launches,
    device time against its (profiled) wall time and the 20 kernels with the
    most device time.  Returns (all events, device events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    events = prof.key_averages()
    # device-side events only (the kernels and memcpys/memsets themselves;
    # the CPU ops that launched them carry the same time again)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{name} under torch.profiler: {sum(e.count for e in kernels)} device "
          f"launches, {dev_ms:.1f} ms of device time in {wall:.1f} ms of "
          f"(profiled) wall ({100 * dev_ms / wall:.1f}% busy); events averaged "
          f"in {time.perf_counter() - t0:.1f} s")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  "
              f"{e.key[:90]}")
    return events, kernels


def report_in_situ(kernels, where, name, key, calls):
    """Print a kernel's launches and device time in a profiled run (its
    device events whose name holds ``key``); returns ms per wrapper call."""
    mine = [e for e in kernels if key in e.key]
    total = sum(e.self_device_time_total for e in mine) / 1e3
    print(f"  {name} in {where}: {sum(e.count for e in mine)} launches, {total:.3f} ms "
          f"of device time ({total / calls:.4f} ms per call); " + ", ".join(
              f"{e.key[e.key.find(key):][:40]} {e.count} x "
              f"{e.self_device_time_total / 1e3 / e.count:.4f} ms" for e in mine))
    return total / calls


def profile_train_step(model, trainer, batch, gen, nice_calls):
    """One SHIPPED train step split into its parts, then one under
    ``torch.profiler``; ``nice_calls`` K1 + K4 wrapper calls per step."""
    from ipoke_tpu_torch.core.optim import cast_floats
    from ipoke_tpu_torch.flows import flow_loss

    b16 = cast_floats(batch, torch.bfloat16)
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("start")
    motion, cond = model._flow_input(b16, gen)
    mark("frozen nets (conditioning, motion encoder)")
    z, logdet = model.flow.forward(model.flow_params.tree(), motion, cond)
    loss = flow_loss(z, logdet, generator=gen)[0]
    mark("flow forward (no-grad remat pass, priors) + loss")
    loss.backward()
    mark("backward (step recomputes, K4 backward)")
    trainer.tx.step()
    mark("optimizer (AMSGrad on fp32 masters, bf16 copy)")
    print("SHIPPED train step parts, host clock: " + "; ".join(
        f"{name} {1e3 * (t - t_prev):.1f} ms"
        for (_, t_prev), (name, t) in zip(marks, marks[1:])))

    events, kernels = profiled("SHIPPED train step", lambda: trainer.train_step(batch, gen))
    # K1 and K4 calls launch the same three stage kernels, so the profile
    # gives one per-call time for both
    stages = sorted((e for e in kernels if "nice_net_stage" in e.key),
                    key=lambda e: e.key)
    per_call = sum(e.self_device_time_total for e in stages) / 1e3 / nice_calls
    print(f"  K1/K4 in situ ({nice_calls} calls, each the same 3 launches): "
          f"{per_call:.4f} ms per call; " + ", ".join(
              f"{e.key[e.key.find('nice_net_stage'):][:17]} {e.count} x "
              f"{e.self_device_time_total / 1e3 / e.count:.4f} ms" for e in stages))
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=lambda e: -e.count)[:12]
    print("  most launched aten ops: " + ", ".join(
        f"{e.key[6:]} {e.count}" for e in ops))


def phase_shipped_train(dev, smi):
    """(g) SHIPPED train: DDI, perturb, bf16 + fp32 masters, one checked
    step, 3 timed steps, one split and one profiled step."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.core.optim import warmup_linear_decay
    from ipoke_tpu_torch.train import SecondStageTrainer

    cfg = entry.SHIPPED
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = entry.build(cfg, dev, gen)
    batch = entry.make_batch(cfg, dev, seed=0)
    # the shipped schedule (config/second_stage.yaml: lr 1e-3, 500 warmup
    # steps, 100 epochs of 2000 batches)
    trainer = SecondStageTrainer(model, warmup_linear_decay(1e-3, 500, 200000))
    trainer.ddi(batch, gen)
    entry.perturb(model.flow_params, gen)
    trainer.start()
    torch.cuda.synchronize()
    print(f"SHIPPED train set-up (build, fp32 DDI, bf16 cast, fp32 masters) "
          f"{time.perf_counter() - t0:.1f} s")

    ops.reset_launches()  # the train path's run
    losses = [trainer.train_step(batch, gen)["flow_loss"]]
    torch.cuda.synchronize()
    launches = check_launches("SHIPPED train step", expected_train_launches(cfg))
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        losses.append(trainer.train_step(batch, gen)["flow_loss"])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    losses = [l.item() for l in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"SHIPPED train losses {losses}")
    ms = sum(times) / len(times)
    print(f"SHIPPED train bf16 + fp32 AMSGrad masters B={cfg['batch_size']} "
          f"T={cfg['T']} {cfg['spatial']}px: {ms:.1f} ms/step "
          f"({', '.join(f'{t:.1f}' for t in times)}), "
          f"{cfg['batch_size'] / (ms / 1e3):.2f} clips/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}; "
          f"losses {losses}")
    profile_train_step(model, trainer, batch, gen,
                       launches["nice_net"] + launches["nice_net_train"])
    return launches


def phase_nonsquare(dev, smi):
    """(h) the SHIPPED-width cINN at 8x16: fp32 round trip, bf16 inverses
    (this path's run and 3 timed); then SMALL widths card vs CPU."""
    from ipoke_tpu_torch import entry, ops

    cfg = entry.SHIPPED
    gen = torch.Generator(device=dev).manual_seed(4)
    model = entry.build(cfg, dev, gen)
    entry.perturb(model.flow_params, gen)
    flow, b = model.flow, cfg["batch_size"]
    z = torch.randn((b, *NONSQUARE, cfg["z_dim"]), generator=gen, device=dev)
    h = torch.randn((b, *NONSQUARE, flow.h_channels), generator=gen, device=dev)
    with torch.no_grad():
        y, _ = flow.forward(model.flow_params.tree(), z, h)
        ops.reset_launches()
        x = flow.inverse(model.flow_params.tree(), y, h)
        torch.cuda.synchronize()
        check_launches("SHIPPED fp32 flow inverse at 8x16",
                       expected_flow_launches(cfg, False))
        err = max_err(x, z)
        print(f"SHIPPED fp32 round trip z -> forward -> inverse at "
              f"{tuple(z.shape)}: max |x - z| {err:.3e} (tol {ROUNDTRIP_TOL}), "
              f"max |y| {y.abs().max().item():.3e}")
        if not bool(torch.isfinite(x).all()) or err > ROUNDTRIP_TOL:
            raise AssertionError("SHIPPED fp32 round trip at 8x16 out of bound")

        model = model.to(torch.bfloat16)
        inverse = lambda: flow.inverse(model.flow_params.tree(), y.bfloat16(),
                                       h.bfloat16())
        ops.reset_launches()  # the non-square inverse path's run
        x16 = inverse()
        torch.cuda.synchronize()
        launches = check_launches("SHIPPED bf16 flow inverse at 8x16",
                                  expected_flow_launches(cfg, True))
        if x16.shape != z.shape or not bool(torch.isfinite(x16).all()):
            raise AssertionError(f"bf16 inverse {tuple(x16.shape)}: want finite "
                                 f"{tuple(z.shape)}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            inverse()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        print(f"SHIPPED bf16 flow inverse B={b} at {NONSQUARE[0]}x{NONSQUARE[1]}: "
              f"{sum(times) / 3:.1f} ms/pass ({', '.join(f'{t:.1f}' for t in times)}) "
              f"on {smi}; max |x - z| {max_err(x16, z):.3e} (bf16)")
        # one inverse under the profiler: the card's busy share, and K1's
        # and K5's device time per call in situ
        _, kernels = profiled("SHIPPED bf16 flow inverse at 8x16", inverse)
        for name, key, calls in (("K1", "nice_net_stage", launches["nice_net"]),
                                 ("K5", "masked_conv_inverse_kernel",
                                  launches["masked_conv_inverse"])):
            report_in_situ(kernels, "the inverse", name, key, calls)
        del model, x, y, x16

        cfg = entry.SMALL
        gen = torch.Generator().manual_seed(0)
        model = entry.build(cfg, "cpu", gen)
        entry.perturb(model.flow_params, gen, SMALL_PERTURB, SMALL_PERTURB)
        flow = model.flow
        z = torch.randn((cfg["batch_size"], *NONSQUARE, cfg["z_dim"]), generator=gen)
        h = torch.randn((cfg["batch_size"], *NONSQUARE, flow.h_channels),
                        generator=gen)
        ref32 = flow.inverse(model.flow_params.tree(), z, h)
        model = model.to(torch.bfloat16)
        z, h = z.bfloat16(), h.bfloat16()
        ref = flow.inverse(model.flow_params.tree(), z, h)
        model = model.to(dev)
        ops.reset_launches()
        got = flow.inverse(model.flow_params.tree(), z.to(dev), h.to(dev))
        torch.cuda.synchronize()
        check_launches("SMALL bf16 flow inverse at 8x16",
                       expected_flow_launches(cfg, True))
    diff = (got.cpu().float() - ref.float()).abs()
    drift = (ref.float() - ref32).abs()
    print(f"SMALL flow inverse at {tuple(z.shape)}, bf16 card vs CPU: max_abs_err "
          f"{diff.max().item():.3e} mean {diff.mean().item():.3e} (tol max "
          f"{SMALL_FLOW_MAX_TOL}, mean {SMALL_FLOW_MEAN_TOL}); CPU bf16 vs fp32 "
          f"max {drift.max().item():.3e} mean {drift.mean().item():.3e}")
    if not bool(torch.isfinite(got).all()) or diff.max().item() > SMALL_FLOW_MAX_TOL \
            or diff.mean().item() > SMALL_FLOW_MEAN_TOL:
        raise AssertionError("SMALL flow inverse at 8x16: card disagrees with CPU")
    return launches


def phase_k3_train(dev):
    """(i1) K3 at the decoder's training shapes: forward against the plain
    version, two calls bitwise equal, device times, bound and share; the
    backward (K3 + the portable VJP) against autograd of the plain version."""
    from ipoke_tpu_torch.ops import _build, spade_gn

    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    lib, n, tol, rows = _build.load(), K3_TRAIN_FRAMES, K3_TOL[torch.float32], []
    for s, ch in K3_TRAIN_CASES:
        x = randn(n, s, s, ch) * 2.0 + 0.5
        gamma, beta = randn(n, s, s, ch) * 0.5, randn(n, s, s, ch) * 0.5
        got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
        want = spade_gn.spade_gn_plain(x, gamma, beta, 16)
        err = check_close(f"K3 train S={s} Ch={ch}", got, want, tol, tol)
        if not torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, 16)):
            raise AssertionError(f"K3 train S={s} Ch={ch}: two calls differ")
        ms = cuda_ms(lambda: spade_gn.spade_gn_cuda(x, gamma, beta, 16), 50)
        plain = cuda_ms(lambda: spade_gn.spade_gn_plain(x, gamma, beta, 16), 20)
        bound_ms, bound_by = bound(*spade_work(n, n, s, ch, 4), FP32_FLOPS)
        k, resident = spade_gn.spade_gn_plan(s * s, ch, 4)
        clusters = lib.spade_gn_max_clusters(s * s, ch, 16, 0, k, int(resident))
        r = randn(n, s, s, ch)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
            return torch.autograd.grad((fn(*leaves, 16) * r).sum(), leaves)

        g_err = max(check_close(f"K3 train grad {g} S={s} Ch={ch}", a, b, tol, tol)
                    for g, a, b in zip(("x", "gamma", "beta"),
                                       grads(spade_gn.spade_gn_modulate),
                                       grads(spade_gn.spade_gn_plain)))
        g_ms = cuda_ms(lambda: grads(spade_gn.spade_gn_modulate), 10)
        g_plain = cuda_ms(lambda: grads(spade_gn.spade_gn_plain), 10)
        print(f"K3 spade_gn train N={n} t=1 S={s} Ch={ch} G=16 fp32: max_abs_err "
              f"{err:.3e} (tol {tol} abs+rel), two calls bitwise equal, kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {100 * bound_ms / ms:.1f}% of it); clusters of {k}, "
              f"slices {'kept in' if resident else 'streamed past'} shared memory, "
              f"{clusters} clusters resident at once; backward: gradients max_abs_err "
              f"{g_err:.3e}, forward + backward {g_ms:.4f} ms, plain {g_plain:.4f} ms")
        rows.append({"S": s, "Ch": ch, "frames": n, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                     "cluster": k, "resident": resident, "grad_max_abs_err": g_err,
                     "fwd_bwd_ms": g_ms, "plain_fwd_bwd_ms": g_plain})
    return rows


def expected_first_stage_launches(cfg):
    """Per first-stage train step: K3 at each SPADE level of each frame of
    both generator forwards."""
    levels = len(cfg["architecture"]["dec_channels"]) - 1
    return {"nice_net": 0, "nice_net_train": 0, "macow_unit_inverse": 0,
            "masked_conv_inverse": 0,
            "spade_gn": 2 * cfg["data"]["max_frames"] * levels}


def _first_stage_step(cfg, nets):
    from ipoke_tpu_torch.core.optim import gan_adam
    from ipoke_tpu_torch.models import first_stage as fs

    txs = fs.create_first_stage_state(*nets[:3], lambda p: gan_adam(p, FS_TINY_LR))
    return fs.FirstStageStep(cfg, *nets, *txs)


def check_adam_update(name, card_tx, cpu_tx, lr):
    """Hold the card's optimizer after an update against the CPU's by the
    (i2) rule; returns the worst moment error over its limit and the share
    of params more than lr / 10 apart."""
    off = total = 0
    for p, q in zip(card_tx.params, cpu_tx.params):
        d = (p.detach().cpu() - q.detach()).abs()
        if d.max() > 2 * lr:
            raise AssertionError(f"{name}: a param {d.max():.2e} apart")
        off, total = off + int((d > 0.1 * lr).sum()), total + d.numel()
    if off > 0.01 * total:
        raise AssertionError(f"{name}: {off} of {total} params more than lr / 10 apart")
    mus = [cpu_tx.adam.state[q]["exp_avg"] for q in cpu_tx.params]
    floor = 1e-4 * torch.cat([m.flatten() for m in mus]).square().mean().sqrt()
    ratios = []
    for p, m in zip(card_tx.params, mus):
        err = (card_tx.adam.state[p]["exp_avg"].cpu() - m).norm()
        ratios.append(float(err / (3e-4 * m.norm() + floor * m.numel() ** 0.5)))
    if max(ratios) > 1:
        raise AssertionError(f"{name}: first moments apart ({max(ratios):.2f} of the limit)")
    return max(ratios), off / total


@torch.no_grad()
def sync_moments(card_tx, cpu_tx, params=False):
    """Load the CPU optimizer's Adam state (and with ``params`` its params)
    into the card's."""
    for qa, qb in zip(card_tx.params, cpu_tx.params):
        if params:
            qa.copy_(qb)
        for k, v in cpu_tx.adam.state[qb].items():
            card_tx.adam.state[qa][k].copy_(v)


def check_metrics(name, got, ref, tol=FS_TINY_TOL):
    """A card step's metrics against the CPU's: |diff| / (1 + |CPU|) within
    ``tol``, and finite."""
    diffs = {k: abs(got[k].item() - ref[k].item()) / (1.0 + abs(ref[k].item()))
             for k in ref}
    print(f"{name}, card vs CPU fp32 from the same state, |diff| / (1 + |CPU|) "
          f"(tol {tol}): " + ", ".join(f"{k} {v:.1e}" for k, v in diffs.items()))
    if not all(math.isfinite(got[k].item()) for k in got) or max(diffs.values()) > tol:
        raise AssertionError(f"{name}: card disagrees with CPU")
    return diffs


def check_first_stage_update(name, card, cpu, lr):
    """Hold the card's ``FirstStageStep`` after an update against the CPU's
    by the (i2) rule, net by net."""
    return {net_name: check_adam_update(f"{name} {net_name}", ta, tb, lr)
            for net_name, ta, tb in zip(("generator", "d_s", "d_t"),
                                        (card.tx_g, card.tx_ds, card.tx_dt),
                                        (cpu.tx_g, cpu.tx_ds, cpu.tx_dt))}


def sync_first_stage(card, cpu):
    """Load the CPU step's params, spectral-norm state and Adam moments into
    the card's."""
    for a, b in zip((card.model, card.disc_s, card.disc_t),
                    (cpu.model, cpu.disc_s, cpu.disc_t)):
        a.load_state_dict(b.state_dict())
    for ta, tb in zip((card.tx_g, card.tx_ds, card.tx_dt),
                      (cpu.tx_g, cpu.tx_ds, cpu.tx_dt)):
        sync_moments(ta, tb)


def phase_first_stage_tiny(dev, cfg=None, n_steps=3, label="first-stage TINY"):
    """(i2) TINY (or ``cfg``), ``n_steps`` steps card against CPU, each from
    the same state."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.models.first_stage import sample_draws

    cfg = cfg or entry.FIRST_STAGE_TINY
    nets = entry.build_first_stage(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = entry.make_first_stage_batch(cfg, "cpu")
    draw_gen = torch.Generator().manual_seed(1)
    draws = [sample_draws(draw_gen, cfg, cfg["data"]["batch_size"]) for _ in range(n_steps)]
    to = lambda d, dv: {k: v.to(dv) if torch.is_tensor(v) else v for k, v in d.items()}
    card = _first_stage_step(cfg, [copy.deepcopy(n).to(dev) for n in nets])
    cpu = _first_stage_step(cfg, nets)
    want = expected_first_stage_launches(cfg)
    for i, d in enumerate(draws):
        ops.reset_launches()
        got = card(to(batch, dev), to(d, dev), 1.0)
        torch.cuda.synchronize()
        check_launches(f"{label} step {i}", want)
        ref = cpu(batch, d, 1.0)
        check_metrics(f"{label} step {i}", got, ref)
        worst = check_first_stage_update(f"{label} step {i}", card, cpu, FS_TINY_LR)
        print(f"{label} step {i}: params within 2 lr; first moments' worst "
              "leaf error over its limit, share of params past lr / 10 (limit 1%): "
              + ", ".join(f"{k} {r:.3f} {100 * o:.3f}%" for k, (r, o) in worst.items()))
        sync_first_stage(card, cpu)


def phase_first_stage(dev, smi):
    """(i3) config/first_stage.yaml on the card: the path's run with launch
    counts, every net moved, 3 timed steps, a host split and a profile."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.models.first_stage import sample_draws
    from ipoke_tpu_torch.train import FirstStageTrainer

    cfg = entry.FIRST_STAGE
    B = cfg["data"]["batch_size"]
    t0 = time.perf_counter()
    nets = entry.build_first_stage(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    batch = entry.make_first_stage_batch(cfg, dev)
    trainer = FirstStageTrainer(cfg, *nets)
    draw_gen = torch.Generator(device=dev).manual_seed(1)
    before = [[p.detach().clone() for p in net.parameters()] for net in nets[:3]]
    torch.cuda.synchronize()
    print(f"FIRST_STAGE built in {time.perf_counter() - t0:.1f} s: params "
          + ", ".join(f"{name} {sum(p.numel() for p in net.parameters()) / 1e6:.2f}M"
                      for name, net in zip(("generator", "d_s", "d_t", "vgg"), nets)))

    ops.reset_launches()  # the first-stage path's run
    metrics = trainer.train_step(batch, 0, draw_gen)
    torch.cuda.synchronize()
    launches = check_launches("FIRST_STAGE train step", expected_first_stage_launches(cfg))
    metrics = {k: v.item() for k, v in metrics.items()}
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"FIRST_STAGE metrics {metrics}")
    for name, net, p0 in zip(("generator", "d_s", "d_t"), nets[:3], before):
        still = sum(torch.equal(a, b) for a, b in zip(p0, net.parameters()))
        if still:
            raise AssertionError(f"FIRST_STAGE: {still} {name} params did not move")
    print("FIRST_STAGE step 1: every param of generator, d_s and d_t moved; "
          + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items()))
    del before

    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(3):
        start.record()
        trainer.train_step(batch, 0, draw_gen)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = sum(times) / len(times)
    print(f"FIRST_STAGE train fp32 B={B} T={cfg['data']['max_frames']} "
          f"{cfg['data']['spatial_size'][0]}px: {ms:.1f} ms/step "
          f"({', '.join(f'{t:.1f}' for t in times)}), {B / (ms / 1e3):.2f} clips/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")

    # one step split into its phases on the host clock, each closed by a
    # synchronize
    step, X = trainer.step, batch["images"]
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    mark("start")
    draws = sample_draws(draw_gen, cfg, B)
    mark("draws")
    X_hat = step.fake(X, draws)
    mark("generator forward (no grad)")
    step.update_dt(X, X_hat, draws, 1.0)
    mark("d_t update (hinge, R1 double backward, Adam)")
    step.update_ds(X, X_hat, draws, 1.0)
    mark("d_s update")
    step.update_g(X, draws, 1.0)
    mark("generator update (forward, discs, VGG, backward, Adam)")
    print("FIRST_STAGE step parts, host clock: " + "; ".join(
        f"{name} {1e3 * (t - t_prev):.1f} ms"
        for (_, t_prev), (name, t) in zip(marks, marks[1:])))

    _, kernels = profiled("FIRST_STAGE train step",
                          lambda: trainer.train_step(batch, 0, draw_gen))
    per_call = report_in_situ(kernels, "the step", "K3", "spade_gn_kernel",
                              launches["spade_gn"])
    return launches, {"ms_per_step": ms, "in_situ_ms_per_call": per_call}


def expected_third_stage_launches(cfg, path):
    """Per run of a conv third-stage path: the bridge inverse's units
    (hallucinated flow) or the cINN inverse's and the decode's SPADE levels
    (video from flow) are the only kernel launches; the NICE couplings run
    fp32, outside K1's bf16 family, and the train steps run no kernel."""
    want = dict.fromkeys(("nice_net", "nice_net_train", "macow_unit_inverse",
                          "masked_conv_inverse", "spade_gn"), 0)
    ss = cfg["second_stage"]
    if path == "hallucinated_flow":
        want["macow_unit_inverse"] = 4 * sum(cfg["architecture"]["num_steps"])
    elif path == "video_from_flow":
        want["macow_unit_inverse"] = 4 * sum(ss["num_steps"])
        want["spade_gn"] = len(ss["dec_ch"]) - 1
    return want


def phase_third_stage_kernels(dev):
    """(j1) K2 without conditioning rows at the bridge's unit shapes, and
    K3 in fp32 at the flow-to-video decode's levels: each against its plain
    version, two calls bitwise equal, device times, bound and share."""
    from ipoke_tpu_torch.ops import _build, masked_conv

    gen = torch.Generator(device=dev).manual_seed(6)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    lib, b, rows = _build.load(), K2_BRIDGE_B, {"macow_unit_inverse": [], "spade_gn": []}
    for s, c in K2_BRIDGE_CASES:
        hid = 4 * c
        mcf = [{"w_shift": randn(2, 3, c, hid) * (6 * c) ** -0.5,
                "out": {"v": randn(1, 1, hid, 2 * c) * 0.05,
                        "g": randn(2 * c) * K2_BRIDGE_GAIN, "b": randn(2 * c) * 0.1}}
               for _ in range(4)]
        for p in mcf[2:]:  # C/D store the kernel dims swapped
            p["w_shift"] = p["w_shift"].transpose(0, 1).contiguous()
        an = [{"log_scale": randn(c) * 0.05, "bias": randn(c) * 0.05} for _ in range(2)]
        y = randn(b, s, s, c)
        packed = masked_conv.pack_unit(None, mcf, an, b, s, s)
        name = f"K2 unconditioned B={b} {s}x{s} C={c}"
        got = masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)
        want = masked_conv.macow_unit_inverse_plain(y, *packed, 1.0)
        err = check_close(name, got, want, K2_TOL)
        if not torch.equal(got, masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0)):
            raise AssertionError(f"{name}: two calls differ")
        ms = cuda_ms(lambda: masked_conv.macow_unit_inverse_cuda(y, *packed, 1.0), 20)
        plain = cuda_ms(lambda: masked_conv.macow_unit_inverse_plain(y, *packed, 1.0), 2)
        bound_ms, bound_by = bound(*unit_work(b, s, c, hid), FP32_FLOPS)
        print(f"{name} hid={hid} (no conditioning rows; hc is the out bias): "
              f"max_abs_err {err:.3e} (tol {K2_TOL}), two calls bitwise equal, kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {1e3 * bound_ms:.2f} us "
              f"({bound_by}; {100 * bound_ms / ms:.1f}% of it), "
              f"{lib.macow_unit_inverse_max_clusters(s, s, c, hid, 2, 3)} clusters of "
              f"{masked_conv.K2_CLUSTER} resident at once")
        rows["macow_unit_inverse"].append(
            {"B": b, "S": s, "C": c, "hid": hid, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by})
    n, tol = K3_VIDEO_CLIPS * K3_VIDEO_T, K3_TOL[torch.float32]
    for s, ch in K3_VIDEO_CASES:
        x = randn(n, s, s, ch) * 2.0 + 0.5
        gamma = randn(K3_VIDEO_CLIPS, s, s, ch) * 0.5
        beta = randn(K3_VIDEO_CLIPS, s, s, ch) * 0.5
        rows["spade_gn"].append(k3_row(
            f"K3 fp32 video decode N={n} clips={K3_VIDEO_CLIPS} S={s} Ch={ch}",
            x, gamma, beta, tol))
        del x, gamma, beta
    return rows


def phase_third_stage_tiny(dev):
    """(j2) FLOW_MOTION_TINY card vs CPU, fp32: hallucinated flow, video
    from flow, 2 bridge steps and 2 flow-VAE steps, each step from the
    CPU's state."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.train import FlowMotionTrainer, FlowVAETrainer

    cfg = entry.FLOW_MOTION_TINY
    ss = cfg["second_stage"]
    gen = torch.Generator().manual_seed(0)
    cpu = entry.build_flow_motion(cfg, "cpu", gen)
    entry.perturb(cpu.second_stage.flow_params, gen, TS_PERTURB, TS_PERTURB)
    entry.perturb(cpu.inn_params, gen, TS_PERTURB, TS_PERTURB)
    card = copy.deepcopy(cpu).to(dev)
    batch = entry.make_batch(ss, "cpu")
    on = lambda d, dv: {k: v.to(dv) for k, v in d.items()}
    b, m = ss["batch_size"], ss["min_spatial"]
    shape = lambda c: (b, m, m, c)
    randn = lambda c: torch.randn(shape(c), generator=gen)
    z, eps, extra = randn(cpu.z_total), randn(cpu.z_flow), randn(cpu.z_total - cpu.z_flow)
    runs = {"hallucinated_flow": lambda mod, bt, dv: mod.forward_sample_flow(bt, z=z.to(dv)),
            "video_from_flow": lambda mod, bt, dv: mod.forward_video_from_flow(
                bt, ss["T"], noise=(eps.to(dv), extra.to(dv)))}
    for path, run in runs.items():
        ops.reset_launches()
        got = run(card, on(batch, dev), dev)
        torch.cuda.synchronize()
        check_launches(f"FLOW_MOTION_TINY {path}", expected_third_stage_launches(cfg, path))
        err = check_close(f"FLOW_MOTION_TINY {path}, card vs CPU", got.cpu(),
                          run(cpu, batch, "cpu"), TS_TINY_TOL, TS_TINY_TOL)
        print(f"FLOW_MOTION_TINY {path} {tuple(got.shape)}, fp32 card vs CPU: max_abs_err "
              f"{err:.3e} (tol {TS_TINY_TOL} abs+rel)")

    def steps(name, card_step, cpu_step, card_tx, cpu_tx, sync, draw):
        for i in range(2):
            noise = draw()
            ops.reset_launches()
            got = card_step(tuple(t.to(dev) for t in noise) if isinstance(noise, tuple)
                            else noise.to(dev))
            torch.cuda.synchronize()
            check_launches(f"{name} step {i}", expected_third_stage_launches(cfg, "step"))
            ref = cpu_step(noise)
            diffs = {k: abs(got[k].item() - ref[k].item()) / (1.0 + abs(ref[k].item()))
                     for k in ref}
            if not all(math.isfinite(got[k].item()) for k in got) \
                    or max(diffs.values()) > FS_TINY_TOL:
                raise AssertionError(f"{name} step {i}: card disagrees with CPU: {diffs}")
            worst, off = check_adam_update(f"{name} step {i}", card_tx, cpu_tx, TS_LR)
            print(f"{name} step {i}, card vs CPU fp32 from the same state: metrics "
                  f"|diff| / (1 + |CPU|) (tol {FS_TINY_TOL}) " + ", ".join(
                      f"{k} {v:.1e}" for k, v in diffs.items())
                  + f"; params within 2 lr, {100 * off:.3f}% past lr / 10; first "
                  f"moments' worst leaf {worst:.3f} of its limit")
            sync()

    trainers = [FlowMotionTrainer(mod, TS_LR) for mod in (card, cpu)]
    txs = [t.state.tx for t in trainers]
    bridge_noise = lambda: (randn(cpu.z_flow), randn(cpu.z_total - cpu.z_flow),
                            randn(cpu.z_total))
    steps("FLOW_MOTION_TINY bridge",
          lambda nz: trainers[0].train_step(on(batch, dev), 0, noise=nz),
          lambda nz: trainers[1].train_step(batch, 0, noise=nz), *txs,
          lambda: sync_moments(*txs, params=True), bridge_noise)

    vae_cfg = {"training": {"lr": TS_LR, "kl_weight": entry.FLOW_VAE["training"]["kl_weight"]}}
    vaes = [entry.build_flow_vae(ss["spatial"], cfg["architecture"], m, "cpu", gen)]
    vaes.insert(0, copy.deepcopy(vaes[0]).to(dev))
    vtrainers = [FlowVAETrainer(vae_cfg, vae) for vae in vaes]

    def sync_vae():
        want = vaes[1].state_dict()
        for name, got in vaes[0].state_dict().items():
            if name.rsplit(".", 1)[-1] in ("u", "sigma"):
                check_close(f"FLOW_MOTION_TINY flow VAE {name}", got.cpu(), want[name],
                            TS_TINY_TOL)
        vaes[0].load_state_dict(want)
        sync_moments(vtrainers[0].tx, vtrainers[1].tx)

    steps("FLOW_MOTION_TINY flow VAE",
          lambda nz: vtrainers[0].train_step({"flow": batch["flow"].to(dev)}, noise=nz),
          lambda nz: vtrainers[1].train_step({"flow": batch["flow"]}, noise=nz),
          vtrainers[0].tx, vtrainers[1].tx, sync_vae, lambda: randn(cpu.z_flow))


def phase_flow_motion(dev, smi):
    """(j3) FLOW_MOTION at full width, fp32: per path one run with the
    launch counts zeroed before and read after, one warm run, 3 timed runs
    (CUDA events) with the peak memory; then one video-from-flow pass under
    ``torch.profiler``."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.flows import count_params
    from ipoke_tpu_torch.train import FlowMotionTrainer, FlowVAETrainer

    cfg, vae_cfg = entry.FLOW_MOTION, entry.FLOW_VAE
    ss = cfg["second_stage"]
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = entry.build_flow_motion(cfg, dev, gen)
    entry.perturb(model.second_stage.flow_params, gen)
    entry.perturb(model.inn_params, gen)
    batch = entry.make_batch(ss, dev)
    va = vae_cfg["architecture"]
    vae = entry.build_flow_vae(vae_cfg["data"]["spatial_size"][0], va,
                               va["min_spatial_size"], dev, gen)
    vae_batch = entry.make_flow_vae_batch(vae_cfg, dev)
    trainer = FlowMotionTrainer(model, TS_LR)
    vae_trainer = FlowVAETrainer(vae_cfg, vae)
    torch.cuda.synchronize()
    print(f"FLOW_MOTION built in {time.perf_counter() - t0:.1f} s: bridge "
          f"{count_params(model.inn_params.tree()) / 1e6:.2f}M params, cINN "
          f"{count_params(model.second_stage.flow_params.tree()) / 1e6:.2f}M, flow VAE "
          f"{sum(p.numel() for p in model.flow_vae.parameters()) / 1e6:.2f}M")
    b, s, t = ss["batch_size"], ss["spatial"], ss["T"]
    vb = vae_cfg["data"]["batch_size"]
    paths = {
        "hallucinated_flow": (lambda: model.forward_sample_flow(batch, gen), (b, s, s, 2), b),
        "video_from_flow": (lambda: model.forward_video_from_flow(batch, t, gen),
                            (b, t, s, s, 3), b),
        "bridge_step": (lambda: trainer.train_step(batch, 0, gen)["flow_loss"], (), b),
        "flow_vae_step": (lambda: vae_trainer.train_step(vae_batch, gen)["loss"], (), vb),
    }
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    launches, times = {}, {}
    for name, (fn, shape, clips) in paths.items():
        ops.reset_launches()  # this path's run
        out = fn()
        torch.cuda.synchronize()
        launches[name] = check_launches(f"FLOW_MOTION {name}",
                                        expected_third_stage_launches(cfg, name))
        if tuple(out.shape) != shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"FLOW_MOTION {name}: {tuple(out.shape)}, want finite {shape}")
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ts = []
        for _ in range(3):
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ts.append(start.elapsed_time(end))
        ms = sum(ts) / len(ts)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        times[name] = {"ms": ms, "clips_per_s": clips / (ms / 1e3), "peak_gib": peak}
        print(f"FLOW_MOTION {name} fp32 B={clips}: {ms:.1f} ms ({', '.join(f'{x:.1f}' for x in ts)}), "
              f"{clips / (ms / 1e3):.2f} clips/s, peak memory {peak:.2f} GiB on {smi}")
    # the frozen target's share of the trainer's bridge step: the step and,
    # alone, the target it computes, each closed by a synchronize
    def host_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    step_ms = host_ms(lambda: trainer.train_step(batch, 0, gen))
    with torch.no_grad():
        target_ms = host_ms(lambda: model.second_stage.forward_density(batch, gen))
    times["bridge_step"]["target_share"] = target_ms / step_ms
    print(f"FLOW_MOTION bridge step, host clock: the step {step_ms:.1f} ms, its target "
          f"(the frozen second stage's forward_density, run alone) {target_ms:.1f} ms, "
          f"{100 * target_ms / step_ms:.0f}%")
    # one video pass under the profiler: the card's busy share, and K2's and
    # K3's device time per call in situ
    _, kernels = profiled("FLOW_MOTION video from flow", paths["video_from_flow"][0])
    v = launches["video_from_flow"]
    times["video_from_flow"]["k2_in_situ_ms"] = report_in_situ(
        kernels, "the video pass", "K2", "macow_unit_inverse_kernel", v["macow_unit_inverse"])
    times["video_from_flow"]["k3_in_situ_ms"] = report_in_situ(
        kernels, "the video pass", "K3", "spade_gn_kernel", v["spade_gn"])
    return launches, times


# (k) the port's CLI: the synthetic tree (64 px, PlantDataset: 20 videos of
# 30 frames, 400 train and 100 val clips: 3 batches of the flow VAE's 64
# and 1 val batch), the shipped YAMLs with only the dataset, the epochs,
# CLI_BATCHES train and 1 val batch, the frozen run dirs and one depth cut
# changed: second_stage's num_steps, so that one state copy (bf16 params,
# fp32 masters, 3 AMSGrad moments: 18 bytes a param) stays under ~4 GB
# (209.3M params, 3.77 GB; at the yaml's depth 1054.4M params, ~19 GB a
# copy, and the store writes `last` and the monitored copy every epoch).
# Widths stay: flow_mid_channels_factor 64, factor 16, kernel (2, 3), B = 40.
CLI_VIDEOS, CLI_FRAMES, CLI_BATCHES = 20, 30, 3
CLI_SECOND_STAGE_STEPS = [4, 2, 1, 1, 1]
CLI_KERNELS = ("nice_net", "nice_net_train", "macow_unit_inverse",
               "masked_conv_inverse", "spade_gn")


def _decode_levels(cfg) -> int:
    """The SPADE levels of a second stage's frozen first stage."""
    from ipoke_tpu_torch.core.config import load_config

    return len(load_config(cfg["first_stage"]["config"])["architecture"]
               ["dec_channels"]) - 1


def expected_cli_launches(name, cfg, n_train, n_val):
    """Per CLI run of ``name`` with ``n_train`` steps and ``n_val`` val
    batches: the first stage's K3, conv or FC (60 a train step at T = 10,
    one per decode level a val batch); the second stage's bf16 steps (K1 in
    each step's no-grad pass, K4 in its recompute and the priors; its fp32
    DDI runs no kernel), its validation's no-grad density (K1 in every
    coupling) and sampling pass (K1, K2 in every unit, K3 per decode level);
    the FC second stage's validation pass, K3 per decode level (its flat
    flows and steps run no kernel); flow_motion's validation, the bridge's
    units in the hallucinated flow (K2).  The image AEs, the FC encoders,
    the BigAE, the flat INN, the flow VAE and the bridge's steps run no
    kernel."""
    want = dict.fromkeys(CLI_KERNELS, 0)
    arch = cfg["architecture"]
    if name in ("first_stage", "first_stage_fc"):
        levels = len(arch["dec_channels"]) - 1
        want["spade_gn"] = n_train * 2 * cfg["data"]["max_frames"] * levels + n_val * levels
    elif name == "second_stage_fc":
        want["spade_gn"] = n_val * _decode_levels(cfg)
    elif name == "second_stage":
        steps, levels = sum(arch["num_steps"]), len(arch["num_steps"])
        dec = _decode_levels(cfg)
        want["nice_net"] = n_train * 4 * steps + n_val * 2 * (4 * steps + levels)
        want["nice_net_train"] = n_train * (4 * steps + levels)
        want["macow_unit_inverse"] = n_val * 4 * steps
        want["spade_gn"] = n_val * dec
    elif name == "flow_motion":
        want["macow_unit_inverse"] = n_val * 4 * sum(arch["num_steps"])
    return want


@contextlib.contextmanager
def cli_tree():
    """A temporary directory with the synthetic PlantDataset tree of phase
    (k) (``data``) and the run dirs' base (``logs``, as ``DATAPATH_BASE``);
    removed, and ``DATAPATH_BASE`` restored, on exit."""
    import os
    import shutil
    import tempfile

    from ipoke_tpu_torch.data.prep import make_synthetic_dataset

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    old_base = os.environ.get("DATAPATH_BASE")
    try:
        t0 = time.perf_counter()
        data_root = os.path.join(root, "data")
        meta = make_synthetic_dataset(data_root, n_videos=CLI_VIDEOS,
                                      n_frames=CLI_FRAMES, spatial_size=64)
        base = os.path.join(root, "logs")
        os.environ["DATAPATH_BASE"] = base
        print(f"CLI synthetic tree: {len(meta['img_path'])} clips "
              f"({int(meta['train'].sum())} train) in {time.perf_counter() - t0:.1f} s")
        yield {"root": root, "data_root": data_root, "base": base}
    finally:
        if old_base is None:
            os.environ.pop("DATAPATH_BASE", None)
        else:
            os.environ["DATAPATH_BASE"] = old_base
        shutil.rmtree(root, ignore_errors=True)


def host_probe(dev, n=2000):
    """us per launch of a one-element add queued back to back: the host's
    dispatch speed just before a run (the small nets' steps are bound by
    it)."""
    x = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t) / n


def release():
    """Collect what a finished run left in reference cycles (an experiment
    and its trainer refer to each other), so that the next run's peak
    memory is its own."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def run_cli(argv):
    """``main.run(argv)`` with both TF32 switches turned on before it: the
    run must leave them off (the precision every record assumes)."""
    from ipoke_tpu_torch import main as cli

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    out = cli.run(argv)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError(f"main.run({argv}) left TF32 on")
    return out


def drive_cli(dev, smi, data_root, exp, path, *extra):
    """One CLI run of ``exp`` from the config at ``path``, with the launch
    counts zeroed before and read after (the path's run, held against
    ``expected_cli_launches``); returns the experiment and its record."""
    from ipoke_tpu_torch import ops

    probe_us = host_probe(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30  # before the run
    stats0 = torch.cuda.memory_stats()
    ops.reset_launches()  # this CLI run
    t_run = time.perf_counter()
    e = run_cli(["--config", path, "--model_name", "smoke", "--data_root", data_root,
                 *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    got = dict(ops.LAUNCHES)
    tm = e.timings
    n_train, n_val = len(tm["step_s"]), len(tm["val_s"])
    want = expected_cli_launches(exp, e.config, n_train, n_val * e.max_val_batches)
    label = f"CLI {exp}{' --resume' if extra else ''}"
    print(f"{label} kernel launches: {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got} != {want}")
    with open(e.metrics_logger.path) as f:
        val = [json.loads(line) for line in f if '"val/' in line][-1]
    val = {k[4:]: v for k, v in val.items() if k.startswith("val/")}
    if not val or not all(map(math.isfinite, val.values())):
        raise AssertionError(f"{label}: validation metrics {val}")
    steps_ms = [1e3 * t for t in tm["step_s"]]
    ms = sum(steps_ms[1:]) / max(1, len(steps_ms) - 1)
    wait = [1e3 * t for t in tm["loader_wait_s"]]
    drain = [1e3 * t for t in tm["drain_s"]]
    # cudaMalloc calls in each step (the first from the run's start)
    counts = [stats0.get("num_device_alloc", 0)] + tm["device_allocs"]
    allocs = [b - a for a, b in zip(counts, counts[1:])]
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) \
        - stats0.get("num_alloc_retries", 0)
    per_step = {k: v / n_train for k, v in got.items() if v}
    out = {"ms_per_step": ms, "steps_ms": steps_ms,
           "loader_wait_ms": wait, "drain_ms": drain,
           "host_probe_us": probe_us, "device_allocs": allocs,
           "alloc_retries": retries,
           "val_s": tm["val_s"], "val": val,
           "save_s": tm["save_s"], "save_bytes": tm["save_bytes"],
           "restore_s": tm["restore_s"], "wall_s": wall,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "held_before_gib": held,
           "launches": got, "launches_per_step": per_step}
    print(f"{label} B={e.batch_size}: {n_train} steps, "
          f"{ms:.1f} ms/step after the first ({', '.join(f'{t:.1f}' for t in steps_ms)}); "
          f"loader wait {', '.join(f'{t:.1f}' for t in wait)} ms; "
          f"wait in the closing sync {', '.join(f'{t:.1f}' for t in drain)} ms; "
          f"cudaMallocs {allocs}, {retries} retries; "
          f"host probe {probe_us:.2f} us a launch; "
          f"validation {', '.join(f'{t:.2f}' for t in tm['val_s'])} s "
          f"{json.dumps(val)}; checkpoint {tm['save_bytes']} bytes in "
          f"{', '.join(f'{t:.2f}' for t in tm['save_s'])} s; restore "
          f"{tm['restore_s']} s; peak {out['peak_gib']:.2f} GiB "
          f"({held:.2f} held before the run); "
          f"launches per step {per_step}; run {wall:.1f} s on {smi}")
    return e, out


def phase_cli(dev, smi, tree):
    """(k) ``ipoke_tpu_torch.main`` through the conv pipeline on a synthetic
    tree: k1 img_encoder, k2 poke_encoder, k3 first_stage, k4 second_stage
    (1 epoch, a restore check, then --resume for 1 more), k5 flow_vae and
    flow_motion, each run with the launch counts zeroed before and read
    after (the CLI path's run).  Per run: ms per step (after the first),
    the loader's wait per step, validation seconds and metrics (finite),
    checkpoint bytes and save seconds, restore seconds, peak memory and the
    kernels' launches per step; beside each step's time, the host's wait in
    its closing synchronize and its cudaMalloc calls, and a host probe
    before each run, which tell a host-bound step from an allocator-bound
    one."""
    import os

    import yaml

    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.core.config import load_config

    release()  # what earlier phases left in reference cycles
    root, data_root, base = tree["root"], tree["data_root"], tree["base"]
    t0 = time.perf_counter()

    def run_dir(exp):
        return {"config": os.path.join(base, exp, "config", "smoke", "0.yaml"),
                "ckpt": os.path.join(base, exp, "ckpt", "smoke", "0")}

    def config(exp):
        cfg = load_config(os.path.join("config", f"{exp}.yaml")).to_dict()
        cfg["data"]["dataset"] = "PlantDataset"
        cfg["training"].update(n_epochs=1, max_batches_per_epoch=CLI_BATCHES,
                               max_val_batches=1)
        for sec in ("first_stage", "conditioner", "poke_embedder"):
            if sec in cfg:
                cfg[sec].update(run_dir({"conditioner": "img_encoder",
                                         "poke_embedder": "poke_encoder"}.get(sec, sec)))
        if exp == "second_stage":
            cfg["architecture"]["num_steps"] = CLI_SECOND_STAGE_STEPS
        if exp == "flow_motion":
            cfg["second_stage"].update(run_dir("second_stage"))
            cfg["flow_vae"]["ckpt"] = run_dir("flow_vae")["ckpt"]
        path = os.path.join(root, f"{exp}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    drive = lambda exp, path, *extra: drive_cli(dev, smi, data_root, exp, path, *extra)

    results, launches = {}, {}
    for exp in ("img_encoder", "poke_encoder", "first_stage"):
        e, results[exp] = drive(exp, config(exp))
        launches[f"cli_{exp}"] = results[exp]["launches"]
        del e
        release()
    ss_path = config("second_stage")
    e1, results["second_stage"] = drive("second_stage", ss_path)
    launches["cli_second_stage"] = results["second_stage"]["launches"]
    if e1.ddi_runs != 1:
        raise AssertionError(f"CLI second_stage: DDI ran {e1.ddi_runs} times")
    # restore check: the state a --resume loads equals the run's own
    args = cli.parse_args(["--config", ss_path, "--model_name", "smoke",
                           "--data_root", data_root, "--resume"])
    cfg_r, dirs, _ = cli.load_parameters(args)
    from ipoke_tpu_torch.cli.experiments import SecondStageExperiment
    e2 = SecondStageExperiment(cfg_r, dirs, data_root=data_root, device="cuda")
    e2.build()
    e2.restore_last()
    checks = {"step": e2.step == e1.step,
              "lr count": e2.tx.count == e1.tx.count,
              "masters fp32, bitwise": all(
                  a.dtype == torch.float32 and torch.equal(a, b)
                  for a, b in zip(e2.tx.master, e1.tx.master)),
              "params bf16, bitwise": all(
                  a.dtype == torch.bfloat16 and torch.equal(a, b)
                  for a, b in zip(e2.model.flow_params.parameters(),
                                  e1.model.flow_params.parameters()))}
    e2.metrics_logger.close()
    print(f"CLI second_stage restore check (step {e2.step}, lr count "
          f"{e2.tx.count}): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"CLI second_stage restore: {checks}")
    step1, count1 = e1.step, e1.tx.count
    del e1, e2
    release()
    e3, results["second_stage_resume"] = drive("second_stage", ss_path, "--resume")
    launches["cli_second_stage_resume"] = results["second_stage_resume"]["launches"]
    n3 = len(e3.timings["step_s"])
    if (e3.step, e3.tx.count, e3.ddi_runs) != (step1 + n3, count1 + n3, 0):
        raise AssertionError(
            f"CLI second_stage --resume: step {e3.step}, lr count {e3.tx.count}, "
            f"DDI runs {e3.ddi_runs}; want {step1 + n3}, {count1 + n3}, 0")
    print(f"CLI second_stage --resume: step {step1} -> {e3.step}, lr count "
          f"{count1} -> {e3.tx.count}, DDI not rerun")
    del e3
    release()
    for exp in ("flow_vae", "flow_motion"):
        e, results[exp] = drive(exp, config(exp))
        launches[f"cli_{exp}"] = results[exp]["launches"]
        del e
        release()
    print(f"CLI phase (k) in {time.perf_counter() - t0:.1f} s")
    tree["second_stage"] = ss_path
    return launches, results


# (l) the --test modes.  (l1) the evaluation nets, card against the CPU
# port, fp32 with TF32 off, at the modes' shapes: LPIPS (3 and 2 channels)
# and PoseResNet-50 on the B*T = 400 frames of a 64 px test batch, I3D on
# 8 clips (10, 64, 64, 3); the diversity scores on (N, S) = (8, 5) clips
# (the mode's N = 40 on the card alone: VGG19 and VGG16 over 2000 frames
# take the CPU ~30 s).  cuDNN and oneDNN sum their convolutions in other
# orders, ~1e-6 relative a layer; a wrong layout or pad moves the output
# by O(1).  LPIPS and the LPIPS and MSE diversity within 1e-4 relative;
# I3D's logits and features, PoseResNet's heatmaps within 1e-3 abs + rel;
# the VGG diversity, 1 - cos of the fixed-seed VGG19's last taps (~1e-4:
# its features all but align), within 1e-6 absolute (fp32 rounds the
# cosine at ~1e-7).
EVAL_FRAMES, EVAL_I3D, EVAL_DIVERSITY = 400, (8, 10, 64, 64, 3), (8, 5, 10, 64, 64, 3)
EVAL_TOL = {"lpips": 1e-4, "i3d": 1e-3, "pose": 1e-3, "div_rel": 1e-4, "div_vgg_abs": 1e-6}
# (l2) each mode through ``ipoke_tpu_torch.main --test <mode> --debug`` on
# phase (k)'s second-stage run, with the JAX package's --debug batch counts
# and the YAML's batch (data.test_batch_size set to its batch_size, 40:
# --debug cuts batch_size to 2, and the test loader reads
# data.test_batch_size); (sampling passes, density passes) per mode at
# testing.n_samples_per_data_point = S
TEST_MODES = ("samples", "fvd", "accuracy", "diversity", "control_sensitivity",
              "transfer", "kps_acc")


def test_mode_passes(mode, cfg):
    """Without ``testing.n_samples_per_data_point`` (second_stage_fc.yaml)
    each mode takes its default: 3 in samples, 5 in accuracy and
    diversity, as in the JAX package."""
    s = cfg.get("testing", {}).get("n_samples_per_data_point")
    s3, s5 = (3, 5) if s is None else (int(s), int(s))
    return {"samples": (s3, 0), "fvd": (2, 0), "accuracy": (2 * s5, 0),
            "diversity": (s5, 0), "control_sensitivity": (1 + 4, 0),
            "transfer": (2, 1), "kps_acc": (2, 0)}[mode]


def expected_test_launches(mode, cfg):
    """The modes sample in fp32, on the mixed second stage too (its bf16
    weights upcast, the batch uncast: the JAX package's modes): a sampling
    pass runs K2 in every unit of the cINN inverse (4 a step) and K3 once
    a decode level, and no K1 (its family is bf16), in the density pass
    (transfer) neither; no K4 (no grad) and no K5 (every latent 8x8).  The
    FC second stage's pass runs K3 alone (its flat flows run no kernel).
    On the FC third stage, realism and accuracy decode no video: no
    kernel."""
    want = dict.fromkeys(CLI_KERNELS, 0)
    if cfg["general"]["experiment"] == "third_stage_fc":
        return want
    passes, _ = test_mode_passes(mode, cfg)
    if cfg["general"]["experiment"] == "second_stage":
        want["macow_unit_inverse"] = passes * 4 * sum(cfg["architecture"]["num_steps"])
    want["spade_gn"] = passes * _decode_levels(cfg)
    return want


def phase_eval_nets(dev, smi):
    """(l1) LPIPS, I3D, PoseResNet-50 and the diversity scores, card against
    the CPU port on the same inputs, with the card's ms per call."""
    import numpy as np

    from ipoke_tpu_torch import entry
    from ipoke_tpu_torch.eval import metrics
    from ipoke_tpu_torch.eval.i3d import init_i3d
    from ipoke_tpu_torch.eval.pose import build_pose_resnet
    from ipoke_tpu_torch.nn.lpips import init_lpips

    rng = np.random.default_rng(0)

    def clips(*shape):
        return np.clip(0.5 * rng.standard_normal(shape), -1, 1).astype(np.float32)

    nets = {"lpips": init_lpips(0), "i3d": init_i3d(0), "pose": build_pose_resnet(),
            "vgg": entry.build_vgg("cpu")}
    card = {k: copy.deepcopy(v).to(dev) for k, v in nets.items()}
    frames = clips(EVAL_FRAMES, 64, 64, 3)
    cases = {
        "lpips3": ("lpips", (frames, np.clip(frames + 0.3 * clips(*frames.shape), -1, 1))),
        "lpips2": ("lpips", (frames[..., :2], np.clip(frames[..., 1:] + 0.3, -1, 1))),
        "i3d": ("i3d", (clips(*EVAL_I3D),)),
        "pose": ("pose", (frames,)),
    }
    out = {}
    for name, (net, args) in cases.items():
        dargs = [torch.as_tensor(a).to(dev) for a in args]
        kw = {"return_features": True} if net == "i3d" else {}
        with torch.no_grad():
            want = nets[net](*map(torch.as_tensor, args), **kw)
            got = card[net](*dargs, **kw)
            if net == "i3d":  # logits and features
                want, got = torch.cat(want, -1), torch.cat(got, -1)
            tol = EVAL_TOL[net]
            err = (got.cpu() - want).abs()
            bad = err > tol * want.abs() + (0.0 if net == "lpips" else tol)
            ms = cuda_ms(lambda: card[net](*dargs, **kw), 3)
        print(f"(l1) {name} {tuple(args[0].shape)}: card vs CPU max abs err "
              f"{err.max().item():.3e} (tolerance {tol:g}{' rel' if net == 'lpips' else ' abs + rel'}), "
              f"{ms:.3f} ms a call on {smi}")
        if bad.any() or not torch.isfinite(got).all():
            raise AssertionError(f"(l1) {name}: card vs CPU beyond {tol:g}")
        out[name] = {"max_abs_err": err.max().item(), "ms": ms}
    samples = clips(*EVAL_DIVERSITY)
    samples_full = clips(40, *EVAL_DIVERSITY[1:])
    for name, fn, net in (("div_mse", metrics.diversity_score_mse, None),
                          ("div_lpips", metrics.diversity_score_lpips, "lpips"),
                          ("div_vgg", metrics.diversity_score_vgg, "vgg")):
        args = (lambda n: (samples,)) if net is None else (lambda n: (n, samples))
        want, got = fn(*args(nets.get(net))), fn(*args(card.get(net)))
        err = abs(got - want)
        tol = EVAL_TOL["div_vgg_abs"] if name == "div_vgg" else EVAL_TOL["div_rel"] * abs(want)
        full = (samples_full,) if net is None else (card[net], samples_full)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn(*full)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"(l1) {name} {EVAL_DIVERSITY}: card {got:.6g}, CPU {want:.6g}, err {err:.3e} "
              f"(tolerance {tol:.3g}); at N = 40 on the card {value:.6g} in {secs:.3f} s "
              f"on {smi}")
        if not err <= tol or not math.isfinite(value):
            raise AssertionError(f"(l1) {name}: card {got} vs CPU {want}")
        out[name] = {"abs_err": err, "full_s": secs}
    return out


def check_test_artifacts(mode, d, result):
    """The files and metric keys of each mode (``tests/test_pipeline_e2e.py``
    for the JAX package), metrics finite."""
    import os

    import numpy as np

    files = set(os.listdir(d))
    if not all(map(math.isfinite, result.values())):
        raise AssertionError(f"--test {mode}: metrics {result}")
    with_json = {"fvd": "fvd.json", "accuracy": "metrics.json",
                 "diversity": "metrics.json", "control_sensitivity": "metrics.json",
                 "kps_acc": "metrics.json"}
    if mode in with_json:
        with open(os.path.join(d, with_json[mode])) as f:
            if json.load(f) != result:
                raise AssertionError(f"--test {mode}: {with_json[mode]} != {result}")
    want = {
        "samples": lambda: {"samples_batch0.npy", "real_batch0.npy", "grid_batch0.mp4",
                            "enrollment_b0_s0.png"} <= files
        and np.isfinite(np.load(os.path.join(d, "samples_batch0.npy"))).all(),
        "fvd": lambda: {"real_samples.npy", "fake_samples.npy"} <= files
        and set(result) == {"FVD", "n_samples"},
        "accuracy": lambda: {"per_frame_metrics.csv", "per_frame_metrics.png"} <= files
        and set(result) == {"ssim_best_of_n", "psnr_best_of_n", "lpips_best_of_n"},
        "diversity": lambda: set(result) == {"divscore_mse", "divscore_vgg", "divscore_lpips"},
        "control_sensitivity": lambda: any(
            f.startswith("sid_") and {"overview.mp4", "groundtruth_poke_enrollment.png"}
            <= set(os.listdir(os.path.join(d, f))) for f in files)
        and "direction_correlation" in result,
        "transfer": lambda: "transfer_grid-0.mp4" in files
        and any(f.startswith("transfer_row-ids_m") for f in files)
        and any(f.startswith("transfer_grid-ids_m") and f.endswith(".png") for f in files),
        "kps_acc": lambda: result.get("annotated_keypoints") == 0.0 and "kps_mse" in result,
    }[mode]
    if not want():
        raise AssertionError(f"--test {mode}: artifacts {sorted(files)}, metrics {result}")


def phase_test_modes(dev, smi, tree, fc=False):
    """(l2) ``ipoke_tpu_torch.main --test <mode> --debug`` on phase (k)'s
    second-stage run (with ``fc``, (m4): phase (m3)'s ``second_stage_fc``
    run), each mode with the launch counts zeroed before and read after
    (this path's run, ``test_<mode>`` / ``test_fc_<mode>``): artifacts,
    finite metrics, launches against ``expected_test_launches``, seconds per
    mode, its build, its restore and each sampling pass (each closed by a
    synchronize), peak memory; then ``realism`` raises the JAX package's
    assertion."""
    import os

    import yaml

    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.core.config import load_config

    if fc:
        from ipoke_tpu_torch.cli.fc_experiments import (
            SecondStageFCExperiment as SecondStageExperiment)
        from ipoke_tpu_torch.models.fc_baseline import (
            SecondStageModelFC as SecondStageModel)
    else:
        from ipoke_tpu_torch.cli.experiments import SecondStageExperiment
        from ipoke_tpu_torch.models.second_stage import SecondStageModel
    exp_name = "second_stage_fc" if fc else "second_stage"
    prefix, tag = ("test_fc_", "(m4)") if fc else ("test_", "(l2)")
    cfg = load_config(tree[exp_name]).to_dict()
    cfg["data"]["test_batch_size"] = cfg["data"]["batch_size"]
    path = os.path.join(tree["root"], f"{exp_name}_test.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    passes, density, builds = [], [], []
    sample, dens = SecondStageModel.forward_sample, SecondStageModel.forward_density
    build, restore = SecondStageExperiment.build, SecondStageExperiment.restore

    def timed(fn, into):
        def wrapper(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t)
            return out
        return wrapper

    gen = os.path.join(tree["base"], exp_name, "generated", "smoke")
    launches, results = {}, {}
    t_phase = time.perf_counter()
    SecondStageModel.forward_sample = timed(sample, passes)
    SecondStageModel.forward_density = timed(dens, density)
    SecondStageExperiment.build = timed(build, builds)
    SecondStageExperiment.restore = timed(restore, builds)
    try:
        for mode in TEST_MODES:
            release()
            torch.cuda.reset_peak_memory_stats()
            passes.clear()
            density.clear()
            builds.clear()
            ops.reset_launches()  # this mode's run
            t0 = time.perf_counter()
            result = run_cli(["--config", path, "--model_name", "smoke", "--data_root",
                              tree["data_root"], "--test", mode, "--debug"])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            got = dict(ops.LAUNCHES)
            want = expected_test_launches(mode, cfg)
            n_pass, n_dens = test_mode_passes(mode, cfg)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rest = secs - sum(builds) - sum(passes) - sum(density)
            print(f"{tag} --test {mode}: {json.dumps(result)}; {len(passes)} sampling passes "
                  f"({', '.join(f'{1e3 * t:.1f}' for t in passes)} ms), {len(density)} density "
                  f"passes; {secs:.2f} s the mode: build {builds[0]:.2f} s, restore "
                  f"{builds[1]:.2f} s, the passes {sum(passes) + sum(density):.2f} s, the rest "
                  f"(batches, metrics, writing) {rest:.2f} s; launches {got} (expected {want}); "
                  f"peak {peak:.2f} GiB on {smi}")
            if got != want or (len(passes), len(density)) != (n_pass, n_dens):
                raise AssertionError(f"--test {mode}: launches {got} != {want} or passes "
                                     f"{len(passes)}/{len(density)} != {n_pass}/{n_dens}")
            check_test_artifacts(mode, os.path.join(gen, mode), result)
            launches[f"{prefix}{mode}"] = got
            results[mode] = {"s": secs, "build_s": builds[0], "restore_s": builds[1],
                             "pass_ms": [1e3 * t for t in passes], "rest_s": rest,
                             "peak_gib": peak, "metrics": result}
    finally:
        SecondStageModel.forward_sample, SecondStageModel.forward_density = sample, dens
        SecondStageExperiment.build, SecondStageExperiment.restore = build, restore
    try:
        run_cli(["--config", path, "--model_name", "smoke", "--data_root",
                 tree["data_root"], "--test", "realism", "--debug"])
    except AssertionError as e:
        if "hallucinated-flow pipeline" not in str(e):
            raise
        print(f"{tag} --test realism on the {exp_name} run raises: {e}")
    else:
        raise AssertionError(f"--test realism ran on a {exp_name} run")
    print(f"{tag} the seven modes in {time.perf_counter() - t_phase:.1f} s")
    return launches, results


# (m) the FC tower.  (m1) K3 in fp32 at the FC generator's SPADE levels (S,
# Ch) of config/first_stage_fc.yaml's dec_channels at 32 px: training, B =
# 20 frames rendered one at a time (a modulation per frame, t = 1), and
# sampling, 400 frames of 40 clips (the batched decode, t = 10); K3's
# backward at the 32 px level in training
K3_FC_CASES = ((8, 256), (16, 128), (32, 64))
K3_FC_BATCHES = (("training", 20, 20), ("sampling", 400, 40))
# (m2) FC_TINY card against the CPU port, fp32, TF32 off, the same weights
# and draws: the (i2) rule for every step (FS_TINY_TOL on metrics, the
# update rule on params and first moments, each step from the CPU's state);
# the flat flow's forward (z, logdet) and inverse and the sampling pass's
# frames within FC_TINY_TOL abs + rel (both fp32, summing in other orders)
FC_TINY_TOL = 1e-3
# (m3) the FC experiments from the shipped YAMLs, in pipeline order: (run,
# YAML, experiment, 32 px cut).  The FC baseline's four dec_channels render
# 32 px, not the 64 px its YAML asks for (the JAX package's step fails
# there too), so the FC-baseline runs (its encoders, first and second
# stage) run at 32 px; the BigAE runs and the flat INN at the YAMLs' 64 px
FC_RUNS = (("flow_encoder_fc", "flow_encoder_fc", "flow_encoder_fc", False),
           ("img_encoder_fc_bigae", "img_encoder_fc", "flow_encoder_fc", False),
           ("inn_fcae", "inn_fcae", "inn_fcae", False),
           ("img_encoder_fc", "img_encoder", "img_encoder_fc", True),
           ("poke_encoder_fc", "poke_encoder", "poke_encoder_FC", True),
           ("first_stage_fc", "first_stage_fc", "first_stage_fc", True),
           ("second_stage_fc", "second_stage_fc", "second_stage_fc", True))
FC_SIZE = 32


def phase_fc_kernels(dev):
    """(m1) K3 at the FC generator's training and sampling shapes, and its
    backward at the 32 px level in training."""
    from ipoke_tpu_torch.ops import spade_gn

    gen = torch.Generator(device=dev).manual_seed(7)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    tol, rows = K3_TOL[torch.float32], []
    for label, n, clips in K3_FC_BATCHES:
        for s, ch in K3_FC_CASES:
            x = randn(n, s, s, ch) * 2.0 + 0.5
            gamma, beta = randn(clips, s, s, ch) * 0.5, randn(clips, s, s, ch) * 0.5
            rows.append(dict(k3_row(f"(m1) K3 fp32 FC {label} N={n} clips={clips} S={s} "
                                    f"Ch={ch}", x, gamma, beta, tol), batch=label))
    s, ch = K3_FC_CASES[-1]
    n = K3_FC_BATCHES[0][1]
    x, gamma, beta, r = (randn(n, s, s, ch) for _ in range(4))

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        return torch.autograd.grad((fn(*leaves, 16) * r).sum(), leaves)

    g_err = max(check_close(f"(m1) K3 FC grad {g} S={s} Ch={ch}", a, b, tol, tol)
                for g, a, b in zip(("x", "gamma", "beta"), grads(spade_gn.spade_gn_modulate),
                                   grads(spade_gn.spade_gn_plain)))
    g_ms = cuda_ms(lambda: grads(spade_gn.spade_gn_modulate), 10)
    g_plain = cuda_ms(lambda: grads(spade_gn.spade_gn_plain), 10)
    print(f"(m1) K3 FC training backward N={n} t=1 S={s} Ch={ch}: gradients through K3 "
          f"and the portable VJP against autograd of the plain version, max_abs_err "
          f"{g_err:.3e}; forward + backward {g_ms:.4f} ms, plain {g_plain:.4f} ms")
    rows[K3_FC_CASES.index((s, ch))].update(grad_max_abs_err=g_err, fwd_bwd_ms=g_ms,
                                           plain_fwd_bwd_ms=g_plain)
    return rows


def phase_fc_tiny(dev):
    """(m2) FC_TINY card against the CPU port: 2 FCAE steps, 2 first_stage_fc
    steps, the flat flow's forward and inverse, a second_stage_fc sampling
    pass and 2 of its train steps, each step from the CPU's state."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.core.optim import gan_adam
    from ipoke_tpu_torch.models.fc_stack import FCAEStep
    from ipoke_tpu_torch.train import SecondStageTrainer

    cfg = entry.FC_TINY
    to = lambda d, dv: {k: v.to(dv) for k, v in d.items()}
    zero = dict.fromkeys(CLI_KERNELS, 0)
    # the BigAE VAE-GAN step
    fe = cfg["flow_encoder"]
    nets = entry.build_fcae(fe, "cpu", torch.Generator().manual_seed(0))
    steps = []
    for device, ns in ((dev, [copy.deepcopy(n).to(dev) for n in nets]), ("cpu", nets)):
        txs = [gan_adam(list(n.parameters()), fe["training"]["lr"]) for n in ns[:2]]
        steps.append(FCAEStep(fe, *ns, *txs))
    card, cpu = steps
    s = fe["data"]["spatial_size"][0]
    gen = torch.Generator().manual_seed(1)
    for i in range(2):
        batch = {"flow": torch.tanh(torch.randn((2, s, s, 2), generator=gen))}
        noise = torch.randn((2, fe["architecture"]["z_dim"]), generator=gen)
        ops.reset_launches()
        got = card(to(batch, dev), 1.0, noise.to(dev))
        torch.cuda.synchronize()
        check_launches(f"(m2) FCAE step {i}", zero)
        check_metrics(f"(m2) FCAE step {i}", got, cpu(batch, 1.0, noise))
        worst = [check_adam_update(f"(m2) FCAE step {i} {name}", a, b, fe["training"]["lr"])
                 for name, a, b in (("BigAE", card.tx, cpu.tx), ("disc", card.tx_d, cpu.tx_d))]
        print(f"(m2) FCAE step {i}: params within 2 lr; first moments' worst leaf error "
              f"over its limit, share past lr / 10: {worst}")
        for a, b, ta, tb in ((card.model, cpu.model, card.tx, cpu.tx),
                             (card.disc, cpu.disc, card.tx_d, cpu.tx_d)):
            a.load_state_dict(b.state_dict())
            sync_moments(ta, tb)
        card.prev_d_loss = cpu.prev_d_loss.clone()
    # the FC first stage's step
    phase_first_stage_tiny(dev, cfg["first_stage"], 2, "(m2) first_stage_fc TINY")
    # the FC second stage: flat flow, sampling pass, train steps
    model = entry.build_second_stage_fc(cfg, "cpu", torch.Generator().manual_seed(2))
    card_model = copy.deepcopy(model).to(dev)
    batch = entry.make_first_stage_batch(cfg["first_stage"], "cpu", seed=3)
    batch["poke"] = torch.randn((2, s, s, 2), generator=gen) * 0.5
    noise = torch.randn((2, model.flow_in_channels), generator=gen)
    z, ld = model.forward_density(batch, noise=noise)
    ops.reset_launches()
    z_c, ld_c = card_model.forward_density(to(batch, dev), noise=noise.to(dev))
    x_c = card_model.flow.inverse(card_model.flow_params.tree(), z_c,
                                  card_model.embed_conditioning(to(batch, dev)))
    torch.cuda.synchronize()
    check_launches("(m2) flat flow forward and inverse", zero)
    x = model.flow.inverse(model.flow_params.tree(), z, model.embed_conditioning(batch))
    errs = [check_close(f"(m2) flat flow {w}", a.cpu(), b, FC_TINY_TOL, FC_TINY_TOL)
            for w, a, b in (("z", z_c, z), ("logdet", ld_c, ld), ("inverse", x_c, x))]
    print(f"(m2) flat flow card vs CPU: z, logdet, inverse max_abs_err "
          + ", ".join(f"{e:.3e}" for e in errs) + f" (tol {FC_TINY_TOL} abs+rel)")
    T = cfg["first_stage"]["data"]["max_frames"]
    ops.reset_launches()
    video_c = card_model.forward_sample(to(batch, dev), T, z=z.to(dev))
    torch.cuda.synchronize()
    levels = len(cfg["first_stage"]["architecture"]["dec_channels"]) - 1
    check_launches("(m2) second_stage_fc sampling pass", dict(zero, spade_gn=levels))
    err = check_close("(m2) second_stage_fc sampling pass", video_c.cpu(),
                      model.forward_sample(batch, T, z=z), FC_TINY_TOL, FC_TINY_TOL)
    print(f"(m2) second_stage_fc sampling pass card vs CPU: frames max_abs_err "
          f"{err:.3e} (tol {FC_TINY_TOL} abs+rel)")
    lr = cfg["second_stage"]["training"]["lr"]
    trainers = [SecondStageTrainer(m, lr) for m in (card_model, model)]
    for t in trainers:
        t.start()
    for i in range(2):
        ops.reset_launches()
        got = trainers[0].train_step(to(batch, dev))  # motion = mu: no draw
        torch.cuda.synchronize()
        check_launches(f"(m2) second_stage_fc step {i}", zero)
        check_metrics(f"(m2) second_stage_fc step {i}", got, trainers[1].train_step(batch))
        worst = check_adam_update(f"(m2) second_stage_fc step {i}", trainers[0].tx,
                                  trainers[1].tx, lr)
        print(f"(m2) second_stage_fc step {i}: params within 2 lr; first moments' worst "
              f"leaf error over its limit, share past lr / 10: {worst}")
        sync_moments(trainers[0].tx, trainers[1].tx, params=True)


def fc_cli_config(tree, run, yaml_name, exp, cut, arch=None):
    """(m3) the shipped YAML of ``run`` with the synthetic tree's dataset,
    1 epoch of CLI_BATCHES train and 1 val batch, the frozen runs' dirs,
    the experiment it runs, the FC baseline's 32 px cut, and ``arch``'s
    architecture keys."""
    import os

    import yaml

    from ipoke_tpu_torch.core.config import load_config

    base = tree["base"]
    run_dir = lambda exp_dir: {
        "config": os.path.join(base, exp_dir, "config", "smoke", "0.yaml"),
        "ckpt": os.path.join(base, exp_dir, "ckpt", "smoke", "0")}
    cfg = load_config(os.path.join("config", f"{yaml_name}.yaml")).to_dict()
    cfg["general"]["experiment"] = exp
    cfg["data"]["dataset"] = "PlantDataset"
    if cut:
        cfg["data"]["spatial_size"] = [FC_SIZE, FC_SIZE]
    cfg["training"].update(n_epochs=1, max_batches_per_epoch=CLI_BATCHES, max_val_batches=1)
    cfg["architecture"].update(arch or {})
    if exp in ("img_encoder_fc", "poke_encoder_FC"):  # as second_stage_fc.yaml's nf_max
        cfg["architecture"]["nf_max"] = 64
    if exp == "inn_fcae":
        cfg["flow_encoder"] = run_dir("flow_encoder_fc")
    if exp in ("second_stage_fc", "third_stage_fc"):
        for sec, frozen in (("first_stage", "first_stage_fc"),
                            ("conditioner", "img_encoder_fc"),
                            ("poke_embedder", "poke_encoder_FC")):
            cfg[sec].update(run_dir(frozen))
    if exp == "third_stage_fc":
        # the encoders of the second stage it loads (second_stage_fc.yaml's
        # nf_max 64; third_stage_fc.yaml names 128)
        for sec in ("conditioner", "poke_embedder"):
            cfg[sec]["nf_max"] = 64
        cfg["second_stage"].update(run_dir("second_stage_fc"))
        cfg["flow_encoder"].update(run_dir("flow_encoder_fc"))
    path = os.path.join(tree["root"], f"{run}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def phase_fc_cli(dev, smi, tree):
    """(m3) ``ipoke_tpu_torch.main`` through the FC tower from the shipped
    YAMLs (``FC_RUNS``), each run with the launch counts zeroed before and
    read after (path ``fc_<run>``), recorded as phase (k) records its runs;
    then the restore check and ``--resume`` of ``second_stage_fc``."""
    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.cli.fc_experiments import SecondStageFCExperiment

    release()
    t0 = time.perf_counter()
    data_root = tree["data_root"]
    results, launches = {}, {}
    for run, yaml_name, exp, cut in FC_RUNS:
        # (img_encoder_fc.yaml's BigAE runs as flow_encoder_fc: its version 1)
        path = fc_cli_config(tree, run, yaml_name, exp, cut)
        e, results[run] = drive_cli(dev, smi, data_root, exp, path)
        launches[f"fc_{run}"] = results[run]["launches"]
        if run == "second_stage_fc":
            tree["second_stage_fc"] = path
            ss = e
            continue
        del e
        release()
    if ss.ddi_runs != 1:
        raise AssertionError(f"CLI second_stage_fc: DDI ran {ss.ddi_runs} times")
    args = cli.parse_args(["--config", tree["second_stage_fc"], "--model_name", "smoke",
                           "--data_root", data_root, "--resume"])
    cfg_r, dirs, _ = cli.load_parameters(args)
    check = SecondStageFCExperiment(cfg_r, dirs, data_root=data_root, device="cuda")
    check.build()
    check.restore_last()
    check.metrics_logger.close()
    checks = {"step": check.step == ss.step, "lr count": check.tx.count == ss.tx.count,
              "flow params bitwise": all(torch.equal(a, b) for a, b in zip(
                  check.model.flow_params.parameters(), ss.model.flow_params.parameters())),
              "moments bitwise": all(  # Adam keeps its step count on the CPU
                  torch.equal(a, ss.tx.adam.state[r][k].to(a.device))
                  for q, r in zip(check.tx.params, ss.tx.params)
                  for k, a in check.tx.adam.state[q].items())}
    print(f"(m3) CLI second_stage_fc restore check (step {check.step}): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"CLI second_stage_fc restore: {checks}")
    step1, count1 = ss.step, ss.tx.count
    del ss, check
    release()
    e, results["second_stage_fc_resume"] = drive_cli(
        dev, smi, data_root, "second_stage_fc", tree["second_stage_fc"], "--resume")
    launches["fc_second_stage_fc_resume"] = results["second_stage_fc_resume"]["launches"]
    n = len(e.timings["step_s"])
    if (e.step, e.tx.count, e.ddi_runs) != (step1 + n, count1 + n, 0):
        raise AssertionError(f"CLI second_stage_fc --resume: step {e.step}, lr count "
                             f"{e.tx.count}, DDI runs {e.ddi_runs}")
    print(f"(m3) CLI second_stage_fc --resume: step {step1} -> {e.step}, DDI not rerun")
    del e
    release()
    print(f"(m3) the FC CLI runs in {time.perf_counter() - t0:.1f} s")
    return launches, results


# (n) the FC third stage (config/third_stage_fc.yaml, fp32).  (n1) K3 in fp32
# at its sample_video decode's levels (K3_FC_CASES): 320 frames of 32 clips
# (the YAML's batch, T = 10); (n2) FC_THIRD_TINY card against the CPU port:
# 2 steps by the (i2) rule, the residual-seeded extract, a base-sampled flow
# and sample_video's frames within FC_TINY_TOL abs + rel, unconditioned and
# conditioned; (n3) main.run of the YAML at its width (mid 2048, 20 blocks,
# B = 32) on a 32 px flow_encoder_fc run and (m3)'s FC runs, recorded as (k)
# records its runs, then its restore check and --resume; (n4) --test
# realism and accuracy on it, and sample_video at the YAML's batch; then
# the YAML with general.conditional for one epoch.  One cut: (n3)'s INN
# runs FC_THIRD_FLOWS of the YAML's 20 blocks.  The card's machine lets a
# call write 45 GiB to its disk, freed blocks included; at 20 blocks a
# state (0.69G fp32 params and three AMSGrad buffers) is 11.1 GB, 13.9 GB an
# epoch with its weights, and the script's earlier phases write ~20 GB.  At
# 6 blocks (207.8M params) the three epochs write ~12.5 GB.  Width stays
# (flow_in_channels 128, mid 2048, hidden depth 2, B = 32);
# tools/torch_fc_third_stage.py runs the YAML's 20 blocks alone.  Each
# run's dir goes once read.
FC_THIRD_CLIPS, FC_THIRD_T, FC_THIRD_FLOWS = 32, 10, 6


def phase_fc_third_kernels(dev):
    """(n1) K3 at the FC third stage's sample_video decode levels."""
    gen = torch.Generator(device=dev).manual_seed(11)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    n, rows = FC_THIRD_CLIPS * FC_THIRD_T, []
    for s, ch in K3_FC_CASES:
        x = randn(n, s, s, ch) * 2.0 + 0.5
        gamma, beta = (randn(FC_THIRD_CLIPS, s, s, ch) * 0.5 for _ in range(2))
        rows.append(k3_row(f"(n1) K3 fp32 FC third stage sample_video N={n} "
                           f"clips={FC_THIRD_CLIPS} S={s} Ch={ch}", x, gamma, beta,
                           K3_TOL[torch.float32]))
    return rows


def phase_fc_third_tiny(dev):
    """(n2) FC_THIRD_TINY card against the CPU port, unconditioned and
    conditioned: 2 steps by the (i2) rule, each from the CPU's state; the
    modes' residual-seeded extract, a base-sampled flow and sample_video's
    frames from the same draws."""
    from types import SimpleNamespace

    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.cli.testing import _third_stage_fns
    from ipoke_tpu_torch.train import ThirdStageFCTrainer

    cfg = entry.FC_THIRD_TINY
    fs = cfg["first_stage"]
    s, T = fs["data"]["spatial_size"][0], fs["data"]["max_frames"]
    levels = len(fs["architecture"]["dec_channels"]) - 1
    zero = dict.fromkeys(CLI_KERNELS, 0)
    lr = cfg["third_stage"]["training"]["lr"]
    gen = torch.Generator().manual_seed(21)
    randn = lambda *shape: torch.randn(shape, generator=gen)
    batch = entry.make_first_stage_batch(fs, "cpu", seed=22)
    B = batch["images"].shape[0]
    batch.update(poke=0.5 * randn(B, s, s, 2), flow=randn(B, s, s, 2))
    to = lambda d: {k: v.to(dev) for k, v in d.items()}
    for conditional in (False, True):
        tag = f"(n2) third_stage_fc TINY {'conditioned' if conditional else 'unconditioned'}"
        cpu = entry.build_third_stage_fc(cfg, "cpu", torch.Generator().manual_seed(23),
                                         conditional)
        card = copy.deepcopy(cpu).to(dev)
        z_ss, zt, zf = cpu.second_stage.flow_in_channels, cpu.z_total, cpu.z_flow
        trainers = [ThirdStageFCTrainer(m, lr) for m in (card, cpu)]
        for i in range(2):
            noise = (randn(B, z_ss), randn(B, zf), randn(B, zt - zf), randn(B, zt))
            ops.reset_launches()
            got = trainers[0].train_step(to(batch), 0, noise=[n.to(dev) for n in noise])
            torch.cuda.synchronize()
            check_launches(f"{tag} step {i}", zero)
            check_metrics(f"{tag} step {i}", got, trainers[1].train_step(batch, 0, noise=noise))
            worst = check_adam_update(f"{tag} step {i}", trainers[0].state.tx,
                                      trainers[1].state.tx, lr)
            print(f"{tag} step {i}: params within 2 lr; first moments' worst leaf error over "
                  f"its limit, share past lr / 10: {worst}")
            sync_moments(trainers[0].state.tx, trainers[1].state.tx, params=True)
        motion, z, eps, extra = randn(B, z_ss), randn(B, zt), randn(B, zf), randn(B, zt - zf)
        outs = []
        for model, device in ((card, dev), (cpu, "cpu")):
            extract, sample, _ = _third_stage_fns(SimpleNamespace(model=model, generator=None))
            b = to(batch) if device == dev else batch
            ops.reset_launches()
            out = (extract(b, motion=motion.to(device)), sample(b, z=z.to(device)),
                   model.forward_video_from_flow(b, T, noise=(eps.to(device), extra.to(device))))
            if device == dev:
                torch.cuda.synchronize()
                check_launches(f"{tag} extract, sample, sample_video",
                               dict(zero, spade_gn=levels))
            outs.append(out)
        errs = [check_close(f"{tag} {w}", a.cpu(), b, FC_TINY_TOL, FC_TINY_TOL)
                for w, a, b in zip(("extract", "sample", "sample_video"), *outs)]
        print(f"{tag} card vs CPU: extract, base-sampled flow, sample_video frames "
              f"max_abs_err " + ", ".join(f"{e:.3e}" for e in errs)
              + f" (tol {FC_TINY_TOL} abs+rel)")


def free_runs(tree, runs):
    """Remove the dirs (their checkpoints) of the experiments ``runs``,
    which no later phase reads."""
    import os
    import shutil

    for run in runs:
        shutil.rmtree(os.path.join(tree["base"], run), ignore_errors=True)


def phase_fc_third_cli(dev, smi, tree, n_flows=FC_THIRD_FLOWS):
    """(n3) ``ipoke_tpu_torch.main`` of config/third_stage_fc.yaml at its
    width (``n_flows`` blocks) on a 32 px flow_encoder_fc run and (m3)'s FC
    runs, each run with the launch counts zeroed before and read after
    (path ``fc_third_<run>``), recorded as phase (k) records its runs; then
    the restore check (the state a resume loads is the run's own, bit for
    bit) and --resume."""
    import os
    import shutil

    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.cli.fc_experiments import ThirdStageFCExperiment
    from ipoke_tpu_torch.flows import count_params

    release()
    free_runs(tree, ("flow_encoder_fc", "inn_fcae"))  # (m3)'s 64 px BigAE runs
    usage = shutil.disk_usage(tree["root"])
    print(f"(n3) disk: {usage.free / 2 ** 30:.1f} GiB free of {usage.total / 2 ** 30:.1f}")
    t0 = time.perf_counter()
    data_root = tree["data_root"]
    results, launches = {}, {}
    path = fc_cli_config(tree, "flow_encoder_fc_32", "flow_encoder_fc", "flow_encoder_fc", True)
    e, results["flow_encoder_fc_32"] = drive_cli(dev, smi, data_root, "flow_encoder_fc", path)
    launches["fc_third_flow_encoder_fc_32"] = results["flow_encoder_fc_32"]["launches"]
    del e
    release()
    path = fc_cli_config(tree, "third_stage_fc", "third_stage_fc", "third_stage_fc", True,
                         {"n_flows": n_flows})
    tree["third_stage_fc"] = path
    ts, results["third_stage_fc"] = drive_cli(dev, smi, data_root, "third_stage_fc", path)
    launches["fc_third_third_stage_fc"] = results["third_stage_fc"]["launches"]
    n_params = count_params(ts.model.inn_params.tree())
    arch = ts.config["architecture"]
    print(f"(n3) third_stage_fc INN: {n_params / 1e6:.2f}M fp32 params (flow_in_channels "
          f"{arch['flow_in_channels']}, mid {arch['flow_mid_channels_factor']} x "
          f"{arch['flow_in_channels']}, {arch['n_flows']} blocks), B = {ts.batch_size}")
    results["third_stage_fc"]["inn_params"] = n_params
    args = cli.parse_args(["--config", path, "--model_name", "smoke", "--data_root",
                           data_root, "--resume"])
    cfg_r, dirs, _ = cli.load_parameters(args)
    check = ThirdStageFCExperiment(cfg_r, dirs, data_root=data_root, device="cuda")
    check.build()
    check.restore_last()
    check.metrics_logger.close()
    checks = {"step": check.step == ts.step, "lr count": check.tx.count == ts.tx.count,
              "updates": check.trainer.state.step == ts.trainer.state.step,
              "INN params bitwise": all(torch.equal(a, b) for a, b in zip(
                  check.model.inn_params.parameters(), ts.model.inn_params.parameters())),
              "moments bitwise": all(
                  torch.equal(a, ts.tx.adam.state[r][k].to(a.device))
                  for q, r in zip(check.tx.params, ts.tx.params)
                  for k, a in check.tx.adam.state[q].items())}
    print(f"(n3) CLI third_stage_fc restore check (step {check.step}, restore "
          f"{check.timings['restore_s']:.2f} s): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"CLI third_stage_fc restore: {checks}")
    step1, count1 = ts.step, ts.tx.count
    del ts, check
    release()
    e, results["third_stage_fc_resume"] = drive_cli(dev, smi, data_root, "third_stage_fc",
                                                    path, "--resume")
    launches["fc_third_third_stage_fc_resume"] = results["third_stage_fc_resume"]["launches"]
    n = len(e.timings["step_s"])
    if (e.step, e.tx.count) != (step1 + n, count1 + n):
        raise AssertionError(f"CLI third_stage_fc --resume: step {e.step}, lr count "
                             f"{e.tx.count}")
    print(f"(n3) CLI third_stage_fc --resume: step {step1} -> {e.step}, lr count "
          f"{count1} -> {e.tx.count}")
    del e
    release()
    print(f"(n3) the FC third stage's CLI runs in {time.perf_counter() - t0:.1f} s")
    return launches, results


def phase_fc_third_test(dev, smi, tree, conditional=True):
    """(n4) ``--test realism`` and ``--test accuracy`` with ``--debug`` on
    (n3)'s run (the YAML's batch as data.test_batch_size), each with the
    launch counts zeroed before and read after (path
    ``test_fc_third_<mode>``; no kernel runs: no video is decoded), its
    artifacts, finite metrics, seconds and peak memory; then sample_video
    at the YAML's batch and T = 10: one call with the counts zeroed before
    and read after (path ``third_stage_fc_sample_video``: K3 once a decode
    level), 3 timed calls and one under ``torch.profiler``; then the YAML
    with ``general.conditional`` trained one epoch (path
    ``fc_third_third_stage_fc_conditional``)."""
    import os

    import yaml

    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.cli.fc_experiments import ThirdStageFCExperiment
    from ipoke_tpu_torch.core.config import load_config

    zero = dict.fromkeys(CLI_KERNELS, 0)
    cfg = load_config(tree["third_stage_fc"]).to_dict()
    cfg["data"]["test_batch_size"] = cfg["data"]["batch_size"]
    path = os.path.join(tree["root"], "third_stage_fc_test.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    gen = os.path.join(tree["base"], "third_stage_fc", "generated", "smoke")
    n_pokes = cfg["data"]["n_pokes"]
    want_files = {"realism": {"metrics.json"},
                  "accuracy": {"metrics.json", f"error_result_{n_pokes}_pokes.yaml",
                               f"samples_diversity_{n_pokes}_pokes.npy",
                               f"pokes_diversity_{n_pokes}_pokes.npy",
                               f"starting_frame_{n_pokes}_pokes.npy"}}
    launches, results = {}, {}
    for mode in ("realism", "accuracy"):
        release()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()  # this mode's run
        t0 = time.perf_counter()
        result = run_cli(["--config", path, "--model_name", "smoke", "--data_root",
                          tree["data_root"], "--test", mode, "--debug"])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got, want = dict(ops.LAUNCHES), expected_test_launches(mode, cfg)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        d = os.path.join(gen, mode)
        files = set(os.listdir(d))
        with open(os.path.join(d, "metrics.json")) as f:
            written = json.load(f)
        print(f"(n4) --test {mode}: {json.dumps(result)}; {secs:.2f} s; files "
              f"{sorted(files)}; launches {got} (expected {want}); peak {peak:.2f} GiB "
              f"on {smi}")
        if got != want or files != want_files[mode] or written != result \
                or not all(map(math.isfinite, result.values())):
            raise AssertionError(f"--test {mode} on third_stage_fc: {result}, {files}, {got}")
        launches[f"test_fc_third_{mode}"] = got
        results[mode] = {"s": secs, "peak_gib": peak, "metrics": result}

    release()
    args = cli.parse_args(["--config", tree["third_stage_fc"], "--model_name", "smoke",
                           "--data_root", tree["data_root"], "--resume"])
    cfg_r, dirs, _ = cli.load_parameters(args)
    e = ThirdStageFCExperiment(cfg_r, dirs, data_root=tree["data_root"], device="cuda")
    e.build()
    e.restore_last()
    e.metrics_logger.close()
    batch = next(iter(e.val_batches(0)))
    B, levels = batch["images"].shape[0], _decode_levels(cfg)
    ops.reset_launches()  # the sample_video path's run
    video = e.sample_video(batch, FC_THIRD_T)
    torch.cuda.synchronize()
    want = dict(zero, spade_gn=levels)
    got = check_launches(f"(n4) third_stage_fc sample_video B={B} T={FC_THIRD_T}", want)
    launches["third_stage_fc_sample_video"] = got
    if video.shape != (B, FC_THIRD_T, FC_SIZE, FC_SIZE, 3) or not torch.isfinite(video).all():
        raise AssertionError(f"(n4) sample_video: {tuple(video.shape)}")
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        e.sample_video(batch, FC_THIRD_T)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    print(f"(n4) third_stage_fc sample_video B={B} T={FC_THIRD_T}: "
          f"{', '.join(f'{t:.2f}' for t in times)} ms (host clock, each closed by a "
          f"synchronize) on {smi}")
    events, kernels = profiled("(n4) third_stage_fc sample_video",
                               lambda: e.sample_video(batch, FC_THIRD_T))
    k3_ms = report_in_situ(kernels, "sample_video", "K3", "spade_gn_kernel", levels)
    results["sample_video"] = {"ms": times, "k3_in_situ_ms": k3_ms, "B": B}
    del e, video
    release()
    free_runs(tree, ("third_stage_fc",))
    if not conditional:
        return launches, results
    cond = load_config(tree["third_stage_fc"]).to_dict()
    cond["general"]["conditional"] = True
    path = os.path.join(tree["root"], "third_stage_fc_conditional.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cond, f)
    e, results["conditional"] = drive_cli(dev, smi, tree["data_root"], "third_stage_fc", path)
    launches["fc_third_third_stage_fc_conditional"] = results["conditional"]["launches"]
    print(f"(n4) third_stage_fc conditioned on the poke embedding "
          f"({e.model.poke_cond_dim} entries): trained one epoch")
    del e
    release()
    free_runs(tree, ("third_stage_fc",))
    return launches, results


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

    # (c) kernels vs plain versions, (c') K4
    kernels = phase_kernels(dev)
    kernels.update(phase_k4(dev))
    kernels["nice_net_train"]["bf16_matmul_chain_ms"] = \
        kernels["nice_net"]["bf16_matmul_chain_ms"]
    # (c) K5, (c'') K2 against the per-flow route
    kernels.update(phase_k5(dev))
    # (d) SMALL sampling end to end
    phase_small(dev)
    # (e) SHIPPED sampling
    paths = {"sample": phase_shipped(dev, smi)}
    # (f) SMALL train, card vs CPU
    phase_small_train(dev)
    # (g) SHIPPED train
    paths["train"] = phase_shipped_train(dev, smi)
    # (h) the non-square inverse: K5 in every masked-conv flow
    paths["inverse_8x16"] = phase_nonsquare(dev, smi)
    # (i) the first-stage VAE-GAN train step
    kernels["spade_gn"]["train_shapes"] = phase_k3_train(dev)
    phase_first_stage_tiny(dev)
    paths["first_stage_train"], fs_times = phase_first_stage(dev, smi)
    kernels["spade_gn"]["first_stage_in_situ_ms"] = fs_times["in_situ_ms_per_call"]
    # (j) the conv third stage
    for name, cases in phase_third_stage_kernels(dev).items():
        kernels[name]["third_stage_shapes"] = cases
    phase_third_stage_tiny(dev)
    ts_launches, ts_times = phase_flow_motion(dev, smi)
    paths.update(ts_launches)
    kernels["macow_unit_inverse"]["video_from_flow_in_situ_ms"] = \
        ts_times["video_from_flow"]["k2_in_situ_ms"]
    kernels["spade_gn"]["video_from_flow_in_situ_ms"] = \
        ts_times["video_from_flow"]["k3_in_situ_ms"]
    with cli_tree() as tree:
        # (k) the port's CLI through the conv pipeline
        cli_launches, _ = phase_cli(dev, smi, tree)
        paths.update(cli_launches)
        # (l) the --test modes on (k)'s second-stage run
        phase_eval_nets(dev, smi)
        test_launches, _ = phase_test_modes(dev, smi, tree)
        paths.update(test_launches)
        # (m) the FC tower: (m1) K3 at its shapes, (m2) FC_TINY card vs CPU,
        # (m3) its CLI runs, (m4) the --test modes on its second stage
        kernels["spade_gn"]["fc_shapes"] = phase_fc_kernels(dev)
        phase_fc_tiny(dev)
        free_runs(tree, ("img_encoder", "poke_encoder", "first_stage", "second_stage",
                         "flow_vae", "flow_motion"))  # (k)'s runs
        fc_launches, _ = phase_fc_cli(dev, smi, tree)
        paths.update(fc_launches)
        fc_test_launches, _ = phase_test_modes(dev, smi, tree, fc=True)
        paths.update(fc_test_launches)
        # (n) the FC third stage: (n1) K3 at its sample_video shapes, (n2)
        # FC_THIRD_TINY card vs CPU, (n3) its CLI runs at the YAML's width,
        # (n4) realism, accuracy, sample_video and the conditioned run
        kernels["spade_gn"]["fc_third_stage_shapes"] = phase_fc_third_kernels(dev)
        phase_fc_third_tiny(dev)
        third_launches, _ = phase_fc_third_cli(dev, smi, tree)
        paths.update(third_launches)
        third_test_launches, third_times = phase_fc_third_test(dev, smi, tree)
        paths.update(third_test_launches)
        kernels["spade_gn"]["third_stage_fc_sample_video_in_situ_ms"] = \
            third_times["sample_video"]["k3_in_situ_ms"]

    meta = {
        "nice_net": ("cuda", "ipoke_tpu_torch/csrc/nice_net.cu",
                     "ipoke_tpu/ops/nice_net.py:127"),
        "nice_net_train": ("cuda", "ipoke_tpu_torch/csrc/nice_net.cu",
                           "ipoke_tpu/ops/nice_net.py:278"),
        "macow_unit_inverse": ("cuda", "ipoke_tpu_torch/csrc/macow_unit_inverse.cu",
                               "ipoke_tpu/ops/masked_conv.py:215"),
        "masked_conv_inverse": ("cuda", "ipoke_tpu_torch/csrc/masked_conv_inverse.cu",
                                "ipoke_tpu/ops/masked_conv.py:80"),
        "spade_gn": ("cuda", "ipoke_tpu_torch/csrc/spade_gn.cu",
                     "ipoke_tpu/ops/spade_gn.py:232"),
    }
    rows = []
    for name, (route, source, replaces) in meta.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        rows.append({"name": name, "route": route, "source": source,
                     "replaces": replaces, "launches": sum(by_path.values()),
                     "launches_by_path": by_path, **kernels[name]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
