#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sampling pass, second-stage train step and
options, reproduction recipes, first-stage VAE-GAN train step (fp32 and bf16)
and PokeVAE baseline, conv
third stage, CLI, ``--test`` modes, FC tower, FC third stage, data prep,
RAFT training and poke UI on one NVIDIA GPU.

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
      latent, and on its wide path (``K5_WIDE_CASES``) the `reshape: down`
      stack's 4x4 flows at C = 128 / 96 / 64, hid 256 / 384 / 256, B = 40;
      each with two calls bitwise equal, its shared memory (held
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
  (p) the reproduction recipes of config/pretrained_models/ (fp32,
      Adafactor): (p1) plants_64.yaml at its width and depth (the
      1054.43M-param cINN, B=40, 64 px), frozen nets from the shipped
      first-stage and encoder YAMLs drawn from the seed, through
      ``SecondStageTrainer``: fp32 DDI, one step with the launch counts
      zeroed before and read after (no kernel: K1/K4 are bf16 only), 3
      steps timed with CUDA events (ms/step, peak memory, the Adafactor
      state's bytes beside AMSGrad's), then one full-depth
      ``forward_sample`` (200 K2, 3 K3) with every launch held against its
      plain version; (p2) SMALL, fp32, 3 steps card against CPU under
      Adafactor and under AdaBelief: losses and optimizer states.
  (r) the paper's PyTorch checkpoints (ipoke_tpu_torch.reference, fp32,
      TF32 off, reference-layout states drawn from a seed): (r1) SMALL
      with architecture.torch_compat from Lightning .ckpt files through
      the loader, card against the CPU port within REF_TOL abs + rel; (r2)
      SHIPPED (128 px, B=40, T=10, the 1054.43M-param cINN) with
      torch_compat, the states held in memory: one pass with the launch
      counts zeroed before and read after (200 K2, 4 K3), REF_PASSES timed
      passes and the peak memory, one pass under torch.profiler (busy
      share, K2's and K3's device time in it), every K2 and K3 launch
      against its plain version, then the same weights with torch_compat off, timed in
      turns (on, off, on); (r3), after (k): (k)'s poke_encoder run again
      with the native loader helpers and then under IPOKE_NATIVE=0, the
      loader's wait per step of each.
  (i) the first-stage VAE-GAN train step (config/first_stage.yaml: 64 px,
      B=20, T=10, fp32): (i1) K3 at the decoder's training shapes (fp32,
      20 frames, one modulation per frame, 16/32/64 px) against its plain
      version, bitwise repeated, with its bound, and its backward; (i2) the
      TINY config 3 steps card against CPU; (i3) the yaml config: one step
      with the launch counts zeroed before and read after (this path's run),
      every net checked to move, 3 steps timed with CUDA events (ms/step,
      clips/s, peak memory), a host split of one step and a
      ``torch.profiler`` table of one step with K3's in-situ time.
      Under ``training.mixed_prec`` (bf16 compute over fp32 params): (q3)
      K3 in bf16 at the training shapes, forward and backward; (q1) TINY 3
      steps card against CPU, both bf16, by a rule fixed against the CPU
      port in float64 in the same run, and one ``full_sequence: false``
      step by the (i2) rule; (q2) the yaml config's step as (i3), beside
      (i3)'s fp32 step.
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
  (l') the UI's ``main`` route (``ui.server.load_experiment``) on (k)'s
      second-stage run: TF32 on before and off after, the restored flow
      params equal to the best checkpoint's weights, one ``/poke`` over
      HTTP with the launch counts zeroed before and read after (path
      ``ui_restored_poke``, against ``expected_ui_launches``).
  (p3) plants_64.yaml through ``main.run`` at (k)'s depth cut, its frozen
      nets (k)'s first_stage, img_encoder and poke_encoder runs named
      plants_64 by a registry file (``IPOKE_TPU_REGISTRY``): one epoch, a
      restore check (the Adafactor state and params bit for bit), then
      --resume for one more, each run against ``expected_cli_launches``.
      (k)'s second-stage and third-stage runs are removed first (disk).
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
  (o) data prep, RAFT training and the poke UI: (o1) two synthetic MJPG
      clips (written, then read back: an unreadable format fails) prepared
      by ``data.prep.run`` from config/data_preparation/iper.yaml (raw and
      processed dirs and video_format changed): frames and RAFT flows at
      256 px, lags 5 and 10, the full-width ``RAFTConfig()``, then
      PoseResNet-50 pose prep, with the launch counts zeroed before and read
      after (path ``prep``: no kernel); every file, shape and value checked;
      ms per RAFT pair and per pose batch; one pair card against CPU
      (``RAFT_CARD_*_TOL``), its forward's device time, a
      ``torch.profiler`` table of one pair and its fp32 bound from the
      operations ``torch.utils.flop_counter`` counts; (o2)
      ``train_raft_synthetic`` (400 steps, EPE < RAFT_EPE_GATE) and
      ``finetune_raft_selfsup`` (160 steps, epe1 < SELFSUP_GATE epe0) on
      the small ``SYNTHETIC_CFG`` net at 32 px, as the JAX package's slow
      tests gate it, then ``finetune_raft_selfsup`` of the full-width
      ``init_raft()`` on (o1)'s 256 px frame pairs (lag 5,
      RAFT_FULL_BATCH a step, RAFT_FULL_STEPS timed after one), loss
      finite and every parameter finite and moved; ms per step and peak
      memory for each (paths ``raft_train_synthetic``, ``raft_selfsup``,
      ``raft_selfsup_full``: no kernel); (o3) config/second_stage.yaml's
      experiment at its width and
      depth (1054.43M params, fp32, frozen nets drawn) on (o1)'s tree,
      served: ``GET /``, ``/frame``, UI_POKES ``POST /poke`` (10 PNG frames
      each; path ``ui_poke``) and one ``POST /save`` (its 3 ground-truth
      pokes; path ``ui_save``), each with the launch counts zeroed before
      and read after and held against ``expected_ui_launches`` (K2 200 and
      K3 3 a pass), ms per ``/poke``; then one poke of a session of its own
      with every K2 and K3 call's inputs and output kept, each held against
      its plain version on those inputs (K2 at B = 1, K3 at 10 frames of one
      clip; ``poke_kernel_check``), each distinct shape timed with its
      bound; and a ``torch.profiler`` table of one poke.  (l') runs the same
      check at (k)'s widths.  Alone: ``_build.load()``, then ``with
      prep_root() as root:`` ``phase_prep(dev, smi, root)``,
      ``phase_raft_train(dev, smi, processed)``, ``phase_ui(dev, smi, root,
      processed)``.

  (s) the second stage's options (``OPTION_VARIANTS``): A flow_ae, a
      poke_and_image embedder at 2x and a variational conditioner at 1/2 of
      the first stage's latent size (both conv_adapt adapters), bf16; B
      additive steps over relu priors without a conditioner, bf16; C a
      MultiscaleStack (reshape up, levels [[4, 3, 2], [4, 3, 2]], factors
      [16, 4]) with use1x1, fp32; C' that stack without use1x1 in bf16,
      NICE hidden 64 x C (512 at 16x16x8).  (s1) SMALL, each variant card against the CPU
      port: one ``forward_sample`` with every K1, K2 and K3 launch held
      against its plain version on its inputs and the frames by phase (d)'s
      rule (bf16) or within 1e-3 abs + rel (fp32), then 2 train steps by
      phase (f)'s rule with every K1 and K4 launch of the first held so (and
      A's adapters moved); (s2) A, B and C at the shipped widths (128 px,
      B = 40, T = 10): one pass with the launch counts zeroed before and
      read after and every launch held against its plain version (A's
      shapes timed), 3 timed passes, peak memory, and for A a
      ``torch.profiler`` table of one pass; (s3), after (l') in the same
      ``cli_tree``: ``main.run`` of img_encoder (variational, min 4),
      poke_encoder (poke_and_image, flow_ae, min 16) and a second_stage over
      them and (k)'s first stage (depth OPTION_CLI_STEPS), its restore
      check and --resume, each against ``expected_cli_launches``.  Alone:
      ``_build.load()``, ``phase_options_small(dev)``,
      ``phase_options_shipped(dev, smi)``; (s3) after ``phase_cli`` in a
      ``cli_tree``.
  (t) variant D (``STACK_DOWN``: (s2)'s C with `reshape: down`, 8x8x32
      then 4x4x128) at the shipped widths: the flow's fp32 round trip
      within ROUNDTRIP_TOL with every K2 (36) and K5 (144) launch of the
      inverse held against its plain version on its inputs (each shape
      timed), 2 timed inverses; then in bf16 one ``forward_sample`` with
      every K1, K2, K5 and K3 launch held so, 2 timed passes, peak memory.
      Alone: ``_build.load()``, ``phase_down_stack(dev, smi)``.
  (u) the PokeVAE baseline (``architecture.baseline``): (u1) TINY, 3 steps
      card against CPU by the (i2) rule; (u2) config/first_stage.yaml with
      ``baseline: true`` (64 px, B = 20, fp32): one step with every K3
      launch (60) held against its plain version on its inputs, 3 steps
      timed with CUDA events, peak memory; (u3), after (s3) in the same
      ``cli_tree``: ``main.run`` of that config for one epoch, a bitwise
      restore check and --resume.  Alone: ``_build.load()``,
      ``phase_poke_vae(dev, smi)``, then in a ``cli_tree``
      ``phase_poke_vae_cli(dev, smi, tree)``.

  (v) K5's streamed instance (fault (e)): 2x2x512 at hid 512, 4x4x256 at
      hid 2048 and a 16x16x128 row at hid 256, B = 40, rows staged in
      shared memory, and a 2x64x512 row at hid 512 (B = 8), too wide to
      stage, each against its
      plain version within K5_TOL, two calls bitwise equal, with its time
      and bound.  Alone: ``_build.load()``, ``phase_k5_streamed(dev)``.
  (w) the dp x tp mesh (``ipoke_tpu_torch.parallel``), two ranks on the
      one card over gloo: the dryrun's toy step and pass at dp 1 x tp 2
      and dp 2 x tp 1 within 2e-4 of one rank; the SHIPPED widths at
      MESH_STEPS (bf16 with fp32 masters) at tp = 2 and dp = 2: a
      ``forward_sample`` and a train step against one rank
      (``mesh_shipped_leg``), each rank's K1 and K4 launches counted and
      held against their plain versions; a world of one over NCCL for one
      step; K1/K4 at the tp = 2 shard's shapes beside the whole coupling's;
      the SHIPPED flow's shard bytes at tp = 2 and 4 on ``meta``.  Alone:
      ``_build.load()``, ``phase_mesh(dev, smi)``.
  (x) the dormant zoo (MixCDF, the hierarchical coupling flow, MADE, the
      gated conv and attention, LeapFlow, AdaIN, Generator3D, minibatch
      discrimination) card against CPU: ``phase_zoo(dev)``.

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
import os
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

# K1/K4 (M, C1, Hid, Cout): the level-0 step coupling, a prior, the level-0
# coupling of the 8x16 latent (phase h), SMALL's level-0 coupling, an
# additive level-0 coupling (N = 9 x 16 = 144), a MultiscaleStack's 16x16x8
# block at B = 40 (hidden 512)
K1_CASES = ((2560, 16, 2048, 32), (2560, 30, 2048, 4), (5120, 16, 2048, 32),
            (512, 16, 256, 32), (2560, 16, 2048, 16), (10240, 4, 512, 8))
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
# K5's wide path (B, H, W, C, hid, Ch, order): the three levels of a
# `reshape: down` MultiscaleStack's second block over the shipped 8x8x32
# first stage (phase t): 4x4 at C = 128, 96, 64 with MCF hidden
# default_mcf_hidden(C) = 256, 384, 256
K5_WIDE_CASES = ((40, 4, 4, 128, 256, 128, "A"), (40, 4, 4, 96, 384, 128, "A"),
                 (40, 4, 4, 64, 256, 128, "A"))
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
# K1 and K4 in situ: K1_TOL abs + rel with the abs part scaled by the
# output's magnitude where that is below 1 (a flow's out convs start with
# g ~ 0.01, so u is ~1e-2 there, where K1_TOL alone would pass zeros);
# phase (c)'s random unit weights give outputs of order 1, its plain K1_TOL
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


def nice_work(m, k1, hid, n, train, hs=None):
    """(bytes, flops) of K1 (K4 with ``train``): bf16 zcol and weights read
    once, u written in fp32 (and a, b in bf16); ``hs``: the hidden width of
    w2's columns and wp's rows on a mesh rank's shard (Hid when whole)."""
    hs = hid if hs is None else hs
    nbytes = 2 * (m * k1 + k1 * hid + hid * hs + hs * n) + 4 * m * n
    if train:
        nbytes += 2 * m * (hid + hs)
    return nbytes, 2 * m * (k1 * hid + hid * hs + hs * n)


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
    errs, times, wide = [], [], []
    cases = [(b, hh, ww, c, 4 * c, ch, o) for b, hh, ww, c, ch, o in K5_CASES]
    for b, hh, ww, c, hid, ch, order in cases + list(K5_WIDE_CASES):
        transposed, reverse = order in "CD", order in "BD"
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
        regs = masked_conv.k5_registers(c, hid, 2)
        line = (f"K5 masked_conv_inverse order {order} B={b} H={hh} W={ww} C={c} "
                f"hid={hid} Ch={ch}: max_abs_err {err:.3e} (tol {K5_TOL}), two "
                f"calls bitwise equal, kernel {ms:.4f} ms, bound "
                f"{1e3 * bound_ms:.2f} us ({bound_by}; {100 * bound_ms / ms:.1f}% "
                f"of it); {'tap weights in registers' if regs else 'wide path'}, "
                f"clusters of {k}, {smem} B of shared memory per CTA, "
                f"{lib.masked_conv_inverse_max_clusters(sw, c, hid, 2, 3, k)} "
                f"clusters resident at once")
        if not times or not regs:  # the level-0 flow, order A; the wide shapes
            plain_ms = cuda_ms(lambda: masked_conv.masked_conv_inverse_plain(*args), 3)
            line += f"; plain {plain_ms:.4f} ms"
            if not times:
                times = (ms, plain_ms)
            else:
                wide.append({"B": b, "H": hh, "W": ww, "C": c, "hid": hid,
                             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                             "bound_ms": bound_ms, "bound_by": bound_by,
                             "library_ms": None, "cluster": k, "smem_bytes": smem})
        print(line)
    b, hh, ww, c, ch, _ = K5_CASES[0]
    out = row(max(errs), times, k5_work(b, hh, ww, c, 4 * c), FP32_FLOPS)
    out["down_stack_shapes"] = wide

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


class ProfiledKey:
    """One name's events of a profiled run: ``count`` and, for device
    events, their summed duration in us (``self_device_time_total``, the
    field of ``key_averages``' rows)."""

    __slots__ = ("key", "device_type", "count", "self_device_time_total")

    def __init__(self, key, device_type):
        self.key, self.device_type = key, device_type
        self.count, self.self_device_time_total = 0, 0.0


def profile_keys(prof):
    """The raw profiler events of ``prof`` grouped by name and device type,
    as ``key_averages`` groups them, without building its per-event
    objects: a step's ~180k events group in seconds where
    ``key_averages`` took minutes."""
    cuda = torch.autograd.DeviceType.CUDA
    keys, names = {}, {}
    for e in prof.profiler.kineto_results.events():
        raw, dtype = e.name(), e.device_type()
        k = keys.get((raw, dtype))
        if k is None:
            if raw not in names:
                names[raw] = torch._C._demangle(raw)
            k = keys[(raw, dtype)] = ProfiledKey(names[raw], dtype)
        k.count += 1
        if dtype == cuda:
            k.self_device_time_total += (e.end_ns() - e.start_ns()) / 1e3
    return list(keys.values())


def cross_check_keys(name, prof, kernels):
    """``profile_keys``' device events of ``prof`` against ``key_averages``'
    (how the busy shares before it were taken): the launch counts and device
    times in total and by name must agree."""
    t0 = time.perf_counter()
    theirs = {e.key: e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA}
    ours = {e.key: e for e in kernels}
    total = lambda es: (sum(e.count for e in es),
                        sum(e.self_device_time_total for e in es) / 1e3)
    (n_ours, ms_ours), (n_theirs, ms_theirs) = total(ours.values()), total(theirs.values())
    both = ours.keys() & theirs.keys()
    counts = sum(ours[k].count != theirs[k].count for k in both)
    dt = max((abs(ours[k].self_device_time_total - theirs[k].self_device_time_total)
              for k in both), default=0.0)
    print(f"{name}: key_averages (in {time.perf_counter() - t0:.1f} s) reads {n_theirs} "
          f"device launches, {ms_theirs:.4f} ms of device time; profile_keys {n_ours}, "
          f"{ms_ours:.4f} ms; {len(both)} names in both, {len(ours) - len(both)} / "
          f"{len(theirs) - len(both)} in one only, {counts} counts differ, device times "
          f"by name within {dt:.3f} us")
    if n_ours != n_theirs or abs(ms_ours - ms_theirs) > 1e-3 * ms_theirs or counts:
        raise AssertionError(f"{name}: profile_keys and key_averages disagree")


def profiled(name, fn, cross_check=False):
    """Run ``fn`` once under ``torch.profiler``; print its device launches,
    device time against its (profiled) wall time and the 20 kernels with the
    most device time (with ``cross_check``, ``cross_check_keys`` too).
    Returns (all events, device events) by name (``profile_keys``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    events = profile_keys(prof)
    # device-side events only (the kernels and memcpys/memsets themselves;
    # the CPU ops that launched them carry the same time again)
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"{name} under torch.profiler: {sum(e.count for e in kernels)} device "
          f"launches, {dev_ms:.1f} ms of device time in {wall:.1f} ms of "
          f"(profiled) wall ({100 * dev_ms / wall:.1f}% busy); events grouped "
          f"in {time.perf_counter() - t0:.1f} s")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d} x  "
              f"{e.key[:90]}")
    if cross_check:
        cross_check_keys(name, prof, kernels)
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


def phase_k3_train(dev, dtype=torch.float32):
    """(i1) K3 at the decoder's training shapes in ``dtype`` ((q3): bf16):
    forward against the plain version, two calls bitwise equal, device
    times, bound and share; the backward (K3 + the portable VJP) against
    autograd of the plain version, its gradients in ``dtype``."""
    from ipoke_tpu_torch.ops import _build, spade_gn

    gen = torch.Generator(device=dev).manual_seed(5)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    lib, n, tol, rows = _build.load(), K3_TRAIN_FRAMES, K3_TOL[dtype], []
    size = torch.empty((), dtype=dtype).element_size()
    word = "bf16" if dtype == torch.bfloat16 else "fp32"
    for s, ch in K3_TRAIN_CASES:
        x = (randn(n, s, s, ch) * 2.0 + 0.5).to(dtype)
        gamma = (randn(n, s, s, ch) * 0.5).to(dtype)
        beta = (randn(n, s, s, ch) * 0.5).to(dtype)
        got = spade_gn.spade_gn_cuda(x, gamma, beta, 16)
        want = spade_gn.spade_gn_plain(x, gamma, beta, 16)
        err = check_close(f"K3 train S={s} Ch={ch}", got, want, tol, tol)
        if not torch.equal(got, spade_gn.spade_gn_cuda(x, gamma, beta, 16)):
            raise AssertionError(f"K3 train S={s} Ch={ch}: two calls differ")
        ms = cuda_ms(lambda: spade_gn.spade_gn_cuda(x, gamma, beta, 16), 50)
        plain = cuda_ms(lambda: spade_gn.spade_gn_plain(x, gamma, beta, 16), 20)
        bound_ms, bound_by = bound(*spade_work(n, n, s, ch, size), FP32_FLOPS)
        k, resident = spade_gn.spade_gn_plan(s * s, ch, size)
        clusters = lib.spade_gn_max_clusters(s * s, ch, 16, int(dtype == torch.bfloat16),
                                             k, int(resident))
        r = randn(n, s, s, ch).to(dtype)

        def grads(fn):
            leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
            return torch.autograd.grad((fn(*leaves, 16) * r).sum(), leaves)

        got_g = grads(spade_gn.spade_gn_modulate)
        if any(g.dtype != dtype for g in got_g):
            raise AssertionError(f"K3 train {word} S={s}: gradients in "
                                 f"{[g.dtype for g in got_g]}")
        g_err = max(check_close(f"K3 train grad {g} S={s} Ch={ch} {word}", a, b, tol, tol)
                    for g, a, b in zip(("x", "gamma", "beta"), got_g,
                                       grads(spade_gn.spade_gn_plain)))
        g_ms = cuda_ms(lambda: grads(spade_gn.spade_gn_modulate), 10)
        g_plain = cuda_ms(lambda: grads(spade_gn.spade_gn_plain), 10)
        print(f"K3 spade_gn train N={n} t=1 S={s} Ch={ch} G=16 {word}: max_abs_err "
              f"{err:.3e} (tol {tol} abs+rel), two calls bitwise equal, kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}; {100 * bound_ms / ms:.1f}% of it); clusters of {k}, "
              f"slices {'kept in' if resident else 'streamed past'} shared memory, "
              f"{clusters} clusters resident at once; backward: gradients max_abs_err "
              f"{g_err:.3e}, forward + backward {g_ms:.4f} ms, plain {g_plain:.4f} ms")
        rows.append({"S": s, "Ch": ch, "frames": n, "dtype": word, "max_abs_err": err, "ms": ms,
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
    print(f"{name}, card vs CPU from the same state, |diff| / (1 + |CPU|) "
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


def phase_first_stage(dev, smi, cfg=None, label="FIRST_STAGE"):
    """(i3) config/first_stage.yaml on the card ((q2): ``cfg``
    FIRST_STAGE_BF16, under ``mixed_prec``): the path's run with launch
    counts, every net moved, 3 timed steps, a host split and a profile."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.models.first_stage import sample_draws
    from ipoke_tpu_torch.train import FirstStageTrainer

    cfg = cfg or entry.FIRST_STAGE
    word = "bf16 (fp32 params)" if cfg["training"].get("mixed_prec") else "fp32"
    B = cfg["data"]["batch_size"]
    t0 = time.perf_counter()
    nets = entry.build_first_stage(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    batch = entry.make_first_stage_batch(cfg, dev)
    trainer = FirstStageTrainer(cfg, *nets)
    draw_gen = torch.Generator(device=dev).manual_seed(1)
    before = [[p.detach().clone() for p in net.parameters()] for net in nets[:3]]
    torch.cuda.synchronize()
    print(f"{label} built in {time.perf_counter() - t0:.1f} s: params "
          + ", ".join(f"{name} {sum(p.numel() for p in net.parameters()) / 1e6:.2f}M"
                      for name, net in zip(("generator", "d_s", "d_t", "vgg"), nets)))

    ops.reset_launches()  # the first-stage path's run
    metrics = trainer.train_step(batch, 0, draw_gen)
    torch.cuda.synchronize()
    launches = check_launches(f"{label} train step", expected_first_stage_launches(cfg))
    metrics = {k: v.item() for k, v in metrics.items()}
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"{label} metrics {metrics}")
    for name, net, p0 in zip(("generator", "d_s", "d_t"), nets[:3], before):
        still = sum(torch.equal(a, b) for a, b in zip(p0, net.parameters()))
        if still:
            raise AssertionError(f"{label}: {still} {name} params did not move")
    print(f"{label} step 1: every param of generator, d_s and d_t moved; "
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
    print(f"{label} train {word} B={B} T={cfg['data']['max_frames']} "
          f"{cfg['data']['spatial_size'][0]}px: {ms:.1f} ms/step "
          f"({', '.join(f'{t:.1f}' for t in times)}), {B / (ms / 1e3):.2f} clips/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

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
    print(f"{label} step parts, host clock: " + "; ".join(
        f"{name} {1e3 * (t - t_prev):.1f} ms"
        for (_, t_prev), (name, t) in zip(marks, marks[1:])))

    _, kernels = profiled(f"{label} train step",
                          lambda: trainer.train_step(batch, 0, draw_gen))
    per_call = report_in_situ(kernels, "the step", "K3", "spade_gn_kernel",
                              launches["spade_gn"])
    return launches, {"ms_per_step": ms, "in_situ_ms_per_call": per_call,
                      "peak_gib": peak}


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
    from ipoke_tpu_torch.models.pretrained_registry import resolve

    sec = resolve("first_stage", dict(cfg["first_stage"]))
    return len(load_config(sec["config"])["architecture"]["dec_channels"]) - 1


def expected_cli_launches(name, cfg, n_train, n_val):
    """Per CLI run of ``name`` with ``n_train`` steps and ``n_val`` val
    batches: the first stage's K3, conv or FC (60 a train step at T = 10,
    one per decode level a val batch); the second stage's bf16 steps (K1 in
    each step's no-grad pass, K4 in its recompute and the priors; its fp32
    DDI runs no kernel), its validation's no-grad density (K1 in every
    coupling) and sampling pass (K1, K2 in every unit, K3 per decode level);
    an fp32 second stage (the recipes) runs no K1 or K4;
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
        if cfg["training"].get("mixed_prec_master", False):  # K1/K4: bf16 only
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


def drive_cli(dev, smi, data_root, exp, path, *extra, model_name="smoke"):
    """One CLI run of ``exp`` from the config at ``path`` as ``model_name``,
    with the launch counts zeroed before and read after (the path's run,
    held against ``expected_cli_launches``); returns the experiment and its
    record."""
    from ipoke_tpu_torch import ops

    probe_us = host_probe(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30  # before the run
    stats0 = torch.cuda.memory_stats()
    ops.reset_launches()  # this CLI run
    t_run = time.perf_counter()
    e = run_cli(["--config", path, "--model_name", model_name, "--data_root", data_root,
                 *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    got = dict(ops.LAUNCHES)
    tm = e.timings
    n_train, n_val = len(tm["step_s"]), len(tm["val_s"])
    want = expected_cli_launches(exp, e.config, n_train, n_val * e.max_val_batches)
    label = f"CLI {exp}{'' if model_name == 'smoke' else f' ({model_name})'}" \
        f"{' --resume' if extra else ''}"
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
    check_second_stage_restore(e1, ss_path, data_root, "smoke", dev)
    step1, count1 = e1.step, e1.tx.count
    del e1
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


def phase_native_loader(dev, smi, tree):
    """(r3) (k)'s poke_encoder run (images, pokes and flows through the
    loader) again, its frames and flows decoded by the native helpers of
    ``data/native.py``, then under ``IPOKE_NATIVE=0`` (cv2 and numpy): the
    loader's wait per step, the first batch's and the mean of the rest, in
    turn on the card's host."""
    from ipoke_tpu_torch.data import native

    path = os.path.join(tree["root"], "poke_encoder.yaml")
    out = {}
    for label, flag in (("native", "1"), ("cv2", "0")):
        os.environ["IPOKE_NATIVE"] = flag
        try:
            e, rec = drive_cli(dev, smi, tree["data_root"], "poke_encoder", path)
        finally:
            os.environ.pop("IPOKE_NATIVE", None)
        del e
        release()
        wait = rec["loader_wait_ms"]
        out[label] = {"loader_wait_ms": wait, "first_ms": wait[0],
                      "rest_mean_ms": sum(wait[1:]) / max(1, len(wait) - 1)}
    if not native.LIB.exists():
        raise AssertionError("(r3) the native loader library was not built")
    print(f"(r3) CLI poke_encoder loader wait per step, native decoders: first batch "
          f"{out['native']['first_ms']:.2f} ms, then {out['native']['rest_mean_ms']:.2f} ms "
          f"mean; IPOKE_NATIVE=0 (cv2): first {out['cv2']['first_ms']:.2f} ms, then "
          f"{out['cv2']['rest_mean_ms']:.2f} ms mean; on the card's host, {smi}")
    return out


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
    # the smallest profile of the script (~3400 launches) is also grouped by
    # key_averages: the grouping does not depend on the path, and
    # key_averages' cost grows with the events (~18 s at a SHIPPED pass's)
    events, kernels = profiled("(n4) third_stage_fc sample_video",
                               lambda: e.sample_video(batch, FC_THIRD_T), cross_check=True)
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


# (o) data prep, RAFT training and the poke UI.  (o1) two synthetic raw
# clips (MJPG .avi: OpenCV's own writer, no ffmpeg) prepared by the port's
# ``data.prep.run`` from config/data_preparation/iper.yaml (raw_dir,
# processed_dir and video_format changed): frames and flows at 256 px, lags
# 5 and 10, the full-width RAFTConfig() (fixed-seed weights), then
# PoseResNet-50 pose prep; RAFT card against CPU on one pair.  (o2) RAFT
# trained from scratch on synthetic translations and fine-tuned
# self-supervised, with the JAX package's slow tests' gates
# (tests/test_raft.py:173-184, :256-293).  (o3) the UI over
# config/second_stage.yaml at its width and depth (fp32, frozen nets drawn
# from the seed) on (o1)'s tree: ``/poke`` and ``/save`` over HTTP.
PREP_CLIPS, PREP_FRAMES, PREP_RAW_SIZE = 2, 32, 320
RAFT_EPE_GATE, SELFSUP_GATE = 2.0, 0.93
# (o2) the full-width net's self-supervised steps: a batch of 8 pairs at
# 256 px, one untimed step, then RAFT_FULL_STEPS timed
RAFT_FULL_BATCH, RAFT_FULL_STEPS = 8, 5
UI_POKES = 3
# (o1) RAFT at 256 px, card against CPU from the same fixed-seed weights,
# fp32, TF32 off (cuDNN's implicit-GEMM convs vs oneDNN's, summing in other
# orders, carried through 12 GRU iterations): the largest error over the
# flow's largest magnitude and the mean error over its mean magnitude read
# 9.3e-7 and 5.7e-7 on an NVIDIA H100 80GB HBM3 at 700 W (6.5e-5 px of a
# 69.5 px flow); the bounds are ten times that.  A wrong layout, lookup or
# crop moves the flow by O(its size).
RAFT_CARD_MAX_TOL, RAFT_CARD_MEAN_TOL = 1e-5, 6e-6


@contextlib.contextmanager
def prep_root():
    """A temporary directory for phase (o), removed on exit."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    try:
        yield root
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_raw_clips(raw_dir):
    """PREP_CLIPS MJPG .avi clips of PREP_FRAMES textured frames, each
    shifting a blurred random texture by a few pixels a frame; each read
    back (frame count and size), so an unreadable format fails here."""
    import os

    import cv2
    import numpy as np

    os.makedirs(raw_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    s = PREP_RAW_SIZE
    for v in range(PREP_CLIPS):
        tex = cv2.GaussianBlur(rng.uniform(0, 255, (2 * s, 2 * s, 3)).astype(np.float32),
                               (0, 0), 4.0)
        tex = cv2.normalize(tex, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
        path = os.path.join(raw_dir, f"clip_{v}.avi")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (s, s))
        if not wr.isOpened():
            raise AssertionError(f"cv2 cannot write MJPG .avi ({path})")
        vx, vy = (2, 1) if v == 0 else (-1, 3)
        for t in range(PREP_FRAMES):
            y0, x0 = s // 2 + vy * t, s // 2 + vx * t
            wr.write(np.ascontiguousarray(tex[y0:y0 + s, x0:x0 + s]))
        wr.release()
        cap = cv2.VideoCapture(path)
        n, shape = 0, None
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            n, shape = n + 1, frame.shape
        cap.release()
        if n != PREP_FRAMES or shape != (s, s, 3):
            raise AssertionError(f"{path}: read back {n} frames of {shape}, wrote "
                                 f"{PREP_FRAMES} of {(s, s, 3)}")


def raft_flops(net, x1, x2):
    """The fp32 multiply-adds x 2 of one RAFT pair (its convolutions and
    products), counted by ``torch.utils.flop_counter`` on the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        net(x1, x2)
    return fc.get_total_flops()


def phase_prep(dev, smi, root):
    """(o1) ``data.prep.run`` of the iPER YAML on the card: extraction with
    full-width RAFT, ``meta.p``, pose prep; every file, shape and value
    checked; ms per RAFT pair and per pose batch; RAFT card against CPU on
    one pair, with its operations' bound."""
    import os
    import pickle

    import cv2
    import numpy as np

    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.data import prep
    from ipoke_tpu_torch.eval.pose import PoseEstimator
    from ipoke_tpu_torch.nn import raft

    raw, out = os.path.join(root, "raw"), os.path.join(root, "processed")
    t0 = time.perf_counter()
    write_raw_clips(raw)
    print(f"(o1) {PREP_CLIPS} MJPG clips of {PREP_FRAMES} frames at {PREP_RAW_SIZE} px "
          f"written and read back in {time.perf_counter() - t0:.1f} s")
    cfg = prep.load_prep_config(os.path.join("config", "data_preparation", "iper.yaml"))
    cfg.update(raw_dir=raw, processed_dir=out, video_format="avi")
    size, lags = cfg["spatial_size"], list(range(cfg["flow_delta"], cfg["flow_max"] + 1,
                                                 cfg["flow_delta"]))
    if (size, lags, cfg["flow_estimator"], cfg["data"]["dataset"]) != \
            (256, [5, 10], "raft", "IperDataset"):
        raise AssertionError(f"(o1) iper.yaml: {size}, {lags}, {cfg['flow_estimator']}")
    pair_s, pose_s = [], []
    est, pose_call = prep._FLOW_ESTIMATORS["raft"], PoseEstimator.__call__

    def timed_est(a, b, device):
        t = time.perf_counter()
        flow = est(a, b, device)  # on the host: the call synchronized
        pair_s.append(time.perf_counter() - t)
        return flow

    def timed_pose(self, frames):
        t = time.perf_counter()
        kps = pose_call(self, frames)
        pose_s.append(time.perf_counter() - t)
        return kps

    prep._FLOW_ESTIMATORS["raft"], PoseEstimator.__call__ = timed_est, timed_pose
    ops.reset_launches()  # the prep path's run
    t0 = time.perf_counter()
    try:
        prep.run(cfg, device=dev)
    finally:
        prep._FLOW_ESTIMATORS["raft"], PoseEstimator.__call__ = est, pose_call
    wall = time.perf_counter() - t0
    launches = check_launches("(o1) prep", dict.fromkeys(CLI_KERNELS, 0))
    n_rows = PREP_CLIPS * (PREP_FRAMES - lags[-1])
    for v in range(PREP_CLIPS):
        d = os.path.join(out, f"clip_{v}")
        frames = [cv2.imread(os.path.join(d, f"frame_{i}.png")) for i in range(PREP_FRAMES)]
        if any(f is None or f.shape != (size, size, 3) for f in frames):
            raise AssertionError(f"(o1) {d}: frames")
        for i in range(PREP_FRAMES - lags[-1]):
            for lag in lags:
                flow = np.load(os.path.join(d, f"prediction_{i}_{i + lag}.flow.npy"))
                if flow.shape != (2, size, size) or flow.dtype != np.float32 \
                        or not np.isfinite(flow).all():
                    raise AssertionError(f"(o1) {d} flow {i}->{i + lag}: {flow.shape}")
    for name in ("meta.p", "meta_kp_nn.p"):
        with open(os.path.join(out, name), "rb") as f:
            meta = pickle.load(f)
        kps = meta["keypoints"]
        if len(meta["img_path"]) != n_rows or meta["flow_paths"].shape != (n_rows, 2) \
                or kps.shape != (n_rows, 17, 2) or not np.isfinite(kps).all() \
                or meta["kp_nn"].shape != (n_rows,):
            raise AssertionError(f"(o1) {name}: {len(meta['img_path'])} rows, keypoints "
                                 f"{kps.shape}")
    if len(pair_s) != PREP_CLIPS * (PREP_FRAMES - lags[-1]) * len(lags):
        raise AssertionError(f"(o1) {len(pair_s)} RAFT pairs")
    pair_ms = 1e3 * sum(pair_s[1:]) / (len(pair_s) - 1)
    pose_ms = 1e3 * sum(pose_s[1:]) / max(1, len(pose_s) - 1)
    print(f"(o1) prep of {PREP_CLIPS} clips in {wall:.1f} s: {len(pair_s)} RAFT pairs at "
          f"{size} px, {pair_ms:.2f} ms a pair after the first ({1e3 * pair_s[0]:.1f} ms; "
          f"min {1e3 * min(pair_s):.2f}, max {1e3 * max(pair_s[1:]):.2f}); {len(pose_s)} "
          f"pose batches (PoseResNet-50, {cfg.get('pose_input_size', 64)} px), "
          f"{pose_ms:.2f} ms a batch after the first ({1e3 * pose_s[0]:.1f} ms); "
          f"{n_rows} rows with keypoints; launches {launches} on {smi}")
    # one pair card against CPU, the same fixed-seed weights, fp32, TF32 off
    a, b = (cv2.cvtColor(cv2.imread(os.path.join(out, "clip_0", f"frame_{i}.png")),
                         cv2.COLOR_BGR2RGB) for i in (0, lags[0]))
    got = raft.raft_estimator(a, b, dev)
    t0 = time.perf_counter()
    want = raft.raft_estimator(a, b, "cpu")
    cpu_s = time.perf_counter() - t0
    err = np.abs(got - want)
    mx, mean = err.max() / np.abs(want).max(), err.mean() / np.abs(want).mean()
    _, kernels = profiled(f"(o1) one RAFT pair at {size} px (the estimator's call)",
                          lambda: raft.raft_estimator(a, b, dev))
    fwd_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    x1, x2 = (torch.from_numpy(im.astype(np.float32).transpose(2, 0, 1)[None] / 127.5 - 1.0)
              for im in (a, b))
    flops = raft_flops(raft.init_raft(), x1, x2)
    bound_ms = 1e3 * flops / FP32_FLOPS
    print(f"(o1) RAFT at {size} px card vs CPU (fp32, TF32 off): max abs err {err.max():.3e} "
          f"({mx:.2e} of the largest |flow| {np.abs(want).max():.2f}; tolerance "
          f"{RAFT_CARD_MAX_TOL:g}), mean {err.mean():.3e} ({mean:.2e} of the mean |flow| "
          f"{np.abs(want).mean():.3f}; tolerance {RAFT_CARD_MEAN_TOL:g}); the CPU "
          f"{1e3 * cpu_s:.0f} ms a pair; the pair's device time {fwd_ms:.2f} ms (profiled); "
          f"{flops / 1e9:.2f} GFLOP a pair, fp32 bound {bound_ms:.2f} ms "
          f"({100 * bound_ms / fwd_ms:.1f}% of the device time, "
          f"{100 * bound_ms / pair_ms:.1f}% of the prep's "
          f"{pair_ms:.2f} ms a pair) on {smi}")
    if mx > RAFT_CARD_MAX_TOL or mean > RAFT_CARD_MEAN_TOL or not np.isfinite(got).all():
        raise AssertionError(f"(o1) RAFT card vs CPU: {err.max()} / {err.mean()}")
    return {"prep": launches}, {"processed": out, "pair_ms": pair_ms, "pose_ms": pose_ms,
                                "forward_ms": fwd_ms, "bound_ms": bound_ms,
                                "gflop": flops / 1e9}


def phase_raft_train(dev, smi, processed):
    """(o2) On the small ``SYNTHETIC_CFG`` net at 32 px,
    ``train_raft_synthetic(400 steps)`` to EPE < RAFT_EPE_GATE and
    ``finetune_raft_selfsup`` for 160 steps to ``epe1 < SELFSUP_GATE
    epe0``, as the JAX package's slow tests; then the full-width net on
    (o1)'s frame pairs (``raft_full_width_steps``).  ms per step on the
    host clock (the synthetic batches' cv2 work on the host included)."""
    import numpy as np

    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.nn import raft

    paths = {}
    ops.reset_launches()  # the supervised training path's run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, epe = raft.train_raft_synthetic(steps=400, seed=0, log_every=100, device=dev)
    torch.cuda.synchronize()
    sup_ms = 1e3 * (time.perf_counter() - t0) / 400
    paths["raft_train_synthetic"] = check_launches("(o2) RAFT synthetic training",
                                                   dict.fromkeys(CLI_KERNELS, 0))
    print(f"(o2) RAFT from scratch, small net (SYNTHETIC_CFG), 400 steps (B = 8, 32 px): "
          f"final EPE {epe:.3f} (gate < {RAFT_EPE_GATE}), {sup_ms:.2f} ms a step on {smi}")
    if not epe < RAFT_EPE_GATE:
        raise AssertionError(f"(o2) RAFT EPE {epe}")
    net = raft.init_raft(raft.SYNTHETIC_CFG, 0, dev)
    rng = np.random.default_rng(5)
    held = raft.synthetic_flow_batch(rng, 8, 32, 3.0, dev)

    def epe_of():
        with torch.no_grad():
            final = net.eval()(held["image1"], held["image2"])
        net.train()
        return float(torch.linalg.vector_norm(final - held["flow"], dim=1).mean())

    def batches(i):
        b = raft.synthetic_flow_batch(rng, 8, 32, 3.0, dev)
        return {"image1": b["image1"], "image2": b["image2"]}

    epe0 = epe_of()
    ops.reset_launches()  # the self-supervised path's run
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    log = raft.finetune_raft_selfsup(net, batches, steps=160, lr=1e-3)
    torch.cuda.synchronize()
    self_ms = 1e3 * (time.perf_counter() - t0) / 160
    paths["raft_selfsup"] = check_launches("(o2) RAFT self-supervised fine-tune",
                                           dict.fromkeys(CLI_KERNELS, 0))
    epe1 = epe_of()
    print(f"(o2) RAFT self-supervised, small net, 160 steps (B = 8, 32 px): EPE on held "
          f"pairs {epe0:.3f} -> {epe1:.3f} ({epe1 / epe0:.3f}; gate < {SELFSUP_GATE}), "
          f"loss {float(log['loss']):.4f}, {self_ms:.2f} ms a step on {smi}")
    if not epe1 < SELFSUP_GATE * epe0:
        raise AssertionError(f"(o2) self-supervised EPE {epe0} -> {epe1}")
    del net, held
    paths["raft_selfsup_full"], full = raft_full_width_steps(dev, smi, processed)
    return paths, {"synthetic_ms": sup_ms, "selfsup_ms": self_ms, "epe": epe,
                   "selfsup_ratio": epe1 / epe0, **full}


def raft_full_width_steps(dev, smi, processed):
    """``finetune_raft_selfsup`` of the full-width ``init_raft()`` (base 64,
    256-d features, 12 iterations, 4 levels, radius 4) on (o1)'s 256 px
    frame pairs at lag 5, RAFT_FULL_BATCH pairs a step: one untimed step,
    then RAFT_FULL_STEPS timed; the loss and every parameter finite and
    every parameter tensor moved; ms per step and peak memory."""
    import os

    import cv2
    import numpy as np

    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.nn import raft

    def frame(v, i):
        im = cv2.cvtColor(cv2.imread(os.path.join(processed, f"clip_{v}", f"frame_{i}.png")),
                          cv2.COLOR_BGR2RGB)
        return torch.from_numpy(im.astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0)

    lag = 5
    pairs = [(v, i) for v in range(PREP_CLIPS) for i in range(PREP_FRAMES - lag)]
    x1 = torch.stack([frame(v, i) for v, i in pairs]).to(dev)
    x2 = torch.stack([frame(v, i + lag) for v, i in pairs]).to(dev)
    net = raft.init_raft(device=dev)
    before = {k: p.detach().clone() for k, p in net.named_parameters()}
    n, B = x1.shape[0], RAFT_FULL_BATCH
    marks = {}

    def batches(i):
        torch.cuda.synchronize()
        marks[i] = time.perf_counter()
        idx = torch.arange(i * B, (i + 1) * B, device=dev) % n
        return {"image1": x1[idx], "image2": x2[idx]}

    release()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # the full-width self-supervised path's run
    log = raft.finetune_raft_selfsup(net, batches, steps=1 + RAFT_FULL_STEPS)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - marks[1]) / RAFT_FULL_STEPS
    launches = check_launches("(o2) full-width RAFT self-supervised",
                              dict.fromkeys(CLI_KERNELS, 0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(log["loss"])
    finite = all(bool(torch.isfinite(p).all()) for p in net.parameters())
    moved = sum(not torch.equal(p.detach(), before[k]) for k, p in net.named_parameters())
    n_params = sum(p.numel() for p in net.parameters())
    print(f"(o2) RAFT self-supervised, full width (RAFTConfig(), {n_params / 1e6:.2f}M "
          f"params), B = {B} pairs at {x1.shape[-1]} px, lag {lag}: "
          f"{RAFT_FULL_STEPS} steps after one, {step_ms:.2f} ms a step, peak "
          f"{peak:.2f} GiB allocated, last loss {loss:.4f}, {moved} of {len(before)} "
          f"parameter tensors moved on {smi}")
    if not np.isfinite(loss) or not finite or moved != len(before) \
            or not torch.isfinite(log["final"]).all():
        raise AssertionError(f"(o2) full-width RAFT: loss {loss}, params finite {finite}, "
                             f"{moved} of {len(before)} moved")
    del net, x1, x2, before
    release()
    return launches, {"full_selfsup_ms": step_ms, "full_peak_gib": peak}


def expected_ui_launches(cfg, passes):
    """Per ``passes`` sampling passes of the UI (a ``/poke`` is one; a first
    ``/save`` of a frame runs one a ground-truth poke): in fp32, K2 in every
    unit of the cINN inverse and K3 once a decode level, no K1 (bf16 only),
    K4 (no grad) or K5 (8x8 latents), as in ``expected_test_launches``."""
    want = dict.fromkeys(CLI_KERNELS, 0)
    want["macow_unit_inverse"] = passes * 4 * sum(cfg["architecture"]["num_steps"])
    want["spade_gn"] = passes * _decode_levels(cfg)
    return want


def poke_kernel_check(experiment, tag):
    """K2 and K3 at the shapes a poke gives them: ``launch_check`` of one
    poke of a session of its own."""
    from ipoke_tpu_torch.ui import server

    return launch_check(
        tag, lambda: server.PokeSession(experiment, 256).poke(0.4, 0.6, -0.1, 0.05),
        expected_ui_launches(experiment.config, 1))


def _checked_kernels():
    """Per kernel that ``launch_check`` can hold: (module, wrapper name,
    plain version, (tol, rel, scaled) by the first argument's dtype, (dims,
    work, peak) of the arguments); ``scaled``: tol times min(1, max |ref|)
    per output."""
    from ipoke_tpu_torch.ops import masked_conv, nice_net, spade_gn

    def unit(args):
        b, s, _, c = args[0].shape
        hid = args[1].shape[-1]
        return {"B": b, "S": s, "C": c, "hid": hid}, unit_work(b, s, c, hid), FP32_FLOPS

    def spade(args):
        n, s, _, ch = args[0].shape
        return ({"N": n, "clips": args[1].shape[0], "S": s, "Ch": ch},
                spade_work(n, args[1].shape[0], s, ch, args[0].element_size()), FP32_FLOPS)

    def flow(args):
        b, hh, ww, c = args[0].shape
        hid = args[1].shape[-1]
        return ({"B": b, "H": hh, "W": ww, "C": c, "hid": hid},
                k5_work(b, hh, ww, c, hid), FP32_FLOPS)

    def nice(train):
        def dims(args):
            (m, k1), hid, (hs, n) = args[0].shape, args[1].shape[1], args[3].shape
            shard = {} if hs == hid else {"Hs": hs}
            return ({"M": m, "K1": k1, "Hid": hid, **shard, "N": n},
                    nice_work(m, k1, hid, n, train, hs), BF16_FLOPS)
        return dims

    return {
        "macow_unit_inverse": (masked_conv, "macow_unit_inverse_cuda",
                               masked_conv.macow_unit_inverse_plain,
                               lambda dt: (K2_TOL, 0.0, False), unit),
        "masked_conv_inverse": (masked_conv, "masked_conv_inverse_cuda",
                                masked_conv.masked_conv_inverse_plain,
                                lambda dt: (K5_TOL, 0.0, False), flow),
        "spade_gn": (spade_gn, "spade_gn_cuda", spade_gn.spade_gn_plain,
                     lambda dt: (K3_TOL[dt], K3_TOL[dt], False), spade),
        "nice_net": (nice_net, "nice_net_cuda", nice_net.nice_net_plain,
                     lambda dt: (K1_TOL, K1_TOL, True), nice(False)),
        "nice_net_train": (nice_net, "nice_net_train_cuda", nice_net.nice_net_train_plain,
                           lambda dt: (K1_TOL, K1_TOL, True), nice(True)),
    }


def launch_check(tag, run, want, names=("macow_unit_inverse", "spade_gn"), timed=True):
    """The kernels ``names`` (K2 and K3 by default; K1 ``nice_net``, K4
    ``nice_net_train`` and K5 ``masked_conv_inverse`` too) at the shapes
    ``run()`` gives them: ``run`` once
    with every launch's inputs and output kept, its launches counted against
    ``want``, then each kept output held against the plain version on the
    same inputs (K2 and K5 at K2_TOL / K5_TOL, K3 at K3_TOL of its dtype abs + rel, K1 and
    K4 (u, a and b) at K1_TOL abs + rel with the abs part times min(1,
    max |ref|) of each output; the smallest max |ref| of the u outputs,
    what a zeroed output would read, is printed), and (``timed``) each distinct
    shape timed, kernel and plain, with its bound (those launches are left
    out of ``ops.LAUNCHES``).  Returns the rows by kernel."""
    from ipoke_tpu_torch import ops

    table = _checked_kernels()
    launch = {name: getattr(table[name][0], table[name][1]) for name in names}
    kept = {name: [] for name in names}
    clone = lambda t: t.clone() if torch.is_tensor(t) else t

    def keeping(name):
        def call(*args):
            out = launch[name](*args)
            kept[name].append(([clone(a) for a in args],
                               tuple(map(clone, out)) if isinstance(out, tuple)
                               else clone(out)))
            return out
        return call

    for name in names:
        setattr(table[name][0], table[name][1], keeping(name))
    try:
        run()
    finally:
        for name in names:
            setattr(table[name][0], table[name][1], launch[name])
    rows = {}
    for name in names:
        _, _, plain, tols, describe = table[name]
        if len(kept[name]) != want[name]:
            raise AssertionError(f"{tag} {name}: {len(kept[name])} launches kept, "
                                 f"{want[name]} expected")
        by_shape = {}
        for i, (args, out) in enumerate(kept[name]):
            tol, rel, scaled = tols(args[0].dtype)
            ref = plain(*args)
            outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
            shape = tuple(tuple(a.shape) for a in args if torch.is_tensor(a))
            peaks = [r.float().abs().max().item() for r in refs]
            err = max(check_close(f"{tag} {name} launch {i} {shape[0]}", o, r,
                                  tol * min(1.0, m) if scaled else tol, rel)
                      for o, r, m in zip(outs, refs, peaks))
            row = by_shape.setdefault(shape, {"launches_a_pass": 0, "max_abs_err": 0.0,
                                              "args": args, "tol": tol, "rel": rel,
                                              "ref_max": math.inf, "scaled": scaled})
            row["launches_a_pass"] += 1
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ref_max"] = min(row["ref_max"], peaks[0])
        del kept[name]
        rows[name] = []
        held = dict(ops.LAUNCHES)  # the timing's launches are not the run's
        for shape, row in by_shape.items():
            args = row.pop("args")
            ref_max, scaled = row.pop("ref_max"), row.pop("scaled")
            if scaled:
                row["ref_max"] = ref_max
            dims, work, peak = describe(args)
            bound_ms, bound_by = bound(*work, peak)
            out = {**dims, **row, "bound_ms": bound_ms, "bound_by": bound_by,
                   "library_ms": None}
            times = ""
            if timed:
                out["ms"] = cuda_ms(lambda: launch[name](*args), 20)
                out["plain_ms"] = cuda_ms(lambda: plain(*args), 3)
                times = f", kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms"
            rows[name].append(out)
            if timed:
                print(f"{tag} {name} at the shape {dims} ({row['launches_a_pass']} launches "
                      f"a pass): every launch against its plain version on its inputs, "
                      f"max_abs_err {row['max_abs_err']:.3e} ({_tol_text([row])}){times}, "
                      f"bound {1e3 * bound_ms:.2f} us ({bound_by})")
        ops.LAUNCHES.update(held)
        if not timed and rows[name]:
            r = rows[name]
            print(f"{tag} {name}: {sum(x['launches_a_pass'] for x in r)} launches at "
                  f"{len(r)} shapes, each against its plain version on its inputs, "
                  f"max_abs_err {max(x['max_abs_err'] for x in r):.3e} ({_tol_text(r)})")
    return rows


def _tol_text(rows):
    """``launch_check``'s limit for ``rows`` of one kernel, with (K1, K4)
    the smallest max |ref| of u: what a zeroed output would read."""
    tol, rel = rows[0]["tol"], rows[0]["rel"]
    if "ref_max" in rows[0]:
        return (f"tol {tol:g} x min(1, max |ref|) abs + {rel:g} rel; u's max |ref| "
                f">= {min(x['ref_max'] for x in rows):.3e}, a zeroed output's error")
    return f"tol {tol:g}{' abs+rel' if rel else ''}"


def drive_ui(experiment, smi, tag, n_pokes, save=True, profile_poke=False):
    """Serve ``experiment`` on a free port and drive ``GET /``, ``/frame``,
    ``n_pokes`` ``POST /poke`` and (``save``) one ``POST /save`` over HTTP,
    each with the launch counts zeroed before and read after, then
    ``poke_kernel_check``; returns (launches by path, ms per poke, K2 and
    K3 rows at the poke's shapes)."""
    import base64
    import os
    import urllib.request

    import cv2
    import numpy as np

    from ipoke_tpu_torch import ops
    from ipoke_tpu_torch.ui import server

    cfg = experiment.config
    T = cfg["data"]["max_frames"]
    httpd = server.serve(experiment, port=0, display_size=256, background=True)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=600).read())

    def png(b64):
        return cv2.imdecode(np.frombuffer(base64.b64decode(b64), np.uint8), cv2.IMREAD_COLOR)

    paths, poke_ms = {}, []
    try:
        page = urllib.request.urlopen(url + "/", timeout=60).read().decode()
        frame = json.loads(urllib.request.urlopen(url + "/frame", timeout=600).read())
        if "drag on the image to poke" not in page or png(frame["frame"]).shape != (256, 256, 3):
            raise AssertionError(f"{tag}: GET / or /frame")
        total = dict.fromkeys(CLI_KERNELS, 0)
        for i in range(n_pokes):
            torch.cuda.synchronize()
            ops.reset_launches()  # this /poke
            t0 = time.perf_counter()
            out = post("/poke", {"x": 0.3 + 0.2 * i, "y": 0.5, "dx": 0.1, "dy": -0.05 * i})
            poke_ms.append(1e3 * (time.perf_counter() - t0))
            got = check_launches(f"{tag} /poke {i + 1}", expected_ui_launches(cfg, 1))
            total = {k: total[k] + got[k] for k in total}
            frames = [png(f) for f in out["frames"]]
            if len(frames) != T or any(f is None or f.shape != (256, 256, 3) for f in frames):
                raise AssertionError(f"{tag} /poke: {len(frames)} frames")
        paths["ui_poke"] = total
        if save:
            n_gt = 3
            ops.reset_launches()  # the /save with its ground-truth pokes
            t0 = time.perf_counter()
            files = post("/save", {})["files"]
            save_s = time.perf_counter() - t0
            paths["ui_save"] = check_launches(f"{tag} /save", expected_ui_launches(cfg, n_gt))
            names = {os.path.basename(f) for f in files}
            want = {"vid_0.mp4", "gt_vid.mp4", *(f"gt_poke_vid_{i}.mp4" for i in range(n_gt))}
            if not want <= names or not all(os.path.getsize(f) > 0 for f in files):
                raise AssertionError(f"{tag} /save: {sorted(names)}")
            print(f"{tag} /save: {len(files)} files ({n_gt} ground-truth pokes sampled) in "
                  f"{save_s:.2f} s")
        shape_rows = poke_kernel_check(experiment, tag)
        if profile_poke:  # a session of its own, outside the HTTP round trip
            session = server.PokeSession(experiment, 256)
            profiled(f"{tag} one poke (its sampling pass and {T} PNGs)",
                     lambda: session.poke(0.5, 0.5, 0.1, 0.1))
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(f"{tag} {n_pokes} /poke at B = 1, T = {T}, "
          f"{cfg['data']['spatial_size'][0]} px: "
          f"{', '.join(f'{t:.1f}' for t in poke_ms)} ms (HTTP round trip, {T} PNGs) on {smi}")
    return paths, poke_ms, shape_rows


def ui_experiment(cfg, root, processed, dev):
    """A second-stage experiment of the config tree ``cfg`` on ``processed``,
    built (its weights drawn from the seed, fp32), couplings perturbed."""
    import os

    import yaml

    from ipoke_tpu_torch import entry
    from ipoke_tpu_torch.cli.experiments import SecondStageExperiment
    from ipoke_tpu_torch.core.checkpoint import create_dir_structure
    from ipoke_tpu_torch.core.config import load_config

    path = os.path.join(root, "second_stage_ui.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    dirs = create_dir_structure(os.path.join(root, "logs"), "second_stage", "ui")
    e = SecondStageExperiment(load_config(path), dirs, data_root=processed, device=dev)
    e.build()
    entry.perturb(e.model.flow_params, torch.Generator(device=dev).manual_seed(0))
    return e


def phase_ui(dev, smi, root, processed):
    """(o3) config/second_stage.yaml's experiment at its width and depth
    (the 1054.43M-param cINN drawn from the seed, couplings perturbed, fp32;
    its frozen nets from the shipped first-stage and encoder YAMLs, drawn)
    on (o1)'s tree, served: ``/poke`` and ``/save`` against
    ``expected_ui_launches``."""
    import os

    from ipoke_tpu_torch import entry
    from ipoke_tpu_torch.core.config import load_config
    from ipoke_tpu_torch.flows import count_params

    release()
    cfg = load_config(os.path.join("config", "second_stage.yaml")).to_dict()
    cfg.update({k: dict(v) for k, v in entry.SHIPPED_FROZEN.items()})
    t0 = time.perf_counter()
    e = ui_experiment(cfg, root, processed, dev)
    n = count_params(e.model.flow_params.tree())
    dtypes = {p.dtype for p in e.model.parameters()}
    print(f"(o3) config/second_stage.yaml built in {time.perf_counter() - t0:.1f} s: flow "
          f"params {n / 1e6:.2f}M, {dtypes}")
    if round(n / 1e6, 2) != 1054.43 or dtypes != {torch.float32}:
        raise AssertionError(f"(o3) flow params {n}, {dtypes}")
    paths, poke_ms, shape_rows = drive_ui(e, smi, "(o3) UI", UI_POKES, profile_poke=True)
    e.metrics_logger.close()
    del e
    release()
    return paths, {"poke_ms": poke_ms, "kernel_shapes": shape_rows}


def phase_ui_restore(dev, smi, tree):
    """(l') the UI's ``main`` route (``ui.server.load_experiment``) on phase
    (k)'s second-stage run: TF32 turned on before and off after, the flow
    params equal to the best checkpoint's weights (bf16, upcast), then one
    ``/poke`` over HTTP against ``expected_ui_launches``."""
    from ipoke_tpu_torch.ui import server

    release()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.perf_counter()
    e = server.load_experiment(server.parse_args(
        ["--config", tree["second_stage"], "--model_name", "smoke", "--data_root",
         tree["data_root"]]))
    secs = time.perf_counter() - t0
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("(l') ui.server.load_experiment left TF32 on")
    saved = e.store.restore_best(weights=True, map_location=dev)
    got = e.model.flow_params.state_dict()
    same = set(got) == set(saved) and all(
        (got[k].dtype == torch.float32 or not v.is_floating_point())
        and torch.equal(got[k], v.to(got[k].dtype)) for k, v in saved.items())
    print(f"(l') the UI's main route restored (k)'s second stage in {secs:.2f} s: "
          f"{len(saved)} flow leaves equal to the best checkpoint's weights "
          f"(fp32 from bf16): {same}")
    if not same:
        raise AssertionError("(l') restored params differ from the checkpoint's")
    paths, poke_ms, shape_rows = drive_ui(e, smi, "(l') UI restored", 1, save=False)
    e.metrics_logger.close()
    del e
    release()
    return {"ui_restored_poke": paths["ui_poke"]}, {"poke_ms": poke_ms,
                                                    "kernel_shapes": shape_rows}


# (p) the reproduction recipes of config/pretrained_models/: fp32,
# Adafactor.  (p1) plants_64.yaml at its width and depth (1054.43M params,
# B = 40, 64 px), frozen nets from the shipped YAMLs drawn from the seed.
# (p2) SMALL, fp32, 3 steps card against CPU under Adafactor and AdaBelief
# from the same weights: losses within SMALL_TRAIN_TOL relative (f's rule);
# each state tensor (Adafactor's rows, columns and full second moments,
# AdaBelief's mu and nu) within RULE_STATE_TOL of its CPU norm.  Both sides
# are fp32 summing in other orders (cuDNN vs oneDNN); the rule was fixed by
# the same run on the CPU in fp32 against float64 (RULE_STATE_TOL's note).
# (p3) plants_64.yaml through main.run at (k)'s depth cut, its frozen nets
# (k)'s runs named through a registry file.
RECIPE = "plants_64"
RECIPE_STEPS = 3
# fp32 against float64 on the CPU over (p2)'s 3 steps (this script's
# phase_recipe_small with the card's side in float64 on the CPU): every
# state tensor within 2.3e-4 of its norm (AdaBelief's; Adafactor's 1.7e-4),
# the losses within 2.0e-5 relative; the card's fp32 against the CPU's fp32
# within ten times that
RULE_STATE_TOL = 2e-3
# (q1) first-stage TINY under mixed_prec, card against CPU, both bf16 over
# fp32 params, 3 steps each from the CPU's state; the rule is the CPU
# test's (tests/test_torch_first_stage_bf16.py), fixed against float64 in
# the same run (values read on NVIDIA H100 80GB HBM3 machines at 700 W,
# over three runs of the phase).  Metrics: |card - CPU| <= FS_BF16_TOL (1
# + |CPU|), read at most 3.7e-3; the generator's adversarial terms
# (FS_BF16_ADV) read the discriminators after their own update, whose sign
# bf16 gradients flip in 9-30% of the entries, and the CPU's bf16 value
# itself moves from machine to machine (loss_g_t at step 0: -0.254 and
# -0.457, the card -0.664, float64 -0.510): within FS_BF16_ADV_TOL (1 +
# |CPU|), read at most 0.33.  Leaf by leaf, Adam's first moments ||card -
# CPU|| <= FS_BF16_RATIO (||CPU - float64|| + 1e-3 ||float64||): the
# median ratio within FS_BF16_RATIO_MEDIAN, read at most 0.90 over nine
# steps, holds the backward (a wrong dtype or layer parts the card from the
# CPU in most leaves); the largest, read up to 6.82 (a leaf whose CPU bf16
# happens to lie near float64), guards against one leaf's gradient gone.
# Every param within FS_BF16_PARAM_LR lr: Adam at betas (0.5, 0.9) steps an
# entry by at most 1.16 lr over its first 4 steps (a numpy sweep of 200k
# gradient sequences), so two sides stepping opposite ways part it by 2.32
# lr.  The share of params past lr / 10 is printed, not held (card vs CPU
# 9-30%).
FS_BF16_TOL, FS_BF16_ADV_TOL = 1e-2, 1.0
FS_BF16_ADV = ("loss_g_s", "loss_g_t", "loss_fmap_t", "loss")
FS_BF16_RATIO, FS_BF16_RATIO_MEDIAN, FS_BF16_PARAM_LR = 30.0, 1.5, 2.5


def phase_recipe(dev, smi):
    """(p1) plants_64.yaml's second stage at its width and depth through
    ``SecondStageTrainer``, no save: DDI, one checked step (no kernel: fp32
    runs no K1 or K4), 3 timed steps, peak memory, the Adafactor state's
    bytes beside AMSGrad's; then one full-depth ``forward_sample`` with every
    K2 and K3 launch held against its plain version."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.core.optim import Adafactor, state_bytes
    from ipoke_tpu_torch.flows import count_params
    from ipoke_tpu_torch.train import SecondStageTrainer, run_lr_schedule

    release()
    cfg = entry.recipe_config(RECIPE)
    d = cfg["data"]
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    model = entry.build_recipe(cfg, dev, gen)
    batch = entry.make_batch({"batch_size": d["batch_size"], "T": d["max_frames"],
                              "spatial": d["spatial_size"][0]}, dev)
    n = count_params(model.flow_params.tree())
    trainer = SecondStageTrainer(model, run_lr_schedule(cfg["training"]))
    trainer.ddi(batch, gen)
    entry.perturb(model.flow_params, gen)
    trainer.start()
    torch.cuda.synchronize()
    if round(n / 1e6, 2) != 1054.43 or not isinstance(trainer.tx, Adafactor) \
            or trainer.mixed:
        raise AssertionError(f"(p1) {RECIPE}: {n} params, {type(trainer.tx).__name__}, "
                             f"mixed {trainer.mixed}")
    print(f"(p1) {RECIPE} built (frozen nets from the shipped YAMLs, drawn), fp32 DDI "
          f"and Adafactor in {time.perf_counter() - t0:.1f} s: flow params {n / 1e6:.2f}M")
    ops.reset_launches()  # the recipe's train path
    losses = [trainer.train_step(batch, gen)["flow_loss"]]
    torch.cuda.synchronize()
    launches = {"recipe_train": check_launches(f"(p1) {RECIPE} train step",
                                               dict.fromkeys(CLI_KERNELS, 0))}
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(RECIPE_STEPS):
        start.record()
        losses.append(trainer.train_step(batch, gen)["flow_loss"])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    losses = [l.item() for l in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"(p1) {RECIPE} losses {losses}")
    ms, peak = sum(times) / len(times), torch.cuda.max_memory_allocated() / 2 ** 30
    state = state_bytes(trainer.tx)
    amsgrad = 3 * 4 * sum(p.numel() for p in trainer.tx.params)  # three fp32 moments
    factored = sum(v is not None for v in trainer.tx.v_row)
    print(f"(p1) {RECIPE} train fp32 Adafactor B={d['batch_size']} T={d['max_frames']} "
          f"{d['spatial_size'][0]}px: {ms:.1f} ms/step ({', '.join(f'{t:.1f}' for t in times)}), "
          f"{d['batch_size'] / (ms / 1e3):.2f} clips/s, peak memory {peak:.2f} GiB on {smi}; "
          f"optimizer state {state / 1e9:.3f} GB ({factored} of {len(trainer.tx.params)} "
          f"leaves factored) against AMSGrad's {amsgrad / 1e9:.3f} GB for the same "
          f"params; losses {losses}")
    out = {"ms_per_step": ms, "steps_ms": times, "peak_gib": peak, "state_bytes": state,
           "amsgrad_state_bytes": amsgrad, "factored_leaves": factored}
    del trainer
    release()
    model.eval()
    T = d["max_frames"]
    want = expected_ui_launches(cfg, 1)
    ops.reset_launches()  # the recipe's sampling path
    with torch.no_grad():
        video = model.forward_sample(batch, T, gen)
    torch.cuda.synchronize()
    launches["recipe_sample"] = check_launches(f"(p1) {RECIPE} forward_sample", want)
    if tuple(video.shape) != (d["batch_size"], T, *d["spatial_size"], 3) \
            or not bool(torch.isfinite(video).all()):
        raise AssertionError(f"(p1) {RECIPE} video {tuple(video.shape)}")
    start.record()
    with torch.no_grad():
        model.forward_sample(batch, T, gen)
    end.record()
    torch.cuda.synchronize()
    out["sample_ms"] = start.elapsed_time(end)
    with torch.no_grad():
        rows = launch_check(f"(p1) {RECIPE} forward_sample",
                            lambda: model.forward_sample(batch, T, gen), want)
    print(f"(p1) {RECIPE} forward_sample fp32 B={d['batch_size']}: {out['sample_ms']:.1f} ms, "
          f"video {tuple(video.shape)} finite on {smi}")
    del model, video
    release()
    return launches, out, rows


def phase_recipe_small(dev, card_device=None, card_dtype=torch.float32):
    """(p2) SMALL, fp32, 3 train steps card against CPU under Adafactor and
    AdaBelief from the same post-DDI weights: no kernel launches (fp32),
    losses by (f)'s rule, the optimizer states within RULE_STATE_TOL.
    ``card_device``/``card_dtype`` run the card's side elsewhere (the CPU
    in float64 fixed RULE_STATE_TOL)."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.train import SecondStageTrainer

    card_device = card_device or dev
    cfg = entry.SMALL
    gen = torch.Generator().manual_seed(0)
    model = entry.build(cfg, "cpu", gen)
    model.config["training"]["mixed_prec_master"] = False
    batch = entry.make_batch(cfg, "cpu", seed=0)
    SecondStageTrainer(model, SMALL_TRAIN_LR).ddi(batch)
    entry.perturb(model.flow_params, gen, SMALL_PERTURB, SMALL_PERTURB)
    worst = {}
    for rule in ("use_adafactor", "use_adabelief"):
        losses, txs = {}, {}
        for name, m, d, dt in (("card", copy.deepcopy(model), card_device, card_dtype),
                               ("cpu", copy.deepcopy(model), "cpu", torch.float32)):
            m = m.to(d, dt)
            m.config["training"][rule] = True
            trainer = SecondStageTrainer(m, SMALL_TRAIN_LR)
            trainer.start()
            b = {k: v.to(d, dt) for k, v in batch.items()}
            losses[name] = []
            for step in range(3):
                ops.reset_launches()
                losses[name].append(trainer.train_step(b)["flow_loss"].item())
                if name == "card" and torch.device(d).type == "cuda":
                    torch.cuda.synchronize()
                    check_launches(f"(p2) SMALL {rule} step {step}",
                                   dict.fromkeys(CLI_KERNELS, 0))
            txs[name] = trainer.tx
        rel = [abs(a - c) / abs(c) for a, c in zip(losses["card"], losses["cpu"])]
        a, c = txs["card"].state_dict(), txs["cpu"].state_dict()
        ratios = []
        for key in c:
            if key == "count":
                continue
            for x, y in zip(a[key], c[key]):
                if y is not None:
                    ratios.append(float((x.cpu().double() - y.double()).norm()
                                        / (y.double().norm() + 1e-30)))
        worst[rule] = {"loss_rel": max(rel), "state_rel": max(ratios)}
        print(f"(p2) SMALL fp32 {rule[4:]}, 3 steps at lr {SMALL_TRAIN_LR}: card losses "
              f"{losses['card']}, CPU {losses['cpu']} (rel diff "
              f"{', '.join(f'{r:.2e}' for r in rel)}, tol {SMALL_TRAIN_TOL}); state "
              f"tensors' worst |card - CPU| / |CPU| {max(ratios):.2e} over {len(ratios)} "
              f"(tol {RULE_STATE_TOL})")
        if not all(map(math.isfinite, losses["card"])) or max(rel) > SMALL_TRAIN_TOL \
                or max(ratios) > RULE_STATE_TOL or not a["count"] == c["count"] == 3:
            raise AssertionError(f"(p2) SMALL {rule}: card disagrees with the CPU")
    return worst


def _moment_ratios(card, cpu, exact):
    """Per leaf ||card - CPU|| / (||CPU - float64|| + 1e-3 ||float64||) of
    Adam's first moments, over the three nets; returns the ratios."""
    ratios = []
    for ta, tb, tc in zip((card.tx_g, card.tx_ds, card.tx_dt),
                          (cpu.tx_g, cpu.tx_ds, cpu.tx_dt),
                          (exact.tx_g, exact.tx_ds, exact.tx_dt)):
        for p, q, r in zip(ta.params, tb.params, tc.params):
            a = ta.adam.state[p]["exp_avg"].cpu().double()
            b = tb.adam.state[q]["exp_avg"].double()
            c = tc.adam.state[r]["exp_avg"]
            ratios.append(float((a - b).norm() / ((b - c).norm() + 1e-3 * c.norm() + 1e-30)))
    return ratios


def phase_first_stage_tiny_bf16(dev):
    """(q1) TINY under mixed_prec, 3 steps card against CPU (both bf16 over
    fp32 params) and against the CPU port in float64, each step from the
    CPU's state, by the FS_BF16 rule; K3 in bf16 under autograd, 18 a
    step."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.models.first_stage import sample_draws
    from ipoke_tpu_torch.nn.blocks import set_compute_dtype

    cfg = entry.FIRST_STAGE_TINY_BF16
    nets = entry.build_first_stage(cfg, "cpu", torch.Generator().manual_seed(0))
    batch = entry.make_first_stage_batch(cfg, "cpu")
    draw_gen = torch.Generator().manual_seed(1)
    draws = [sample_draws(draw_gen, cfg, cfg["data"]["batch_size"]) for _ in range(3)]
    to = lambda d, dv, dt=None: {k: v.to(dv, dt) if torch.is_tensor(v) and v.is_floating_point()
                                 else v.to(dv) if torch.is_tensor(v) else v
                                 for k, v in d.items()}
    card = _first_stage_step(cfg, [copy.deepcopy(n).to(dev) for n in nets])
    cpu = _first_stage_step(cfg, nets)
    exact = _first_stage_step(cfg, [set_compute_dtype(copy.deepcopy(n), None).double()
                                    for n in nets])
    want = expected_first_stage_launches(cfg)
    rows = []
    for i, d in enumerate(draws):
        ops.reset_launches()
        got = card(to(batch, dev), to(d, dev), 1.0)
        torch.cuda.synchronize()
        check_launches(f"(q1) first-stage TINY bf16 step {i}", want)
        ref = cpu(batch, d, 1.0)
        ex = exact(to(batch, "cpu", torch.float64), to(d, "cpu", torch.float64), 1.0)
        if got["loss"].dtype != torch.float32 or got["loss_g_s"].dtype != torch.bfloat16:
            raise AssertionError("(q1) the step's losses are not in JAX's dtypes")
        diffs, bad = {}, []
        for k in ref:
            a, b = got[k].item(), ref[k].item()
            tol = FS_BF16_ADV_TOL if k in FS_BF16_ADV else FS_BF16_TOL
            diffs[k] = abs(a - b) / (tol * (1 + abs(b)))
            if not math.isfinite(a) or diffs[k] > 1:
                bad.append(k)
        print(f"(q1) first-stage TINY bf16 step {i} metrics card / CPU / CPU float64: " + ", ".join(
            f"{k} {got[k].item():.5g} / {ref[k].item():.5g} / {ex[k].item():.5g}" for k in ref)
            + "; |card - CPU| over its limit: " + ", ".join(f"{k} {v:.2f}" for k, v in diffs.items()))
        worst, off, total = 0.0, 0, 0
        for ta, tb in zip((card.tx_g, card.tx_ds, card.tx_dt), (cpu.tx_g, cpu.tx_ds, cpu.tx_dt)):
            for p, q in zip(ta.params, tb.params):
                d = (p.detach().cpu() - q.detach()).abs()
                worst = max(worst, float(d.max()) / FS_TINY_LR)
                off, total = off + int((d > 0.1 * FS_TINY_LR).sum()), total + d.numel()
                if p.dtype != torch.float32:
                    bad.append("param dtype")
        ratios = _moment_ratios(card, cpu, exact)
        med = sorted(ratios)[len(ratios) // 2]
        print(f"(q1) first-stage TINY bf16 step {i}: params' largest |card - CPU| {worst:.3f} lr "
              f"(limit {FS_BF16_PARAM_LR}), {100 * off / total:.2f}% of them past lr / 10; "
              f"first moments leaf by leaf ||card - CPU|| / (||CPU - float64|| + 1e-3 "
              f"||float64||) median {med:.3f} (limit {FS_BF16_RATIO_MEDIAN}), largest "
              f"{max(ratios):.3f} (limit {FS_BF16_RATIO}) over {len(ratios)} leaves")
        if max(ratios) > FS_BF16_RATIO or med > FS_BF16_RATIO_MEDIAN:
            bad.append("first moments")
        if worst > FS_BF16_PARAM_LR:
            bad.append("params")
        if bad:
            raise AssertionError(f"(q1) step {i}: card apart from the CPU in {bad}")
        rows.append({"metrics_worst": max(diffs.values()), "ratio_median": med,
                     "ratio_max": max(ratios), "param_max_lr": worst,
                     "params_past_lr_10": off / total})
        sync_first_stage(card, cpu)
        sync_first_stage(exact, cpu)
    return rows


def phase_recipe_cli(dev, smi, tree):
    """(p3) ``ipoke_tpu_torch.main`` of plants_64.yaml at (k)'s depth cut,
    its frozen nets (k)'s first_stage, img_encoder and poke_encoder runs,
    named plants_64 through a registry file (``IPOKE_TPU_REGISTRY``): one
    epoch, a restore check (the Adafactor state and params bitwise), then
    --resume for one more; launches against ``expected_cli_launches``."""
    import os

    import yaml

    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.cli.experiments import SecondStageExperiment
    from ipoke_tpu_torch.core.config import load_config
    from ipoke_tpu_torch.core.optim import Adafactor

    release()
    root, data_root, base = tree["root"], tree["data_root"], tree["base"]
    t0 = time.perf_counter()
    run = lambda exp: {"config": os.path.join(base, exp, "config", "smoke", "0.yaml"),
                       "ckpt": os.path.join(base, exp, "ckpt", "smoke", "0")}
    registry = os.path.join(root, "registry.yaml")
    with open(registry, "w") as f:
        yaml.safe_dump({"first_stage_models": {RECIPE: run("first_stage")},
                        "conditioner_models": {RECIPE: run("img_encoder")},
                        "poke_embedder_models": {RECIPE: run("poke_encoder")}}, f)
    cfg = load_config(os.path.join("config", "pretrained_models", f"{RECIPE}.yaml")).to_dict()
    cfg["training"].update(n_epochs=1, max_batches_per_epoch=CLI_BATCHES, max_val_batches=1)
    cfg["architecture"]["num_steps"] = CLI_SECOND_STAGE_STEPS
    path = os.path.join(root, f"{RECIPE}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    old = os.environ.get("IPOKE_TPU_REGISTRY")
    os.environ["IPOKE_TPU_REGISTRY"] = registry
    results, launches = {}, {}
    try:
        e1, results["first"] = drive_cli(dev, smi, data_root, "second_stage", path)
        launches["cli_recipe"] = results["first"]["launches"]
        if not isinstance(e1.tx, Adafactor) or e1.ddi_runs != 1:
            raise AssertionError(f"(p3) {type(e1.tx).__name__}, DDI {e1.ddi_runs}")
        args = cli.parse_args(["--config", path, "--model_name", "smoke",
                               "--data_root", data_root, "--resume"])
        cfg_r, dirs, _ = cli.load_parameters(args)
        e2 = SecondStageExperiment(cfg_r, dirs, data_root=data_root, device="cuda")
        e2.build()
        e2.restore_last()
        saved, got = e1.tx.state_dict(), e2.tx.state_dict()
        checks = {"step": e2.step == e1.step, "count": got["count"] == saved["count"],
                  "Adafactor state bitwise": all(
                      (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b))
                      for key in ("v_row", "v_col", "v")
                      for a, b in zip(got[key], saved[key])),
                  "params fp32, bitwise": all(
                      a.dtype == torch.float32 and torch.equal(a, b)
                      for a, b in zip(e2.model.flow_params.parameters(),
                                      e1.model.flow_params.parameters()))}
        e2.metrics_logger.close()
        print(f"(p3) {RECIPE} restore check (step {e2.step}, count {got['count']}, "
              f"{sum(v is not None for v in got['v_row'])} factored leaves): {checks}")
        if not all(checks.values()):
            raise AssertionError(f"(p3) restore: {checks}")
        step1, count1 = e1.step, e1.tx.count
        del e1, e2
        release()
        e3, results["resume"] = drive_cli(dev, smi, data_root, "second_stage", path,
                                          "--resume")
        launches["cli_recipe_resume"] = results["resume"]["launches"]
        n3 = len(e3.timings["step_s"])
        if (e3.step, e3.tx.count, e3.ddi_runs) != (step1 + n3, count1 + n3, 0):
            raise AssertionError(f"(p3) --resume: step {e3.step}, count {e3.tx.count}, "
                                 f"DDI {e3.ddi_runs}")
        del e3
    finally:
        if old is None:
            os.environ.pop("IPOKE_TPU_REGISTRY", None)
        else:
            os.environ["IPOKE_TPU_REGISTRY"] = old
    release()
    print(f"(p3) {RECIPE} CLI in {time.perf_counter() - t0:.1f} s")
    return launches, results


# (r) the paper's PyTorch checkpoints through ipoke_tpu_torch.reference:
# (r1) SMALL (64 px, B = 8) with architecture.torch_compat, its four
# reference states drawn from REF_SEED, written as Lightning .ckpt files and
# read back through the loader; card against the CPU port, fp32, TF32 off,
# the same z: frames within REF_TOL abs + rel ((j2)'s rule: both sides
# fp32, cuDNN against oneDNN convs, K2 and K3 against their plain
# versions; a wrong layout or kernel moves them by O(1)).  (r2) SHIPPED
# (bench.py's 128 px, B = 40, T = 10, the 1054.43M-param cINN) in fp32 with
# torch_compat, the reference states held in memory (4.2 GB of cINN; (r1)
# ran the file round trip), REF_PASSES timed passes after a warm one
REF_SEED, REF_TOL, REF_PASSES = 0, 1e-3, 3


def expected_reference_launches(cfg):
    """Per fp32 sampling pass: K2 in each of a step's 4 MaCowUnits (the 8x8
    latents fit it), K3 once a decoder level; no K1 (bf16 only) or K5."""
    return {"nice_net": 0, "nice_net_train": 0,
            "macow_unit_inverse": 4 * sum(cfg["num_steps"]),
            "masked_conv_inverse": 0, "spade_gn": len(cfg["dec_ch"]) - 1}


def reference_model(cfg, dev, states=None, seed=REF_SEED):
    """(model, states): ``cfg``'s second stage with ``torch_compat``, built
    on ``meta`` and moved to ``dev`` without weights, then loaded through
    ``reference.load_second_stage`` from ``states`` (drawn from ``seed``
    in the reference's layout without them); fp32, eval."""
    from ipoke_tpu_torch import entry, reference
    from ipoke_tpu_torch.flows import ParamTree

    cfg = dict(cfg, torch_compat=True)
    with torch.device("meta"):
        model = entry.make_model(cfg)
    if states is None:
        states = reference.draw_second_stage(model, seed)
    model = model.to_empty(device=dev)
    model.flow_params = ParamTree(model.init_params(
        torch.Generator(device=dev).manual_seed(seed), dev))
    reference.load_second_stage(model, states["first_stage"], states["conditioner"],
                                states["poke_embedder"], states["flow"])
    return model.eval(), states


def phase_reference_small(dev):
    """(r1) SMALL with torch_compat from seeded reference .ckpt files, card
    against CPU, fp32."""
    import tempfile

    from ipoke_tpu_torch import entry, ops, reference

    cfg = entry.SMALL
    with tempfile.TemporaryDirectory() as d:
        drawn = reference_model(cfg, "cpu")[1]
        for name, state in drawn.items():
            reference.save_ckpt(state, os.path.join(d, f"{name}.ckpt"))
        states = {name: reference.read_state(os.path.join(d, f"{name}.ckpt"))
                  for name in drawn}
    cpu = reference_model(cfg, "cpu", states)[0]
    card = reference_model(cfg, dev, states)[0]
    batch = entry.make_batch(cfg, "cpu", seed=1)
    s = cfg["min_spatial"]
    z = torch.randn((cfg["batch_size"], s, s, cfg["z_dim"]),
                    generator=torch.Generator().manual_seed(2))
    ops.reset_launches()
    got = card.forward_sample({k: v.to(dev) for k, v in batch.items()}, cfg["T"],
                              z=z.to(dev))
    torch.cuda.synchronize()
    launches = check_launches("(r1) SMALL torch_compat fp32 pass",
                              expected_reference_launches(cfg))
    want = cpu.forward_sample(batch, cfg["T"], z=z)
    err = check_close("(r1) SMALL torch_compat frames, card vs CPU", got.cpu(), want,
                      REF_TOL, REF_TOL)
    print(f"(r1) SMALL torch_compat from seeded reference .ckpt files (the loader's "
          f"file route): frames {tuple(got.shape)} card vs CPU max_abs_err {err:.3e} "
          f"(tol {REF_TOL} abs+rel)")
    return launches


def phase_reference(dev, smi, cfg=None):
    """(r2) SHIPPED (or ``cfg``) fp32 with torch_compat from a seeded reference state:
    the pass's launches, REF_PASSES timed passes and peak memory, every K2
    and K3 launch against its plain version, then the same weights with
    torch_compat off, timed in the same way."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.flows import count_params
    from ipoke_tpu_torch.models.first_stage import FirstStageModel

    release()
    cfg = cfg or entry.SHIPPED
    t0 = time.perf_counter()
    model, states = reference_model(cfg, dev)
    del states
    torch.cuda.synchronize()
    n = count_params(model.flow_params.tree())
    print(f"(r2) SHIPPED torch_compat drawn in the reference's layout and loaded in "
          f"{time.perf_counter() - t0:.1f} s: flow params {n / 1e6:.2f}M")
    if cfg is entry.SHIPPED and round(n / 1e6, 2) != 1054.43:
        raise AssertionError(f"(r2) flow params {n} != 1054.43M")
    batch = entry.make_batch(cfg, dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    want = expected_reference_launches(cfg)
    ops.reset_launches()  # the reference path's run
    frames = model.forward_sample(batch, cfg["T"], gen)
    torch.cuda.synchronize()
    launches = check_launches("(r2) SHIPPED torch_compat fp32 pass", want)
    shape = (cfg["batch_size"], cfg["T"], cfg["spatial"], cfg["spatial"], 3)
    if tuple(frames.shape) != shape or not bool(torch.isfinite(frames).all()):
        raise AssertionError(f"(r2) frames {tuple(frames.shape)}: want finite {shape}")
    del frames

    def timed():
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(REF_PASSES):
            t1 = time.perf_counter()
            model.forward_sample(batch, cfg["T"], gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t1))
        return times, torch.cuda.max_memory_allocated() / 2 ** 30

    times, peak = timed()
    ms = sum(times) / len(times)
    print(f"(r2) SHIPPED torch_compat fp32 B={cfg['batch_size']} T={cfg['T']} "
          f"{cfg['spatial']}px: {ms:.1f} ms/pass ({', '.join(f'{t:.1f}' for t in times)}), "
          f"{cfg['batch_size'] / (ms / 1e3):.2f} clips/s, peak memory {peak:.2f} GiB on {smi}")
    # one pass under the profiler: the busy share and K2's and K3's device
    # time in the pass
    _, kernels = profiled("(r2) SHIPPED torch_compat fp32 pass",
                          lambda: model.forward_sample(batch, cfg["T"], gen))
    in_situ = {name: report_in_situ(kernels, "the pass", name, key, want[kernel])
               for name, key, kernel in (
                   ("K2", "macow_unit_inverse_kernel", "macow_unit_inverse"),
                   ("K3", "spade_gn_kernel", "spade_gn"))}
    rows = launch_check("(r2) SHIPPED torch_compat",
                        lambda: model.forward_sample(batch, cfg["T"], gen), want)
    off = FirstStageModel(cfg["spatial"], z_dim=cfg["z_dim"], dec_channels=cfg["dec_ch"],
                          n_gru_layers=2, min_spatial_size=cfg["min_spatial"],
                          enc_channels=cfg["enc_ch"], max_frames=cfg["T"])
    off.load_state_dict(model.first_stage.state_dict())
    on, off = model.first_stage, off.to(dev).eval()
    model.first_stage = off
    model.forward_sample(batch, cfg["T"], gen)
    torch.cuda.synchronize()
    off_times, off_peak = timed()
    model.first_stage = on  # in turns: on, off, on
    times2, _ = timed()
    off_ms, on_ms = sum(off_times) / len(off_times), sum(times + times2) / (2 * REF_PASSES)
    print(f"(r2) the same weights with torch_compat off: {off_ms:.1f} ms/pass "
          f"({', '.join(f'{t:.1f}' for t in off_times)}), peak memory {off_peak:.2f} GiB; "
          f"on again {', '.join(f'{t:.1f}' for t in times2)} ms: on {on_ms:.1f} ms over "
          f"the {2 * REF_PASSES} passes before and after, {on_ms - off_ms:+.1f} ms a pass, "
          f"same call, {smi}")
    del model, on, off
    release()
    return launches, {"ms_per_pass": ms, "passes_ms": times, "peak_gib": peak,
                      "off_ms_per_pass": off_ms, "off_passes_ms": off_times,
                      "on_again_passes_ms": times2, "in_situ_ms": in_situ}, rows


# ---------------------------------------------------------------------------
# (s) the second stage's options
# ---------------------------------------------------------------------------

# The variants of phase (s), keys of an ``entry`` config dict (on SMALL's or
# SHIPPED's widths): A the conditioning options (flow_ae, a poke_and_image
# embedder at 4x the first stage's latent size and a variational
# conditioner at half of it: both conv_adapt adapters), bf16; B the
# non-affine transforms without a conditioner, bf16; C a MultiscaleStack
# with reshape up and use1x1, fp32; C' the same stack without use1x1 in
# bf16 (SMALL only) at SHIPPED's NICE hidden widths, 64 x C (2048 at 8x8x32,
# 512 at 16x16x8), so that K1 runs in both blocks.
OPTION_VARIANTS = {
    "A": dict(flow_ae=True, poke_and_image=True, cond_deterministic=False),
    "B": dict(transform="additive", prior_transform="relu", conditioner=False),
    "C": dict(multistack=True, reshape="up", levels=[[4, 3, 2], [4, 3, 2]],
              factors=[16, 4], use1x1=True, mixed=False),
    "C'": dict(multistack=True, reshape="up", levels=[[4, 3, 2], [4, 3, 2]],
               factors=[16, 4], mid_factor=64),
}
# (s1) SMALL card vs CPU: sampling in bf16 by phase (d)'s rule, in fp32
# within OPTION_FP32_TOL abs + rel (both sides fp32, TF32 off, summing in
# other orders); 2 train steps by phase (f)'s rule
OPTION_FP32_TOL, OPTION_TRAIN_STEPS = 1e-3, 2
# (s3) the CLI second stage's depth over the variant A encoders (phase (k)'s
# widths and step counts; the depth cut further than (k)'s for the disk)
OPTION_CLI_STEPS = [2, 1]


def option_config(base, name):
    """A variant on ``base``'s widths (SMALL or SHIPPED): A's embedders at 2x
    and 1/2 of the first stage's latent size."""
    cfg = dict(base, **OPTION_VARIANTS[name])
    if name == "A":
        cfg.update(poke_min_spatial=2 * base["min_spatial"],
                   cond_min_spatial=base["min_spatial"] // 2)
    return cfg


def flow_blocks(model):
    """[(MultiScaleInternal, latent size)] of a second stage's flow, walked
    from the model's own blocks: a MultiscaleStack's blocks from its
    reshape step on see its output shape."""
    from ipoke_tpu_torch.flows.macow import MultiscaleStack

    s, flow = model.min_spatial_size, model.flow
    if not isinstance(flow, MultiscaleStack):
        return [(flow, s)]
    after, step = flow.output_shape((s, s, model.flow_in_channels))[0], flow._reshape_step
    return [(b, s if step is None or i < step else after)
            for i, b in enumerate(flow._blocks())]


def expected_option_launches(model, cfg, bf16, train=False):
    """Per sampling pass (or, ``train``, per step) of a variant: K1 in
    every NICE coupling of its bf16 family (hidden a multiple of 128, at
    most 512 pixels; steps' and priors' alike, whatever the transform), K2
    in each affine unit that ``unit_fits``, else K5 in each of its 4
    masked-conv flows, K3 once a decode level; a step
    runs K1 in each step's 4 couplings (the remat's no-grad pass) and K4 in
    their recompute and the priors.  A non-affine masked-conv flow takes
    the plain row scan, as in the JAX package."""
    from ipoke_tpu_torch.flows.macow import default_mcf_hidden
    from ipoke_tpu_torch.ops.masked_conv import unit_fits

    want = dict.fromkeys(CLI_KERNELS, 0)
    for block, s in flow_blocks(model):
        steps, c, hid = block.num_steps, block.in_channels, block.hidden_channels
        n, levels = sum(steps), len(steps)
        k1 = bf16 and hid % 128 == 0 and s * s <= 512
        if train:
            want["nice_net"] += 4 * n if k1 else 0
            want["nice_net_train"] += 4 * n + levels if k1 else 0
            continue
        want["nice_net"] += 4 * n + levels if k1 else 0
        for i, k in enumerate(steps):
            ci = c - i * (c // block.factor)
            if block.transform != "affine":
                continue
            if unit_fits((cfg["batch_size"], s, s, ci), default_mcf_hidden(ci), (2, 3)):
                want["macow_unit_inverse"] += 4 * k
            else:
                want["masked_conv_inverse"] += 16 * k
    if not train:
        want["spade_gn"] = len(cfg["dec_ch"]) - 1
    return want


def phase_options_small(dev):
    """(s1) SMALL, each variant card against the CPU port from the same
    perturbed weights: one ``forward_sample`` (the same z) with every K1,
    K2 and K3 launch held against its plain version on its inputs and the
    frames compared; then from the same post-DDI weights 2 train steps
    with every K1 and K4 launch of the first held so, and the losses
    compared.  Returns the launches by path."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.train import SecondStageTrainer

    paths, t_phase = {}, time.perf_counter()
    for name in OPTION_VARIANTS:
        cfg = option_config(entry.SMALL, name)
        bf16 = cfg.get("mixed", True)
        dtype = torch.bfloat16 if bf16 else torch.float32
        gen = torch.Generator().manual_seed(0)
        model = entry.build(cfg, "cpu", gen)
        entry.perturb(model.flow_params, gen, SMALL_PERTURB, SMALL_PERTURB)
        cpu = model.to(dtype)
        card = copy.deepcopy(cpu).to(dev)
        batch = entry.make_batch(cfg, "cpu", dtype, seed=0)
        z = torch.randn((cfg["batch_size"], *cpu.z_shape()), generator=gen).to(dtype)
        tag = f"(s1) SMALL {name}"
        want = expected_option_launches(model, cfg, bf16)
        frames = []
        ops.reset_launches()  # this variant's sampling path
        launch_check(tag, lambda: frames.append(card.forward_sample(
            {k: v.to(dev) for k, v in batch.items()}, cfg["T"], z=z.to(dev))),
            want, ("nice_net", "macow_unit_inverse", "spade_gn"), timed=False)
        torch.cuda.synchronize()
        paths[f"options_small_{name}_sample"] = check_launches(f"{tag} pass", want)
        ref = cpu.forward_sample(batch, cfg["T"], z=z)
        got = frames[0].cpu()
        shape = (cfg["batch_size"], cfg["T"], cfg["spatial"], cfg["spatial"], 3)
        if tuple(got.shape) != shape:
            raise AssertionError(f"{tag}: frames {tuple(got.shape)}, want {shape}")
        diff = (got.float() - ref.float()).abs()
        if bf16:
            print(f"{tag} bf16 card vs CPU: frames max_abs_err {diff.max().item():.3e} "
                  f"mean {diff.mean().item():.3e} (tol max {SMALL_MAX_TOL}, mean "
                  f"{SMALL_MEAN_TOL})")
            if not bool(torch.isfinite(got).all()) or diff.max().item() > SMALL_MAX_TOL \
                    or diff.mean().item() > SMALL_MEAN_TOL:
                raise AssertionError(f"{tag}: card frames disagree with the CPU port")
        else:
            err = check_close(f"{tag} fp32 frames", got, ref, OPTION_FP32_TOL,
                              OPTION_FP32_TOL)
            print(f"{tag} fp32 card vs CPU: frames max_abs_err {err:.3e} (tol "
                  f"{OPTION_FP32_TOL} abs+rel)")
        del card, cpu, frames

        # 2 train steps from the same post-DDI weights (phase (f)'s rule)
        model = entry.build(cfg, "cpu", torch.Generator().manual_seed(0))
        tbatch = entry.make_batch(cfg, "cpu", seed=0)
        SecondStageTrainer(model, SMALL_TRAIN_LR).ddi(tbatch)  # fp32
        entry.perturb(model.flow_params, gen, SMALL_PERTURB, SMALL_PERTURB)
        models = {"card": copy.deepcopy(model).to(dev), "cpu": model}
        want = expected_option_launches(model, cfg, bf16, train=True)
        adapters = {}
        losses = {}
        for side, m in models.items():
            trainer = SecondStageTrainer(m, SMALL_TRAIN_LR)
            trainer.start()
            before = {n: p.detach().clone() for n, p in m.flow_params.named_parameters()
                      if n.startswith("adapt")}
            b = {k: v.to(dev if side == "card" else "cpu") for k, v in tbatch.items()}
            losses[side] = []
            for step in range(OPTION_TRAIN_STEPS):
                ops.reset_launches()
                if side == "card" and step == 0:
                    out = []
                    launch_check(f"{tag} train step", lambda: out.append(
                        trainer.train_step(b)["flow_loss"].item()), want,
                        ("nice_net", "nice_net_train"), timed=False)
                    loss = out[0]
                else:
                    loss = trainer.train_step(b)["flow_loss"].item()
                if side == "card":
                    torch.cuda.synchronize()
                    got = check_launches(f"{tag} train step {step}", want)
                    if step == 0:
                        paths[f"options_small_{name}_train"] = got
                losses[side].append(loss)
            adapters[side] = all(not torch.equal(p.detach(), before[n])
                                 for n, p in m.flow_params.named_parameters() if n in before)
        rel = [abs(a - c) / abs(c) for a, c in zip(losses["card"], losses["cpu"])]
        print(f"{tag} train {'bf16' if bf16 else 'fp32'}, {OPTION_TRAIN_STEPS} steps at lr "
              f"{SMALL_TRAIN_LR}: card {losses['card']}, CPU {losses['cpu']} (rel diff "
              f"{', '.join(f'{r:.2e}' for r in rel)}, tol {SMALL_TRAIN_TOL})"
              + (f"; adapters moved on card and CPU: {adapters}" if name == "A" else ""))
        if not all(map(math.isfinite, losses["card"])) or max(rel) > SMALL_TRAIN_TOL:
            raise AssertionError(f"{tag} train: card losses disagree with the CPU port")
        if name == "A" and not all(adapters.values()):
            raise AssertionError(f"{tag} train: an adapter did not move ({adapters})")
        del models, model
    print(f"(s1) in {time.perf_counter() - t_phase:.1f} s")
    return paths


def phase_options_shipped(dev, smi):
    """(s2) variants A, B and C at the shipped widths (128 px, B = 40, T =
    10, the cINN's 1054.43M-param widths; weights drawn on the card,
    couplings perturbed): per variant one pass with the launch counts zeroed
    before and read after and every K1, K2 and K3 launch held against its
    plain version on its inputs (A's distinct shapes also timed), then 3
    timed passes (host clock, each closed by a synchronize) and the peak
    memory; A's busy share from a ``torch.profiler`` table of one pass.
    Returns (launches by path, results, A's kernel rows)."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.flows import count_params

    release()
    paths, results, rows = {}, {}, {}
    for name in ("A", "B", "C"):
        cfg = option_config(entry.SHIPPED, name)
        bf16 = cfg.get("mixed", True)
        dtype = torch.bfloat16 if bf16 else torch.float32
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        model = entry.build(cfg, dev, gen)
        entry.perturb(model.flow_params, gen)
        model = model.to(dtype)
        batch = entry.make_batch(cfg, dev, dtype, seed=0)
        torch.cuda.synchronize()
        tag = f"(s2) SHIPPED {name}"
        n_params = count_params(model.flow_params.tree())
        print(f"{tag} built in {time.perf_counter() - t0:.1f} s: second-stage params "
              f"{n_params / 1e6:.2f}M, {'bf16' if bf16 else 'fp32'}")
        want = expected_option_launches(model, cfg, bf16)
        torch.cuda.reset_peak_memory_stats()
        frames = []
        ops.reset_launches()  # this variant's main path run
        r = launch_check(tag, lambda: frames.append(
            model.forward_sample(batch, cfg["T"], gen)), want,
            [k for k in ("nice_net", "macow_unit_inverse", "spade_gn") if want[k]],
            timed=name == "A")
        torch.cuda.synchronize()
        paths[f"options_shipped_{name}"] = check_launches(f"{tag} pass", want)
        shape = (cfg["batch_size"], cfg["T"], cfg["spatial"], cfg["spatial"], 3)
        if tuple(frames[0].shape) != shape or not bool(torch.isfinite(frames[0]).all()):
            raise AssertionError(f"{tag}: frames {tuple(frames[0].shape)}, want finite "
                                 f"{shape}")
        del frames
        if name == "A":
            rows = r
        times = []
        for _ in range(3):
            t = time.perf_counter()
            model.forward_sample(batch, cfg["T"], gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
        ms = sum(times) / len(times)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        results[name] = {"ms_per_pass": ms, "passes_ms": times, "peak_gib": peak,
                         "params_m": n_params / 1e6,
                         "launches": paths[f"options_shipped_{name}"]}
        print(f"{tag} B={cfg['batch_size']} T={cfg['T']} {cfg['spatial']}px: {ms:.1f} "
              f"ms/pass ({', '.join(f'{t:.1f}' for t in times)}), "
              f"{cfg['batch_size'] / (ms / 1e3):.2f} clips/s, peak {peak:.2f} GiB "
              f"(the checked pass's kept inputs included) on {smi}")
        if name == "A":
            _, kernels = profiled(f"{tag} sampling pass",
                                  lambda: model.forward_sample(batch, cfg["T"], gen))
            results[name]["in_situ_ms"] = {
                k: report_in_situ(kernels, "the pass", k, key, paths["options_shipped_A"][n])
                for k, key, n in (("K1", "nice_net_stage", "nice_net"),
                                  ("K2", "macow_unit_inverse_kernel",
                                   "macow_unit_inverse"),
                                  ("K3", "spade_gn_kernel", "spade_gn"))}
        del model, batch
        release()
    return paths, results, rows


def check_second_stage_restore(e1, path, data_root, model_name, dev):
    """The state a ``--resume`` of the run ``e1`` loads (step, lr count,
    fp32 masters, bf16 params) on ``dev`` against the run's own, bit for
    bit."""
    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.cli.experiments import SecondStageExperiment

    args = cli.parse_args(["--config", path, "--model_name", model_name,
                           "--data_root", data_root, "--resume"])
    cfg_r, dirs, _ = cli.load_parameters(args)
    e2 = SecondStageExperiment(cfg_r, dirs, data_root=data_root, device=dev)
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
    print(f"CLI second_stage ({model_name}) restore check (step {e2.step}, lr count "
          f"{e2.tx.count}): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"CLI second_stage ({model_name}) restore: {checks}")


def phase_options_cli(dev, smi, tree):
    """(s3) ``ipoke_tpu_torch.main`` over variant A's options from the
    shipped YAMLs on (k)'s tree, model name ``options``: img_encoder
    variational at a min spatial size of 4, poke_encoder with
    poke_and_image and flow_ae at 16, then second_stage over them and (k)'s
    first_stage with poke_embedder.flow_ae (both conv_adapt adapters; depth
    OPTION_CLI_STEPS), a restore check and --resume; each run with the
    launch counts zeroed before and read after (``expected_cli_launches``).
    Returns (launches by path, results)."""
    import os
    import shutil

    import yaml

    from ipoke_tpu_torch.core.config import load_config

    release()
    root, data_root, base = tree["root"], tree["data_root"], tree["base"]
    name, t0 = "options", time.perf_counter()

    def run_dir(exp, model):
        return {"config": os.path.join(base, exp, "config", model, "0.yaml"),
                "ckpt": os.path.join(base, exp, "ckpt", model, "0")}

    def config(exp, arch):
        cfg = load_config(os.path.join("config", f"{exp}.yaml")).to_dict()
        cfg["data"]["dataset"] = "PlantDataset"
        cfg["training"].update(n_epochs=1, max_batches_per_epoch=CLI_BATCHES,
                               max_val_batches=1)
        cfg["architecture"].update(arch)
        if exp == "second_stage":
            cfg["first_stage"].update(run_dir("first_stage", "smoke"))
            cfg["conditioner"].update(run_dir("img_encoder", name))
            cfg["poke_embedder"].update(run_dir("poke_encoder", name), flow_ae=True)
        path = os.path.join(root, f"{exp}_{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    drive = lambda exp, path, *extra: drive_cli(dev, smi, data_root, exp, path, *extra,
                                                model_name=name)
    launches, results = {}, {}
    for exp, arch in (("img_encoder", {"deterministic": False, "min_spatial_size": 4}),
                      ("poke_encoder", {"poke_and_image": True, "flow_ae": True,
                                        "min_spatial_size": 16})):
        e, results[exp] = drive(exp, config(exp, arch))
        launches[f"options_cli_{exp}"] = results[exp]["launches"]
        del e
        release()
    path = config("second_stage", {"num_steps": OPTION_CLI_STEPS})
    e1, results["second_stage"] = drive("second_stage", path)
    launches["options_cli_second_stage"] = results["second_stage"]["launches"]
    m = e1.model
    if (m.poke_key, set(m.adapters), e1.ddi_runs) != (
            "flow", {"adapt_poke", "adapt_cond"}, 1):
        raise AssertionError(f"(s3) second_stage: poke key {m.poke_key}, adapters "
                             f"{m.adapters}, DDI runs {e1.ddi_runs}")
    print(f"(s3) second_stage embeds {m.poke_key}, adapters {m.adapters} (latent "
          f"size, channels) to the first stage's {m.min_spatial_size}; variational "
          f"conditioner: {not m.conditioner.deterministic}, poke_and_image embedder: "
          f"{m.poke_embedder.poke_and_image}")
    check_second_stage_restore(e1, path, data_root, name, dev)
    step1, count1 = e1.step, e1.tx.count
    del e1, m
    release()
    e3, results["second_stage_resume"] = drive("second_stage", path, "--resume")
    launches["options_cli_second_stage_resume"] = results["second_stage_resume"]["launches"]
    n3 = len(e3.timings["step_s"])
    if (e3.step, e3.tx.count, e3.ddi_runs) != (step1 + n3, count1 + n3, 0):
        raise AssertionError(
            f"(s3) second_stage --resume: step {e3.step}, lr count {e3.tx.count}, "
            f"DDI runs {e3.ddi_runs}; want {step1 + n3}, {count1 + n3}, 0")
    del e3
    release()
    shutil.rmtree(os.path.join(base, "second_stage", "ckpt", name), ignore_errors=True)
    print(f"(s3) in {time.perf_counter() - t0:.1f} s")
    return launches, results


# ---------------------------------------------------------------------------
# (t) the `reshape: down` stack: K5's wide path
# ---------------------------------------------------------------------------

# Variant D: (s2)'s variant C with `reshape: down`: 8x8x32, then 4x4x128
# (channel steps 128 -> 96 -> 64, MCF hidden 256 / 384 / 256, NICE hidden 64
# x C); fp32, at the shipped widths (128 px, B = 40)
STACK_DOWN = dict(multistack=True, reshape="down", levels=[[4, 3, 2], [4, 3, 2]],
                  factors=[16, 4], use1x1=True, mixed=False)


def phase_down_stack(dev, smi, cfg=None):
    """(t) variant D at the shipped widths: the flow's fp32 round trip z ->
    forward -> inverse within ROUNDTRIP_TOL, with every K2 and K5 launch of
    the inverse held against its plain version on its inputs (each K5
    shape timed); 2 timed fp32 inverses; then the model in bf16, one
    ``forward_sample`` with every K1, K2, K5 and K3 launch held so, and 2
    timed passes.  The launch counts are zeroed before each run and read
    after.  Returns (launches by path, results, K5's rows)."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.flows import count_params

    release()
    t_phase = time.perf_counter()
    cfg = cfg or dict(entry.SHIPPED, **STACK_DOWN)
    gen = torch.Generator(device=dev).manual_seed(5)
    model = entry.build(cfg, dev, gen)
    entry.perturb(model.flow_params, gen)
    flow, b = model.flow, cfg["batch_size"]
    n_params = count_params(model.flow_params.tree())
    want = expected_option_launches(model, cfg, False)
    want["spade_gn"] = 0
    m = model.min_spatial_size
    z = torch.randn((b, m, m, model.flow_in_channels), generator=gen, device=dev)
    h = torch.randn((b, m, m, flow.h_channels), generator=gen, device=dev)
    tag = "(t) SHIPPED D"
    paths, results = {}, {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        y, _ = flow.forward(model.flow_params.tree(), z, h)
        xs = []
        ops.reset_launches()  # the fp32 inverse's run
        rows = launch_check(f"{tag} fp32 inverse", lambda: xs.append(
            flow.inverse(model.flow_params.tree(), y, h)), want,
            ("macow_unit_inverse", "masked_conv_inverse"))
        torch.cuda.synchronize()
        paths["down_stack_inverse"] = check_launches(f"{tag} fp32 inverse", want)
        err = max_err(xs[0], z)
        print(f"{tag} fp32 round trip z -> forward -> inverse at {tuple(z.shape)}: "
              f"max |x - z| {err:.3e} (tol {ROUNDTRIP_TOL}), max |y| "
              f"{y.abs().max().item():.3e}; {n_params / 1e6:.2f}M flow params")
        if not bool(torch.isfinite(xs[0]).all()) or err > ROUNDTRIP_TOL:
            raise AssertionError(f"{tag}: fp32 round trip out of bound")
        del xs
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            flow.inverse(model.flow_params.tree(), y, h)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        results["fp32_inverse"] = {"ms": sum(times) / 2, "runs_ms": times,
                                   "launches": paths["down_stack_inverse"]}
        print(f"{tag} fp32 flow inverse B={b}: {sum(times) / 2:.1f} ms "
              f"({', '.join(f'{t:.1f}' for t in times)}) on {smi}")
        del y

        model = model.to(torch.bfloat16)
        batch = entry.make_batch(cfg, dev, torch.bfloat16, seed=0)
        want16 = expected_option_launches(model, cfg, True)
        frames = []
        ops.reset_launches()  # the bf16 sampling pass's run
        launch_check(f"{tag} bf16 pass", lambda: frames.append(
            model.forward_sample(batch, cfg["T"], gen)), want16,
            [k for k in ("nice_net", "macow_unit_inverse", "masked_conv_inverse",
                         "spade_gn") if want16[k]], timed=False)
        torch.cuda.synchronize()
        paths["down_stack_sample"] = check_launches(f"{tag} bf16 pass", want16)
        shape = (b, cfg["T"], cfg["spatial"], cfg["spatial"], 3)
        if tuple(frames[0].shape) != shape or not bool(torch.isfinite(frames[0]).all()):
            raise AssertionError(f"{tag}: frames {tuple(frames[0].shape)}, want finite "
                                 f"{shape}")
        del frames
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            model.forward_sample(batch, cfg["T"], gen)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    results["bf16_pass"] = {"ms": sum(times) / 2, "runs_ms": times,
                            "launches": paths["down_stack_sample"]}
    results.update(peak_gib=peak, params_m=n_params / 1e6)
    print(f"{tag} bf16 sampling pass B={b} T={cfg['T']} {cfg['spatial']}px: "
          f"{sum(times) / 2:.1f} ms ({', '.join(f'{t:.1f}' for t in times)}), peak "
          f"{peak:.2f} GiB over the phase (the checked runs' kept inputs included) "
          f"on {smi}")
    del model, batch
    release()
    print(f"(t) in {time.perf_counter() - t_phase:.1f} s")
    return paths, results, rows["masked_conv_inverse"]


# ---------------------------------------------------------------------------
# (u) the PokeVAE baseline
# ---------------------------------------------------------------------------

def poke_vae_config(base):
    """``base`` (a first-stage config) with ``architecture.baseline``: the
    PokeVAE, the poke as the GRU's input (the default)."""
    cfg = copy.deepcopy(base)
    cfg["architecture"]["baseline"] = True
    return cfg


def phase_poke_vae(dev, smi):
    """(u1) the PokeVAE at TINY, 3 steps card against CPU by the (i2) rule;
    (u2) config/first_stage.yaml with ``baseline: true`` (64 px, B = 20, T =
    10, fp32, TF32 off): one checked step, the path's run, with the launch
    counts zeroed before and read after and every K3 launch held against
    its plain version on its inputs (each shape timed), then 3 timed steps
    and the peak memory.  Returns (launches by path, results, K3's rows)."""
    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.train import FirstStageTrainer

    t_phase = time.perf_counter()
    release()
    phase_first_stage_tiny(dev, poke_vae_config(entry.FIRST_STAGE_TINY), 3,
                           "(u1) PokeVAE TINY")
    cfg, label = poke_vae_config(entry.FIRST_STAGE), "(u2) POKE_VAE"
    B = cfg["data"]["batch_size"]
    nets = entry.build_first_stage(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    batch = entry.make_first_stage_batch(cfg, dev)
    trainer = FirstStageTrainer(cfg, *nets)
    draw_gen = torch.Generator(device=dev).manual_seed(1)
    before = [[p.detach().clone() for p in net.parameters()] for net in nets[:3]]
    print(f"{label} params: " + ", ".join(
        f"{name} {sum(p.numel() for p in net.parameters()) / 1e6:.2f}M"
        for name, net in zip(("generator", "d_s", "d_t", "vgg"), nets)))
    want = expected_first_stage_launches(cfg)
    out = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()  # the PokeVAE step's run
    rows = launch_check(f"{label} train step", lambda: out.append(
        trainer.train_step(batch, 0, draw_gen)), want, ("spade_gn",))
    torch.cuda.synchronize()
    launches = check_launches(f"{label} train step", want)
    metrics = {k: v.item() for k, v in out[0].items()}
    if not all(map(math.isfinite, metrics.values())):
        raise AssertionError(f"{label} metrics {metrics}")
    # a discriminator's last bias starts at 0, and its gradient is exactly 0
    # while every prediction sits inside the hinge's margin (as many real
    # as fake terms, each +-1/N): coupled decay of 0 leaves it; the
    # generator's params all move
    held = {}
    for name, net, p0 in zip(("generator", "d_s", "d_t"), nets[:3], before):
        still = [(n, a) for (n, b), a in zip(net.named_parameters(), p0)
                 if torch.equal(a, b)]
        if name == "generator" and still or any(
                a.dim() != 1 or bool(a.any()) for _, a in still):
            raise AssertionError(f"{label}: {name} params did not move: "
                                 f"{[n for n, _ in still]}")
        held[name] = [n for n, _ in still]
    print(f"{label} step 1: every generator param moved, the discriminators' but "
          f"zero biases of zero gradient {held}; "
          + ", ".join(f"{k} {v:.5g}" for k, v in metrics.items()))
    del before, out
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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{label} train fp32 B={B} T={cfg['data']['max_frames']} "
          f"{cfg['data']['spatial_size'][0]}px: {ms:.1f} ms/step "
          f"({', '.join(f'{t:.1f}' for t in times)}), {B / (ms / 1e3):.2f} clips/s, "
          f"peak {peak:.2f} GiB (the checked step's kept inputs included) on {smi}")
    del nets, trainer, batch
    release()
    print(f"(u1, u2) in {time.perf_counter() - t_phase:.1f} s")
    return ({"poke_vae_train": launches},
            {"ms_per_step": ms, "steps_ms": times, "peak_gib": peak}, rows["spade_gn"])


def check_first_stage_restore(e1, path, data_root, model_name, dev):
    """The state a ``--resume`` of the first-stage run ``e1`` loads (step,
    the three nets, each optimizer's count and Adam state) on ``dev``
    against the run's own, bit for bit."""
    from ipoke_tpu_torch import main as cli
    from ipoke_tpu_torch.cli.experiments import FirstStageExperiment

    args = cli.parse_args(["--config", path, "--model_name", model_name,
                           "--data_root", data_root, "--resume"])
    cfg_r, dirs, _ = cli.load_parameters(args)
    e2 = FirstStageExperiment(cfg_r, dirs, data_root=data_root, device=dev)
    e2.build()
    e2.restore_last()
    same = lambda a, b: all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))
    checks = {"step": e2.step == e1.step,
              "nets, bitwise": all(
                  same(a.state_dict().values(), b.state_dict().values())
                  for a, b in ((e2.model, e1.model), (e2.disc_s, e1.disc_s),
                               (e2.disc_t, e1.disc_t))),
              "optimizers, bitwise": all(
                  ta.count == tb.count and all(
                      same(ta.adam.state[p].values(), tb.adam.state[q].values())
                      for p, q in zip(ta.params, tb.params))
                  for ta, tb in zip(e2.trainer.tx, e1.trainer.tx))}
    e2.metrics_logger.close()
    print(f"CLI first_stage ({model_name}) restore check (step {e2.step}): {checks}")
    if not all(checks.values()):
        raise AssertionError(f"CLI first_stage ({model_name}) restore: {checks}")


def phase_poke_vae_cli(dev, smi, tree):
    """(u3) ``ipoke_tpu_torch.main`` over config/first_stage.yaml with
    ``baseline: true`` on (k)'s tree at (k)'s sizes, model name
    ``pokevae``: one epoch, a restore check, then ``--resume`` for one
    more, each run with the launch counts zeroed before and read after.
    Returns (launches by path, results)."""
    import os
    import shutil

    import yaml

    from ipoke_tpu_torch.core.config import load_config

    release()
    t0, name = time.perf_counter(), "pokevae"
    cfg = load_config(os.path.join("config", "first_stage.yaml")).to_dict()
    cfg["data"]["dataset"] = "PlantDataset"
    cfg["training"].update(n_epochs=1, max_batches_per_epoch=CLI_BATCHES,
                           max_val_batches=1)
    cfg["architecture"]["baseline"] = True
    path = os.path.join(tree["root"], f"first_stage_{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    launches, results = {}, {}
    e1, results["run"] = drive_cli(dev, smi, tree["data_root"], "first_stage", path,
                                   model_name=name)
    launches["poke_vae_cli"] = results["run"]["launches"]
    check_first_stage_restore(e1, path, tree["data_root"], name, dev)
    step1, count1 = e1.step, e1.tx.count
    del e1
    release()
    e2, results["resume"] = drive_cli(dev, smi, tree["data_root"], "first_stage", path,
                                      "--resume", model_name=name)
    launches["poke_vae_cli_resume"] = results["resume"]["launches"]
    n2 = len(e2.timings["step_s"])
    if (e2.step, e2.tx.count) != (step1 + n2, count1 + n2):
        raise AssertionError(f"(u3) --resume: step {e2.step}, count {e2.tx.count}; want "
                             f"{step1 + n2}, {count1 + n2}")
    del e2
    release()
    shutil.rmtree(os.path.join(tree["base"], "first_stage", "ckpt", name),
                  ignore_errors=True)
    print(f"(u3) in {time.perf_counter() - t0:.1f} s")
    return launches, results


# (v) K5's streamed instance (B, H, W, C, hid, Ch, order): fault (e)'s
# shapes, past shared memory (2x2x512 at hid 512: 786 KB of w_shift a CTA at
# a cluster of 8; 4x4x256 at hid 2048) and a row past 1024 elements
# (16x16x128 at hid 256, order C), each with its row staged in shared
# memory; and a 2x64x512 row at hid 512, too wide to stage
K5_STREAMED_CASES = ((40, 2, 2, 512, 512, 128, "A"), (40, 4, 4, 256, 2048, 128, "B"),
                     (40, 16, 16, 128, 256, 128, "C"), (8, 2, 64, 512, 512, 128, "A"))


def phase_k5_streamed(dev):
    """(v) K5 at ``K5_STREAMED_CASES`` against its plain version within
    K5_TOL, two calls bitwise equal, with device times and the bound."""
    from ipoke_tpu_torch.ops import _build, masked_conv

    gen = torch.Generator(device=dev).manual_seed(13)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev)
    lib = _build.load()
    rows = []
    for b, hh, ww, c, hid, ch, order in K5_STREAMED_CASES:
        transposed, reverse = order in "CD", order in "BD"
        ks = (3, 2) if transposed else (2, 3)
        params = {"w_shift": randn(*ks, c, hid) * (6 * c) ** -0.5,
                  "out": {"v": randn(1, 1, hid + ch, 2 * c) * 0.05,
                          "g": randn(2 * c) * 0.3, "b": randn(2 * c) * 0.1}}
        y, h = randn(b, hh, ww, c), randn(b, hh, ww, ch)
        ys = (y.transpose(1, 2) if transposed else y).contiguous()
        packed = [t.contiguous() for t in masked_conv.pack_mcf(
            F.elu(h), params, transposed, b, hh, ww)]
        args = (ys, *packed, 1.0, reverse)
        sw, k = ys.shape[2], masked_conv.k5_cluster(hid)
        name = f"(v) K5 streamed {order} B={b} {hh}x{ww} C={c} hid={hid}"
        if not masked_conv.k5_streamed(sw, c, hid, 2, 3, k) \
                or lib.masked_conv_inverse_streamed_at(sw, c, hid, 2, 3, k) != 1:
            raise AssertionError(f"{name}: not the streamed instance")
        smem = masked_conv.k5_smem_bytes(sw, c, hid, 2, 3, k)
        if lib.masked_conv_inverse_smem_bytes(sw, c, hid, 2, 3, k) != smem:
            raise AssertionError(f"{name}: kernel and k5_smem_bytes disagree")
        got = masked_conv.masked_conv_inverse_cuda(*args)
        err = check_close(name, got, masked_conv.masked_conv_inverse_plain(*args), K5_TOL)
        if not torch.equal(got, masked_conv.masked_conv_inverse_cuda(*args)):
            raise AssertionError(f"{name}: two calls differ")
        ms = cuda_ms(lambda: masked_conv.masked_conv_inverse_cuda(*args), 10)
        plain_ms = cuda_ms(lambda: masked_conv.masked_conv_inverse_plain(*args), 2)
        bound_ms, bound_by = bound(*k5_work(b, hh, ww, c, hid), FP32_FLOPS)
        staged = smem > masked_conv.K5_STREAMED_SMEM
        print(f"{name} Ch={ch} ({'row staged' if staged else 'not staged'}): "
              f"max_abs_err {err:.3e} (tol {K5_TOL}), two calls "
              f"bitwise equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{1e3 * bound_ms:.2f} us ({bound_by}; {100 * bound_ms / ms:.2f}% of it); "
              f"clusters of {k}, {smem} B of shared memory per CTA, "
              f"{lib.masked_conv_inverse_max_clusters(sw, c, hid, 2, 3, k)} clusters "
              f"resident at once")
        rows.append({"B": b, "H": hh, "W": ww, "C": c, "hid": hid, "order": order,
                     "staged": staged, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
                     "cluster": k, "smem_bytes": smem})
    return rows


# (w) the dp x tp mesh on the card: two ranks on the one H100 over gloo
# (NCCL takes one rank a device).  The SHIPPED widths (128 px, B = 40, T =
# 10, NICE hidden 2048) cut to MESH_STEPS, bf16 params with fp32 masters
# at a constant lr MESH_LR, against the same on one rank.  The split sums
# each coupling's u in another order than one rank: the sharded step's
# loss within MESH_LOSS_TOL relative of the rank's, every updated param
# within 2 lr plus 2^-7 of the larger magnitude (AMSGrad's first step moves
# a master by lr whatever its gradient; each bf16 param rounds its master
# by half an ulp, at most 2^-8 of its magnitude), the videos within
# MESH_VIDEO_TOL max and MESH_VIDEO_MEAN_TOL mean (frames in [-1, 1]; a
# wrong split moves them by O(1) everywhere)
MESH_STEPS, MESH_LR = (1, 1), 1e-3
MESH_LOSS_TOL, MESH_VIDEO_TOL, MESH_VIDEO_MEAN_TOL = 1e-2, 0.25, 1e-2


def mesh_shipped_leg(rank, device, model_parallel, cfg, check=True):
    """(w) on one rank: the second stage at ``cfg`` on one rank (the whole
    batch and tree), then on the mesh of ``model_parallel``: DDI on the
    whole batch, couplings perturbed, the shard cut at ``start``; one
    ``forward_sample`` (gathered over the data ranks) and one train step,
    each with the launch counts zeroed before and read after (``check``:
    every K1 and K4 launch held against its plain version on its inputs,
    ``launch_check``), then one more of each on the host clock and
    (``check``) one more under ``torch.profiler`` on rank 0.  Returns
    the sharded run's counts, times and differences from the rank's own
    one-rank run."""
    import torch.distributed as dist

    from ipoke_tpu_torch import entry, ops
    from ipoke_tpu_torch.core.optim import cast_floats
    from ipoke_tpu_torch.flows.base import tree_leaves, tree_map
    from ipoke_tpu_torch.parallel import gather_params, make_mesh, shard_batch
    from ipoke_tpu_torch.train import SecondStageTrainer

    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" \
        else torch.device(device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    mesh = make_mesh(None, model_parallel)
    batch = entry.make_batch(cfg, dev)
    b16 = cast_floats(batch, torch.bfloat16)
    tag = f"(w) tp={mesh.tp} dp={mesh.dp} rank {rank}"
    res, out = {}, {"shape": dict(mesh.shape)}
    for name, m in (("one", None), ("mesh", mesh)):
        model = entry.build(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        trainer = SecondStageTrainer(model, MESH_LR, mesh=m)
        trainer.ddi(batch)
        entry.perturb(model.flow_params, torch.Generator(device=dev).manual_seed(1))
        trainer.start()
        local = b16 if m is None else shard_batch(b16, m)
        sample = lambda: model.forward_sample(
            b16, cfg["T"], torch.Generator(device=dev).manual_seed(2), mesh=m)
        step = lambda: trainer.train_step(local)
        if m is None:
            res[name] = (sample(), float(step()["flow_loss"]),
                         tree_map(lambda t: t.detach(), model.flow_params.tree()))
            del model, trainer
            continue
        got = {}
        for what, run, names, want in (
                ("sample", sample, ("nice_net",), expected_launches(cfg)),
                ("train", step, ("nice_net", "nice_net_train"),
                 expected_train_launches(cfg))):
            sync()
            ops.reset_launches()
            keep = lambda run=run, what=what: got.__setitem__(what, run())
            if check:
                out[what + "_rows"] = launch_check(f"{tag} {what}", keep, want,
                                                   names, timed=False)
            else:
                keep()
            sync()
            out[what + "_launches"] = dict(ops.LAUNCHES)
            print(f"{tag} {what}: kernel launches {out[what + '_launches']}")
            for k in names if check else ():
                if out[what + "_launches"][k] != want[k]:
                    raise AssertionError(f"{tag} {what} {k}: "
                                         f"{out[what + '_launches'][k]} != {want[k]}")
        res[name] = (got["sample"], float(got["train"]["flow_loss"]), tree_map(
            lambda t: t.detach().clone(), gather_params(model.flow_params.tree(), mesh)))
        for what, run in (("sample", sample), ("train", step)):  # a second step
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            run()
            sync()
            out[what + "_ms"] = 1e3 * (time.perf_counter() - t0)
        if check:  # one more of each, rank 0's under torch.profiler
            for what, run in (("sample", sample), ("train", step)):
                sync()
                dist.barrier()
                if rank == 0:
                    profiled(f"{tag} {what} (rank 0's kernels; rank 1 shares the card)", run)
                else:
                    run()
    (v1, l1, t1), (v2, l2, t2) = res["one"], res["mesh"]
    dv = (v2.float() - v1.float()).abs()
    worst = max(float(((a.float() - b.float()).abs() - (
        2 * MESH_LR + 2 ** -7 * torch.maximum(a.float().abs(), b.float().abs()))).max())
        for a, b in zip(tree_leaves(t2), tree_leaves(t1)))
    out.update(video_max=float(dv.max()), video_mean=float(dv.mean()),
               loss=l2, loss_one=l1, loss_rel=abs(l2 - l1) / max(abs(l1), 1e-12),
               param_excess=worst, finite=bool(torch.isfinite(v2).all()))
    if not (out["finite"] and out["loss_rel"] <= MESH_LOSS_TOL and worst <= 0
            and out["video_max"] <= MESH_VIDEO_TOL
            and out["video_mean"] <= MESH_VIDEO_MEAN_TOL):
        raise AssertionError(f"{tag}: the mesh against one rank: "
                             + str({k: v for k, v in out.items() if "rows" not in k}))
    return out


def nice_shard_times(dev):
    """(w) K1 and K4 at the level-0 step coupling's shard at tp = 2 (M =
    2560, K1 = 144, Hid 2048, S = 2 at N = 1024, S = 3 at K = 1024) beside
    the whole coupling's call: device times, plain times and the bound."""
    from ipoke_tpu_torch.ops import nice_net

    gen = torch.Generator(device=dev).manual_seed(17)
    randn = lambda *s, std=1.0: (std * torch.randn(s, generator=gen, device=dev)
                                 ).to(torch.bfloat16)
    m, k1, hid, n = 2560, 144, 2048, 288
    zcol, w1 = randn(m, k1), randn(k1, hid, std=k1 ** -0.5)
    w2, wp = randn(hid, hid, std=hid ** -0.5), randn(hid, n, std=0.05)
    rows = {}
    for name, train in (("nice_net", False), ("nice_net_train", True)):
        fn = nice_net.nice_net_train_cuda if train else nice_net.nice_net_cuda
        plain = nice_net.nice_net_train_plain if train else nice_net.nice_net_plain
        rows[name] = []
        for hs in (hid, hid // 2):
            args = (zcol, w1, w2[:, :hs].contiguous(), wp[:hs].contiguous())
            got, want = fn(*args), plain(*args)
            got, want = (got, want) if train else ((got,), (want,))
            err = max(check_close(f"(w) {name} Hs={hs}", g, w, K1_TOL * min(
                1.0, w.float().abs().max().item()), K1_TOL) for g, w in zip(got, want))
            ms, plain_ms = cuda_ms(lambda: fn(*args), 20), cuda_ms(lambda: plain(*args), 5)
            bound_ms, bound_by = bound(*nice_work(m, k1, hid, n, train, hs), BF16_FLOPS)
            print(f"(w) {name} M={m} K1={k1} Hid={hid} Hs={hs} N={n}: max_abs_err "
                  f"{err:.3e} (tol {K1_TOL} x min(1, max |ref|) abs + rel), kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {1e3 * bound_ms:.2f} us "
                  f"({bound_by}; {100 * bound_ms / ms:.1f}% of it)")
            rows[name].append({"M": m, "K1": k1, "Hid": hid, "Hs": hs, "N": n,
                               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": None})
    return rows


def phase_mesh(dev, smi):
    """(w) the mesh on the card: the dryrun's toy legs (dp 1 x tp 2 and dp 2
    x tp 1, fp32, loss and pass within 2e-4 of one rank, params within 2
    lr) and
    ``mesh_shipped_leg`` at tp = 2 and dp = 2, two ranks over gloo; then a
    world of one over NCCL for one toy step; K1/K4 at the shard's shapes;
    the SHIPPED flow's shard bytes at tp = 2 and 4 on ``meta``.  Returns
    the paths' launch counts (summed over the ranks) and the rows."""
    import torch.distributed as dist

    from ipoke_tpu_torch import entry
    from ipoke_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    cfg = dict(entry.SHIPPED, num_steps=MESH_STEPS)
    calls = [(dryrun.toy_leg, ("mesh", 2)), (dryrun.toy_leg, ("mesh", 1)),
             (mesh_shipped_leg, (2, cfg)), (mesh_shipped_leg, (1, cfg))]
    ranks = dryrun.launch(dryrun.legs, 2, "cuda", "gloo", (calls,))
    for i, what in enumerate(("dp 1 x tp 2", "dp 2 x tp 1")):
        for r, res in enumerate(ranks):
            # the updated params within 2 lr: on the card the batch's split
            # changes cuDNN's algorithms, and AMSGrad's first step of a
            # gradient near its eps turns with the gradient's rounding
            # (1.8e-4 seen at dp 2 against 2e-4; the CPU test holds 2e-4)
            dryrun.check(res[i], f"(w) toy {what} rank {r}", 2 * dryrun.LR)
        print(f"(w) toy {what}, two ranks on one card over gloo: loss "
              f"{ranks[0][i]['loss_sharded']:.6f} (one rank {ranks[0][i]['loss']:.6f}), "
              f"max param diff {ranks[0][i]['params']:.2e}, video max diff "
              f"{ranks[0][i]['video']:.2e} (tol {dryrun.TOL})")
    paths, out = {}, {}
    for i, name in ((2, "tp2"), (3, "dp2")):
        for r, res in enumerate(ranks):
            print(f"(w) SHIPPED widths at num_steps {MESH_STEPS}, {name} rank {r} "
                  f"{res[i]['shape']}: sample {res[i]['sample_ms']:.1f} ms, step "
                  f"{res[i]['train_ms']:.1f} ms (host clock, both ranks on one card); "
                  f"loss {res[i]['loss']:.5f} against one rank's {res[i]['loss_one']:.5f} "
                  f"(rel {res[i]['loss_rel']:.2e}, tol {MESH_LOSS_TOL}); video max diff "
                  f"{res[i]['video_max']:.3e} (tol {MESH_VIDEO_TOL}), mean "
                  f"{res[i]['video_mean']:.3e} (tol {MESH_VIDEO_MEAN_TOL}); params "
                  f"within 2 lr + 2^-7 max |p| (excess {res[i]['param_excess']:.2e})")
        for what in ("sample", "train"):
            paths[f"mesh_{name}_{what}"] = {
                k: sum(res[i][what + "_launches"][k] for res in ranks)
                for k in ranks[0][i][what + "_launches"]}
        out[name] = [{k: v for k, v in res[i].items() if not k.endswith("_rows")}
                     for res in ranks]
    rows = {"nice_net": [], "nice_net_train": []}
    for res in ranks:
        for i in (2, 3):
            for what in ("sample", "train"):
                for k, r in res[i].get(what + "_rows", {}).items():
                    rows[k].extend(r)
    print(f"(w) two-rank legs: {time.perf_counter() - t0:.1f} s")
    # a world of one over NCCL: one all-reduce of a CUDA tensor, one toy step
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{dryrun.free_port()}",
                            world_size=1, rank=0)
    try:
        t = torch.arange(4.0, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        if not torch.equal(t, torch.arange(4.0, device=dev)):
            raise AssertionError("(w) NCCL all_reduce over a world of one")
        res = dryrun.toy_leg(0, "cuda", "mesh", 1)
        dryrun.check(res, "(w) NCCL world of one", 2 * dryrun.LR)
        print(f"(w) NCCL world of one: all_reduce and a toy step, loss "
              f"{res['loss_sharded']:.6f}")
    finally:
        dist.destroy_process_group()
    shard = nice_shard_times(dev)
    for tp in (2, 4):
        b = dryrun.shipped_shard_bytes(tp)
        out[f"shipped_bytes_tp{tp}"] = b
        print(f"(w) SHIPPED flow on meta at tp={tp}: whole {b['whole'] / 2**30:.3f} GiB "
              f"fp32, each rank " + ", ".join(f"{x / 2**30:.3f}" for x in b["ranks"])
              + " GiB")
    print(f"(w) done in {time.perf_counter() - t0:.1f} s on {smi}")
    return paths, out, rows, shard


def phase_zoo(dev):
    """(x) each module of the dormant zoo card against CPU at a small size,
    fp32 with TF32 off, the same params: within 1e-4 abs + rel (no
    kernel)."""
    from ipoke_tpu_torch.flows import extra, leapfrog
    from ipoke_tpu_torch.flows.base import tree_map
    from ipoke_tpu_torch.nn.blocks import AdaIN
    from ipoke_tpu_torch.nn.discriminators import MinibatchDiscrimination
    from ipoke_tpu_torch.nn.motion_generator import Generator3D

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(19)
    x4, h4 = torch.randn(2, 4, 4, 8, generator=gen), torch.randn(2, 4, 4, 4, generator=gen)
    x2, v2 = torch.randn(4, 6, generator=gen), torch.randn(4, 6, generator=gen)

    def perturbed(tree):
        def walk(node):
            if isinstance(node, dict):
                if {"v", "g", "b"} <= node.keys():
                    node["g"] = 0.3 * torch.randn(node["g"].shape, generator=gen)
                for v in node.values():
                    walk(v)
            elif isinstance(node, list):
                for v in node:
                    walk(v)
        walk(tree)
        return tree

    flows = {
        "MixCDFCoupling": (extra.MixCDFCoupling(8, 16, 3), (x4,)),
        "build_mixcdf_flow": (extra.build_mixcdf_flow(8, 2, 16, 2), (x4,)),
        "HierarchicalCouplingFlow": (extra.HierarchicalCouplingFlow(
            (1, 1), 8, 16, h_channels=4, factor=4, n_blocks=1), (x4, h4)),
        "LeapFlow": (leapfrog.LeapFlow(6, 16, depth=1, n_flows=3, extended=False), (x2, v2)),
        "LeapFlow extended": (leapfrog.LeapFlow(6, 16, depth=1, n_flows=3), (x2, v2)),
    }
    calls = {}
    for name, (flow, args) in flows.items():
        p = perturbed(flow.init(gen, "cpu"))
        calls[name] = (lambda p, a, flow=flow: (flow.forward(p, *a),), p, args)
    made = extra.MADE(5, (16, 16), 10, ncond=3)
    calls["MADE"] = (lambda p, a: made.apply(p, *a), made.init(gen, "cpu"),
                     (torch.randn(3, 5, generator=gen), torch.randn(3, 3, generator=gen)))
    gc = extra.GatedConv2d(8, dim_cond=4)
    calls["GatedConv2d"] = (lambda p, a: gc.apply(p, *a), gc.init(gen, "cpu"), (x4, h4))
    ga = extra.GatedAttention(8, 2)
    calls["GatedAttention"] = (lambda p, a: ga.apply(p, *a), ga.init(gen, "cpu", (4, 4)), (x4,))
    nets = {"AdaIN": (AdaIN(6, 8), (torch.randn(2, 3, 4, 4, 6, generator=gen),
                                    torch.randn(2, 8, generator=gen))),
            "Generator3D": (Generator3D(nf=4, z_dim=8, spatial_size=16, max_frames=4),
                            (torch.randn(2, 8, generator=gen),
                             torch.randn(2, 16, 16, 3, generator=gen))),
            "MinibatchDiscrimination": (MinibatchDiscrimination(6, 4, 3), (x2,))}
    for name, (net, args) in nets.items():
        with torch.no_grad():
            for q in net.parameters():
                q.copy_(torch.randn(q.shape, generator=gen) * q[0].numel() ** -0.5
                        if q.ndim > 1 else 0.1 * torch.randn(q.shape, generator=gen))
        calls[name] = (lambda p, a, net=net: net.to(a[0].device)(*a), None, args)
    flat = lambda o: [t for x in (o if isinstance(o, (tuple, list)) else (o,))
                      for t in (x if isinstance(x, (tuple, list)) else (x,))]
    with torch.no_grad():
        for name, (fn, p, args) in calls.items():
            cpu = flat(fn(p, args))
            card = flat(fn(None if p is None else tree_map(lambda t: t.to(dev), p),
                           tuple(a.to(dev) for a in args)))
            err = max(check_close(f"(x) {name}", c.cpu(), w, 1e-4, 1e-4)
                      for c, w in zip(card, cpu))
            print(f"(x) {name} card against CPU: max_abs_err {err:.3e} (tol 1e-4 abs + rel)")
    print(f"(x) done in {time.perf_counter() - t0:.1f} s")


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
    # (p1) the reproduction recipe at its width and depth, (p2) SMALL under
    # Adafactor and AdaBelief card vs CPU
    recipe_launches, recipe, rows = phase_recipe(dev, smi)
    paths.update(recipe_launches)
    for name, r in rows.items():
        kernels[name]["recipe_sample_shapes"] = r
    recipe["small_rules"] = phase_recipe_small(dev)
    # (r1) a SMALL torch_compat stack from seeded reference .ckpt files,
    # card vs CPU; (r2) the SHIPPED-width fp32 pass with torch_compat
    paths["reference_small"] = phase_reference_small(dev)
    paths["reference_sample"], ref_out, rows = phase_reference(dev, smi)
    for name, r in rows.items():
        kernels[name]["reference_sample_shapes"] = r
    kernels["macow_unit_inverse"]["reference_in_situ_ms"] = ref_out["in_situ_ms"]["K2"]
    kernels["spade_gn"]["reference_in_situ_ms"] = ref_out["in_situ_ms"]["K3"]
    # (s1) the second stage's options, SMALL card vs CPU; (s2) variants A,
    # B and C at the shipped widths
    paths.update(phase_options_small(dev))
    s_launches, s_out, rows = phase_options_shipped(dev, smi)
    paths.update(s_launches)
    for name, r in rows.items():
        kernels[name]["options_A_shapes"] = r
    for name, key in (("nice_net", "K1"), ("macow_unit_inverse", "K2"), ("spade_gn", "K3")):
        kernels[name]["options_A_in_situ_ms"] = s_out["A"]["in_situ_ms"][key]
    # (t) variant D, the `reshape: down` stack: K5's wide path in situ
    t_launches, _, rows = phase_down_stack(dev, smi)
    paths.update(t_launches)
    kernels["masked_conv_inverse"]["down_stack_in_situ"] = rows
    # (v) K5's streamed instance at fault (e)'s shapes; (w) the dp x tp mesh,
    # two ranks on the card; (x) the dormant zoo card against CPU
    kernels["masked_conv_inverse"]["streamed_shapes"] = phase_k5_streamed(dev)
    w_launches, _, rows, shard = phase_mesh(dev, smi)
    paths.update(w_launches)
    for name in ("nice_net", "nice_net_train"):
        kernels[name]["mesh_in_situ_shapes"] = rows[name]
        kernels[name]["shard_tp2_shapes"] = shard[name]
    phase_zoo(dev)
    # (i) the first-stage VAE-GAN train step; (q3) K3 in bf16 at its
    # training shapes, forward and backward; (q1) TINY under mixed_prec and
    # a full_sequence: false step, card vs CPU; (q2) the yaml's step in bf16
    kernels["spade_gn"]["train_shapes"] = phase_k3_train(dev)
    kernels["spade_gn"]["bf16_train_shapes"] = phase_k3_train(dev, torch.bfloat16)
    phase_first_stage_tiny(dev)
    phase_first_stage_tiny_bf16(dev)
    from ipoke_tpu_torch import entry

    partial = copy.deepcopy(entry.FIRST_STAGE_TINY)
    partial["training"]["full_sequence"] = False
    phase_first_stage_tiny(dev, partial, 1, "(q1) first-stage TINY full_sequence false")
    paths["first_stage_train"], fs_times = phase_first_stage(dev, smi)
    kernels["spade_gn"]["first_stage_in_situ_ms"] = fs_times["in_situ_ms_per_call"]
    paths["first_stage_bf16_train"], fs16 = phase_first_stage(
        dev, smi, entry.FIRST_STAGE_BF16, "(q2) FIRST_STAGE_BF16")
    kernels["spade_gn"]["first_stage_bf16_in_situ_ms"] = fs16["in_situ_ms_per_call"]
    print(f"(q2) first-stage step, same call: bf16 {fs16['ms_per_step']:.1f} ms, "
          f"{fs16['peak_gib']:.2f} GiB; fp32 {fs_times['ms_per_step']:.1f} ms, "
          f"{fs_times['peak_gib']:.2f} GiB; on {smi}")
    # (u1, u2) the PokeVAE baseline: TINY card vs CPU, the yaml's step
    u_launches, _, rows = phase_poke_vae(dev, smi)
    paths.update(u_launches)
    kernels["spade_gn"]["poke_vae_train_shapes"] = rows
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
        # (r3) the loader's wait with the native decoders and without
        phase_native_loader(dev, smi, tree)
        # (l) the --test modes on (k)'s second-stage run
        phase_eval_nets(dev, smi)
        test_launches, _ = phase_test_modes(dev, smi, tree)
        paths.update(test_launches)
        # (l') the UI's main route on (k)'s second-stage run
        ui_launches, ui_out = phase_ui_restore(dev, smi, tree)
        paths.update(ui_launches)
        for name, rows in ui_out["kernel_shapes"].items():
            kernels[name]["ui_restored_poke_shapes"] = rows
        # (s3) the CLI over variant A's options, on (k)'s first stage
        s3_launches, _ = phase_options_cli(dev, smi, tree)
        paths.update(s3_launches)
        # (u3) the PokeVAE through the CLI, then --resume
        u3_launches, _ = phase_poke_vae_cli(dev, smi, tree)
        paths.update(u3_launches)
        # (p3) the recipe through the CLI on (k)'s frozen runs; (k)'s second
        # stage and third-stage runs are read by no later phase
        free_runs(tree, ("second_stage", "flow_vae", "flow_motion"))
        recipe_cli, _ = phase_recipe_cli(dev, smi, tree)
        paths.update(recipe_cli)
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
    # (o) data prep with full-width RAFT and pose prep, RAFT training, the UI
    with prep_root() as root:
        prep_launches, prep_out = phase_prep(dev, smi, root)
        paths.update(prep_launches)
        train_launches, _ = phase_raft_train(dev, smi, prep_out["processed"])
        paths.update(train_launches)
        ui_launches, ui_out = phase_ui(dev, smi, root, prep_out["processed"])
        paths.update(ui_launches)
        for name, rows in ui_out["kernel_shapes"].items():
            kernels[name]["ui_poke_shapes"] = rows

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
