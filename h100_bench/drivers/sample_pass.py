"""A closed loop of ``SecondStageModel.forward_sample`` passes.

Each pass samples ``draws_per_clip`` videos of each of ``clips`` clips
(start frame and poke) in one batch, z drawn afresh from the seed for every
pass; the clip batches come from a pool of ``pool`` seeded batches, used in
turn.  Every pass is waited for, as the evaluation waits for each draw.

After the window, ``checked_passes`` passes drawn from the seed (a
reservoir over all the run's passes) are held against the plain reference
in fp32, ``reference_block`` items at a time: each item's mean absolute
difference over its frames, reported as the mean over items and as the
worst item.  With ``control`` (``readings.py``) the reference itself, in
that lower precision, takes the program's place.
"""

from __future__ import annotations

import gc
import random
import sys
import time

import numpy as np
import torch

import weights
from frozen.synthetic import make_batch
from harness import load_module


class Driver:
    def __init__(self, cell, seed, device, control=None):
        self.cfg, self.traffic = cell.config, cell.traffic
        self.mc = self.cfg["model"]
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.dtype = getattr(torch, self.cfg["dtype"])
        t = self.traffic
        self.batch_size = t["clips"] * t["draws_per_clip"]
        self.clips_per_unit = self.batch_size
        self.attempted = self.failed = 0
        self.kept = []  # (pass index, frames) of the passes to check
        self.pick = random.Random(weights.stream_seed(seed, "checked"))
        self.zgen = torch.Generator(device=self.device)
        self.ref_mod = load_module("reference", self.cfg["reference"])
        self.build_s = None
        self.produce = None

    def units_to_check(self):
        """Units a short run makes so that each is checked."""
        return self.traffic["checked_passes"]

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def draw(self):
        """The reference on meta and this seed's weights, as served."""
        ref = self.ref_mod.build(self.mc)
        return ref, weights.draw(ref.specs(), self.seed, self.device, self.dtype)

    def z(self, i):
        self.zgen.manual_seed(weights.stream_seed(self.seed, "z", i))
        return torch.randn((self.batch_size, *self.shape_z), generator=self.zgen,
                           device=self.device, dtype=self.dtype)

    def build_program(self, ref, values):
        """The port's model with this seed's weights: the system under test."""
        from ipoke_tpu_torch import entry
        from ipoke_tpu_torch.flows.base import ParamTree

        with torch.device("meta"):
            model = entry.make_model(self.mc)
        model = model.to_empty(device=self.device)
        nets = {k: v for k, v in values.items() if not k.startswith("flow_params.")}
        missing, unexpected = model.load_state_dict(nets, strict=False)
        missing = [m for m in missing if not m.startswith("flow_params.")]
        if missing or unexpected:
            raise RuntimeError(f"weights do not fit the port's model: missing {missing}, "
                               f"unexpected {unexpected}")
        if model.first_stage.n_gru_layers != self.mc["n_gru_layers"]:
            raise RuntimeError(f"the port builds {model.first_stage.n_gru_layers} GRU layers, "
                               f"the configuration states {self.mc['n_gru_layers']}")
        model.flow_params = ParamTree(ref.flow_tree(values))
        model = model.to(self.dtype).eval()
        length = self.mc["T"]
        return lambda batch, z: model.forward_sample(batch, length, z=z)

    def build_control(self, ref, values):
        """The reference in the control's precision, in the program's place."""
        from reference.precision import lower

        ref = self.load_reference(ref, values)
        tree = ref.flow_tree(values)

        def produce(batch, z):
            with lower(self.control):
                return ref.sample(tree, batch["images"].float(), batch["poke"].float(),
                                  z.float(), self.mc["T"])
        return produce

    def load_reference(self, ref, values):
        """``ref`` given ``values`` in fp32 (in place: the floats upcast)."""
        for k, v in values.items():
            if v.is_floating_point():
                values[k] = v.float()
        ref = ref.to_empty(device=self.device)
        ref.load_state_dict({k: v for k, v in values.items()
                             if not k.startswith("flow_params.")})
        return ref

    def setup(self):
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            from ipoke_tpu_torch.ops import _build

            _build.load()
            self.build_s = _build.build_seconds
        t1 = time.perf_counter()
        ref, values = self.draw()
        self.sync()
        t2 = time.perf_counter()
        flow_m = sum(int(np.prod(s)) for k, s, _ in ref.specs()
                     if k.startswith("flow_params.")) / 1e6
        if round(flow_m, 2) != self.cfg["flow_params_m"]:
            raise RuntimeError(f"{flow_m:.2f}M flow parameters, the configuration "
                               f"states {self.cfg['flow_params_m']}M")
        self.shape_z = ref.z_shape
        build = self.build_control if self.control else self.build_program
        self.produce = build(ref, values)
        del values
        self.sync()
        t3 = time.perf_counter()
        t, mc = self.traffic, self.mc
        self.pool = []
        for p in range(t["pool"]):
            rng = np.random.default_rng(weights.stream_seed(self.seed, "clips", p))
            b = make_batch(rng, batch_size=t["clips"], n_frames=mc["T"],
                           spatial_size=mc["spatial"])
            self.pool.append({k: torch.as_tensor(b[k]).repeat_interleave(
                t["draws_per_clip"], dim=0).to(self.device, self.dtype)
                for k in ("images", "poke")})
        for w in range(t["warm_passes"]):
            self.produce(self.pool[w % len(self.pool)], self.z(-1 - w))
        self.sync()
        print(f"set-up parts (s): kernels {t1 - t0:.3f}, weights {t2 - t1:.3f}, model "
              f"{t3 - t2:.3f}, clips and {t['warm_passes']} warm passes "
              f"{time.perf_counter() - t3:.3f}", file=sys.stderr)

    def unit(self, i):
        frames = self.produce(self.pool[i % len(self.pool)], self.z(i))
        bad = int((~torch.isfinite(frames).reshape(self.batch_size, -1).all(dim=1)).sum())
        self.sync()
        self.attempted += self.batch_size
        self.failed += bad
        k = self.traffic["checked_passes"]
        if len(self.kept) < k:
            self.kept.append((i, frames))
        else:
            j = self.pick.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, frames)

    @torch.no_grad()
    def check(self):
        """[(name, value, limit)]: the kept passes against the reference."""
        self.produce = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref, values = self.draw()
        ref = self.load_reference(ref, values)
        tree = ref.flow_tree(values)
        del values
        maes = []
        blk = self.traffic["reference_block"]
        for i, frames in self.kept:
            batch, z = self.pool[i % len(self.pool)], self.z(i)
            for a in range(0, self.batch_size, blk):
                want = ref.sample(tree, batch["images"][a:a + blk].float(),
                                  batch["poke"][a:a + blk].float(), z[a:a + blk].float(),
                                  self.mc["T"])
                got = frames[a:a + blk].float()
                maes.append((got - want).abs().flatten(1).mean(dim=1))
        maes = torch.cat(maes)
        self.check_s = time.perf_counter() - t0
        lim = self.cfg["limits"]
        return [("frames_mae", float(maes.mean()), lim["frames_mae"]),
                ("worst_clip_mae", float(maes.max()), lim["worst_clip_mae"])]
