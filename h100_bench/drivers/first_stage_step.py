"""A closed loop of ``FirstStageTrainer.train_step`` calls, each waited for.

Set-up builds the trainer (the three nets and their Adams) from weights
drawn on the device, then drives it through its first ``checked_steps``
steps, each on another batch of the pool and with the step's draws from a
generator seeded for it: the warm-up, and what the reference follows.  The
window goes on with the same trainer over the pool in turn.

After the window the plain reference, from the same weights, batches and
draws, follows those first steps.  ``numbers`` reads both sides the same
way (the program's from its trainer's state); the configuration's
``limits`` name the ones compared:

* ``loss0_d_rel``: the largest relative gap of step 0's discriminator
  losses (the generator's no-grad forward and both discriminators, before
  any update);
* ``grad1_gap.<net>``: by the worst leaf of the net, the gap of the norms
  of the first gradient as the optimizer gets it (Adam's first moment
  after one step over 1 - beta1), against the reference's norm of that
  leaf or of the median leaf, whichever is larger; ``grad1_med_gap.<net>``
  the median leaf's gap;
* ``change3_gap``: as ``grad1_gap`` for the norm of each leaf's change
  over the checked steps, leaving out the leaves whose reference gradient
  is under a thousandth of the median leaf's (moved by round-off alone
  under Adam).

The generator's loss and gradient in step 0 see discriminators after one
Adam step, which moves every entry whose gradient is rounding by a whole
lr, so they part from the reference beyond rounding (as an fp32 reference
does from a float64 one); its gradient is held by the median leaf.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

import weights
from frozen.synthetic import make_batch
from harness import load_module


class Readings:
    """What one side's checked steps leave: losses per step, the first
    gradients' norms and the changes' norms by leaf name."""

    def __init__(self, named):
        self.p0 = {n: p.detach().clone() for n, p in named}
        self.losses, self.grad1, self.change = [], {}, {}

    def step(self, s, last, losses, named, state, beta1):
        self.losses.append({k: float(v) for k, v in losses.items()})
        if s == 0:  # a leaf the optimizer never stepped has no moment: 0
            self.grad1 = {n: float(state(p)["exp_avg"].norm()) / (1.0 - beta1)
                          if state(p) else 0.0 for n, p in named}
        if s == last:
            self.change = {n: float((p.detach() - self.p0[n]).norm()) for n, p in named}
            self.p0 = None


def gaps(got: dict, want: dict, keys):
    """|got - want| / max(want, median of want) for each of ``keys``."""
    med = float(np.median([want[k] for k in keys]))
    return [abs(got[k] - want[k]) / max(want[k], med, 1e-30) if math.isfinite(got[k])
            else math.inf for k in keys]


def worst_gap(got, want, keys):
    return max(gaps(got, want, keys))


def median_gap(got, want, keys):
    return float(np.median(gaps(got, want, keys)))


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30) if math.isfinite(a) else math.inf


def numbers(prog: Readings, ref: Readings) -> dict:
    """The numbers compared (the configuration's ``limits``) by name, and
    those that ``PERF.md`` gives as the look behind them: step 0's
    generator loss, every step's losses and the generator's worst leaf."""
    names = list(ref.grad1)
    med = float(np.median([ref.grad1[n] for n in names]))
    moved = [n for n in names if ref.grad1[n] >= 1e-3 * med]
    model = [n for n in names if n.startswith("model")]
    disc = [n for n in names if n.startswith("disc")]
    return {
        "loss0_d_rel": max(rel(prog.losses[0][k], ref.losses[0][k])
                           for k in ("loss_d_dt", "loss_d_ds")),
        "loss0_g_rel": rel(prog.losses[0]["loss"], ref.losses[0]["loss"]),
        "loss_rel": max(rel(p[k], r[k]) for p, r in zip(prog.losses, ref.losses) for k in r),
        "grad1_gap.disc": worst_gap(prog.grad1, ref.grad1, disc),
        "grad1_gap.model": worst_gap(prog.grad1, ref.grad1, model),
        "grad1_med_gap.model": median_gap(prog.grad1, ref.grad1, model),
        "change3_gap": worst_gap(prog.change, ref.change, moved),
    }


class Driver:
    def __init__(self, cell, seed, device, control=None):
        self.cfg, self.traffic = cell.config, cell.traffic
        t = self.traffic
        mc = self.cfg["model"]
        self.mc = dict(mc, data=dict(mc["data"], batch_size=t["batch"]))
        self.seed, self.device, self.control = seed, torch.device(device), control
        self.clips_per_unit = t["batch"]
        self.attempted = self.failed = 0
        self.ref_mod = load_module("reference", self.cfg["reference"])
        self.build_s = None
        self.check_s = 0.0
        self.run_step = None

    def units_to_check(self):
        return 0  # set-up makes the checked steps

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def gen(self, k):
        return torch.Generator(device=self.device).manual_seed(
            weights.stream_seed(self.seed, "draws", k))

    def draw(self):
        ref = self.ref_mod.build(self.mc)
        return ref, weights.draw(ref.specs(), self.seed, self.device, torch.float32)

    def reference(self, ref, values, tf32=False):
        """(step(batch, k) -> losses, named leaves, state(p), beta1) of the
        reference given ``values``; with ``tf32`` its products in TF32."""
        from reference.precision import lower

        nets = ref.to_empty(device=self.device)
        nets.load_state_dict(values)
        opts = self.ref_mod.adams(self.mc, nets)
        step = self.ref_mod.Step(self.mc, nets, opts)
        named = [(f"{n}.{k}", p) for n in self.ref_mod.NETS
                 for k, p in getattr(nets, n).named_parameters()]

        def run(batch, k):
            draws = self.ref_mod.sample_draws(self.gen(k), self.mc, self.traffic["batch"])
            if tf32:
                with lower("tf32"):
                    return step(batch, draws)
            return step(batch, draws)
        return run, named, lambda p: opts_state(opts, p), self.ref_mod.BETAS[0]

    def program(self, values):
        """The same of the port's trainer: the system under test."""
        from ipoke_tpu_torch.models.first_stage import build_first_stage
        from ipoke_tpu_torch.nn.vgg import VGG19Features
        from ipoke_tpu_torch.train import FirstStageTrainer

        with torch.device("meta"):
            model, d_s, d_t = build_first_stage(self.mc)
            vgg = VGG19Features()
        nets = {}
        for name, net in (("model", model), ("disc_s", d_s), ("disc_t", d_t), ("vgg", vgg)):
            net = net.to_empty(device=self.device)
            net.load_state_dict({k[len(name) + 1:]: v for k, v in values.items()
                                 if k.startswith(name + ".")})
            nets[name] = net
        trainer = FirstStageTrainer(self.mc, nets["model"], nets["disc_s"], nets["disc_t"],
                                    nets["vgg"])
        named = [(f"{n}.{k}", p) for n in ("model", "disc_s", "disc_t")
                 for k, p in nets[n].named_parameters()]
        opts = [tx.adam for tx in trainer.tx]
        beta1 = opts[0].param_groups[0]["betas"][0]
        return (lambda batch, k: trainer.train_step(batch, 0, self.gen(k)), named,
                lambda p: opts_state(opts, p), beta1)

    def replay(self, run, named, state, beta1):
        """The checked steps on their batches: their ``Readings``."""
        n = self.traffic["checked_steps"]
        rd = Readings(named)
        for s in range(n):
            rd.step(s, n - 1, run(self.pool[s], s), named, state, beta1)
        return rd

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
        if self.control:
            run, named, state, beta1 = self.reference(ref, values, tf32=True)
        else:
            run, named, state, beta1 = self.program(values)
        del values
        t, data = self.traffic, self.mc["data"]
        self.pool = []
        for p in range(t["pool"]):
            rng = np.random.default_rng(weights.stream_seed(self.seed, "clips", p))
            images = make_batch(rng, batch_size=t["batch"], n_frames=data["max_frames"],
                                spatial_size=data["spatial_size"][0])["images"]
            images += t["pixel_noise"] * rng.standard_normal(images.shape, np.float32)
            self.pool.append({"images": torch.as_tensor(np.clip(images, -1.0, 1.0))
                              .to(self.device)})
        self.sync()
        t3 = time.perf_counter()
        self.mine = self.replay(run, named, state, beta1)
        self.sync()
        self.run_step = run
        self.next = t["checked_steps"]
        print(f"set-up parts (s): kernels {t1 - t0:.3f}, weights {t2 - t1:.3f}, trainer "
              f"and clips {t3 - t2:.3f}, {t['checked_steps']} checked steps "
              f"{time.perf_counter() - t3:.3f}", file=sys.stderr)

    def unit(self, i):
        k = self.next + i
        losses = self.run_step(self.pool[k % len(self.pool)], k)
        ok = math.isfinite(float(losses["loss"]))
        self.sync()
        self.attempted += self.clips_per_unit
        self.failed += 0 if ok else self.clips_per_unit

    def check(self):
        """[(name, value, limit)]: the checked steps against the reference."""
        self.run_step = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref, values = self.draw()
        want = self.replay(*self.reference(ref, values))
        self.check_s = time.perf_counter() - t0
        self.numbers = numbers(self.mine, want)
        return [(k, self.numbers[k], lim) for k, lim in self.cfg["limits"].items()]


def opts_state(opts, p):
    """The optimizer state of ``p`` (empty before its first step)."""
    for o in opts:
        if p in o.state:
            return o.state[p]
    return {}
