#!/usr/bin/env python3
"""Time the port's SHIPPED sampling pass and train step from the checkout
at the given path, as ``chip_smoke.py`` phases (e) and (g) do (host clock
around 3 passes closed by a synchronize; CUDA events around 3 train steps;
each after one warm call).  One JSON line.  For an A/B on one card, run it
on two checkouts in turns in one session:

    for t in parent . . parent; do python3 tools/torch_ab_shipped.py $t; done
"""

import json
import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from ipoke_tpu_torch import entry  # noqa: E402
from ipoke_tpu_torch.core.optim import warmup_linear_decay  # noqa: E402
from ipoke_tpu_torch.train import SecondStageTrainer  # noqa: E402


def main():
    if not entry.__file__.startswith(ROOT):
        raise RuntimeError(f"imported {entry.__file__}, not the checkout {ROOT}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = entry.SHIPPED
    gen = torch.Generator(device=dev).manual_seed(0)
    model = entry.build(cfg, dev, gen)
    entry.perturb(model, gen)
    model = model.to(torch.bfloat16)
    batch = entry.make_batch(cfg, dev, torch.bfloat16, seed=0)
    model.forward_sample(batch, cfg["T"], gen)
    torch.cuda.synchronize()
    passes = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.forward_sample(batch, cfg["T"], gen)
        torch.cuda.synchronize()
        passes.append(1e3 * (time.perf_counter() - t0))
    del model

    gen = torch.Generator(device=dev).manual_seed(0)
    model = entry.build(cfg, dev, gen)
    batch = entry.make_batch(cfg, dev, seed=0)
    trainer = SecondStageTrainer(model, warmup_linear_decay(1e-3, 500, 200000))
    trainer.ddi(batch, gen)
    entry.perturb(model, gen)
    trainer.start()
    trainer.train_step(batch, gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    steps = []
    for _ in range(3):
        start.record()
        trainer.train_step(batch, gen)
        end.record()
        torch.cuda.synchronize()
        steps.append(start.elapsed_time(end))
    print(json.dumps({"checkout": sys.argv[1] if len(sys.argv) > 1 else ".",
                      "device": torch.cuda.get_device_name(0),
                      "ms_per_pass": passes, "mean_ms_per_pass": sum(passes) / 3,
                      "ms_per_step": steps, "mean_ms_per_step": sum(steps) / 3}))


if __name__ == "__main__":
    main()
