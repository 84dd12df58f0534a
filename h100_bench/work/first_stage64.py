"""Work counts of a first-stage VAE-GAN step at the traffic's batch: the
FLOPs the step's math needs, counted by ``frozen.work.FlopCount`` on the
plain reference's step over meta tensors (the products of every forward,
backward and the R1 penalty's double backward), less one forward of the
generator: the program runs it twice a step (a no-grad pass for the fake
videos, then again with grad), the math needs it once."""

from __future__ import annotations

import torch
from frozen.work import FlopCount
from harness import load_module


class _NoStep:
    """Stands for an optimizer: counts its gradients, moves nothing."""

    def __init__(self, params):
        self.param_groups = [{"params": list(params)}]

    def step(self):
        pass

    def zero_grad(self, set_to_none=True):
        for p in self.param_groups[0]["params"]:
            p.grad = None


def counts(config, traffic):
    ref_mod = load_module("reference", config["reference"])
    mc = dict(config["model"], data=dict(config["model"]["data"], batch_size=traffic["batch"]))
    nets = ref_mod.build(mc)
    data, arch = mc["data"], mc["architecture"]
    b, t, s = traffic["batch"], data["max_frames"], data["spatial_size"][0]
    m = arch["min_spatial_size"]
    n_ex = mc["d_s"].get("n_examples", 16)
    with torch.device("meta"):
        X = torch.empty(b, t + 1, s, s, 3)
        draws = {"noise": torch.empty(b, m, m, arch["z_dim"]), "offset": 0,
                 "idx_t": torch.zeros(n_ex, dtype=torch.long),
                 "idx_f": torch.zeros(n_ex, dtype=torch.long)}
    step = ref_mod.Step(mc, nets, [_NoStep(getattr(nets, n).parameters())
                                   for n in ref_mod.NETS])
    with FlopCount() as whole:
        step({"images": X}, draws)
    with FlopCount() as gen, torch.no_grad():
        nets.model(X, draws["noise"], train=True)
    return {"flops_per_unit": whole.total - gen.total, "generator_forward_flops": gen.total}
