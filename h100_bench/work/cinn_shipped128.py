"""Work counts of a ``forward_sample`` pass of the configuration at the
traffic's batch, from shapes alone: K1's launches (each NICE coupling's
three products, ``nice_work``), K2's (each MaCowUnit, ``unit_work``), and
the FLOPs a pass needs: the couplings' products, the masked-conv flows'
conditioning rows, and the encoders and the decode counted by
``torch.utils.flop_counter`` on the plain reference over meta tensors.
The flow's products are counted once, as their forward would run them:
what an inverse recomputes is not work the math needs."""

from __future__ import annotations

import torch
from frozen.work import FlopCount, nice_work, unit_work
from harness import load_module


def flow_launches(mc, batch):
    """([K1 (bytes, flops)], [K2 (bytes, flops)], conditioning-row flops)
    of one pass; bytes and flops of the kernels as ``frozen.work`` counts
    them."""
    s, z, hid = mc["min_spatial"], mc["z_dim"], mc["mid_factor"] * mc["z_dim"]
    factor, ch = mc.get("factor", 16), 2 * mc["nf_cond"]
    m = batch * s * s
    k1, k2, cond = [], [], 0
    c = z
    for n in mc["num_steps"]:
        half = c // 2
        k1 += [nice_work(m, 9 * (c - half), hid, 9 * 2 * half)] * (4 * n)
        k2 += [unit_work(batch, s, c, 4 * c)] * (4 * n)
        cond += 4 * n * 4 * 2 * m * ch * 2 * c
        out = c // factor
        k1.append(nice_work(m, 9 * (c - out), hid, 9 * 2 * out))
        c -= z // mc.get("factor", 16)
        factor -= 1
    return k1, k2, cond


def counts(config, traffic):
    mc = config["model"]
    batch = traffic["clips"] * traffic["draws_per_clip"]
    k1, k2, cond = flow_launches(mc, batch)
    ref = load_module("reference", config["reference"]).build(mc)
    s, t = mc["spatial"], mc["T"]
    with torch.device("meta"):
        images = torch.empty(batch, t + 1, s, s, 3)
        poke = torch.empty(batch, s, s, 2)
        motion = torch.empty(batch, mc["min_spatial"], mc["min_spatial"], mc["z_dim"])
    with FlopCount() as fc, torch.no_grad():
        ref.conditioner.encoder(images[:, 0])
        ref.poke_embedder.encoder(poke)
        ref.first_stage.decode(motion, images[:, 0], t)
    nets = fc.total
    return {"k1": k1, "k2": k2, "nets_flops": nets,
            "flops_per_unit": sum(f for _, f in k1) + sum(f for _, f in k2) + cond + nets}
