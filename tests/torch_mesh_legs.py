"""Legs of ``tests/test_torch_parallel.py`` that its spawned ranks run
(``parallel.dryrun.launch`` pickles them by import path; this module
imports no JAX, so the ranks start without it)."""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ipoke_tpu_torch import ops
from ipoke_tpu_torch.convert import flow_params_shard, jax_flow_params
from ipoke_tpu_torch.core.optim import flow_adam
from ipoke_tpu_torch.flows import ParamTree, build_macow_transformer, flow_loss
from ipoke_tpu_torch.flows.base import tree_leaves, tree_map
from ipoke_tpu_torch.flows.macow import NICE2d
from ipoke_tpu_torch.parallel.comm import gather_slot
from ipoke_tpu_torch.parallel.dryrun import LR, _mesh, _np
from ipoke_tpu_torch.parallel.mesh import (
    average_grads,
    gather_params,
    make_mesh,
    mean_over_batch,
    shard_batch,
    shard_params,
)


def flow_step(flow, tree, x, h, mesh=None, lr: float = LR):
    """One flow-only NLL step (``tests/test_parallel.py``'s program): the
    density forward, the loss, its backward, the data-parallel gradient
    average on a mesh, one ``flow_adam`` (AMSGrad) update.  ``tree`` is the
    whole tree, cut to the rank's shard on a mesh; ``x`` and ``h`` the whole
    batch.  Returns (the whole batch's loss, the whole updated tree)."""
    if mesh is not None:
        tree = shard_params(tree, mesh)
        x, h = shard_batch((x, h), mesh)
    params = ParamTree(tree)
    tx = flow_adam(params.trainable(), lr)
    with contextlib.nullcontext() if mesh is None else mesh:
        z, ld = flow.forward(params.tree(), x, h)
        loss, log = flow_loss(z, ld)
        loss.backward()
    if mesh is None:
        tx.step()
        return loss.detach(), params.tree()
    average_grads(params.parameters(), mesh)
    tx.step()
    return mean_over_batch(log, mesh)["flow_loss"], gather_params(params.tree(), mesh)


def flow_leg(rank, device, arch, tree_np, x_np, h_np, kinds, model_parallel):
    """``flow_step`` of the flow ``arch`` from the numpy tree on the numpy
    batch on each mesh of ``kinds`` ("mesh": dp x tp, "hybrid": 2 slices),
    and in this process alone; rank 0 returns {kind: (loss, tree)} as
    numpy, "single" for the one-process step."""
    flow = build_macow_transformer(arch)
    put = lambda a: torch.tensor(np.asarray(a), device=device)  # a copy: steps update in place
    x, h = put(x_np), put(h_np)
    out = {}
    for kind in kinds + ("single",):
        mesh = None if kind == "single" else _mesh(kind, model_parallel)
        if mesh is not None:  # the converters' round trip of the whole tree
            back = jax_flow_params(flow_params_shard(tree_np, mesh, device), mesh)
            out[kind + "_roundtrip"] = all(
                np.array_equal(a, b) for a, b in
                zip(tree_leaves(back), tree_leaves(tree_np)))
        loss, tree = flow_step(flow, tree_map(put, tree_np), x, h, mesh)
        out[kind] = (float(loss.detach()), _np(tree))
    return out if rank == 0 else None


def _rel(a, b) -> float:
    """max |a - b| over max |b| (0 for two zero tensors)."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def coupling_leg(rank, device, c=16, hid=256, h_ch=8, hw=(4, 4), batch=2,
                 dtype="bfloat16", seed=0):
    """One NICE coupling, whole on every rank and split over a mesh whose
    model axis is the whole world: the sampling direction's output (K1 in
    its family, under no_grad), the train direction's output (K4 with its
    split backward, while autograd records) and the gradients of every
    input and leaf.  Returns the largest relative differences of the split
    from the whole, the split's w2 shape, and the ops' launch counts of the
    split runs."""
    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" \
        else torch.device(device)
    dt = getattr(torch, dtype)
    mesh = make_mesh(None, dist.get_world_size())
    gen = torch.Generator(device=dev).manual_seed(seed)
    nice = NICE2d(c, hidden_channels=hid, h_channels=h_ch)
    tree = nice.init(gen, dev)
    rnd = lambda *shape, std=1.0: std * torch.randn(shape, generator=gen, device=dev)
    tree["out"]["g"] = rnd(*tree["out"]["g"].shape, std=0.1)
    tree["out"]["b"] = rnd(*tree["out"]["b"].shape, std=0.01)
    tree = tree_map(lambda t: t.to(dt), tree)
    z = rnd(batch, *hw, nice.z1_channels).to(dt)
    h = rnd(batch, *hw, h_ch).to(dt)
    cot = rnd(batch, *hw, 2 * (c // 2)).to(dt)
    res, counts = {}, {}
    for name, m in (("whole", None), ("split", mesh)):
        params = tree if m is None else shard_params(tree, m)
        ops.reset_launches()
        with contextlib.nullcontext() if m is None else m:
            with torch.no_grad():
                sample = nice._raw_inference(params, z, h)
            leaves = [z, h, params["w1"], params["w2"], *params["out"].values()]
            leaves = [t.detach().requires_grad_() for t in leaves]
            p2 = {"w1": leaves[2], "w2": leaves[3],
                  "out": dict(zip(("v", "g", "b"), leaves[4:]))}
            train = nice._raw_train(p2, leaves[0], leaves[1])
            grads = torch.autograd.grad(train, leaves, cot)
        counts[name] = dict(ops.LAUNCHES)
        if m is not None:
            grads = list(grads)
            grads[3] = gather_slot(grads[3], m.index("model"), m.tp,
                                   m.group("model"), dim=3)
        res[name] = (sample, train, grads)
    (s1, t1, g1), (s2, t2, g2) = res["whole"], res["split"]
    names = ("z", "h", "w1", "w2", "v", "g", "b")
    return {"sample": _rel(s2, s1), "train": _rel(t2, t1),
            "grads": {n: _rel(b, a) for n, a, b in zip(names, g1, g2)},
            "w2_shard": tuple(shard_params(tree, mesh)["w2"].shape),
            "launches": counts["split"]}
