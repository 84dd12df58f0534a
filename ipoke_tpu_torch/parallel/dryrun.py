"""A sharded second-stage step on a dp x tp mesh, against one process
(counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m ipoke_tpu_torch.parallel.dryrun --n N [--device cpu|cuda]
        [--backend gloo|nccl] [--model_parallel MP]

starts N ranks, one process each, joined over ``tcp://localhost`` (NCCL and
one rank a device on the card; gloo on the CPU), and runs three legs:

1. at ``TOY`` (the JAX dryrun's toy shapes) one dp x tp second-stage train
   step and a ``forward_sample(length=3)``, each held within 2e-4 of the
   same step and pass in one process on every rank (``toy_leg``);
2. the same step on a hybrid ``(slice, data, model)`` mesh of 2 slices,
   where N splits so;
3. the SHIPPED model (1054M flow params) built on ``meta`` and cut by
   ``flow_param_specs`` at tp = 2 and 4: each rank's parameter bytes,
   nothing allocated (``shipped_shard_bytes``).

Nothing falls back: on the card N above ``torch.cuda.device_count()``
raises unless ``--backend gloo`` is given (NCCL takes one rank a device),
and NCCL refuses the CPU.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import entry
from ..flows.base import tree_leaves, tree_map
from .mesh import (
    Mesh,
    gather_params,
    make_hybrid_mesh,
    make_mesh,
    shard_batch,
    shard_params,
)

# the JAX dryrun's toy second stage (``_dryrun_multichip_impl``), in fp32,
# at channel factor 4: its factor 16 of 8 channels factors out none, an
# empty conv that torch refuses
TOY = dict(spatial=32, min_spatial=4, T=3, z_dim=8, enc_ch=(16, 16, 32, 32),
           dec_ch=(32, 32, 16, 16), nf_cond=16, num_steps=(1, 1), mid_factor=4,
           factor=4, mixed=False)
TOL, LR = 2e-4, 1e-3  # the comparisons' tolerance, the steps' constant lr


def check_backend(n: int, device: str, backend=None) -> str:
    """The backend for ``n`` ranks on ``device``: NCCL on the card unless
    ``backend`` says gloo, which the CPU needs.  NCCL takes one rank a
    device, so more ranks than cards raise."""
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if device == "cpu" and backend == "nccl":
        raise ValueError("NCCL runs on the card only: --device cpu takes gloo")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no card (torch.cuda.is_available() "
                               "is false); --device cpu runs on the CPU")
        cards = torch.cuda.device_count()
        if backend == "nccl" and n > cards:
            raise ValueError(
                f"--n {n} ranks over NCCL on {cards} card(s): NCCL takes one rank "
                "a device; pass --backend gloo to run several ranks on one card")
    return backend


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, fn, n, device, backend, port, args, queue):
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        # fp32 products in fp32 (as main.run): a rank's run is compared
        # with one process, whose convs may take other algorithms
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=n, rank=rank)
    try:
        queue.put((rank, fn(rank, device, *args)))
    finally:
        dist.destroy_process_group()


def launch(fn, n: int, device: str = "cuda", backend=None, args=()) -> list:
    """Run ``fn(rank, device, *args)`` on ``n`` spawned ranks of one process
    group; returns their results in rank order.  ``fn`` and its results are
    pickled, so ``fn`` is a module-level function of an importable module."""
    backend = check_backend(n, device, backend)
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_worker,
                         args=(r, fn, n, device, backend, port, args, queue))
             for r in range(n)]
    for p in procs:
        p.start()
    out = {}
    try:
        while len(out) < n:
            if queue.empty() and any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError(f"a rank failed: exit codes {[p.exitcode for p in procs]}")
            if queue.empty():
                time.sleep(0.05)
                continue
            rank, res = queue.get()
            out[rank] = res
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(n)]


def _mesh(kind: str, model_parallel: int) -> Mesh:
    if kind == "hybrid":
        return make_hybrid_mesh(2, model_parallel)
    return make_mesh(None, model_parallel)


def _np(tree):
    return tree_map(lambda t: t.detach().float().cpu().numpy(), tree)


def _max_diff(a, b) -> float:
    return max(float(np.max(np.abs(x - y))) for x, y in
               zip(tree_leaves(_np(a)), tree_leaves(_np(b))))


def legs(rank, device, calls):
    """Several legs in one process group: ``calls`` is a list of (fn,
    args); returns their results in order."""
    return [fn(rank, device, *args) for fn, args in calls]


def toy_leg(rank, device, kind: str = "mesh", model_parallel: int = 2, cfg=None):
    """One second-stage train step of ``cfg`` (``TOY``) on this rank's slice
    and shard of the mesh ``kind``, and a ``forward_sample(length=3)`` with
    the updated params, against the same step and pass on the whole batch
    in this process.  Every rank returns the loss of both, the largest
    difference of the updated params (gathered) and of the videos, and the
    mesh's shape."""
    from ..train import SecondStageTrainer

    dev = torch.device(device, torch.cuda.current_device()) if device == "cuda" \
        else torch.device(device)
    mesh = _mesh(kind, model_parallel)
    cfg = dict(cfg or TOY, batch_size=2 * mesh.dp)
    batch = entry.make_batch(cfg, dev)
    res = {}
    for name, m in (("single", None), ("sharded", mesh)):
        model = entry.build(cfg, dev, torch.Generator(device=dev).manual_seed(0))
        trainer = SecondStageTrainer(model, LR, mesh=m)
        trainer.ddi(batch)
        entry.perturb(model.flow_params, torch.Generator(device=dev).manual_seed(1))
        trainer.start()
        log = trainer.train_step(batch if m is None else shard_batch(batch, m))
        tree = model.flow_params.tree()
        if m is not None:
            tree = gather_params(tree, m)
        video = model.forward_sample(batch, 3, torch.Generator(device=dev).manual_seed(2),
                                     mesh=m)
        res[name] = (float(log["flow_loss"]), tree, video)
    (l1, t1, v1), (l2, t2, v2) = res["single"], res["sharded"]
    return {"shape": dict(mesh.shape), "loss": l1, "loss_sharded": l2,
            "params": _max_diff(t1, t2),
            "video": float((v1.float() - v2.float()).abs().max()),
            "video_shape": tuple(v2.shape), "finite": bool(torch.isfinite(v2).all())}


def shipped_shard_bytes(tp: int, cfg=None) -> dict:
    """The SHIPPED flow's parameter bytes on each model rank at ``tp``,
    built on ``meta`` (no memory) and cut by ``flow_param_specs``: {"whole":
    bytes, "ranks": [bytes of rank r]} in fp32."""
    model = entry.build(cfg or entry.SHIPPED, "meta")
    tree = model.flow_params.tree()
    size = lambda t: sum(x.numel() * 4 for x in tree_leaves(t))
    ranks = []
    for r in range(tp):
        mesh = Mesh(("data", "model"), {"data": 1, "model": tp},
                    {"data": 0, "model": r}, {})
        ranks.append(size(shard_params(tree, mesh)))
    return {"whole": size(tree), "ranks": ranks}


def check(res: dict, what: str, param_tol: float = TOL) -> None:
    """Raise unless the sharded step and pass of ``toy_leg`` agree with the
    single process within ``TOL`` (the updated params within
    ``param_tol``)."""
    rel = abs(res["loss"] - res["loss_sharded"]) / max(abs(res["loss"]), 1e-12)
    if not (rel <= TOL and res["params"] <= param_tol and res["video"] <= TOL
            and res["finite"]):
        raise AssertionError(f"{what}: sharded against one process out of {TOL}: {res}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    p.add_argument("--model_parallel", type=int, default=None)
    args = p.parse_args(argv)
    check_backend(args.n, args.device, args.backend)
    mp_ = args.model_parallel or (2 if args.n % 2 == 0 else 1)
    t0 = time.perf_counter()
    res = launch(toy_leg, args.n, args.device, args.backend, ("mesh", mp_))
    check(res[0], "dp x tp")
    print(f"dryrun ok: mesh={res[0]['shape']} loss={res[0]['loss_sharded']:.6f} "
          f"(one process {res[0]['loss']:.6f}) max param diff {res[0]['params']:.2e} "
          f"video {res[0]['video_shape']} max diff {res[0]['video']:.2e} "
          f"({time.perf_counter() - t0:.1f} s)")
    if args.n % (2 * mp_) == 0:
        t0 = time.perf_counter()
        res = launch(toy_leg, args.n, args.device, args.backend, ("hybrid", mp_))
        check(res[0], "hybrid")
        print(f"hybrid (slice, data, model) ok: mesh={res[0]['shape']} "
              f"loss={res[0]['loss_sharded']:.6f} max param diff {res[0]['params']:.2e} "
              f"({time.perf_counter() - t0:.1f} s)")
    for tp in (2, 4):
        b = shipped_shard_bytes(tp)
        print(f"SHIPPED flow at tp={tp} on meta: whole {b['whole'] / 2**20:.1f} MiB, "
              "each rank " + ", ".join(f"{x / 2**20:.1f}" for x in b["ranks"])
              + " MiB (fp32)")


if __name__ == "__main__":
    sys.exit(main())
