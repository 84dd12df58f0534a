"""Train MotionFeatureNet, the default FVD backbone, on synthetic motion
clips and save its weights (the counterpart of ``tools/train_motion_feat.py``):

    python -m ipoke_tpu_torch.scripts.train_motion_feat [--steps 1500] \
        [--out motion_feat_v1.npz] [--device cuda|cpu]

Pretext tasks, as in the JAX package: the clips' motion statistics
(``motion_targets`` of ``data.synthetic.make_batch``'s exact flow maps, MSE),
the temporal order of clips against their frame-shuffled copies (binary
cross-entropy on the order logit), and a light uniformity term (0.1) that
keeps the features spread.  Adam at ``--lr``.  The npz loads in both
packages' ``load_motion_feat``.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.nn.functional as F


def pretext_loss(net, vids, vids_shuf, targets):
    """(loss, (regression, order loss, order accuracy))."""
    b = vids.shape[0]
    feat, motion, order = net(torch.cat([vids, vids_shuf]), return_heads=True)
    reg = torch.mean((motion[:b] - targets) ** 2)
    labels = torch.cat([torch.ones(b), torch.zeros(b)]).to(order)
    order_loss = F.binary_cross_entropy_with_logits(order, labels)
    fn = feat / (feat.norm(dim=-1, keepdim=True) + 1e-6)
    uniform = torch.mean(fn @ fn.t()) - 1.0 / feat.shape[0]
    acc = ((order > 0) == (labels > 0.5)).float().mean()
    return reg + order_loss + 0.1 * uniform, (reg, order_loss, acc)


def train(steps: int, batch: int = 16, frames: int = 10, spatial: int = 64,
          lr: float = 3e-4, seed: int = 0, device="cuda", log=print):
    """The trained net (with its heads) after ``steps`` Adam steps."""
    from ..data.synthetic import make_batch
    from ..nn.motion_feat import init_motion_feat, motion_targets

    device = torch.device(device)
    net = init_motion_feat(torch.Generator().manual_seed(seed), device)
    n = sum(p.numel() for p in net.parameters())
    log(f"motion feature net: {n / 1e3:.0f}k params on {device}")
    opt = torch.optim.Adam(net.parameters(), lr=lr)
    rng = np.random.default_rng(seed)
    t0 = time.time()
    for it in range(steps):
        b = make_batch(rng, batch_size=batch, n_frames=frames, spatial_size=spatial,
                       n_pokes=int(rng.integers(1, 4)))
        clips = np.asarray(b["images"][:, 1:])
        perm = rng.permuted(np.tile(np.arange(frames), (batch, 1)), axis=1)
        shuf = np.take_along_axis(clips, perm[:, :, None, None, None], axis=1)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        loss, (reg, ol, acc) = pretext_loss(net, as_t(clips), as_t(shuf),
                                            as_t(motion_targets(b["flow"])))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if it % 100 == 0 or it == steps - 1:
            log(f"step {it}: loss {loss.item():.4f} reg {reg.item():.4f} order "
                f"{ol.item():.4f} order-acc {acc.item():.2f} ({time.time() - t0:.0f}s)")
    return net


def main(argv=None) -> int:
    from ..main import check_device
    from ..nn.motion_feat import save_motion_feat

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--spatial", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="motion_feat_v1.npz")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = p.parse_args(argv)
    check_device(a.device)
    net = train(a.steps, a.batch, a.frames, a.spatial, a.lr, a.seed, a.device)
    out = os.path.abspath(a.out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_motion_feat(net, out)
    print(f"saved {out} ({os.path.getsize(out) / 1e6:.2f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
