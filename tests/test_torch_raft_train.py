"""The port's RAFT training (``ipoke_tpu_torch/nn/raft.py``) against the
JAX package's, fp32 on the CPU:

* ``synthetic_flow_batch`` gives JAX's arrays from the same generator;
  ``sequence_loss``, ``warp_image`` and ``photometric_selfsup_loss``
  within 1e-5; ``core/optim.py``'s ``clip_by_global_norm_`` (the clip of
  RAFT's train step and of every ``_Adam``) is optax's
  ``clip_by_global_norm`` below and above the limit;
* three steps of ``make_raft_train_step`` against the JAX package's
  (jitted once: this file's one program) from the same weights (the port's
  ``state_dict`` through ``convert_torch_raft``) and batches, AdamW with the
  global-norm clip at a constant lr, each step from the JAX state: loss and
  EPE, the gradients (as AdamW's first moments) and the params (Adam's
  first steps move an entry by ~lr whatever its gradient's size, so a
  gradient that is rounding, as a conv bias under instance norm has, sets
  the sign of a full step: the ROADMAP's parity rule); see the test."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ipoke_tpu.nn import raft as jraft
from ipoke_tpu_torch.core import optim
from ipoke_tpu_torch.nn import raft as traft

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)
from test_torch_raft import SMALL, _nchw, _nhwc, _perturbed, _state

LR, STEPS = 1e-4, 3


def _batch(seed, n=2, size=32, shift=3.0):
    rng = np.random.default_rng(seed)
    return jraft.synthetic_flow_batch(rng, n, size, shift)


def test_synthetic_flow_batch_matches_jax():
    want = _batch(0)
    got = traft.synthetic_flow_batch(np.random.default_rng(0), 2, 32, 3.0)
    for k in ("image1", "image2", "flow"):
        assert got[k].shape == (2, 2 if k == "flow" else 3, 32, 32)
        np.testing.assert_array_equal(_nhwc(got[k]), np.asarray(want[k]))


def test_losses_and_warp_match_jax():
    b = _batch(1)
    rng = np.random.default_rng(2)
    preds = np.asarray(b["flow"])[None] + rng.normal(0, 1.5, (3, 2, 32, 32, 2)).astype(
        np.float32)
    tb = {k: _nchw(v) for k, v in b.items()}
    tpreds = torch.from_numpy(np.ascontiguousarray(preds.transpose(0, 1, 4, 2, 3)))
    np.testing.assert_allclose(
        float(traft.sequence_loss(tpreds, tb["flow"])),
        float(jraft.sequence_loss(jnp.asarray(preds), b["flow"])), rtol=1e-5)
    np.testing.assert_allclose(
        _nhwc(traft.warp_image(tb["image1"], tpreds[0])),
        np.asarray(jraft.warp_image(b["image1"], jnp.asarray(preds[0]))), atol=1e-5)
    for sw in (0.1, 0.02):
        np.testing.assert_allclose(
            float(traft.photometric_selfsup_loss(tpreds, tb["image1"], tb["image2"],
                                                 smooth_weight=sw)),
            float(jraft.photometric_selfsup_loss(jnp.asarray(preds), b["image1"],
                                                 b["image2"], smooth_weight=sw)),
            rtol=1e-5)


def test_clip_matches_optax():
    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) * 0.1 for s in ((4, 3), (5,), (2, 2))]
    clip = optax.clip_by_global_norm(1.0)
    for scale in (1.0, 30.0):  # global norm ~0.3, then ~9
        ps = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g * scale)
        optim.clip_by_global_norm_(ps, 1.0)
        want, _ = clip.update([jnp.asarray(g * scale) for g in grads], clip.init(None))
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def _flax_paths(net):
    """The flax path of each entry of the port's ``state_dict`` under
    ``convert_torch_raft``, found by converting a state whose tensors hold
    their own index."""
    keys = list(net.state_dict())
    tagged = jraft.convert_torch_raft({k: np.full(v.shape, i, np.float32)
                                       for i, (k, v) in enumerate(net.state_dict().items())})
    paths = {}
    for tree in tagged.values():
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            paths[keys[int(np.asarray(leaf).flat[0])]] = path
    missing = [k for k in keys if k not in paths]  # norm3: the same tensor as downsample.1
    for k in missing:
        paths[k] = paths[k.replace(".norm3.", ".downsample.1.")]
    return paths


def _port_leaf(tree, path):
    """The flax leaf at ``path`` in the port's layout (OIHW conv weights)."""
    for k in path:
        tree = tree[k.key]
    a = np.asarray(tree)
    return torch.tensor(a.transpose(3, 2, 0, 1) if a.ndim == 4 else a)


def test_train_steps_match_jax():
    """Each step starts from the JAX package's state (params and AdamW's
    count and moments loaded into the port): the JAX step itself is not
    reproducible on a loaded CPU (at lr 1e-3 its step-2 loss read 8.7256,
    8.8231 and 8.8264 from the same inputs), and Adam's first steps turn a gradient
    that is rounding into a full lr step of either sign.  Per step: loss and
    EPE within 1e-4 relative; every param within 2 lr of JAX's, at most 1%
    of them more than lr / 10 apart, each leaf by norm within 2 lr (steps x
    2 lr over the run: the ROADMAP's parity rule); cnet's BatchNorm
    statistics unchanged on both sides.  The gradients (clipped) are held
    to the port's own float64 step from the same state, by leaf norm within
    1e-4 of the leaf plus 1e-4 of the net's RMS gradient per root entry
    (fp32 reads 3e-6 relative on the weights; a conv bias under instance
    norm has a gradient of rounding and no effect): XLA's fp32 gradients
    of some leaves of this random net move from run to run and sit up to
    40% from the port (fnet.conv1's weight 5.7%, cnet.norm1's bias 31%),
    where the port reads 3e-6 from float64.  At lr 1e-3 the second step's
    state is ill-conditioned for fnet.conv1 in fp32 on both sides (the
    port 10% from float64), so the steps run at 1e-4."""
    cfg = traft.RAFTConfig(**SMALL)
    net = _perturbed(cfg).train()
    paths = _flax_paths(net)
    variables = jax.tree_util.tree_map(jnp.asarray, jraft.convert_torch_raft(_state(net)))
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(LR, weight_decay=1e-5))
    params, stats = variables["params"], variables["batch_stats"]
    opt = tx.init(params)
    j_step = jraft.make_raft_train_step(jraft.RAFT(jraft.RAFTConfig(**SMALL)), tx)
    torch_opt = traft.make_optimizer(net, LR)
    t_step = traft.make_raft_train_step(net, torch_opt)
    named = dict(net.named_parameters())
    stats0 = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    for i in range(STEPS):
        with torch.no_grad():  # the JAX state into the port
            for k, p in named.items():
                p.copy_(_port_leaf(params, paths[k]))
                if i:
                    st = torch_opt.state[p]
                    st["step"].fill_(int(opt[1][0].count))
                    st["exp_avg"].copy_(_port_leaf(opt[1][0].mu, paths[k]))
                    st["exp_avg_sq"].copy_(_port_leaf(opt[1][0].nu, paths[k]))
        before = {k: _port_leaf(params, paths[k]) for k in named}
        ref = copy.deepcopy(net).double()  # the same state in float64
        b = _batch(10 + i)
        tb = {k: _nchw(v) for k, v in b.items()}
        params, stats, opt, want = j_step(params, stats, opt, b, None)
        got = t_step(tb)
        _, (_, ups) = ref(tb["image1"].double(), tb["image2"].double(), with_intermediate=True)
        traft.sequence_loss(ups, tb["flow"].double()).backward()
        optim.clip_by_global_norm_(list(ref.parameters()), 1.0)
        g64 = dict(ref.named_parameters())
        rms = (sum(float((g.grad ** 2).sum()) for g in g64.values())
               / sum(g.numel() for g in g64.values())) ** 0.5
        for k, p in named.items():
            g = g64[k].grad
            err = float(torch.linalg.vector_norm(p.grad.double() - g))
            assert err <= 1e-4 * float(torch.linalg.vector_norm(g)) \
                + 1e-4 * rms * g.numel() ** 0.5, (i, k, err)
        for k in ("loss", "epe"):
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
        far, total, moved = 0, 0, 0
        for k, p in named.items():
            after = _port_leaf(params, paths[k])
            d = (p.detach() - after).abs()
            assert float(d.max()) <= 2 * LR * (1 + 1e-3), (i, k)
            assert float(torch.linalg.vector_norm(d)) <= 2 * LR * d.numel() ** 0.5, (i, k)
            far, total = far + int((d > LR / 10).sum()), total + d.numel()
            moved += int(((after - before[k]).abs() > LR / 2).sum())
        assert far <= 0.01 * total, (i, far, total)
        assert i or moved > total / 2, (moved, total)  # Adam's first step: ~lr an entry
    assert all(torch.equal(v, net.state_dict()[k]) for k, v in stats0.items())
    got_tree = jraft.convert_torch_raft(_state(net))
    jax.tree_util.tree_map(np.testing.assert_array_equal, got_tree["batch_stats"],
                           jax.tree_util.tree_map(np.asarray, stats))
