"""The port's RAFT (``ipoke_tpu_torch/nn/raft.py``) against the JAX
package's, fp32 on the CPU, the same weights carried by the JAX package's
``convert_torch_raft`` from the port's ``state_dict``:

* ``corr_pyramid``, ``bilinear_sample`` (zero padding past every edge),
  ``corr_lookup`` (the window's channel order at r = 2, a 1-pixel level)
  and ``convex_upsample`` within 1e-5;
* the forward at a small ``RAFTConfig`` on 32x32 images, cnet's BatchNorm
  statistics and affine drawn at random and every conv bias off zero: the
  final flow and every iteration's flow and upsampled flow within 1e-4
  abs + rel;
* ``raft_estimator`` on a 30x34 uint8 pair: float32 (2, 30, 34), and with
  an official-layout npz (``tests/test_raft.py``'s recipe) named by
  ``IPOKE_RAFT_WEIGHTS`` for both packages, JAX's flow within
  ``EST_MAX_TOL`` of its largest and ``EST_MEAN_TOL`` of its mean
  magnitude (below); ``load_torch_raft_npz`` takes the npz's DataParallel
  prefix, BatchNorm counters and either name of a projection norm.

The estimator's JAX side is this file's one jitted program (JAX's own
``jax.jit``); the others run eagerly (``jax.disable_jit``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.nn import raft as jraft
from ipoke_tpu_torch.nn import raft as traft

from test_raft import _synth_torch_state
from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

# The estimator runs the default config's 12 iterations, and on these
# synthesized weights fp32 rounding grows ~10x every 3 iterations: against
# the port's float64 forward, the port's fp32 flow reads 5.7e-6 max at 1
# iteration, 1.7e-4 at 6 and 1.1e-2 at 12 (2.2e-3 mean), JAX's 5.8e-3 max
# (1.2e-3 mean), on flows of 20 px mean and 67 px max magnitude; the two
# fp32 results are 5.7e-3 max and 1.3e-3 mean apart.  So the bounds are
# relative to the flow: 5e-4 of its largest magnitude for the largest error
# and 2e-4 of its mean magnitude for the mean error.  A wrong layout, lookup
# or crop moves the flow by O(its size).  The 3-iteration forward below
# holds the same net within 1e-4.
EST_MAX_TOL, EST_MEAN_TOL = 5e-4, 2e-4
SMALL = dict(base=16, feature_dim=32, hidden_dim=32, context_dim=32, corr_levels=2,
             corr_radius=2, iters=3)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return np.asarray(t.detach()).transpose(0, 2, 3, 1)


def _state(net):
    return {k: v.detach().numpy() for k, v in net.state_dict().items()}


def test_corr_pyramid_matches_jax():
    rng = np.random.default_rng(0)
    f1, f2 = (rng.standard_normal((2, 4, 5, 8)).astype(np.float32) for _ in range(2))
    want = jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), num_levels=3)
    got = traft.corr_pyramid(_nchw(f1), _nchw(f2), num_levels=3)
    assert [g.shape[2:] for g in got] == [(4, 5), (2, 2), (1, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), atol=1e-5)


def test_bilinear_sample_matches_jax():
    """Points inside, on and past every edge and corner: zero padding per
    corner, as JAX and F.grid_sample(zeros, align_corners=True) do."""
    rng = np.random.default_rng(1)
    img = rng.standard_normal((2, 5, 6, 3)).astype(np.float32)
    pts = np.concatenate([rng.uniform(-1.5, 6.5, (2, 40, 2)),
                          np.broadcast_to([[-0.5, 2.0], [5.5, 2.0], [2.0, -0.5], [2.0, 4.5],
                                           [-1.0, -1.0], [6.0, 5.0], [5.0, 4.0], [0.0, 0.0]],
                                          (2, 8, 2))], axis=1).astype(np.float32)
    want = np.asarray(jraft.bilinear_sample(jnp.asarray(img), jnp.asarray(pts)))
    got = traft.bilinear_sample(_nchw(img), torch.from_numpy(pts)).numpy().transpose(0, 2, 1)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.all(got[:, -4:-2] == 0)  # a full pixel past the corners
    grid = torch.from_numpy(pts / np.float32([5, 4]) * 2 - 1)[:, :, None]
    ref = torch.nn.functional.grid_sample(_nchw(img), grid, padding_mode="zeros",
                                          align_corners=True)[..., 0]
    np.testing.assert_allclose(got, ref.numpy().transpose(0, 2, 1), atol=1e-5)


def test_corr_lookup_matches_jax():
    rng = np.random.default_rng(2)
    f1, f2 = (rng.standard_normal((2, 4, 6, 8)).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-3, 9, (2, 4, 6, 2)).astype(np.float32)
    want = jraft.corr_lookup(jraft.corr_pyramid(jnp.asarray(f1), jnp.asarray(f2), 3),
                             jnp.asarray(coords), radius=2)
    got = traft.corr_lookup(traft.corr_pyramid(_nchw(f1), _nchw(f2), 3), _nchw(coords),
                            radius=2)
    assert got.shape == (2, 3 * 25, 4, 6)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


def test_convex_upsample_matches_jax():
    rng = np.random.default_rng(3)
    flow = rng.standard_normal((2, 3, 4, 2)).astype(np.float32)
    mask = rng.standard_normal((2, 3, 4, 576)).astype(np.float32)
    want = jraft.convex_upsample(jnp.asarray(flow), jnp.asarray(mask))
    got = traft.convex_upsample(_nchw(flow), _nchw(mask))
    assert got.shape == (2, 2, 24, 32)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5)


def _perturbed(cfg, seed=0):
    """``init_raft`` with cnet's BatchNorms drawn (scale 1 + 0.1 N, bias and
    mean 0.1 N, var 1 + 0.1 |N|) and every conv bias 0.05 N."""
    net = traft.init_raft(cfg, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            n = torch.randn(t.shape, generator=gen)
            if ".norm" in name or ".downsample.1." in name:
                t.copy_({"weight": 1 + 0.1 * n, "bias": 0.1 * n, "running_mean": 0.1 * n,
                         "running_var": 1 + 0.1 * n.abs()}[name.rsplit(".", 1)[1]])
            elif name.endswith(".bias"):
                t.copy_(0.05 * n)
    return net


def test_raft_forward_matches_jax():
    cfg = traft.RAFTConfig(**SMALL)
    net = _perturbed(cfg).eval()
    rng = np.random.default_rng(4)
    im1, im2 = (rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32) for _ in range(2))
    with torch.no_grad():
        final, (flows, ups) = net(_nchw(im1), _nchw(im2), with_intermediate=True)
    variables = jax.tree_util.tree_map(jnp.asarray, jraft.convert_torch_raft(_state(net)))
    with jax.disable_jit():
        j_final, (j_flows, j_ups) = jraft.RAFT(jraft.RAFTConfig(**SMALL)).apply(
            variables, jnp.asarray(im1), jnp.asarray(im2), with_intermediate=True)
    assert ups.shape == (3, 2, 2, 32, 32) and flows.shape == (3, 2, 2, 4, 4)
    assert np.abs(np.asarray(j_final)).max() > 0.1
    np.testing.assert_allclose(_nhwc(final), np.asarray(j_final), rtol=1e-4, atol=1e-4)
    for i in range(3):
        np.testing.assert_allclose(_nhwc(flows[i]), np.asarray(j_flows[i]), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(_nhwc(ups[i]), np.asarray(j_ups[i]), rtol=1e-4,
                                   atol=1e-4)


def test_train_mode_keeps_cnet_statistics():
    """``train()`` leaves cnet's BatchNorm on its running statistics (the JAX
    package's ``use_running_average=True`` in its steps too)."""
    net = _perturbed(traft.RAFTConfig(**SMALL))
    x = torch.rand(2, 3, 32, 32) * 2 - 1
    before = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        a = net.train().cnet(x)
        b = net.eval().cnet(x)
    assert torch.equal(a, b)
    assert all(torch.equal(before[k], v) for k, v in net.state_dict().items())


@pytest.fixture
def official_npz(tmp_path, monkeypatch):
    """``tests/test_raft.py``'s official-layout state at the default
    config, with the DataParallel prefix, named by ``IPOKE_RAFT_WEIGHTS``;
    both packages' estimator caches emptied."""
    state = _synth_torch_state(jraft.RAFTConfig())
    path = str(tmp_path / "raft.npz")
    np.savez(path, **{f"module.{k}": v for k, v in state.items()})
    monkeypatch.setenv("IPOKE_RAFT_WEIGHTS", path)
    monkeypatch.setattr(jraft, "_RAFT_CACHE", {})
    monkeypatch.setattr(traft, "_RAFT_CACHE", {})
    return path, state


def _pair(seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 255, (30, 34, 3), dtype=np.uint8) for _ in range(2))


def test_raft_estimator_contract(monkeypatch):
    monkeypatch.delenv("IPOKE_RAFT_WEIGHTS", raising=False)
    monkeypatch.setattr(traft, "_RAFT_CACHE", {})
    flow = traft.raft_estimator(*_pair(5), device="cpu")
    assert flow.shape == (2, 30, 34) and flow.dtype == np.float32
    assert np.isfinite(flow).all()
    assert list(traft._RAFT_CACHE) == [("cpu", None)]
    a, b = (np.ascontiguousarray(im[:16, :24]) for im in _pair(6))  # one net for every size
    assert traft.raft_estimator(a, b, device="cpu").shape == (2, 16, 24)
    assert list(traft._RAFT_CACHE) == [("cpu", None)]


def test_raft_estimator_matches_jax_with_official_weights(official_npz):
    a, b = _pair(6)
    got = traft.raft_estimator(a, b, device="cpu")
    want = jraft.raft_estimator(a, b)
    assert got.shape == want.shape == (2, 30, 34) and got.dtype == np.float32
    err = np.abs(got - want)
    assert err.max() <= EST_MAX_TOL * np.abs(want).max(), (err.max(), np.abs(want).max())
    assert err.mean() <= EST_MEAN_TOL * np.abs(want).mean(), (err.mean(), np.abs(want).mean())


def test_load_torch_raft_npz_takes_official_names(official_npz, tmp_path):
    """The npz of an official checkpoint names cnet's projection norms
    ``downsample.1`` as well as (or instead of) ``norm3`` and carries
    ``num_batches_tracked``: the same net loads."""
    path, state = official_npz
    alias = {}
    for k, v in state.items():
        alias[k.replace(".norm3.", ".downsample.1.") if k.startswith("cnet") else k] = v
        if k.endswith("running_var"):
            alias[k.replace("running_var", "num_batches_tracked")] = np.int64(7)
    other = str(tmp_path / "official.npz")
    np.savez(other, **alias)
    a, b = traft.load_torch_raft_npz(path), traft.load_torch_raft_npz(other)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.equal(sa["cnet.layer2.0.norm3.running_mean"],
                       torch.from_numpy(state["cnet.layer2.0.norm3.running_mean"]))
