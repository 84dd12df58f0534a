"""The port's I3D and FVD backbones against the JAX package's, fp32 on the
CPU, with the same variables (numpy values over the JAX shapes, carried by
``convert.load_flax``: kernels, BatchNorm scale/bias and running
mean/var) and clips from numpy seeds:

* logits and 1024-d features at 32 px, and at an odd size (7 frames of
  27 x 29) whose stride-2 stem and pools pad asymmetrically under
  TF-SAME: 1e-4;
* FVD over the I3D and over the packaged MotionFeatureNet, through the
  port's ``init_fvd_backbone`` priority and ``backbone_activations``:
  1e-3 relative;
* the kinetics npz loader against the JAX package's on one random npz in
  the reference's torch layout, written here: the same weights.

The JAX I3D is this file's one jitted program (``_jax_i3d``; the FVD is
``compute_fvd``'s composition of the JAX package's moments and distance
over its logits); the MotionFeatureNet runs eagerly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.eval import backbone as jbackbone
from ipoke_tpu.eval import i3d as ji3d
from ipoke_tpu.eval import metrics as jm
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.eval import backbone as tbackbone
from ipoke_tpu_torch.eval import i3d as ti3d
from ipoke_tpu_torch.eval import metrics as tm

from test_torch_ops import _jnp

K = jax.random.PRNGKey
_jax_i3d = jax.jit(lambda v, x: ji3d.I3D().apply(v, x, return_features=True))


def _variables(seed=0):
    """I3D variables: He-scaled kernels, BN scale 1 + 0.1 N, bias and mean
    0.1 N, var 1 + 0.1 |N|; the dense head fan-in scaled."""
    shapes = jax.eval_shape(lambda: ji3d.I3D().init(K(0), jnp.zeros((1, 8, 32, 32, 3))))
    rng = np.random.default_rng(seed)

    def fill(tree, stats=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, stats)
                continue
            n = rng.standard_normal(v.shape).astype(np.float32)
            if k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = n * np.float32((2.0 / fan_in) ** 0.5) if len(v.shape) == 5 \
                    else n * np.float32(fan_in ** -0.5)
            elif k == "scale":
                out[k] = 1.0 + 0.1 * n
            elif k == "var":
                out[k] = 1.0 + 0.1 * np.abs(n)
            else:  # bias, mean
                out[k] = 0.1 * n
        return out

    return {"params": fill(shapes["params"]),
            "batch_stats": fill(shapes["batch_stats"], stats=True)}


def _clips(seed, shape):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(shape) * 0.5, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    values = _variables()
    net = ti3d.I3D()
    load_flax(net, values["params"], values["batch_stats"])
    return _jnp(values), net.eval()


def test_same_pads_match_flax():
    """TF-SAME per axis: total max((ceil(n/s)-1) s + k - n, 0), low half
    first (``F.pad`` takes the last axis first)."""
    assert ti3d._same_pads((10, 32, 32), (7, 7, 7), (2, 2, 2)) == [2, 3, 2, 3, 2, 3]
    assert ti3d._same_pads((7, 27, 29), (7, 7, 7), (2, 2, 2)) == [3, 3, 3, 3, 3, 3]
    assert ti3d._same_pads((5, 8, 8), (1, 3, 3), (1, 2, 2)) == [0, 1, 0, 1, 0, 0]
    x = torch.arange(2 * 5 * 7 * 9 * 3, dtype=torch.float32).reshape(2, 5, 7, 9, 3)
    want = jax.lax.reduce_window(
        jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max, (1, 3, 3, 3, 1), (1, 2, 2, 2, 1),
        "SAME")
    np.testing.assert_array_equal(ti3d.max_pool_same(x, (3, 3, 3), (2, 2, 2)).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("shape", [(2, 10, 32, 32, 3), (1, 7, 27, 29, 3)])
def test_i3d_matches_jax(pair, shape):
    values, net = pair
    x = _clips(1, shape)
    want_logits, want_feats = _jax_i3d(values, jnp.asarray(x))
    with torch.no_grad():
        logits, feats = net(torch.tensor(x), return_features=True)
    assert logits.shape == (shape[0], 400) and feats.shape == (shape[0], 1024)
    assert float(np.abs(np.asarray(want_feats)).max()) > 1e-2
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(feats.numpy(), np.asarray(want_feats), rtol=1e-4, atol=1e-4)


def _i3d_npz(path, values):
    """The reference's torch state dict of ``values``: OIDHW kernels,
    ``batch3d.{weight,bias,running_mean,running_var}``, Sequential branch
    indices, the 1x1x1 head with bias."""
    names = {"branch_1a": "branch_1.0", "branch_1b": "branch_1.1",
             "branch_2a": "branch_2.0", "branch_2b": "branch_2.1",
             "branch_3b": "branch_3.1"}
    state = {}

    def walk(p, s, prefix):
        for k, v in p.items():
            key = ".".join(prefix + [names.get(k, k)])
            if k == "conv3d":
                state[key + ".weight"] = np.asarray(v["kernel"]).transpose(4, 3, 0, 1, 2)
            elif k == "batch3d":
                state[key + ".weight"] = np.asarray(v["scale"])
                state[key + ".bias"] = np.asarray(v["bias"])
                state[key + ".running_mean"] = np.asarray(s[k]["mean"])
                state[key + ".running_var"] = np.asarray(s[k]["var"])
                state[key + ".num_batches_tracked"] = np.asarray(0)
            else:
                walk(v, s[k], prefix + [names.get(k, k)])

    params = dict(values["params"])
    head = params.pop("logits")
    walk(params, values["batch_stats"], [])
    state["conv3d_0c_1x1.conv3d.weight"] = np.asarray(head["kernel"]).T[:, :, None, None, None]
    state["conv3d_0c_1x1.conv3d.bias"] = np.asarray(head["bias"])
    np.savez(path, **state)
    return path


def test_i3d_npz_loader_matches_jax(pair, tmp_path, monkeypatch):
    values, net = pair
    path = _i3d_npz(str(tmp_path / "i3d.npz"), jax.tree_util.tree_map(np.asarray, values))
    got = ti3d.load_torch_i3d_npz(path)
    want = ti3d.I3D()
    jv = jax.tree_util.tree_map(np.asarray, ji3d.load_torch_i3d_npz(path))
    load_flax(want, jv["params"], jv["batch_stats"])
    for (k, a), b in zip(got.state_dict().items(), want.state_dict().values()):
        assert torch.equal(a, b), k
    for a, b in zip(got.state_dict().values(), net.state_dict().values()):
        assert torch.equal(a, b)
    # IPOKE_I3D_WEIGHTS takes the FVD backbone first
    monkeypatch.setenv("IPOKE_I3D_WEIGHTS", path)
    backbone = tbackbone.init_fvd_backbone("cpu")
    assert isinstance(backbone, ti3d.I3D)
    assert torch.equal(backbone.logits.kernel, net.logits.kernel)


def test_fvd_over_both_backbones_matches_jax(pair, monkeypatch):
    """3 real and 3 fake clips (T 10, 32 px) in batches of 2, the last
    short: the I3D's logits and the MotionFeatureNet's features."""
    values, net = pair
    real = _clips(2, (3, 10, 32, 32, 3))
    fake = np.clip(real + 0.5 * _clips(3, real.shape), -1, 1)

    def jax_fvd(acts):
        a_real, a_fake = (np.concatenate([np.asarray(acts(v[i:i + 2]))
                                          for i in range(0, 3, 2)]) for v in (real, fake))
        return jm.frechet_distance(*jm.calculate_moments(a_real),
                                   *jm.calculate_moments(a_fake))

    want_i3d = jax_fvd(lambda v: _jax_i3d(values, jnp.asarray(v))[0])
    monkeypatch.delenv("IPOKE_FVD_BACKBONE", raising=False)
    motion = jbackbone.init_fvd_backbone(0, spatial=32, frames=10)
    assert motion["kind"] == "motion_feat"
    with jax.disable_jit():
        want_motion = jax_fvd(lambda v: jbackbone.backbone_activations(motion, v, 2))
    got_i3d = tm.compute_fvd(net, real, fake, 2)
    got_motion = tm.compute_fvd(tbackbone.init_fvd_backbone("cpu"), real, fake, 2)
    assert want_i3d > 0 and want_motion > 0
    np.testing.assert_allclose(got_i3d, want_i3d, rtol=1e-3)
    np.testing.assert_allclose(got_motion, want_motion, rtol=1e-3)
    monkeypatch.setenv("IPOKE_FVD_BACKBONE", "random_i3d")
    random = tbackbone.init_fvd_backbone("cpu")
    assert isinstance(random, ti3d.I3D)
    assert tbackbone.backbone_activations(random, real, 2).shape == (3, 400)
