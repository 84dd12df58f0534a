"""The port's pose estimator against the JAX package's, fp32 on the CPU,
with the same variables (numpy values over the JAX shapes, carried by
``convert.load_flax``: kernels, the deconvs' transposed kernels,
BatchNorm scale/bias and running mean/var) and frames from numpy seeds, at
a short stage plan (1, 2, 1, 1) of 64 px frames:

* heatmaps within 1e-4; ``get_max_preds``' coordinates equal wherever the
  top-2 margin of a heatmap exceeds 1e-4, the maxvals within 1e-4;
* ``keypoint_mse`` and ``keypoint_nearest_neighbors``: equal;
* the pose-ResNet npz loader against the JAX package's on one random npz
  in the reference's torch layout, written here: the same weights, the
  stage plan read from the keys, ``IPOKE_POSE_WEIGHTS`` taken by
  ``pose_estimator_from_env``.

The JAX net is this file's one jitted program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.eval import pose as jpose
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.eval import pose as tpose

from test_torch_ops import _few_threads, _jnp  # noqa: F401 (_few_threads)

K = jax.random.PRNGKey
LAYERS = (1, 2, 1, 1)
_jax_pose = jax.jit(lambda v, x: jpose.PoseResNet(layers=LAYERS).apply(v, x))


def _variables(seed=0):
    """He-scaled kernels (the deconvs' by their input fan), BN scale
    1 + 0.1 N, bias and mean 0.1 N, var 1 + 0.1 |N|."""
    shapes = jax.eval_shape(lambda: jpose.PoseResNet(layers=LAYERS).init(
        K(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(seed)

    def fill(tree, path=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, k)
                continue
            n = rng.standard_normal(v.shape).astype(np.float32)
            if k == "kernel":
                fan = v.shape[0] * v.shape[1] * (v.shape[3] if path.startswith("deconv")
                                                 else v.shape[2])
                out[k] = n * np.float32((2.0 / fan) ** 0.5)
            elif k == "scale":
                out[k] = 1.0 + 0.1 * n
            elif k == "var":
                out[k] = 1.0 + 0.1 * np.abs(n)
            else:
                out[k] = 0.1 * n
        return out

    return {"params": fill(shapes["params"]), "batch_stats": fill(shapes["batch_stats"])}


def _frames(seed, n=3):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n, 64, 64, 3)) * 0.5, -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    values = _variables()
    net = tpose.PoseResNet(layers=LAYERS)
    load_flax(net, values["params"], values["batch_stats"])
    return _jnp(values), net.eval()


def test_pose_resnet_matches_jax(pair):
    values, net = pair
    x = _frames(1)
    want = np.asarray(_jax_pose(values, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.tensor(x))
    assert got.shape == want.shape == (3, 16, 16, 17)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # the decoded keypoints, where the first argmax is clear
    coords, maxvals = tpose.get_max_preds(got)
    j_coords, j_maxvals = jpose.get_max_preds(jnp.asarray(want))
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(j_maxvals), rtol=1e-4, atol=1e-4)
    flat = np.sort(want.transpose(0, 3, 1, 2).reshape(3, 17, -1), axis=-1)
    clear = flat[..., -1] - flat[..., -2] > 1e-4
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(coords.numpy()[clear], np.asarray(j_coords)[clear])


def test_get_max_preds_matches_jax():
    """Ties take the first argmax; maxval <= 0 gives -1 coordinates."""
    rng = np.random.default_rng(2)
    hm = rng.integers(-3, 4, (2, 6, 5, 4)).astype(np.float32)
    hm[1, ..., 3] = -1.0
    got = tpose.get_max_preds(torch.tensor(hm))
    want = jpose.get_max_preds(jnp.asarray(hm))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][1, 3] == -1).all()


def test_keypoint_metrics_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.random((5, 17, 2)) * 64, rng.random((5, 17, 2)) * 64
    np.testing.assert_array_equal(tpose.keypoint_mse(a, b, norm=64),
                                  jpose.keypoint_mse(a, b, norm=64))
    kps = rng.random((40, 17, 2)).astype(np.float32)
    groups = np.repeat(np.arange(8), 5)
    np.testing.assert_array_equal(tpose.keypoint_nearest_neighbors(kps, groups, chunk=7),
                                  jpose.keypoint_nearest_neighbors(kps, groups, chunk=7))


def _pose_npz(path, values):
    """The reference's torch pose-ResNet state dict of ``values``."""
    p, s = values["params"], values["batch_stats"]
    state = {}

    def bn(dst, name, stats):
        state[f"{dst}.weight"], state[f"{dst}.bias"] = name["scale"], name["bias"]
        state[f"{dst}.running_mean"], state[f"{dst}.running_var"] = stats["mean"], stats["var"]

    conv = lambda k: np.asarray(k).transpose(3, 2, 0, 1)  # noqa: E731
    state["conv1.weight"] = conv(p["conv1"]["kernel"])
    bn("bn1", p["bn1"], s["bn1"])
    for i, n in enumerate(LAYERS):
        for j in range(n):
            t, d = f"layer{i + 1}.{j}", f"layer{i + 1}_{j}"
            for k in (1, 2, 3):
                state[f"{t}.conv{k}.weight"] = conv(p[d][f"conv{k}"]["kernel"])
                bn(f"{t}.bn{k}", p[d][f"bn{k}"], s[d][f"bn{k}"])
            if "downsample_conv" in p[d]:
                state[f"{t}.downsample.0.weight"] = conv(p[d]["downsample_conv"]["kernel"])
                bn(f"{t}.downsample.1", p[d]["downsample_bn"], s[d]["downsample_bn"])
    for m in range(3):
        state[f"deconv_layers.{3 * m}.weight"] = conv(p[f"deconv{m}"]["kernel"])
        bn(f"deconv_layers.{3 * m + 1}", p[f"deconv_bn{m}"], s[f"deconv_bn{m}"])
    state["final_layer.weight"] = conv(p["final"]["kernel"])
    state["final_layer.bias"] = p["final"]["bias"]
    np.savez(path, **{k: np.asarray(v) for k, v in state.items()})
    return path


def test_pose_npz_loader_matches_jax(pair, tmp_path, monkeypatch):
    values, net = pair
    path = _pose_npz(str(tmp_path / "pose.npz"), jax.tree_util.tree_map(np.asarray, values))
    got = tpose.load_torch_pose_resnet_npz(path)
    assert got.layers == LAYERS
    want = tpose.PoseResNet(layers=LAYERS)
    jv = jax.tree_util.tree_map(np.asarray, jpose.load_torch_pose_resnet_npz(path, LAYERS))
    load_flax(want, jv["params"], jv["batch_stats"])
    for (k, a), b, c in zip(got.state_dict().items(), want.state_dict().values(),
                            net.state_dict().values()):
        assert torch.equal(a, b) and torch.equal(a, c), k
    monkeypatch.setenv("IPOKE_POSE_WEIGHTS", path)
    est = tpose.pose_estimator_from_env("cpu")
    x = _frames(4, 2)
    with torch.no_grad():
        want_kps = tpose.get_max_preds(net(torch.tensor(x)))[0].numpy() * 4
    np.testing.assert_array_equal(est(x), want_kps)
    monkeypatch.delenv("IPOKE_POSE_WEIGHTS")
    assert tpose.pose_estimator_from_env("cpu").net.layers == (3, 4, 6, 3)
