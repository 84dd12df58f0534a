"""The port's perceptual nets and diversity scores against the JAX
package's, fp32 on the CPU, with the same weights (numpy values over the
JAX shapes, carried by ``convert``) and inputs from numpy seeds:

* LPIPS, 3- and 2-channel (flow, zero-padded): 1e-5 relative;
* the LPIPS npz loader and the VGG19 npz (``IPOKE_VGG_WEIGHTS``) against
  the JAX package's loaders on one random npz in the torch layout, written
  here: the LPIPS weights equal, the VGG19 taps within 1e-5;
* the MSE, VGG and LPIPS diversity scores and ``optical_flow_metrics``:
  1e-5 relative.

The JAX functions run eagerly (``jax.disable_jit``): the file compiles no
jitted program."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.eval import metrics as jm
from ipoke_tpu.nn import vgg as jvgg
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import load_flax, load_lpips
from ipoke_tpu_torch.eval import metrics as tm
from ipoke_tpu_torch.nn import lpips as tl
from ipoke_tpu_torch.nn.vgg import VGG19Features

from test_torch_ops import _few_threads, _jnp  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill

K = jax.random.PRNGKey
jl = importlib.import_module("ipoke_tpu.nn.lpips")  # the package exports lpips()


def _images(seed, shape):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(shape) * 0.5, -1, 1).astype(np.float32)


def _he(tree):
    """``_fill``'s fan-in-scaled kernels times sqrt(2), the He scale of a
    ReLU net: at 1/sqrt(fan_in) each of VGG's 13+ ReLU layers halves the
    signal, the biases take over and every image's last tap points the same
    way (a VGG diversity score of ~1e-4, where fp32's 1 - cos rounds at
    ~1e-8)."""
    return {k: _he(v) if isinstance(v, dict) else
            (v * np.float32(2 ** 0.5) if k == "kernel" else v) for k, v in tree.items()}


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX LPIPS params (fan-in-scaled VGG16, |N(0, 1)| / C heads) and the
    port's LPIPS carrying them."""
    shapes = jax.eval_shape(lambda: jl.VGG16Features().init(
        K(0), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(0)
    params = {"vgg": _he(_fill(shapes["params"], rng)),
              "lins": [(np.abs(rng.standard_normal(c)) / c).astype(np.float32)
                       for c in jl._CHNS]}
    net = tl.init_lpips(0)
    load_lpips(net, params)
    return _jnp(params), net


@pytest.fixture(scope="module")
def vgg_pair():
    shapes = jax.eval_shape(lambda: jvgg.VGG19Features().init(
        K(0), jnp.zeros((1, 16, 16, 3))))
    values = _jnp(_he(_fill(shapes, np.random.default_rng(1))))
    vgg = VGG19Features()
    load_flax(vgg, values["params"])
    return values, vgg.eval()


@pytest.mark.parametrize("channels", [3, 2])
def test_lpips_matches_jax(lpips_pair, channels):
    params, net = lpips_pair
    a = _images(2, (3, 32, 32, channels))
    b = np.clip(a + 0.3 * _images(3, a.shape), -1, 1)
    with torch.no_grad():
        got = net(torch.tensor(a), torch.tensor(b))
    want = jl.lpips(params, jnp.asarray(a), jnp.asarray(b))
    assert got.shape == (3,) and float(got.min()) > 0
    _close(got.numpy(), want, 1e-5)


def _torch_lpips_npz(path, rng):
    """A random torch LPIPS state_dict in the reference's layout."""
    state = {}
    cin = 3
    idx = iter(jl._CONV_IDX)
    for ch, n in jl._VGG16_CFG:
        for _ in range(n):
            i = next(idx)
            s = int(np.searchsorted((0, 4, 9, 16, 23, 30), i, side="right"))
            state[f"net.slice{s}.{i}.weight"] = rng.standard_normal(
                (ch, cin, 3, 3)).astype(np.float32)
            state[f"net.slice{s}.{i}.bias"] = rng.standard_normal(ch).astype(np.float32)
            cin = ch
    for k, c in enumerate(jl._CHNS):
        state[f"lin{k}.model.1.weight"] = rng.random((1, c, 1, 1)).astype(np.float32)
    np.savez(path, **state)
    return path


def test_lpips_npz_loader_matches_jax(tmp_path):
    path = _torch_lpips_npz(str(tmp_path / "lpips.npz"), np.random.default_rng(4))
    got = tl.load_torch_lpips_npz(path)
    want = tl.init_lpips(1)
    load_lpips(want, jax.tree_util.tree_map(np.asarray, jl.load_torch_lpips_npz(path)))
    got_sd, want_sd = got.state_dict(), want.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k


def test_vgg19_weights_from_env_match_jax(tmp_path, monkeypatch):
    """``IPOKE_VGG_WEIGHTS``: the port's ``build_vgg`` and the JAX package's
    ``init_vgg_params`` read the same npz and give the same taps."""
    rng = np.random.default_rng(5)
    state, idx, cin = {}, 0, 3
    for ch, n in jvgg._CFG:
        for _ in range(n):
            state[f"features.{idx}.weight"] = (rng.standard_normal((ch, cin, 3, 3))
                                               * (9 * cin) ** -0.5).astype(np.float32)
            state[f"features.{idx}.bias"] = (0.1 * rng.standard_normal(ch)).astype(np.float32)
            cin, idx = ch, idx + 2
        idx += 1
    path = str(tmp_path / "vgg19.npz")
    np.savez(path, **state)
    monkeypatch.setenv("IPOKE_VGG_WEIGHTS", path)
    x = _images(6, (2, 16, 16, 3))
    want = jvgg.VGG19Features().apply(jvgg.init_vgg_params(0), jnp.asarray(x))
    with torch.no_grad():
        got = entry.build_vgg("cpu")(torch.tensor(x))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-5)
    monkeypatch.delenv("IPOKE_VGG_WEIGHTS")
    seeded = entry.build_vgg("cpu")
    assert not torch.equal(seeded.conv1_1.weight, torch.as_tensor(state["features.0.weight"]))


def _samples(seed, n=2, s=3, t=2, size=32):
    base = _images(seed, (n, 1, t, size, size, 3))
    return np.clip(base + 0.2 * _images(seed + 1, (n, s, t, size, size, 3)), -1, 1)


def test_diversity_scores_match_jax(lpips_pair, vgg_pair):
    """N = 2 data points, S = 3 samples, T = 2 frames at 32 px."""
    params, net = lpips_pair
    values, vgg = vgg_pair
    samples = _samples(7)
    with jax.disable_jit():
        want_lpips = jm.diversity_score_lpips(params, samples)
        want_vgg = jm.diversity_score_vgg(values, samples)
    assert tm.diversity_score_mse(samples) == jm.diversity_score_mse(samples)
    _close(tm.diversity_score_lpips(net, samples), want_lpips, 1e-5)
    _close(tm.diversity_score_vgg(vgg, samples), want_vgg, 1e-5)
    assert want_lpips > 0 and want_vgg > 0


def test_diversity_lpips_chunks_frames(lpips_pair):
    """More frames than one chunk (256 // N): the frame chunks add up to the
    score of one pass over every frame."""
    _, net = lpips_pair
    samples = _samples(8, n=64, s=2, t=5, size=16)  # chunks of 4 frames
    with torch.no_grad():
        a = torch.tensor(samples[:, 0].reshape(-1, 16, 16, 3))
        b = torch.tensor(samples[:, 1].reshape(-1, 16, 16, 3))
        whole = float(net(a, b).mean())
    _close(tm.diversity_score_lpips(net, samples), whole, 1e-5)


def test_optical_flow_metrics_match_jax():
    rng = np.random.default_rng(9)
    f1 = (3 * rng.standard_normal((2, 16, 16, 2))).astype(np.float32)
    f2 = (f1 + rng.standard_normal(f1.shape)).astype(np.float32)
    got = tm.optical_flow_metrics(torch.tensor(f1), torch.tensor(f2))
    want = jm.optical_flow_metrics(jnp.asarray(f1), jnp.asarray(f2))
    assert got.keys() == want.keys()
    for k in want:
        _close(float(got[k]), float(want[k]), 1e-5)
