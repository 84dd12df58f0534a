"""The port's validation metrics against the JAX package's on the same
arrays, fp32 on the CPU: PSNR, SSIM and the VGG perceptual distance within
1e-5 relative; MotionFeatureNet's features from the packaged npz within
1e-4; FID and FVD within 1e-3 relative; the Fréchet distance and moments.
The JAX MotionFeatureNet runs once (this file's one JAX program), on the
real and the fake clips together; its FVD is ``compute_fvd``'s composition
of the JAX package's moments and distance over those features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.eval import backbone as jbackbone
from ipoke_tpu.eval import metrics as jm
from ipoke_tpu.nn import motion_feat as jmf
from ipoke_tpu.nn.vgg import VGG19Features as JaxVGG
from ipoke_tpu_torch.convert import load_flax
from ipoke_tpu_torch.eval import backbone as tbackbone
from ipoke_tpu_torch.eval import metrics as tm
from ipoke_tpu_torch.nn.motion_feat import load_motion_feat, motion_feat_activations
from ipoke_tpu_torch.nn.vgg import VGG19Features

from test_torch_ops import _jnp
from test_torch_sampling import _fill

K = jax.random.PRNGKey


def _images(seed, shape=(4, 16, 16, 3)):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal(shape) * 0.5, -1, 1).astype(np.float32)


def _close(got, want, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("channels", [3, 2])
def test_psnr_ssim_match_jax(channels):
    a = _images(0, (4, 24, 24, channels))
    b = np.clip(a + 0.1 * _images(1, a.shape), -1, 1)
    for fn in ("psnr", "ssim"):
        _close(getattr(tm, fn)(torch.tensor(a), torch.tensor(b)).numpy(),
               getattr(jm, fn)(jnp.asarray(a), jnp.asarray(b)), 1e-5)


def test_perceptual_distance_matches_jax():
    """The same random VGG (the JAX tree's values loaded into the port):
    the perceptual distance within 1e-5 relative; FID over the last tap,
    mean-pooled, of 8 real and 8 fake images in batches of 4, within 1e-3
    relative (``compute_fid`` run eagerly, so that it adds no JAX
    program)."""
    shapes = jax.eval_shape(lambda: JaxVGG().init(K(0), jnp.zeros((1, 16, 16, 3))))
    values = _jnp(_fill(shapes, np.random.default_rng(0)))
    vgg = VGG19Features()
    load_flax(vgg, values["params"])
    a, b = _images(2), _images(3)
    with torch.no_grad():
        got = tm.perceptual_distance(vgg, torch.tensor(a), torch.tensor(b))
    _close(got.numpy(), jm.perceptual_distance(values, jnp.asarray(a),
                                               jnp.asarray(b)), 1e-5)
    real = np.concatenate([a, b])
    fake = np.clip(real + 0.3 * _images(4, real.shape), -1, 1)
    with torch.no_grad():
        got = tm.compute_fid(vgg, real, fake, batch_size=4)
    with jax.disable_jit():
        want = jm.compute_fid(values, real, fake, batch_size=4)
    assert got > 0
    _close(got, want, 1e-3)


def test_moments_and_frechet_match_jax():
    rng = np.random.default_rng(4)
    for n, d in ((40, 8), (6, 8)):  # full and diagonal covariance
        a, b = rng.standard_normal((n, d)), 0.5 + rng.standard_normal((n, d))
        for x, y in zip(tm.calculate_moments(a), jm.calculate_moments(a)):
            np.testing.assert_array_equal(x, y)
        want = jm.frechet_distance(*jm.calculate_moments(a), *jm.calculate_moments(b))
        assert tm.frechet_distance(*tm.calculate_moments(a),
                                   *tm.calculate_moments(b)) == want


def test_motion_feat_and_fvd_match_jax():
    """Features of 8 real and 8 fake clips (T 10, 32 px; the last slice
    short) within 1e-4 of the JAX net's, both from the packaged npz; FVD
    within 1e-3 relative."""
    path = jbackbone.packaged_weights_path()
    assert tbackbone.packaged_weights_path() == path
    rng = np.random.default_rng(5)
    real = np.clip(rng.standard_normal((8, 10, 32, 32, 3)) * 0.5, -1, 1).astype(np.float32)
    fake = np.clip(real + 0.3 * rng.standard_normal(real.shape), -1, 1).astype(np.float32)
    params = jmf.load_motion_feat(path, 10, 32)
    want = jmf.motion_feat_activations(params, np.concatenate([real, fake]), 16)
    net = tbackbone.init_fvd_backbone("cpu")
    got = motion_feat_activations(net, np.concatenate([real, fake]), 3)
    assert got.shape == want.shape == (16, jmf.FEAT_DIM)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want_fvd = jm.frechet_distance(*jm.calculate_moments(want[:8]),
                                   *jm.calculate_moments(want[8:]))
    got_fvd = tm.compute_fvd(net, torch.tensor(real), torch.tensor(fake), batch_size=3)
    assert want_fvd > 0
    np.testing.assert_allclose(got_fvd, want_fvd, rtol=1e-3)
    assert isinstance(load_motion_feat(path), torch.nn.Module)


def test_fvd_backbone_refuses_unported_choices(monkeypatch):
    """Every choice of the JAX package's priority is ported: the random I3D
    when asked for or when the packaged weights are absent; the one choice
    left to refuse is the MotionFeatureNet forced without its weights."""
    from ipoke_tpu_torch.eval.i3d import I3D

    monkeypatch.setenv("IPOKE_FVD_BACKBONE", "random_i3d")
    assert isinstance(tbackbone.init_fvd_backbone("cpu"), I3D)
    monkeypatch.delenv("IPOKE_FVD_BACKBONE")
    monkeypatch.setattr(tbackbone, "_PACKAGED", "/nonexistent/motion_feat_v1.npz")
    assert isinstance(tbackbone.init_fvd_backbone("cpu"), I3D)
    monkeypatch.setenv("IPOKE_FVD_BACKBONE", "motion_feat")
    with pytest.raises(FileNotFoundError):
        tbackbone.init_fvd_backbone("cpu")
