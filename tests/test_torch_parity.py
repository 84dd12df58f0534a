"""Cross-framework layout golden tests: torch OIHW conv weights transposed to
flax HWIO must produce identical outputs — the foundation of the checkpoint
converters (SURVEY.md §7 hard part 2)."""

import numpy as np

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)


def test_conv2d_weight_transpose_matches_torch():
    import torch
    import torch.nn.functional as F

    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)  # NCHW
    w = rng.normal(size=(8, 3, 3, 3)).astype(np.float32)    # OIHW
    b = rng.normal(size=(8,)).astype(np.float32)

    ref = F.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), padding=1).numpy()

    x_jax = jnp.asarray(np.transpose(x, (0, 2, 3, 1)))      # NHWC
    w_jax = jnp.asarray(np.transpose(w, (2, 3, 1, 0)))      # HWIO
    out = jax.lax.conv_general_dilated(
        x_jax, w_jax, (1, 1), [(1, 1), (1, 1)],
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    out_nchw = np.transpose(np.asarray(out), (0, 3, 1, 2))
    np.testing.assert_allclose(out_nchw, ref, atol=2e-4)


def test_conv_transpose_matches_torch():
    """The 2x-upsampling convention mapping for weight porting: torch
    ConvTranspose2d(k3, s2, p=1, output_padding=1) == flax
    ConvTranspose(k3, s2, padding=VALID, transpose_kernel=True) with the
    (in, out, kh, kw) -> (kh, kw, out, in) weight transpose, CROPPED [1:, 1:]
    (flax 'SAME' instead crops [:-1, :-1] — do NOT use it when porting)."""
    import torch
    import torch.nn.functional as F

    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    w = rng.normal(size=(4, 6, 3, 3)).astype(np.float32)  # (in, out, kh, kw)

    ref = F.conv_transpose2d(torch.from_numpy(x), torch.from_numpy(w),
                             stride=2, padding=1, output_padding=1).numpy()

    conv = nn.ConvTranspose(6, (3, 3), strides=(2, 2), padding="VALID",
                            use_bias=False, transpose_kernel=True)
    params = {"params": {"kernel": jnp.asarray(
        np.transpose(w, (2, 3, 1, 0)))}}
    out = conv.apply(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    out_nchw = np.transpose(np.asarray(out), (0, 3, 1, 2))[:, :, 1:, 1:]
    assert out_nchw.shape == ref.shape
    np.testing.assert_allclose(out_nchw, ref, atol=2e-4)


def test_groupnorm_matches_torch():
    import torch

    import jax.numpy as jnp
    from flax import linen as nn

    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 8, 8)).astype(np.float32)
    gamma = rng.normal(size=(16,)).astype(np.float32)
    beta = rng.normal(size=(16,)).astype(np.float32)

    tgn = torch.nn.GroupNorm(4, 16)
    tgn.weight.data = torch.from_numpy(gamma)
    tgn.bias.data = torch.from_numpy(beta)
    ref = tgn(torch.from_numpy(x)).detach().numpy()

    gn = nn.GroupNorm(num_groups=4, epsilon=1e-5)
    params = {"params": {"scale": jnp.asarray(gamma),
                         "bias": jnp.asarray(beta)}}
    out = gn.apply(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    np.testing.assert_allclose(
        np.transpose(np.asarray(out), (0, 3, 1, 2)), ref, atol=2e-4)
