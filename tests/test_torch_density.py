"""The port's density direction (ipoke_tpu_torch) against the JAX package's:
the motion encoder, the flow's forward, logdet and data-dependent init, the
masked and weight-norm convs, the loss and the lr schedule, with the same
weights and inputs (numpy seeds), in fp32 on CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.flows import flow_loss as jflow_loss
from ipoke_tpu.flows import macow as jm
from ipoke_tpu.flows import primitives as jp
from ipoke_tpu.nn.motion import ResNetMotionEncoder as JMotion
from ipoke_tpu_torch.convert import flow_params, load_flax, to_numpy_tree
from ipoke_tpu_torch.core.optim import warmup_linear_decay
from ipoke_tpu_torch.flows import flow_loss
from ipoke_tpu_torch.flows import macow as tm
from ipoke_tpu_torch.flows import primitives as tp
from ipoke_tpu_torch.nn.motion import ResNetMotionEncoder

from test_torch_ops import _jnp, _np, _perturb, _t
from test_torch_sampling import _fill

K = jax.random.PRNGKey


def leaves(tree):
    """Leaves in jax's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the motion encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spatial,channels", [(32, (16, 16, 32, 32)),
                                              (64, (8, 16, 16, 32, 32))])
def test_motion_encoder_matches_flax(spatial, channels):
    """ResNetMotionEncoder (64 px adds the spatial stage 4) against flax,
    deterministic (z = mu), with random GroupNorm scales and biases."""
    kw = dict(channels=channels, z_dim=8, spatial_size=spatial, max_frames=3,
              min_spatial_size=4, deterministic=True)
    x = np.random.default_rng(spatial).standard_normal(
        (2, 4, spatial, spatial, 3)).astype(np.float32)
    jenc = JMotion(**kw)
    shapes = jax.eval_shape(lambda: jenc.init(K(0), jnp.asarray(x)))
    values = _fill(shapes, np.random.default_rng(1))
    want = jenc.apply(jax.tree_util.tree_map(jnp.asarray, values), jnp.asarray(x))
    port = ResNetMotionEncoder(**kw)
    load_flax(port, values["params"])
    with torch.no_grad():
        got = port(_t(x))
    assert got[0].shape == (2, 4, 4, 8)
    for g, w in zip(got, want):
        close(g, w, 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# the flow: density forward, logdet, data-dependent init
# ---------------------------------------------------------------------------

FLOW = dict(num_steps=(1, 1), in_channels=16, hidden_channels=128,
            h_channels=6, factor=16)


def _flow_case(seed):
    jflow = jm.MultiScaleInternal(**FLOW)
    rng = np.random.default_rng(seed)
    params = _perturb(to_numpy_tree(jflow.init(K(seed), None)), rng, 0.1, 0.05)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    h = rng.standard_normal((2, 4, 4, 6)).astype(np.float32)
    return jflow, params, x, h


def test_multiscale_forward_matches_jax():
    """z and logdet of the perturbed flow; the port's inverse undoes it."""
    jflow, params, x, h = _flow_case(70)
    want_y, want_ld = jax.jit(jflow.forward)(_jnp(params), jnp.asarray(x),
                                             jnp.asarray(h))
    tflow, pt = tm.MultiScaleInternal(**FLOW), flow_params(params)
    y, ld = tflow.forward(pt, _t(x), _t(h))
    assert ld.dtype == torch.float32 and ld.shape == (2,)
    close(y, want_y, 2e-4, 2e-4)
    close(ld, want_ld, 2e-4, 2e-4)
    np.testing.assert_allclose(tflow.inverse(pt, y, _t(h)).numpy(), x, atol=1e-3)


def test_multiscale_ddi_matches_jax():
    """DDI's output, logdet and every re-initialised leaf."""
    jflow, params, x, h = _flow_case(71)
    want = jax.jit(jflow.ddi)(_jnp(params), jnp.asarray(x), jnp.asarray(h))
    got = tm.MultiScaleInternal(**FLOW).ddi(flow_params(params), _t(x), _t(h))
    close(got[0], want[0], 2e-4, 2e-4)
    close(got[1], want[1], 2e-4, 2e-4)
    g_leaves, w_leaves = leaves(got[2]), jax.tree_util.tree_leaves(want[2])
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        close(g, w, 2e-4, 2e-4)


@pytest.mark.parametrize("order", ["A", "B", "C", "D"])
def test_shifted_conv_and_wn_ddi_match_jax(order):
    """The masked conv of each order, and the weight-norm DDI at
    init_scale 1 (the flows use 0, which multiplies its statistics away)."""
    rng = np.random.default_rng(ord(order))
    ks = (2, 3) if order in "AB" else (3, 2)
    w = rng.standard_normal((*ks, 4, 8)).astype(np.float32)
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    close(tp.shifted_conv_apply(_t(w), _t(x), order),
           jp.shifted_conv_apply(jnp.asarray(w), jnp.asarray(x), order), 1e-5, 1e-5)
    wn = {"v": rng.standard_normal((3, 3, 4, 8)).astype(np.float32),
          "g": rng.standard_normal(8).astype(np.float32),
          "b": rng.standard_normal(8).astype(np.float32)}
    want = jp.wn_conv_ddi(_jnp(wn), jnp.asarray(x), init_scale=1.0)
    got = tp.wn_conv_ddi(flow_params(wn), _t(x), init_scale=1.0)
    for k in ("g", "b"):
        close(got[k], want[k], 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# loss and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,spatial_mean", [
    ((3, 4, 4, 8), False), ((3, 4, 4, 8), True), ((2, 8, 4, 6), True),
    ((3, 10), False)])
def test_flow_loss_matches_jax(shape, spatial_mean):
    rng = np.random.default_rng(len(shape) + 2 * spatial_mean + shape[1])
    z = (2.0 * rng.standard_normal(shape)).astype(np.float32)
    ld = (10.0 * rng.standard_normal(shape[0])).astype(np.float32)
    want = jflow_loss(jnp.asarray(z), jnp.asarray(ld), spatial_mean=spatial_mean)[1]
    loss, log = flow_loss(_t(z), _t(ld), torch.Generator().manual_seed(0),
                          spatial_mean=spatial_mean)
    for k in ("flow_loss", "nlogdet_loss", "nll_loss"):
        close(log[k], want[k], 1e-6, 1e-5)
    assert log["flow_loss"] is loss
    assert torch.isfinite(log["reference_nll_loss"])


@pytest.mark.parametrize("warmup,total", [(10, 30), (0, 20), (5, 5)])
def test_warmup_linear_decay_matches_optax(warmup, total):
    want = joptim.warmup_linear_decay(1e-3, warmup, total)
    got = warmup_linear_decay(1e-3, warmup, total)
    for count in range(total + 5):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-10)
