"""The port's flows (ipoke_tpu_torch/flows) against the JAX package's, inverse
direction, with the same perturbed weights and the same inputs (numpy seeds).
On CPU the unit inverse takes K2's plain version on square latents and K5's,
flow by flow, on the others."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.flows import macow as jm
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.convert import flow_params, to_numpy_tree
from ipoke_tpu_torch.flows import macow as tm
from ipoke_tpu_torch.flows import count_params, tree_leaves
from ipoke_tpu_torch.ops import masked_conv

from test_torch_ops import _few_threads, _jnp, _np, _perturb, _t  # noqa: F401 (_few_threads)

B, H, W, C, HC = 2, 8, 8, 8, 6


def _case(jflow, seed, channels=C, h_channels=HC, g_std=0.3, b_std=0.1,
          hw=(H, W)):
    rng = np.random.default_rng(seed)
    params = _perturb(to_numpy_tree(jflow.init(jax.random.PRNGKey(seed), None)),
                      rng, g_std, b_std)
    x = rng.standard_normal((B, *hw, channels)).astype(np.float32)
    h = rng.standard_normal((B, *hw, h_channels)).astype(np.float32) \
        if h_channels else None
    pj = _jnp(params)
    hj = None if h is None else jnp.asarray(h)
    # jitted: one compile each instead of op-by-op dispatch of the scans
    y, _ = jax.jit(jflow.forward)(pj, jnp.asarray(x), hj)
    want = jax.jit(jflow.inverse)(pj, y, hj)
    return params, x, h, y, want


def _check(tflow, params, h, y, want, x, tol):
    got = tflow.inverse(flow_params(params), _t(y), None if h is None else _t(h))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=tol)
    if x is not None:  # and it inverts the JAX forward
        np.testing.assert_allclose(got.numpy(), x, atol=1e-3)


@pytest.mark.parametrize("hw", [(H, W), (4, 8)])
@pytest.mark.parametrize("order,ks", [("A", (2, 3)), ("B", (2, 3)),
                                      ("C", (3, 2)), ("D", (3, 2))])
def test_masked_conv_flow_inverse(order, ks, hw):
    jflow = jm.MaskedConvFlow(C, ks, order=order, h_channels=HC)
    params, x, h, y, want = _case(jflow, 1 + ord(order), hw=hw)
    _check(tm.MaskedConvFlow(C, ks, order=order, h_channels=HC),
           params, h, y, want, x, 1e-4)


@pytest.mark.parametrize("activation", ["relu", "leaky_relu"])
def test_masked_conv_flow_inverse_other_activation(activation):
    """No kernel takes another activation (nor in the JAX package): the
    plain row scan, with the activation also applied to the conditioning
    rows."""
    kw = dict(order="D", h_channels=HC, activation=activation)
    params, x, h, y, want = _case(jm.MaskedConvFlow(C, (3, 2), **kw), 70, hw=(4, 8))
    _check(tm.MaskedConvFlow(C, (3, 2), **kw), params, h, y, want, x, 1e-4)


@pytest.mark.parametrize("split,order", [("continuous", "up"),
                                         ("continuous", "down"),
                                         ("skip", "up"), ("skip", "down")])
def test_nice2d_inverse(split, order):
    kw = dict(hidden_channels=128, split_type=split, order=order)
    params, x, h, y, want = _case(jm.NICE2d(C, **kw), 30, h_channels=0)
    _check(tm.NICE2d(C, **kw), params, h, y, want, x, 1e-4)


@pytest.mark.parametrize("hw", [(H, W), (4, 8)])
def test_macow_unit_inverse(hw):
    """Square: K2's route; 4x8: four K5 flows and two ActNorm inverses."""
    params, x, h, y, want = _case(jm.make_macow_unit(C, (2, 3), HC), 40, hw=hw)
    _check(tm.make_macow_unit(C, (2, 3), HC), params, h, y, want, x, 1e-4)


def test_unit_route_depends_on_shape_only(monkeypatch):
    """K2 takes a unit only on a square latent whose footprint it can hold
    (the SHIPPED level-0 8x8x32, hid 128); any other goes flow by flow
    through K5's wrapper.  On CPU tensors the same routing runs, with the
    plain versions."""
    assert masked_conv.unit_fits((40, 8, 8, 32), 128, (2, 3))
    assert not masked_conv.unit_fits((40, 8, 16, 32), 128, (2, 3))
    assert not masked_conv.unit_fits((40, 32, 32, 32), 128, (2, 3))
    calls = collections.Counter()
    for name in ("masked_conv_inverse", "macow_unit_inverse_plain"):
        def spy(*args, _fn=getattr(masked_conv, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(masked_conv, name, spy)
    unit = tm.make_macow_unit(C, (2, 3), HC)
    params = unit.init(torch.Generator().manual_seed(0), "cpu")
    for hw, want in (((4, 8), {"masked_conv_inverse": 4}),
                     ((8, 8), {"macow_unit_inverse_plain": 1})):
        calls.clear()
        unit.inverse(params, torch.randn(B, *hw, C), torch.randn(B, *hw, HC))
        assert calls == want, (hw, calls)


# MCF channels C of the SHIPPED levels: 32, 30, ..., 4 (factor 16, one step
# of 2 channels per level), each with hid = 4C and 128 conditioning channels
SHIPPED_C = tuple(range(32, 2, -2))


@pytest.mark.parametrize("c", SHIPPED_C)
def test_unit_route_at_shipped_level(c, monkeypatch):
    """At each SHIPPED level the 8x8 unit goes to K2 and the 8x16 unit (the
    latent of 128x256 frames) to K5, flow by flow.  The footprint
    ``unit_fits`` checks is ``k2_smem_bytes``, K2's shared memory written in
    Python beside it (the card test holds it against the kernel's own
    count): with the limit set just at it the unit fits, one byte below it
    does not.  Two CTAs of it fit one SM's 228 KB (1 KB reserved each), so
    the 160 CTAs of a B = 40 launch run in one wave."""
    shape, hid, ks = (40, 8, 8, c), 4 * c, (2, 3)
    assert masked_conv.unit_fits(shape, hid, ks)
    assert not masked_conv.unit_fits((40, 8, 16, c), hid, ks)
    smem = masked_conv.k2_smem_bytes(8, 8, c, hid, *ks)
    monkeypatch.setattr(masked_conv, "SMEM_LIMIT", smem)
    assert masked_conv.unit_fits(shape, hid, ks)
    monkeypatch.setattr(masked_conv, "SMEM_LIMIT", smem - 1)
    assert not masked_conv.unit_fits(shape, hid, ks)
    assert 2 * (smem + 1024) <= 228 * 1024
    if c == 32:  # the level-0 footprint, as the kernel itself counts it
        assert smem == 91792


def test_macow_step_inverse():
    params, x, h, y, want = _case(
        jm.make_macow_step(C, (2, 3), 128, HC), 50, g_std=0.1, b_std=0.05)
    _check(tm.make_macow_step(C, (2, 3), 128, HC), params, h, y, want, x, 1e-4)


@pytest.mark.parametrize("hw", [(H, W), (4, 8)])
def test_multiscale_internal_inverse(hw):
    """The whole flow, from a z drawn like the sampler's (no JAX forward:
    its compile would dominate the test); at 4x8 every unit goes flow by
    flow."""
    kw = dict(num_steps=(2, 1), in_channels=16, hidden_channels=128,
              h_channels=HC, factor=16)
    jflow = jm.MultiScaleInternal(**kw)
    rng = np.random.default_rng(60)
    params = _perturb(to_numpy_tree(jflow.init(jax.random.PRNGKey(60), None)),
                      rng, 0.1, 0.05)
    z = rng.standard_normal((B, *hw, 16)).astype(np.float32)
    h = rng.standard_normal((B, *hw, HC)).astype(np.float32)
    want = jax.jit(jflow.inverse)(_jnp(params), jnp.asarray(z), jnp.asarray(h))
    _check(tm.MultiScaleInternal(**kw), params, h, z, want, None, 1e-3)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_shapes(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tuple(tree.shape)}


def test_shipped_meta_build_matches_jax_init():
    """The port's SHIPPED flow tree, built on ``meta``, has the JAX init's
    1755 leaves at the same paths and shapes (1054.43M parameters)."""
    import __graft_entry__ as ge

    cfg = entry.SHIPPED
    model, _ = ge._make_models(
        spatial=cfg["spatial"], min_spatial=cfg["min_spatial"], T=cfg["T"],
        z_dim=cfg["z_dim"], enc_ch=(64, 128, 256, 256, 256),
        dec_ch=cfg["dec_ch"], nf_cond=cfg["nf_cond"],
        num_steps=cfg["num_steps"], mid_factor=cfg["mid_factor"])
    want = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(4)))["flow"]
    port = entry.build(cfg, "meta")
    got = port.flow_params.tree()
    assert len(tree_leaves(got)) == len(jax.tree_util.tree_leaves(want)) == 1755
    assert _shapes(got) == _shapes(want)
    assert round(count_params(got) / 1e6, 2) == 1054.43
    assert port.flow == tm.MultiScaleInternal(**{
        f: getattr(model.flow, f) for f in (
            "num_steps", "in_channels", "hidden_channels", "h_channels",
            "factor", "transform", "prior_transform", "alpha", "kernel_size",
            "activation", "use_1x1", "condition_nice")})
