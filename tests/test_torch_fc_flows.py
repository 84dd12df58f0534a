"""The port's flat (vector-latent) flows, radial base and gated update
against the JAX package, fp32 on the CPU: the conditional and unconditional
flat flows (``ipoke_tpu_torch/flows/fc.py``) with the JAX package's weights
carried by ``convert.flow_params`` (forward, logdet, inverse and DDI within
1e-5), the round trip, the logdet against autograd's log|det J|,
``reference_logdet`` on and off; the radial NLL and flow loss, and the law
of the radial base draw; ``core.optim.gated_update`` against the JAX
package's over Adam at gate 0 and 1.  The JAX side runs eagerly
(``jax.disable_jit``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.core import optim as joptim
from ipoke_tpu.flows import fc as jfc
from ipoke_tpu.flows import loss as jloss
from ipoke_tpu.models.fc_baseline import SecondStageModelFC as JSecondStageModelFC
from ipoke_tpu_torch.convert import flow_params, to_numpy_tree
from ipoke_tpu_torch.core.optim import gan_adam, gated_update
from ipoke_tpu_torch.flows import fc as tfc
from ipoke_tpu_torch.flows import loss as tloss

from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill, _x

K = jax.random.PRNGKey
D, DC, HID, B = 8, 6, 16, 5
TOL = 1e-5


def _arch(**kw):
    return dict(flow_in_channels=D, h_channels=DC, flow_mid_channels=HID,
                flow_hidden_depth=2, **kw)


def _pair(kind, reference_logdet=False, n_flows=3):
    """(JAX flow, port flow, numpy params): the conditional flow (odd
    n_flows: the stacked pairs and the leftover block) or the unconditional
    one."""
    if kind == "conditional":
        arch = _arch(n_flows=n_flows, reference_logdet=reference_logdet)
        jflow, port = jfc.build_supervised_transformer(arch), tfc.build_supervised_transformer(arch)
    else:
        arch = _arch(n_flows=2)
        jflow, port = jfc.build_unsupervised_transformer3(arch), \
            tfc.build_unsupervised_transformer3(arch)
    shapes = jax.eval_shape(lambda: jflow.init(K(0), (1, D)))
    return jflow, port, _fill(shapes, np.random.default_rng(3))


def _assert_tree_close(got, want, where="params"):
    """A port tree against a numpy tree of the same nesting, key by key."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            _assert_tree_close(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_tree_close(a, b, f"{where}/{i}")
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL, err_msg=where)


def _inputs(kind):
    x = _x((B, D), 4, 1.5)
    h = _x((B, DC), 5) if kind == "conditional" else None
    return x, h


@pytest.mark.parametrize("kind,reference_logdet", [
    ("conditional", False), ("conditional", True), ("unconditional", False)])
def test_flat_flow_matches_jax(kind, reference_logdet):
    """forward (y, logdet), inverse and DDI (output, logdet, new params)
    against the JAX flow on the same params; the round trip.  (The
    unconditional flow has no leaky relu.)"""
    jflow, port, values = _pair(kind, reference_logdet)
    x, h = _inputs(kind)
    jh = None if h is None else jnp.asarray(h)
    th = None if h is None else _t(h)
    params = flow_params(values)
    with jax.disable_jit():
        y, ld = jflow.forward(_jnp(values), jnp.asarray(x), jh)
        x_back = jflow.inverse(_jnp(values), y, jh)
        dy, dld, dparams = jflow.ddi(_jnp(values), jnp.asarray(x), jh)
    got_y, got_ld = port.forward(params, _t(x), th)
    np.testing.assert_allclose(got_y.numpy(), _np(y), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_ld.numpy(), _np(ld), atol=TOL, rtol=TOL)
    got_x = port.inverse(params, _t(_np(y)), th)
    np.testing.assert_allclose(got_x.numpy(), _np(x_back), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(port.inverse(params, got_y, th).numpy(), x, atol=TOL)
    got_dy, got_dld, got_dparams = port.ddi(params, _t(x), th)
    np.testing.assert_allclose(got_dy.numpy(), _np(dy), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_dld.numpy(), _np(dld), atol=TOL, rtol=TOL)
    _assert_tree_close(got_dparams, to_numpy_tree(dparams))
    if reference_logdet:  # the leaky relus report 0: logdets differ by their sum
        _, ld_true = _pair(kind, False)[1].forward(params, _t(x), th)
        assert (ld_true - got_ld).abs().max() > 1e-3


@pytest.mark.parametrize("kind", ["conditional", "unconditional"])
def test_flat_flow_logdet_matches_autograd(kind):
    """The per-sample logdet is log|det dy/dx| (the leaky relu's included),
    at D = 8."""
    _, port, values = _pair(kind)
    params = flow_params(values)
    x, h = _inputs(kind)
    for b in range(B):
        hb = None if h is None else _t(h[b:b + 1])
        fn = lambda v: port.forward(params, v[None], hb)[0][0]
        jac = torch.autograd.functional.jacobian(fn, _t(x[b]))
        want = torch.linalg.slogdet(jac.double())[1].item()
        got = port.forward(params, _t(x[b:b + 1]), hb)[1].item()
        assert abs(got - want) < 1e-4, (b, got, want)


def test_radial_nll_and_flow_loss_match_jax():
    z, logdet = _x((B, D), 6), _x((B,), 7)
    want = jloss.nll(jnp.asarray(z), radial=True)
    np.testing.assert_allclose(tloss.nll(_t(z), radial=True).numpy(), _np(want),
                               rtol=1e-6, atol=1e-6)
    ref = _x((B, D), 8)
    loss, log = tloss.flow_loss(_t(z), _t(logdet), reference=_t(ref), radial=True)
    jl, jlog = jloss.flow_loss(jnp.asarray(z), jnp.asarray(logdet), radial=True)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    for k in jlog:
        np.testing.assert_allclose(log[k].item(), float(jlog[k]), rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(log["reference_nll_loss"].item(),
                               float(jnp.mean(jloss.nll(jnp.asarray(ref), radial=True))),
                               rtol=1e-6)
    # dof is sum(shape[1:]) - 1 of the (B, 1, 1, D) view: 1 + 1 + D - 1
    r = np.linalg.norm(z, axis=1)
    np.testing.assert_allclose(tloss.nll(_t(z), radial=True).numpy(),
                               (1 + D) * np.log(r) + 0.5 * r ** 2, rtol=1e-5)


def test_radial_base_draw_law():
    """Both packages' radial draws: unit directions times |N(0, 1)|: the
    norms' mean and spread agree with the half-normal's (sqrt(2/pi) and
    sqrt(1 - 2/pi)) and with each other; values differ (other RNGs)."""
    n = 20000
    jmodel = object.__new__(JSecondStageModelFC)
    jmodel.flow_in_channels, jmodel.radial = D, True
    with jax.disable_jit():
        jz = np.asarray(jmodel.sample_base(K(9), n))
    tz = tloss.radial_sample((n, D), torch.Generator().manual_seed(9)).numpy()
    mean, std = np.sqrt(2 / np.pi), np.sqrt(1 - 2 / np.pi)
    for z in (jz, tz):
        r = np.linalg.norm(z, axis=1)
        assert abs(r.mean() - mean) < 0.02 and abs(r.std() - std) < 0.02
        mu = (z / r[:, None]).mean(axis=0)  # directions: no preferred one
        assert np.abs(mu).max() < 0.03
    assert abs(np.linalg.norm(jz, axis=1).mean() - np.linalg.norm(tz, axis=1).mean()) < 0.03


def test_gated_update_matches_jax():
    """gan_adam over 3 updates gated 1, 0, 1: params and Adam's moments as
    the JAX package's ``gated_update``; at gate 0 nothing of the optimizer
    moves (params, moments, step count)."""
    rng = np.random.default_rng(10)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) for p in p0]
             for _ in range(3)]
    tx = joptim.gan_adam(1e-2, 1e-2)
    params = [jnp.asarray(p) for p in p0]
    opt = tx.init(params)
    port = [torch.tensor(p) for p in p0]
    ptx = gan_adam(port, 1e-2, 1e-2)
    for gate, g in zip((1.0, 0.0, 1.0), grads):
        params, opt = joptim.gated_update(tx, jnp.float32(gate),
                                          [jnp.asarray(x) for x in g], opt, params)
        before = ([q.clone() for q in port],
                  [{k: v.clone() for k, v in ptx.adam.state[q].items()} for q in port],
                  ptx.count)
        for q, x in zip(port, g):
            q.grad = torch.tensor(x)
        assert gated_update(ptx, torch.tensor(gate)) == (gate > 0)
        assert all(q.grad is None for q in port)
        if gate == 0:
            assert all(torch.equal(a, b) for a, b in zip(before[0], port))
            assert ptx.count == before[2]
            for a, q in zip(before[1], port):
                assert all(torch.equal(a[k], ptx.adam.state[q][k]) for k in a)
        for a, q in zip(params, port):
            np.testing.assert_allclose(q.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)
        adam = opt[1]  # (add_decayed_weights, scale_by_adam, scale_by_lr)
        for q, mu, nu in zip(port, adam.mu, adam.nu):
            np.testing.assert_allclose(ptx.adam.state[q]["exp_avg"].numpy(),
                                       np.asarray(mu), rtol=1e-6, atol=1e-8)
            np.testing.assert_allclose(ptx.adam.state[q]["exp_avg_sq"].numpy(),
                                       np.asarray(nu), rtol=1e-6, atol=1e-8)
        assert ptx.count == int(adam.count)
