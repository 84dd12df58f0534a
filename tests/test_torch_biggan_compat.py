"""The port's reference FCAE (``models/biggan_compat.py``) against the JAX
package's, fp32 on the CPU: one reference-format state dict, drawn from a
seed (every GANalyze spectral norm as ``weight_bar`` / ``weight_u`` /
``weight_v``, every BatchNorm with running statistics off their init),
loaded by both packages' loaders (the JAX package's converter, the port's
collapse and ``load_state_dict``); encode (mu, logvar) and decode within
1e-4 at resnet18 and at resnet50 (bottleneck blocks and their
downsampling), the spectral-norm collapse equal, and the npz loader and
the third stage's ``flow_encoder.torch_compat_npz`` option giving the same
net.  The JAX side runs eagerly: no program is compiled."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.models import biggan_compat as jbc
from ipoke_tpu_torch.models import biggan_compat as tbc

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

Z, CHN, B, S = 48, 8, 2, 64


def reference_state(enc_type, seed):
    """A state dict in the reference's format for ``BigAECompat(Z,
    enc_type, 2, CHN)``: its keys, each spectrally normed layer's weight
    as (weight_bar, weight_u, weight_v), fan-in scaled kernels, BatchNorms
    with affine and running statistics near but off identity."""
    with torch.device("meta"):
        net = tbc.BigAECompat(Z, enc_type, 2, CHN)
    sn = {name + ".module." for name, m in net.named_modules() if isinstance(m, tbc._SN)}
    rng = np.random.default_rng(seed)
    state = {}
    for key, t in net.state_dict().items():
        shape = tuple(t.shape)
        prefix = key[:key.rindex(".") + 1]
        if key.endswith("num_batches_tracked"):
            state[key] = np.zeros((), np.int64)
        elif key.endswith(("running_mean", "bias")) and len(shape) == 1:
            state[key] = 0.05 * rng.standard_normal(shape)
        elif key.endswith("running_var"):
            state[key] = rng.uniform(0.8, 1.2, shape)
        elif len(shape) == 1:  # a BatchNorm's scale
            state[key] = rng.uniform(0.8, 1.2, shape)
        elif prefix in sn:
            state[prefix + "weight_bar"] = rng.standard_normal(shape)
            state[prefix + "weight_u"] = rng.standard_normal(shape[0])
            state[prefix + "weight_v"] = rng.standard_normal(int(np.prod(shape[1:])))
        else:
            state[key] = rng.standard_normal(shape) * (1.0 / np.prod(shape[1:])) ** 0.5
    return {k: np.asarray(v, np.int64 if v.dtype == np.int64 else np.float32)
            for k, v in state.items()}


def test_collapse_spectral_norm_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((16, 8, 3, 3)).astype(np.float32)
    u = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_array_equal(tbc.collapse_spectral_norm(w, u),
                                  jbc.collapse_spectral_norm(w, u))


class _Narrow(tbc.BigAECompat):
    """``BigAECompat`` at this file's width (the loaders build the
    reference's, ``chn`` 96)."""

    def __init__(self, z_dim, enc_type="resnet101", in_channels=2):
        super().__init__(z_dim, enc_type, in_channels, CHN)


@pytest.mark.parametrize("enc_type", ["resnet18", "resnet50"])
def test_bigae_compat_matches_jax(enc_type, tmp_path, monkeypatch):
    state = reference_state(enc_type, {"resnet18": 1, "resnet50": 2}[enc_type])
    jmodel = jbc.BigAECompat(Z, enc_type, 2, CHN)
    variables = jbc.convert_torch_bigae(state, Z, enc_type)
    port = tbc.load_torch_bigae(tbc.BigAECompat(Z, enc_type, 2, CHN), state)
    x = np.random.default_rng(3).uniform(-1, 1, (B, S, S, 2)).astype(np.float32)
    mu, logvar = jmodel.encode(variables, jnp.asarray(x))
    got_mu, got_logvar = port.encode(torch.as_tensor(x))
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(mu), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_logvar.numpy(), np.asarray(logvar), rtol=1e-4, atol=1e-4)
    dec = np.asarray(jmodel.decode(variables, mu))
    got = port.decode(torch.tensor(np.asarray(mu)))
    assert got.shape == (B, S, S, 2) and np.abs(dec).max() > 1e-2
    np.testing.assert_allclose(got.numpy(), dec, rtol=1e-4, atol=1e-4)
    # the third stage's torch_compat_npz option (the reference's extra keys
    # ignored) loads the same net
    from ipoke_tpu_torch.cli.fc_experiments import load_flow_encoder

    path = str(tmp_path / "fcae.npz")
    extra = "decoder.decoder.attention.theta.module."
    np.savez(path, **state, **{extra + "weight_bar": np.ones((2, 3), np.float32),
                               extra + "weight_u": np.ones(2, np.float32),
                               extra + "weight_v": np.ones(3, np.float32)})
    monkeypatch.setattr(tbc, "BigAECompat", _Narrow)
    loaded = load_flow_encoder({"flow_encoder": {
        "torch_compat_npz": path, "z_dim": Z, "type": enc_type}}, None)
    assert isinstance(loaded, _Narrow) and not loaded.training
    for a, b in zip(loaded.state_dict().values(), port.state_dict().values()):
        assert torch.equal(a, b)


def test_load_refuses_a_state_without_a_layer():
    state = reference_state("resnet18", 1)
    del state["encoder.model.layer2.0.conv1.weight"]
    with pytest.raises(KeyError, match="layer2.0.conv1.weight"):
        tbc.load_torch_bigae(tbc.BigAECompat(Z, "resnet18", 2, CHN), state)
