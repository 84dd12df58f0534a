"""The ``--test`` slice against the JAX package, fp32 on the CPU:

* ``forward_sample`` fed the z that the JAX model draws from its key
  matches the JAX video within 2e-3, and ``cli.testing.transfer_videos``
  (the density pass under the clip's conditioning, the inverse of its
  residual under the neighbour's, the decode on the neighbour, and the
  random-residual control from JAX's draw) matches the JAX mode's body
  within 2e-3: ``entry.FLOW_MOTION_TINY``'s second stage (deterministic
  first stage, motion encoder), the same weights carried by ``convert``;
* on a ``mixed_prec_master`` run the modes sample as the JAX package's: its
  ``--test`` restores the bf16 params into its fp32 template and feeds the
  batch uncast, so it samples in fp32 from bf16-valued weights (its frozen
  nets cast to bf16 at build); the port's restored bf16 model is upcast to
  fp32 (``cli.testing._restore_trained``).  With weights that bf16 holds
  exactly, one difference is left: JAX runs the frozen nets' spectral norm
  on the bf16 weights in bf16, the port collapses it in fp32 when it loads
  them and then rounds (ROADMAP §3);
  all JAX sides are this file's one jitted program;
* ``--test accuracy``, ``diversity``, ``control_sensitivity`` and ``fvd``
  of both packages, run through their own mode functions on the same videos (a
  stub sampler hands both the same table of clips, in draw order) with the
  same VGG19 and LPIPS (random torch-layout npz files named by
  ``IPOKE_VGG_WEIGHTS`` and ``IPOKE_LPIPS_WEIGHTS``): the metrics within
  1e-5 relative, control sensitivity's equal.  The JAX modes run eagerly
  (``jax.disable_jit``)."""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipoke_tpu.cli import testing as jtesting
from ipoke_tpu.data.synthetic import make_batch as jax_make_batch
from ipoke_tpu.models.second_stage import FrozenBundle
from ipoke_tpu_torch import entry
from ipoke_tpu_torch.cli import testing as ttesting
from ipoke_tpu_torch.convert import flow_params, load_flax
from ipoke_tpu_torch.core.config import Config

from test_torch_lpips import _torch_lpips_npz
from test_torch_ops import _few_threads, _jnp, _np, _t  # noqa: F401 (_few_threads)
from test_torch_sampling import _fill
from test_torch_train import _jax_model

K = jax.random.PRNGKey
SS = entry.FLOW_MOTION_TINY["second_stage"]
S, M, B, T = SS["spatial"], SS["min_spatial"], SS["batch_size"], SS["T"]
SAMPLE_KEY, TRANSFER_KEY = K(3), K(4)


def _batch(seed):
    b = jax_make_batch(np.random.default_rng(seed), batch_size=B, n_frames=T,
                       spatial_size=S)
    return {k: b[k] for k in ("images", "poke", "flow")}


@pytest.fixture(scope="module")
def slice_ref():
    """The JAX model and the port's with the same weights, a batch with a
    neighbour's clip, and the JAX side's outputs and draws."""
    jmodel, shapes = _jax_model(SS, False)
    values = _fill(shapes, np.random.default_rng(11))
    frozen = {k: FrozenBundle(_jnp(values[k]["params"]),
                              _jnp(values[k].get("batch_stats", {})))
              for k in ("fs", "cond", "poke")}
    port = entry.make_model(SS, flow_params(values["flow"]))
    for sub, name in ((port.first_stage, "fs"), (port.conditioner, "cond"),
                      (port.poke_embedder, "poke")):
        load_flax(sub, values[name]["params"], values[name].get("batch_stats"))
    batch = dict(_batch(0), nn_images=_batch(1)["images"])
    # the JAX --test state of a mixed run, on weights that bf16 holds
    # exactly: the frozen nets cast to bf16 at build, the checkpoint's bf16
    # params restored into the fp32 template
    values_b = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        if a.dtype.kind == "f" else a, values)
    frozen_mixed = {k: FrozenBundle(_jnp(values_b[k]["params"], jnp.bfloat16),
                                    _jnp(values_b[k].get("batch_stats", {}), jnp.bfloat16))
                    for k in ("fs", "cond", "poke")}
    port_b = entry.make_model(SS, flow_params(values_b["flow"]))
    for sub, name in ((port_b.first_stage, "fs"), (port_b.conditioner, "cond"),
                      (port_b.poke_embedder, "poke")):
        load_flax(sub, values_b[name]["params"], values_b[name].get("batch_stats"))

    @jax.jit
    def run(params, frozen, batch, params_mixed, frozen_mixed):
        # forward_sample's own draw: z ~ N(0, I) from its key
        z_shape = jmodel.flow.output_shape((M, M, jmodel.flow_in_channels))
        out = {"video": jmodel.forward_sample(params, frozen, batch, SAMPLE_KEY, length=T),
               "video_mixed": jmodel.forward_sample(params_mixed, frozen_mixed, batch,
                                                    SAMPLE_KEY, length=T),
               "z": jax.random.normal(SAMPLE_KEY, (B, *z_shape), jnp.float32)}
        # the body of the JAX package's test_transfer
        r1, _ = jmodel.forward_density(params, frozen, batch, TRANSFER_KEY)
        batch_b = {"images": batch["nn_images"], "poke": batch["poke"]}
        cond_b = jmodel.embed_conditioning(frozen, batch_b, params)

        def decode(residual):
            motion = jmodel.flow.inverse(params["flow"], residual, cond_b)
            return jmodel.decode_first_stage(frozen, motion, batch_b["images"][:, 0], T)

        z_rand = jax.random.normal(TRANSFER_KEY, r1.shape, r1.dtype)
        out.update(transfer=decode(r1), transfer_rand=decode(z_rand), z_rand=z_rand)
        return out

    ref = run({"flow": _jnp(values["flow"])}, frozen, _jnp(batch),
              {"flow": _jnp(values_b["flow"])}, frozen_mixed)
    assert ref["video_mixed"].dtype == jnp.float32
    ref = jax.tree_util.tree_map(_np, ref)
    return port.eval(), batch, dict(ref, port_bf16_exact=port_b.eval())


def test_forward_sample_with_jax_draw_matches_jax(slice_ref):
    port, batch, ref = slice_ref
    tb = {k: _t(v) for k, v in batch.items()}
    got = port.forward_sample(tb, T, z=_t(ref["z"]))
    assert got.shape == (B, T, S, S, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref["video"], atol=2e-3)


def test_mixed_run_samples_as_jax(slice_ref):
    """``--test`` on a mixed run: the restored model (bf16 params and frozen
    nets, as ``SecondStageTrainer.start`` casts them) comes out of
    ``_restore_trained`` in fp32 and samples from the uncast batch, as the
    JAX package's modes do.  The frames' mean error stays within 5e-3 and
    their largest within 5e-2 of JAX's (the spectral norm's rounding order;
    the module docstring), half or less of what a bf16 pass on the same
    model reads."""
    import copy

    port, batch, ref = slice_ref
    port = ref["port_bf16_exact"]
    mixed = copy.deepcopy(port).to(torch.bfloat16)
    run = SimpleNamespace(_mixed=True, model=mixed, build=lambda: None,
                          restore=lambda name=None: None,
                          config=Config({"general": {}}))
    ttesting._restore_trained(run)
    assert all(p.dtype == torch.float32 for p in mixed.parameters())
    tb = ttesting._sampling_batch({k: _t(v) for k, v in batch.items()})
    got = mixed.forward_sample(tb, T, z=_t(ref["z"]))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = np.abs(got.numpy() - ref["video_mixed"])
    assert err.mean() < 5e-3 and err.max() < 5e-2, (err.mean(), err.max())
    bf16 = copy.deepcopy(port).to(torch.bfloat16).forward_sample(
        {k: v.to(torch.bfloat16) for k, v in tb.items()}, T,
        z=_t(ref["z"], torch.bfloat16)).float()
    assert np.abs(bf16.numpy() - ref["video_mixed"]).mean() > 2 * err.mean()


def test_transfer_matches_jax(slice_ref):
    port, batch, ref = slice_ref
    tb = {k: _t(v) for k, v in batch.items()}
    vid, vid_rand = ttesting.transfer_videos(port, tb, T, z_rand=_t(ref["z_rand"]))
    np.testing.assert_allclose(vid.numpy(), ref["transfer"], atol=2e-3)
    np.testing.assert_allclose(vid_rand.numpy(), ref["transfer_rand"], atol=2e-3)
    # the transfer depends on the residual: not the random control's video
    assert np.abs(ref["transfer"] - ref["transfer_rand"]).max() > 1e-2


# ---------------------------------------------------------------------------
# the modes' metrics on the same videos
# ---------------------------------------------------------------------------

CFG = {"general": {"seed": 3, "experiment": "second_stage"},
       "data": {"max_frames": T, "spatial_size": [S, S], "poke_size": 3, "n_pokes": 1},
       "testing": {"n_samples_per_data_point": 2}}


class _Data:
    def __init__(self, batches):
        self.batches, self.batch_size, self.config = batches, B, {"batch_size": B}
        self.dset_test = SimpleNamespace(datakeys=["images", "poke", "flow"], keypoints=None)

    def test_loader(self, n_batches=None):
        return [dict(b) for b in self.batches[:n_batches]]


class _JaxRun:
    """What the JAX package's modes read of an experiment; the sampler
    returns the table's clip indexed by the draw (``next_rng``)."""

    debug = True

    def __init__(self, videos, batches, out):
        self.config, self.datamodule = Config(CFG), _Data(batches)
        self.dirs, self.frozen, self.i = {"generated": out}, {}, 0
        self.state = SimpleNamespace(params={})
        self.store = SimpleNamespace(restore_best=lambda s: s)
        table = jnp.asarray(videos)
        self.model = SimpleNamespace(
            forward_sample=lambda p, f, b, r, length: table[r])

    def build(self):
        pass

    def next_rng(self):
        self.i += 1
        return self.i - 1


class _PortRun:
    """What the port's modes read of an experiment; the sampler returns the
    table's clips in draw order."""

    debug, device, _mixed, generator = True, torch.device("cpu"), False, None

    def __init__(self, videos, batches, out):
        self.config, self.datamodule = Config(CFG), _Data(batches)
        self.dirs, self.i, self.videos = {"generated": out}, 0, videos
        self.model = SimpleNamespace(forward_sample=self.sample)

    def sample(self, batch, length, generator=None):
        self.i += 1
        return torch.tensor(self.videos[self.i - 1])

    def build(self):
        pass

    def restore(self, name=None):
        pass

    def batches(self, loader):
        return ({k: torch.as_tensor(v) for k, v in b.items()} for b in loader)


@pytest.fixture(scope="module")
def weights_env(tmp_path_factory):
    """Random torchvision-layout VGG19 and torch LPIPS npz files (He-scaled
    VGG kernels: see ``test_torch_lpips._he``)."""
    root = tmp_path_factory.mktemp("weights")
    rng = np.random.default_rng(12)
    state, idx, cin = {}, 0, 3
    for ch, n in ((64, 2), (128, 2), (256, 4), (512, 4), (512, 1)):
        for _ in range(n):
            state[f"features.{idx}.weight"] = (rng.standard_normal((ch, cin, 3, 3))
                                               * (2 / (9 * cin)) ** 0.5).astype(np.float32)
            state[f"features.{idx}.bias"] = (0.05 * rng.standard_normal(ch)).astype(np.float32)
            cin, idx = ch, idx + 2
        idx += 1
    vgg = str(root / "vgg19.npz")
    np.savez(vgg, **state)
    lpips = _torch_lpips_npz(str(root / "lpips.npz"), rng)
    raw = dict(np.load(lpips))
    for k in raw:
        if k.endswith(".weight") and raw[k].ndim == 4 and k.startswith("net."):
            raw[k] = raw[k] * np.float32((2 / np.prod(raw[k].shape[1:])) ** 0.5)
    np.savez(lpips, **raw)
    return {"IPOKE_VGG_WEIGHTS": vgg, "IPOKE_LPIPS_WEIGHTS": lpips}


def _clips(seed, n):
    """n clips (B, T, S, S, 3): the test batch's frames, moved and under
    N(0, 0.6^2) noise each.  The VGG score is 1 - cos in fp32, whose
    rounding (~1e-7) is 1e-5 of a score near 0.003: clips as alike as under
    N(0, 0.2^2) put it there on both sides."""
    base = _batch(0)["images"][:, 1:]
    rng = np.random.default_rng(seed)
    return [np.clip(np.roll(base, i, axis=3) + 0.6 * rng.standard_normal(base.shape), -1, 1)
            .astype(np.float32) for i in range(n)]


def _estimator(frames):
    """A stand-in pose estimator for both packages: 17 (x, y) keypoints in
    pixels from each frame's mean over 17 row bands."""
    f = np.asarray(frames, np.float32)[:, :17].mean(axis=(2, 3))  # (B, 17)
    return (S * (0.5 + 0.4 * np.stack([np.sin(3 * f), np.cos(5 * f)], -1))).astype(np.float32)


def _with_keypoints(run, batches, seed):
    """The dataset carries keypoints: the accuracy mode adds the keypoint
    MSE and the reference's keypoint-error artifact set."""
    run.datamodule.dset_test.keypoints = np.zeros(1)
    rng = np.random.default_rng(seed)
    for b in batches:
        b["keypoints_rel"] = rng.random((B, T + 1, 17, 2)).astype(np.float32)


@pytest.mark.parametrize("mode,n_videos,n_batches", [
    ("accuracy_keypoints", 4, 2), ("diversity", 2, 1), ("control_sensitivity", 5, 1),
    ("fvd", 2, 2)])
def test_mode_metrics_match_jax(mode, n_videos, n_batches, weights_env, tmp_path,
                                monkeypatch):
    """Accuracy runs on a dataset with keypoints (the keypoint-free path is
    the same but for the keypoint block: ``test_torch_cli_testing.py``);
    both packages' pose estimators are one stand-in (``_estimator``), and
    the keypoint CSVs are compared parsed."""
    from test_torch_video import _assert_same_csv

    for k, v in weights_env.items():
        monkeypatch.setenv(k, v)
    videos = _clips(13, n_videos)
    batches = [_batch(20 + i) for i in range(n_batches)]
    jrun = _JaxRun(videos, batches, str(tmp_path / "jax"))
    prun = _PortRun(videos, batches, str(tmp_path / "port"))
    name = mode
    if mode == "accuracy_keypoints":
        from ipoke_tpu.eval import pose as jpose
        from ipoke_tpu_torch.eval import pose as tpose

        name = "accuracy"
        for run in (jrun, prun):
            _with_keypoints(run, batches, 14)
        monkeypatch.setattr(jpose, "pose_estimator_from_env", lambda *a: _estimator)
        monkeypatch.setattr(tpose, "pose_estimator_from_env", lambda *a: _estimator)
    with jax.disable_jit():
        want = getattr(jtesting, f"test_{name}")(jrun)
    got = getattr(ttesting, f"test_{name}")(prun)
    assert jrun.i == prun.i == n_videos
    assert got.keys() == want.keys()
    assert ("kps_mse" in want) == (name == "accuracy")
    for k in want:
        rtol = 0.0 if mode == "control_sensitivity" else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    files = sorted(os.listdir(tmp_path / "port" / name))
    assert files == sorted(os.listdir(tmp_path / "jax" / name))
    for f in files:
        if f.startswith("plot_data_"):
            _assert_same_csv(str(tmp_path / "port" / name / f),
                             str(tmp_path / "jax" / name / f))
