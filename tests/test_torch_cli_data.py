"""The port's copies of the JAX package's numpy-only data and config
modules against the originals: every shipped YAML through both loaders,
the synthetic tree written byte for byte alike, the samplers' index
streams, and ``StaticDataModule``'s batches byte for byte (train and val,
2 epochs, augmentation on and off, zero pokes on), the JAX side on its
cv2/numpy paths (``IPOKE_NATIVE=0``).  No JAX program runs here."""

import glob
import os

import numpy as np
import pytest

from ipoke_tpu.core.config import load_config as jax_load_config
from ipoke_tpu.data import datamodule as jdm
from ipoke_tpu.data import prep as jprep
from ipoke_tpu.data import samplers as jsamplers
from ipoke_tpu_torch.core.config import load_config
from ipoke_tpu_torch.data import datamodule as tdm
from ipoke_tpu_torch.data import prep as tprep
from ipoke_tpu_torch.data import samplers as tsamplers

from test_torch_ops import _few_threads  # noqa: F401 (one torch thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.relpath(p, ROOT) for p in
               glob.glob(os.path.join(ROOT, "config", "**", "*.yaml"), recursive=True))
S = 32
TREE = dict(n_videos=5, n_frames=14, spatial_size=S, flow_delta=4)


@pytest.mark.parametrize("path", YAMLS)
def test_config_loaders_agree(path):
    want = jax_load_config(os.path.join(ROOT, path))
    got = load_config(os.path.join(ROOT, path))
    assert got == want
    assert got.to_dict() == want.to_dict()


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("trees")
    a, b = str(root / "jax"), str(root / "port")
    return jprep.make_synthetic_dataset(a, **TREE), \
        tprep.make_synthetic_dataset(b, **TREE), a, b


def test_synthetic_dataset_identical(trees):
    meta_j, meta_t, a, b = trees
    files = sorted(os.path.relpath(p, a) for p in
                   glob.glob(os.path.join(a, "**", "*"), recursive=True)
                   if os.path.isfile(p))
    assert files == sorted(os.path.relpath(p, b) for p in
                           glob.glob(os.path.join(b, "**", "*"), recursive=True)
                           if os.path.isfile(p))
    assert any(f.endswith(".png") for f in files) and "meta.p" in files
    for f in files:
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    assert meta_j.keys() == meta_t.keys()
    for k in meta_j:
        np.testing.assert_array_equal(meta_t[k], meta_j[k])


@pytest.mark.parametrize("kind", ["fixed", "fixed_weighted_zero_poke",
                                  "sequence", "sequence_length"])
def test_sampler_streams_identical(kind):
    def make(mod):
        if kind == "fixed":
            return mod.FixedLengthSampler(37, 4, seed=3)
        if kind == "fixed_weighted_zero_poke":
            w = np.random.default_rng(0).uniform(0.1, 1.0, 37)
            return mod.FixedLengthSampler(37, 4, weights=w, zero_poke=True,
                                          zero_poke_amount=6, seed=5)
        if kind == "sequence":
            return mod.SequenceSampler(37, [1, 2, 3], 4, seed=7)
        return mod.SequenceLengthSampler(37, 5, 4, zero_poke=True,
                                         zeropoke_weight=2.0,
                                         longest_seq_weight=3.0, seed=9)

    j, t = make(jsamplers), make(tsamplers)
    for epoch in range(3):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j)
        assert len(t) == len(j)


def _data_cfg(augment: bool):
    cfg = {"dataset": "PlantDataset", "poke_size": 3, "max_frames": 3,
           "batch_size": 2, "n_workers": 2, "spatial_size": [S, S],
           "augment": augment, "n_pokes": 2, "zero_poke": True,
           "zero_poke_amount": 6, "scale_poke_to_res": True}
    if augment:
        cfg.update(p_col=0.8, p_geom=0.8, augment_b=0.4, augment_c=0.5,
                   augment_h=0.15, augment_s=0.4, aug_deg=15, aug_trans=[0.1, 0.1])
    return cfg


@pytest.mark.parametrize("augment", [False, True])
def test_datamodule_batches_bytewise(trees, augment, monkeypatch):
    """Train and val loaders of 2 epochs yield the same bytes under every
    key (images, poke, poke centres, flow) from the same tree and config."""
    monkeypatch.setenv("IPOKE_NATIVE", "0")
    _, _, root, _ = trees
    keys = ["images", "poke", "flow"]
    j = jdm.StaticDataModule(_data_cfg(augment), keys, data_root=root)
    t = tdm.StaticDataModule(_data_cfg(augment), keys, data_root=root)
    n = 0
    for epoch in range(2):
        for loader in ("train_loader", "val_loader"):
            got = list(getattr(t, loader)(epoch=epoch))
            want = list(getattr(j, loader)(epoch=epoch))
            assert len(got) == len(want) > 0
            for bt, bj in zip(got, want):
                assert bt.keys() == bj.keys()
                for k in bj:
                    assert bt[k].dtype == bj[k].dtype and bt[k].shape == bj[k].shape
                    assert bt[k].tobytes() == bj[k].tobytes(), (epoch, loader, k)
                n += 1
    assert n >= 8


def test_loader_raises_what_a_worker_raised():
    """An item that fails to load stops the epoch with its exception (the
    producer thread hands it to the consumer), and the producer ends."""
    class Broken:
        def get_item(self, idx, rng):
            if idx == 3:
                raise ValueError("corrupt item 3")
            return {"x": np.full(2, idx, np.float32)}

    loader = tdm.ThreadedLoader(Broken(), tsamplers.FixedLengthSampler(8, 2, shuffle=False),
                                n_workers=2)
    with pytest.raises(ValueError, match="corrupt item 3"):
        list(loader)
    got = list(tdm.ThreadedLoader(Broken(), tsamplers.FixedLengthSampler(3, 3, shuffle=False)))
    assert len(got) == 1 and got[0]["x"].shape == (3, 2)


def test_zero_poke_on_a_still_clip_draws_another():
    """A clip without motion has no poke value under ``zero_poke``: the
    port raises ``FlowError`` there, which the dataset's retry loop turns
    into another draw, where the JAX package fails in numpy; with motion
    both give the same poke."""
    from ipoke_tpu.data import poke as jpoke
    from ipoke_tpu_torch.data import poke as tpoke

    still = np.zeros((32, 32, 2), np.float32)
    with pytest.raises(tpoke.FlowError, match="no motion"):
        tpoke.simulate_poke(still, np.random.default_rng(0), 1, 5, zero_poke=True)
    with pytest.raises(ValueError):
        jpoke.simulate_poke(still, np.random.default_rng(0), 1, 5, zero_poke=True)
    moving = still.copy()
    moving[10:18, 12:20] = (4.0, -2.0)
    got = tpoke.simulate_poke(moving, np.random.default_rng(1), 1, 5, zero_poke=True)
    want = jpoke.simulate_poke(moving, np.random.default_rng(1), 1, 5, zero_poke=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
