"""The ``--test`` modes (counterpart of ``ipoke_tpu/cli/testing.py``;
reference ``experiments/second_stage_video.py:71-200`` and the test_step
modes of ``models/second_stage_video.py``), on a trained second stage:

* ``samples``: npy dumps, a poke-annotated mp4 grid and enrollment PNGs;
* ``fvd``: the real and fake uint8 dumps and the Fréchet video distance
  over the backbone of ``eval.backbone``;
* ``accuracy``: best-of-n SSIM / PSNR / VGG distance (and the keypoint MSE
  where the data carries keypoints), per-frame errorbars and CSVs;
* ``diversity``: the MSE, VGG and LPIPS diversity scores;
* ``control_sensitivity``: the same pixel re-poked in rotated directions,
  the Farneback response's alignment with each, multipoke grids;
* ``transfer``: kinematics transfer by residual swap onto each clip's
  nearest neighbour, with a random-residual control;
* ``kps_acc``: the keypoint MSE of the generated last frame.

Each restores the run's best checkpoint (``last`` under ``--last_ckpt``)
into the template ``--resume`` uses, draws from the experiment's
``generator`` and writes the JAX package's files and metric keys under
``<generated>/<mode>/``; ``--debug`` takes the JAX package's batch counts.
On a ``mixed_prec_master`` run the modes sample as the JAX package's do:
it restores the bf16 params into its fp32 template (orbax upcasts them)
and feeds the batch uncast, so the pass runs in fp32 from bf16-valued
weights (the frozen nets too, which its build casts to bf16); here the
restored bf16 model is upcast to fp32 (``_restore_trained``).  The modes
run the same way on a ``second_stage_fc`` run (fp32).
``realism`` (and ``accuracy`` on a third-stage run) needs the fork's FC
third stage, which is not ported (ROADMAP queue 1 item 8): on the ported
experiments they fail with the JAX package's assertion.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch


def _out_dir(experiment, mode: str) -> str:
    d = os.path.join(experiment.dirs["generated"], mode)
    os.makedirs(d, exist_ok=True)
    return d


# Annotated keypoints and the pose estimator share the COCO-17 layout, so
# equal joint counts mean the same joints; a count mismatch is refused
# unless an index map (n_pred, n_gt) -> (pred_idx, gt_idx) is registered.
_JOINT_LAYOUT_MAPS: Dict[tuple, tuple] = {}


def _aligned_joints(kps_pred: np.ndarray, kps_gt: np.ndarray):
    n_p, n_g = kps_pred.shape[1], kps_gt.shape[1]
    if n_p == n_g:
        return kps_pred, kps_gt
    if (n_p, n_g) in _JOINT_LAYOUT_MAPS:
        pi, gi = _JOINT_LAYOUT_MAPS[(n_p, n_g)]
        return kps_pred[:, list(pi)], kps_gt[:, list(gi)]
    raise ValueError(
        f"keypoint layout mismatch: estimator yields {n_p} joints but "
        f"annotations carry {n_g}; register an explicit index map in "
        f"_JOINT_LAYOUT_MAPS instead of truncating to a common prefix")


def _restore_trained(experiment, require_sampler: bool = True):
    """Build, then restore the best checkpoint (``last`` under
    ``general.last_ckpt``)."""
    experiment.build()
    if require_sampler:
        assert hasattr(experiment.model, "forward_sample"), (
            f"--test modes drive the sampling pipeline; experiment "
            f"{type(experiment).__name__} has no frozen-submodel sampler "
            f"(run them on second_stage/second_stage_fc runs)")
    experiment.restore(
        "last" if experiment.config.get_path("general.last_ckpt") else None)
    if getattr(experiment, "_mixed", False):
        experiment.model.float()  # fp32 activations, bf16-valued weights


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy()


def _sampling_batch(batch, keys=("images", "poke")):
    """The keys the model reads."""
    return {k: batch[k] for k in keys}


def _sample_fn(experiment):
    """One sampling pass of a batch: (B, T, H, W, 3) fp32 on the device."""
    T = experiment.config["data"]["max_frames"]
    model = experiment.model

    def sample(batch):
        return model.forward_sample(_sampling_batch(batch), T,
                                    experiment.generator).float()

    return sample


def _test_batches(experiment, n_batches: int):
    return experiment.batches(experiment.datamodule.test_loader(n_batches=n_batches))


def _test_batch_size(experiment) -> int:
    dm = experiment.datamodule
    return dm.config.get("test_batch_size", dm.batch_size)


def test_samples(experiment) -> Dict[str, float]:
    from ..utils.video import make_flow_video_grid, save_enrollment

    _restore_trained(experiment)
    tcfg = experiment.config.get("testing", {})
    n_batches = 1 if experiment.debug else max(
        1, int(tcfg.get("n_samples_vis", 20)) // _test_batch_size(experiment))
    n_spp = int(tcfg.get("n_samples_per_data_point", 3))
    d = _out_dir(experiment, "samples")
    sample = _sample_fn(experiment)
    bi = 0
    for bi, batch in enumerate(_test_batches(experiment, n_batches)):
        samples = np.stack([_host(sample(batch)) for _ in range(n_spp)], axis=1)
        real, poke, flow = (_host(batch[k]) for k in ("images", "poke", "flow"))
        np.save(os.path.join(d, f"samples_batch{bi}.npy"), samples)
        np.save(os.path.join(d, f"real_batch{bi}.npy"), real)
        # poke-annotated animated grid + per-sample enrollment strips
        # (reference _generate_samples, second_stage_video.py:906-957)
        make_flow_video_grid(
            real[:, 0], poke, list(samples.swapaxes(0, 1)), real[:, 1:],
            flow, os.path.join(d, f"grid_batch{bi}.mp4"), fps=3)
        for i in range(min(4, samples.shape[0])):
            save_enrollment(samples[i, 0],
                            os.path.join(d, f"enrollment_b{bi}_s{i}.png"))
    return {"n_batches": float(bi + 1)}


def test_fvd(experiment) -> Dict[str, float]:
    from ..eval import compute_fvd, init_fvd_backbone

    _restore_trained(experiment)
    tcfg = experiment.config.get("testing", {})
    n_batches = 2 if experiment.debug else max(
        1, int(tcfg.get("n_samples_fvd", 1000)) // _test_batch_size(experiment))
    sample = _sample_fn(experiment)
    reals, fakes = [], []
    for batch in _test_batches(experiment, n_batches):
        reals.append(_host(batch["images"][:, 1:]))
        fakes.append(_host(sample(batch)))
    real, fake = np.concatenate(reals), np.concatenate(fakes)
    d = _out_dir(experiment, "fvd")
    np.save(os.path.join(d, "real_samples.npy"), ((real + 1) * 127.5).astype(np.uint8))
    np.save(os.path.join(d, "fake_samples.npy"), ((fake + 1) * 127.5).astype(np.uint8))
    backbone = init_fvd_backbone(experiment.device)
    fvd = compute_fvd(backbone, real, fake, batch_size=min(8, real.shape[0]))
    result = {"FVD": float(fvd), "n_samples": float(real.shape[0])}
    with open(os.path.join(d, "fvd.json"), "w") as f:
        json.dump(result, f)
    return result


def _keypoint_artifacts(experiment, d: str, pf_kps, n_spp: int) -> None:
    """The reference's keypoint-error artifact set (second_stage_video_fc.py
    :125-133, utils/logging.py:979-1010): the per-frame CSV, the errorbar
    PDF and the per-Time group CSV."""
    from ..utils.plots import group_mean, make_errorbar_plot, to_csv

    kps = np.stack(pf_kps)  # (N, T)
    n_pokes = int(experiment.config["data"].get("n_pokes", 1))
    frame = {
        "Time": np.tile(np.arange(kps.shape[1]), kps.shape[0]),
        "Mean MSE per Frame": kps.reshape(-1),
        "Std per Frame": np.tile(kps.std(axis=0), kps.shape[0]),
        "Number of Pokes": [n_pokes] * kps.size,
    }
    to_csv(frame, os.path.join(d, f"plot_data_{n_spp}pokes_kps-aggregated.csv"))
    make_errorbar_plot(
        os.path.join(d, f"keypoint_err_plot_{n_spp}samples-aggregated.pdf"),
        frame, xid="Time", yid="Mean MSE per Frame", hueid="Number of Pokes",
        varid="Std per Frame")
    to_csv(group_mean(frame, "Time"), os.path.join(d, "plot_data_kps_group.csv"))


@torch.no_grad()
def test_accuracy(experiment) -> Dict[str, float]:
    from .. import entry
    from ..eval.metrics import perceptual_distance, psnr, ssim
    from ..utils.latent_viz import plot_metric_errorbars

    _restore_trained(experiment)
    vgg = entry.build_vgg(experiment.device)
    tcfg = experiment.config.get("testing", {})
    n_spp = int(tcfg.get("n_samples_per_data_point", 5))
    n_batches = 2 if experiment.debug else 10
    sample = _sample_fn(experiment)
    # the pose-net keypoint MSE where the data carries keypoints (reference
    # _test_step_metrics, second_stage_video.py:692-754)
    dset = experiment.datamodule.dset_test
    est = None
    spatial = experiment.config["data"]["spatial_size"]
    if getattr(dset, "keypoints", None) is not None:
        from ..eval.pose import pose_estimator_from_env

        est = pose_estimator_from_env(experiment.device)
        if "keypoints_rel" not in dset.datakeys:
            dset.datakeys.append("keypoints_rel")
    kps_errs = []
    best_ssim, best_lpips, best_psnr = [], [], []
    pf_ssim, pf_psnr, pf_lpips, pf_kps = [], [], [], []
    for batch in _test_batches(experiment, n_batches):
        tgt = batch["images"][:, 1:]
        B, T = tgt.shape[:2]
        a = tgt.reshape(-1, *tgt.shape[2:])
        per_sample = {"ssim": [], "lpips": [], "psnr": []}
        for s in range(n_spp):
            b = sample(batch).reshape(a.shape)
            ss = ssim(a, b).cpu().numpy().reshape(B, T)
            ps = psnr(a, b).cpu().numpy().reshape(B, T)
            pf = perceptual_distance(vgg, a, b).cpu().numpy().reshape(B, T)
            per_sample["ssim"].append(ss.mean(-1))
            per_sample["psnr"].append(ps.mean(-1))
            per_sample["lpips"].append(pf.mean(-1))
            if s == 0:
                pf_lpips.extend(pf)
                pf_ssim.extend(ss)
                pf_psnr.extend(ps)
                if est is not None and "keypoints_rel" in batch:
                    # the keypoints_rel datakey's per-axis normalisation
                    kps_pred = est(b) / np.asarray(spatial, np.float32)
                    rel = _host(batch["keypoints_rel"][:, 1:])
                    kp, kg = _aligned_joints(kps_pred, rel.reshape(-1, *rel.shape[2:]))
                    kps_errs.append(np.mean((kp - kg) ** 2))
                    pf_kps.extend(((kp - kg) ** 2).mean(axis=(1, 2)).reshape(B, T))
        best_ssim.append(np.max(per_sample["ssim"], axis=0))
        best_psnr.append(np.max(per_sample["psnr"], axis=0))
        best_lpips.append(np.min(per_sample["lpips"], axis=0))
    result = {
        "ssim_best_of_n": float(np.mean(np.concatenate(best_ssim))),
        "psnr_best_of_n": float(np.mean(np.concatenate(best_psnr))),
        "lpips_best_of_n": float(np.mean(np.concatenate(best_lpips))),
    }
    if kps_errs:
        result["kps_mse"] = float(np.mean(kps_errs))
    d = _out_dir(experiment, "accuracy")
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump(result, f)
    plot_metric_errorbars(
        {"ssim": np.stack(pf_ssim), "psnr": np.stack(pf_psnr),
         "lpips": np.stack(pf_lpips)},
        os.path.join(d, "per_frame_metrics.png"),
        csv_path=os.path.join(d, "per_frame_metrics.csv"))
    if pf_kps:
        _keypoint_artifacts(experiment, d, pf_kps, n_spp)
    return result


def test_diversity(experiment) -> Dict[str, float]:
    from .. import entry
    from ..eval.metrics import (
        diversity_score_lpips,
        diversity_score_mse,
        diversity_score_vgg,
    )
    from ..nn.lpips import init_lpips, load_torch_lpips_npz

    _restore_trained(experiment)
    tcfg = experiment.config.get("testing", {})
    n_spp = int(tcfg.get("n_samples_per_data_point", 5))
    n_batches = 1 if experiment.debug else 5
    sample = _sample_fn(experiment)
    samples = np.concatenate([
        np.stack([_host(sample(batch)) for _ in range(n_spp)], axis=1)
        for batch in _test_batches(experiment, n_batches)])
    # the learned LPIPS variant (reference compute_div_score_lpips); real
    # heads through IPOKE_LPIPS_WEIGHTS
    lp = os.environ.get("IPOKE_LPIPS_WEIGHTS")
    lpips = load_torch_lpips_npz(lp, experiment.device) if lp \
        else init_lpips(0, experiment.device)
    result = {
        "divscore_mse": diversity_score_mse(samples),
        "divscore_vgg": diversity_score_vgg(entry.build_vgg(experiment.device), samples),
        "divscore_lpips": diversity_score_lpips(lpips, samples),
    }
    d = _out_dir(experiment, "diversity")
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump(result, f)
    return result


def _u8(img: np.ndarray) -> np.ndarray:
    from ..utils.video import to_uint8

    return to_uint8(np.asarray(img, np.float32))


def _generated_motion_direction(x0_u8, xT_u8, y, x, win: int = 8):
    """Mean Farneback-flow vector (dx, dy) of the generated clip around
    (y, x): the measured response to a poke."""
    import cv2

    g0 = cv2.cvtColor(x0_u8, cv2.COLOR_RGB2GRAY)
    gT = cv2.cvtColor(xT_u8, cv2.COLOR_RGB2GRAY)
    fl = cv2.calcOpticalFlowFarneback(g0, gT, None, 0.5, 3, 9, 3, 5, 1.2, 0)
    patch = fl[max(0, y - win): y + win + 1, max(0, x - win): x + win + 1]
    return patch.reshape(-1, 2).mean(0)


def test_control_sensitivity(experiment) -> Dict[str, float]:
    """Re-poke the same pixel in ``n_control_sensitivity_pokes`` evenly
    spaced directions (4 under ``--debug``) at the amplitude of a random
    above-mean flow location, one sample each (reference
    ``_control_sensitivity``, second_stage_video.py:797-902), and report
    ``direction_correlation``: the mean cosine between each poke's direction
    and the Farneback motion of the generated clip at the poke."""
    from ..utils.video import make_multipoke_grid, save_enrollment, save_video

    _restore_trained(experiment)
    n_dirs = 4 if experiment.debug else int(
        experiment.config.get("testing", {}).get("n_control_sensitivity_pokes", 8))
    half = int(experiment.config["data"].get("poke_size", 5)) // 2
    sample = _sample_fn(experiment)
    d = _out_dir(experiment, "control_sensitivity")
    cos_sims, responses = [], []
    rng = np.random.default_rng(experiment.config["general"].get("seed", 42))
    for batch in _test_batches(experiment, 1):
        poke = _host(batch["poke"])
        B, H, W = poke.shape[:3]
        flow = _host(batch["flow"]) if "flow" in batch else poke
        coords = batch["poke_coords"].cpu().numpy() if "poke_coords" in batch else None
        images = _host(batch["images"])
        mag = np.linalg.norm(poke, axis=-1)
        ys, xs = np.unravel_index(mag.reshape(B, -1).argmax(-1), (H, W))
        if coords is not None:
            # zero-poke elements carry (-1, -1) centres: the argmax stays
            valid = coords[:, 0, 0] >= 0
            ys = np.where(valid, coords[:, 0, 0], ys)
            xs = np.where(valid, coords[:, 0, 1], xs)
        # amplitude per element: |flow| at a random above-mean location
        amp = np.linalg.norm(flow, axis=-1)
        phases = np.empty(B, np.float32)
        for b in range(B):
            valid = np.argwhere(amp[b] > amp[b].mean())
            if valid.shape[0] == 0:
                valid = np.asarray([[ys[b], xs[b]]])
            vy, vx = valid[rng.integers(valid.shape[0])]
            phases[b] = amp[b, vy, vx]
        all_pokes, all_vids = [poke], [_host(sample(batch))]
        for k in range(n_dirs):
            ang = 2 * np.pi * k / n_dirs
            d_vec = np.stack([np.cos(ang) * phases, np.sin(ang) * phases], -1)
            new_poke = np.zeros_like(poke)
            for b in range(B):
                y, x = int(ys[b]), int(xs[b])
                new_poke[b, max(0, y - half): y + half + 1,
                         max(0, x - half): x + half + 1] = d_vec[b]
            nb = dict(batch, poke=torch.as_tensor(new_poke, device=batch["poke"].device))
            vid = _host(sample(nb))
            all_pokes.append(new_poke)
            all_vids.append(vid)
            for b in range(B):
                y, x = int(ys[b]), int(xs[b])
                move = _generated_motion_direction(_u8(images[b, 0]), _u8(vid[b, -1]),
                                                   y, x)
                n_move = np.linalg.norm(move)
                responses.append(float(n_move))
                if n_move > 1e-3:
                    u = d_vec[b] / (phases[b] + 1e-8)
                    # pokes copy flow values, (dx, dy) like the Farneback
                    # response: dot(move, u) is the aligned correlation, the
                    # swapped order a debug field
                    cos_sims.append((float(np.dot(move / n_move, u)),
                                     float(np.dot(move[::-1] / n_move, u))))
        # overview grid + per-poke singles + enrollments under sid_<id>
        pokes_np = np.stack(all_pokes, axis=1)  # (B, n_dirs+1, H, W, 2)
        vids_np = np.stack(all_vids, axis=1)    # (B, n_dirs+1, T, H, W, 3)
        sids = batch["sample_ids"].cpu().numpy()[:, 0] if "sample_ids" in batch \
            else np.arange(B)
        for b in range(min(B, 4)):
            sd = os.path.join(d, f"sid_{int(sids[b])}")
            os.makedirs(sd, exist_ok=True)
            singles = make_multipoke_grid(images[b, 0], pokes_np[b], images[b, 1:],
                                          vids_np[b], os.path.join(sd, "overview.mp4"))
            for i, sv in enumerate(singles):
                tag = "groundtruth_poke" if i == 0 else f"sample_{i}"
                save_video(sv, os.path.join(sd, f"{tag}.mp4"))
                save_enrollment(sv, os.path.join(sd, f"{tag}_enrollment.png"))
    if cos_sims:
        m_xy = float(np.mean([c[0] for c in cos_sims]))
        m_yx = float(np.mean([c[1] for c in cos_sims]))
    else:
        m_xy = m_yx = 0.0
    result = {
        "direction_correlation": m_xy,
        "direction_correlation_swapped_debug": m_yx,
        "poke_region_response": float(np.mean(responses)),
        "n_directions": float(n_dirs),
    }
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump(result, f)
    return result


@torch.no_grad()
def transfer_videos(model, batch, length: int, generator=None, z_rand=None):
    """The clip's residual under its own conditioning (the density pass),
    inverted under its neighbour's (``nn_images``' start frame with the
    clip's poke) and decoded on the neighbour; and the same from ``z_rand``
    (drawn from ``generator`` without one), the random-residual control."""
    r1, _ = model.forward_density(batch, generator)
    batch_b = {"images": batch["nn_images"], "poke": batch["poke"]}
    if z_rand is None:
        z_rand = torch.randn(r1.shape, generator=generator, device=r1.device,
                             dtype=r1.dtype)
    return (model.forward_sample(batch_b, length, z=r1),
            model.forward_sample(batch_b, length, z=z_rand.to(r1.dtype)))


def test_transfer(experiment) -> Dict[str, float]:
    """Kinematics transfer (reference ``_test_transfer``,
    second_stage_video.py:959-1045): each clip's nearest neighbour (the
    ``nn`` datakey), ``transfer_videos``; ``transfer_grid-<b>.mp4`` (source
    | target x0 | transfer | random) and per-pair row mp4s and enrollment
    PNGs keyed by both sample ids."""
    from ..utils.video import make_transfer_grid, save_enrollment, save_video

    _restore_trained(experiment)
    T = experiment.config["data"]["max_frames"]
    d = _out_dir(experiment, "transfer")
    n_batches = 1 if experiment.debug else 2
    dset = experiment.datamodule.dset_test
    if "nn" not in dset.datakeys:
        dset.datakeys.append("nn")
    n_done = 0
    for bi, batch in enumerate(_test_batches(experiment, n_batches)):
        vid, vid_rand = transfer_videos(
            experiment.model,
            _sampling_batch(batch, ("images", "poke", "nn_images")),
            T, experiment.generator)
        vid, vid_rand = _host(vid), _host(vid_rand)
        np.save(os.path.join(d, f"transfer_batch{bi}.npy"), vid)
        make_transfer_grid(_host(batch["images"][:, 1:]), _host(batch["nn_images"][:, 0]),
                           vid, os.path.join(d, f"transfer_grid-{bi}.mp4"),
                           extra=[vid_rand])
        sids1 = batch["sample_ids"].cpu().numpy()[:, 0] if "sample_ids" in batch \
            else np.arange(vid.shape[0])
        sids2 = batch["nn_sample_ids"].cpu().numpy()[:, 0]
        for b in range(min(vid.shape[0], 4)):
            tag = f"ids_m{int(sids1[b])}_src{int(sids2[b])}"
            save_video(vid[b], os.path.join(d, f"transfer_row-{tag}.mp4"))
            save_enrollment(vid[b], os.path.join(d, f"transfer_grid-{tag}.png"))
        n_done += vid.shape[0]
    return {"n_transferred": float(n_done)}


def test_kps_acc(experiment) -> Dict[str, float]:
    """Keypoint error of the generated last frame (reference
    ``_test_step_kps_acc``, second_stage_video.py:772-794): with keypoint
    metadata, the keypoint poke and the annotated target; without, the pose
    net on the real last frame."""
    from ..eval.pose import keypoint_mse, pose_estimator_from_env

    _restore_trained(experiment)
    est = pose_estimator_from_env(experiment.device)
    sample = _sample_fn(experiment)
    dset = experiment.datamodule.dset_test
    has_kp = getattr(dset, "keypoints", None) is not None
    if has_kp and "keypoint_poke" not in dset.datakeys:
        dset.datakeys.append("keypoint_poke")
        dset.datakeys.append("keypoints_abs")
    n_batches = 2 if experiment.debug else 10
    errs = []
    for batch in _test_batches(experiment, n_batches):
        if has_kp:
            batch = dict(batch, poke=batch["keypoint_poke"])
        vid = sample(batch)
        kps_fake = est(vid[:, -1])
        kps_real = _host(batch["keypoints_abs"][:, -1]) if has_kp \
            else est(batch["images"][:, -1])
        errs.append(keypoint_mse(kps_fake, kps_real, norm=vid.shape[2]))
    result = {"kps_mse": float(np.mean(np.concatenate(errs))),
              "annotated_keypoints": float(has_kp)}
    d = _out_dir(experiment, "kps_acc")
    with open(os.path.join(d, "metrics.json"), "w") as f:
        json.dump(result, f)
    return result


def _require_third_stage(experiment):
    assert getattr(experiment, "evaluates_hallucinated_flow", False), (
        f"--test realism / third-stage accuracy evaluate the fork's "
        f"hallucinated-flow pipeline (run them on third_stage_fc runs); "
        f"{type(experiment).__name__} has no flow-hallucination pipeline")


def test_realism(experiment) -> Dict[str, float]:
    """The third stage's FID of hallucinated against real flow: only the FC
    third stage evaluates hallucinated flow (ROADMAP queue 1 item 8)."""
    _require_third_stage(experiment)
    raise NotImplementedError("--test realism is not ported yet (ROADMAP "
                              "queue 1 item 8)")


def test_accuracy_third_stage(experiment) -> Dict[str, float]:
    """The third stage's flow-error categories (ROADMAP queue 1 item 8)."""
    _require_third_stage(experiment)
    raise NotImplementedError("third-stage --test accuracy is not ported yet "
                              "(ROADMAP queue 1 item 8)")


_MODES = {
    "samples": test_samples,
    "fvd": test_fvd,
    "accuracy": test_accuracy,
    "diversity": test_diversity,
    "control_sensitivity": test_control_sensitivity,
    "transfer": test_transfer,
    "kps_acc": test_kps_acc,
    "realism": test_realism,
}


def run_test(experiment, mode: str) -> Dict[str, float]:
    assert mode in _MODES, f"unknown test mode {mode!r} ({sorted(_MODES)})"
    fn = _MODES[mode]
    # `--test accuracy` on a third-stage run is the fork's flow-error
    # fan-out (reference third_stage_video_fc.py:371-415)
    if mode == "accuracy" and getattr(experiment, "evaluates_hallucinated_flow", False):
        fn = test_accuracy_third_stage
    result = fn(experiment)
    experiment.logger.info(f"--test {mode}: {result}")
    return result
