"""Multi-camera end-to-end demo (port of ``playground3d_tpu/apps/demo_e2e_mc.py``):
train the full-frame detector AND the crop detector on synthetic traffic,
then run the multi-camera crop tracker (detection every d frames, crop
re-detection between) across three overlapping cameras - every network
real, no oracle.

The three cameras share the training camera's intrinsics/pose, shifted along
the roadway (translation-invariant geometry), so one trained detector serves
all views - mirroring the I-24 deployment where one detector serves 18
near-identical pole cameras.

Runs on the CUDA card unless ``--device cpu``: training takes its batches
from ``Prefetcher(device=)`` (pinned staging on a side stream, the copy of
the next batch overlapping the step) with the loss in
``csrc/focal_loss.cu``; tracking runs the clip loop of captured CUDA graphs
(``MultiCameraTracker.track``), or one eager ``process`` a frame with
``--per-frame``. The log lines keep the JAX app's format, which
``scripts/ship_decision.py`` reads.

Usage:
    python -m playground3d_tpu_torch.apps.demo_e2e_mc --steps 600 --crop-steps 400 \\
        --frames 60 --det-step 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def shifted_registry(ds, shifts):
    """Registry of cameras = the dataset camera translated along x."""
    from playground3d_tpu_torch.geometry.homography import CameraRegistry

    reg = CameraRegistry()
    projectors = {}
    rng = np.random.default_rng(123)
    h, w = ds.image_shape
    for i, dx in enumerate(shifts):
        name = f"p1c{i + 1}"

        def project(p3, dx=dx):
            p = np.array(p3, dtype=np.float64)
            p[:, 0] = p[:, 0] - dx
            return ds._project(p)

        sp = np.stack([rng.uniform(450 + dx, 680 + dx, 24), rng.uniform(0, 120, 24)], 1)
        corr = project(np.concatenate([sp, np.zeros((24, 1))], 1))
        vp_z = project(np.array([[550.0 + dx, 60.0, -1e7]]))[0]
        reg.add_camera(name, corr, sp, np.array([[1e6, h / 2], [w / 2, 1e6], vp_z]))

        # calibrate P's z-column against true-projected 3D boxes — an
        # uncalibrated z scale renders/reprojects garbage vertical geometry
        from playground3d_tpu_torch.evaluation import geometry_np as G
        from playground3d_tpu_torch.geometry.homography import scale_P_z

        states = np.stack(
            [
                rng.uniform(460 + dx, 660 + dx, 10),
                rng.uniform(10, 110, 10),
                rng.uniform(14, 20, 10),
                rng.uniform(5.5, 7, 10),
                rng.uniform(4, 6, 10),
                np.ones(10),
            ],
            axis=1,
        )
        space = G.state_to_space(states)
        boxes_im = project(space.reshape(-1, 3)).reshape(-1, 8, 2).astype(np.float32)
        ci = reg.index(name)
        P = scale_P_z(reg.P[ci, 0], boxes_im, states[:, 4].astype(np.float32), reg.H[ci, 0])
        reg.set_P(name, P)
        projectors[name] = project
    return reg, projectors


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--crop-steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--det-step", type=int, default=3)
    ap.add_argument("--skip-step", type=int, default=1,
                    help="crop re-detection cadence between detections")
    ap.add_argument("--pre-topk", type=int, default=1024,
                    help="detect-branch candidate pool (cfg.pre_topk)")
    ap.add_argument("--cd-max", type=int, default=16)
    ap.add_argument("--w-conf", type=float, default=None,
                    help="best-box selection confidence weight (cfg.w_conf)")
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--zoom", type=float, default=1.5)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument(
        "--quantize", action="store_true",
        help="PTQ both trained networks to int8 before tracking (models/quant)",
    )
    ap.add_argument(
        "--approx-topk", action="store_true",
        help="accepted for the JAX app's flag; the port's top-k is exact either way",
    )
    ap.add_argument("--det-ckpt", default=None, help="skip detector training")
    ap.add_argument("--crop-ckpt", default=None, help="skip crop training")
    ap.add_argument(
        "--resume", action="store_true",
        help="warm-start training from the periodic out-prefix checkpoints "
        "if present (optimizer state is reinitialized, only params carry over)",
    )
    ap.add_argument("--out-prefix", default="_outputs/demo_mc")
    ap.add_argument(
        "--per-frame", action="store_true",
        help="track with one process() call per frame (eager) instead of "
        "the clip loop of captured CUDA graphs (latency-style run)",
    )
    ap.add_argument(
        "--sequences", type=int, default=1,
        help="fresh scenes tracked with the same nets (quality-gate spread)",
    )
    ap.add_argument(
        "--track-seeds", type=int, default=1,
        help="render seeds per scene (quality-gate spread)",
    )
    ap.add_argument(
        "--size-nudge", action="store_true",
        help="class-size KF nudge in the crop branch (measurement model 3)",
    )
    ap.add_argument(
        "--ghost-frames", type=int, default=0,
        help="ghost re-identification window (frames past f_max a dead "
        "track's id can be reclaimed by a reappearing detection; 0 = "
        "reference behavior)",
    )
    ap.add_argument(
        "--crop-conf-gate", action="store_true",
        help="skip crop-branch KF updates below sigma_c (the reference "
        "updates unconditionally; gating stops occluded tracks drifting "
        "toward noise boxes — a d>=6 quality candidate)",
    )
    ap.add_argument(
        "--crop-r2-size", type=float, default=1.0,
        help="scale the crop measurement noise (R2) on the l,w,h "
        "components. Crop-derived sizes are the low-information part of "
        "the measurement (small FOV, class-prior heights), and with R2=I "
        "they are re-trusted every crop frame; >1 de-weights them so "
        "position stays corrected while sizes ride detections + the class "
        "nudge (the reference FIT R2 from data, fit_filter_3D.py:306-392, "
        "which discovers exactly this anisotropy)",
    )
    ap.add_argument(
        "--f-max", type=int, default=5,
        help="failed re-detection attempts before track death (reference "
        "f_max=5, MC3D:69). At d>=6 the default kills a track whose crops "
        "miss within ONE detection gap — the next full-frame detection "
        "never gets to rescue it — so d>=6 gates sweep this",
    )
    ap.add_argument(
        "--f-init", type=int, default=2,
        help="output burn-in: a track is reported only once age > f_init "
        "(reference 'frames before permanent', util_track/config f_init). "
        "Output-mask only — tracking state/fps are untouched. At d>=6/s=2 "
        "cadence, junk tracks born from one false detection survive 4-10 "
        "frames before f_max kills them (vs 1-3 at d=3), so the d3-tuned "
        "default of 2 stops suppressing them from the CSV; cadence gates "
        "sweep this together with f_max",
    )
    ap.add_argument(
        "--tentative-age", type=int, default=0,
        help="tentative-kill: one failed re-detection attempt while "
        "age <= this kills the track outright (no re-id ghost). Junk "
        "tracks born from a single false detection die in 1-2 frames — "
        "inside the f_init burn-in — instead of surviving f_max attempts "
        "(4-10 reported FP frames at d>=6/s=2 cadence); confirmed tracks "
        "are untouched. 0 = reference rule (f_max uniformly)",
    )
    ap.add_argument(
        "--crop-slots", type=int, default=0,
        help="live slots cropped per crop frame, oldest first (0 = all); "
        "the crop step's cost scales with this pool and at d>=6 crop "
        "frames dominate, so 16 vs 32 is a first-order fps lever whose "
        "quality cost this A/B measures",
    )
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.apps.demo_e2e import frozen
    from playground3d_tpu_torch.data.dataset import Prefetcher, SyntheticDetectionDataset
    from playground3d_tpu_torch.models import retinanet_init
    from playground3d_tpu_torch.models.nn import load_params, save_params, save_step_sidecar
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:7.1f}s] {msg}", flush=True)

    shape = (args.height, args.width)
    # uint8 to the device, normalized there by forward_raw: 4x fewer bytes
    # to copy than normalized float32. Real cameras deliver uint8 anyway.
    ds = SyntheticDetectionDataset(
        image_shape=shape, n_objects=6, seed=0, augment=True, zoom=args.zoom,
        output_dtype="uint8",
    )

    def train(cfg, dataset, steps, tag, ckpt_path=None):
        init_model = None
        step0 = 0
        if args.resume and ckpt_path and os.path.exists(ckpt_path):
            init_model = load_params(
                ckpt_path,
                retinanet_init(torch.Generator().manual_seed(0), depth=args.depth, stem=cfg.stem,
                               device=device),
            )
            # sidecar step counter: a retry resumes the loop where the last
            # periodic save left it (optimizer state is rebuilt; only params
            # carry over)
            try:
                with open(ckpt_path + ".step") as f:
                    step0 = int(f.read().strip())
            except (OSError, ValueError):
                step0 = 0
            log(f"{tag}: warm-starting from {ckpt_path} at step {step0}")
        if step0 >= steps:
            log(f"{tag}: checkpoint already at step {step0} >= {steps}, skipping")
            return init_model
        trainer = Trainer(cfg, generator=torch.Generator().manual_seed(0), model=init_model, device=device)
        # the Prefetcher stages each batch on a side stream while the step
        # before it runs (the JAX app's double-buffered device_put)
        pf = Prefetcher(factory=dataset.batch_factory(args.batch), workers=args.workers, depth=4, device=device)
        try:
            for step in range(step0, steps):
                frames, labels = next(pf)
                m = trainer.train_step(frames, labels)
                if step % 100 == 0:
                    log(f"{tag} step {step}: loss={float(m['loss']):.4f}")
                # periodic checkpoint: a 500-step save bounds what a killed
                # run loses
                if ckpt_path and step and step % 500 == 0:
                    save_params(ckpt_path, trainer.model)
                    # params on disk include step's update -> resume at step+1
                    save_step_sidecar(ckpt_path + ".step", step + 1)
        finally:
            pf.close()
        final = frozen(trainer.model)
        if ckpt_path:
            # persist the final params before declaring training complete: a
            # premature .step=steps would make --resume skip the tail
            save_params(ckpt_path, final)
            save_step_sidecar(ckpt_path + ".step", steps)
        log(f"{tag} done: loss={float(m['loss']):.4f}")
        return final

    # 1. full-frame detector (s2d stem)
    if args.det_ckpt:
        det_model = load_params(
            args.det_ckpt,
            retinanet_init(torch.Generator().manual_seed(0), depth=args.depth, stem="s2d", device=device),
        )
        log("loaded detector checkpoint")
    else:
        det_model = train(
            TrainConfig(depth=args.depth, stem="s2d", image_shape=shape, lr=3e-4),
            ds, args.steps, "detector", ckpt_path=args.out_prefix + "_det.npz",
        )
        save_params(args.out_prefix + "_det.npz", det_model)

    # 2. crop detector (conv7 stem at 112^2 crops)
    if args.crop_ckpt:
        crop_model = load_params(
            args.crop_ckpt, retinanet_init(torch.Generator().manual_seed(1), depth=args.depth, device=device)
        )
        log("loaded crop checkpoint")
    else:
        crop_ds = SyntheticDetectionDataset(
            image_shape=shape, n_objects=6, seed=1, augment=True, zoom=args.zoom,
            crop_mode=True, crop_size=112, output_dtype="uint8",
        )
        crop_model = train(
            TrainConfig(depth=args.depth, stem="conv7", image_shape=(112, 112), lr=3e-4),
            crop_ds, args.crop_steps, "crop-detector", ckpt_path=args.out_prefix + "_crop.npz",
        )
        save_params(args.out_prefix + "_crop.npz", crop_model)

    if args.quantize:
        from playground3d_tpu_torch.models.quant import quantize_detector

        calib, _ = ds.batch_factory(args.batch)()
        det_model = quantize_detector(det_model, torch.as_tensor(calib).to(device))
        calib_crop_ds = SyntheticDetectionDataset(
            image_shape=shape, n_objects=6, seed=1, augment=True, zoom=args.zoom,
            crop_mode=True, crop_size=112, output_dtype="uint8",
        )
        crop_calib, _ = calib_crop_ds.batch_factory(args.batch)()
        crop_model = quantize_detector(crop_model, torch.as_tensor(crop_calib).to(device))
        log("both networks quantized to int8 (PTQ)")

    # train-only stage: with --sequences 0 the run ends after training /
    # quantization, and tracking runs separately from --det-ckpt/--crop-ckpt
    if args.sequences <= 0 or args.track_seeds <= 0:
        log("train-only run complete (no tracking requested)")
        return None

    # 3. multi-camera tracking with both trained networks
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, render_frame
    from playground3d_tpu_torch.evaluation import geometry_np as G
    from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
    from playground3d_tpu_torch.evaluation.mot import MOTEvaluator
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.track.kf import default_params
    from playground3d_tpu_torch.utils.config import TrackerConfig
    from playground3d_tpu_torch.utils.constants import CLASS_NAMES

    shifts = [0.0, 160.0, 320.0]
    reg, projectors = shifted_registry(ds, shifts)
    cameras = list(projectors.keys())
    centers = np.array([[565.0 + dx, 60.0] for dx in shifts], np.float32)
    lo, hi = 445.0, 680.0 + shifts[-1]

    tcfg = TrackerConfig(
        max_tracks=32, max_dets=48, pre_topk=args.pre_topk, x_range=(lo - 30, hi + 30),
        f_init=args.f_init, sigma_d=0.25, sigma_c=0.2, f_max=args.f_max, det_step=args.det_step,
        tentative_age=args.tentative_age,
        skip_step=args.skip_step, cd_max=args.cd_max, crop_slots=args.crop_slots,
        **({} if args.w_conf is None else {"w_conf": args.w_conf}),
        estimate_ts_bias=False, merge_dist_ft=12.0, approx_topk=args.approx_topk,
        size_nudge=args.size_nudge, crop_conf_gate=args.crop_conf_gate,
        ghost_frames=args.ghost_frames,
    )

    def track_one(scene_seed: int, render_seed: int, tag: str):
        """One fresh sequence tracked with the SAME trained nets -> metrics."""
        scene = SyntheticScene(
            n_objects=10, seed=scene_seed, x_spawn=(lo + 20, hi - 20), x_visible=(lo, hi)
        )
        kfp = default_params(device=device)
        if args.crop_r2_size != 1.0:
            r2 = kfp.R2.clone()
            r2[2:, 2:] *= args.crop_r2_size
            kfp = kfp._replace(R2=r2)
        tracker = MultiCameraTracker(
            reg, cameras, cfg=tcfg, kf_params=kfp,
            det_model=det_model, crop_model=crop_model,
            centers=centers, stem="s2d", crop_stem="conv7", device=device,
        )

        # frames ship as uint8 (the tracker packs them to s2d on the device)
        def cam_source(ci):
            rng_c = np.random.default_rng([render_seed, ci])
            for f in range(args.frames):
                t = f / 30.0
                frame, _ = render_frame(
                    scene, t, reg.P[ci, 0], height=args.height,
                    width=args.width, rng=rng_c, normalized=False,
                )
                yield (np.clip(frame, 0.0, 1.0) * 255.0).astype(np.uint8), 1.6e9 + t

        if args.per_frame:
            # one process() call per frame (eager; latency-style run)
            rng = np.random.default_rng(render_seed)
            for f in range(args.frames):
                t = f / 30.0
                frames = [
                    (np.clip(fr, 0.0, 1.0) * 255.0).astype(np.uint8)
                    for fr, _ in (
                        render_frame(
                            scene, t, reg.P[ci, 0], height=args.height,
                            width=args.width, rng=rng, normalized=False,
                        )
                        for ci in range(len(cameras))
                    )
                ]
                tracker.process(np.stack(frames), [1.6e9 + t] * 3, f)
        else:
            # the shipped clip loop: 24-frame clips, each branch a captured
            # CUDA graph on the card, one read a clip
            tracker.track([cam_source(ci) for ci in range(len(cameras))])
        pred_path = f"{args.out_prefix}_{tag}_pred.csv"
        tracker.write_results_csv(pred_path)

        gt = []
        for f in range(args.frames):
            t = f / 30.0
            states, idx = scene.states_at(t)
            if len(states) == 0:
                continue
            space = G.state_to_space(states)
            im = G.space_to_im(space, reg.P[0, 0])
            for i in range(len(states)):
                gt.append(
                    TrackRecord(
                        frame=f, timestamp=1.6e9 + t, obj_id=int(idx[i]),
                        class_name=CLASS_NAMES[int(scene.classes[idx[i]])],
                        state7=states[i], im_corners=im[i],
                        space_footprint=space[i, 0:4, :2], camera=cameras[0],
                    )
                )
        gt_path = f"{args.out_prefix}_{tag}_gt.csv"
        write_results_csv(gt_path, gt)
        ev = MOTEvaluator(
            gt_path, pred_path, reg.H[0, 0], reg.P[0, 0], match_iou=0.2,
            cutoff_frame=args.frames,
        )
        return ev.evaluate()

    # quality gate: >=1 sequences x >=1 render seeds with the same nets.
    # Fixed seeds first (comparable across A/B runs), deterministic
    # extension beyond them so --sequences/--track-seeds never silently
    # truncate the requested spread.
    scene_seeds = ([99, 231, 47] + [1000 + 13 * i for i in range(args.sequences)])[
        : args.sequences
    ]
    render_seeds = ([5, 17] + [2000 + 7 * i for i in range(args.track_seeds)])[
        : args.track_seeds
    ]
    all_metrics = []
    for ss in scene_seeds:
        for rs in render_seeds:
            m = track_one(ss, rs, f"s{ss}r{rs}")
            all_metrics.append(m)
            log(
                f"seq seed={ss} render={rs}: recall {m['Recall']:.3f} "
                f"precision {m['Precision']:.3f} MOTA {m['MOTA']:.3f} "
                f"IDs {m['ID switches']}"
            )

    keys = ["TP", "FP", "FN", "Recall", "Precision", "MOTA", "ID switches"]
    log(
        f"MC e2e metrics over {len(all_metrics)} runs "
        f"(trained det + crop nets, d={args.det_step}, s={args.skip_step}, "
        f"size_nudge={args.size_nudge}): mean +- std"
    )
    for k in keys:
        vals = np.array([float(m[k]) for m in all_metrics])
        print(f"  {k:<12}: {vals.mean():.3f} +- {vals.std():.3f}", flush=True)
    # the mean metrics dict (the JAX app's single-run shape)
    metrics = {k: float(np.mean([float(m[k]) for m in all_metrics])) for k in keys}
    metrics["spread"] = {
        k: float(np.std([float(m[k]) for m in all_metrics])) for k in keys
    }
    metrics["runs"] = all_metrics
    return metrics


if __name__ == "__main__":
    main()
