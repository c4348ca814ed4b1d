"""Tracking CLI (port of ``playground3d_tpu/apps/track.py``): single-camera
(reference minimal_3D_track.py __main__) and multi-camera crop tracking
(MC3D_crop_tracker.py __main__) over a synthetic scene, with CSV output,
optional ground truth and MOT evaluation; and ``--mode session``, the
production flow over a recording session's directory.

Usage:
    python -m playground3d_tpu_torch.apps.track --mode single --frames 100 \\
        --out out.csv [--gt-out gt.csv] [--eval] [--checkpoint det.npz] [--device cpu]
    python -m playground3d_tpu_torch.apps.track --mode multi --cameras 3 --oracle ...
    python -m playground3d_tpu_torch.apps.track --mode session --session-dir DIR \\
        --registry cams.npz [--ignore-dir ignored_regions] [--emit s2d_u8|yuv420|f32] ...

The detector is ``retinanet_init`` from a fixed ``torch.Generator`` seed
(the JAX app uses ``PRNGKey(0)``), so the two apps share weights only
through ``--checkpoint`` and ``--crop-checkpoint``, files written by either
package's ``save_params``. ``--device`` picks where the port runs (default
the card).
"""

from __future__ import annotations

import argparse

import numpy as np


def _synthetic_registry(n_cameras: int):
    """Build a synthetic multi-camera registry + scene ranges + centres."""
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain

    reg, ranges, centers, _ = toy_camera_chain(n_cameras)
    return reg, ranges, centers


def _detector(path, seed: int, depth: int, device, stem: str = "conv7"):
    import torch

    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import retinanet_init

    model = retinanet_init(torch.Generator().manual_seed(seed), depth=depth, stem=stem, device=device)
    return load_params(path, model) if path else model


def track_session(args, device):
    """Track the recordings of an ingest session directory: camera and
    segment discovery (data/session), decode with burned-in timestamps
    parsed at native size and the 4K->1080p host tails (data/video), the
    cameras' ignore regions (data/regions), and the clip tracker on
    ``device`` (the JAX app's ``track_session``; reference
    MC3D_crop_tracker.py __main__:1469-1651). Returns ``track_clips``'
    stats plus the sources' host seconds by stage ("read", "ts", "tail")."""
    import itertools
    import os

    from playground3d_tpu_torch.data.regions import load_ignore_regions
    from playground3d_tpu_torch.data.session import find_files, get_recording_params
    from playground3d_tpu_torch.data.video import VideoFrameSource
    from playground3d_tpu_torch.geometry.homography import CameraRegistry
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig, tracking_x_range

    # camera geometry: npz registry or a reference homography pickle
    if args.registry.endswith((".cpkl", ".pkl")):
        from playground3d_tpu_torch.tools.ref_interop import registry_from_reference_pickle

        reg = registry_from_reference_pickle(args.registry)
    else:
        reg = CameraRegistry.load(args.registry)

    rec_dirs, fmts, cam_names = get_recording_params(args.session_dir)
    cameras = [c for c in cam_names if c in reg.names]
    files = find_files(rec_dirs, fmts, cam_names, drop_last_file=False)
    by_cam = {c: [f for f in files if f[3] == c] for c in cameras}
    if not any(by_cam.values()):
        raise ValueError(f"{args.session_dir}: no recordings found for the registry's cameras {reg.names}")

    ignore = load_ignore_regions(args.ignore_dir, cameras) if args.ignore_dir else None
    try:
        x_range = tracking_x_range(cameras)
    except KeyError:
        x_range = (0.0, 2000.0)
    cfg = TrackerConfig(
        max_tracks=64, max_dets=64, x_range=x_range, f_init=2,
        det_step=args.det_step, crop_slots=32,
    )
    det = _detector(args.checkpoint, 0, args.depth, device, stem="s2d")
    crop = _detector(args.crop_checkpoint, 1, 18, device, stem="s2d") if args.crop_checkpoint else None
    tracker = MultiCameraTracker(
        reg, cameras, cfg=cfg, det_model=det, crop_model=crop, stem="s2d", crop_stem="s2d",
        ignore_polygons=ignore, image_hw=(args.height, args.width), device=device,
    )

    opened = []

    def segment(d, fn):
        src = VideoFrameSource(os.path.join(d, fn), resize_hw=(args.height, args.width), emit=args.emit)
        opened.append(src)
        return src

    def cam_source(cam):
        # segments open one after another as the previous one ends
        return itertools.chain.from_iterable(segment(d, fn) for d, fn, _, _ in by_cam[cam])

    stats = tracker.track_clips(
        [cam_source(c) for c in cameras], clip_len=args.clip_len, cutoff=args.frames,
        # flat planar YUV buffers need the frame geometry for the on-card
        # conversion to s2d frames
        yuv_hw=(args.height, args.width) if args.emit == "yuv420" else None,
    )
    tracker.write_results_csv(args.out)
    for stage in ("read", "ts", "tail"):
        stats[stage] = sum(src.timers[stage] for src in opened)
    print(f"session: tracked {stats['frames']} frames at {stats['fps']:.1f} fps -> {args.out}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", default="single", choices=["single", "multi", "session"])
    ap.add_argument("--session-dir", default=None, help="ingest session directory (mode=session)")
    ap.add_argument("--registry", default=None, help="camera registry .npz or reference .cpkl")
    ap.add_argument("--ignore-dir", default=None, help="ignored_regions/ directory")
    ap.add_argument("--clip-len", type=int, default=24)
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--cameras", type=int, default=3)
    ap.add_argument("--out", default="track_outputs.csv")
    ap.add_argument("--gt-out", default=None, help="also write GT CSV here")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--crop-checkpoint", default=None)
    ap.add_argument("--det-step", type=int, default=1)
    ap.add_argument(
        "--emit", default="s2d_u8", choices=["s2d_u8", "f32", "yuv420"],
        help="session-mode frame layout: uint8 s2d, reference f32, or planar YUV420 converted on the card",
    )
    ap.add_argument("--oracle", action="store_true", help="use oracle detections (no network)")
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, oracle_detections
    from playground3d_tpu_torch.data.video import SyntheticVideoSource
    from playground3d_tpu_torch.utils.config import TrackerConfig

    device = resolve_device(args.device)
    if args.mode == "session":
        if not (args.session_dir and args.registry):
            ap.error("--mode session needs --session-dir and --registry")
        return track_session(args, device)
    reg, ranges, centers = _synthetic_registry(args.cameras if args.mode == "multi" else 1)
    cameras = list(ranges.keys())
    lo = min(r[0] for r in ranges.values()) - 20
    hi = max(r[1] for r in ranges.values()) + 20
    scene = SyntheticScene(n_objects=10, seed=3, x_spawn=(lo + 30, hi - 30), x_visible=(lo, hi))

    cfg = TrackerConfig(
        max_tracks=64, max_dets=64, x_range=(lo - 50, hi + 50), f_init=2,
        det_step=args.det_step,
    )

    model = None if args.oracle else _detector(args.checkpoint, 0, args.depth, device)

    fps = 30.0
    holder = {"f": 0}

    if args.mode == "single":
        from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker

        P = reg.P[0, 0]
        rng = np.random.default_rng(0)

        detect_fn = None
        if args.oracle:
            def detect_fn(frames):
                return oracle_detections(
                    scene, holder["f"] / fps, P, K=cfg.max_dets, noise_px=1.0, rng=rng, device=device
                )

        tracker = SingleCameraTracker(
            reg, cameras[0], cfg=cfg, det_model=model, detect_fn=detect_fn, device=device,
        )

        def frames():
            if args.oracle:
                for f in range(args.frames):
                    holder["f"] = f
                    yield np.zeros((8, 8, 3), np.float32), 1.6e9 + f / fps
            else:
                src = SyntheticVideoSource(
                    scene, P, n_frames=args.frames, height=args.height, width=args.width
                )
                for f, (frame, t) in enumerate(src):
                    holder["f"] = f
                    yield frame, t

        stats = tracker.track(frames())
        tracker.write_results_csv(args.out)
        print(f"tracked {stats['frames']} frames at {stats['fps']:.1f} fps -> {args.out}")
    else:
        from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker

        rng = np.random.default_rng(0)
        detect_fn = None
        if args.oracle:
            from playground3d_tpu_torch.data.synthetic import mc_oracle_detections

            def detect_fn(frames, frame_num):
                return mc_oracle_detections(
                    scene, [holder["f"] / fps] * len(cameras), reg, cameras, ranges,
                    cfg.max_dets, rng, device=device,
                )

        crop_model = None
        if args.crop_checkpoint:
            crop_model = _detector(args.crop_checkpoint, 1, args.depth, device)

        tracker = MultiCameraTracker(
            reg, cameras, cfg=cfg, det_model=model, crop_model=crop_model,
            detect_fn=detect_fn, centers=centers, device=device,
        )

        def source_for(ci):
            if args.oracle:
                def gen():
                    for f in range(args.frames):
                        yield np.zeros((8, 8, 3), np.float32), 1.6e9 + f / fps
                return gen()
            return SyntheticVideoSource(
                scene, reg.P[ci, 0], n_frames=args.frames,
                height=args.height, width=args.width,
            )

        if args.oracle:
            # manual loop so holder["f"] tracks the frame index
            its = [iter(source_for(ci)) for ci in range(len(cameras))]
            for f in range(args.frames):
                holder["f"] = f
                cur = [next(it) for it in its]
                tracker.process(np.stack([c[0] for c in cur]), [c[1] for c in cur], f)
        else:
            tracker.track([source_for(ci) for ci in range(len(cameras))], cutoff=args.frames)
        tracker.write_results_csv(args.out)
        print(f"wrote {args.out}")

    if args.gt_out or args.eval:
        from playground3d_tpu_torch.evaluation import geometry_np as G
        from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
        from playground3d_tpu_torch.utils.constants import CLASS_NAMES

        P = reg.P[0, 0]
        gt = []
        for f in range(args.frames):
            t = f / fps
            states, idx = scene.states_at(t)
            if len(states) == 0:
                continue
            space = G.state_to_space(states)
            im = G.space_to_im(space, P)
            for i in range(len(states)):
                gt.append(
                    TrackRecord(
                        frame=f, timestamp=1.6e9 + t, obj_id=int(idx[i]),
                        class_name=CLASS_NAMES[int(scene.classes[idx[i]])],
                        state7=states[i], im_corners=im[i],
                        space_footprint=space[i, 0:4, :2], camera=cameras[0],
                    )
                )
        gt_path = args.gt_out or (args.out + ".gt.csv")
        write_results_csv(gt_path, gt)
        print(f"wrote GT to {gt_path}")

        if args.eval:
            from playground3d_tpu_torch.evaluation.mot import MOTEvaluator

            ev = MOTEvaluator(
                gt_path, args.out, reg.H[0, 0], reg.P[0, 0],
                match_iou=0.3, cutoff_frame=args.frames,
            )
            ev.evaluate()
            ev.print_metrics()
            return ev.metrics


if __name__ == "__main__":
    main()
