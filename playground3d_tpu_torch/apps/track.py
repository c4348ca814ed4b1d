"""Tracking CLI (port of ``playground3d_tpu/apps/track.py``): single-camera
(reference minimal_3D_track.py __main__) and multi-camera crop tracking
(MC3D_crop_tracker.py __main__) over a synthetic scene, with CSV output,
optional ground truth and MOT evaluation.

Usage:
    python -m playground3d_tpu_torch.apps.track --mode single --frames 100 \\
        --out out.csv [--gt-out gt.csv] [--eval] [--checkpoint det.npz] [--device cpu]
    python -m playground3d_tpu_torch.apps.track --mode multi --cameras 3 --oracle ...

The detector is ``retinanet_init`` from a fixed ``torch.Generator`` seed
(the JAX app uses ``PRNGKey(0)``), so the two apps share weights only
through ``--checkpoint``, a file written by either package's
``save_params``. ``--device`` picks where the port runs (default the card).
The JAX app's ``--mode session`` (recorded video with ignore regions) needs
the session reader, the video decoders and the region loader, which are
not ported yet; it is not offered here.
"""

from __future__ import annotations

import argparse

import numpy as np


def _synthetic_registry(n_cameras: int):
    """Build a synthetic multi-camera registry + scene ranges + centres."""
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain

    reg, ranges, centers, _ = toy_camera_chain(n_cameras)
    return reg, ranges, centers


def _detector(path, seed: int, depth: int, device):
    import torch

    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import retinanet_init

    model = retinanet_init(torch.Generator().manual_seed(seed), depth=depth, device=device)
    return load_params(path, model) if path else model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", default="single", choices=["single", "multi"])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--cameras", type=int, default=3)
    ap.add_argument("--out", default="track_outputs.csv")
    ap.add_argument("--gt-out", default=None, help="also write GT CSV here")
    ap.add_argument("--eval", action="store_true")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--crop-checkpoint", default=None)
    ap.add_argument("--det-step", type=int, default=1)
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
