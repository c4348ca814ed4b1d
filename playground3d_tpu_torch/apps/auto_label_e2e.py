"""Auto-label a real-decoded video through the annotation shell, end to end
(port of ``playground3d_tpu/apps/auto_label_e2e.py``):

    train (or load) detector -> render scene -> write y4m -> DECODE PIXELS
    (native fused s2d-u8 tail) -> detector-assisted `auto` labeling in the
    AnnotatorShell -> interpolate/outlier cleanup -> CSV -> MOT evaluation

This is the reference v3 annotator's `automate` workflow
(manual_annotator_state_v3.py:644-741) run headlessly with zero manual
steps - it welds together the y4m decoder, the annotation shell, and the
evaluator, which otherwise only meet in unit tests.

Runs on the CUDA card unless ``--device cpu``: training (the loss in
``csrc/focal_loss.cu``) and the shell's detector, which detects, parses and
NMSes a frame on the device and crosses to the host once a frame.

    python -m playground3d_tpu_torch.apps.auto_label_e2e --steps 1000 [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=384)
    ap.add_argument("--zoom", type=float, default=1.5)
    ap.add_argument("--det-ckpt", default=None, help="skip training")
    ap.add_argument("--sigma-d", type=float, default=0.3)
    ap.add_argument("--out-prefix", default="_outputs/auto_label")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.apps.demo_e2e import frozen
    from playground3d_tpu_torch.data.dataset import Prefetcher, SyntheticDetectionDataset
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, render_frame
    from playground3d_tpu_torch.data.video import VideoFrameSource, write_y4m
    from playground3d_tpu_torch.evaluation import geometry_np as G
    from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
    from playground3d_tpu_torch.evaluation.mot import MOTEvaluator
    from playground3d_tpu_torch.models import retinanet_init
    from playground3d_tpu_torch.models.nn import load_params, save_params
    from playground3d_tpu_torch.models.retinanet import detect_multiframe
    from playground3d_tpu_torch.ops.topk import HostSyncs
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
    from playground3d_tpu_torch.pipeline.tracker_state import (
        parse_detections_pre,
        space_nms_parsed,
    )
    from playground3d_tpu_torch.tools.annotator import AnnotationSession
    from playground3d_tpu_torch.tools.annotator_shell import AnnotatorShell, session_to_records
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer
    from playground3d_tpu_torch.utils.config import TrackerConfig
    from playground3d_tpu_torch.utils.constants import CLASS_NAMES

    device = resolve_device(args.device)
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    t_start = time.time()

    def log(msg):
        print(f"[{time.time() - t_start:7.1f}s] {msg}", flush=True)

    shape = (args.height, args.width)
    ds = SyntheticDetectionDataset(
        image_shape=shape, n_objects=6, seed=0, augment=True, zoom=args.zoom
    )
    reg = ds.camera_registry()
    camera = "p1c1"

    # 1. detector
    if args.det_ckpt:
        model = load_params(
            args.det_ckpt,
            retinanet_init(torch.Generator().manual_seed(0), depth=args.depth, stem="s2d", device=device),
        )
        log(f"loaded detector {args.det_ckpt}")
    else:
        trainer = Trainer(
            TrainConfig(depth=args.depth, stem="s2d", image_shape=shape, lr=3e-4),
            generator=torch.Generator().manual_seed(0), device=device,
        )
        pf = Prefetcher(factory=ds.batch_factory(args.batch), workers=2, depth=4, device=device)
        log(f"training resnet{args.depth}/s2d at {shape} for {args.steps} steps")
        try:
            for step in range(args.steps):
                frames, labels = next(pf)
                m = trainer.train_step(frames, labels)
                if step % 100 == 0:
                    log(f"step {step}: loss={float(m['loss']):.4f}")
        finally:
            pf.close()
        model = frozen(trainer.model)
        save_params(args.out_prefix + "_det.npz", model)

    # 2. fresh scene -> y4m (REAL pixels on disk)
    scene = SyntheticScene(
        n_objects=8, seed=77, x_spawn=(460, 660), x_visible=(445, 680)
    )
    video_path = args.out_prefix + ".y4m"
    rng = np.random.default_rng(3)

    def u8_frames():
        for f in range(args.frames):
            frame, _ = render_frame(
                scene, f / 30.0, reg.P[0, 0], height=args.height, width=args.width,
                rng=rng, normalized=False,
            )
            yield (np.clip(frame, 0, 1) * 255).astype(np.uint8)

    write_y4m(video_path, u8_frames())
    log(f"wrote {args.frames}-frame y4m -> {video_path}")

    # 3. decode pixels back (native fused YUV->s2d-u8 tail when available)
    decoded = [
        fr for fr, _t in VideoFrameSource(
            video_path, resize_hw=shape, parse_ts=False, emit="s2d_u8"
        )
    ]
    log(f"decoded {len(decoded)} frames (uint8 s2d {decoded[0].shape})")

    # 4. detector callable for the shell's `auto` command
    cfg = TrackerConfig(
        max_dets=16, pre_topk=256, sigma_d=args.sigma_d,
        x_range=(415.0, 710.0), estimate_ts_bias=False,
    )
    bank = bank_from_registry(reg, device=device)
    cam_times = torch.zeros((1,), dtype=torch.float32, device=device)

    @torch.no_grad()
    def detect(frame_s2d):
        """-> one float64 tensor [K, 8]: state (6), class, mask."""
        det = detect_multiframe(
            model, frame_s2d[None], pre_topk=cfg.pre_topk, max_dets=cfg.max_dets,
        )
        parsed = space_nms_parsed(parse_detections_pre(det, bank, cam_times, cfg), cfg)
        return torch.cat([
            parsed.state.to(torch.float64), parsed.classes[:, None].to(torch.float64),
            parsed.mask[:, None].to(torch.float64),
        ], dim=1)

    def shell_detector(t, _camera):
        f = int(round(t * 30.0))
        f = min(max(f, 0), len(decoded) - 1)
        packed = HostSyncs.fetch(detect(torch.as_tensor(decoded[f]).to(device)))  # one read a frame
        m = packed[:, 7] > 0
        st = packed[m, :6].astype(np.float32)
        st7 = np.concatenate([st, np.zeros((int(m.sum()), 1), np.float32)], axis=1)
        return st7, packed[m, 6].astype(np.int32)

    # 5. scripted shell session: `auto` every frame, then cleanup per object
    sess = AnnotationSession()
    shell = AnnotatorShell(
        sess, registry=reg, cameras=[camera], t0=0.0, detector=shell_detector
    )
    script = []
    for f in range(args.frames):
        script += [f"goto {f}", "auto"]
    shell.run(script)
    ids = sorted(sess.labels.keys())
    cleanup = []
    for oid in ids:
        if len(sess.labels[oid]) >= 5:
            cleanup += [f"outliers {oid} 3.0", f"interp {oid}"]
    cleanup += [f"save {args.out_prefix}_session.npz"]
    shell.run(cleanup)
    log(f"auto-labeled {len(ids)} objects over {args.frames} frames")

    # 6. session -> CSV -> evaluator vs the scene's true states
    pred_path = args.out_prefix + "_pred.csv"
    write_results_csv(pred_path, session_to_records(sess, reg, camera))

    gt = []
    for f in range(args.frames):
        t = f / 30.0
        states, idx = scene.states_at(t)
        if len(states) == 0:
            continue
        space = G.state_to_space(states)
        imc = G.space_to_im(space, reg.P[0, 0])
        for i in range(len(states)):
            gt.append(
                TrackRecord(
                    frame=f, timestamp=t, obj_id=int(idx[i]),
                    class_name=CLASS_NAMES[int(scene.classes[idx[i]])],
                    state7=states[i], im_corners=imc[i],
                    space_footprint=space[i, 0:4, :2], camera=camera,
                )
            )
    gt_path = args.out_prefix + "_gt.csv"
    write_results_csv(gt_path, gt)

    ev = MOTEvaluator(
        gt_path, pred_path, reg.H[0, 0], reg.P[0, 0], match_iou=0.2,
        cutoff_frame=args.frames,
    )
    metrics = ev.evaluate()
    log("auto-label e2e metrics (pixels -> shell `auto` -> CSV):")
    for k in ["TP", "FP", "FN", "Recall", "Precision", "MOTA"]:
        v = metrics[k]
        print(f"  {k:<10}: {v:.3f}" if isinstance(v, float) else f"  {k:<10}: {v}", flush=True)
    return metrics


if __name__ == "__main__":
    main()
