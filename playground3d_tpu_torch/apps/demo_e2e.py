"""End-to-end demo (port of ``playground3d_tpu/apps/demo_e2e.py``): train the
detector on synthetic traffic, then run the single-camera tracker with the
REAL trained network and score MOT metrics.

This is the whole framework in one flow - dataset/augs -> train step (the
loss in ``csrc/focal_loss.cu`` on the card) -> checkpoint -> fused
detect+track -> 46-col CSV -> MOT evaluator - and the round-trip proof that
detector, geometry, and tracker agree end to end (no oracle detections
anywhere). Runs on the CUDA card unless ``--device cpu``; the trained model
stays on the device and tracks as it is (``--quantize`` runs its convs in
``csrc/qconv.cu``).

Usage:
    python -m playground3d_tpu_torch.apps.demo_e2e --steps 600 --frames 90 \\
        [--height 512 --width 768] [--depth 18] [--stem s2d] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def frozen(model):
    """A trained model for inference: no tensor of it requires gradients
    (the trainer set its parameters and frozen-BN buffers to)."""
    for t in list(model.parameters()) + list(model.buffers()):
        t.requires_grad_(False)
    return model.eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--depth", type=int, default=18)
    ap.add_argument("--stem", default="s2d", choices=["conv7", "s2d"])
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--zoom", type=float, default=1.5)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--feature-size", type=int, default=256)
    ap.add_argument("--tower-depth", type=int, default=4)
    ap.add_argument("--shared-tower", action="store_true")
    ap.add_argument(
        "--quantize", action="store_true",
        help="PTQ the trained backbone to int8 before tracking (models/quant)",
    )
    ap.add_argument("--pre-topk", type=int, default=1024)
    ap.add_argument(
        "--det-min-level", type=int, default=3,
        help="lowest pyramid level for full-frame detection (4 drops stride-8)",
    )
    ap.add_argument(
        "--approx-topk", action="store_true",
        help="accepted for the JAX app's flag; the port's top-k is exact either way",
    )
    ap.add_argument(
        "--det-ckpt", default=None,
        help="load a trained detector npz and skip training (quality A/B runs)",
    )
    ap.add_argument("--out-prefix", default="_outputs/demo_e2e")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.data.dataset import Prefetcher, SyntheticDetectionDataset
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer

    device = resolve_device(args.device)
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    t0 = time.time()

    def log(msg):
        print(f"[{time.time() - t0:7.1f}s] {msg}", flush=True)

    shape = (args.height, args.width)
    ds = SyntheticDetectionDataset(
        image_shape=shape, n_objects=6, seed=0, augment=True, zoom=args.zoom
    )
    cfg = TrainConfig(
        depth=args.depth, stem=args.stem, image_shape=shape, lr=args.lr,
        feature_size=args.feature_size, tower_depth=args.tower_depth,
        shared_tower=args.shared_tower,
    )
    if args.det_ckpt is not None:
        from playground3d_tpu_torch.models import load_params, retinanet_init

        model = load_params(
            args.det_ckpt,
            retinanet_init(
                torch.Generator().manual_seed(0), depth=args.depth, stem=args.stem,
                feature_size=args.feature_size, tower_depth=args.tower_depth,
                shared_tower=args.shared_tower, device=device,
            ),
        )
        log(f"loaded detector checkpoint {args.det_ckpt} (training skipped)")
    else:
        trainer = Trainer(cfg, generator=torch.Generator().manual_seed(0), device=device)
        log(
            f"training resnet{args.depth}/{args.stem} fs={args.feature_size} "
            f"towers={args.tower_depth}{'/shared' if args.shared_tower else ''} "
            f"at {shape} for {args.steps} steps"
        )

        batches = Prefetcher(factory=ds.batch_factory(args.batch), workers=4, depth=4, device=device)
        losses = []  # device scalars: read at the log lines and once at the end
        try:
            for step, (frames, labels) in zip(range(args.steps), batches):
                m = trainer.train_step(frames, labels)
                losses.append(m["loss"])
                if step % 50 == 0:
                    log(
                        f"step {step}: loss={float(m['loss']):.4f} "
                        f"cls={float(m['cls']):.4f} reg={float(m['reg']):.4f} vp={float(m['vp']):.4f}"
                    )
                if step % 500 == 499:
                    trainer.save(args.out_prefix + "_detector.npz")
        finally:
            batches.close()
        losses = torch.stack(losses).cpu().numpy()
        log(f"training done; loss {losses[0]:.3f} -> {np.mean(losses[-20:]):.3f}")
        trainer.save(args.out_prefix + "_detector.npz")
        model = frozen(trainer.model)

    if args.quantize:
        from playground3d_tpu_torch.models.quant import quantize_detector

        calib, _ = ds.batch_factory(args.batch)()
        model = quantize_detector(model, torch.as_tensor(calib).to(device))
        log("backbone quantized to int8 (PTQ, synthetic calibration batch)")

    # ---- track a fresh synthetic sequence with the trained detector --------
    from playground3d_tpu_torch.data.synthetic import SyntheticScene
    from playground3d_tpu_torch.data.video import SyntheticVideoSource
    from playground3d_tpu_torch.evaluation import geometry_np as G
    from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
    from playground3d_tpu_torch.evaluation.mot import MOTEvaluator
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig
    from playground3d_tpu_torch.utils.constants import CLASS_NAMES

    reg = ds.camera_registry()
    scene = SyntheticScene(
        n_objects=8, seed=77, x_spawn=(450.0, 660.0), x_visible=(445.0, 680.0)
    )
    tcfg = TrackerConfig(
        max_tracks=32,
        max_dets=32,
        pre_topk=args.pre_topk,
        x_range=(430.0, 700.0),
        f_init=2,
        sigma_d=0.25,
        approx_topk=args.approx_topk,
        det_min_level=args.det_min_level,
    )
    tracker = SingleCameraTracker(
        reg, "p1c1", cfg=tcfg, det_model=model, stem=args.stem, device=device
    )
    src = SyntheticVideoSource(
        scene, reg.P[0, 0], n_frames=args.frames, height=args.height,
        width=args.width, t0=1.6e9,
    )
    stats = tracker.track(src)
    log(f"tracked {stats['frames']} frames at {stats['fps']:.1f} fps (real detector)")
    pred_path = args.out_prefix + "_pred.csv"
    tracker.write_results_csv(pred_path)

    # ground truth
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
                    space_footprint=space[i, 0:4, :2], camera="p1c1",
                )
            )
    gt_path = args.out_prefix + "_gt.csv"
    write_results_csv(gt_path, gt)

    ev = MOTEvaluator(
        gt_path, pred_path, reg.H[0, 0], reg.P[0, 0],
        match_iou=0.2, cutoff_frame=args.frames,
    )
    metrics = ev.evaluate()
    log("MOT metrics (trained detector, no oracle):")
    for k in ["TP", "FP", "FN", "Recall", "Precision", "MOTA", "ID switches"]:
        v = metrics[k]
        print(f"  {k:<12}: {v:.3f}" if isinstance(v, float) else f"  {k:<12}: {v}", flush=True)
    return metrics


if __name__ == "__main__":
    main()
