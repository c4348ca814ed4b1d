"""Detection-only video app (port of ``playground3d_tpu/apps/detect_video.py``;
reference 3D_detect_video.py and perform_3D_detection_on_video_sequences.py):
run the detector over a frame source and write a per-sequence detections CSV
with a processing-fps trailer.

Runs on the CUDA card unless ``--device cpu``. Each frame is copied to the
device, detected (``detect_multiframe``: the NMS in ``csrc/nms.cu`` on the
card) and read back as one packed tensor; the fps counts the host clock over
every frame, the last one's read included.

Usage:
    python -m playground3d_tpu_torch.apps.detect_video --source synthetic \\
        --frames 100 --out detections.csv [--depth 50] [--conf 0.3] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import time

import numpy as np


def write_detections_csv(path, rows, fps):
    """Per-sequence detections CSV with the reference's "Processing fps"
    trailer row (perform_3D_detection_on_video_sequences.py:124-194)."""
    header = ["frame", "timestamp", "class", "confidence"] + [
        f"c{i}" for i in range(16)
    ] + ["x1", "y1", "x2", "y2"]
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(header)
        for r in rows:
            out.writerow(r)
        out.writerow([f"Processing fps: {fps:.2f}"])


def pack_detections(det):
    """Detections -> one float64 tensor [K, 23]: score, mask, class, the 20
    box values (each exact in float64), so a frame is one read."""
    import torch

    return torch.cat([
        det.scores[:, None].to(torch.float64), det.mask[:, None].to(torch.float64),
        det.classes[:, None].to(torch.float64), det.boxes.to(torch.float64),
    ], dim=1)


def synthetic_source(height: int, width: int, n_frames: int):
    """``--source synthetic``: a standalone synthetic camera's rendered
    frames, normalized float32 [H,W,3], with burned-in timestamps."""
    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.data.synthetic import SyntheticScene
    from playground3d_tpu_torch.data.video import SyntheticVideoSource

    ds = SyntheticDetectionDataset(image_shape=(height, width))
    return SyntheticVideoSource(
        SyntheticScene(n_objects=8, seed=0, x_spawn=(450, 660), x_visible=(445, 680)),
        ds._P, n_frames=n_frames, height=height, width=width,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", default="synthetic", choices=["synthetic", "video", "imagedir"])
    ap.add_argument("--path", default=None, help="video file or image dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default="detections.csv")
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--checkpoint", default=None, help="npz detector params")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.models import load_params, retinanet_init
    from playground3d_tpu_torch.models.retinanet import detect_multiframe
    from playground3d_tpu_torch.ops.topk import HostSyncs

    device = resolve_device(args.device)
    model = retinanet_init(torch.Generator().manual_seed(0), depth=args.depth, device=device)
    if args.checkpoint:
        model = load_params(args.checkpoint, model)

    if args.source == "synthetic":
        source = synthetic_source(args.height, args.width, args.frames)
    elif args.source == "video":
        from playground3d_tpu_torch.data.video import VideoFrameSource

        source = VideoFrameSource(args.path, resize_hw=(args.height, args.width))
    else:
        from playground3d_tpu_torch.data.video import ImageDirSource

        source = ImageDirSource(args.path)

    rows = []
    start = time.time()
    n = 0
    for frame_num, (frame, t_abs) in enumerate(source):
        if frame_num >= args.frames:
            break
        det = detect_multiframe(model, torch.as_tensor(np.asarray(frame)[None]).to(device))
        packed = HostSyncs.fetch(pack_detections(det))  # one read a frame
        scores = packed[:, 0].astype(np.float32)
        keep = (packed[:, 1] > 0) & (scores > args.conf)
        for i in np.flatnonzero(keep):
            rows.append(
                [frame_num, t_abs, int(packed[i, 2]), float(scores[i])]
                + [float(v) for v in packed[i, 3:].astype(np.float32)]
            )
        n += 1
        print(f"\rframe {frame_num}: {keep.sum()} detections", end="", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fps = n / max(time.time() - start, 1e-9)
    write_detections_csv(args.out, rows, fps)
    print(f"\nwrote {len(rows)} detections to {args.out} ({fps:.1f} fps)")


if __name__ == "__main__":
    main()
