"""Detector batch-size latency sweep (port of
``playground3d_tpu/tools/benchmark_speed.py``; reference
pytorch_retinanet_detector_directional/benchmark_speed.py:9-47): measures
staging (a host->device copy of the float32 batch) and the forward's time
per batch size.

Runs on the CUDA card unless ``--device cpu``; the card is synchronized
before each clock stops, so the times hold the card's work.

Usage: python -m playground3d_tpu_torch.tools.benchmark_speed [--depth 50]
       [--height 540 --width 960] [--batches 1 2 4 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=50)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--batches", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from playground3d_tpu_torch import resolve_device
    from playground3d_tpu_torch.models import retinanet_init
    from playground3d_tpu_torch.models.retinanet import forward_raw

    device = resolve_device(args.device)
    model = retinanet_init(torch.Generator().manual_seed(0), depth=args.depth, device=device)
    rng = np.random.default_rng(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}  {args.height}x{args.width} resnet{args.depth}")
    for b in args.batches:
        host = torch.from_numpy(rng.normal(0, 1, (b, args.height, args.width, 3)).astype(np.float32))

        sync()
        st = time.time()
        dev = host.to(device)
        sync()
        stage_ms = (time.time() - st) * 1000

        with torch.no_grad():
            out = forward_raw(model, dev)
            sync()
            st = time.time()
            for _ in range(args.iters):
                out = forward_raw(model, dev)
            sync()
        del out
        compute_ms = (time.time() - st) / args.iters * 1000
        print(
            f"b={b:3d}: stage {stage_ms:7.2f} ms  compute {compute_ms:7.2f} ms "
            f"({b / compute_ms * 1000:.1f} im/s)"
        )


if __name__ == "__main__":
    main()
