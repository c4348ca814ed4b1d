#!/usr/bin/env python3
"""Time the training loss's kernels (``csrc/focal_loss.cu``) of the checkout
at ROOT on one CUDA card.

    python3 scripts/focal_times.py [ROOT]

Inputs are those of this checkout's ``chip_smoke.py::kernels_focal`` (its
``focal_inputs``, same seed) at its three shapes: batch 4 x 512x768, batch
2 x 1080x1920 and batch 4 x 112x112, so two checkouts are timed on the same
data. For each shape and pass (forward, backward): CUDA events around each
call after a write of 256 MiB (L2 cold), the median of 3 means of 20 calls;
the same without the flush (warm); and the kernel's own device time under
the profiler, L2 cold. Prints one JSON line. To compare two checkouts, run
this on each on the same card, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This checkout's chip_smoke.py (for its inputs and timers)."""
    spec = importlib.util.spec_from_file_location("smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("focal_times: needs a CUDA card")
    from playground3d_tpu_torch.ops import focal_loss as FL

    if not FL.__file__.startswith(root):
        sys.exit(f"focal_times: imported {FL.__file__}, not the checkout at {root}")
    smoke = smoke_module()
    dev = torch.device("cuda", 0)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(11)
    out = {"root": root, "card": smoke.device_line(), "shapes": []}
    for b, hw in smoke.FOCAL_SHAPES:
        cls, reg, ann, anchors = (torch.as_tensor(x, device=dev) for x in smoke.focal_inputs(rng, b, hw))
        g_out = torch.tensor(smoke.FOCAL_GRAD_OUT, device=dev)
        losses, num_pos, argmax, flags = FL.focal_loss_forward_cuda(cls, reg, ann, anchors)
        fwd = lambda: FL.focal_loss_forward_cuda(cls, reg, ann, anchors)
        bwd = lambda: FL.focal_loss_backward_cuda(cls, reg, ann, anchors, argmax, flags, num_pos, g_out)
        row = {"batch": b, "hw": list(hw), "anchors": int(anchors.shape[0]), "losses": losses.tolist()}
        for name, fn, kernel in (("forward", fwd, "focal_forward_kernel"), ("backward", bwd, "focal_backward_kernel")):
            row[name] = {
                "cold_ms": float(np.median([smoke.gpu_ms(fn, iters=20, flush=flush) for _ in range(3)])),
                "warm_ms": smoke.gpu_ms(fn, iters=20),
                "kernel_ms": smoke.kernel_split(fn, [kernel], flush=flush)[kernel],
            }
        out["shapes"].append(row)
        del cls, reg, ann, anchors, argmax, flags
    print(json.dumps(out))


if __name__ == "__main__":
    main()
