#!/usr/bin/env python3
"""Card time of one detect frame and one crop frame of the shipped
configuration (s2d frames, int8 nets), by kind of kernel, under
torch.profiler.

    python3 scripts/profile_int8_frames.py [ROOT]

ROOT (by default this checkout) is a checkout of the repo: the models, the
tracker and the frame are built by its own ``chip_smoke.py`` helpers and run
on its own ``playground3d_tpu_torch``, so two checkouts (say a parent
unpacked with ``git archive`` and the change) are compared by running the
script once on each, in one chip call. Prints, for each branch, the wall
time, the card's busy time and kernel launches, and the part of both that is
the int8 convolution (``qconv_kernel``) and PyTorch's elementwise kernels;
each the median of 3 profiled runs after 2 unprofiled ones.
"""

import os
import statistics
import sys
import time

ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as S  # noqa: E402

PARTS = (("qconv", ("qconv_kernel",)), ("elementwise", ("elementwise",)))


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    device = torch.device("cuda", 0)
    reg, cfg, _, (det_q, crop_q), _ = S.shipped_models(device)
    raw = np.random.default_rng(0).integers(0, 256, (1, S.H, S.W, 3), dtype=np.uint8)
    frames_dev = torch.as_tensor(S.pack_frames(raw)[:1]).to(device)
    trk = S.make_tracker(reg, det_q, crop_q, cfg, device, S.N_SEED)
    t = torch.zeros(1, device=device)
    bias = torch.zeros(1, device=device)
    runs = {
        "detect": lambda: trk._detect_step(trk.state, frames_dev, t, bias),
        "crop": lambda: trk._crop_step(trk.state, frames_dev, t, bias),
    }
    print(f"root {ROOT}")
    for name, fn in runs.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        rows = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            row = {"wall": wall, "busy": sum(e.self_device_time_total for e in kern) / 1e3,
                   "launches": sum(e.count for e in kern)}
            for part, words in PARTS:
                ks = [e for e in kern if any(w in e.key for w in words)]
                row[part] = sum(e.self_device_time_total for e in ks) / 1e3
                row[part + "_launches"] = sum(e.count for e in ks)
            rows.append(row)
        med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        if med["busy"] <= 0:
            print(f"{name}: the profiler saw no device time (not measured)")
            continue
        print(f"{name}: wall {med['wall']:.2f} ms, card busy {med['busy']:.3f} ms ({med['busy'] / med['wall'] * 100:.0f}%),"
              f" {med['launches']:.0f} launches; qconv_kernel {med['qconv']:.3f} ms over {med['qconv_launches']:.0f};"
              f" elementwise {med['elementwise']:.3f} ms over {med['elementwise_launches']:.0f}; the rest "
              f"{med['busy'] - med['qconv'] - med['elementwise']:.3f} ms over "
              f"{med['launches'] - med['qconv_launches'] - med['elementwise_launches']:.0f} (median of 3)")


if __name__ == "__main__":
    main()
