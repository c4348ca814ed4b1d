#!/usr/bin/env python3
"""Where the time of the s2d crop (``csrc/crop_resize_s2d.cu``) goes, block
by block, on one CUDA card.

    python3 scripts/crop_s2d_timeline.py

Builds the kernel with ``-DCROP_S2D_TIMING`` (each block of the pyramid and
of the sampling kernel then writes the card's global timer at a few points
of its life into a device array) and runs, queued behind a sleep, the main path's call (uint8
frames [1,270,480,48], 32 boxes of 992 px, 112 px crops, normalize,
bfloat16, packed) and the same at ``crop_case`` boxes, L2 cold. Prints, in
microseconds from the first block's start, the spread (min / median / max
over the blocks) of each point, and the call's time with and without the
timer (CUDA events).
"""

import ctypes
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as S  # noqa: E402
from playground3d_tpu_torch.ops import crop_mxu  # noqa: E402
from playground3d_tpu_torch.ops.cuda_build import KernelLibrary  # noqa: E402

PYRAMID = ("start", "frame rows staged", "end")
SAMPLING = ("start", "tables built", "pyramid waited for", "rows staged", "crops stored", "end")
BLOCKS = 16384


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")

    def bind(lib):
        crop_mxu._bind(lib)
        lib.crop_s2d_read_stamps.argtypes = [ctypes.c_void_p]
        lib.crop_s2d_read_stamps.restype = ctypes.c_int

    timed = KernelLibrary("crop_resize_s2d", bind, extra_flags=("-DCROP_S2D_TIMING",))
    timed.build()
    print(timed.build_log)
    device = torch.device("cuda", 0)
    print(f"device {S.device_line()}")
    gen = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (1, S.H // 4, S.W // 4, 48), generator=gen, dtype=torch.uint8).to(device)
    n, size = 32, 112
    main_boxes = S.seed_crop_boxes(S.bench_registry(), S.tracker_config(), S.N_SEED, s2d=True)[0]
    sets = {"main-path boxes": main_boxes.to(device).contiguous(),
            "crop_case boxes": S.crop_case(gen, device, n, (S.H, S.W))[0]}
    cam = torch.zeros(n, dtype=torch.int32, device=device)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    plan = crop_mxu.launch_plan(1, S.H // 4, S.W // 4, n, size)
    stamps = np.zeros((2, BLOCKS, 6), np.uint64)
    for label, boxes in sets.items():
        def run(boxes=boxes):
            return crop_mxu.crop_and_resize_s2d_cuda(frames, boxes, cam, size, normalize=True)

        plain_lib = crop_mxu.LIB
        untimed = S.gpu_ms(run, flush=flush)
        crop_mxu.LIB = timed
        try:
            timed_ms = S.gpu_ms(run, flush=flush)
            flush.zero_()
            torch.cuda._sleep(int(1e7))  # both launches queued before the card reaches them, as in a clip
            run()
            torch.cuda.synchronize()
            timed.check(timed.load().crop_s2d_read_stamps(stamps.ctypes.data))
        finally:
            crop_mxu.LIB = plain_lib
        pyr = stamps[0, : plan.pyramid_blocks[0], :3].astype(np.int64)
        smp = stamps[1, : plan.blocks].astype(np.int64)
        t0 = min(pyr[:, 0].min(), smp[:, 0].min())
        print(f"{label}: call {untimed * 1e3:.2f} us L2 cold ({timed_ms * 1e3:.2f} us with the timer); "
              f"{plan.pyramid_blocks[0]} pyramid blocks, {plan.blocks} sampling blocks; us from the first start, "
              f"min / median / max over the blocks:")
        for kernel, names, arr in (("pyramid", PYRAMID, pyr), ("sampling", SAMPLING, smp)):
            for k, name in enumerate(names):
                v = (arr[:, k] - t0) / 1e3
                print(f"  {kernel} {name}: {v.min():.2f} / {statistics.median(v.tolist()):.2f} / {v.max():.2f}")
        life = (smp[:, 4] - smp[:, 2]) / 1e3
        print(f"  sampling block from the wait to its stores done: median {statistics.median(life.tolist()):.2f} us; "
              f"staging {statistics.median(((smp[:, 3] - smp[:, 2]) / 1e3).tolist()):.2f}, "
              f"sampling {statistics.median(((smp[:, 4] - smp[:, 3]) / 1e3).tolist()):.2f}, "
              f"tables {statistics.median(((smp[:, 1] - smp[:, 0]) / 1e3).tolist()):.2f}")


if __name__ == "__main__":
    main()
