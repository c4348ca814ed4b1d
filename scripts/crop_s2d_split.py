#!/usr/bin/env python3
"""Times of the s2d crop (``csrc/crop_resize_s2d.cu``) at the main path's
call, whole and kernel by kernel, on one CUDA card.

    python3 scripts/crop_s2d_split.py [ROOT]

ROOT (by default this checkout) is a checkout of the repo whose
``playground3d_tpu_torch`` is timed; the inputs and the timing helpers come
from this checkout's ``chip_smoke.py``, so a parent unpacked with
``git archive`` and the change are timed alike by running the script once
on each, in one chip call. The call: uint8 frames [1,270,480,48], 32 boxes
of the main path (992 px, pyramid level 2) and 32 of ``crop_case`` (20-600
px, levels 0-2), 112 px crops, normalize, bfloat16, packed layout. Prints,
for each box set, the whole call L2-cold (median of 3 means of 50 calls,
CUDA events) and warm, and the device time of each kernel under
torch.profiler (mean of 20 L2-cold calls; kernels that overlap count each
in full).
"""

import importlib.util
import os
import statistics
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else HERE
sys.path.insert(0, ROOT)

import torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
S = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(S)

KERNELS = ("pyramid_kernel", "halve_kernel", "sample_kernel")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from playground3d_tpu_torch.ops import crop_mxu

    device = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(4)
    frames = torch.randint(0, 256, (1, S.H // 4, S.W // 4, 48), generator=gen, dtype=torch.uint8).to(device)
    n, size = 32, 112
    main_boxes = S.seed_crop_boxes(S.bench_registry(), S.tracker_config(), S.N_SEED, s2d=True)[0]
    sets = {"main-path boxes": main_boxes.to(device).contiguous(),
            "crop_case boxes": S.crop_case(gen, device, n, (S.H, S.W))[0]}
    cam = torch.zeros(n, dtype=torch.int32, device=device)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    print(f"root {ROOT}")
    print(f"device {S.device_line()}")
    for label, boxes in sets.items():
        def run(boxes=boxes):
            return crop_mxu.crop_and_resize_s2d_cuda(frames, boxes, cam, size, normalize=True)

        cold = [S.gpu_ms(run, flush=flush) for _ in range(3)]
        warm = S.gpu_ms(run)
        split = S.kernel_split(run, KERNELS, flush=flush)
        parts = ", ".join(f"{k} {'not measured' if v is None else format(v * 1e3, '.2f') + ' us'}"
                          for k, v in split.items() if v is not None or k != "halve_kernel")
        print(f"{label}: whole call {statistics.median(cold) * 1e3:.2f} us L2 cold (means of 50: "
              f"{' '.join(f'{c * 1e3:.2f}' for c in cold)}), {warm * 1e3:.2f} us warm; by kernel "
              f"(profiler, L2 cold): {parts}")


if __name__ == "__main__":
    main()
