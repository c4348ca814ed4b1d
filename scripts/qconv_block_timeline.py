#!/usr/bin/env python3
"""Where the time of one block of ``csrc/qconv.cu`` goes, on the card, and
what splitting K costs.

    python3 scripts/qconv_block_timeline.py

Builds the kernel twice, side by side: as the package uses it, and with
``-DQCONV_TIMING`` (each block then writes the card's global timer at ten
points of its life into a device array). For a few conv shapes of the main
path, with and without a block's residual, prints the kernel time of each
build (CUDA events, mean of 20), whether the output equals the plain
version, and, averaged over the blocks that ran the epilogue, the
microseconds from the block's start to each point of ``POINTS``. Then, for
the maps on which ``ops/qconv.py::launch_plan`` may narrow the tile or
split K, the kernel time at each tile width (256 and 128, for layers of
more than 128 filters) and count of splits, the entry point called with
them forced, beside the plan's choice: the data its cost model
(``STEP_US``, ``EPILOGUE_US``, ``SPLIT_US``, ``REDUCE_BYTES_PER_US``) was
fitted to.
"""

import concurrent.futures as cf
import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import gpu_ms  # noqa: E402
from playground3d_tpu_torch.ops import qconv as QC  # noqa: E402
from playground3d_tpu_torch.ops.cuda_build import KernelLibrary  # noqa: E402

# (N, H, W, Cin, Cout, k, stride), output, residual
TIMELINE = [((1, 135, 240, 256, 256, 3, 1), "int8", "none"), ((1, 68, 120, 256, 256, 3, 1), "int8", "none"),
            ((1, 9, 15, 256, 256, 3, 1), "int8", "none"), ((1, 34, 60, 2048, 256, 3, 2), "bf16", "none"),
            ((32, 4, 4, 512, 512, 3, 1), "int8", "none"), ((1, 135, 240, 128, 512, 1, 1), "int8", "none"),
            ((1, 135, 240, 128, 512, 1, 1), "bf16", "none"), ((1, 135, 240, 128, 512, 1, 1), "int8", "int8"),
            ((1, 135, 240, 128, 512, 1, 1), "int8", "bf16"), ((1, 68, 120, 256, 1024, 1, 1), "int8", "int8"),
            ((1, 270, 480, 256, 128, 1, 1), "int8", "none")]
POINTS = [(2, "weights asked"), (1, "rows set up"), (3, "producer ready"), (5, "first stage full"),
          (6, "K loop done"), (8, "consumers synced"), (9, "tile parked (and summed)"), (10, "first row out"),
          (7, "epilogue done")]
SWEEP = [(1, 9, 15, 256, 256, 3, 1), (1, 17, 30, 256, 256, 3, 1), (1, 34, 60, 256, 256, 3, 1),
         (1, 34, 60, 512, 512, 3, 1), (1, 34, 60, 2048, 256, 3, 2), (32, 4, 4, 512, 512, 3, 1),
         (32, 7, 7, 256, 256, 3, 1), (32, 1, 1, 256, 256, 3, 1), (1, 68, 120, 256, 256, 3, 1),
         (1, 34, 60, 2048, 256, 1, 1), (32, 14, 14, 256, 256, 3, 1), (1, 9, 15, 256, 72, 3, 1),
         (1, 68, 120, 1024, 256, 1, 1), (1, 34, 60, 2048, 512, 1, 1), (32, 4, 4, 512, 256, 3, 2)]
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32)


def launch(lib, x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, tile_n, splits):
    """The C entry point with ``tile_n`` and ``splits`` forced; int8 out when
    emit_xs is given."""
    N, H, W, Cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    plan = QC.launch_plan(N, H, W, Cin, cout, k, stride)
    store = QC.INT8 if emit_xs is not None else QC.BF16
    out = torch.empty((N, plan.ho, plan.wo, cout), dtype=torch.int8 if emit_xs is not None else torch.bfloat16,
                      device=x.device)
    tiles = plan.tiles_m * -(-cout // tile_n)
    ws = QC._workspace(x.device, -(-tiles // 64) * 64 + tiles * QC.TILE_M * tile_n)
    kind = QC.NO_RES if res is None else (QC.RES_INT8 if res.dtype == torch.int8 else QC.RES_BF16)
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    QC.LIB.check(lib.qconv(
        ptr(x), ptr(wq), ptr(scale), ptr(offset), ptr(emit_xs), ptr(res), ptr(res_xs), ptr(out), ptr(ws),
        N, H, W, Cin, cout, k, stride, plan.ho, plan.wo, plan.pad_top, plan.pad_left, int(relu), store, kind,
        tile_n, splits, torch.cuda.current_stream().cuda_stream))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    timing = KernelLibrary("qconv", QC._bind, extra_flags=("-DQCONV_TIMING",))
    with cf.ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda lib: lib.build(), (QC.LIB, timing)))
    plain_lib, timing_lib = QC.LIB.load(), timing.load()
    timing_lib.qconv_read_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(8)
    stamps = np.zeros((4096, 16), np.uint64)
    xs, res_xs = torch.tensor(0.043, device=dev), torch.tensor(0.0371, device=dev)
    print(torch.cuda.get_device_name(0))

    def operands(N, H, W, cin, cout, k):
        x = torch.randint(-127, 128, (N, H, W, cin), generator=gen, dtype=torch.int8).to(dev)
        wq = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, dtype=torch.int8).to(dev)
        scale = (torch.rand(cout, generator=gen) * 2e-5 + 1e-6).to(dev)
        offset = torch.randn(cout, generator=gen).to(dev)
        return x, wq, scale, offset

    for shape, out_kind, res_kind in TIMELINE:
        N, H, W, cin, cout, k, s = shape
        x, wq, scale, offset = operands(N, H, W, cin, cout, k)
        plan = QC.launch_plan(*shape)
        res, rxs = None, None
        if res_kind == "int8":
            res, rxs = torch.randint(-127, 128, (N, plan.ho, plan.wo, cout), generator=gen, dtype=torch.int8).to(dev), res_xs
        elif res_kind == "bf16":
            res = (torch.randn((N, plan.ho, plan.wo, cout), generator=gen) * 3).to(torch.bfloat16).to(dev)
        emit, relu = (xs if out_kind == "int8" else None), res is None
        want = QC.qconv_plain(x, wq, scale, offset, s, relu, emit, res, rxs)
        times = []
        for lib in (plain_lib, timing_lib):
            def run():
                return launch(lib, x, wq, scale, offset, s, relu, emit, res, rxs, plan.tile_n, plan.splits)
            times.append(gpu_ms(run, iters=20) * 1e3)
            equal = torch.equal(run(), want)
            torch.cuda.synchronize()
            if not equal:
                sys.exit(f"{shape}: the kernel differs from the plain version")
        timing_lib.qconv_read_stamps(stamps.ctypes.data)
        blocks = plan.tiles_m * plan.tiles_n * plan.splits
        b = stamps[:min(blocks, len(stamps))].astype(np.int64)
        rel = (b - b[:, :1]) / 1e3
        done = rel[:, 7] > 0  # the blocks of a split conv that were not last stop before the epilogue
        print(f"{shape} out {out_kind} residual {res_kind}: {times[0]:.2f} us ({times[1]:.2f} with the stamps), "
              f"equal to the plain version; {blocks} blocks (tile_n {plan.tile_n}, splits {plan.splits}), starts "
              f"spread over {(b[:, 0].max() - b[:, 0].min()) / 1e3:.1f} us")
        print("   us after the block's start: " + ", ".join(f"{name} {rel[done, i].mean():.2f}" for i, name in POINTS))

    print("sweep (int8 out, relu, offset): kernel us at each tile width and count of splits; the plan's marked *")
    for shape in SWEEP:
        N, H, W, cin, cout, k, s = shape
        x, wq, scale, offset = operands(N, H, W, cin, cout, k)
        plan = QC.launch_plan(*shape)
        want = QC.qconv_plain(x, wq, scale, offset, s, True, xs)
        widths = (256, 128) if cout > 128 else (plan.tile_n,)
        parts = []
        for tn in widths:
            tiles = plan.tiles_m * -(-cout // tn)
            counts = sorted({sp for sp in SPLITS if sp <= plan.steps and tiles * sp <= 2 * QC.SMS}
                            | ({plan.splits} if tn == plan.tile_n else set()))
            row = []
            for sp in counts:
                def run():
                    return launch(plain_lib, x, wq, scale, offset, s, True, xs, None, None, tn, sp)
                us = gpu_ms(run, iters=20) * 1e3
                if not torch.equal(run(), want):
                    sys.exit(f"{shape} at N = {tn}, {sp} splits: the kernel differs from the plain version")
                row.append(f"{sp}{'*' if (tn, sp) == (plan.tile_n, plan.splits) else ''} {us:.1f}")
            parts.append(f"N {tn} ({tiles} tiles): " + ", ".join(row))
        print(f"  {shape}, {plan.steps} steps: " + "; ".join(parts))

if __name__ == "__main__":
    main()
