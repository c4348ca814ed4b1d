#!/usr/bin/env python3
"""Where the time of ``csrc/nms.cu``'s one-launch route and of
``csrc/auction.cu`` goes, on the card.

    python3 scripts/nms_auction_timeline.py [--calls PATH]

Builds ``nms.cu`` with ``-DNMS_TIMING`` (the cluster's leader records the
SM clock and the global timer at its start, when the boxes are staged, when
the beats table is complete, after the rounds and after the compaction) and
``auction.cu`` with ``-DAUCTION_TIMING`` (thread 0 sums the SM cycles of the
set-up and, over the rounds, of the bids, the winners and the settling).
For the NMS at n 512 (tied and random scores), 48, 64 and 0
(``chip_smoke.py``'s cases; with ``--calls``, also the main path's own NMS
calls that ``chip_smoke.py --loop-calls PATH`` saves) it prints the kernel time between
CUDA events, an empty kernel launched with the same cluster, block and
shared memory, and the leader's phases in microseconds; for the auction at
64 x 48 tie-heavy the kernel time and its phases in cycles and microseconds
(at the SM clock the global timer implies). The clock reads change the code
around them: compare variants on plain builds.
"""

import ctypes
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from playground3d_tpu_torch.ops import assignment as A  # noqa: E402
from playground3d_tpu_torch.ops import nms as N  # noqa: E402
from playground3d_tpu_torch.ops.cuda_build import KernelLibrary  # noqa: E402
from playground3d_tpu_torch.ops.topk import DeviceRounds  # noqa: E402

PHASES = ("staged", "table complete", "rounds done", "compacted")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("nms_auction_timeline: needs a CUDA card")
    calls_path = sys.argv[sys.argv.index("--calls") + 1] if "--calls" in sys.argv else None
    dev = torch.device("cuda", 0)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def bind_nms(lib):
        N._bind(lib)
        lib.nms_read_stamps.argtypes = [ctypes.c_void_p]
        lib.nms_empty_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def bind_auction(lib):
        A._bind(lib)
        lib.auction_read_cycles.argtypes = [ctypes.c_void_p]

    N.LIB = KernelLibrary("nms", bind_nms, extra_flags=("-fmad=false", "-DNMS_TIMING"))
    A.LIB = KernelLibrary("auction", bind_auction, extra_flags=("-fmad=false", "-DAUCTION_TIMING"))
    nms_lib, auction_lib = N.LIB.load(), A.LIB.load()
    print(f"card: {chip_smoke.device_line()}")

    cases = [case[1:] for case in chip_smoke.nms_cases(np.random.default_rng(41))]
    cases = [cases[i] for i in (0, 1, 3, 4, 10)]
    if calls_path:  # the main path's own NMS calls, as chip_smoke.py records them
        rec = torch.load(calls_path)
        cases += [args for branch in rec["calls"].values() for kind, args in branch if kind == "nms"]
    clock_mhz = []
    for boxes, scores, mask, thr, max_keep, n_iter, groups in cases:
        b, s, m = (torch.as_tensor(a, device=dev) for a in (boxes, scores, mask))
        g = None if groups is None else torch.as_tensor(groups, device=dev)
        plan = N.launch_plan(len(boxes))
        DeviceRounds.reset()
        N.nms_cuda(b, s, m, thr, max_keep, n_iter, groups=g)
        rounds = DeviceRounds.read()["nms"]
        kernel_ms = chip_smoke.gpu_ms(lambda: N.nms_cuda(b, s, m, thr, max_keep, n_iter, groups=g), iters=50)
        stamps = np.zeros((5, 2), np.uint64)
        N.nms_cuda(b, s, m, thr, max_keep, n_iter, groups=g)
        torch.cuda.synchronize()
        N.LIB.check(nms_lib.nms_read_stamps(stamps.ctypes.data))
        empty_ms = chip_smoke.gpu_ms(lambda: N.LIB.check(nms_lib.nms_empty_launch(
            plan.cluster, plan.threads, plan.shared_bytes, stream())), iters=50)
        cyc = stamps[:, 0].astype(np.int64) - int(stamps[0, 0])
        ns = stamps[:, 1].astype(np.int64) - int(stamps[0, 1])
        if ns[-1] > 0:
            clock_mhz.append(cyc[-1] / ns[-1] * 1e3)
        print(f"nms n {len(boxes)} ({int(m.sum())} masked in, {rounds} rounds, {plan.cluster}-CTA cluster of {plan.threads} threads, "
              f"{plan.shared_bytes} B shared{', groups' if g is not None else ''}): kernel {kernel_ms * 1e3:.2f} us "
              f"between CUDA events; an empty kernel with the same launch {empty_ms * 1e3:.2f} us; leader from "
              f"its start: " + ", ".join(f"{p} {c / 1e3:.1f} kcycles / {t / 1e3:.2f} us" for p, c, t in
                                        zip(PHASES, cyc[1:], ns[1:])))

    label, ben, rm, cm, max_iters = chip_smoke.auction_cases(np.random.default_rng(43))[0]
    bt, rt, ct = (torch.as_tensor(a, device=dev) for a in (ben, rm, cm))
    DeviceRounds.reset()
    A.assign_auction_cuda(bt, rt, ct, max_iters)
    counts = DeviceRounds.read()
    kernel_ms = chip_smoke.gpu_ms(lambda: A.assign_auction_cuda(bt, rt, ct, max_iters), iters=20)
    cycles = np.zeros(8, np.uint64)
    A.assign_auction_cuda(bt, rt, ct, max_iters)
    torch.cuda.synchronize()
    A.LIB.check(auction_lib.auction_read_cycles(cycles.ctypes.data))
    mhz = float(np.median(clock_mhz)) if clock_mhz else float("nan")
    rounds = counts["auction"]
    names = ("whole kernel", "set-up", "bids", "winners", "settling", "its own scan", "its butterfly",
             "its bid and atomic")
    print(f"auction {label} ({rounds} rounds, {counts['auction_bids']} bids, {A.launch_plan(*ben.shape).threads} "
          f"threads): kernel {kernel_ms * 1e3:.2f} us between CUDA events; thread 0 at ~{mhz:.0f} MHz: "
          + ", ".join(f"{nm} {int(c)} cycles ({int(c) / mhz:.2f} us)" for nm, c in zip(names, cycles))
          + f"; a round {int(cycles[2] + cycles[3] + cycles[4]) / max(rounds, 1):.0f} cycles")


if __name__ == "__main__":
    main()
