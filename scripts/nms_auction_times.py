#!/usr/bin/env python3
"""Time the NMS and auction kernels of the checkout at ROOT on one CUDA card.

    python3 scripts/nms_auction_times.py [ROOT] [--calls PATH]

Inputs are those of ``chip_smoke.py``'s kernels phase (this checkout's
``nms_cases`` and ``auction_cases``, same seeds): NMS at n 512 (one car box
at 8 px steps, tied scores, 23 rounds; the boxes shifted by
``group_shift``, then ``nms_cuda``), n 48, n 64 and n 1,024; ``batched_nms`` at n
512 through the public function (the groups shifted on the card); the
auction at 64 x 48 tie-heavy (457 rounds). With ``--calls``, also every
NMS and auction call of one detect frame and one crop frame of the main
path, as ``chip_smoke.py --loop-calls PATH`` saves them, replayed through
the public functions, and their launches x time per 24-frame clip.

Times are CUDA events around 200 launches after a queued sleep (device time,
warm inputs), the median of 5 such means. Prints one JSON line. To compare
two checkouts, run this on each on the same card, in turns (parent, change,
change, parent).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke_module():
    """This checkout's chip_smoke.py (for its input cases and timer)."""
    spec = importlib.util.spec_from_file_location("smoke_cases", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def timed(fn, iters: int = 200, reps: int = 5) -> float:
    """Median over ``reps`` of the mean device ms of ``fn()`` over ``iters``."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(1e8))  # the host enqueues every launch before the card reaches them
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        torch.cuda.synchronize()
        means.append(s.elapsed_time(e) / iters)
    return float(np.median(means))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=HERE)
    ap.add_argument("--calls", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        sys.exit("nms_auction_times: needs a CUDA card")
    from playground3d_tpu_torch.ops import assignment as A
    from playground3d_tpu_torch.ops import nms as N
    from playground3d_tpu_torch.ops.topk import DeviceRounds

    if not N.__file__.startswith(root):
        sys.exit(f"nms_auction_times: imported {N.__file__}, not the checkout at {root}")
    dev = torch.device("cuda", 0)
    smoke = smoke_module()
    cases = smoke.nms_cases(np.random.default_rng(41))
    out = {"root": root, "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]}

    def nms_inputs(i):
        _, boxes, scores, mask, thr, max_keep, n_iter, groups = cases[i]
        b, s, m = (torch.as_tensor(a, device=dev) for a in (boxes, scores, mask))
        g = None if groups is None else torch.as_tensor(groups, device=dev)
        shifted = (b if g is None else N.group_shift(b, g, m)).contiguous()
        return b, shifted, s, m, g, thr, max_keep, n_iter

    for i, name in ((0, "512"), (3, "48"), (4, "64"), (11, "1024")):
        _, shifted, s, m, _, thr, max_keep, n_iter = nms_inputs(i)
        DeviceRounds.reset()
        got = N.nms_cuda(shifted, s, m, thr, max_keep, n_iter)
        out[f"nms_rounds_{name}"] = DeviceRounds.read()["nms"]
        ref = N.nms_plain(shifted, s, m, thr, max_keep, n_iter)
        out[f"nms_equal_{name}"] = all(torch.equal(x, y) for x, y in zip(got, ref))
        out[f"nms_us_{name}"] = timed(lambda: N.nms_cuda(shifted, s, m, thr, max_keep, n_iter)) * 1e3
    b, _, s, m, g, thr, max_keep, n_iter = nms_inputs(0)
    out["batched_nms_us_512"] = timed(lambda: N.batched_nms(b, s, g, m, thr, max_keep, n_iter)) * 1e3

    label, ben, rm, cm, max_iters = smoke.auction_cases(np.random.default_rng(43))[0]
    bt, rt, ct = (torch.as_tensor(a, device=dev) for a in (ben, rm, cm))
    DeviceRounds.reset()
    A.assign_auction_cuda(bt, rt, ct, max_iters)
    counts = DeviceRounds.read()
    out["auction_case"] = label
    out["auction_rounds"], out["auction_bids"] = counts["auction"], counts["auction_bids"]
    out["auction_us"] = timed(lambda: A.assign_auction_cuda(bt, rt, ct, max_iters), iters=50) * 1e3

    if args.calls:
        rec = torch.load(args.calls)
        per_clip = rec["per_clip"]
        clip = {"nms": 0.0, "auction": 0.0}
        for branch, calls in rec["calls"].items():
            for kind, a in calls:
                a = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x for x in a)
                if kind == "nms":
                    cb, cs, cm_, cthr, ckeep, citer, cg = a
                    fn = ((lambda: N.nms(cb, cs, cm_, cthr, ckeep, citer)) if cg is None else
                          (lambda: N.batched_nms(cb, cs, cg, cm_, cthr, ckeep, citer)))
                else:
                    fn = lambda: A.assign_auction(*a)  # noqa: E731
                us = timed(fn, iters=50) * 1e3
                clip[kind] += us * per_clip[branch]
                out.setdefault(f"calls_{branch}", []).append([kind, list(a[0].shape), round(us, 3)])
        out["clip_nms_us"], out["clip_auction_us"] = clip["nms"], clip["auction"]

    print(json.dumps(out))


if __name__ == "__main__":
    main()
