"""The readings the limits of ``correct`` are set from, on the card:

    python3 -m cellbench.control --workload <cell> --seeds 11,12,13 --seconds 6

For each seed, in one process: one run of the cell with a short window at
the cell's own load (its numbers against the reference: the sound
readings), then the control on the same clips: the reference itself,
computed in the precision below the configuration's (int4 for int8,
float8 e4m3 for bfloat16), run from the same states and compared with the
reference as the program is. One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys


def control_numbers(cfg: dict, traffic: dict, keep: dict, device) -> dict:
    """The control's numbers over the clips a run's check compared
    (``keep`` as :func:`cellbench.run.run_cell` fills it)."""
    from cellbench import check

    ctrl = check.Reference(cfg, traffic, keep["weights"], keep["calib"], device, cfg["control_precision"])
    outs = check.reference_outputs(ctrl, keep["rings"], keep["jitter"], keep["calls"], keep["chosen"],
                                   traffic["clip_len"])
    return check.merge([check.compare(c[2], r[2], c[0], c[1], r[0], r[1])
                        for c, r in zip(outs, keep["ref_outs"], strict=True)])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=6.0)
    args = parser.parse_args(argv)

    import torch

    from cellbench.manifest import Manifest
    from cellbench.run import log, run_cell

    man = Manifest()
    wl = man.workload(args.workload)
    cfg, traffic = man.config(wl["config"]), man.traffic(wl["traffic"])
    if not torch.cuda.is_available():
        log("cellbench.control: no CUDA device")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        keep: dict = {}
        res = run_cell(cfg, traffic, seed, args.seconds, False, "cuda:0", end_to_end=man.end_to_end(wl["name"]),
                       keep=keep)
        line = {"workload": wl["name"], "seed": seed, "correct": res["correct"], "program": keep["numbers"],
                "control": control_numbers(cfg, traffic, keep, "cuda:0"), "control_precision": cfg["control_precision"],
                "metrics": {k: v["value"] for k, v in res["metrics"].items()}}
        print(json.dumps(line), flush=True)
        del keep
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
