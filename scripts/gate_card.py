#!/usr/bin/env python3
"""The multi-camera quality gate of the PyTorch port on one CUDA card:
``apps/demo_e2e_mc.py`` at the JAX app's defaults (ResNet-18 nets, 512x768,
3 cameras, ``--steps 600 --crop-steps 400 --frames 60``), trained once,
then tracked from its checkpoints float (``--cd-max`` 16, the app's
default, and 8) and ``--quantize --cd-max 8``, each over ``--sequences 3
--track-seeds 1``.

    python3 scripts/gate_card.py [--out DIR] [--ckpt-dir DIR] [--steps 600 --crop-steps 400]

Every app log goes to ``--out``'s ``<run>.log`` (the format
``scripts/ship_decision.py`` reads); the checkpoints (~80 MB each) go to
``--ckpt-dir`` (gitignored ``_outputs/gate`` by default). The last lines
are the card's name and power limit, then one JSON object: per tracking run the mean and spread of each metric and every
sequence's; training steps/s of both nets (from the log's clock between the
first and the last step it prints, each printed after a read of the step's
loss); and per tracking run the seconds of each sequence (from one
sequence's log line to the next: rendering on the host, the clip loop,
the CSV and the MOT evaluation; the first also loads and captures).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_app(argv, log_path):
    """``demo_e2e_mc.main(argv)`` with its output teed to ``log_path`` ->
    (result, log text, wall seconds)."""
    from playground3d_tpu_torch.apps import demo_e2e_mc

    buf = io.StringIO()
    t0 = time.time()
    with open(log_path, "w") as fh, contextlib.redirect_stdout(_Tee(sys.stdout, buf, fh)):
        out = demo_e2e_mc.main(argv)
    return out, buf.getvalue(), time.time() - t0


def clock(text, pattern):
    """[(seconds on the log's clock, match)] of the lines matching."""
    out = []
    for line in text.splitlines():
        m = re.match(r"^\[ *([0-9.]+)s\] (.*)$", line)
        if m and re.search(pattern, m.group(2)):
            out.append((float(m.group(1)), re.search(pattern, m.group(2))))
    return out


def steps_per_s(text, tag):
    steps = clock(text, rf"^{tag} step (\d+): loss=")
    (t0, m0), (t1, m1) = steps[0], steps[-1]
    return (int(m1.group(1)) - int(m0.group(1))) / (t1 - t0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="_outputs/gate_logs")
    ap.add_argument("--ckpt-dir", default="_outputs/gate")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--crop-steps", type=int, default=400)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--sequences", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("gate_card: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    prefix = os.path.join(args.ckpt_dir, "mc")
    summary = {"card": torch.cuda.get_device_name(0), "steps": args.steps, "crop_steps": args.crop_steps,
               "frames": args.frames, "sequences": args.sequences}

    _, text, wall = run_app(["--steps", str(args.steps), "--crop-steps", str(args.crop_steps), "--sequences", "0",
                             "--out-prefix", prefix], os.path.join(args.out, "train.log"))
    summary["train"] = {"wall_s": wall, "detector_steps_per_s": steps_per_s(text, "detector"),
                        "crop_steps_per_s": steps_per_s(text, "crop-detector")}

    ckpts = ["--det-ckpt", prefix + "_det.npz", "--crop-ckpt", prefix + "_crop.npz", "--frames", str(args.frames),
             "--sequences", str(args.sequences), "--track-seeds", "1"]
    for name, extra in (("float_cd16", []), ("float_cd8", ["--cd-max", "8"]),
                        ("int8_cd8", ["--quantize", "--cd-max", "8"])):
        metrics, text, wall = run_app(ckpts + extra + ["--out-prefix", os.path.join(args.out, name)],
                                      os.path.join(args.out, f"{name}.log"))
        marks = [t for t, _ in clock(text, r"^loaded crop checkpoint|^both networks quantized|^seq seed=")]
        seq_s = [b - a for a, b in zip(marks[-args.sequences - 1:], marks[-args.sequences:])]
        summary[name] = {
            "wall_s": wall, "sequence_s": seq_s, "frames_per_s": [args.frames / s for s in seq_s],
            **{k: metrics[k] for k in ("Recall", "Precision", "MOTA", "ID switches", "TP", "FP", "FN")},
            "spread": metrics["spread"],
            "runs": [{k: float(m[k]) for k in ("Recall", "Precision", "MOTA", "ID switches")} for m in metrics["runs"]],
        }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: not available")
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
