#!/usr/bin/env python3
"""Render ``docs/QCONV_SHAPES.md`` from the per-shape table that
``python3 chip_smoke.py`` writes to ``_outputs/qconv_shapes.json``.

    python3 scripts/qconv_shapes_table.py --card "$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)"

Reads the JSON (``--json``), writes the markdown (``--out``). Needs no card.
"""

import argparse
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HEADER = """# Every int8 conv of the main path on the H100, by shape

From one run of `python3 chip_smoke.py` (its `kernels: qconv` table, saved
as `_outputs/qconv_shapes.json` and rendered by
`scripts/qconv_shapes_table.py`) on one card: {card} (name and
power limit as `nvidia-smi` gives them). The shapes are listed by a hook on
`models/quant.py`'s `qconv` during one detect frame (ResNet-50 + FPN + two
4-conv 256-wide towers at 1080p, heads on P3-P7) and one crop frame
(ResNet-18 + FPN + a shared 2-conv tower on 32 crops of 112 px) of the
quantized pair. Times are means of 20 launches between CUDA events, operands
warm in L2. `bf16 F.conv2d` is cuDNN on the same shape, channels-last,
operands already cast and padded (what the float path runs there);
`_int_mm` is `torch._int_mm` on the same int8 operands at k = 1, stride 1
(the int32 accumulators alone, no epilogue); `plain` is the exact float64
convolution plus the epilogue in tensor ops; `bound` is the larger of 2 x
MACs over 1,979 TOPS and (input + weights + residual + output + scales)
bytes over 3.35 TB/s. `relu`/`out`: the fused epilogue (every call has an
offset or bias); `res`: the residual of a ResNet block fused into the
epilogue (`int8`: the block input; `bf16`: `down_conv`'s output). `tile N`
and `splits`: the kernel's tile width and the blocks that share a tile's K
loop (`ops/qconv.py::launch_plan`).
"""

COLS = ("| N | H | W | Cin | Cout | k | stride | relu | out | res | per detect frame | per crop frame | tile N | splits "
        "| kernel us | bf16 `F.conv2d` us | `_int_mm` us | plain us | bound us | bound by | TMAC/s |")


def row(r: dict) -> str:
    mm = f"{r['int_mm_ms'] * 1e3:.2f}" if r.get("int_mm_ms") is not None else "-"
    return (f"| {r['N']} | {r['H']} | {r['W']} | {r['Cin']} | {r['Cout']} | {r['k']} | {r['stride']} | "
            f"{int(r['relu'])} | {r['out']} | {r['residual']} | {r['per_detect']} | {r['per_crop']} | {r['tile_n']} | "
            f"{r['splits']} | {r['ms'] * 1e3:.2f} | {r['library_ms'] * 1e3:.2f} | {mm} | {r['plain_ms'] * 1e3:.1f} | "
            f"{r['bound_ms'] * 1e3:.3f} | {r['bound_by']} | {r['macs'] / r['ms'] / 1e9:.2f} |")


def render(data: dict, card: str) -> str:
    rows, totals = data["rows"], data["totals"]
    lines = [HEADER.format(card=card)]
    parts = []
    for branch in ("detect", "crop"):
        t = totals[branch]
        parts.append(
            f"per {branch} frame {t['launches']} launches ({t['fused']} with a block's tail fused), "
            f"{t['macs'] / 1e9:.1f} GMAC, kernel {t['ms']:.3f} ms, bf16 convs {t['library_ms']:.3f} ms, plain "
            f"{t['plain_ms']:.1f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms'] * 100:.1f}% of bound); "
            f"its {t['int_mm'][2]} k = 1 stride-1 shapes: kernel {t['int_mm'][0]:.3f} ms, `_int_mm` "
            f"{t['int_mm'][1]:.3f} ms")
    lines.append("Totals: " + "; ".join(parts) + ".")
    if data.get("host_us_per_launch") is not None:
        lines[-1] += f" Host time of one launch (wrapper, checks, plan, launch): {data['host_us_per_launch']:.1f} us."
    for branch, per in (("Detect", "per_detect"), ("Crop", "per_crop")):
        lines += ["", f"## {branch} frame, heaviest first", "", COLS, "|" + " --- |" * (COLS.count("|") - 1)]
        for r in sorted((r for r in rows if r[per]), key=lambda r: -r[per] * r["ms"]):
            lines.append(row(r))
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=os.path.join(ROOT, "_outputs", "qconv_shapes.json"))
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "QCONV_SHAPES.md"))
    ap.add_argument("--card", required=True, help="the card's name and power limit, as nvidia-smi gives them")
    args = ap.parse_args()
    with open(args.json) as fh:
        data = json.load(fh)
    text = render(data, args.card)
    with open(args.out, "w") as fh:
        fh.write(text)


if __name__ == "__main__":
    main()
