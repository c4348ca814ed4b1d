"""A cell at a tiny size for the benchmark's own tests on the CPU: the
configurations' and mixes' keys, with small nets (each cut by its
architecture module), frames and capacities."""

from __future__ import annotations

import copy
import json

from cellbench import archs, cell
from cellbench.manifest import PKG


def tiny_cell(config, traffic: str):
    """(config, traffic) dicts of the named files (``config`` a name, or a
    configuration's dict), cut to run in seconds on the CPU."""
    if isinstance(config, str):
        with open(PKG / "configs" / f"{config}.json") as fh:
            config = dict(json.load(fh), name=config)
    with open(PKG / "traffic" / f"{traffic}.json") as fh:
        tr = dict(json.load(fh), name=traffic)
    cfg = copy.deepcopy(config)
    for net in cell.NETS:
        cfg[net] = archs.of(cfg[net]).tiny(cfg[net])
    cfg["tracker"].update(max_tracks=16, max_dets=16, pre_topk=64, cs=32, crop_slots=8)
    cfg["seeded_tracks"] = 8
    tr.update(cameras=tr["cameras"][:2], height=64, width=96, clip_len=12, ring=3, warm_clips=2, check_clips=1)
    return cfg, tr
