"""The r50 configurations' drawn weights and operation counts, pinned: the
digests and counts below were recorded before the nets' wiring moved into
``cellbench/archs/retinanet_resnet.py``, and must not move with it."""

import hashlib
import json

import pytest

from cellbench import archs, cell, run
from cellbench.manifest import PKG
from cellbench.tests.tiny import tiny_cell

SEED = 2**31 + 2**30 + 17
CELLS = [("r50_s2d_int8", "pole6_yuv_backlog"), ("r50_conv7_bf16", "pole6_rgb_backlog")]
WEIGHTS = {  # (config, size) -> sha256 of (detector, crop net) weights drawn on the CPU
    ("r50_s2d_int8", "tiny"): ("368ac19c5587a7a89d8abb3f99f85ea3aededf2096a4ec9734722443c3728e3d",
                               "e5419572a76274f840e04a1d54c92cb99ad245f94fe78479ae80984178fb02eb"),
    ("r50_s2d_int8", "full"): ("cea6f4409a2f8d4cda3426c40105bdebc1cd39b0c9e028be1bea7d6b1e29aeb9",
                               "adf19433f00cc912839432bb6350893a07a322c1bef1485484243a914160ae56"),
    ("r50_conv7_bf16", "tiny"): ("d408f4b9b7c93e97e7f420a9ebd09d0acb6b374d8d62153dc582719afbe310b5",
                                 "ea15e7ba23d817997b15b8db0a87a01746e934b23717b450842a6b1a4967f9c9"),
    ("r50_conv7_bf16", "full"): ("e35edc8cd972a8683791a217f6e5d6d3920c1fbb53dccae8897f7e5cb66bcad4",
                                 "24b72f7be13c4ab410a73f356d83e4341f0668e36b2ba3d518795eab454c32a9"),
}
OPS = {  # config -> (a detect frame of 6 cameras, a crop frame of 32 crops) at the cell's shapes
    "r50_s2d_int8": (5_104_030_003_200, 68_614_750_208),  # 6 x 270 x 480 x 48; 32 x 28 x 28 x 48
    "r50_conv7_bf16": (5_119_557_120_000, 69_115_707_392),  # 6 x 1080 x 1920 x 3; 32 x 112 x 112 x 3
}


def digest(weights):
    h = hashlib.sha256()
    for k in sorted(weights):
        t = weights[k].detach().to("cpu").contiguous()
        h.update(f"{k}:{tuple(t.shape)}:{t.dtype};".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def full_cell(config, traffic):
    with open(PKG / "configs" / f"{config}.json") as fh:
        cfg = dict(json.load(fh), name=config)
    with open(PKG / "traffic" / f"{traffic}.json") as fh:
        tr = dict(json.load(fh), name=traffic)
    return cfg, tr


@pytest.mark.parametrize("size", ["tiny", "full"])
@pytest.mark.parametrize("config,traffic", CELLS)
def test_weights_digest_is_pinned(config, traffic, size):
    cfg, tr = (tiny_cell if size == "tiny" else full_cell)(config, traffic)
    std = cfg["weights"]["output_conv_std"]
    det, crop = cfg["detector"], cfg["crop_net"]
    got = (digest(archs.of(det).raw_weights(det, cell.sub_seed(SEED, 3), "cpu", std)),
           digest(archs.of(crop).raw_weights(crop, cell.sub_seed(SEED, 4), "cpu", std,
                                             reg_bias_xy=cell.crop_target(cfg, tr))))
    assert got == WEIGHTS[config, size]


@pytest.mark.parametrize("config,traffic", CELLS)
def test_operation_counts_are_pinned(config, traffic):
    cfg, tr = full_cell(config, traffic)
    det_ops, crop_ops = run.frame_ops(cfg, tr, cfg["tracker"]["crop_slots"])
    p = cfg["precision"]
    assert (det_ops, crop_ops) == ({p: OPS[config][0]}, {p: OPS[config][1]})
