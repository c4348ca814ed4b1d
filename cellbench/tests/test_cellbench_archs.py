"""A net's architecture is found by name: a new one is a module under
``cellbench/archs/`` and a configuration naming it, with no edit to the
harness. This file is itself such a module (``toy_attention``), registered
under the finder's package for its tests alone: a backbone of linears and
one multi-head attention, in bfloat16, before the RetinaNet FPN and heads,
which an int8 configuration quantizes (the layout a transformer backbone's
detector takes: a float backbone beside an int8 tail)."""

import ast
import copy
import json
import math
import sys

import pytest
import torch
from torch import nn

from cellbench import archs, run
from cellbench.manifest import PKG
from cellbench.tests.tiny import tiny_cell

NAME = "toy_attention"
SEED = 2**31 + 2**29 + 3


class Linear(nn.Module):
    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n_out, n_in))
        self.b = nn.Parameter(torch.empty(n_out))

    def forward(self, x):
        return x @ self.w.to(x.dtype).T + self.b.to(x.dtype)


def merge2x2(x):
    """[n, h, w, c] -> [n, h/2, w/2, 4c]: each 2x2 patch of tokens one token."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


class ToyBackbone(nn.Module):
    """s2d-packed images [n, h, w, 48] -> NCHW (C3, C4, C5) at strides 8,
    16 and 32: three 2x2 patch merges, each a linear, and a multi-head
    self-attention over C5's tokens with a residual."""

    def __init__(self, dims, heads: int):
        super().__init__()
        c3, c4, c5 = dims
        self.heads = heads
        self.embed3, self.embed4, self.embed5 = Linear(4 * 48, c3), Linear(4 * c3, c4), Linear(4 * c4, c5)
        self.qkv, self.proj = Linear(c5, 3 * c5), Linear(c5, c5)

    def forward(self, x, dtype=torch.bfloat16):
        c3 = torch.relu(self.embed3(merge2x2(x.to(dtype))))
        c4 = torch.relu(self.embed4(merge2x2(c3)))
        c5 = self.embed5(merge2x2(c4))
        n, h, w, c = c5.shape
        q, k, v = self.qkv(c5.reshape(n, h * w, c)).reshape(n, h * w, 3, self.heads, c // self.heads).permute(
            2, 0, 3, 1, 4)
        att = torch.softmax((q @ k.transpose(-1, -2)).to(torch.float32) / math.sqrt(c // self.heads), dim=-1)
        o = (att.to(dtype) @ v).transpose(1, 2).reshape(n, h, w, c)
        c5 = torch.relu(c5 + self.proj(o))
        return tuple(f.permute(0, 3, 1, 2) for f in (c3, c4, c5))


class ToyNet(nn.Module):
    def __init__(self, net, fpn_cls, heads_cls):
        super().__init__()
        self.num_classes, self.stem = net["num_classes"], layout(net)
        self.backbone = ToyBackbone(net["dims"], net["heads"])
        self.fpn = fpn_cls(*net["dims"], feature_size=net["feature_size"])
        self.heads = heads_cls(net["num_classes"], feature_size=net["feature_size"], tower_depth=net["tower_depth"],
                               shared_tower=net["shared_tower"])


def _model(net, side):
    with torch.device("meta"):
        return ToyNet(net, side.fpn.FPN, side.heads.Heads)


def _reference():
    from cellbench.reference.models import fpn, heads, quant, retinanet

    return type("Side", (), dict(fpn=fpn, heads=heads, quant=quant, retinanet=retinanet))


def _program():
    from playground3d_tpu_torch.models import fpn, heads, quant, retinanet

    return type("Side", (), dict(fpn=fpn, heads=heads, quant=quant, retinanet=retinanet))


def _quantize_tail(model, calib, side):
    """The FPN and heads quantized by ``side``'s own code, calibrated on the
    float backbone's features of ``calib``; the backbone stays float."""
    c3, c4, c5 = model.backbone(side.retinanet.normalize_on_device(calib))
    qt = side.quant.quantize_tail(model, side.quant.calibrate_tail(model, c3, c4, c5))
    out = copy.copy(model)
    out._modules = dict(model._modules)
    out.fpn, out.heads = qt["fpn"], qt["heads"]
    return out


def shapes(net):
    return {k: tuple(v.shape) for k, v in _model(net, _reference()).state_dict().items()}


def raw_weights(net, seed, device, out_std, reg_bias_xy=None):
    return archs.draw_weights(shapes(net), seed, device, out_std, reg_bias_xy)


def build(net, weights, device, precision, calib, side):
    side = {"program": _program, "reference": _reference}[side]()
    model = archs.load(_model(net, side), weights, device)
    return _quantize_tail(model, calib, side) if precision in ("int8", "int4") else model


def layout(net):
    """s2d-packed frames, whatever the configuration says of a stem."""
    return "s2d"


def ops(net, images_shape, precision, min_level=3):
    """The backbone's matmuls (linears and the attention's two) in
    bfloat16, the FPN's and heads' convolutions at ``precision``."""
    from cellbench.reference.models.nn import Conv

    side = _reference()
    model = _model(net, side)
    macs = {"backbone": 0, "tail": 0}

    def linear(m, args, out):
        macs["backbone"] += out.numel() * m.w.shape[1]

    def attention(m, args, out):
        n, c, h, w = out[2].shape
        macs["backbone"] += 2 * n * (h * w) ** 2 * c

    def conv(m, args, out):
        macs["tail"] += out.numel() * m.w.shape[1] * m.k * m.k

    hooks = [m.register_forward_hook(linear) for m in model.modules() if isinstance(m, Linear)]
    hooks += [m.register_forward_hook(conv) for m in model.modules() if isinstance(m, Conv)]
    hooks.append(model.backbone.register_forward_hook(attention))
    try:
        with torch.no_grad():
            side.retinanet.forward_raw(model, torch.empty(images_shape, dtype=torch.uint8, device="meta"),
                                       compact=True, min_level=min_level, score_path=True)
    finally:
        for h in hooks:
            h.remove()
    out = {"bf16": 2 * macs["backbone"]}
    out[precision] = out.get(precision, 0) + 2 * macs["tail"]
    return out


KERNELS = ("qconv", "quantize")


def tiny(net):
    return dict(net, dims=[128, 128, 128], heads=2, feature_size=128, tower_depth=1)


TOY_DETECTOR = {"arch": NAME, "dims": [64, 128, 320], "heads": 4, "feature_size": 256, "tower_depth": 4,
                "shared_tower": False, "num_classes": 8}


@pytest.fixture
def toy(monkeypatch):
    monkeypatch.setitem(sys.modules, f"cellbench.archs.{NAME}", sys.modules[__name__])


def toy_config():
    with open(PKG / "configs" / "r50_s2d_int8.json") as fh:
        cfg = dict(json.load(fh), name="toy_s2d_int8")
    cfg["detector"] = dict(TOY_DETECTOR)
    return cfg


def hand_count(cfg, tr):
    """The toy detector's operations over one detect frame, counted by hand
    from the layer sizes: (bfloat16 backbone, int8 FPN and heads)."""
    det, n = cfg["detector"], len(tr["cameras"])
    c3, c4, c5 = det["dims"]
    fs, depth, k, a = det["feature_size"], det["tower_depth"], det["num_classes"], 9
    hw = [(tr["height"] // 2 ** level, tr["width"] // 2 ** level) for level in range(3, 6)]
    hw += [(-(-hw[2][0] // 2), -(-hw[2][1] // 2))]
    hw += [(-(-hw[3][0] // 2), -(-hw[3][1] // 2))]
    px = [h * w for h, w in hw]  # pixels of P3..P7
    backbone = px[0] * 4 * 48 * c3 + px[1] * 4 * c3 * c4 + px[2] * 4 * c4 * c5  # the three patch merges
    backbone += px[2] * c5 * 3 * c5 + 2 * px[2] ** 2 * c5 + px[2] * c5 * c5  # qkv, scores and values, proj
    fpn = px[2] * c5 * fs + px[1] * c4 * fs + px[0] * c3 * fs  # the laterals
    fpn += sum(px[:3]) * fs * fs * 9 + px[3] * c5 * fs * 9 + px[4] * fs * fs * 9  # smoothing, P6, P7
    heads = sum(px) * fs * 9 * (2 * depth * fs + a * k + a * 12)
    return {"bf16": 2 * n * backbone, "int8": 2 * n * (fpn + heads)}


def test_toy_tiny_cell_is_correct_and_its_ops_are_counted(toy):
    cfg, tr = tiny_cell(toy_config(), "pole6_yuv_backlog")
    assert cfg["detector"]["arch"] == NAME and cfg["detector"]["dims"] == [128, 128, 128]
    keep: dict = {}
    res = run.run_cell(cfg, tr, SEED, 1.0, False, "cpu", keep=keep)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    # what both sides ran: a float backbone, an int8 FPN and heads
    for side in archs.SIDES:
        net = build(cfg["detector"], keep["weights"]["detector"], "cpu", "int8", keep["calib"]["detector"], side)
        assert isinstance(net.backbone, ToyBackbone) and not hasattr(net.backbone.embed3, "wq")
        assert all(c.wq is not None for c in (net.fpn.P3_1, net.heads.cls_tower[0], net.heads.reg_out))
    det_ops, crop_ops = run.frame_ops(cfg, tr, cfg["tracker"]["crop_slots"])
    assert det_ops == hand_count(cfg, tr)
    assert set(crop_ops) == {"int8"}  # the crop net is the default architecture, all int8


def test_toy_ops_at_full_size_by_hand(toy):
    cfg = toy_config()
    tr = {"cameras": [0] * 6, "height": 1024, "width": 2048}  # even down to P5: the toy's patch merges need it
    assert run.frame_ops(cfg, tr, 32)[0] == hand_count(cfg, tr)


def test_mfu_holds_each_precision_against_its_peak():
    from types import SimpleNamespace

    from cellbench.manifest import Manifest

    ctx = SimpleNamespace(window_s=2.0, branch_frames={"detect": 4, "crop": 8}, det_ops={"bf16": 3e12, "int8": 1e12},
                          crop_ops={"int8": 5e10}, cfg={"precision": "int8", "peak_ops_per_s": 2e15})
    want = 100 * 4 * 3e12 / 2.0 / 0.989e15 + 100 * (4 * 1e12 + 8 * 5e10) / 2.0 / 2e15
    assert Manifest().reader("mfu_pct").read(ctx) == pytest.approx(want, rel=1e-12)


def test_unknown_architecture_names_those_there_are():
    with pytest.raises(ValueError, match="no architecture 'pvt_v9'.*retinanet_resnet"):
        archs.of({"arch": "pvt_v9"})
    with pytest.raises(ValueError, match="retinanet_resnet"):
        archs.of({"arch": "../cell"})
    assert archs.of({}) is archs.of({"arch": "retinanet_resnet"})
    assert NAME not in archs.available()  # registered for these tests alone


CORE = ["cell.py", "program.py", "check.py", "counts.py", "run.py", "tests/tiny.py"]


@pytest.mark.parametrize("path", CORE)
def test_core_files_name_no_architecture(path):
    text = (PKG / path).read_text()
    for word in ("RetinaNet", "ResNet", "quantize_detector", '["depth"]', '["stem"]'):
        assert word not in text, (path, word)
    ast.parse(text)
