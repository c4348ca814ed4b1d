# A frozen copy of the port's models/resnet.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""ResNet backbones (18/34/50/101/152) returning C3/C4/C5 (port of
``playground3d_tpu/models/resnet.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from cellbench.reference.models.nn import Conv, FrozenBN, max_pool

LAYER_SPECS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def default_conv_bn(dtype=torch.bfloat16):
    """The conv -> frozen BN (-> relu) unit of the blocks, as a callable
    ``cb(conv, bn, x, stride, relu)``. :meth:`ResNet.forward` takes another
    in its place: int8 quantization and its calibration plug in there
    (``models/quant.py``)."""

    def cb(conv: Conv, bn: FrozenBN, x, stride: int = 1, relu: bool = False):
        y = bn(conv(x, stride, dtype))
        return torch.relu(y) if relu else y

    return cb


class BasicBlock(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int, generator=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(in_ch, planes, 3, generator=generator)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv(planes, planes, 3, generator=generator)
        self.bn2 = FrozenBN(planes)
        if stride != 1 or in_ch != planes:
            self.down_conv = Conv(in_ch, planes, 1, generator=generator)
            self.down_bn = FrozenBN(planes)
        else:
            self.down_conv = None

    def forward(self, x, cb):
        out = cb(self.conv1, self.bn1, x, self.stride, True)
        out = cb(self.conv2, self.bn2, out, 1, False)
        res = x
        if self.down_conv is not None:
            res = cb(self.down_conv, self.down_bn, x, self.stride, False)
        return torch.relu(out + res)


class Bottleneck(nn.Module):
    def __init__(self, in_ch: int, planes: int, stride: int, generator=None):
        super().__init__()
        self.stride = stride
        self.conv1 = Conv(in_ch, planes, 1, generator=generator)
        self.bn1 = FrozenBN(planes)
        self.conv2 = Conv(planes, planes, 3, generator=generator)
        self.bn2 = FrozenBN(planes)
        self.conv3 = Conv(planes, planes * 4, 1, generator=generator)
        self.bn3 = FrozenBN(planes * 4)
        if stride != 1 or in_ch != planes * 4:
            self.down_conv = Conv(in_ch, planes * 4, 1, generator=generator)
            self.down_bn = FrozenBN(planes * 4)
        else:
            self.down_conv = None

    def forward(self, x, cb):
        out = cb(self.conv1, self.bn1, x, 1, True)
        out = cb(self.conv2, self.bn2, out, self.stride, True)
        out = cb(self.conv3, self.bn3, out, 1, False)
        res = x
        if self.down_conv is not None:
            res = cb(self.down_conv, self.down_bn, x, self.stride, False)
        return torch.relu(out + res)


def space_to_depth(x: torch.Tensor, block: int = 4) -> torch.Tensor:
    """[N,H,W,C] -> [N,H/b,W/b,C*b*b], channels packed (by, bx, c) as the
    JAX package packs them (``pixel_unshuffle`` packs (c, by, bx))."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // block, w // block, c * block * block)


class ResNet(nn.Module):
    """``stem``: "conv7" = 7x7/2 conv + 3x3/2 max pool (reference parity);
    "s2d" = space-to-depth(4x4) + 3x3/1 conv."""

    def __init__(self, depth: int = 50, stem: str = "conv7",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.depth, self.stem = depth, stem
        block_type, layers = LAYER_SPECS[depth]
        expansion = 1 if block_type == "basic" else 4
        block = BasicBlock if block_type == "basic" else Bottleneck
        if stem == "s2d":
            self.conv1 = Conv(48, 64, 3, generator=generator)
        else:
            self.conv1 = Conv(3, 64, 7, generator=generator)
        self.bn1 = FrozenBN(64)
        in_ch = 64
        for stage, (planes, n_blocks, stride) in enumerate(
            zip((64, 128, 256, 512), layers, (1, 2, 2, 2))
        ):
            blocks = []
            for i in range(n_blocks):
                blocks.append(block(in_ch, planes, stride if i == 0 else 1, generator))
                in_ch = planes * expansion
            setattr(self, f"layer{stage + 1}", nn.ModuleList(blocks))

    def forward(self, x: torch.Tensor, dtype=torch.bfloat16, conv_bn=None):
        """NHWC images (s2d: raw [N,H,W,3] or packed [N,H/4,W/4,48]) ->
        NCHW (C3, C4, C5). ``conv_bn`` replaces the conv -> BN (-> relu) unit
        of every convolution (see :func:`default_conv_bn`); the call order
        is the contract that ``models/quant.py::_iter_conv_bn`` mirrors."""
        cb = conv_bn if conv_bn is not None else default_conv_bn(dtype)
        if self.stem == "s2d" and x.shape[-1] == 3:
            x = space_to_depth(x, 4)
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels-last memory order
        if self.stem == "s2d":
            x = cb(self.conv1, self.bn1, x, 1, True)
        else:
            x = cb(self.conv1, self.bn1, x, 2, True)
            x = max_pool(x, 3, 2)
        feats = []
        for stage in range(4):
            for blk in getattr(self, f"layer{stage + 1}"):
                x = blk(x, cb)
            feats.append(x)
        return feats[1], feats[2], feats[3]


def fpn_sizes(depth: int) -> Tuple[int, int, int]:
    """Channel counts of C3, C4, C5 (reference model.py:222-227)."""
    expansion = 1 if LAYER_SPECS[depth][0] == "basic" else 4
    return 128 * expansion, 256 * expansion, 512 * expansion
