# A frozen copy of the port's models/fpn.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Feature Pyramid Network P3-P7 (port of ``playground3d_tpu/models/fpn.py``,
reference model.py:59-117)."""

from __future__ import annotations

import torch
from torch import nn

from cellbench.reference.models.nn import Conv, apply_conv, crop_add, upsample2x_nearest


class FPN(nn.Module):
    def __init__(self, c3_size: int, c4_size: int, c5_size: int, feature_size: int = 256,
                 generator=None):
        super().__init__()
        g, fs = generator, feature_size
        self.P5_1 = Conv(c5_size, fs, 1, bias=True, generator=g)
        self.P5_2 = Conv(fs, fs, 3, bias=True, generator=g)
        self.P4_1 = Conv(c4_size, fs, 1, bias=True, generator=g)
        self.P4_2 = Conv(fs, fs, 3, bias=True, generator=g)
        self.P3_1 = Conv(c3_size, fs, 1, bias=True, generator=g)
        self.P3_2 = Conv(fs, fs, 3, bias=True, generator=g)
        self.P6 = Conv(c5_size, fs, 3, bias=True, generator=g)
        self.P7_2 = Conv(fs, fs, 3, bias=True, generator=g)

    def forward(self, c3, c4, c5, dtype=torch.bfloat16, conv=apply_conv):
        """NCHW (C3,C4,C5) -> [P3..P7]; the lateral 1x1 output is both
        upsampled for the next level and 3x3-smoothed for the output.
        ``conv(module, x, stride=, dtype=)`` replaces the convolution unit
        (int8 quantization and its calibration plug in there)."""
        p5_x = conv(self.P5_1, c5, dtype=dtype)
        p5_up = upsample2x_nearest(p5_x)
        p5 = conv(self.P5_2, p5_x, dtype=dtype)

        p4_x = crop_add(conv(self.P4_1, c4, dtype=dtype), p5_up)
        p4_up = upsample2x_nearest(p4_x)
        p4 = conv(self.P4_2, p4_x, dtype=dtype)

        p3_x = crop_add(conv(self.P3_1, c3, dtype=dtype), p4_up)
        p3 = conv(self.P3_2, p3_x, dtype=dtype)

        p6 = conv(self.P6, c5, stride=2, dtype=dtype)
        p7 = conv(self.P7_2, torch.relu(p6), stride=2, dtype=dtype)
        return [p3, p4, p5, p6, p7]
