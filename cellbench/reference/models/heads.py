# A frozen copy of the port's models/heads.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Classification and 12-channel regression heads shared across FPN levels
(port of ``playground3d_tpu/models/heads.py``, reference model.py:120-205)."""

from __future__ import annotations

import math

import torch
from torch import nn

from cellbench.reference.models.nn import Conv, apply_conv

N_REG_OUTPUTS = 12
PRIOR = 0.01  # focal-loss prior for the classification bias (model.py:252)


class Heads(nn.Module):
    """Two ``tower_depth``-conv towers (reference parity), or one shared
    tower feeding both output convs (``shared_tower=True``)."""

    def __init__(self, num_classes: int, num_anchors: int = 9, feature_size: int = 256,
                 tower_depth: int = 4, shared_tower: bool = False, generator=None):
        super().__init__()
        self.num_classes, self.num_anchors = num_classes, num_anchors
        fs, g = feature_size, generator

        def tower():
            return nn.ModuleList(Conv(fs, fs, 3, bias=True, generator=g) for _ in range(tower_depth))

        self.cls_tower = tower()
        self.reg_tower = None if shared_tower else tower()
        self.cls_out = Conv(fs, num_anchors * num_classes, 3, bias=True, generator=g)
        self.reg_out = Conv(fs, num_anchors * N_REG_OUTPUTS, 3, bias=True, generator=g)
        # focal prior init: zero weights, bias = -log((1-p)/p) (model.py:254-258)
        with torch.no_grad():
            self.cls_out.w.zero_()
            self.cls_out.b.fill_(-math.log((1.0 - PRIOR) / PRIOR))
            self.reg_out.w.zero_()
            self.reg_out.b.zero_()

    @staticmethod
    def _tower(tower, x, dtype, conv=apply_conv):
        for c in tower:
            x = torch.relu(conv(c, x, dtype=dtype))
        return x

    def forward(self, features, dtype=torch.bfloat16, apply_sigmoid: bool = True,
                compact: bool = False, score_path: bool = False, conv=apply_conv):
        """NCHW [P3..P7] -> (cls [N, A_total, K], reg [N, A_total, 12]),
        flattened per level in (y, x, anchor) order like the anchors.

        ``compact``: raw logits and regression in ``dtype``. ``score_path``:
        (per-anchor max logit, its class (int32), regression), the class
        reduction done per level before any concat. Otherwise float32 with
        a sigmoid on the classes (``apply_sigmoid``). ``conv(module, x,
        stride=, dtype=)`` replaces the convolution unit."""
        A, K = self.num_anchors, self.num_classes
        cls_all, reg_all, arg_all = [], [], []
        for f in features:
            n, _, h, w = f.shape
            ct = self._tower(self.cls_tower, f, dtype, conv)
            rt = ct if self.reg_tower is None else self._tower(self.reg_tower, f, dtype, conv)
            # NCHW -> NHWC before any reshape: the flatten order is (y, x, anchor)
            c = conv(self.cls_out, ct, dtype=dtype).permute(0, 2, 3, 1)
            r = conv(self.reg_out, rt, dtype=dtype).permute(0, 2, 3, 1)
            if score_path:
                c5 = c.reshape(n, h, w, A, K)
                cls_all.append(torch.amax(c5, dim=-1).reshape(n, h * w * A))
                arg_all.append(torch.argmax(c5, dim=-1).to(torch.int32).reshape(n, h * w * A))
            else:
                cls_all.append(c.reshape(n, h * w * A, K))
            reg_all.append(r.reshape(n, h * w * A, N_REG_OUTPUTS))
        cls = torch.cat(cls_all, dim=1)
        reg = torch.cat(reg_all, dim=1)
        if score_path:
            return cls.to(dtype), torch.cat(arg_all, dim=1), reg.to(dtype)
        if compact:
            return cls.to(dtype), reg.to(dtype)
        if apply_sigmoid:
            cls = torch.sigmoid(cls.to(torch.float32))
        return cls, reg.to(torch.float32)
