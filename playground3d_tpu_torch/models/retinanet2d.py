"""Stock 2D RetinaNet variant (port of ``playground3d_tpu/models/retinanet2d.py``;
reference top-level ``retinanet/`` package).

The reference keeps an unmodified yhenon-style 2D detector beside the
directional 3D one (retinanet/model.py: 4-output regression, standard
(dx,dy,dw,dh) decode with std scaling, 2D focal loss retinanet/losses.py).
This module provides the same capability on the shared backbone/FPN: a
4-channel regression head, the classic box decode, :func:`detect_2d` with
per-class NMS (``csrc/nms.cu`` on the card) and the 2D focal loss, plain
PyTorch. Parameter names mirror the JAX tree (``heads.cls_tower.0.w`` <->
``heads/cls_tower/0/w``); ``models/bridge.py`` carries its weights across.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
from torch import nn

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.models.anchors import PYRAMID_LEVELS
from playground3d_tpu_torch.models.fpn import FPN
from playground3d_tpu_torch.models.nn import Conv
from playground3d_tpu_torch.models.resnet import ResNet, fpn_sizes
from playground3d_tpu_torch.models.retinanet import _anchors
from playground3d_tpu_torch.ops.nms import batched_nms
from playground3d_tpu_torch.ops.topk import top_k

# standard RetinaNet decode scaling (reference retinanet/utils.py BBoxTransform)
DECODE_MEAN = (0.0, 0.0, 0.0, 0.0)
DECODE_STD = (0.1, 0.1, 0.2, 0.2)
TOWER_DEPTH = 4


@functools.lru_cache(maxsize=None)
def _mean_std(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    # made once a device: no copy from the host on each call
    return (torch.tensor(DECODE_MEAN, dtype=torch.float32, device=device),
            torch.tensor(DECODE_STD, dtype=torch.float32, device=device))


class Heads2D(nn.Module):
    """Two 4-conv towers, a ``9 * num_classes`` classification conv and a
    ``9 * 4`` regression conv, focal-prior initialized."""

    def __init__(self, num_classes: int, feature_size: int = 256, generator=None):
        super().__init__()
        fs, g = feature_size, generator

        def tower():
            return nn.ModuleList(Conv(fs, fs, 3, bias=True, generator=g) for _ in range(TOWER_DEPTH))

        self.cls_tower = tower()
        self.reg_tower = tower()
        self.cls_out = Conv(fs, 9 * num_classes, 3, bias=True, generator=g)
        self.reg_out = Conv(fs, 9 * 4, 3, bias=True, generator=g)
        with torch.no_grad():
            self.cls_out.w.zero_()
            self.cls_out.b.fill_(-math.log((1.0 - 0.01) / 0.01))
            self.reg_out.w.zero_()
            self.reg_out.b.zero_()


class RetinaNet2D(nn.Module):
    def __init__(self, num_classes: int = 80, depth: int = 50, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes, self.depth, self.stem = num_classes, depth, "conv7"
        c3, c4, c5 = fpn_sizes(depth)
        self.backbone = ResNet(depth, "conv7", generator=generator)
        self.fpn = FPN(c3, c4, c5, generator=generator)
        self.heads = Heads2D(num_classes, generator=generator)


def retinanet2d_init(generator: Optional[torch.Generator] = None, num_classes: int = 80, depth: int = 50,
                     device: DeviceLike = None) -> RetinaNet2D:
    """A randomly initialized 2D detector on ``device`` (the card unless
    the caller asks for the CPU); weights drawn on the CPU from
    ``generator``."""
    dev = resolve_device(device)
    return RetinaNet2D(num_classes, depth, generator).to(dev).eval().requires_grad_(False)


def decode_boxes_2d(regression: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Standard (dx,dy,dw,dh) -> xyxy decode (retinanet/utils.py:102-149)."""
    mean, std = _mean_std(regression.device)
    w = anchors[:, 2] - anchors[:, 0]
    h = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + 0.5 * w
    cy = anchors[:, 1] + 0.5 * h
    reg = regression * std + mean
    pcx = cx + reg[..., 0] * w
    pcy = cy + reg[..., 1] * h
    pw = torch.exp(reg[..., 2]) * w
    ph = torch.exp(reg[..., 3]) * h
    return torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2, pcy + ph / 2], dim=-1)


def forward_raw_2d(model: RetinaNet2D, images: torch.Tensor, dtype=torch.bfloat16):
    """NHWC images -> (sigmoid class scores [N, A, K], regression [N, A, 4]),
    both float32, flattened per level in (y, x, anchor) order."""
    c3, c4, c5 = model.backbone(images, dtype)
    feats = model.fpn(c3, c4, c5, dtype)
    h, k = model.heads, model.num_classes
    cls_all, reg_all = [], []
    for f in feats:
        n, _, hh, ww = f.shape
        ct, rt = f, f
        for conv in h.cls_tower:
            ct = torch.relu(conv(ct, dtype=dtype))
        for conv in h.reg_tower:
            rt = torch.relu(conv(rt, dtype=dtype))
        # NCHW -> NHWC before any reshape: the flatten order is (y, x, anchor)
        cls_all.append(h.cls_out(ct, dtype=dtype).permute(0, 2, 3, 1).reshape(n, hh * ww * 9, k))
        reg_all.append(h.reg_out(rt, dtype=dtype).permute(0, 2, 3, 1).reshape(n, hh * ww * 9, 4))
    cls = torch.sigmoid(torch.cat(cls_all, 1).to(torch.float32))
    reg = torch.cat(reg_all, 1).to(torch.float32)
    return cls, reg


@torch.no_grad()
def detect_2d(
    model: RetinaNet2D,
    image: torch.Tensor,
    score_threshold: float = 0.05,
    nms_iou: float = 0.5,
    pre_topk: int = 1000,
    max_dets: int = 100,
):
    """Single-image 2D detection with per-class NMS; fixed-capacity masked
    output (scores, classes, boxes_xyxy, mask). The top ``pre_topk`` of the
    A·K scores (lower index first on ties) enter the NMS."""
    anchors = _anchors(tuple(image.shape[0:2]), PYRAMID_LEVELS, image.device)
    cls, reg = forward_raw_2d(model, image[None])
    boxes = decode_boxes_2d(reg[0], anchors)
    n_cls = model.num_classes
    k = min(pre_topk, anchors.shape[0] * n_cls)
    top_scores, top_idx = top_k(cls[0].reshape(-1), k)
    anchor_idx = top_idx // n_cls
    class_idx = (top_idx % n_cls).to(torch.int32)
    top_boxes = boxes[anchor_idx]
    valid = top_scores > score_threshold
    keep_idx, keep_mask = batched_nms(top_boxes, top_scores, class_idx, valid, nms_iou, max_keep=max_dets)
    keep = keep_idx.long()
    return top_scores[keep], class_idx[keep], top_boxes[keep], keep_mask


def focal_loss_2d(
    classification: torch.Tensor,  # [B,A,K]
    regression: torch.Tensor,  # [B,A,4]
    annotations: torch.Tensor,  # [B,M,5] xyxy+class, -1 padded
    anchors: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard 2D focal + smooth-L1 on (dx,dy,dw,dh) targets (reference
    retinanet/losses.py:24-179), over the batch at once. Each anchor takes
    the first annotation of greatest IoU (an annotation replaces the one
    before only when its IoU is greater), as the JAX ``fori_loop`` does."""
    _, std = _mean_std(regression.device)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    area = (anchors[:, 2] - anchors[:, 0]) * (anchors[:, 3] - anchors[:, 1])
    b, a, k = classification.shape
    valid = annotations[:, :, 4] >= 0  # [B,M]
    cls = torch.clamp(classification, 1e-4, 1 - 1e-4)

    best = torch.full((b, a), -1.0, dtype=classification.dtype, device=classification.device)
    arg = torch.zeros((b, a), dtype=torch.long, device=classification.device)
    for m in range(annotations.shape[1]):
        box = annotations[:, m, :4]  # [B,4]
        iw = torch.clamp(torch.minimum(anchors[None, :, 2], box[:, 2:3]) - torch.maximum(anchors[None, :, 0], box[:, 0:1]), min=0)
        ih = torch.clamp(torch.minimum(anchors[None, :, 3], box[:, 3:4]) - torch.maximum(anchors[None, :, 1], box[:, 1:2]), min=0)
        inter = iw * ih
        ab = (box[:, 2:3] - box[:, 0:1]) * (box[:, 3:4] - box[:, 1:2])
        iou = torch.where(valid[:, m:m + 1], inter / torch.clamp(area[None] + ab - inter, min=1e-8), -1.0)
        better = iou > best
        best = torch.where(better, iou, best)
        arg = torch.where(better, m, arg)
    assigned = torch.gather(annotations, 1, arg[:, :, None].expand(b, a, 5))  # [B,A,5]
    has = valid.any(dim=1, keepdim=True)
    pos = (best >= 0.5) & has
    neg = (best < 0.4) | ~has
    num_pos = torch.clamp(pos.sum(dim=1).to(torch.float32), min=1.0)  # [B]

    one_hot = torch.nn.functional.one_hot(assigned[..., 4].to(torch.long).clamp(min=0), k).to(cls.dtype)
    one_hot = torch.where((assigned[..., 4:5] >= 0) & (assigned[..., 4:5] < k), one_hot, 0.0)
    targets = torch.where(pos[..., None], one_hot, 0.0)
    care = (pos | neg)[..., None]
    alpha_f = torch.where(targets == 1.0, 0.25, 0.75)
    focal_w = torch.where(targets == 1.0, 1 - cls, cls)
    bce = -(targets * torch.log(cls) + (1 - targets) * torch.log(1 - cls))
    cls_loss = torch.where(care, alpha_f * focal_w ** 2 * bce, 0.0).sum(dim=(1, 2)) / num_pos

    gw = torch.clamp(assigned[..., 2] - assigned[..., 0], min=1.0)
    gh = torch.clamp(assigned[..., 3] - assigned[..., 1], min=1.0)
    gcx = assigned[..., 0] + 0.5 * gw
    gcy = assigned[..., 1] + 0.5 * gh
    t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah, torch.log(gw / aw), torch.log(gh / ah)], dim=-1) / std
    diff = torch.abs(t - regression)
    sl1 = torch.where(diff <= 1 / 9, 0.5 * 9 * diff ** 2, diff - 0.5 / 9)
    reg_loss = torch.where(pos[..., None], sl1, 0.0).sum(dim=(1, 2)) / (num_pos * 4.0)
    return cls_loss.mean(), reg_loss.mean()
