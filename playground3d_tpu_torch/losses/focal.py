"""Detector losses: focal classification + corner smooth-L1 + vp-angle (port
of ``playground3d_tpu/losses/focal.py``).

Labels are [B, M, 21] per image: 16 corner pixel coords (x, y interleaved,
corner order matching the decode sign matrix), a 4-value 2D box and the
class id; padded rows have class -1. Semantics (reference
pytorch_retinanet_detector_directional/retinanet/losses.py):

* anchor assignment by IoU of anchor and 2D hull of the 16 corners, the
  first label of greatest IoU in label order: positive >= 0.5, negative
  < 0.4, in between ignored (losses.py:93-131);
* focal loss alpha 0.25, gamma 2, summed over anchors and classes and
  divided by max(positives, 1) (losses.py:133-152);
* regression: smooth-L1 (beta 1/9) between the +-composed predicted corners
  and anchor-normalized targets, top-corner coordinates x0.5, divided by
  20 max(positives, 1) (losses.py:310-349);
* vp: the mean of three (1 - cos) terms aligning the regressed length,
  width and height vectors with the label's axis vectors in pixels
  (losses.py:214-304).

:func:`detection_loss` runs the hand-written kernels of
``csrc/focal_loss.cu`` (forward and backward, through
:class:`~playground3d_tpu_torch.ops.focal_loss.FocalLoss`) for tensors on
the card, and :func:`detection_loss_plain`, the JAX function's ops in its
order, for tensors on the CPU. Both keep JAX's gradient where JAX's
primitives define it: the class clamp passes 0.5 at exactly either bound
(``jnp.clip`` splits a tie of maximum / minimum), a class of -1 is an
all-zero one-hot, and the vp norms keep 1e-12 inside the square roots.
"""

from __future__ import annotations

from typing import Tuple

import torch

from playground3d_tpu_torch.models.decode import _SIGNS
from playground3d_tpu_torch.ops.focal_loss import FocalLoss

__all__ = ["assign_plain", "detection_loss", "detection_loss_plain"]

ALPHA = 0.25
GAMMA = 2.0
TOP_WEIGHT = 0.5
SL1_BETA = 1.0 / 9.0
POS_IOU = 0.5
NEG_IOU = 0.4
CLS_CLAMP = 1e-4

# corner-column index groups of the flat 16-coord layout (x at even cols)
_X_FRONT = (0, 2, 8, 10)  # corners 0,1,4,5
_X_BACK = (4, 6, 12, 14)  # corners 2,3,6,7
_X_LEFTG = (0, 4, 8, 12)  # corners 0,2,4,6  (S[:,1] == -1 group)
_X_RIGHTG = (2, 6, 10, 14)  # corners 1,3,5,7  (S[:,1] == +1 group)
_X_BOT = (0, 2, 4, 6)  # corners 0..3
_X_TOP = (8, 10, 12, 14)  # corners 4..7


def _hull(ann16: torch.Tensor) -> torch.Tensor:
    """[...,16] corner coords -> [...,4] xyxy hull (losses.py:93-107)."""
    xs = ann16[..., 0::2]
    ys = ann16[..., 1::2]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)], dim=-1)


def assign_plain(anchors: torch.Tensor, annotations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming anchor assignment: anchors [A,4], annotations [B,M,21] ->
    (iou_max [B,A], argmax [B,A] int32), a loop over the M label rows that
    keeps the first strictly greater IoU (the JAX ``fori_loop``)."""
    valid = annotations[..., 20] >= 0  # [B,M]
    hulls = _hull(annotations[..., :16])  # [B,M,4]
    b, m = valid.shape
    a0, a1, a2, a3 = (anchors[:, i] for i in range(4))
    best = torch.full((b, anchors.shape[0]), -1.0, dtype=anchors.dtype, device=anchors.device)
    arg = torch.zeros(best.shape, dtype=torch.int32, device=anchors.device)
    for j in range(m):
        h0, h1, h2, h3 = (hulls[:, j, i, None] for i in range(4))  # [B,1]
        iw = torch.clamp_min(torch.minimum(a2, h2) - torch.maximum(a0, h0), 0.0)
        ih = torch.clamp_min(torch.minimum(a3, h3) - torch.maximum(a1, h1), 0.0)
        inter = iw * ih
        area_a = (a2 - a0) * (a3 - a1)
        area_b = (h2 - h0) * (h3 - h1)
        iou = inter / torch.clamp_min(area_a + area_b - inter, 1e-8)
        iou = torch.where(valid[:, j, None], iou, torch.full_like(iou, -1.0))
        better = iou > best
        best = torch.where(better, iou, best)
        arg = torch.where(better, torch.full_like(arg, j), arg)
    return best, arg


def _compose_corners(reg: torch.Tensor) -> torch.Tensor:
    """[...,12] raw regression -> [...,16] anchor-normalized corner coords by
    the +- sign composition (losses.py:310-328)."""
    c, lv, wv, hv = reg[..., 0:2], reg[..., 2:4], reg[..., 4:6], reg[..., 6:8]
    S = torch.tensor(_SIGNS, dtype=reg.dtype, device=reg.device)
    corners = (
        c[..., None, :]
        + S[:, 0, None] * lv[..., None, :]
        + S[:, 1, None] * wv[..., None, :]
        + S[:, 2, None] * hv[..., None, :]
    )
    return corners.reshape(corners.shape[:-2] + (16,))


def _axis_vec(t16: torch.Tensor, plus, minus) -> Tuple[torch.Tensor, torch.Tensor]:
    px = sum(t16[..., i] for i in plus) - sum(t16[..., i] for i in minus)
    py = sum(t16[..., i + 1] for i in plus) - sum(t16[..., i + 1] for i in minus)
    return px / 4.0, py / 4.0


def detection_loss_plain(
    classification: torch.Tensor,  # [B,A,K] sigmoided scores
    regression: torch.Tensor,  # [B,A,12]
    annotations: torch.Tensor,  # [B,M,21], class -1 padding
    anchors: torch.Tensor,  # [A,4]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version: (cls, reg, vp), each the mean over images of the
    per-image loss; differentiable by autograd. Any device."""
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    ann = annotations
    valid = ann[..., 20] >= 0  # [B,M]

    # jnp.clip's tie gradient: torch.maximum / minimum split it too
    cls = torch.minimum(torch.maximum(classification, classification.new_tensor(CLS_CLAMP)),
                        classification.new_tensor(1.0 - CLS_CLAMP))
    iou_max, iou_arg = assign_plain(anchors, ann)
    assigned = torch.gather(ann, 1, iou_arg.long()[..., None].expand(-1, -1, ann.shape[-1]))  # [B,A,21]

    has_objects = valid.any(dim=1)[:, None]
    positive = (iou_max >= POS_IOU) & has_objects
    negative = (iou_max < NEG_IOU) | ~has_objects
    num_pos = torch.clamp_min(positive.to(torch.float32).sum(dim=1), 1.0)  # [B]

    # focal classification; a class of -1 (or >= K) is an all-zero one-hot
    k = cls.shape[-1]
    cls_id = assigned[..., 20].to(torch.int32)
    one_hot = (cls_id[..., None] == torch.arange(k, device=cls.device)).to(cls.dtype)
    targets = torch.where(positive[..., None], one_hot, torch.zeros_like(one_hot))
    care = (positive | negative)[..., None]
    alpha_f = torch.where(targets == 1.0, ALPHA, 1.0 - ALPHA)
    focal_w = torch.where(targets == 1.0, 1.0 - cls, cls)
    bce = -(targets * torch.log(cls) + (1.0 - targets) * torch.log(1.0 - cls))
    cls_loss = torch.where(care, alpha_f * focal_w**GAMMA * bce, torch.zeros_like(cls))
    cls_total = cls_loss.sum(dim=(1, 2)) / num_pos

    reg = regression
    t16 = assigned[..., :16]
    t2d = assigned[..., 16:20]

    def cos_term(reg_vec, plus, minus):
        tx, ty = _axis_vec(t16, plus, minus)
        # eps inside the sqrt: the gradient of sqrt(x^2+y^2) at 0 is NaN, and
        # it would leak through the positive mask's where into the total
        rn = torch.sqrt(reg_vec[..., 0] ** 2 + reg_vec[..., 1] ** 2 + 1e-12)
        tn = torch.sqrt(tx**2 + ty**2 + 1e-12)
        cos = (reg_vec[..., 0] * tx + reg_vec[..., 1] * ty) / (rn * tn)
        return 1.0 - cos

    vp = (
        cos_term(reg[..., 2:4], _X_BACK, _X_FRONT)
        + cos_term(reg[..., 4:6], _X_RIGHTG, _X_LEFTG)
        + cos_term(reg[..., 6:8], _X_BOT, _X_TOP)
    ) / 3.0
    vp_total = torch.where(positive, vp, torch.zeros_like(vp)).sum(dim=1) / num_pos

    preds20 = torch.cat([_compose_corners(reg), reg[..., 8:12]], dim=-1)
    t20 = torch.cat([t16, t2d], dim=-1)
    norm_x = (t20[..., 0::2] - acx[:, None]) / aw[:, None]
    norm_y = (t20[..., 1::2] - acy[:, None]) / ah[:, None]
    t20n = torch.stack([norm_x, norm_y], dim=-1).reshape(t20.shape)

    diff = torch.abs(t20n - preds20)
    weight = torch.ones(20, dtype=diff.dtype, device=diff.device)
    weight[8:16] = TOP_WEIGHT
    diff = diff * weight
    sl1 = torch.where(diff <= SL1_BETA, 0.5 / SL1_BETA * diff**2, diff - 0.5 * SL1_BETA)
    reg_total = torch.where(positive[..., None], sl1, torch.zeros_like(sl1)).sum(dim=(1, 2)) / (num_pos * 20.0)

    return cls_total.mean(), reg_total.mean(), vp_total.mean()


def detection_loss(
    classification: torch.Tensor,
    regression: torch.Tensor,
    annotations: torch.Tensor,
    anchors: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batch losses -> (cls, reg, vp) scalars, means over images
    (losses.py:362). The CUDA kernels for tensors on the card, the plain
    version for tensors on the CPU."""
    if classification.device.type == "cuda":
        return FocalLoss.apply(classification, regression, annotations, anchors)
    if classification.device.type == "cpu":
        return detection_loss_plain(classification, regression, annotations, anchors)
    raise ValueError(f"detection_loss: no implementation for device {classification.device}")
