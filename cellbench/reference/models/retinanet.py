# A frozen copy of the port's models/retinanet.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Directional RetinaNet: ResNet + FPN + heads, with decode and NMS (port
of ``playground3d_tpu/models/retinanet.py``; the int8 paths are in
``models/quant.py``).

``forward_raw`` is the raw forward, ``image_candidates`` and
``merge_candidates`` the multi-camera detector of the clip's detect
branch, ``localize`` the crop detector (LOCALIZE, model.py:362-363).
Public inputs are NHWC images, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from cellbench.reference.models import quant
from cellbench.reference.models.anchors import anchors_for_shape
from cellbench.reference.models.decode import decode_regression
from cellbench.reference.models.fpn import FPN
from cellbench.reference.models.heads import Heads
from cellbench.reference.models.nn import apply_conv
from cellbench.reference.models.resnet import ResNet, fpn_sizes
from cellbench.reference.ops.nms import batched_nms
from cellbench.reference.ops.topk import top_k
from cellbench.reference.utils.constants import IMAGENET_MEAN, IMAGENET_STD

DEFAULT_NUM_CLASSES = 8


class Detections(NamedTuple):
    """Fixed-capacity masked detection set."""

    scores: torch.Tensor  # [K]
    classes: torch.Tensor  # [K] int32
    boxes: torch.Tensor  # [K,20] (16 corner coords + 2D box)
    cam_idx: torch.Tensor  # [K] int32 source image index
    mask: torch.Tensor  # [K] bool


class RetinaNet(nn.Module):
    """Parameter names mirror the JAX tree: ``backbone.layer1.0.conv1.w``
    <-> ``backbone/layer1/0/conv1/w``."""

    def __init__(self, num_classes: int = DEFAULT_NUM_CLASSES, depth: int = 50,
                 stem: str = "conv7", tower_depth: int = 4, shared_tower: bool = False,
                 feature_size: int = 256, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes, self.depth, self.stem = num_classes, depth, stem
        c3, c4, c5 = fpn_sizes(depth)
        self.backbone = ResNet(depth, stem, generator=generator)
        self.fpn = FPN(c3, c4, c5, feature_size=feature_size, generator=generator)
        self.heads = Heads(num_classes, feature_size=feature_size, tower_depth=tower_depth,
                           shared_tower=shared_tower, generator=generator)


@functools.lru_cache(maxsize=None)
def imagenet_mean_std(reps: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's channel mean and std tiled over ``reps`` pixels, made once
    a device: a CUDA graph cannot capture a copy from the host."""
    return (torch.as_tensor(np.tile(IMAGENET_MEAN, reps), device=device),
            torch.as_tensor(np.tile(IMAGENET_STD, reps), device=device))


def normalize_on_device(images: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> ImageNet-normalized float32; other dtypes pass
    through. The channel constants tile to s2d-packed channel counts."""
    if images.dtype != torch.uint8:
        return images
    mean, std = imagenet_mean_std(images.shape[-1] // 3, images.device)
    return (images.to(torch.float32) / 255.0 - mean) / std


def forward_raw(
    model: RetinaNet,
    images: torch.Tensor,
    dtype=torch.bfloat16,
    apply_sigmoid: bool = True,
    compact: bool = False,
    min_level: int = 3,
    score_path: bool = False,
    constrain=None,
):
    """NHWC images -> head outputs (see :meth:`Heads.forward`); uint8
    inputs are normalized first; heads run on pyramid levels >= min_level.
    A model that ``models/quant.py`` has quantized takes its int8 paths: the
    chained backbone, int8 FPN convs, and the chained heads when ``compact``.
    ``constrain`` is applied to each pyramid level before the heads
    (``parallel/mesh.py::spatial_constrainer``, which finds each level
    placed by JAX's rule already)."""
    images = normalize_on_device(images)
    if quant.is_quantized(model.backbone):
        c3, c4, c5 = quant.resnet_apply_int8_chained(model.backbone, images)
    else:
        c3, c4, c5 = model.backbone(images, dtype)
    # the FPN and the heads dispatch per conv on its ``wq`` buffer, so a
    # mixed model (int8 towers, bfloat16 output convs) runs each conv right
    heads_q = quant.is_quantized(model.heads)
    conv = quant.quant_conv if heads_q or quant.is_quantized(model.fpn) else apply_conv
    feats = model.fpn(c3, c4, c5, dtype, conv=conv)
    if min_level > 3:
        feats = feats[min_level - 3:]
    if constrain is not None:
        feats = [constrain(f) for f in feats]
    if compact and heads_q:
        return quant.head_apply_int8_chained(model.heads, feats, score_path=score_path)
    return model.heads(feats, dtype=dtype, apply_sigmoid=apply_sigmoid, compact=compact,
                       score_path=score_path, conv=conv)


def _image_shape_of(images: torch.Tensor, stem: str) -> Tuple[int, int]:
    """Pixel (H, W) for the anchors, accounting for s2d-packed inputs."""
    h, w = images.shape[1:3]
    if stem == "s2d" and images.shape[-1] == 48:
        return h * 4, w * 4
    return h, w


@functools.lru_cache(maxsize=16)
def _anchors(shape: Tuple[int, int], levels: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.as_tensor(anchors_for_shape(shape, levels), device=device)


class Candidates(NamedTuple):
    """The top-k anchors of some images, ahead of sigmoid, decode and NMS:
    what a camera shard hands to the lead device (only these cross cards,
    never the regression map)."""

    logits: torch.Tensor  # [k] float32 max class logit, descending, lower index first among ties
    index: torch.Tensor  # [k] int64 flat index over the frame's images: image * A + anchor
    classes: torch.Tensor  # [k] the argmax class of each
    reg: torch.Tensor  # [k,12] float32 raw regression rows


@torch.no_grad()
def image_candidates(
    model: RetinaNet,
    images: torch.Tensor,
    pre_topk: int = 4096,
    min_level: int = 3,
    first_image: int = 0,
) -> Candidates:
    """The detector over images [n,...] (one camera shard's, the frame's
    images ``first_image`` onwards) and their exact top-``pre_topk``
    anchors by max class logit, on the images' device; the indices count
    over the whole frame's images, so a merge of the shards in order keeps
    the lower index first among ties."""
    cls_max, cls_arg, reg = forward_raw(model, images, compact=True, min_level=min_level, score_path=True)
    return _top_candidates(cls_max, cls_arg, reg, pre_topk, first_image)


def _top_candidates(cls_max, cls_arg, reg, pre_topk: int, first_image: int) -> Candidates:
    n, a = cls_max.shape[0], cls_max.shape[1]
    logits = cls_max.reshape(-1).to(torch.float32)
    top_logits, top_idx = top_k(logits, min(pre_topk, n * a))
    index = top_idx + first_image * a if first_image else top_idx
    return Candidates(top_logits, index, cls_arg.reshape(n * a)[top_idx],
                      reg.reshape(n * a, -1)[top_idx].to(torch.float32))


def merge_candidates(
    cands: Candidates,
    anchors: torch.Tensor,
    n_images: int,
    shards: int,
    score_threshold: float = 1e-7,
    nms_iou: float = 0.5,
    pre_topk: int = 4096,
    max_dets: int = 256,
) -> Detections:
    """A frame's detections from its shards' candidates, concatenated in
    mesh order (:func:`gather_candidates`): the top-k over them, then
    sigmoid, decode and camera-grouped NMS capped at ``max_dets``. Every
    shard holds a contiguous block of cameras and sorts its own candidates
    lower index first among ties, so a stable top-k of the concatenation
    is the exact top-k over all images' anchors; one shard's candidates are
    that already."""
    a = anchors.shape[0]
    if shards > 1:
        logits, pos = top_k(cands.logits, min(pre_topk, n_images * a))
        cands = Candidates(logits, cands.index[pos], cands.classes[pos], cands.reg[pos])
    top_scores = torch.sigmoid(cands.logits)
    top_cam = (cands.index // a).to(torch.int32)
    top_boxes = decode_regression(cands.reg, anchors[cands.index % a])
    valid = top_scores > score_threshold

    keep_idx, keep_mask = batched_nms(
        top_boxes[:, 16:20], top_scores, top_cam, valid, nms_iou, max_keep=max_dets
    )
    keep = keep_idx.long()
    return Detections(
        scores=top_scores[keep],
        classes=cands.classes[keep],
        boxes=top_boxes[keep],
        cam_idx=top_cam[keep],
        mask=keep_mask,
    )


def frame_anchors(images: torch.Tensor, stem: str, min_level: int = 3) -> torch.Tensor:
    """The anchors of one image of ``images`` [n,...] (s2d-packed or raw)
    for pyramid levels ``min_level``-7, on the images' device."""
    return _anchors(_image_shape_of(images, stem), tuple(range(min_level, 8)), images.device)


@torch.no_grad()
def localize(model: RetinaNet, crops: torch.Tensor, dtype=torch.bfloat16):
    """NHWC crops -> (decoded boxes [n, A, 20], class scores [n, A, K]);
    no NMS: the tracker's best-box selection reads the raw candidates."""
    anchors = _anchors(_image_shape_of(crops, model.stem), (3, 4, 5, 6, 7), crops.device)
    cls, reg = forward_raw(model, crops, dtype=dtype)
    return decode_regression(reg, anchors), cls
