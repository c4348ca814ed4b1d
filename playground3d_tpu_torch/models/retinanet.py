"""Directional RetinaNet: ResNet + FPN + heads, with decode and NMS (port
of ``playground3d_tpu/models/retinanet.py``; the int8 paths are in
``models/quant.py``).

``forward_raw`` is the training / raw forward, ``detect_multiframe`` the
batched multi-camera detector (reference MULTI_FRAME, model.py:311-344),
``detect_singleframe`` the one-image per-class detector (the reference's
default path, model.py:365-397), ``localize`` the crop detector (LOCALIZE,
model.py:362-363). Public inputs
are NHWC images, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.models import quant
from playground3d_tpu_torch.models.anchors import PYRAMID_LEVELS, anchors_for_shape
from playground3d_tpu_torch.models.decode import decode_regression
from playground3d_tpu_torch.models.fpn import FPN
from playground3d_tpu_torch.models.heads import Heads
from playground3d_tpu_torch.models.nn import apply_conv
from playground3d_tpu_torch.models.resnet import ResNet, fpn_sizes
from playground3d_tpu_torch.ops.nms import batched_nms
from playground3d_tpu_torch.ops.topk import top_k
from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

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


def retinanet_init(
    generator: Optional[torch.Generator] = None,
    num_classes: int = DEFAULT_NUM_CLASSES,
    depth: int = 50,
    stem: str = "conv7",
    tower_depth: int = 4,
    shared_tower: bool = False,
    feature_size: int = 256,
    device: DeviceLike = None,
) -> RetinaNet:
    """A randomly initialized detector (He-normal convs, identity frozen
    BN, focal-prior output convs) on ``device`` (the card unless the caller
    asks for the CPU). Weights are drawn on the CPU from ``generator``."""
    dev = resolve_device(device)
    model = RetinaNet(num_classes, depth, stem, tower_depth, shared_tower, feature_size,
                      generator=generator)
    return model.to(dev).eval().requires_grad_(False)


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


def _as_shards(model, images):
    """(models, image shards): one model and one tensor, or one replica a
    mesh device and the matching shards of the images (a sequence each)."""
    if isinstance(images, torch.Tensor):
        return [model], [images]
    if len(model) != len(images):
        raise ValueError(f"{len(model)} model replicas for {len(images)} image shards")
    return list(model), list(images)


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


def gather_candidates(parts, device: torch.device) -> Candidates:
    """The shards' candidates concatenated in mesh order on ``device``."""
    if len(parts) == 1:
        return Candidates(*(x.to(device) for x in parts[0]))
    return Candidates(*(torch.cat([x.to(device) for x in xs]) for xs in zip(*parts)))


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
def detect_multiframe(
    model,
    images,
    score_threshold: float = 1e-7,
    nms_iou: float = 0.5,
    pre_topk: int = 4096,
    max_dets: int = 256,
    approx_topk: bool = False,
    min_level: int = 3,
) -> Detections:
    """Batched multi-camera detection: per-anchor max class logit over all
    N frames, exact top-k (lower index first on ties), sigmoid and decode
    of the survivors, camera-grouped NMS on the 2D boxes (cols 16:20).

    Camera-sharded (JAX's ``detect_multiframe`` of an array sharded over a
    mesh): ``images`` is one tensor a mesh device, each of its cameras
    (:func:`~playground3d_tpu_torch.parallel.mesh.shard_batch`), and
    ``model`` one replica a device (:func:`~playground3d_tpu_torch.parallel.
    mesh.replicate`). Each device takes the top-k of its own cameras; the
    candidates alone move to the first device, which merges them and
    returns the detections there. One tensor is the one-shard case.

    ``approx_topk`` is accepted and runs the same exact top-k. The JAX
    function then calls ``jax.lax.approx_max_k``, which is approximate
    (recall 0.99) only on the TPU and returns ``lax.top_k``'s indices on
    other backends; the port has no TPU path, so both flags give JAX's
    off-TPU result."""
    models, shards = _as_shards(model, images)
    firsts = np.cumsum([0] + [x.shape[0] for x in shards]).tolist()
    parts = [image_candidates(m, x, pre_topk, min_level, first) for m, x, first in zip(models, shards, firsts)]
    lead = shards[0].device
    return merge_candidates(gather_candidates(parts, lead), frame_anchors(shards[0], models[0].stem, min_level),
                            firsts[-1], len(shards), score_threshold, nms_iou, pre_topk, max_dets)


@torch.no_grad()
def frames_candidates(
    model: RetinaNet,
    frames: torch.Tensor,
    pre_topk: int = 4096,
    min_level: int = 3,
    first_image: int = 0,
) -> Candidates:
    """:func:`image_candidates` of each of J frames [J,n,...] of one
    shard's n cameras, from one detector forward over all J*n images;
    -> Candidates stacked on a [J] axis (a top-k a frame)."""
    J, n = frames.shape[:2]
    images = frames.reshape((J * n,) + tuple(frames.shape[2:]))
    cls_max, cls_arg, reg = forward_raw(model, images, compact=True, min_level=min_level, score_path=True)
    per_frame = [_top_candidates(cls_max[j * n:(j + 1) * n], cls_arg[j * n:(j + 1) * n],
                                 reg[j * n:(j + 1) * n], pre_topk, first_image) for j in range(J)]
    return Candidates(*(torch.stack(xs) for xs in zip(*per_frame)))


@torch.no_grad()
def detect_frames(
    model,
    frames,
    score_threshold: float = 1e-7,
    nms_iou: float = 0.5,
    pre_topk: int = 4096,
    max_dets: int = 256,
    approx_topk: bool = False,
    min_level: int = 3,
) -> Detections:
    """:func:`detect_multiframe` of each of J frames of C cameras, frames
    [J,C,...] -> Detections stacked on a [J] axis (the JAX clip's ``vmap``
    of ``detect_multiframe`` over its detect frames). The detector runs
    once, over all J*C images (once a shard, over its J*C/n, when
    ``frames`` are camera shards [J,C/n,...] and ``model`` replicas, as
    for :func:`detect_multiframe`); the top-k pool and the NMS cap stay per
    frame: one top-k and one camera-grouped NMS a frame, never across
    frames."""
    models, shards = _as_shards(model, frames)
    firsts = np.cumsum([0] + [x.shape[1] for x in shards]).tolist()
    parts = [frames_candidates(m, x, pre_topk, min_level, first) for m, x, first in zip(models, shards, firsts)]
    lead = shards[0].device
    anchors = frame_anchors(shards[0][0], models[0].stem, min_level)
    per_frame = [
        merge_candidates(gather_candidates([Candidates(*(x[j] for x in p)) for p in parts], lead), anchors,
                         firsts[-1], len(shards), score_threshold, nms_iou, pre_topk, max_dets)
        for j in range(shards[0].shape[0])
    ]
    return Detections(*(torch.stack(xs) for xs in zip(*per_frame)))


@torch.no_grad()
def detect_singleframe(
    model: RetinaNet,
    image: torch.Tensor,
    score_threshold: float = 1e-25,
    nms_iou: float = 0.5,
    pre_topk: int = 4096,
    max_dets: int = 256,
) -> Detections:
    """One image [H,W,3] (or s2d-packed) -> per-class NMS detections: every
    (anchor, class) score competes; the top ``pre_topk`` pairs of the A·K
    flattened scores (lower index first on ties) are decoded and NMS runs
    grouped by class on the 2D boxes (cols 16:20). ``cam_idx`` is zeros."""
    anchors = _anchors(_image_shape_of(image[None], model.stem), PYRAMID_LEVELS, image.device)
    cls, reg = forward_raw(model, image[None])
    cls, reg = cls[0], reg[0]  # [A,K], [A,12]
    a, n_cls = anchors.shape[0], model.num_classes
    k = min(pre_topk, a * n_cls)
    top_scores, top_idx = top_k(cls.reshape(-1), k)
    anchor_idx = top_idx // n_cls
    class_idx = (top_idx % n_cls).to(torch.int32)
    top_boxes = decode_regression(reg[anchor_idx], anchors[anchor_idx])
    valid = top_scores > score_threshold

    keep_idx, keep_mask = batched_nms(
        top_boxes[:, 16:20], top_scores, class_idx, valid, nms_iou, max_keep=max_dets
    )
    keep = keep_idx.long()
    return Detections(
        scores=top_scores[keep],
        classes=class_idx[keep],
        boxes=top_boxes[keep],
        cam_idx=torch.zeros_like(keep_idx, dtype=torch.int32),
        mask=keep_mask,
    )


@torch.no_grad()
def localize(model: RetinaNet, crops: torch.Tensor, dtype=torch.bfloat16):
    """NHWC crops -> (decoded boxes [n, A, 20], class scores [n, A, K]);
    no NMS: the tracker's best-box selection reads the raw candidates."""
    anchors = _anchors(_image_shape_of(crops, model.stem), (3, 4, 5, 6, 7), crops.device)
    cls, reg = forward_raw(model, crops, dtype=dtype)
    return decode_regression(reg, anchors), cls
