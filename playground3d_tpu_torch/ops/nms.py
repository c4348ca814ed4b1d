"""Masked fixed-capacity non-maximum suppression (port of
``playground3d_tpu/ops/nms.py``).

Greedy score-ordered NMS as the fixed point of
``keep[i] <- not any_j (beats[j, i] and keep[j])`` from all-true, with
``beats[j, i] = (score_j > score_i, or equal and j < i) and IoU > thr``.
The JAX package runs it in a ``while_loop`` on the device. Here
:func:`nms` launches the hand-written kernels of ``csrc/nms.cu`` for tensors
on the card (up to :data:`SMEM_MAX_BOXES` boxes one launch of a thread-block
cluster, the beats table in shared memory; above it the beats bits by a grid,
then the loop and the compaction in one block; no host read either way; its
rounds go to :class:`~playground3d_tpu_torch.ops.topk.DeviceRounds`), and
runs :func:`nms_plain`, a host loop that reads one flag a round (counted in
:class:`~playground3d_tpu_torch.ops.topk.HostSyncs`), for tensors on the
CPU. The two agree bit for bit. :func:`batched_nms` hands its groups to the
kernel, which shifts the boxes as :func:`group_shift` does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from playground3d_tpu_torch.ops.cuda_build import KernelLibrary, count_launch
from playground3d_tpu_torch.ops.iou import pairwise_iou
from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs, top_k

__all__ = ["LIB", "batched_nms", "group_shift", "launch_plan", "nms", "nms_cuda", "nms_plain"]

NEG_INF = -1e30

# The kernels' layout constants (csrc/nms.cu holds the same values).
MAX_BOXES = 8192  # MAX_PER_THREAD boxes for each of the loop block's 1,024 threads
MAX_PER_THREAD = 8
SMEM_MAX_BOXES = 1260  # up to here one launch, the beats table in shared memory
MAX_CLUSTER = 8  # CTAs of the one-launch route's cluster (the portable size)
CLUSTER_BOXES = 64  # a cluster CTA for each 64 boxes, in powers of two
REG_WORDS = 16  # up to n 512 a round thread keeps its box's column of beats words in registers
MAX_SHARED_BYTES = 232448  # dynamic shared memory a Hopper block may opt into


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nms.argtypes = [ptr, ptr, ptr, ptr, i32, ctypes.c_float, i32, i32, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.nms.restype = i32


# -fmad=false is belt and braces: the source rounds every float op explicitly
LIB = KernelLibrary("nms", _bind, extra_flags=("-fmad=false",))


class LaunchPlan(NamedTuple):
    one_launch: bool  # n <= SMEM_MAX_BOXES: one cluster launch, else beats grid + loop block
    cluster: int  # CTAs of the one-launch cluster (0 on the two-launch route)
    threads: int  # of each block launched that runs the rounds (the cluster's CTAs, or the loop block)
    round_threads: int  # of those, the ones that run the rounds: a thread a box in whole warps, at most 1,024
    per_thread: int  # boxes each round thread owns
    words: int  # 32-bit words of beats bits per box
    shared_bytes: int  # dynamic shared memory of the block that runs the rounds
    workspace_words: int  # two-launch route: [n] shifted boxes (float4) + the [words, n] table


def launch_plan(n: int) -> LaunchPlan:
    """How the kernels are launched for ``n`` boxes (the C launcher applies
    the same rule and refuses a mismatch). Raises ValueError above
    :data:`MAX_BOXES`."""
    if not 0 <= n <= MAX_BOXES:
        raise ValueError(f"nms: the kernel takes 0 to {MAX_BOXES} boxes, got {n}")
    round_threads = min(1024, max(32, -(-n // 32) * 32))
    words = -(-n // 32)
    per_thread = max(1, -(-n // round_threads))
    if n <= SMEM_MAX_BOXES:
        cluster = 1
        while cluster < MAX_CLUSTER and cluster * CLUSTER_BOXES < n:
            cluster *= 2
        # boxes float4 [n], keep words [2][words4], mask words [words4], the table [words][n],
        # masked scores and areas [n], four words; words4: whole uint4s, REG_WORDS of them
        # while a round thread keeps its column in registers (n <= 32 * REG_WORDS)
        words4 = REG_WORDS if n <= 32 * REG_WORDS else -(-words // 4) * 4
        shared = 16 * n + 12 * words4 + 4 * words * n + 8 * n + 16
        return LaunchPlan(True, cluster, 1024, round_threads, per_thread, words, shared, 0)
    return LaunchPlan(False, 0, round_threads, round_threads, per_thread, words, 4 * words + 4, 4 * n + words * n)


def nms_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
):
    """The plain version: the JAX function's ops, its ``while_loop`` as a
    host loop reading one flag a round. Any device."""
    n = boxes.shape[0]
    if n_iter is None:
        n_iter = n
    dev = boxes.device

    s = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    iou = pairwise_iou(boxes, boxes)
    ar = torch.arange(n, device=dev)
    order_j = s[:, None] > s[None, :]
    tie = (s[:, None] == s[None, :]) & (ar[:, None] < ar[None, :])
    beats = (order_j | tie) & (iou > iou_threshold) & mask[:, None] & mask[None, :]

    keep, prev, i = mask, ~mask, 0
    while i < n_iter and HostSyncs.read(torch.any(keep != prev), "nms"):
        keep, prev = ~torch.any(beats & keep[:, None], dim=0) & mask, keep
        i += 1

    rank_scores = torch.where(keep, s, torch.full_like(s, NEG_INF))
    top_s, top_i = top_k(rank_scores, min(max_keep, n))
    keep_mask = top_s > NEG_INF / 2
    keep_idx = torch.where(keep_mask, top_i, torch.zeros_like(top_i)).to(torch.int32)
    if max_keep > n:
        pad = max_keep - n
        keep_idx = torch.cat([keep_idx, torch.zeros((pad,), dtype=torch.int32, device=dev)])
        keep_mask = torch.cat([keep_mask, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return keep_idx, keep_mask


def nms_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
    groups: Optional[torch.Tensor] = None,
):
    """Launch the kernels on the current stream -> (keep_idx [max_keep]
    int32, keep_mask [max_keep] bool). Takes boxes [n,4] float32 contiguous
    on a 16-byte boundary, scores [n] float32, mask [n] bool, all on one
    CUDA device, n <= :data:`MAX_BOXES`. With ``groups`` ([n] int32), the
    kernel first shifts the boxes as :func:`group_shift` does
    (``batched_nms``). ``nms_cuda.launches`` counts the launches; the rounds
    go to ``DeviceRounds``."""
    if boxes.device.type != "cuda":
        raise ValueError(f"nms: the CUDA kernel takes CUDA tensors, got {boxes.device}")
    n = boxes.shape[0]
    plan = launch_plan(n)
    if boxes.dtype != torch.float32 or boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(f"nms: boxes must be float32 [n,4], got {boxes.dtype} {tuple(boxes.shape)}")
    if scores.dtype != torch.float32 or tuple(scores.shape) != (n,):
        raise ValueError(f"nms: scores must be float32 [{n}], got {scores.dtype} {tuple(scores.shape)}")
    if mask.dtype != torch.bool or tuple(mask.shape) != (n,):
        raise ValueError(f"nms: mask must be bool [{n}], got {mask.dtype} {tuple(mask.shape)}")
    if groups is not None and (groups.dtype != torch.int32 or tuple(groups.shape) != (n,)):
        raise ValueError(f"nms: groups must be int32 [{n}], got {groups.dtype} {tuple(groups.shape)}")
    named = (("boxes", boxes), ("scores", scores), ("mask", mask)) + ((("groups", groups),) if groups is not None else ())
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"nms: {name} must be contiguous")
        if t.device != boxes.device:
            raise ValueError(f"nms: {name} is on {t.device}, boxes on {boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms: boxes must start on a 16-byte boundary (read as float4)")
    if n_iter is None:
        n_iter = n
    if max_keep < 0 or n_iter < 0:
        raise ValueError(f"nms: max_keep and n_iter must be >= 0, got {max_keep}, {n_iter}")
    dev = boxes.device
    keep_idx = torch.empty((max_keep,), dtype=torch.int32, device=dev)
    keep_mask = torch.empty((max_keep,), dtype=torch.bool, device=dev)
    workspace = torch.empty((plan.workspace_words,), dtype=torch.int32, device=dev) if plan.workspace_words else None
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.nms(
            boxes.data_ptr(), scores.data_ptr(), mask.data_ptr(), None if groups is None else groups.data_ptr(),
            n, iou_threshold, n_iter, max_keep, keep_idx.data_ptr(), keep_mask.data_ptr(),
            DeviceRounds.pointer(dev, "nms"), None if workspace is None else workspace.data_ptr(), plan.cluster,
            plan.threads, plan.shared_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    LIB.check(err)
    count_launch(nms_cuda, (boxes, scores, mask, iou_threshold, max_keep, n_iter, groups))
    return keep_idx, keep_mask


nms_cuda.launches = 0


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
):
    """boxes [N,4] xyxy; scores [N]; mask [N] -> (keep_idx [max_keep]
    int32, keep_mask [max_keep] bool), kept indices in decreasing-score
    order (lower index first on ties), 0-padded where keep_mask is False.
    The CUDA kernel for tensors on the card, the plain version for tensors
    on the CPU."""
    if boxes.device.type == "cuda":
        return _nms_on_card(boxes, scores, mask, iou_threshold, max_keep, n_iter, None)
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, mask, iou_threshold, max_keep, n_iter)
    raise ValueError(f"nms: no implementation for device {boxes.device}")


def _nms_on_card(boxes, scores, mask, iou_threshold, max_keep, n_iter, groups):
    b = boxes.contiguous()
    if b.data_ptr() % 16:
        b = b.clone()
    if groups is not None:
        groups = groups.to(torch.int32).contiguous()
    return nms_cuda(b, scores.contiguous(), mask.contiguous(), iou_threshold, max_keep, n_iter, groups)


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    groups: torch.Tensor,
    mask: torch.Tensor,
    iou_threshold: float,
    max_keep: int = 100,
    n_iter: Optional[int] = None,
):
    """Per-group NMS by coordinate offsets: boxes are shifted to a
    non-negative origin and offset by group * span, so groups never overlap
    even with negative coordinates (reference model.py:49-56). On the card
    the kernel does the shift (one launch with the suppression); on the CPU
    :func:`group_shift`'s tensor ops, then :func:`nms_plain`."""
    if boxes.device.type == "cuda":
        return _nms_on_card(boxes, scores, mask, iou_threshold, max_keep, n_iter, groups)
    return nms(group_shift(boxes, groups, mask), scores, mask, iou_threshold, max_keep=max_keep, n_iter=n_iter)


def group_shift(boxes: torch.Tensor, groups: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``batched_nms``'s boxes: shifted to a non-negative origin, then
    offset by group * (coordinate span + 1)."""
    zero = torch.zeros_like(boxes)
    valid = torch.where(mask[:, None], boxes, zero)
    max_c = torch.max(valid)
    min_c = torch.min(valid)
    span = max_c - min_c + 1.0
    offset = groups.to(boxes.dtype) * span
    return (boxes - min_c) + offset[:, None]
