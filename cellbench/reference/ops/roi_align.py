# A frozen copy of the port's ops/roi_align.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Batched bilinear crop-and-resize: the plain PyTorch version and the one
entry the crop branch calls (port of ``playground3d_tpu/ops/roi_align.py``).

The output grid samples each box at bin centres with the half-pixel
convention and a border-replicating clamp: roi_align with sampling_ratio=1,
aligned=True. :func:`crop_and_resize` sends CUDA tensors to the hand-written
kernel (:mod:`cellbench.reference.ops.crop_resize`) and CPU tensors to
:func:`crop_and_resize_plain`; nothing else chooses between them.
"""

from __future__ import annotations

import numpy as np
import torch


def crop_and_resize_plain(
    frames: torch.Tensor,  # [C,H,W,ch] float32 or uint8
    boxes: torch.Tensor,  # [n,4] xyxy pixel coords, float32
    frame_idx: torch.Tensor,  # [n] int
    out_size: int = 112,
) -> torch.Tensor:
    """[n, out_size, out_size, ch] float32 crops, with tensor indexing.

    uint8 frames are gathered as uint8 and converted after the gather,
    which equals cropping ``frames.float()`` (the cast is exact)."""
    C, H, W = frames.shape[0], frames.shape[1], frames.shape[2]
    j = torch.arange(out_size, dtype=torch.float32, device=boxes.device)
    x0i, x1i, wx = _sample_axis(boxes[:, 0], boxes[:, 2], j, W)  # [n,S]
    y0i, y1i, wy = _sample_axis(boxes[:, 1], boxes[:, 3], j, H)
    fi = torch.clamp(frame_idx.long(), 0, C - 1)[:, None, None]

    def gather(yi, xi):  # [n,S] rows, [n,S] cols -> [n,S,S,ch] float32
        return frames[fi, yi[:, :, None], xi[:, None, :], :].to(torch.float32)

    wx = wx[:, None, :, None]  # [n,1,S,1]
    wy = wy[:, :, None, None]  # [n,S,1,1]
    top = _blend(gather(y0i, x0i), gather(y0i, x1i), wx)
    bot = _blend(gather(y1i, x0i), gather(y1i, x1i), wx)
    return _blend(top, bot, wy)


def _sample_axis(lo: torch.Tensor, hi: torch.Tensor, j: torch.Tensor, extent: int):
    """Bin-centre sample positions along one axis, half-pixel convention,
    clamped to the frame (so outside samples replicate the border) ->
    (floor index, next index, fractional weight), each [n,S].

    Rounded as XLA rounds the reference: ``/ S`` is a multiply by the
    float32 reciprocal and ``lo + (j + 0.5) * step`` one multiply-add (here
    in float64, where the product of two floats is exact). One ulp of a
    coordinate near x = 1900 is ~1e-4 px, enough to move a 0-255 output by
    0.03; the CUDA kernel does the same ops."""
    inv_s = float(np.float32(1.0) / np.float32(j.shape[0]))
    step = (hi - lo) * inv_s
    pos = lo.double()[:, None] + (j + 0.5).double()[None, :] * step.double()[:, None]
    pos = torch.clamp(pos.float() - 0.5, 0.0, extent - 1.0)
    p0 = torch.floor(pos)
    i0 = torch.clamp(p0.long(), 0, extent - 1)
    return i0, torch.clamp(i0 + 1, 0, extent - 1), pos - p0


def _blend(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a * (1 - w) + b * w with the sum rounded once, as XLA's multiply-add."""
    return (a.double() * (1 - w).double() + (b * w).double()).float()


def crop_and_resize(
    frames: torch.Tensor,
    boxes: torch.Tensor,
    frame_idx: torch.Tensor,
    out_size: int = 112,
) -> torch.Tensor:
    """[n, out_size, out_size, ch] float32 bilinear crops of float32 or
    uint8 NHWC frames: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    return crop_and_resize_plain(frames, boxes, frame_idx, out_size)
