# A frozen copy of the port's ops/crop_mxu.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Crop-and-resize over space-to-depth-packed frames (port of
``playground3d_tpu/ops/crop_mxu.py``): the plain PyTorch version, the
wrapper of the hand-written CUDA kernel, and the one entry that chooses.

Frames stay in the packed layout ``[C, H/4, W/4, 48]`` (channel = (by, bx,
colour)) that the s2d detector stem takes. A crop is bilinear sampling of
one level of a pyramid of 2x2 box-filtered frames, the level chosen per crop
so that the sampled span fits a fixed window of ``win_cells`` cells.

:func:`crop_and_resize_s2d_plain` follows the JAX function step by step:
pyramid, level choice, one window per crop, two interpolation products. It
is what runs on the CPU and what the kernel is held against on the card.
:func:`crop_and_resize_s2d_cuda` launches ``csrc/crop_resize_s2d.cu``, which
computes the same values tap by tap without the windows or the weight
matrices. :func:`crop_and_resize_s2d` sends CUDA tensors to the kernel and
CPU tensors to the plain version; nothing else chooses between them.

Numerics that the JAX function fixes and both versions copy (``dtype`` is
bfloat16 unless the caller says float32):

* every pyramid level is rounded to ``dtype`` (uint8 pixels are exact in
  bfloat16); a 2x2 mean is summed in float32 and rounded once;
* the level is ``clip(ceil(log2(span / cap)), 0, n_levels - 1)``, with
  ``span / cap`` the float32 product ``span * (1 / cap)`` that XLA makes of
  a division by a constant; here it is counted as the number of powers of
  two that this ratio exceeds, which is the same integer wherever ``log2``
  is exact at powers of two;
* odd cell counts drop their last cell when halved, and samples are clamped
  to the level's own valid pixels;
* the window starts at ``floor(first sample / 4)`` cells, clamped into the
  level, and a tap outside ``[0, 4 * win_cells)`` of it has weight zero;
* with ``normalize``, pixels are normalized in ``dtype`` before resampling
  (each of ``/ 255``, ``- mean``, ``/ std`` rounded), weights are built in
  float32 and rounded to ``dtype``, the row product is summed in float32 and
  rounded to ``dtype``, the column product is summed in float32.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from cellbench.reference.utils.constants import IMAGENET_MEAN, IMAGENET_STD


LAYOUTS = ("s2d", "hwc", "chw")
DTYPES = (torch.bfloat16, torch.float32)


def max_crop_span_s2d(win_cells: int = 64, n_levels: int = 3) -> float:
    """Largest box span (px) :func:`crop_and_resize_s2d` can represent at
    the given window and pyramid depth; callers clamp larger boxes before
    they build the crop-to-frame mapping (``make_crop_step`` does)."""
    return float((win_cells * 4 - 8) * 2 ** (n_levels - 1))


def _pixels(cells: torch.Tensor) -> torch.Tensor:
    """[n,hc,wc,48] cells -> [n,hc*4,wc*4,3] pixels (a copy)."""
    n, hc, wc, _ = cells.shape
    x = cells.reshape(n, hc, wc, 4, 4, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, hc * 4, wc * 4, 3)


def _unpack_chw(window: torch.Tensor) -> torch.Tensor:
    """s2d window [n,hc,wc,48] -> pixel tensor [n,3,hc*4,wc*4]."""
    return _pixels(window).permute(0, 3, 1, 2)


def s2d_halve(frames: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[C,Hs,Ws,48] s2d frames -> half-resolution s2d frames
    [C,Hs//2,Ws//2,48]: a 2x2 pixel box filter that stays packed. An odd
    last cell row or column is dropped. The four pixels, rounded to
    ``dtype`` first, are summed in float32 (top pair, then bottom pair)
    and the mean is rounded to ``dtype`` once."""
    C, Hs, Ws, ch = frames.shape
    if ch != 48:
        raise ValueError(f"s2d_halve: expects s2d-packed frames [C,H/4,W/4,48], got {tuple(frames.shape)}")
    ho, wo = Hs // 2, Ws // 2
    px = _pixels(frames[:, : 2 * ho, : 2 * wo].to(dtype)).to(torch.float32)
    s = (px[:, 0::2, 0::2] + px[:, 0::2, 1::2]) + (px[:, 1::2, 0::2] + px[:, 1::2, 1::2])
    half = (s * 0.25).to(dtype)  # [C, ho*4, wo*4, 3]
    x = half.reshape(C, ho, 4, wo, 4, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(C, ho, wo, 48)


def level_shapes(Hs: int, Ws: int, n_levels: int) -> List[Tuple[int, int]]:
    """(cells high, cells wide) of each pyramid level."""
    out = [(Hs, Ws)]
    for _ in range(n_levels - 1):
        out.append((out[-1][0] // 2, out[-1][1] // 2))
    return out


def _levels_of(boxes: torch.Tensor, win_cells: int, n_levels: int) -> torch.Tensor:
    """Pyramid level of each box, int64 [n]."""
    cap = float(win_cells * 4 - 8)
    inv_cap = float(np.float32(1.0) / np.float32(cap))
    span = torch.clamp(torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]), min=1.0)
    ratio = span * inv_cap
    level = torch.zeros_like(span, dtype=torch.int64)
    for k in range(n_levels - 1):
        level = level + (ratio > float(2 ** k)).to(torch.int64)
    return level


def _sample_positions(lo, hi, ls, S: int, extent_px: torch.Tensor) -> torch.Tensor:
    """Bin-centre sample positions in level pixels, [n,S] float32, clamped
    to the level's valid pixels. ``/ S`` is a multiply by the float32
    reciprocal and ``lo / ls + (j + 0.5) * step`` one multiply-add (float64,
    rounded once), as XLA rounds them."""
    inv_s = float(np.float32(1.0) / np.float32(S))
    j = torch.arange(S, dtype=torch.float32, device=lo.device)
    step = (hi - lo) * inv_s / ls
    pos = (lo / ls).double()[:, None] + (j + 0.5).double()[None, :] * step.double()[:, None]
    pos = pos.float() - 0.5
    return torch.minimum(torch.clamp(pos, min=0.0), extent_px[:, None] - 1.0)


def _normalize_constants(dtype, device):
    mean = torch.as_tensor(IMAGENET_MEAN, device=device).to(dtype)
    std = torch.as_tensor(IMAGENET_STD, device=device).to(dtype)
    return mean, std


def _check_common(frames_s2d, boxes, cam_idx, out_size, win_cells, n_levels, layout, dtype):
    if frames_s2d.ndim != 4 or frames_s2d.shape[3] != 48:
        raise ValueError(
            f"crop_and_resize_s2d: expects s2d-packed frames [C,H/4,W/4,48], got {tuple(frames_s2d.shape)}"
        )
    if layout not in LAYOUTS:
        raise ValueError(f"crop_and_resize_s2d: layout must be one of {LAYOUTS}, got {layout!r}")
    if dtype not in DTYPES:
        raise ValueError(f"crop_and_resize_s2d: dtype must be bfloat16 or float32, got {dtype}")
    if layout == "s2d" and out_size % 4:
        raise ValueError(f"crop_and_resize_s2d: layout 's2d' needs out_size % 4 == 0, got {out_size}")
    if out_size < 1 or win_cells < 3 or n_levels < 1:
        raise ValueError(
            f"crop_and_resize_s2d: needs out_size >= 1, win_cells >= 3, n_levels >= 1, got "
            f"{out_size}, {win_cells}, {n_levels}"
        )
    if min(level_shapes(frames_s2d.shape[1], frames_s2d.shape[2], n_levels)[-1]) < 1 or frames_s2d.shape[0] < 1:
        raise ValueError(
            f"crop_and_resize_s2d: frames {tuple(frames_s2d.shape)} are empty at pyramid level {n_levels - 1}"
        )
    if boxes.ndim != 2 or boxes.shape[1] != 4 or tuple(cam_idx.shape) != (boxes.shape[0],):
        raise ValueError(
            f"crop_and_resize_s2d: boxes must be [n,4] and cam_idx [n], got "
            f"{tuple(boxes.shape)} and {tuple(cam_idx.shape)}"
        )


def _to_layout(out: torch.Tensor, layout: str) -> torch.Tensor:
    """[n,3,S,S] -> the asked layout."""
    if layout == "chw":
        return out
    if layout == "hwc":
        return out.permute(0, 2, 3, 1)
    n, _, S, _ = out.shape
    x = out.reshape(n, 3, S // 4, 4, S // 4, 4).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(n, S // 4, S // 4, 48)


def crop_and_resize_s2d_plain(
    frames_s2d: torch.Tensor,  # [C,Hs,Ws,48] uint8 or float, s2d-packed
    boxes: torch.Tensor,  # [n,4] xyxy in level-0 pixels, float32
    cam_idx: torch.Tensor,  # [n] int
    out_size: int = 112,
    win_cells: int = 64,
    n_levels: int = 3,
    layout: str = "s2d",
    dtype=torch.bfloat16,
    normalize: bool = False,
) -> torch.Tensor:
    """Bilinear crops from s2d-packed frames, float32, in ``layout``: "s2d"
    [n,S/4,S/4,48], "hwc" [n,S,S,3] or "chw" [n,3,S,S]. The module docstring
    lists the roundings. ``cam_idx`` is clamped to the frames at hand."""
    _check_common(frames_s2d, boxes, cam_idx, out_size, win_cells, n_levels, layout, dtype)
    C, Hs, Ws, ch = frames_s2d.shape
    dev = frames_s2d.device
    S, win_px = out_size, win_cells * 4
    boxes = boxes.to(torch.float32)

    # pyramid, each level padded with zeros to a common cell width and to at
    # least the window's height, stacked along the rows
    levels = [frames_s2d.to(dtype)]
    for _ in range(n_levels - 1):
        levels.append(s2d_halve(levels[-1], dtype))
    shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
    wp = max(max(w for _, w in shapes), win_cells)
    parts, bases, hps = [], [], []
    base = 0
    for lv, (hl, wl) in zip(levels, shapes):
        hp = max(hl, win_cells)
        padded = torch.zeros((C, hp, wp, ch), dtype=dtype, device=dev)
        padded[:, :hl, :wl] = lv
        parts.append(padded.reshape(C * hp, wp, ch))
        bases.append(base)
        hps.append(hp)
        base += C * hp
    flat = torch.cat(parts, dim=0)  # [Rtot, wp, 48]

    def per_level(values, kind):
        return torch.as_tensor(values, dtype=kind, device=dev)[level]

    level = _levels_of(boxes, win_cells, n_levels)
    ls = torch.exp2(level.to(torch.float32))
    hl_cells = per_level([h for h, _ in shapes], torch.int64)
    wl_cells = per_level([w for _, w in shapes], torch.int64)
    xs = _sample_positions(boxes[:, 0], boxes[:, 2], ls, S, (wl_cells * 4).float())
    ys = _sample_positions(boxes[:, 1], boxes[:, 3], ls, S, (hl_cells * 4).float())

    def origin(smin, n_valid_cells):
        c0 = torch.floor(smin / 4.0).to(torch.int64)
        return torch.minimum(torch.clamp(c0, min=0), torch.clamp(n_valid_cells - win_cells, min=0))

    cy0 = origin(ys[:, 0], hl_cells)
    cx0 = origin(xs[:, 0], wl_cells)
    cam = torch.clamp(cam_idx.to(torch.int64), 0, C - 1)
    r0 = per_level(bases, torch.int64) + cam * per_level(hps, torch.int64) + cy0

    k = torch.arange(win_cells, device=dev)
    windows = flat[(r0[:, None] + k)[:, :, None], (cx0[:, None] + k)[:, None, :]]  # [n,win,win,48]
    pix = _unpack_chw(windows)  # [n,3,win_px,win_px]

    if normalize:
        mean, std = _normalize_constants(dtype, dev)
        pix = (pix / torch.tensor(255.0, dtype=dtype, device=dev) - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)

    # separable bilinear as two products; weights built in float32, two
    # non-zeros a row. The products run in float32 on values already rounded
    # to ``dtype``: for bfloat16 every product is exact and each sum of two
    # rounds once, whatever the order
    yr = ys - (cy0 * 4).to(torch.float32)[:, None]
    xr = xs - (cx0 * 4).to(torch.float32)[:, None]
    grid = torch.arange(win_px, dtype=torch.float32, device=dev)
    wy = torch.clamp(1.0 - torch.abs(yr[:, :, None] - grid), 0.0, 1.0).to(dtype).float()
    wx = torch.clamp(1.0 - torch.abs(xr[:, :, None] - grid), 0.0, 1.0).to(dtype).float()
    t1 = torch.einsum("nsy,ncyx->ncsx", wy, pix.float()).to(dtype)
    out = torch.einsum("ntx,ncsx->ncst", wx, t1.float())  # [n,3,S,S] float32
    return _to_layout(out, layout).contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernel (csrc/crop_resize_s2d.cu)
# ---------------------------------------------------------------------------

# The kernel's layout constants (csrc/crop_resize_s2d.cu holds the same values).


def crop_and_resize_s2d(
    frames_s2d: torch.Tensor, boxes: torch.Tensor, cam_idx: torch.Tensor, out_size: int = 112,
    win_cells: int = 64, n_levels: int = 3, layout: str = "s2d", dtype=torch.bfloat16,
    normalize: bool = False,
) -> torch.Tensor:
    """Bilinear crops from s2d-packed frames (see the module docstring): the
    CUDA kernel for tensors on the card, the plain version for tensors on
    the CPU. On the card ``cam_idx`` of another integer type is converted
    to int32 first."""
    return crop_and_resize_s2d_plain(
        frames_s2d, boxes, cam_idx, out_size, win_cells, n_levels, layout, dtype, normalize
    )
