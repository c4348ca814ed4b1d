"""The yardstick: operations and bytes of the work a cell does, counted
from shapes and boxes, never from a kernel, and the H100's peaks.

* a net's operations: two per multiply-add of one forward at the cell's
  input size, by the precision each part runs in, counted by the net's
  architecture module (``archs/``), held against that precision's peak;
* an int8 convolution launch (``qconv``): its multiply-adds, and the bytes
  it must move: the int8 input and weights read once, the output written
  once (int8, or bfloat16 where it emits no int8), the scale and offset,
  and a residual where one is added;
* a crop frame: the pixels each live track's crop samples read, once, and
  its crop written once;
* the YUV420 conversion: the planar bytes read and the RGB bytes written.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
INT8_OPS_PER_S = 1.979e15  # dense int8 on the tensor cores
PEAK_OPS_PER_S = {"int8": INT8_OPS_PER_S, "bf16": 0.989e15}  # dense, the same sheet


def peaks(cfg: dict) -> Dict[str, float]:
    """Operations a second of each precision: the configuration's own
    ``peak_ops_per_s`` for its ``precision``, the table's for the others
    (a part of a net that runs in another precision, such as a bfloat16
    backbone before an int8 FPN and heads)."""
    return {**PEAK_OPS_PER_S, cfg["precision"]: cfg["peak_ops_per_s"]}


def qconv_launch(x_shape, w_shape, out_shape, int8_out: bool, res_bytes: int) -> Tuple[int, int, int]:
    """(multiply-adds, activation bytes, weight bytes) of one int8
    convolution launch: x [N,H,W,Cin] int8, w [Cout,k,k,Cin] int8, out
    [N,Ho,Wo,Cout]. Activation bytes: the input and residual read, the
    output written; weight bytes: the weights, scale and offset."""
    cout, k, cin = w_shape[0], w_shape[1], w_shape[3]
    out = math.prod(out_shape)
    macs = out * cin * k * k
    act = math.prod(x_shape) + out * (1 if int8_out else 2) + res_bytes
    return macs, act, math.prod(w_shape) + cout * 8


def qconv_bound_s(launches: Iterable[Tuple[int, int, int]], peak_ops: float = INT8_OPS_PER_S) -> float:
    """The least time the launches could take: for each, the larger of its
    operations over the peak and its bytes over the memory's rate, summed."""
    return sum(max(2 * macs / peak_ops, (act + w) / HBM_BYTES_PER_S) for macs, act, w in launches)


def tap_pixels(boxes: torch.Tensor, h: int, w: int, crop: int) -> int:
    """Distinct pixels of an [h, w] frame that a ``crop`` x ``crop``
    bilinear sampling of each box [n, (x0, y0, x1, y1)] reads: on each axis
    the two neighbours of each sample at the centre of its cell of the box,
    clipped to the frame; each box counted on its own."""
    b = boxes.detach().to("cpu", torch.float64)
    j = (torch.arange(crop, dtype=torch.float64) + 0.5) / crop

    def axis(lo, hi, extent):
        pos = torch.floor(lo[:, None] + j[None, :] * (hi - lo)[:, None] - 0.5)
        taps = torch.cat([pos, pos + 1], 1).clamp(0, extent - 1)
        return torch.tensor([t.unique().numel() for t in taps], dtype=torch.float64)

    return int((axis(b[:, 0], b[:, 2], w) * axis(b[:, 1], b[:, 3], h)).sum()) if b.shape[0] else 0


def crop_frame_bytes(boxes: torch.Tensor, live: torch.Tensor, h: int, w: int, crop: int, value_bytes: int) -> int:
    """Bytes one crop frame needs: the uint8 RGB pixels each live box's
    bilinear samples read, once, and each live box's ``crop`` x ``crop`` x 3
    crop written once at ``value_bytes`` a value."""
    live = live.detach().to("cpu")
    n = int(live.sum())
    return tap_pixels(boxes.detach().to("cpu")[live], h, w, crop) * 3 + n * crop * crop * 3 * value_bytes


def yuv420_bytes(frames: int, h: int, w: int) -> int:
    """Planar YUV420 read and uint8 RGB written for ``frames`` frames."""
    return frames * (h * w * 3 // 2 + h * w * 3)
