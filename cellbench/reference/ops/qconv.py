# A frozen copy of the port's ops/qconv.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""int8 x int8 -> int32 NHWC convolution with the dequantize epilogue fused
(and, for the last conv of a ResNet block, the block's residual add, relu
and requantize): the plain PyTorch version, the wrapper of the hand-written
CUDA kernel (``csrc/qconv.cu``), and the one entry that chooses.

It is the unit that ``models/quant.py`` builds its int8 paths from (the JAX
package's ``_chain_qconv`` / ``_chain_qconv_b`` / ``quant_conv_bn`` /
``quant_conv`` bodies after the input is quantized, and the tail of its
``block``):

    acc = conv(x int8 [N,H,W,Cin], wq int8 [Cout,k,k,Cin], stride, "SAME")   int32, exact
    out = float32(acc) * scale[c] + offset[c]         float32, two roundings
    out = relu(out)                                    if asked
    with a residual res [N,Ho,Wo,Cout] (int8 at scale res_xs, or bfloat16):
        r   = bfloat16(res) * bfloat16(res_xs)         or res as it is
        out = relu(bfloat16(out) + r)                  bfloat16 add
    emit None  -> bfloat16(out)
    emit xs    -> int8(clip(round_half_even(out / xs), -127, 127))

``"SAME"`` padding is split as XLA splits it (``models/nn.py::same_pads``).
The accumulator is an integer: K reaches 3*3*2048 = 18,432 and 18,432 * 127 *
127 = 3.0e8 is above 2^24, so a float32 sum would round (it stays below
2^31). ``out / xs`` is a true division by a scalar that lives on the device.

The plain version is exact on both devices: an int32 ``F.conv2d`` on the CPU
(torch has no integer convolution on the card) and a float64 convolution
there (every partial sum is an integer below 2^53). Its residual tail is the
unfused tensor-op sequence of the block, and is the definition the kernel is
held to. It is for the tests and for holding the kernel against; on the
card the paths of the package go through :func:`qconv`, which launches the
kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from cellbench.reference import precision
from cellbench.reference.models.nn import same_pads


# The kernel's layout constants (csrc/qconv.cu holds the same values).
# the plan's cost model (measured by scripts/qconv_block_timeline.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W; PERF.md), by tile width:


def explicit_pads(H: int, W: int, k: int, stride: int, pads=None):
    """((top, bottom), (left, right)): ``pads`` as given, or the ``"SAME"``
    pads of H and W. A slab of a wider frame that already carries its halo
    is given the frame's (``parallel/spatial.py``)."""
    return pads if pads is not None else (same_pads(H, k, stride), same_pads(W, k, stride))


def conv_int32_plain(x: torch.Tensor, wq: torch.Tensor, stride: int = 1, pads=None) -> torch.Tensor:
    """The exact accumulator: x int8 [N,H,W,Cin], wq int8 [Cout,k,k,Cin] ->
    int32 [N,Ho,Wo,Cout]; ``pads`` see :func:`explicit_pads`."""
    k = wq.shape[1]
    ph, pw = explicit_pads(x.shape[1], x.shape[2], k, stride, pads)
    kind = torch.int32 if x.device.type == "cpu" else torch.float64
    xi = F.pad(x.permute(0, 3, 1, 2).to(kind), (pw[0], pw[1], ph[0], ph[1]))
    acc = F.conv2d(xi, wq.permute(0, 3, 1, 2).to(kind), stride=stride)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def epilogue_plain(acc: torch.Tensor, scale: torch.Tensor, offset: Optional[torch.Tensor],
                   relu: bool, emit_xs: Optional[torch.Tensor], res: Optional[torch.Tensor] = None,
                   res_xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [..,Cout] -> bfloat16, or int8 at the scale ``emit_xs``. With
    ``res`` (int8 at ``res_xs``, or bfloat16, the shape of ``acc``) the
    block's tail follows: ``relu(bfloat16(out) + dequantized res)``."""
    out = acc.to(torch.float32) * scale
    if offset is not None:
        out = out + offset
    if relu:
        out = torch.relu(out)
    if res is not None:
        r = res.to(torch.bfloat16) * res_xs.to(torch.bfloat16) if res.dtype == torch.int8 else res
        out = torch.relu(out.to(torch.bfloat16) + r)
    if emit_xs is None:
        return out.to(torch.bfloat16)
    return torch.clamp(torch.round(out.to(torch.float32) / emit_xs), -precision.QMAX, precision.QMAX).to(torch.int8)


def qconv_plain(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None,
                res=None, res_xs=None, pads=None):
    """The plain version of :func:`qconv` (see the module docstring)."""
    return epilogue_plain(conv_int32_plain(x, wq, stride, pads), scale, offset, relu, emit_xs, res, res_xs)


def qconv(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None,
          res=None, res_xs=None, pads=None) -> torch.Tensor:
    """The int8 convolution with its fused epilogue (see the module
    docstring): the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU. ``pads`` see :func:`explicit_pads`."""
    return qconv_plain(x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)
