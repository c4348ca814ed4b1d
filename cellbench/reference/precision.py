"""The precision the reference computes in. The benchmark's control sets a
lower one (``QMAX = 7`` for int4 where the configuration states int8;
``FP8 = True`` for float8 e4m3 operands where it states bfloat16), to show
that the comparison that decides ``correct`` fails on it."""

from __future__ import annotations

import torch

QMAX = 127.0  # integer levels on each side of 0 of a quantized weight or activation
FP8 = False  # round each convolution's operands to float8 e4m3, scaled per tensor

_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 at a per-tensor scale that maps its largest
    magnitude to e4m3's largest, and back to its dtype."""
    scale = torch.clamp(torch.amax(torch.abs(x.to(torch.float32))), min=1e-30) / _E4M3_MAX
    return ((x.to(torch.float32) / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale).to(x.dtype)
