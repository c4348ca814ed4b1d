# A frozen copy of the port's ops/yuv420.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Planar YUV420 bytes -> uint8 s2d-packed RGB on the device (port of
``playground3d_tpu/pipeline/multi_cam.py::yuv420_flat_to_s2d``): the plain
PyTorch version, the wrapper of the hand-written CUDA kernel
(``csrc/yuv420_s2d.cu``), and the one entry that chooses.

Hosts ship 1.5 bytes a pixel instead of 3, and colour conversion and packing
run where the frames are used. BT.601 limited range; every float32 operation
is rounded on its own, then ``clip(rgb + 0.5, 0, 255)`` and a truncating
cast. The kernel does the same operations in the same order, so the two
versions agree byte for byte; against the JAX function the contract is +-1
LSB (its compiler may contract a multiply into the add that follows).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def check_args(buf: torch.Tensor, hw: Tuple[int, int]) -> None:
    """Raise ValueError on anything the conversion does not take: ``buf``
    [T,C,H*W*3/2] uint8, H and W multiples of 4."""
    h, w = int(hw[0]), int(hw[1])
    if h < 4 or w < 4 or h % 4 or w % 4:
        raise ValueError(f"yuv420_flat_to_s2d: H and W must be positive multiples of 4, got {(h, w)}")
    if buf.dtype != torch.uint8 or buf.ndim != 3 or buf.shape[2] != h * w * 3 // 2:
        raise ValueError(
            f"yuv420_flat_to_s2d: buf must be uint8 [T,C,{h * w * 3 // 2}] for {h}x{w} frames, got "
            f"{buf.dtype} {tuple(buf.shape)}"
        )


def yuv420_flat_to_s2d_plain(buf: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[T,C,H*W*3//2] uint8 planar YUV420 -> [T,C,H/4,W/4,48] uint8 s2d RGB,
    with tensor ops (the expression of the JAX function, term by term)."""
    check_args(buf, hw)
    h, w = int(hw[0]), int(hw[1])
    t, c, L = buf.shape
    n = t * c
    flat = buf.reshape(n, L)
    ysz, csz = h * w, (h * w) // 4
    Y = flat[:, :ysz].reshape(n, h, w).to(torch.float32)
    U = flat[:, ysz: ysz + csz].reshape(n, h // 2, w // 2).to(torch.float32)
    V = flat[:, ysz + csz:].reshape(n, h // 2, w // 2).to(torch.float32)
    ky = float(np.float32(255.0 / 219.0))
    kc = float(np.float32(255.0 / 224.0))

    def up(p):
        return p.repeat_interleave(2, 1).repeat_interleave(2, 2)

    y = (Y - 16.0) * ky
    u = up((U - 128.0) * kc)
    v = up((V - 128.0) * kc)
    k = [float(np.float32(x)) for x in (1.402, 0.344136, 0.714136, 1.772)]
    rgb = torch.stack([y + k[0] * v, y - k[1] * u - k[2] * v, y + k[3] * u], -1)
    rgb = torch.clamp(rgb + 0.5, 0.0, 255.0).to(torch.uint8)
    x = rgb.reshape(n, h // 4, 4, w // 4, 4, 3).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(t, c, h // 4, w // 4, 48)


def yuv420_flat_to_s2d(buf: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """[T,C,H*W*3//2] uint8 planar YUV420 -> [T,C,H/4,W/4,48] uint8 s2d RGB:
    the CUDA kernel for a tensor on the card, the plain version on the CPU."""
    return yuv420_flat_to_s2d_plain(buf, hw)
