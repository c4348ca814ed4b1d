"""Float activations -> int8 at a per-tensor scale that lives on the device:
the plain PyTorch version, the wrapper of the hand-written CUDA kernel
(``csrc/quantize.cu``), and the one entry that chooses.

    q = int8(clip(round_half_even(float32(x) / xs), -127, 127))

``x / xs`` is a true division by a float32 scalar tensor. It is the step
that quantizes each int8 conv's float input (``models/quant.py::
_quantize_act``; the JAX package writes the same expression inline,
``playground3d_tpu/models/quant.py:140``). The plain version is those five
tensor ops (a cast, the division, round, clamp, a cast); the kernel makes
them one pass over memory and gives the same bits.

:func:`quantize` runs the plain version off the card and the kernel for
every tensor on a card, where a view in neither of the layouts the kernel
reads (contiguous, or channels-last NCHW, as the nets give) or a dtype
other than bfloat16 or float32 raises. ``quantize_cuda.launches`` counts
the kernel's launches, credited at each replay of a graph that captured
them (``ops/cuda_build.py``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from playground3d_tpu_torch.ops.cuda_build import KernelLibrary, count_launch

__all__ = ["DTYPES", "LIB", "check_args", "edge_values", "is_dense", "quantize", "quantize_cuda", "quantize_plain"]

DTYPES = (torch.bfloat16, torch.float32)  # the input dtypes the kernel reads


def _bind(lib: ctypes.CDLL) -> None:
    ptr = ctypes.c_void_p
    lib.quantize_int8.argtypes = [ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr]
    lib.quantize_int8.restype = ctypes.c_int


LIB = KernelLibrary("quantize", _bind)


def is_dense(x: torch.Tensor) -> bool:
    """True where ``x`` lies in one of the layouts the kernel reads:
    contiguous, or an NCHW view of channels-last memory (what the nets
    give)."""
    return x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last)


def quantize_plain(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The plain version: five tensor ops, on any device and dtype."""
    return torch.clamp(torch.round(x.to(torch.float32) / xs), -127.0, 127.0).to(torch.int8)


def edge_values(xs: float) -> list:
    """Values at the edges of the rounding and the clip at scale ``xs``:
    ties (k + 0.5) xs, values at and past +-127 xs, +-0, +-inf, NaN, the
    largest bfloat16, bfloat16 and float32 subnormals, the smallest normal
    float32, a value just below a tie. The tests and ``chip_smoke.py`` hold
    the kernel and the plain version to each other on them."""
    ties = [(k + 0.5) * xs for k in (0, 1, 2, 3, 62, 125, 126, 127)]
    steps = [k * xs for k in (1.0, 126.0, 127.0, 128.0, 1e6)]
    return ([0.0, -0.0, math.inf, -math.inf, math.nan, 3.3895313892515355e38, -3.3895313892515355e38,
             9.183549615799121e-41, -9.183549615799121e-41, 1e-45, 1.1754943508222875e-38, 0.4999 * xs]
            + ties + [-t for t in ties] + steps + [-v for v in steps])


def check_args(x: torch.Tensor, xs: torch.Tensor) -> None:
    """Raise ValueError on anything the kernel does not take: ``x``
    bfloat16 or float32 in a layout :func:`is_dense` admits, ``xs`` a
    float32 scalar tensor on ``x``'s device, which is a card."""
    if x.dtype not in DTYPES:
        raise ValueError(f"quantize: x must be bfloat16 or float32, got {x.dtype}")
    if not is_dense(x):
        raise ValueError(f"quantize: x must be contiguous or channels-last, got shape {tuple(x.shape)} "
                         f"strides {x.stride()}")
    if xs.dtype != torch.float32 or xs.ndim != 0:
        raise ValueError(f"quantize: xs must be a float32 scalar tensor, got {xs.dtype} {tuple(xs.shape)}")
    if xs.device != x.device:
        raise ValueError(f"quantize: xs is on {xs.device}, x on {x.device}")
    if x.device.type != "cuda":
        raise ValueError(f"quantize: the CUDA kernel takes CUDA tensors, got {x.device}")


def quantize_cuda(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream -> int8 with ``x``'s shape
    and strides. ``quantize_cuda.launches`` counts the launches."""
    check_args(x, xs)
    out = torch.empty_strided(x.shape, x.stride(), dtype=torch.int8, device=x.device)
    if x.numel() == 0:
        return out
    lib = LIB.load()
    with torch.cuda.device(x.device):
        err = lib.quantize_int8(x.data_ptr(), out.data_ptr(), xs.data_ptr(), x.numel(),
                                int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    LIB.check(err)
    count_launch(quantize_cuda)
    return out


quantize_cuda.launches = 0


def quantize(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """float -> int8 at scale ``xs`` (see the module docstring): the kernel
    on a card, the plain version elsewhere."""
    return quantize_cuda(x, xs) if x.device.type == "cuda" else quantize_plain(x, xs)
