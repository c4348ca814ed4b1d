"""int8 x int8 -> int32 NHWC convolution with the dequantize epilogue fused:
the plain PyTorch version, the wrapper of the hand-written CUDA kernel
(``csrc/qconv.cu``), and the one entry that chooses.

It is the unit that ``models/quant.py`` builds its int8 paths from (the JAX
package's ``_chain_qconv`` / ``_chain_qconv_b`` / ``quant_conv_bn`` /
``quant_conv`` bodies after the input is quantized):

    acc = conv(x int8 [N,H,W,Cin], wq int8 [Cout,k,k,Cin], stride, "SAME")   int32, exact
    out = float32(acc) * scale[c] + offset[c]         float32, two roundings
    out = relu(out)                                    if asked
    emit None  -> bfloat16(out)
    emit xs    -> int8(clip(round_half_even(out / xs), -127, 127))

``"SAME"`` padding is split as XLA splits it (``models/nn.py::same_pads``).
The accumulator is an integer: K reaches 3*3*512 = 4,608 and 4,608 * 127 *
127 = 7.4e7 is above 2^24, so a float32 sum would round. ``out / xs`` is a
true division by a scalar that lives on the device.

The plain version is exact on both devices: an int32 ``F.conv2d`` on the CPU
(torch has no integer convolution on the card) and a float64 convolution
there (every partial sum is an integer below 2^53). It is for the tests and
for holding the kernel against; on the card the paths of the package go
through :func:`qconv`, which launches the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from playground3d_tpu_torch.models.nn import same_pads
from playground3d_tpu_torch.ops.cuda_build import KernelLibrary

__all__ = ["LIB", "LaunchPlan", "check_args", "conv_int32_plain", "epilogue_plain", "launch_plan",
           "qconv", "qconv_cuda", "qconv_plain"]

# The kernel's layout constants (csrc/qconv.cu holds the same values).
THREADS = 256
TILE_M = 128  # output pixels per block
TILE_N_NARROW = 64  # output channels per block for layers of up to 64 filters
TILE_N_WIDE = 128  # for wider layers
TILE_K = 64  # int8 values of one kernel tap per step
STAGES = 3  # operand tiles in flight in shared memory
ROW_BYTES = 80  # a 64-byte operand row and its padding
MAX_SMEM_BYTES = 232448  # 227 KB: the most shared memory one block may ask for
MAX_BLOCKS_Y = 65535

ACC, BF16, INT8 = 0, 1, 2  # what the kernel stores


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qconv.argtypes = [ptr] * 6 + [i32] * 13 + [ptr]
    lib.qconv.restype = i32


LIB = KernelLibrary("qconv", _bind)


def out_extent(n: int, stride: int) -> int:
    return -(-n // stride)


def conv_int32_plain(x: torch.Tensor, wq: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """The exact accumulator: x int8 [N,H,W,Cin], wq int8 [Cout,k,k,Cin] ->
    int32 [N,Ho,Wo,Cout]."""
    k = wq.shape[1]
    ph = same_pads(x.shape[1], k, stride)
    pw = same_pads(x.shape[2], k, stride)
    kind = torch.int32 if x.device.type == "cpu" else torch.float64
    xi = F.pad(x.permute(0, 3, 1, 2).to(kind), (pw[0], pw[1], ph[0], ph[1]))
    acc = F.conv2d(xi, wq.permute(0, 3, 1, 2).to(kind), stride=stride)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def epilogue_plain(acc: torch.Tensor, scale: torch.Tensor, offset: Optional[torch.Tensor],
                   relu: bool, emit_xs: Optional[torch.Tensor]) -> torch.Tensor:
    """int32 [..,Cout] -> bfloat16, or int8 at the scale ``emit_xs``."""
    out = acc.to(torch.float32) * scale
    if offset is not None:
        out = out + offset
    if relu:
        out = torch.relu(out)
    if emit_xs is None:
        return out.to(torch.bfloat16)
    return torch.clamp(torch.round(out / emit_xs), -127.0, 127.0).to(torch.int8)


def qconv_plain(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None):
    """The plain version of :func:`qconv` (see the module docstring)."""
    return epilogue_plain(conv_int32_plain(x, wq, stride), scale, offset, relu, emit_xs)


class LaunchPlan(NamedTuple):
    ho: int
    wo: int
    pad_top: int
    pad_left: int
    grid_x: int  # tiles of TILE_M output pixels
    grid_y: int  # tiles of tile_n output channels
    tile_n: int  # TILE_N_WIDE where the layer has more than TILE_N_NARROW filters
    smem_bytes: int  # dynamic shared memory per block


def launch_plan(N: int, H: int, W: int, Cin: int, Cout: int, k: int, stride: int) -> LaunchPlan:
    """What the host decides for one call, from shapes alone. Raises
    ValueError for what the kernel does not take."""
    if k not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"qconv: kernel size must be 1 or 3 and stride 1 or 2, got k={k} stride={stride}")
    if Cin < 16 or Cin % 16:
        raise ValueError(f"qconv: input channels must be a positive multiple of 16, got {Cin}")
    if min(N, H, W, Cout) < 1:
        raise ValueError(f"qconv: empty problem N={N} H={H} W={W} Cout={Cout}")
    ho, wo = out_extent(H, stride), out_extent(W, stride)
    m = N * ho * wo
    if N * H * W * Cin >= 2**31 or m * Cout >= 2**31:
        raise ValueError("qconv: input or output exceed 2^31 elements")
    tile_n = TILE_N_WIDE if Cout > TILE_N_NARROW else TILE_N_NARROW
    grid_y = -(-Cout // tile_n)
    if grid_y > MAX_BLOCKS_Y:
        raise ValueError(f"qconv: {Cout} output channels exceed the grid")
    return LaunchPlan(ho, wo, same_pads(H, k, stride)[0], same_pads(W, k, stride)[0],
                      -(-m // TILE_M), grid_y, tile_n, STAGES * (TILE_M + tile_n) * ROW_BYTES)


def check_args(x, wq, scale, offset, stride, emit_xs) -> None:
    """Raise ValueError on anything the kernel does not take: x int8
    [N,H,W,Cin], wq int8 [Cout,k,k,Cin], scale (and offset) float32 [Cout],
    emit_xs a float32 scalar tensor, all contiguous and on one device."""
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"qconv: x must be int8 [N,H,W,Cin], got {x.dtype} {tuple(x.shape)}")
    if wq.dtype != torch.int8 or wq.ndim != 4 or wq.shape[1] != wq.shape[2] or wq.shape[3] != x.shape[3]:
        raise ValueError(
            f"qconv: wq must be int8 [Cout,k,k,{x.shape[3]}], got {wq.dtype} {tuple(wq.shape)}"
        )
    cout = wq.shape[0]
    for name, t in (("scale", scale), ("offset", offset)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (cout,)):
            raise ValueError(f"qconv: {name} must be float32 [{cout}], got {t.dtype} {tuple(t.shape)}")
    if emit_xs is not None and (emit_xs.dtype != torch.float32 or emit_xs.numel() != 1):
        raise ValueError(f"qconv: emit_xs must be one float32, got {emit_xs.dtype} {tuple(emit_xs.shape)}")
    for name, t in (("x", x), ("wq", wq), ("scale", scale), ("offset", offset), ("emit_xs", emit_xs)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"qconv: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"qconv: {name} is on {t.device}, x on {x.device}")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("qconv: x and wq must start on a 16-byte boundary")
    launch_plan(x.shape[0], x.shape[1], x.shape[2], x.shape[3], cout, wq.shape[1], stride)


def qconv_cuda(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None,
               store: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on the current stream -> [N,Ho,Wo,Cout] bfloat16, or
    int8 when ``emit_xs`` is given. ``store=ACC`` returns the raw int32
    accumulators instead (for holding them against the plain version).
    ``qconv_cuda.launches`` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"qconv: the CUDA kernel takes CUDA tensors, got {x.device}")
    check_args(x, wq, scale, offset, stride, emit_xs)
    N, H, W, Cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    plan = launch_plan(N, H, W, Cin, cout, k, stride)
    if store is None:
        store = BF16 if emit_xs is None else INT8
    kind = {ACC: torch.int32, BF16: torch.bfloat16, INT8: torch.int8}[store]
    out = torch.empty((N, plan.ho, plan.wo, cout), dtype=kind, device=x.device)
    lib = LIB.load()
    with torch.cuda.device(x.device):
        err = lib.qconv(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
            offset.data_ptr() if offset is not None else None,
            emit_xs.data_ptr() if emit_xs is not None else None, out.data_ptr(),
            N, H, W, Cin, cout, k, stride, plan.ho, plan.wo, plan.pad_top, plan.pad_left,
            int(bool(relu)), store, torch.cuda.current_stream().cuda_stream,
        )
    LIB.check(err)
    qconv_cuda.launches += 1
    return out


qconv_cuda.launches = 0


def qconv(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None) -> torch.Tensor:
    """The int8 convolution with its fused epilogue (see the module
    docstring): the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU."""
    if x.device.type == "cuda":
        return qconv_cuda(x.contiguous(), wq, scale, offset, stride, relu, emit_xs)
    if x.device.type == "cpu":
        return qconv_plain(x, wq, scale, offset, stride, relu, emit_xs)
    raise ValueError(f"qconv: no implementation for device {x.device}")
