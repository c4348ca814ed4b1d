"""The hand-written CUDA crop-and-resize kernel: build, bind, launch.

Port of the TPU kernel ``playground3d_tpu/ops/pallas/crop_resize.py::
crop_and_resize_pallas``. The source is ``csrc/crop_resize.cu`` (its header
says what bounds it and how it is laid out). It is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface at first use
and bound with ``ctypes``, by the loader all the port's kernels share
(:mod:`playground3d_tpu_torch.ops.cuda_build`).

What the host decides is in one pure function that needs no card,
:func:`launch_plan` (tile of output rows, grid, shared-memory bytes, from
shapes alone). The kernel is given the tile height and derives the grid
and the bytes from it by the same rule.

The plain PyTorch version of the same function and the dispatch between
the two live in :mod:`playground3d_tpu_torch.ops.roi_align`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from playground3d_tpu_torch.ops.cuda_build import KernelLibrary, count_launch

__all__ = ["LIB", "LaunchPlan", "check_args", "crop_and_resize_cuda", "launch_noop", "launch_plan"]


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("crop_and_resize_f32", "crop_and_resize_u8"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, ptr, ptr] + [i32] * 7 + [ptr]
        fn.restype = i32
    lib.crop_and_resize_noop.argtypes = [ptr]
    lib.crop_and_resize_noop.restype = i32


# -fmad=false is belt and braces: the source already rounds every float op
# explicitly, so no multiply-add can move the result off the plain version
LIB = KernelLibrary("crop_resize", _bind, extra_flags=("-fmad=false",))
SOURCE = LIB.source

# The kernel's layout constants (csrc/crop_resize.cu holds the same values).
THREADS = 256
MAX_TILE_ROWS = 16  # two source rows per output row, one lane of warp 0 each
MAX_SMEM_BYTES = 232448  # 227 KB: the most shared memory one block may ask for
HEADER_BYTES = 320  # the row table
COLUMN_BYTES = 20  # per output column: 1 - wx as double, x0, x1, wx
MAX_BLOCKS = 2**31 - 1  # gridDim.x: one block per (crop, tile of rows)
TILE_ROWS = 8  # the best at 32 crops, within its noise, on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md)


class LaunchPlan(NamedTuple):
    tile_rows: int  # output rows per block
    tiles: int  # blocks per crop
    threads: int
    smem_bytes: int  # dynamic shared memory per block: the row and column tables


def launch_plan(out_size: int, n: int = 1) -> LaunchPlan:
    """How the kernel is launched for ``n`` crops of ``out_size``: from
    these alone, never from the data. A block computes a tile of
    ``TILE_ROWS`` output rows of one crop (the last tile of a crop may be
    shorter). Shared memory holds the tile's row table and the crop's
    column table. Raises ValueError, naming the reason, for what the kernel
    cannot take."""
    if min(out_size, n) < 1:
        raise ValueError(f"crop_resize: empty problem, out_size={out_size} n={n}")
    smem = HEADER_BYTES + COLUMN_BYTES * out_size
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"crop_resize: out_size {out_size} needs {smem} bytes of shared memory for its "
            f"column table, above the {MAX_SMEM_BYTES} a block may use"
        )
    tile = min(TILE_ROWS, out_size)
    tiles = -(-out_size // tile)
    if n * tiles > MAX_BLOCKS:
        raise ValueError(f"crop_resize: {n} crops in {tiles} tiles each exceed {MAX_BLOCKS} blocks")
    return LaunchPlan(tile, tiles, THREADS, smem)


def check_args(
    frames: torch.Tensor, boxes: torch.Tensor, frame_idx: torch.Tensor, out_size: int
) -> None:
    """Raise ValueError on anything the kernel does not take: frames
    [C,H,W,ch] float32 or uint8, boxes [n,4] float32, frame_idx [n] int32,
    all contiguous and on one device, sizes inside the kernel's int32
    indexing and grid limits, and whatever :func:`launch_plan` refuses (a
    column table above a block's shared memory). Pixels are read in place
    with loads of one element, so any storage offset and any row pitch are
    taken; a tensor whose first byte lies off an element boundary is not."""
    if frames.dtype not in (torch.float32, torch.uint8):
        raise ValueError(f"crop_resize: frames must be float32 or uint8, got {frames.dtype}")
    if frames.ndim != 4:
        raise ValueError(f"crop_resize: frames must be [C,H,W,ch], got shape {tuple(frames.shape)}")
    if boxes.dtype != torch.float32 or boxes.ndim != 2 or boxes.shape[1] != 4:
        raise ValueError(
            f"crop_resize: boxes must be float32 [n,4], got {boxes.dtype} {tuple(boxes.shape)}"
        )
    n = boxes.shape[0]
    if frame_idx.dtype != torch.int32 or tuple(frame_idx.shape) != (n,):
        raise ValueError(
            f"crop_resize: frame_idx must be int32 [{n}], got "
            f"{frame_idx.dtype} {tuple(frame_idx.shape)}"
        )
    for name, t in (("frames", frames), ("boxes", boxes), ("frame_idx", frame_idx)):
        if not t.is_contiguous():
            raise ValueError(f"crop_resize: {name} must be contiguous")
        if t.device != frames.device:
            raise ValueError(f"crop_resize: {name} is on {t.device}, frames on {frames.device}")
    if not isinstance(out_size, int) or out_size < 1:
        raise ValueError(f"crop_resize: out_size must be a positive int, got {out_size!r}")
    if min(frames.shape) < 1:
        raise ValueError(f"crop_resize: empty frames {tuple(frames.shape)}")
    if frames.numel() >= 2**31 or n * out_size * out_size * frames.shape[3] >= 2**31:
        raise ValueError("crop_resize: frames or output exceed 2^31 elements")
    if frames.data_ptr() % frames.element_size():
        raise ValueError(
            f"crop_resize: frames start at address {frames.data_ptr():#x}, off the "
            f"{frames.element_size()}-byte boundary of their elements"
        )
    if n:
        launch_plan(out_size, n)


def crop_and_resize_cuda(
    frames: torch.Tensor, boxes: torch.Tensor, frame_idx: torch.Tensor, out_size: int = 112,
) -> torch.Tensor:
    """Launch the kernel on the current stream -> [n,S,S,ch] float32.
    ``crop_and_resize_cuda.launches`` counts the launches."""
    if frames.device.type != "cuda":
        raise ValueError(f"crop_resize: the CUDA kernel takes CUDA tensors, got {frames.device}")
    check_args(frames, boxes, frame_idx, out_size)
    C, H, W, ch = frames.shape
    n = boxes.shape[0]
    out = torch.empty((n, out_size, out_size, ch), dtype=torch.float32, device=frames.device)
    if n == 0:
        return out
    plan = launch_plan(out_size, n)
    lib = LIB.load()
    fn = lib.crop_and_resize_u8 if frames.dtype == torch.uint8 else lib.crop_and_resize_f32
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            frames.data_ptr(), boxes.data_ptr(), frame_idx.data_ptr(), out.data_ptr(),
            C, H, W, ch, n, out_size, plan.tile_rows, stream,
        )
    LIB.check(err)
    count_launch(crop_and_resize_cuda)
    return out


crop_and_resize_cuda.launches = 0


def launch_noop() -> None:
    """Launch the library's empty kernel on the current stream: what one
    launch costs on the card's clock, for timing beside the kernels."""
    LIB.check(LIB.load().crop_and_resize_noop(torch.cuda.current_stream().cuda_stream))
