"""The hand-written CUDA crop-and-resize kernel: build, bind, launch.

Port of the TPU kernel ``playground3d_tpu/ops/pallas/crop_resize.py::
crop_and_resize_pallas``. The source is ``csrc/crop_resize.cu`` (its header
says what bounds it and how it is laid out). It is compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface at first use,
into ``playground3d_tpu_torch/_build/``, and bound with ``ctypes``. Nothing
here imports a GPU package or runs ``nvcc`` when the module is imported.

The plain PyTorch version of the same function and the dispatch between
the two live in :mod:`playground3d_tpu_torch.ops.roi_align`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

__all__ = ["build", "check_args", "crop_and_resize_cuda"]

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "crop_resize.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false is belt and braces: the source already rounds every float op
# explicitly, so no multiply-add can move the result off the plain version
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "--ptxas-options=-v", "-shared", "-Xcompiler", "-fPIC",
)
MAX_CROPS = 65535  # gridDim.y

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""  # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("crop_resize: nvcc not found (need the CUDA toolkit to build the kernel)")
    return path


def build() -> Path:
    """Compile the kernel library if this source and these flags have not
    been built yet; returns its path. Safe to call from several threads."""
    global build_log
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libcrop_resize-{digest}.so"
    with _lock:
        if lib_path.exists():
            return lib_path
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"crop_resize: nvcc failed ({proc.returncode}):\n{build_log}")
        os.replace(tmp, lib_path)
        return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("crop_and_resize_f32", "crop_and_resize_u8"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.crop_and_resize_error_string.argtypes = [i32]
        lib.crop_and_resize_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check_args(
    frames: torch.Tensor, boxes: torch.Tensor, frame_idx: torch.Tensor, out_size: int
) -> None:
    """Raise ValueError on anything the kernel does not take: frames
    [C,H,W,ch] float32 or uint8, boxes [n,4] float32, frame_idx [n] int32,
    all contiguous and on one device, sizes inside the kernel's int32
    indexing and grid limits."""
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
    if n > MAX_CROPS:
        raise ValueError(f"crop_resize: at most {MAX_CROPS} crops per launch, got {n}")


def crop_and_resize_cuda(
    frames: torch.Tensor, boxes: torch.Tensor, frame_idx: torch.Tensor, out_size: int = 112
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
    lib = _load()
    fn = lib.crop_and_resize_u8 if frames.dtype == torch.uint8 else lib.crop_and_resize_f32
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            frames.data_ptr(), boxes.data_ptr(), frame_idx.data_ptr(), out.data_ptr(),
            C, H, W, ch, n, out_size, stream,
        )
    if err != 0:
        msg = lib.crop_and_resize_error_string(err).decode()
        raise RuntimeError(f"crop_resize: kernel launch failed: {msg} ({err})")
    crop_and_resize_cuda.launches += 1
    return out


crop_and_resize_cuda.launches = 0
