"""The training loss's hand-written CUDA kernels (``csrc/focal_loss.cu``):
their wrappers and the ``torch.autograd.Function`` that binds forward and
backward.

``losses/focal.py::detection_loss`` runs :class:`FocalLoss` for tensors on
the card and its plain version for tensors on the CPU. The forward is one
launch (the assignment, the three terms, and the per-image and batch sums
reduced in a fixed order by the last block), the backward another; no host
read in either. Both count their launches (``focal_loss_forward_cuda.
launches``, ``focal_loss_backward_cuda.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from playground3d_tpu_torch.ops.cuda_build import KernelLibrary, count_launch

__all__ = ["LIB", "FocalLoss", "check_args", "focal_loss_backward_cuda", "focal_loss_forward_cuda"]

# csrc/focal_loss.cu's layout constants
THREADS = 256  # anchors a block
MAX_LABELS = 64  # label rows an image
MAX_CLASSES = 16
N_REG = 12
N_ANN = 21


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.focal_loss_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.focal_loss_forward.restype = i32
    lib.focal_loss_backward.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
    lib.focal_loss_backward.restype = i32


# -fmad=false: the IoU, and so the assignment, rounds as the plain version's ops do
LIB = KernelLibrary("focal_loss", _bind, extra_flags=("-fmad=false",))


def check_args(classification: torch.Tensor, regression: torch.Tensor, annotations: torch.Tensor,
               anchors: torch.Tensor) -> Tuple[int, int, int, int]:
    """Raise ValueError on what the loss does not take; -> (B, A, K, M)."""
    if classification.ndim != 3:
        raise ValueError(f"detection_loss: classification must be [B,A,K], got {tuple(classification.shape)}")
    b, a, k = classification.shape
    want = {"classification": (classification, (b, a, k)), "regression": (regression, (b, a, N_REG)),
            "annotations": (annotations, (b, annotations.shape[1] if annotations.ndim == 3 else -1, N_ANN)),
            "anchors": (anchors, (a, 4))}
    for name, (t, shape) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"detection_loss: {name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
    return b, a, k, annotations.shape[1]


def _check_cuda(name: str, tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _check_sizes(name: str, b: int, k: int, m: int) -> None:
    if not (1 <= b <= 65535 and 1 <= k <= MAX_CLASSES and 1 <= m <= MAX_LABELS):
        raise ValueError(f"{name}: the kernel takes 1-65,535 images, 1-{MAX_CLASSES} classes and "
                         f"1-{MAX_LABELS} label rows, got {b}, {k}, {m}")


def focal_loss_forward_cuda(classification: torch.Tensor, regression: torch.Tensor, annotations: torch.Tensor,
                            anchors: torch.Tensor):
    """Launch the forward kernel on the current stream -> (losses [3]
    float32 (cls, reg, vp batch means), num_pos [B] float32 (clamped >= 1),
    argmax [B,A] int32, flags [B,A] uint8: bit 0 positive, bit 1 positive
    or negative). Contiguous float32 CUDA tensors on one device."""
    _check_cuda("focal_loss_forward", (classification, regression, annotations, anchors))
    b, a, k, m = check_args(classification, regression, annotations, anchors)
    _check_sizes("focal_loss_forward", b, k, m)
    dev = classification.device
    tiles = -(-a // THREADS)
    losses = torch.empty((3,), dtype=torch.float32, device=dev)
    num_pos = torch.empty((b,), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, a), dtype=torch.int32, device=dev)
    flags = torch.empty((b, a), dtype=torch.uint8, device=dev)
    partials = torch.empty((b, tiles, 4), dtype=torch.float64, device=dev)
    ticket = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.focal_loss_forward(
            classification.data_ptr(), regression.data_ptr(), annotations.data_ptr(), anchors.data_ptr(),
            b, a, k, m, argmax.data_ptr(), flags.data_ptr(), partials.data_ptr(), ticket.data_ptr(),
            num_pos.data_ptr(), losses.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    LIB.check(err)
    count_launch(focal_loss_forward_cuda, (classification, regression, annotations, anchors))
    return losses, num_pos, argmax, flags


focal_loss_forward_cuda.launches = 0


def focal_loss_backward_cuda(classification, regression, annotations, anchors, argmax, flags, num_pos,
                             grad_out):
    """Launch the backward kernel on the current stream -> (d classification
    [B,A,K], d regression [B,A,12]) for ``grad_out`` [3] float32, the
    gradients of the three losses; the other arguments are the forward's
    inputs and outputs."""
    _check_cuda("focal_loss_backward", (classification, regression, annotations, anchors, argmax, flags,
                                        num_pos, grad_out))
    b, a, k, m = check_args(classification, regression, annotations, anchors)
    _check_sizes("focal_loss_backward", b, k, m)
    if (argmax.dtype, tuple(argmax.shape)) != (torch.int32, (b, a)) or \
            (flags.dtype, tuple(flags.shape)) != (torch.uint8, (b, a)):
        raise ValueError("focal_loss_backward: argmax must be int32 and flags uint8, both [B,A]")
    if (num_pos.dtype, tuple(num_pos.shape), grad_out.dtype, tuple(grad_out.shape)) != \
            (torch.float32, (b,), torch.float32, (3,)):
        raise ValueError("focal_loss_backward: num_pos must be float32 [B] and grad_out float32 [3]")
    dcls = torch.empty_like(classification)
    dreg = torch.empty_like(regression)
    lib = LIB.load()
    with torch.cuda.device(classification.device):
        err = lib.focal_loss_backward(
            classification.data_ptr(), regression.data_ptr(), annotations.data_ptr(), anchors.data_ptr(),
            argmax.data_ptr(), flags.data_ptr(), num_pos.data_ptr(), grad_out.data_ptr(), b, a, k, m,
            dcls.data_ptr(), dreg.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    LIB.check(err)
    count_launch(focal_loss_backward_cuda, (classification, regression, annotations, anchors, argmax, flags,
                                            num_pos, grad_out))
    return dcls, dreg


focal_loss_backward_cuda.launches = 0


class FocalLoss(torch.autograd.Function):
    """(classification, regression, annotations, anchors) -> (cls, reg, vp)
    through the two kernels; gradients flow to classification and
    regression only."""

    @staticmethod
    def forward(ctx, classification, regression, annotations, anchors):
        inputs = tuple(t.contiguous() for t in (classification, regression, annotations, anchors))
        losses, num_pos, argmax, flags = focal_loss_forward_cuda(*inputs)
        ctx.save_for_backward(*inputs, argmax, flags, num_pos)
        return losses[0], losses[1], losses[2]

    @staticmethod
    def backward(ctx, g_cls, g_reg, g_vp):
        *inputs, argmax, flags, num_pos = ctx.saved_tensors
        zero = torch.zeros((), dtype=torch.float32, device=argmax.device)
        grad_out = torch.stack([zero if g is None else g.to(torch.float32) for g in (g_cls, g_reg, g_vp)])
        dcls, dreg = focal_loss_backward_cuda(*inputs, argmax, flags, num_pos, grad_out)
        return dcls, dreg, None, None
