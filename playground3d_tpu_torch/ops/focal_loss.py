"""The training loss's hand-written CUDA kernels (``csrc/focal_loss.cu``):
their wrappers, the host's launch plan, a plain model of the forward's label
cull, and the ``torch.autograd.Function`` that binds forward and backward.

``losses/focal.py::detection_loss`` runs :class:`FocalLoss` for tensors on
the card and its plain version for tensors on the CPU. The forward is one
launch (a persistent grid: the assignment over the labels each warp keeps,
the three terms, and the per-image and batch sums reduced in a fixed order
by the last block), the backward another; no host read in either. Both
count their launches (``focal_loss_forward_cuda.launches``,
``focal_loss_backward_cuda.launches``).
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from playground3d_tpu_torch.ops.cuda_build import CSRC_DIR, KernelLibrary, count_launch

__all__ = ["LIB", "FocalLoss", "FocalPlan", "assign_culled", "check_args", "focal_loss_backward_cuda",
           "focal_loss_forward_cuda", "kept_labels", "launch_plan"]

SOURCE = CSRC_DIR / "focal_loss.cu"

# csrc/focal_loss.cu's layout constants
THREADS = 256  # anchors a tile (a block's step)
GROUP = 32  # anchors a label cull (one warp)
MAX_LABELS = 64  # label rows an image
MAX_CLASSES = 16
N_REG = 12
N_ANN = 21
SMS = 132
BLOCKS_PER_SM = 2
SLOTS = SMS * BLOCKS_PER_SM  # forward blocks at most
HEADER_BYTES = 528  # forward shared memory before the label table
LABEL_BYTES = 140  # a label's row of the table
MAX_SHARED_BYTES = 232448  # a block's shared memory on the card
BIG = 2.0 ** 60  # coordinates within this bound cannot overflow the IoU


class FocalPlan(NamedTuple):
    """What the host decides for one call, from shapes alone."""

    tiles: int  # anchor tiles of THREADS an image
    parts_per_image: int  # forward blocks an image
    grid: int  # forward blocks
    tiles_per_block: int  # tiles a forward block walks, at most
    partials: int  # doubles in the forward's partials buffer
    forward_smem: int  # dynamic shared memory of a forward block
    backward_smem: int  # dynamic shared memory of a backward block (a block a tile)


def launch_plan(b: int, a: int, k: int = 8, m: int = 32) -> FocalPlan:
    """The forward's fixed split of ``b`` images of ``a`` anchors, so that
    tile-to-block map and reduction order depend on the shapes alone: each
    image gets ``parts_per_image`` = min(SLOTS // b, tiles) blocks, at least
    one, and block p of them its every ``parts_per_image``-th tile from tile
    p. And both kernels' shared memory. ``csrc/focal_loss.cu::make_plan``
    computes the same and refuses a launch whose grid or shared memory
    differs. Raises ValueError for sizes the kernels do not take."""
    if not (1 <= b <= 65535 and a >= 1 and 1 <= k <= MAX_CLASSES and 1 <= m <= MAX_LABELS):
        raise ValueError(f"focal_loss: the kernel takes 1-65,535 images, at least 1 anchor, 1-{MAX_CLASSES} "
                         f"classes and 1-{MAX_LABELS} label rows, got {b}, {a}, {k}, {m}")
    if b * a * N_REG >= 2 ** 40:
        raise ValueError(f"focal_loss: {b} x {a} anchors exceed the kernel's 40-bit element offsets")
    tiles = -(-a // THREADS)
    ppi = max(1, min(SLOTS // b, tiles))
    grid = b * ppi
    return FocalPlan(tiles, ppi, grid, -(-tiles // ppi), 4 * grid, HEADER_BYTES + m * LABEL_BYTES,
                     THREADS * (k + N_REG) * 4)


def _nan_min(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The kernel's ``fminf`` reduction: NaN ignored (+inf if all are)."""
    return torch.where(torch.isnan(x), torch.inf, x).amin(dim)


def _hulls(annotations: torch.Tensor) -> torch.Tensor:
    """[B,M,21] labels -> [B,M,4] xyxy hulls of the 16 corner coordinates
    (NaN passes on, as torch's amin / amax do)."""
    xs, ys = annotations[..., 0:16:2], annotations[..., 1:16:2]
    return torch.stack([xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)], -1)


def kept_labels(anchors: torch.Tensor, annotations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's label cull, as a plain model: anchors [A,4],
    annotations [B,M,21] -> (keep [B, ceil(A/GROUP), M] bool, the labels
    each group of GROUP anchors (one warp) evaluates; start [B, G] int64,
    the label the group's loop starts from with IoU 0, or -1).

    Let f be the first valid label whose hull lies within +-BIG. A group
    keeps every valid label up to f, and after it every valid label whose
    hull it cannot prove disjoint from its anchors' hull; a group with an
    anchor coordinate beyond +-BIG (or NaN) keeps every valid label. When f
    is the only label kept before f's turn and is itself disjoint, its IoU
    is 0 at every anchor: the group starts from (0, f) and drops f.
    ``csrc/focal_loss.cu`` states why the argmax is then the plain loop's,
    bit for bit."""
    valid = annotations[..., 20] >= 0  # [B,M]
    hull = _hulls(annotations)
    inside = valid & (hull.abs() <= BIG).all(-1)
    m = valid.shape[1]
    idx = torch.arange(m)
    first = torch.where(inside, idx, m).amin(1)  # [B]; m when there is none
    prefix = valid & (idx[None] <= first[:, None])
    n = anchors.shape[0]
    groups = -(-n // GROUP)
    pad = groups * GROUP - n
    an = torch.cat([anchors, anchors.new_full((pad, 4), float("nan"))]).view(groups, GROUP, 4)
    real = torch.arange(groups * GROUP).view(groups, GROUP) < n
    w0, w1 = _nan_min(an[..., 0], 1), _nan_min(an[..., 1], 1)
    w2, w3 = -_nan_min(-an[..., 2], 1), -_nan_min(-an[..., 3], 1)
    ok = ((an.abs() <= BIG).all(-1) | ~real).all(1)[None]  # [1,G]
    h = hull[:, None]  # [B,1,M,4]
    disjoint = ((h[..., 0] >= w2[None, :, None]) | (h[..., 2] <= w0[None, :, None])
                | (h[..., 1] >= w3[None, :, None]) | (h[..., 3] <= w1[None, :, None]))  # [B,G,M]
    keep = torch.where(ok[..., None], prefix[:, None] | (valid[:, None] & ~disjoint), valid[:, None])
    f = first.clamp_max(m - 1)[:, None].expand(-1, groups)  # [B,G]
    short = (ok & (first < m)[:, None] & (prefix.sum(1) == 1)[:, None]
             & disjoint.gather(2, f[..., None])[..., 0])
    keep = keep & ~(short[..., None] & (idx == f[..., None]))
    return keep, torch.where(short, f, -1)


def assign_culled(anchors: torch.Tensor, annotations: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``losses/focal.py::assign_plain``'s loop over the labels that
    :func:`kept_labels` keeps for each anchor's group, from its start, the
    rest skipped, as the forward kernel runs it -> (iou_max [B,A], argmax
    [B,A] int32)."""
    keep, start = kept_labels(anchors, annotations)
    n = anchors.shape[0]
    keep = keep.repeat_interleave(GROUP, 1)[:, :n]  # [B,A,M]
    start = start.repeat_interleave(GROUP, 1)[:, :n]  # [B,A]
    hulls = _hulls(annotations)
    a0, a1, a2, a3 = (anchors[:, i] for i in range(4))
    best = torch.where(start >= 0, 0.0, -1.0).to(anchors.dtype)
    arg = start.clamp_min(0).to(torch.int32)
    for j in range(annotations.shape[1]):
        h0, h1, h2, h3 = (hulls[:, j, i, None] for i in range(4))
        iw = torch.clamp_min(torch.minimum(a2, h2) - torch.maximum(a0, h0), 0.0)
        ih = torch.clamp_min(torch.minimum(a3, h3) - torch.maximum(a1, h1), 0.0)
        inter = iw * ih
        iou = inter / torch.clamp_min((a2 - a0) * (a3 - a1) + (h2 - h0) * (h3 - h1) - inter, 1e-8)
        better = keep[:, :, j] & (iou > best)
        best = torch.where(better, iou, best)
        arg = torch.where(better, torch.full_like(arg, j), arg)
    return best, arg


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket(dev: torch.device) -> torch.Tensor:
    """The forward's ticket for the current stream of ``dev``: zeroed once
    when made; each launch leaves it 0. Launches on one stream run in order,
    so they never hold it at once; another stream has its own."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros((1,), dtype=torch.int32, device=dev)
    return t


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.focal_loss_forward.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
                                       ptr, ptr]
    lib.focal_loss_forward.restype = i32
    lib.focal_loss_backward.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr,
                                        ptr]
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


def focal_loss_forward_cuda(classification: torch.Tensor, regression: torch.Tensor, annotations: torch.Tensor,
                            anchors: torch.Tensor):
    """Launch the forward kernel on the current stream -> (losses [3]
    float32 (cls, reg, vp batch means), num_pos [B] float32 (clamped >= 1),
    argmax [B,A] int32, flags [B,A] uint8: bit 0 positive, bit 1 positive
    or negative). Contiguous float32 CUDA tensors on one device."""
    _check_cuda("focal_loss_forward", (classification, regression, annotations, anchors))
    b, a, k, m = check_args(classification, regression, annotations, anchors)
    plan = launch_plan(b, a, k, m)
    dev = classification.device
    losses = torch.empty((3,), dtype=torch.float32, device=dev)
    num_pos = torch.empty((b,), dtype=torch.float32, device=dev)
    argmax = torch.empty((b, a), dtype=torch.int32, device=dev)
    flags = torch.empty((b, a), dtype=torch.uint8, device=dev)
    partials = torch.empty((plan.partials,), dtype=torch.float64, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.focal_loss_forward(
            classification.data_ptr(), regression.data_ptr(), annotations.data_ptr(), anchors.data_ptr(),
            b, a, k, m, plan.grid, plan.forward_smem, argmax.data_ptr(), flags.data_ptr(), partials.data_ptr(),
            _ticket(dev).data_ptr(), num_pos.data_ptr(), losses.data_ptr(), torch.cuda.current_stream().cuda_stream,
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
    plan = launch_plan(b, a, k, m)
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
            plan.backward_smem, dcls.data_ptr(), dreg.data_ptr(), torch.cuda.current_stream().cuda_stream,
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
