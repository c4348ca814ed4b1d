"""Linear assignment: forward auction on the device + host Hungarian (port
of ``playground3d_tpu/ops/assignment.py``).

The auction is Bertsekas' forward auction with epsilon scaling on the
squared-up, masked benefit, with the JAX package's near-zero diagonal dummy
tie-break. The JAX package runs it in a ``while_loop`` on the device. Here
:func:`assign_auction` launches the hand-written kernel
``csrc/auction.cu`` for tensors on the card (the whole loop in one block
sized to the problem, a round's work on the bidding rows only, no host
read; its rounds go to
:class:`~playground3d_tpu_torch.ops.topk.DeviceRounds`), and runs
:func:`assign_auction_plain`, a host loop that reads one flag from the
device per round (counted in
:class:`~playground3d_tpu_torch.ops.topk.HostSyncs`), for tensors on the
CPU. Every round is the same float32 arithmetic in the same order in both,
so they agree with each other and with JAX.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from playground3d_tpu_torch.ops.cuda_build import KernelLibrary, count_launch
from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs

__all__ = [
    "LIB", "assign_auction", "assign_auction_cuda", "assign_auction_plain", "assign_hungarian",
    "launch_plan", "matches_from_assignment",
]

NEG = -1e9

# The kernel's layout constants (csrc/auction.cu holds the same values).
MAX_K = 1024  # max(n, m): one block
SMEM_MAX_K = 224  # up to here the squared-up benefit is formed in shared memory
SMEM_MAX_THREADS = 256  # the block's size cap up to SMEM_MAX_K (1,024 above it)


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.auction.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, i32, i32, i32, ptr]
    lib.auction.restype = i32


# -fmad=false is belt and braces: the source rounds every float op explicitly
LIB = KernelLibrary("auction", _bind, extra_flags=("-fmad=false",))


class LaunchPlan(NamedTuple):
    k: int  # max(n, m), the side of the squared-up problem
    threads: int  # 32 * ceil(k / 4), at most SMEM_MAX_THREADS; 1,024 above SMEM_MAX_K
    lanes: int  # of the group that serves one bidding row (a power of two)
    benefit_in_shared: bool  # else formed on the fly from device memory
    row_stride: int  # floats between rows of the benefit in shared memory (odd; 0 if not there)
    shared_bytes: int


def launch_plan(n: int, m: int) -> LaunchPlan:
    """How the kernel is launched for an [n, m] benefit (the C launcher
    applies the same rule and refuses a mismatch). Raises ValueError for an
    empty problem or max(n, m) above :data:`MAX_K`."""
    k = max(n, m)
    if min(n, m) < 0 or not 1 <= k <= MAX_K:
        raise ValueError(f"auction: the kernel takes max(n, m) from 1 to {MAX_K}, got [{n}, {m}]")
    in_shared = k <= SMEM_MAX_K
    threads = min(SMEM_MAX_THREADS, 32 * -(-k // 4)) if in_shared else 1024
    lanes = 4 if k <= 16 else 8 if k <= 64 else 16 if in_shared else 32
    stride = k | 1 if in_shared else 0
    # the benefit [k, stride], then price, best_of, bid_of, list, col_key[2], col_win[2] and four words
    return LaunchPlan(k, threads, lanes, in_shared, stride, k * stride * 4 + 8 * k * 4 + 16)


def assign_auction_cuda(
    benefit: torch.Tensor,
    row_mask: torch.Tensor,
    col_mask: torch.Tensor,
    max_iters: int = 5000,
) -> torch.Tensor:
    """Launch the kernel on the current stream -> [n] int32. Takes benefit
    [n,m] float32, row_mask [n] and col_mask [m] bool, contiguous, on one
    CUDA device, max(n, m) <= :data:`MAX_K`. ``assign_auction_cuda.launches``
    counts the launches; the rounds and the rows that bid in them go to
    ``DeviceRounds``."""
    if benefit.device.type != "cuda":
        raise ValueError(f"auction: the CUDA kernel takes CUDA tensors, got {benefit.device}")
    if benefit.dtype != torch.float32 or benefit.ndim != 2:
        raise ValueError(f"auction: benefit must be float32 [n,m], got {benefit.dtype} {tuple(benefit.shape)}")
    n, m = benefit.shape
    plan = launch_plan(n, m)
    for name, t, size in (("row_mask", row_mask, n), ("col_mask", col_mask, m)):
        if t.dtype != torch.bool or tuple(t.shape) != (size,):
            raise ValueError(f"auction: {name} must be bool [{size}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("benefit", benefit), ("row_mask", row_mask), ("col_mask", col_mask)):
        if not t.is_contiguous():
            raise ValueError(f"auction: {name} must be contiguous")
        if t.device != benefit.device:
            raise ValueError(f"auction: {name} is on {t.device}, benefit on {benefit.device}")
    if max_iters < 0:
        raise ValueError(f"auction: max_iters must be >= 0, got {max_iters}")
    dev = benefit.device
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    lib = LIB.load()
    with torch.cuda.device(dev):
        err = lib.auction(
            benefit.data_ptr(), row_mask.data_ptr(), col_mask.data_ptr(), n, m, max_iters, out.data_ptr(),
            DeviceRounds.pointer(dev, "auction"), plan.threads, plan.lanes, plan.shared_bytes,
            torch.cuda.current_stream().cuda_stream,
        )
    LIB.check(err)
    count_launch(assign_auction_cuda, (benefit, row_mask, col_mask, max_iters))
    return out


assign_auction_cuda.launches = 0


def assign_auction(
    benefit: torch.Tensor,
    row_mask: torch.Tensor,
    col_mask: torch.Tensor,
    max_iters: int = 5000,
) -> torch.Tensor:
    """Maximize total benefit over a one-to-one row->col assignment.

    benefit [n,m]; row_mask [n] / col_mask [m] mark real entries. Returns
    [n] int32: the column of each row, -1 for unassigned or masked rows.
    The CUDA kernel for tensors on the card, the plain version for tensors
    on the CPU.
    """
    if benefit.device.type == "cuda":
        return assign_auction_cuda(benefit.contiguous(), row_mask.contiguous(), col_mask.contiguous(), max_iters)
    if benefit.device.type == "cpu":
        return assign_auction_plain(benefit, row_mask, col_mask, max_iters)
    raise ValueError(f"assign_auction: no implementation for device {benefit.device}")


def assign_auction_plain(
    benefit: torch.Tensor,
    row_mask: torch.Tensor,
    col_mask: torch.Tensor,
    max_iters: int = 5000,
) -> torch.Tensor:
    """The plain version: the JAX function's ops, its ``while_loop`` as a
    host loop reading one flag a round. Any device."""
    n, m = benefit.shape
    k = max(n, m)
    dev, dt = benefit.device, benefit.dtype

    real = row_mask[:, None] & col_mask[None, :]
    real_b = torch.where(real, benefit, torch.zeros_like(benefit))
    scale = torch.clamp(torch.max(torch.abs(real_b)), min=1e-6)

    arange_k = torch.arange(k, device=dev)
    tie_break = -torch.abs(arange_k[:, None] - arange_k[None, :]).to(dt) * (scale * 1e-7)
    b = tie_break.clone()
    b[:n, :m] = torch.where(real, benefit, tie_break[:n, :m])
    nk = torch.tensor(float(k), dtype=dt, device=dev)
    eps_final = scale / (1e4 * (nk + 1.0))

    neg_k = torch.full((k,), NEG, dtype=dt, device=dev)
    it = 0
    eps = scale / 4.0 + eps_final
    price = torch.zeros((k,), dtype=dt, device=dev)
    row_of_col = torch.full((k,), -1, dtype=torch.int64, device=dev)
    col_of_row = torch.full((k,), -1, dtype=torch.int64, device=dev)

    while it < max_iters and HostSyncs.read(torch.any(col_of_row < 0) | (eps > eps_final), "auction"):
        bidding = col_of_row < 0
        value = b - price[None, :]
        best_j = torch.argmax(value, dim=1)
        best_v = torch.max(value, dim=1).values
        value2 = value.clone()
        value2[arange_k, best_j] = NEG
        second_v = torch.max(value2, dim=1).values
        bid = price[best_j] + (best_v - second_v) + eps

        bid_eff = torch.where(bidding, bid, neg_k)
        col_bid = neg_k.scatter_reduce(0, best_j, bid_eff, "amax", include_self=True)
        has_bid = torch.zeros((k,), dtype=torch.int32, device=dev).scatter_reduce(
            0, best_j, bidding.to(torch.int32), "amax", include_self=True
        ) > 0

        is_winner = bidding & (bid_eff >= col_bid[best_j] - 1e-12)
        winner_row = torch.full((k,), k, dtype=torch.int64, device=dev).scatter_reduce(
            0, best_j, torch.where(is_winner, arange_k, torch.full_like(arange_k, k)),
            "amin", include_self=True,
        )

        taken = has_bid & (winner_row < k)
        prev_row = torch.where(taken, row_of_col, torch.full_like(row_of_col, -1))
        evict = torch.zeros((k,), dtype=torch.int32, device=dev).scatter_reduce(
            0, torch.clamp(prev_row, 0, k - 1), (prev_row >= 0).to(torch.int32),
            "amax", include_self=True,
        ) > 0
        col_of_row = torch.where(evict, torch.full_like(col_of_row, -1), col_of_row)
        w_safe = torch.clamp(winner_row, 0, k - 1)
        won_col = torch.full((k,), -1, dtype=torch.int64, device=dev).scatter_reduce(
            0, w_safe, torch.where(taken, arange_k, torch.full_like(arange_k, -1)),
            "amax", include_self=True,
        )
        col_of_row = torch.where(won_col >= 0, won_col, col_of_row)
        row_of_col = torch.where(taken, winner_row, row_of_col)
        price = torch.where(taken, col_bid, price)

        all_assigned = ~torch.any(col_of_row < 0)
        shrink = all_assigned & (eps > eps_final)
        eps = torch.where(shrink, eps * 0.1, eps)
        col_of_row = torch.where(shrink, torch.full_like(col_of_row, -1), col_of_row)
        row_of_col = torch.where(shrink, torch.full_like(row_of_col, -1), row_of_col)
        it += 1

    out = col_of_row[:n]
    col_ok = (out >= 0) & (out < m)
    col_real = torch.where(col_ok, col_mask[torch.clamp(out, 0, m - 1)], torch.zeros_like(col_ok))
    return torch.where(row_mask & col_ok & col_real, out, torch.full_like(out, -1)).to(torch.int32)


def assign_hungarian(benefit: np.ndarray, maximize: bool = True) -> np.ndarray:
    """Host-side exact Hungarian via scipy (the correctness oracle).
    Returns [n] col index per row, -1 if unassigned."""
    from scipy.optimize import linear_sum_assignment

    n, m = benefit.shape
    out = np.full(n, -1, dtype=np.int32)
    if n == 0 or m == 0:
        return out
    r, c = linear_sum_assignment(benefit, maximize=maximize)
    out[r] = c
    return out


def matches_from_assignment(
    col_of_row: np.ndarray, benefit: np.ndarray, min_benefit: float
) -> np.ndarray:
    """[l,2] (row, col) pairs with benefit >= min_benefit - the reference's
    post-assignment distance cutoff (minimal_3D_track.py:611-623)."""
    rows = np.nonzero(col_of_row >= 0)[0]
    out = []
    for r in rows:
        c = col_of_row[r]
        if benefit[r, c] >= min_benefit:
            out.append((r, c))
    return np.array(out, dtype=np.int64).reshape(-1, 2)
