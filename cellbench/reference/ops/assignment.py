# A frozen copy of the port's ops/assignment.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Linear assignment: forward auction on the device + host Hungarian (port
of ``playground3d_tpu/ops/assignment.py``).

The auction is Bertsekas' forward auction with epsilon scaling on the
squared-up, masked benefit, with the JAX package's near-zero diagonal dummy
tie-break. The JAX package runs it in a ``while_loop`` on the device. Here
:func:`assign_auction` launches the hand-written kernel
``csrc/auction.cu`` for tensors on the card (the whole loop in one block
sized to the problem, a round's work on the bidding rows only, no host
read; its rounds go to
:class:`~cellbench.reference.ops.topk.DeviceRounds`), and runs
:func:`assign_auction_plain`, a host loop that reads one flag from the
device per round (counted in
:class:`~cellbench.reference.ops.topk.HostSyncs`), for tensors on the
CPU. Every round is the same float32 arithmetic in the same order in both,
so they agree with each other and with JAX.
"""

from __future__ import annotations

import torch

from cellbench.reference.ops.topk import HostSyncs


NEG = -1e9

# The kernel's layout constants (csrc/auction.cu holds the same values).


# -fmad=false is belt and braces: the source rounds every float op explicitly


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
    return assign_auction_plain(benefit, row_mask, col_mask, max_iters)


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


