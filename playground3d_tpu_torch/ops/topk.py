"""Top-k with ``jax.lax.top_k``'s tie order, and the host-sync counter of
the data-dependent loops.

``torch.topk`` promises no order among equal values; ``lax.top_k`` puts the
lower index first. With random-init heads every logit ties, so the tie order
decides the whole detection set: a stable descending sort gives it.
"""

from __future__ import annotations

from typing import Tuple

import torch


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` entries along the last axis, descending, lower index
    first among ties -> (values, int64 indices)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class HostSyncs:
    """Counts the device->host reads that steer a loop on the host (the NMS
    fixed point and the auction rounds): each one waits for the device."""

    count = 0

    @classmethod
    def read(cls, flag: torch.Tensor) -> bool:
        cls.count += 1
        return bool(flag)
