# A frozen copy of the port's ops/topk.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Top-k with ``jax.lax.top_k``'s tie order, the host-sync counter of the
data-dependent loops and the trackers' drains, and the device counters of
the rounds those loops run on the card.

``torch.topk`` promises no order among equal values; ``lax.top_k`` puts the
lower index first. With random-init heads every logit ties, so the tie order
decides the whole detection set: a stable descending sort gives it.
"""

from __future__ import annotations

import collections
from typing import Callable, Tuple

import numpy as np
import torch


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest ``k`` entries along the last axis, descending, lower index
    first among ties -> (values, int64 indices)."""
    v, i = torch.sort(values, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


class HostSyncs:
    """Counts the device->host reads that steer a loop on the host (the NMS
    fixed point and the auction rounds) and the single-camera tracker's
    per-frame drain: each one waits for the device. ``count`` is the total,
    ``by_loop`` the same reads by the name of the loop that made them."""

    count = 0
    by_loop: "collections.Counter[str]" = collections.Counter()

    @classmethod
    def read(cls, flag: torch.Tensor, loop: str) -> bool:
        cls.count += 1
        cls.by_loop[loop] += 1
        return bool(flag)

    @classmethod
    def fetch(cls, t: torch.Tensor, loop: str = "drain") -> np.ndarray:
        """One device->host read of ``t``, waited for now."""
        return cls.fetch_later(t, loop)()

    @classmethod
    def fetch_later(cls, t: torch.Tensor, loop: str = "drain") -> Callable[[], np.ndarray]:
        """One device->host read of ``t``, started now and waited for when
        the returned function is called: on the card a ``non_blocking``
        copy into pinned memory behind an event, so the host does not wait
        until it needs the values."""
        cls.count += 1
        cls.by_loop[loop] += 1
        if t.device.type != "cuda":
            host = t.cpu()
            return host.numpy
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))

        def wait() -> np.ndarray:
            done.synchronize()
            return host.numpy()

        return wait


