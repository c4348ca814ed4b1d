"""Stage timers and throughput accounting (port of the standard-library part
of ``playground3d_tpu/utils/profiling.py``).

The reference tracks wall-clock per pipeline stage in a ``time_metrics``
dict and prints FPS / FPS-without-IO (MC3D_crop_tracker.py:168-181,
1301-1308). The JAX module's profiler hooks have no counterpart here:
``torch.profiler`` and CUDA events cover them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class StageTimers:
    def __init__(self, stages: List[str]):
        self.acc: Dict[str, float] = {s: 0.0 for s in stages}

    @contextlib.contextmanager
    def __call__(self, stage: str):
        start = time.time()
        try:
            yield
        finally:
            self.acc[stage] = self.acc.get(stage, 0.0) + time.time() - start

    def totals(self) -> Dict[str, float]:
        return dict(self.acc)

    def reset(self) -> None:
        for s in self.acc:
            self.acc[s] = 0.0

    def fps_without(self, n_frames: int, wall: float, exclude=("load", "plot")) -> float:
        excluded = sum(self.acc.get(s, 0.0) for s in exclude)
        return n_frames / max(wall - excluded, 1e-9)
