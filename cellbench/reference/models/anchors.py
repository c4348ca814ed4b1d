# A frozen copy of the port's models/anchors.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Static anchor generation (numpy copy of ``playground3d_tpu/models/anchors.py``).

Anchors depend only on the input shape, so they are computed once in numpy
and cached per shape (the reference recomputes them on every forward,
anchors.py:21-40).

Layout parity: pyramid levels 3-7, stride 2^l, base size 2^(l+2), 3 ratios
(0.5, 1, 2) x 3 scales (2^0, 2^(1/3), 2^(2/3)) = 9 anchors per cell; cell
grids are ceil(H/2^l) x ceil(W/2^l) with centers at (i+0.5)*stride; flat
order is position-major (row-major y, x), anchor-minor — matching the head
outputs' NHWC flatten.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

PYRAMID_LEVELS = (3, 4, 5, 6, 7)
RATIOS = np.array([0.5, 1.0, 2.0])
SCALES = np.array([2.0 ** 0, 2.0 ** (1.0 / 3.0), 2.0 ** (2.0 / 3.0)])


def base_anchors(base_size: float) -> np.ndarray:
    """[9,4] xyxy anchors centered at the origin.

    Each (ratio r, scale s) pair is the box of area ``(base_size*s)**2``
    with aspect h/w = r, so ``w = base_size*s/sqrt(r)`` and ``h = w*r``.
    Rows are ratio-major, scale-minor — the order the head channels assume
    (same layout as reference anchors.py:42-73 ``generate_anchors``, which
    derives the identical boxes via in-place area renormalization).
    """
    r = np.repeat(RATIOS, len(SCALES))  # [9] ratio-major
    s = np.tile(SCALES, len(RATIOS))  # [9] scale-minor
    w = base_size * s / np.sqrt(r)
    h = w * r
    half = 0.5 * np.stack([w, h, w, h], axis=1)
    return half * np.array([-1.0, -1.0, 1.0, 1.0])


def level_shape(image_shape: Tuple[int, int], level: int) -> Tuple[int, int]:
    h, w = image_shape
    s = 2 ** level
    return (h + s - 1) // s, (w + s - 1) // s


@functools.lru_cache(maxsize=32)
def anchors_for_shape(
    image_shape: Tuple[int, int], levels: Tuple[int, ...] = PYRAMID_LEVELS
) -> np.ndarray:
    """[A_total, 4] float32 anchors for an (H, W) input
    (reference anchors.py:21-40 + shift:109-129).

    ``levels`` restricts the pyramid (e.g. (4,5,6,7) drops the stride-8
    level — the "highway scale band" inference knob; the stride-8 grid is
    ~75% of all anchors and head cells). Reference parity is all of 3-7."""
    out = []
    for level in levels:
        stride = 2 ** level
        size = 2 ** (level + 2)
        base = base_anchors(size)  # [9,4]
        gh, gw = level_shape(image_shape, level)
        sx = (np.arange(gw) + 0.5) * stride
        sy = (np.arange(gh) + 0.5) * stride
        mx, my = np.meshgrid(sx, sy)  # [gh,gw]
        shifts = np.stack([mx, my, mx, my], axis=-1).reshape(-1, 1, 4)  # [K,1,4]
        out.append((shifts + base[None]).reshape(-1, 4))
    return np.concatenate(out, axis=0).astype(np.float32)


