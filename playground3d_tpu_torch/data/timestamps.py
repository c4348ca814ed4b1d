"""Burned-in pixel timestamp codec (encoder + decoder), pure numpy (copy of
``playground3d_tpu/data/timestamps.py``).

The I-24 cameras burn a monospaced UNIX timestamp into each 4K frame; the
reference decodes it by a 6-region pixel checksum per digit with an
exact-match requirement (reference timestamp_utilities.py:46-115,
``parse_frame_timestamp``). This module re-implements the decoder
numpy-only (no cv2) and adds an *encoder* that renders the same digit
geometry — so synthetic videos carry real parseable timestamps and the
decode path is testable end-to-end.

Geometry follows the reference's resources/timestamp_geometry_4K layout
conventions: ``n`` monospaced cells of w x h pixels at (x0, y0); each digit
cell is split into a 3x2 grid (rows split at h13/h23, columns at w12) whose
white-pixel counts form the checksum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class TimestampGeometry:
    x0: int = 16
    y0: int = 16
    w: int = 16  # digit cell width
    h: int = 28  # digit cell height
    n: int = 13  # cells: 10 integer digits, '.', 2 decimals
    decimal_index: int = 10  # cell that holds the '.' (skipped in decode)

    @property
    def h13(self) -> int:
        return self.h // 3

    @property
    def h23(self) -> int:
        return 2 * self.h // 3

    @property
    def w12(self) -> int:
        return self.w // 2

    def pixel_limits(self) -> Tuple[int, int, int, int]:
        """(y1, y2, x1, x2) of the timestamp strip
        (reference timestamp_utilities.py:31-43)."""
        return self.y0, self.y0 + self.h, self.x0, self.x0 + self.n * self.w


# 5x7 bitmap font for digits 0-9 (classic seven-segment-ish glyphs)
_FONT = {
    "0": ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],
    "1": ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    "2": ["01110", "10001", "00001", "00010", "00100", "01000", "11111"],
    "3": ["11111", "00010", "00100", "00010", "00001", "10001", "01110"],
    "4": ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    "5": ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    "6": ["00110", "01000", "10000", "11110", "10001", "10001", "01110"],
    "7": ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    "8": ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    "9": ["01110", "10001", "10001", "01111", "00001", "00010", "01100"],
    ".": ["00000", "00000", "00000", "00000", "00000", "01100", "01100"],
}


def _digit_bitmap(ch: str, g: TimestampGeometry) -> np.ndarray:
    """Render one glyph into a [h, w] binary cell (nearest upscale)."""
    pat = np.array([[int(c) for c in row] for row in _FONT[ch]], dtype=np.uint8)
    yi = (np.arange(g.h) * pat.shape[0] // g.h).clip(0, pat.shape[0] - 1)
    xi = (np.arange(g.w) * pat.shape[1] // g.w).clip(0, pat.shape[1] - 1)
    return pat[yi][:, xi]


def digit_checksum(cell: np.ndarray, g: TimestampGeometry) -> np.ndarray:
    """[3,2] white-pixel counts of a binary digit cell
    (reference timestamp_utilities.py:100-104)."""
    return np.array(
        [
            [int(cell[: g.h13, : g.w12].sum()), int(cell[: g.h13, g.w12 :].sum())],
            [int(cell[g.h13 : g.h23, : g.w12].sum()), int(cell[g.h13 : g.h23, g.w12 :].sum())],
            [int(cell[g.h23 :, : g.w12].sum()), int(cell[g.h23 :, g.w12 :].sum())],
        ]
    )


def precomputed_checksums(g: Optional[TimestampGeometry] = None) -> Dict[str, np.ndarray]:
    """digit -> [3,2] checksum table (the equivalent of the reference's
    pickled resources/timestamp_pixel_checksum_6, tsu.py:10-18)."""
    g = g or TimestampGeometry()
    return {d: digit_checksum(_digit_bitmap(d, g), g) for d in "0123456789"}


def encode_timestamp(
    frame: np.ndarray, timestamp: float, g: Optional[TimestampGeometry] = None
) -> np.ndarray:
    """Burn ``timestamp`` (UNIX seconds, .00 precision) into ``frame``
    ([H,W,3] float in [0,1] or uint8). Returns the modified frame (copy)."""
    g = g or TimestampGeometry()
    s = f"{timestamp:.2f}"
    int_part, dec_part = s.split(".")
    text = int_part.rjust(10, "0") + "." + dec_part  # n=13 cells
    assert len(text) == g.n, (text, g.n)

    out = frame.copy()
    white = 255 if out.dtype == np.uint8 else 1.0
    black = 0
    y0, y1, x0, x1 = g.y0, g.y0 + g.h, g.x0, g.x0 + g.n * g.w
    out[y0:y1, x0:x1] = black
    for j, ch in enumerate(text):
        cell = _digit_bitmap(ch, g)
        xs = g.x0 + j * g.w
        region = out[y0:y1, xs : xs + g.w]
        region[cell.astype(bool)] = white
    return out


def parse_frame_timestamp(
    frame: np.ndarray,
    g: Optional[TimestampGeometry] = None,
    checksums: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[Optional[float], Optional[np.ndarray]]:
    """Decode the burned-in timestamp: grayscale, threshold at half
    intensity, per-digit 6-region checksum with exact-match requirement.
    Returns (timestamp, None) or (None, error_digit_pixels)
    (reference timestamp_utilities.py:46-115)."""
    g = g or TimestampGeometry()
    checksums = checksums or precomputed_checksums(g)

    y1, y2, x1, x2 = g.pixel_limits()
    strip = frame[y1:y2, x1:x2]
    if strip.ndim == 3:
        gray = strip.mean(axis=2)
    else:
        gray = strip
    thresh = 127 if frame.dtype == np.uint8 else 0.5
    mask = (gray > thresh).astype(np.uint8)

    digits = []
    for j in range(g.n):
        if j == g.decimal_index:
            digits.append(".")
            continue
        cell = mask[:, j * g.w : (j + 1) * g.w]
        cs = digit_checksum(cell, g)
        best, best_err = None, None
        for d, ref in checksums.items():
            err = int(np.abs(cs - ref).sum())
            if best_err is None or err < best_err:
                best, best_err = d, err
        if best_err > 0:
            return None, cell
        digits.append(best)
    return float("".join(digits)), None
