"""Frame sources (port of the synthetic part of
``playground3d_tpu/data/video.py``).

:class:`SyntheticVideoSource` renders a synthetic scene at frame rate with a
real burned-in pixel timestamp, the stand-in for recorded video. The video
decoders of the JAX module (native libav shim, cv2, PyAV, an ``ffmpeg``
pipe) are not ported yet; nothing here probes or builds one at import.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from playground3d_tpu_torch.data.timestamps import TimestampGeometry, encode_timestamp
from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD


def normalize_frame(frame_u8: np.ndarray) -> np.ndarray:
    """uint8 [H,W,3] -> ImageNet-normalized float32 (mp_loader.py:237-239)."""
    f = frame_u8.astype(np.float32) / 255.0
    return (f - IMAGENET_MEAN) / IMAGENET_STD


class FrameSource:
    """Iterator protocol: yields (frame [H,W,3] float32 normalized, t_abs)."""

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, float]:
        raise NotImplementedError


class SyntheticVideoSource(FrameSource):
    """Renders a :class:`~playground3d_tpu_torch.data.synthetic.SyntheticScene`
    through a projection at frame rate, with a real burned-in pixel
    timestamp."""

    def __init__(
        self,
        scene,
        P: np.ndarray,
        n_frames: int,
        fps: float = 30.0,
        t0: float = 1.6e9,
        height: int = 1080,
        width: int = 1920,
        clock_bias: float = 0.0,
        normalized: bool = True,
        burn_timestamp: bool = True,
        seed: int = 0,
    ):
        from playground3d_tpu_torch.data.synthetic import render_frame

        self._render = render_frame
        self.scene, self.P = scene, P
        self.n_frames, self.fps, self.t0 = n_frames, fps, t0
        self.h, self.w = height, width
        self.clock_bias = clock_bias
        self.normalized = normalized
        self.burn = burn_timestamp
        self.rng = np.random.default_rng(seed)
        self._i = 0

    def __len__(self):
        return self.n_frames

    def __next__(self):
        if self._i >= self.n_frames:
            raise StopIteration
        t_rel = self._i / self.fps
        t_abs = self.t0 + t_rel + self.clock_bias
        frame, _ = self._render(
            self.scene, t_rel, self.P, height=self.h, width=self.w,
            rng=self.rng, normalized=False,
        )
        g = TimestampGeometry()
        if self.burn and self.h >= g.y0 + g.h and self.w >= g.x0 + g.n * g.w:
            frame = encode_timestamp(frame, t_abs, g)
        if self.normalized:
            frame = (frame - IMAGENET_MEAN) / IMAGENET_STD
        self._i += 1
        return frame.astype(np.float32), t_abs
