"""Frame sources and writers: the host I/O runtime (port of
``playground3d_tpu/data/video.py``).

Replaces the reference's multiprocess loader/writer (util_track/mp_loader.py,
mp_writer.py), which spawn one OS process per camera to decode with
cv2.VideoCapture, parse the pixel timestamp, resize, normalize, and feed a
bounded queue. Here a source is an iterator of (frame, t_abs) that the
tracker's producer thread reads (``MultiCameraTracker.track_clips`` stages
each clip into pinned memory and copies it to the card on a side stream),
optionally behind :class:`PrefetchingSource`'s thread and bounded queue.

Video decode backends, in the JAX package's probe order (:func:`decoder`,
probed at first use, not at import): the repo's libav shim
(``native/avdecode.cc`` over the system FFmpeg libraries, built by
:mod:`~playground3d_tpu_torch.data.avdecode` where they exist), then cv2,
PyAV, or an ``ffmpeg`` binary via a subprocess pipe. Uncompressed ``.y4m``
always works through the built-in reader. Planar 4:2:0 sources take the
fused uint8 host tails of ``native/framepipe.cc``
(:mod:`~playground3d_tpu_torch.data.native`), which raise if that library
cannot be built: no path here falls back to a slower Python twin.
"""

from __future__ import annotations

import functools
import os
import queue
import struct
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np

from playground3d_tpu_torch.data.timestamps import (
    TimestampGeometry,
    encode_timestamp,
    parse_frame_timestamp,
    precomputed_checksums,
)
from playground3d_tpu_torch.ops.crop_mxu import pack_s2d
from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

__all__ = [
    "decoder", "pack_s2d", "normalize_frame", "FrameSource", "SyntheticVideoSource", "ImageDirSource",
    "resize_frame", "rgb_from_planes", "write_y4m", "VideoFrameSource", "PrefetchingSource",
    "encode_png", "write_png", "read_png", "AsyncFrameWriter",
]


@functools.lru_cache(maxsize=None)
def decoder() -> Optional[str]:
    """The compressed-video backend of this host, probed once: the libav
    shim ("lav") where the FFmpeg libraries exist, else "cv2", "av" or
    "ffmpeg" (a binary on PATH), else None."""
    from playground3d_tpu_torch.data import avdecode

    if avdecode.available():
        return "lav"
    try:
        import cv2  # noqa: F401

        return "cv2"
    except ImportError:
        pass
    try:
        import av  # noqa: F401

        return "av"
    except ImportError:
        pass
    import shutil

    if shutil.which("ffmpeg"):
        return "ffmpeg"
    return None


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


class ImageDirSource(FrameSource):
    """Frames from a directory of .npy/.npz/.png files, sorted by name
    (the reference's directory-of-images mode, mp_loader.py:43-68)."""

    def __init__(self, directory: str, fps: float = 30.0, t0: float = 0.0, normalized=True):
        self.files = sorted(
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.endswith((".npy", ".npz", ".png"))
        )
        self.fps, self.t0 = fps, t0
        self.normalized = normalized
        self._i = 0

    def __len__(self):
        return len(self.files)

    def __next__(self):
        if self._i >= len(self.files):
            raise StopIteration
        path = self.files[self._i]
        if path.endswith(".npy"):
            frame = np.load(path)
        elif path.endswith(".npz"):
            frame = np.load(path)["frame"]
        else:
            frame = read_png(path)
        if frame.dtype == np.uint8:
            frame = frame.astype(np.float32) / 255.0
        if self.normalized:
            frame = (frame - IMAGENET_MEAN) / IMAGENET_STD
        t = self.t0 + self._i / self.fps
        self._i += 1
        return frame.astype(np.float32), t


def resize_frame(frame: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Resize [H,W,3] uint8 to ``hw``. Uses cv2 when present; otherwise a
    box filter for integer downscales (the 4K->1080p case) or bilinear."""
    th, tw = hw
    h, w = frame.shape[:2]
    if (h, w) == (th, tw):
        return frame
    if decoder() == "cv2":
        import cv2

        return cv2.resize(frame, (tw, th))
    if h % th == 0 and w % tw == 0 and h // th == w // tw:
        f = h // th
        out = (
            frame[: th * f, : tw * f]
            .reshape(th, f, tw, f, -1)
            .mean(axis=(1, 3))
        )
        return out.astype(frame.dtype)
    ys = np.linspace(0, h - 1, th)
    xs = np.linspace(0, w - 1, tw)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    fr = frame.astype(np.float32)
    top = fr[y0][:, x0] * (1 - fx) + fr[y0][:, x1] * fx
    bot = fr[y1][:, x0] * (1 - fx) + fr[y1][:, x1] * fx
    out = top * (1 - fy) + bot * fy
    return out.astype(frame.dtype)


# ---------------------------------------------------------------------------
# Y4M (YUV4MPEG2): a first-party, dependency-free video container codec.
# ffmpeg converts any recording to y4m losslessly-enough for this pipeline
# (`ffmpeg -i in.mp4 out.y4m`), and the burned-in timestamp strip is pure
# black/white so it survives BT.601 4:2:0 roundtrips (decode binarizes at
# half intensity before checksum matching).
# ---------------------------------------------------------------------------


def rgb_from_planes(Y: np.ndarray, U: np.ndarray, V: np.ndarray) -> np.ndarray:
    """Float BT.601 limited-range YUV (4:2:0 or 4:4:4 planes) -> [H,W,3]
    uint8 RGB: the y4m reader's converter, and the numpy twin of the native
    fixed-point ``native.yuv420_to_rgb`` (within +-1 LSB of it)."""
    h, w = Y.shape
    if U.shape[1] != w:
        U = U.repeat(2, 0).repeat(2, 1)[:h, :w]
        V = V.repeat(2, 0).repeat(2, 1)[:h, :w]
    y = (Y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    u = (U.astype(np.float32) - 128.0) * (255.0 / 224.0)
    v = (V.astype(np.float32) - 128.0) * (255.0 / 224.0)
    rgb = np.stack([y + 1.402 * v, y - 0.344136 * u - 0.714136 * v, y + 1.772 * u], -1)
    return np.clip(rgb + 0.5, 0, 255).astype(np.uint8)


class _Y4MReader:
    """Streaming YUV4MPEG2 reader (C420/C444, 8-bit), pure numpy."""

    def __init__(self, path: str):
        self.f = open(path, "rb")
        header = self.f.readline().decode("ascii", "replace")
        if not header.startswith("YUV4MPEG2"):
            self.f.close()
            raise ValueError(f"{path}: not a YUV4MPEG2 stream")
        self.w = self.h = None
        self.c = "420"
        for tok in header.split()[1:]:
            if tok[0] == "W":
                self.w = int(tok[1:])
            elif tok[0] == "H":
                self.h = int(tok[1:])
            elif tok[0] == "C":
                self.c = tok[1:]
        if self.w is None or self.h is None:
            self.f.close()
            raise ValueError(f"{path}: y4m header missing W/H")

    def read_planes(self):
        """One frame as raw (Y, U, V) uint8 planes (chroma at its stored
        resolution), or None at EOF. The native fused decode tails
        (``native.yuv420_to_s2d_u8`` and its 4K form) consume these
        directly."""
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            return None
        w, h = self.w, self.h
        ysize = w * h
        if self.c.startswith("444"):
            csize, cw, ch = ysize, w, h
        elif self.c.startswith("420"):
            csize, cw, ch = (w // 2) * (h // 2), w // 2, h // 2
        else:
            raise ValueError(f"unsupported y4m colorspace C{self.c}")
        data = self.f.read(ysize + 2 * csize)
        if len(data) < ysize + 2 * csize:
            return None
        Y = np.frombuffer(data[:ysize], np.uint8).reshape(h, w)
        U = np.frombuffer(data[ysize : ysize + csize], np.uint8).reshape(ch, cw)
        V = np.frombuffer(data[ysize + csize :], np.uint8).reshape(ch, cw)
        return Y, U, V

    def read(self) -> Optional[np.ndarray]:
        planes = self.read_planes()
        return None if planes is None else rgb_from_planes(*planes)

    def close(self):
        self.f.close()


def write_y4m(path: str, frames, fps: int = 30, subsample: bool = True) -> None:
    """Write an iterable of [H,W,3] uint8 RGB frames as YUV4MPEG2 (BT.601
    limited range, C420 when ``subsample`` else C444)."""
    frames = iter(frames)
    first = next(frames)
    h, w = first.shape[:2]
    tag = "C420" if subsample else "C444"
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{int(fps)}:1 Ip A1:1 {tag}\n".encode())

        def emit(frame):
            fr = frame.astype(np.float32)
            r, g, b = fr[..., 0], fr[..., 1], fr[..., 2]
            y = 16.0 + (219.0 / 255.0) * (0.299 * r + 0.587 * g + 0.114 * b)
            u = 128.0 + (224.0 / 255.0) * (-0.168736 * r - 0.331264 * g + 0.5 * b)
            v = 128.0 + (224.0 / 255.0) * (0.5 * r - 0.418688 * g - 0.081312 * b)
            if subsample:
                u = u[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3))
                v = v[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2).mean((1, 3))
            f.write(b"FRAME\n")
            for plane in (y, u, v):
                f.write(np.clip(plane + 0.5, 0, 255).astype(np.uint8).tobytes())

        emit(first)
        for frame in frames:
            emit(frame)


class VideoFrameSource(FrameSource):
    """Real video decode with pixel timestamp parsing (mp_loader.py:206-247).

    Backends: the y4m reader (by extension, no dependencies); for
    compressed containers (.mp4 H.264/HEVC/MPEG-4, the reference's
    recordings) :func:`decoder`'s: the libav shim, else cv2 / PyAV /
    ffmpeg-pipe. The timestamp is parsed from the frame at its NATIVE
    resolution *before* resizing, as the reference does (mp_loader.py
    load_to_queue_video): 4K timestamp geometry never matches a resized
    frame.

    ``timers`` holds the host seconds this source spent per stage: "read"
    (decoding or reading a frame's planes or pixels), "ts" (the timestamp
    parse) and "tail" (the conversion, resize and packing into what it
    yields)."""

    def __init__(
        self,
        path: str,
        resize_hw: Tuple[int, int] = (1080, 1920),
        parse_ts=True,
        ts_geometries: Optional[list] = None,
        emit: str = "f32",
    ):
        """``emit``: "f32" yields ImageNet-normalized float [H,W,3] (the
        reference loader's contract, mp_loader.py:237-239); "s2d_u8" yields
        uint8 s2d-packed [H/4,W/4,48], the shipped feed layout (4x less
        host->device transfer, normalization on the device); 4:2:0 sources
        take the fused native decode tail (framepipe
        ``fp_yuv420_to_s2d_u8``, or ``fp_yuv420_half_to_s2d_u8`` from 2x
        the requested size). "yuv420" yields the raw planar YUV420 bytes
        flat ([H*W*3//2] uint8, 4:2:0 sources at the requested size or 2x
        it, box-downsampled per plane): 1.5 B/px, half of s2d_u8, with
        colour conversion and s2d packing on the card
        (``ops.yuv420.yuv420_flat_to_s2d``); pass yuv_hw=(H,W) to
        track_clips."""
        if emit not in ("f32", "s2d_u8", "yuv420"):
            raise ValueError(f"emit must be 'f32', 's2d_u8' or 'yuv420', got {emit!r}")
        self.emit = emit
        self._backend = "y4m" if path.endswith(".y4m") else decoder()
        if self._backend is None:
            raise RuntimeError(
                "no video decode backend available (cv2/PyAV/ffmpeg absent "
                "and not a .y4m file); use SyntheticVideoSource, "
                "ImageDirSource, or convert to y4m"
            )
        self.path = path
        self.resize_hw = resize_hw
        self.parse_ts = parse_ts
        # multiple candidate timestamp geometries, tried in order — the
        # reference falls back between two digit heights (datareader.py:59-66)
        self._geoms = ts_geometries or [TimestampGeometry()]
        self._checks = [precomputed_checksums(g) for g in self._geoms]
        self._last_ts: Optional[float] = None
        self.timers = {"read": 0.0, "ts": 0.0, "tail": 0.0}
        self._open()

    def _probe_native_hw(self) -> Tuple[int, int]:
        """Native (h, w) via ffprobe, falling back to resize_hw."""
        import shutil
        import subprocess

        if shutil.which("ffprobe"):
            try:
                out = subprocess.run(
                    [
                        "ffprobe", "-v", "error", "-select_streams", "v:0",
                        "-show_entries", "stream=width,height",
                        "-of", "csv=p=0", self.path,
                    ],
                    capture_output=True,
                    timeout=30,
                )
                w, h = map(int, out.stdout.strip().split(b",")[:2])
                return h, w
            except Exception:
                pass
        return self.resize_hw

    def _open(self):
        if self._backend == "y4m":
            self._y4m = _Y4MReader(self.path)
        elif self._backend == "lav":
            from playground3d_tpu_torch.data.avdecode import AvReader

            self._lav = AvReader(self.path)
        elif self._backend == "cv2":
            import cv2

            self._cap = cv2.VideoCapture(self.path)
        elif self._backend == "av":
            import av

            self._container = av.open(self.path)
            self._stream = self._container.decode(video=0)
        else:  # ffmpeg subprocess pipe, decoding at NATIVE size
            import subprocess

            h, w = self._probe_native_hw()
            self._ffmpeg_hw = (h, w)
            self._proc = subprocess.Popen(
                [
                    "ffmpeg", "-i", self.path, "-f", "rawvideo",
                    "-pix_fmt", "rgb24", "-s", f"{w}x{h}", "-",
                ],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
            )

    def _read_raw(self) -> Optional[np.ndarray]:
        """One decoded frame at NATIVE resolution, RGB uint8."""
        if self._backend == "y4m":
            return self._y4m.read()
        if self._backend == "lav":
            out = self._lav.read_rgb()
            return None if out is None else out[0]
        if self._backend == "cv2":
            ok, frame = self._cap.read()
            if not ok:
                return None
            return frame[:, :, ::-1]  # BGR->RGB
        if self._backend == "av":
            try:
                frame = next(self._stream)
            except StopIteration:
                return None
            return frame.to_ndarray(format="rgb24")
        h, w = self._ffmpeg_hw
        data = self._proc.stdout.read(h * w * 3)
        if len(data) < h * w * 3:
            return None
        return np.frombuffer(data, np.uint8).reshape(h, w, 3)

    def _fallback_ts(self, t):
        if t is None:
            # fallback: previous + nominal period (MC3D:213-215)
            t = (self._last_ts + 1 / 30.0) if self._last_ts is not None else 0.0
        self._last_ts = t
        return t

    def _parse_ts_rgb(self, raw: np.ndarray):
        # parse on the original frame, BEFORE resize (mp_loader.py order)
        for g, checks in zip(self._geoms, self._checks):
            t, _ = parse_frame_timestamp(raw, g, checks)
            if t is not None:
                return t
        return None

    def _timed(self, stage: str, t0: float) -> float:
        now = time.perf_counter()
        self.timers[stage] += now - t0
        return now

    def _parse_ts_planes(self, Y, U, V):
        """Convert only the timestamp strip (top rows) to RGB and parse it,
        for both planar emit paths."""
        from playground3d_tpu_torch.data import native as N

        t = None
        if self.parse_ts:
            strip_h = min(Y.shape[0], max((g.y0 + g.h for g in self._geoms)) + 2)
            strip_h += strip_h % 2
            ch = strip_h // 2
            t = self._parse_ts_rgb(N.yuv420_to_rgb(Y[:strip_h], U[:ch], V[:ch]))
        return self._fallback_ts(t)

    def _planar_420(self) -> bool:
        """True when the backend can serve raw 4:2:0 planes (the fused-tail
        zero-float host path): the y4m reader, or the libav shim on a
        YUV420P stream (H.264/HEVC/MPEG-4 recordings all decode to it)."""
        if self._backend == "y4m":
            return self._y4m.c.startswith("420")
        return self._backend == "lav" and self._lav.is_yuv420

    def _read_planes(self):
        """(Y, U, V) uint8 planes at native size, or None at EOF."""
        if self._backend == "y4m":
            return self._y4m.read_planes()
        out = self._lav.read_planes()
        return None if out is None else out[:3]

    def _next_s2d_u8(self):
        """Fused fast path: 4:2:0 planes -> (ts strip RGB for parsing) ->
        uint8 s2d frame, no full-frame float math anywhere on the host."""
        from playground3d_tpu_torch.data import native as N

        t0 = time.perf_counter()
        planes = self._read_planes()
        if planes is None:
            raise StopIteration
        Y, U, V = planes
        h, w = Y.shape
        t0 = self._timed("read", t0)
        t = self._parse_ts_planes(Y, U, V)
        t0 = self._timed("ts", t0)
        th, tw = self.resize_hw
        if (h, w) == (th, tw):
            out = N.yuv420_to_s2d_u8(Y, U, V)
        elif (h, w) == (2 * th, 2 * tw):
            # 4K source: fused plane-downsample + convert + pack (one pass,
            # reads 1.5 B/px instead of converting the full 4K frame first)
            out = N.yuv420_half_to_s2d_u8(Y, U, V)
        else:
            out = N.s2d_u8(np.ascontiguousarray(resize_frame(N.yuv420_to_rgb(Y, U, V), self.resize_hw)))
        self._timed("tail", t0)
        return out, t

    def _next_yuv420(self):
        """Raw planar bytes out; decode work deferred to the device. 4K
        sources are box-downsampled per plane on the host (quarter the bytes
        shipped, native fp_plane_half); colour conversion stays on the card."""
        from playground3d_tpu_torch.data import native as N

        t0 = time.perf_counter()
        planes = self._read_planes()
        if planes is None:
            raise StopIteration
        Y, U, V = planes
        h, w = Y.shape
        th, tw = self.resize_hw
        t0 = self._timed("read", t0)
        # timestamps parse at native resolution, BEFORE any resize
        # (mp_loader.py order)
        t = self._parse_ts_planes(Y, U, V)
        t0 = self._timed("ts", t0)
        if (h, w) == (2 * th, 2 * tw):
            Y = N.plane_half(Y)
            U = N.plane_half(U)
            V = N.plane_half(V)
        elif (h, w) != (th, tw):
            raise RuntimeError(
                f"emit='yuv420' serves stored-size or exactly-2x frames only "
                f"({h}x{w} vs requested {self.resize_hw}); use emit='s2d_u8' "
                f"for other ratios"
            )
        out = np.concatenate([Y.ravel(), U.ravel(), V.ravel()])
        self._timed("tail", t0)
        return out, t

    def __next__(self):
        if self.emit == "yuv420":
            if not (self._backend in ("y4m", "lav") and self._planar_420()):
                raise RuntimeError(
                    "emit='yuv420' requires a 4:2:0 source (y4m or a "
                    "libav-decoded YUV420P stream)"
                )
            return self._next_yuv420()
        if (
            self.emit == "s2d_u8"
            and self._backend in ("y4m", "lav")
            and self._planar_420()
        ):
            return self._next_s2d_u8()
        t0 = time.perf_counter()
        raw = self._read_raw()
        if raw is None:
            raise StopIteration
        t0 = self._timed("read", t0)
        t = self._parse_ts_rgb(raw) if self.parse_ts else None
        t = self._fallback_ts(t)
        t0 = self._timed("ts", t0)
        frame = resize_frame(raw, self.resize_hw)
        if self.emit == "s2d_u8":
            from playground3d_tpu_torch.data import native as N

            out = N.s2d_u8(np.ascontiguousarray(frame))
        else:
            out = normalize_frame(frame)
        self._timed("tail", t0)
        return out, t


class PrefetchingSource(FrameSource):
    """Bounded-queue background-thread wrapper (target depth 5, matching the
    reference's worker queue, mp_loader.py:218)."""

    def __init__(self, source: FrameSource, depth: int = 5):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = False
        self._thread = threading.Thread(target=self._work, args=(source,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Stop-aware bounded put so close() can end a blocked producer."""
        while not self._stop:
            try:
                self.q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, source):
        try:
            for item in source:
                if not self._put(item):
                    return
        finally:
            self._put(self._done)

    def close(self):
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass

    def __next__(self):
        try:
            item = self.q.get(timeout=120)
        except queue.Empty:
            # a wedged source ends the stream instead of leaking
            # queue.Empty into the frame loop
            import sys

            print("PrefetchingSource: producer stalled >120s; ending stream", file=sys.stderr)
            raise StopIteration
        if item is self._done:
            raise StopIteration
        return item


# ---------------------------------------------------------------------------
# PNG I/O (stdlib-only; replaces the cv2.imwrite frame writer, mp_writer.py)
# ---------------------------------------------------------------------------


def encode_png(frame: np.ndarray) -> bytes:
    """Encode [H,W,3] uint8 (or float in [0,1]) as PNG bytes using zlib only."""
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    if frame.ndim == 2:
        frame = np.repeat(frame[:, :, None], 3, axis=2)
    h, w = frame.shape[:2]
    raw = b"".join(b"\x00" + frame[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, frame: np.ndarray) -> None:
    """Write [H,W,3] uint8 (or float in [0,1]) as PNG using zlib only."""
    with open(path, "wb") as f:
        f.write(encode_png(frame))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for files written by :func:`write_png`
    (8-bit RGB, no interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    out = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.uint16)
    for y in range(h):
        row = raw[y * stride : (y + 1) * stride]
        filt, body = row[0], np.frombuffer(row[1:], np.uint8).astype(np.uint16)
        if filt == 0:
            rec = body
        elif filt == 1:  # Sub
            rec = body.copy()
            for i in range(3, len(rec)):
                rec[i] = (rec[i] + rec[i - 3]) & 0xFF
        elif filt == 2:  # Up
            rec = (body + prev) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        prev = rec
        out[y] = rec.astype(np.uint8).reshape(w, 3)
    return out


class AsyncFrameWriter:
    """Queue-fed background PNG writer (reference OutputWriter,
    util_track/mp_writer.py:21-49). ``close()`` flushes and joins the
    worker, guaranteeing every submitted frame is fully written."""

    _DONE = object()

    def __init__(self, directory: str):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.q: queue.Queue = queue.Queue()
        self._n = 0
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def __call__(self, frame: np.ndarray) -> None:
        self.q.put((self._n, frame))
        self._n += 1

    def _work(self):
        while True:
            item = self.q.get()
            if item is self._DONE:
                return
            idx, frame = item
            write_png(os.path.join(self.directory, f"{idx:05d}.png"), frame)

    def close(self, timeout: float = 60.0) -> None:
        self.q.put(self._DONE)
        self._thread.join(timeout=timeout)
