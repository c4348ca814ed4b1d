"""ctypes bindings for the repo's libav shim ``native/avdecode.cc`` (port of
``playground3d_tpu/data/avdecode.py``).

Compressed-video ingest (the reference reads its .mp4 recordings through
``cv2.VideoCapture``, util_track/mp_loader.py:90, 213) over the system
FFmpeg libraries. The shim is built with ``g++`` at first use into
``playground3d_tpu_torch/_build/`` by :class:`~playground3d_tpu_torch.data.
native.HostLibrary`, and only where ``pkg-config --exists`` finds
libavformat, libavcodec, libavutil and libswscale, as ``native/Makefile``
decides. :func:`available` says whether this host has them: a host
capability that decides whether ``.mp4`` can be read at all. Where they
exist and the build fails, it raises.

Decoded YUV420 planes feed the same fused framepipe tails as the y4m reader.
The writer produces real H.264 (libx264) or MPEG-4 files for tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from playground3d_tpu_torch.data.native import HostLibrary

AV_PKGS = ("libavformat", "libavcodec", "libavutil", "libswscale")


def _bind(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    dp = ctypes.POINTER(ctypes.c_double)
    lib.avd_open.argtypes = [ctypes.c_char_p]
    lib.avd_open.restype = ctypes.c_void_p
    lib.avd_close.argtypes = [ctypes.c_void_p]
    lib.avd_close.restype = None
    for f in (lib.avd_width, lib.avd_height, lib.avd_is_yuv420):
        f.argtypes = [ctypes.c_void_p]
        f.restype = ctypes.c_int
    lib.avd_fps.argtypes = [ctypes.c_void_p]
    lib.avd_fps.restype = ctypes.c_double
    lib.avd_nframes.argtypes = [ctypes.c_void_p]
    lib.avd_nframes.restype = ctypes.c_int64
    lib.avd_codec_name.argtypes = [ctypes.c_void_p]
    lib.avd_codec_name.restype = ctypes.c_char_p
    lib.avd_next_rgb.argtypes = [ctypes.c_void_p, u8p, dp]
    lib.avd_next_rgb.restype = ctypes.c_int
    lib.avd_next_yuv420.argtypes = [ctypes.c_void_p, u8p, u8p, u8p, dp]
    lib.avd_next_yuv420.restype = ctypes.c_int
    lib.avd_writer_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.avd_writer_open.restype = ctypes.c_void_p
    lib.avd_writer_add_rgb.argtypes = [ctypes.c_void_p, u8p]
    lib.avd_writer_add_rgb.restype = ctypes.c_int
    lib.avd_writer_close.argtypes = [ctypes.c_void_p]
    lib.avd_writer_close.restype = ctypes.c_int
    for f in (lib.avd_has_decoder, lib.avd_has_encoder):
        f.argtypes = [ctypes.c_char_p]
        f.restype = ctypes.c_int


LIB = HostLibrary("avdecode", "avdecode.cc", _bind, pkgs=AV_PKGS)


def available() -> bool:
    """True where this host has the FFmpeg libraries (the shim is then
    built on first use, and a failed build raises)."""
    return LIB.available()


def has_decoder(name: str) -> bool:
    return available() and bool(LIB.load().avd_has_decoder(name.encode()))


def has_encoder(name: str) -> bool:
    return available() and bool(LIB.load().avd_has_encoder(name.encode()))


class AvReader:
    """Iterate decoded frames of any libav-supported container/codec."""

    def __init__(self, path: str):
        lib = LIB.load()
        self._lib = lib
        self._h = lib.avd_open(os.fspath(path).encode())
        if not self._h:
            raise IOError(f"libav could not open {path!r}")
        self.width = lib.avd_width(self._h)
        self.height = lib.avd_height(self._h)
        self.fps = lib.avd_fps(self._h)
        self.nframes = int(lib.avd_nframes(self._h))  # container estimate, -1 unknown
        self.codec = lib.avd_codec_name(self._h).decode()
        # from the container's codec parameters, confirmed or corrected by
        # the first decoded frame's format
        self.is_yuv420: bool = bool(lib.avd_is_yuv420(self._h))

    def read_rgb(self) -> Optional[Tuple[np.ndarray, float]]:
        """Next frame as RGB24 [H,W,3] uint8 + pts seconds, or None at EOF."""
        out = np.empty((self.height, self.width, 3), np.uint8)
        pts = ctypes.c_double(-1.0)
        ret = self._lib.avd_next_rgb(self._h, out, ctypes.byref(pts))
        if ret == 0:
            return None
        if ret < 0:
            raise IOError(f"libav decode error {ret}")
        return out, float(pts.value)

    def read_planes(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, float]]:
        """Next frame as YUV420 planes (Y [H,W], U/V [ceil(H/2),ceil(W/2)])
        + pts seconds; None at EOF. Raises ValueError if the stream is not
        4:2:0 planar (use :meth:`read_rgb`)."""
        h, w = self.height, self.width
        ch, cw = (h + 1) // 2, (w + 1) // 2
        Y = np.empty((h, w), np.uint8)
        U = np.empty((ch, cw), np.uint8)
        V = np.empty((ch, cw), np.uint8)
        pts = ctypes.c_double(-1.0)
        ret = self._lib.avd_next_yuv420(self._h, Y, U, V, ctypes.byref(pts))
        if ret == 0:
            return None
        if ret == 2:
            self.is_yuv420 = False
            raise ValueError("stream is not YUV420P; use read_rgb()")
        if ret < 0:
            raise IOError(f"libav decode error {ret}")
        self.is_yuv420 = True
        return Y, U, V, float(pts.value)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.avd_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - gc ordering
        try:
            self.close()
        except Exception:
            pass


class AvWriter:
    """Encode RGB frames to a compressed video (mp4/H.264 by default)."""

    def __init__(self, path: str, width: int, height: int, fps: int = 30,
                 codec: Optional[str] = None, crf: int = 18):
        lib = LIB.load()
        if codec is None:
            codec = "libx264" if lib.avd_has_encoder(b"libx264") else "mpeg4"
        self._lib = lib
        self.codec = codec
        self._h = lib.avd_writer_open(os.fspath(path).encode(), width, height, fps, codec.encode(), crf)
        if not self._h:
            raise IOError(f"libav could not open encoder {codec!r} for {path!r}")
        self.width, self.height = width, height

    def add(self, rgb: np.ndarray) -> None:
        rgb = np.ascontiguousarray(rgb, np.uint8)
        if rgb.shape != (self.height, self.width, 3):
            raise ValueError(f"frame shape {rgb.shape} != {(self.height, self.width, 3)}")
        ret = self._lib.avd_writer_add_rgb(self._h, rgb)
        if ret < 0:
            raise IOError(f"libav encode error {ret}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            ret = self._lib.avd_writer_close(self._h)
            self._h = None
            if ret < 0:
                raise IOError(f"libav finalize error {ret}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # pragma: no cover - gc ordering
        try:
            self.close()
        except Exception:
            pass
