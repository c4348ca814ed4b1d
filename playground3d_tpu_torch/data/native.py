"""ctypes bindings for the repo's native frame-preprocessing library
``native/framepipe.cc`` (port of ``playground3d_tpu/data/native.py``).

:class:`HostLibrary` compiles a source of ``native/`` with ``g++`` at first
use, with the flags of ``native/Makefile``, into
``playground3d_tpu_torch/_build/lib<name>-<digest>.so`` (the loader of
:mod:`playground3d_tpu_torch.ops.cuda_build`: the digest covers the source,
the flags and what ``-march=native`` resolves to on this host, and a build
renames a whole file into place, so processes that build at once are safe).
``native/`` itself is only read. A failed build raises with the compiler's
output; no function here falls back to numpy. The numpy twins are the plain
versions the tests hold the library to: :func:`resize_half_plain`,
:func:`box2_plane`, ``video.pack_s2d``, ``video.rgb_from_planes`` (the float
YUV converter) and ``timestamps.parse_frame_timestamp``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

from playground3d_tpu_torch.data.timestamps import TimestampGeometry, precomputed_checksums
from playground3d_tpu_torch.ops.cuda_build import build_library
from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread")


def _pkg_config(*args: str) -> subprocess.CompletedProcess:
    return subprocess.run(["pkg-config", *args], capture_output=True, text=True)


class HostLibrary:
    """One ``native/<source>`` -> ``_build/lib<name>-<digest>.so`` -> ctypes.

    ``pkgs`` are system libraries found through ``pkg-config``: the library
    is :meth:`available` only where ``pkg-config --exists`` finds all of them
    (as ``native/Makefile`` decides), and :meth:`load` raises where it does
    not. ``bind(lib)`` sets the exported functions' ``argtypes`` and
    ``restype`` once, when the library is first loaded."""

    def __init__(self, name: str, source: str, bind: Callable[[ctypes.CDLL], None], pkgs: Sequence[str] = ()):
        self.name = name
        self.source = NATIVE_DIR / source
        self.pkgs = tuple(pkgs)
        self.build_log = ""
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._found: Optional[bool] = None

    def available(self) -> bool:
        """Whether this host has the system libraries the source needs."""
        if self._found is None:
            self._found = not self.pkgs or (
                shutil.which("pkg-config") is not None and _pkg_config("--exists", *self.pkgs).returncode == 0
            )
        return self._found

    def build(self) -> Path:
        if not self.available():
            raise RuntimeError(f"{self.name}: pkg-config finds no {' '.join(self.pkgs)} on this host")
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"{self.name}: g++ not found (it builds {self.source})")
        cflags, libs = [], []
        if self.pkgs:
            cflags = _pkg_config("--cflags", *self.pkgs).stdout.split()
            libs = _pkg_config("--libs", *self.pkgs).stdout.split()
        # what -march=native means on this host, so another CPU builds its own
        target = subprocess.run([cxx, "-march=native", "-E", "-dM", "-x", "c++", os.devnull],
                                capture_output=True).stdout
        path, log = build_library(self.name, self.source, [cxx, *CXX_FLAGS, *cflags], libs, digest_extra=target)
        self.build_log = log or self.build_log
        return path

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i = ctypes.c_int
    for fn in (lib.fp_normalize, lib.fp_preprocess, lib.fp_preprocess_s2d):
        fn.argtypes = [u8p, f32p, i, i, f32p, f32p, i]
    lib.fp_resize_half.argtypes = [u8p, u8p, i, i]
    lib.fp_pack_s2d.argtypes = [f32p, f32p, i, i, i]
    for fn in (lib.fp_s2d_u8, lib.fp_preprocess_s2d_u8, lib.fp_plane_half):
        fn.argtypes = [u8p, u8p, i, i, i]
    for fn in (lib.fp_yuv420_to_rgb, lib.fp_yuv420_to_s2d_u8, lib.fp_yuv420_half_to_s2d_u8):
        fn.argtypes = [u8p, u8p, u8p, u8p, i, i, i]
    lib.fp_parse_timestamp.argtypes = [u8p] + [i] * 11 + [i32p, i32p]
    lib.fp_parse_timestamp.restype = i
    for fn in (lib.fp_resize_half, lib.fp_normalize, lib.fp_preprocess, lib.fp_preprocess_s2d, lib.fp_pack_s2d,
               lib.fp_s2d_u8, lib.fp_preprocess_s2d_u8, lib.fp_plane_half, lib.fp_yuv420_to_rgb,
               lib.fp_yuv420_to_s2d_u8, lib.fp_yuv420_half_to_s2d_u8):
        fn.restype = None


LIB = HostLibrary("framepipe", "framepipe.cc", _bind)


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a)  # the bound pointer types refuse any dtype but uint8


def native_available() -> bool:
    """Build and load the library (raises with the compiler's output if the
    build fails); True once it is loaded."""
    return LIB.load() is not None


def resize_half(frame: np.ndarray) -> np.ndarray:
    """[h,w,3] uint8 -> [h/2,w/2,3] uint8, 2x2 box filter."""
    h, w = frame.shape[:2]
    out = np.empty((h // 2, w // 2, 3), np.uint8)
    LIB.load().fp_resize_half(_u8(frame), out, h, w)
    return out


def resize_half_plain(frame: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`resize_half`: (a+b+c+d+2)>>2 per channel."""
    h, w = frame.shape[:2]
    f = frame[: h // 2 * 2, : w // 2 * 2].astype(np.uint16)
    out = (f[0::2, 0::2] + f[0::2, 1::2] + f[1::2, 0::2] + f[1::2, 1::2] + 2) >> 2
    return out.astype(np.uint8)


def _mean_std():
    return np.ascontiguousarray(IMAGENET_MEAN, np.float32), np.ascontiguousarray(IMAGENET_STD, np.float32)


def normalize(frame_u8: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """uint8 [h,w,3] -> ImageNet-normalized float32."""
    h, w = frame_u8.shape[:2]
    out = np.empty((h, w, 3), np.float32)
    LIB.load().fp_normalize(_u8(frame_u8), out, h, w, *_mean_std(), n_threads)
    return out


def preprocess(frame_u8: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """Fused 2x downsample + normalize: 4K uint8 -> 1080p normalized f32
    (the reference loader's resize+normalize, mp_loader.py:236-239)."""
    h, w = frame_u8.shape[:2]
    out = np.empty((h // 2, w // 2, 3), np.float32)
    LIB.load().fp_preprocess(_u8(frame_u8), out, h, w, *_mean_std(), n_threads)
    return out


def preprocess_s2d(frame_u8: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """Fused 2x downsample + normalize + space-to-depth(4x4) pack: 4K uint8
    -> [H/8, W/8, 48] normalized float32."""
    h, w = frame_u8.shape[:2]
    out = np.empty((h // 8, w // 8, 48), np.float32)
    LIB.load().fp_preprocess_s2d(_u8(frame_u8), out, h, w, *_mean_std(), n_threads)
    return out


def pack_s2d_native(frame_f32: np.ndarray, n_threads: int = 4) -> np.ndarray:
    """[H,W,3] float32 -> [H/4,W/4,48] float32 s2d packing."""
    h, w = frame_f32.shape[:2]
    out = np.empty((h // 4, w // 4, 48), np.float32)
    LIB.load().fp_pack_s2d(np.ascontiguousarray(frame_f32, np.float32), out, h, w, n_threads)
    return out


def s2d_u8(frame_u8: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """[H,W,3] uint8 -> [H/4,W/4,48] uint8 s2d pack (the frames travel
    uint8; the device's s2d stem normalizes)."""
    h, w = frame_u8.shape[:2]
    out = np.empty((h // 4, w // 4, 48), np.uint8)
    LIB.load().fp_s2d_u8(_u8(frame_u8), out, h, w, n_threads)
    return out


def preprocess_s2d_u8(frame_u8: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """Fused 2x box downsample + s2d pack, all uint8: 4K [H,W,3] ->
    [H/8,W/8,48]. Equals ``pack_s2d(resize_half(frame))`` exactly."""
    h, w = frame_u8.shape[:2]
    out = np.empty((h // 8, w // 8, 48), np.uint8)
    LIB.load().fp_preprocess_s2d_u8(_u8(frame_u8), out, h, w, n_threads)
    return out


def _yuv_call(fn, Y, U, V, out_shape, n_threads):
    h, w = Y.shape
    out = np.empty(out_shape, np.uint8)
    fn(_u8(Y), _u8(U), _u8(V), out, h, w, n_threads)
    return out


def yuv420_to_rgb(Y: np.ndarray, U: np.ndarray, V: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """BT.601 limited-range YUV420 planes -> [H,W,3] uint8 RGB; 16.16 fixed
    point, within +-1 LSB of the float converter ``video.rgb_from_planes``."""
    h, w = Y.shape
    return _yuv_call(LIB.load().fp_yuv420_to_rgb, Y, U, V, (h, w, 3), n_threads)


def yuv420_to_s2d_u8(Y: np.ndarray, U: np.ndarray, V: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """Fused y4m decode tail: YUV420 planes -> s2d-packed uint8
    [H/4,W/4,48] in one pass (no RGB frame materialized)."""
    h, w = Y.shape
    return _yuv_call(LIB.load().fp_yuv420_to_s2d_u8, Y, U, V, (h // 4, w // 4, 48), n_threads)


def yuv420_half_to_s2d_u8(Y: np.ndarray, U: np.ndarray, V: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """Fused 4K decode tail: full-size YUV420 planes -> exact 2x2 box
    downsample in YUV space -> RGB -> s2d-packed uint8 [H/8,W/8,48] in one
    pass. Bit-exact against ``yuv420_to_s2d_u8(box2(Y), box2(U), box2(V))``."""
    h, w = Y.shape
    return _yuv_call(LIB.load().fp_yuv420_half_to_s2d_u8, Y, U, V, (h // 8, w // 8, 48), n_threads)


def box2_plane(plane: np.ndarray) -> np.ndarray:
    """Exact 2x2 box average of one uint8 plane (numpy twin of
    :func:`plane_half`; (a+b+c+d+2)>>2 rounding)."""
    h, w = plane.shape
    p = plane[: h // 2 * 2, : w // 2 * 2].astype(np.uint16)
    return (
        (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + 2) >> 2
    ).astype(np.uint8)


def plane_half(plane: np.ndarray, n_threads: int = 1) -> np.ndarray:
    """2x2 box downsample of one 8-bit plane [h,w] -> [h/2,w/2] (the 4K
    ``emit='yuv420'`` feed: quarter-size planes go to the card, which does
    the colour conversion)."""
    h, w = plane.shape
    out = np.empty((h // 2, w // 2), np.uint8)
    LIB.load().fp_plane_half(_u8(plane), out, h, w, n_threads)
    return out


def parse_timestamp_native(frame_u8: np.ndarray, g: Optional[TimestampGeometry] = None) -> Optional[float]:
    """Native burned-in timestamp decode; None on a checksum mismatch (the
    numpy twin is ``timestamps.parse_frame_timestamp``)."""
    lib = LIB.load()
    g = g or TimestampGeometry()
    table = precomputed_checksums(g)
    checks = np.stack([table[str(d)].reshape(-1) for d in range(10)]).astype(np.int32)
    out = np.zeros(g.n, np.int32)
    h, w = frame_u8.shape[:2]
    rc = lib.fp_parse_timestamp(
        _u8(frame_u8), h, w, g.x0, g.y0, g.w, g.h, g.n,
        g.decimal_index, g.h13, g.h23, g.w12,
        np.ascontiguousarray(checks), out,
    )
    if rc != 0:
        return None
    return float("".join("." if d < 0 else str(d) for d in out))
