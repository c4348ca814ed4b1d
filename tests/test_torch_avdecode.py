"""Compressed-video ingest in the port: ``native/avdecode.cc`` built by
``playground3d_tpu_torch/data/avdecode.py`` into the port's ``_build/``,
against the JAX package's reader of the same shim on the same files (the
cases of ``tests/test_avdecode.py``). Every test skips where this host has
no FFmpeg libraries (``avdecode.available()``, decided inside a fixture).

Tolerances: the two readers decode the same bitstream through the same
libav and are equal; decoded frames are within the lossy codec's error of
what was encoded (mean below 4 levels); burned timestamps survive the codec
(within 5e-3 s); the two feed layouts agree within 2 levels (the fixed-point
host tail against the float converter, on a lossy decode). The JAX reader's
library is loaded through ``test_torch_jax_native``, which builds it whole
where another test process left it missing or half written.
"""

import numpy as np
import pytest
import torch

from playground3d_tpu_torch.data import avdecode as A
from playground3d_tpu_torch.data.synthetic import SyntheticScene
from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
from playground3d_tpu_torch.data.video import SyntheticVideoSource, VideoFrameSource, pack_s2d, rgb_from_planes
from test_torch_jax_native import jax_library, jax_video

torch.set_num_threads(1)

T0 = 1.6e9


@pytest.fixture(autouse=True)
def libav():
    if not A.available():
        pytest.skip("pkg-config finds no FFmpeg libraries on this host")


def _gradient_frames(n=16, h=96, w=128):
    frames = []
    for i in range(n):
        f = np.zeros((h, w, 3), np.uint8)
        f[:, :, 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        f[:, :, 1] = (i * 12) % 256
        f[h // 4: h // 2, w // 4: w // 2, 2] = 200
        frames.append(f)
    return frames


def _rendered(n, h, w, cam=0, seed=3):
    reg, ranges, _, _ = toy_camera_chain(2)
    scene = SyntheticScene(n_objects=4, seed=seed)
    src = SyntheticVideoSource(scene, reg.P[cam, 0], n_frames=n, t0=T0, height=h, width=w,
                               normalized=False, burn_timestamp=True)
    return [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f, _ in src]


def _mp4(path, frames, **kw):
    h, w = frames[0].shape[:2]
    with A.AvWriter(path, w, h, fps=30, **kw) as wr:
        for f in frames:
            wr.add(f)
    return path


def test_h264_capability_registered():
    assert A.has_decoder("h264") and A.has_decoder("mpeg4") and A.has_decoder("hevc")
    assert A.LIB.build().name.startswith("libavdecode-")


@pytest.mark.parametrize("codec", ["libx264", "mpeg4"])
def test_encode_decode_roundtrip(tmp_path, codec):
    """Every frame comes back, in order, at the right rate, close to what
    was encoded, and equal to the JAX package's reader."""
    from playground3d_tpu.data import avdecode as JA

    jax_library(JA)
    if not A.has_encoder(codec):
        pytest.skip(f"no {codec} encoder in this libav build")
    frames = _gradient_frames()
    path = _mp4(str(tmp_path / f"clip_{codec}.mp4"), frames, codec=codec)
    r, jr = A.AvReader(path), JA.AvReader(path)
    assert (r.width, r.height, r.codec) == (128, 96, jr.codec) and abs(r.fps - 30.0) < 0.01
    n, last_pts = 0, -1.0
    while True:
        out, jout = r.read_rgb(), jr.read_rgb()
        if out is None:
            assert jout is None
            break
        (rgb, pts), (jrgb, jpts) = out, jout
        assert pts > last_pts and pts == jpts
        last_pts = pts
        np.testing.assert_array_equal(rgb, jrgb)
        assert np.abs(rgb.astype(int) - frames[n].astype(int)).mean() < 4.0
        n += 1
    r.close()
    jr.close()
    assert n == len(frames)
    assert last_pts == pytest.approx(15 / 30.0, abs=1e-6)


def test_planar_yuv420_path(tmp_path):
    path = _mp4(str(tmp_path / "p.mp4"), _gradient_frames(n=6))
    r = A.AvReader(path)
    assert r.is_yuv420
    n = 0
    while (out := r.read_planes()) is not None:
        Y, U, V, _pts = out
        assert Y.shape == (96, 128) and U.shape == (48, 64) and V.shape == (48, 64)
        n += 1
    r.close()
    assert n == 6


def test_video_frame_source_h264_with_timestamps(tmp_path):
    JaxSource = jax_video().VideoFrameSource

    path = _mp4(str(tmp_path / "clip.mp4"), _rendered(8, 128, 512), crf=12)
    src = VideoFrameSource(path, resize_hw=(64, 256))
    assert src._backend == "lav"
    mine, theirs = list(src), list(JaxSource(path, resize_hw=(64, 256)))
    assert len(mine) == len(theirs) == 8
    for i, ((f, t), (jf, jt)) in enumerate(zip(mine, theirs)):
        assert f.shape == (64, 256, 3) and t == jt
        np.testing.assert_allclose(t, T0 + i / 30.0, atol=5e-3)
        np.testing.assert_array_equal(f, jf)


def test_video_frame_source_h264_s2d_and_yuv420(tmp_path):
    """Both feed layouts straight from the H.264 stream's YUV420P planes,
    at the stored size and from 2x it, with the burned timestamps."""
    path = _mp4(str(tmp_path / "s.mp4"), _rendered(5, 128, 512), crf=12)
    for hw in ((128, 512), (64, 256)):
        s2d = list(VideoFrameSource(path, resize_hw=hw, emit="s2d_u8"))
        yuv = list(VideoFrameSource(path, resize_hw=hw, emit="yuv420"))
        assert len(s2d) == len(yuv) == 5
        h, w = hw
        for i, ((frame, t), (flat, ty)) in enumerate(zip(s2d, yuv)):
            assert frame.shape == (h // 4, w // 4, 48) and flat.shape == (h * w * 3 // 2,)
            assert t == ty and t == pytest.approx(T0 + i / 30.0, abs=5e-3)
        Y = yuv[0][0][: h * w].reshape(h, w)
        U = yuv[0][0][h * w: h * w + h * w // 4].reshape(h // 2, w // 2)
        V = yuv[0][0][h * w + h * w // 4:].reshape(h // 2, w // 2)
        np.testing.assert_allclose(pack_s2d(rgb_from_planes(Y, U, V)).astype(int), s2d[0][0].astype(int), atol=2)


def test_session_mode_h264_mp4_end_to_end(tmp_path):
    """``--mode session`` over H.264 .mp4 segments in the reference's
    default layout (``record_{cam}_%05d.mp4``): discovery, libav decode,
    the clip tracker on the CPU, the CSV with the burned timestamps."""
    from playground3d_tpu_torch.apps import track
    from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv

    reg, ranges, _, _ = toy_camera_chain(2)
    root = tmp_path / "session"
    (root / "recording").mkdir(parents=True)
    (root / "_SESSION_CONFIG.config").write_text("".join(f"__CAMERA__\nname == {c}\n" for c in ranges))
    (root / "_SESSION_INFO.txt").write_text("SESSION #1\n")
    for ci, cam in enumerate(ranges):
        frames = _rendered(6, 64, 256, cam=ci)
        for seg in range(2):
            _mp4(str(root / "recording" / f"record_{cam}_{seg:05d}.mp4"), frames[seg * 3:(seg + 1) * 3], crf=12)
    reg_path = str(tmp_path / "registry.npz")
    reg.save(reg_path)
    out = str(tmp_path / "out.csv")
    stats = track.main(["--mode", "session", "--session-dir", str(root), "--registry", reg_path, "--depth", "18",
                        "--frames", "6", "--clip-len", "3", "--det-step", "1", "--height", "64", "--width", "256",
                        "--emit", "s2d_u8", "--out", out, "--device", "cpu"])
    assert stats["frames"] == 6 and stats["ts"] > 0
    headers, _ = load_i24_csv(out)
    assert headers[0] == "Frame #"
