"""The port's host I/O (``playground3d_tpu_torch/data/video.py``) against the
JAX package's ``data/video.py`` on the same files: the y4m codec, every emit
of ``VideoFrameSource`` at the stored size and from 2x the requested size
(the 4K -> 1080p case, scaled down), burned-in timestamps parsed at the
native size, ``resize_frame``, the PNG codec, ``ImageDirSource``,
``PrefetchingSource`` and ``AsyncFrameWriter``, and the ffmpeg-pipe backend
with stub binaries.

Tolerances: bytes written (y4m, PNG) are equal; frames from the float paths
(``emit='f32'``, the y4m reader) and from the planar bytes
(``emit='yuv420'``) are equal; ``emit='s2d_u8'`` is within 1 LSB of JAX,
whose host tail is the native fixed-point one where its library loaded and
its float converter where it did not (``tests/test_native.py:81-90``), and
equal to the port's own numpy composition. Timestamps are equal to JAX's and
within 5e-3 s of the burned ones.

The JAX package's ``data.video`` builds ``native/`` when it is imported, so
it is imported inside the tests, never while this module is collected, and
through ``test_torch_jax_native.jax_video``, which makes the JAX package's
host libraries whole first (test processes that build them at once leave the
JAX loaders on their fallback paths).
"""

import os
import stat

import numpy as np
import pytest
import torch

from playground3d_tpu_torch.data import native as N
from playground3d_tpu_torch.data import video as V
from playground3d_tpu_torch.data.synthetic import SyntheticScene
from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
from test_torch_jax_native import jax_video

torch.set_num_threads(1)

T0 = 1.6e9


def _jv():
    return jax_video()


def _rendered(n, h, w, seed=3):
    """uint8 frames of a synthetic scene with burned-in timestamps."""
    reg, ranges, _, _ = toy_camera_chain(1)
    lo, hi = ranges["p1c1"]
    scene = SyntheticScene(n_objects=4, seed=seed, x_spawn=(lo + 20, hi - 20), x_visible=(lo, hi))
    src = V.SyntheticVideoSource(scene, reg.P[0, 0], n_frames=n, t0=T0, height=h, width=w,
                                 normalized=False, burn_timestamp=True)
    return [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f, _ in src]


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two y4m recordings with burned timestamps: 'stored' at the requested
    64x256 and '2x' at 128x512 (both wide enough for the timestamp strip)."""
    d = tmp_path_factory.mktemp("clips")
    out = {}
    for name, hw in (("stored", (64, 256)), ("2x", (128, 512))):
        path = str(d / f"{name}.y4m")
        V.write_y4m(path, _rendered(5, *hw))
        out[name] = path
    return out


def test_decoder_probe_order_follows_jax():
    from playground3d_tpu_torch.data import avdecode

    got = V.decoder()
    if avdecode.available():
        assert got == "lav"
    assert got == _jv().DECODER


@pytest.mark.parametrize("subsample", [True, False])
def test_write_y4m_bytes_equal_jax(tmp_path, subsample):
    frames = [np.random.default_rng(i).integers(0, 256, (34, 50, 3), dtype=np.uint8) for i in range(3)]
    p, j = str(tmp_path / "p.y4m"), str(tmp_path / "j.y4m")
    V.write_y4m(p, frames, fps=25, subsample=subsample)
    _jv().write_y4m(j, frames, fps=25, subsample=subsample)
    assert open(p, "rb").read() == open(j, "rb").read()


def test_y4m_reader_equals_jax_and_round_trips(tmp_path):
    frames = [np.random.default_rng(i).integers(0, 256, (64, 96, 3), dtype=np.uint8) for i in range(3)]
    for subsample, tol in ((False, 4), (True, None)):
        path = str(tmp_path / f"rt{subsample}.y4m")
        V.write_y4m(path, frames, subsample=subsample)
        mine, theirs = V._Y4MReader(path), _jv()._Y4MReader(path)
        for want in frames:
            got = mine.read()
            np.testing.assert_array_equal(got, theirs.read())
            if tol is not None:  # C444 loses only the range quantization
                assert np.abs(got.astype(int) - want.astype(int)).max() <= tol
        assert mine.read() is None and theirs.read() is None
        mine.close()
        theirs.close()


def _both(path, hw, emit):
    mine = list(V.VideoFrameSource(path, resize_hw=hw, emit=emit))
    theirs = list(_jv().VideoFrameSource(path, resize_hw=hw, emit=emit))
    assert len(mine) == len(theirs) == 5
    return mine, theirs


@pytest.mark.parametrize("size", ["stored", "2x"])
@pytest.mark.parametrize("emit", ["f32", "s2d_u8", "yuv420"])
def test_video_source_emits_match_jax(clips, size, emit):
    mine, theirs = _both(clips[size], (64, 256), emit)
    shape = {"f32": (64, 256, 3), "s2d_u8": (16, 64, 48), "yuv420": (64 * 256 * 3 // 2,)}[emit]
    for i, ((f, t), (jf, jt)) in enumerate(zip(mine, theirs)):
        assert f.shape == shape and f.dtype == jf.dtype
        assert t == jt and t == pytest.approx(T0 + i / 30.0, abs=5e-3)
        if emit == "s2d_u8":
            assert np.abs(f.astype(int) - jf.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(f, jf)


def test_s2d_u8_from_2x_is_the_fused_tail(clips):
    rd = V._Y4MReader(clips["2x"])
    for f, _t in V.VideoFrameSource(clips["2x"], resize_hw=(64, 256), emit="s2d_u8"):
        half = [N.box2_plane(p) for p in rd.read_planes()]
        np.testing.assert_array_equal(f, N.yuv420_to_s2d_u8(*half))
        float_ref = V.pack_s2d(V.rgb_from_planes(*half))
        assert np.abs(f.astype(int) - float_ref.astype(int)).max() <= 1


def test_timestamps_parse_at_native_size_before_the_resize(clips):
    """From the 2x recording, every emit parses the burned timestamp from
    the full-size frame; the stage timers count each frame's work."""
    for emit in ("f32", "s2d_u8", "yuv420"):
        src = V.VideoFrameSource(clips["2x"], resize_hw=(64, 256), emit=emit)
        times = [t for _f, t in src]
        np.testing.assert_allclose(times, T0 + np.arange(5) / 30.0, atol=5e-3)
        assert all(src.timers[k] > 0 for k in ("read", "ts", "tail")), src.timers
    # a source without a strip falls back to the previous time + 1/30
    src = V.VideoFrameSource(clips["2x"], resize_hw=(64, 256), parse_ts=False, emit="yuv420")
    np.testing.assert_allclose([t for _f, t in src], np.arange(5) / 30.0)


def test_resize_frame_matches_jax():
    f = np.random.default_rng(1).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    for hw in ((32, 48), (30, 40), (64, 96)):
        np.testing.assert_array_equal(V.resize_frame(f, hw), _jv().resize_frame(f, hw))
    const = V.resize_frame(np.full((64, 96, 3), 200, np.uint8), (30, 40))
    assert np.all(const == 200)


def test_png_codec_equals_jax(tmp_path):
    img = np.random.default_rng(1).integers(0, 255, (37, 53, 3), dtype=np.uint8)
    assert V.encode_png(img) == _jv().encode_png(img)
    gray = np.random.default_rng(2).random((9, 11)).astype(np.float32)
    assert V.encode_png(gray) == _jv().encode_png(gray)
    p = str(tmp_path / "x.png")
    _jv().write_png(p, img)
    np.testing.assert_array_equal(V.read_png(p), img)
    V.write_png(p, img)
    np.testing.assert_array_equal(_jv().read_png(p), img)


def test_image_dir_source_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    np.save(str(tmp_path / "f000.npy"), rng.random((8, 8, 3)).astype(np.float32))
    np.savez(str(tmp_path / "f001.npz"), frame=rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    V.write_png(str(tmp_path / "f002.png"), rng.integers(0, 256, (8, 8, 3), dtype=np.uint8))
    (tmp_path / "notes.txt").write_text("skipped")
    for normalized in (True, False):
        mine = list(V.ImageDirSource(str(tmp_path), fps=10.0, t0=5.0, normalized=normalized))
        theirs = list(_jv().ImageDirSource(str(tmp_path), fps=10.0, t0=5.0, normalized=normalized))
        assert len(mine) == len(theirs) == 3
        for (f, t), (jf, jt) in zip(mine, theirs):
            assert t == jt
            np.testing.assert_array_equal(f, jf)


def test_prefetching_source_yields_in_order_and_closes(clips):
    direct = list(V.VideoFrameSource(clips["stored"], resize_hw=(64, 256), emit="yuv420"))
    pre = list(V.PrefetchingSource(V.VideoFrameSource(clips["stored"], resize_hw=(64, 256), emit="yuv420"), depth=2))
    assert len(pre) == len(direct) == 5
    for (a, ta), (b, tb) in zip(pre, direct):
        assert ta == tb
        np.testing.assert_array_equal(a, b)

    def endless():
        i = 0
        while True:
            yield np.zeros(4), float(i)
            i += 1

    src = V.PrefetchingSource(endless(), depth=2)
    assert next(src)[1] == 0.0
    src.close()  # the producer blocked on a full queue must end
    src._thread.join(timeout=5)
    assert not src._thread.is_alive()


def test_async_frame_writer_matches_jax_pngs(tmp_path):
    frames = [np.full((8, 8, 3), i / 4, np.float32) for i in range(3)]
    w, jw = V.AsyncFrameWriter(str(tmp_path / "p")), _jv().AsyncFrameWriter(str(tmp_path / "j"))
    for f in frames:
        w(f)
        jw(f)
    w.close(timeout=30)
    jw.close(timeout=30)
    assert not w._thread.is_alive()
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) == ["00000.png", "00001.png", "00002.png"]
    for n in names:
        assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()


def test_ffmpeg_pipe_backend_with_stub_binary(tmp_path, monkeypatch):
    """The ffmpeg-pipe backend without a codec: a stub ``ffmpeg`` streams raw
    RGB24 frames over stdout (what ``-f rawvideo -pix_fmt rgb24`` emits) and
    a stub ``ffprobe`` reports the stream's size; timestamps parse at the
    native size before the resize."""
    frames = _rendered(4, 128, 512)
    (tmp_path / "frames.raw").write_bytes(b"".join(f.tobytes() for f in frames))
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "ffmpeg").write_text(f"#!/bin/sh\nexec cat '{tmp_path}/frames.raw'\n")
    (bindir / "ffprobe").write_text("#!/bin/sh\necho 512,128\n")
    for p in (bindir / "ffmpeg", bindir / "ffprobe"):
        p.chmod(p.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    monkeypatch.setenv("PATH", str(bindir) + os.pathsep + os.environ["PATH"])
    monkeypatch.setattr(V, "decoder", lambda: "ffmpeg")

    src = V.VideoFrameSource(str(tmp_path / "clip.mp4"), resize_hw=(64, 256))
    assert src._backend == "ffmpeg"
    out = list(src)
    assert len(out) == 4
    for i, (frame, t) in enumerate(out):
        assert frame.shape == (64, 256, 3)
        np.testing.assert_allclose(t, T0 + i / 30.0, atol=5e-3)
        np.testing.assert_array_equal(frame, V.normalize_frame(V.resize_frame(frames[i], (64, 256))))
    src._proc.wait(timeout=10)


def test_video_source_refuses_bad_emits(clips):
    with pytest.raises(ValueError, match="emit"):
        V.VideoFrameSource(clips["stored"], emit="rgb")
    rgb444 = clips["stored"].replace(".y4m", "_444.y4m")
    V.write_y4m(rgb444, _rendered(1, 64, 256), subsample=False)
    with pytest.raises(RuntimeError, match="4:2:0"):
        next(iter(V.VideoFrameSource(rgb444, resize_hw=(64, 256), emit="yuv420")))
    # 4:4:4 still serves s2d_u8 through the RGB path
    f, t = next(iter(V.VideoFrameSource(rgb444, resize_hw=(64, 256), emit="s2d_u8")))
    assert f.shape == (16, 64, 48) and t == pytest.approx(T0, abs=5e-3)
