"""The port's native frame-preprocessing library (``native/framepipe.cc``
built by ``playground3d_tpu_torch/data/native.py`` into the port's
``_build/``) against its numpy twins and the JAX package's numpy functions:
the cases of ``tests/test_native.py``, on the port's library.

Tolerances are the JAX package's own: integer outputs of the uint8 paths
are equal bit for bit (box filters, s2d packing, the fused tails against
their two-step compositions, the SIMD body against the scalar tail at odd
widths); the 16.16 fixed-point YUV converter is within 1 LSB of the float
converter (``tests/test_native.py:81-90``); the float normalizers within
1e-5 (and the fused 4K one within the half-LSB its pre-quantization average
saves). A failed build raises with the compiler's output.

The JAX package's ``data.native`` and ``data.video`` run ``make`` in
``native/`` when they load, so they are imported inside the tests that
need them, never while this module is collected.
"""

import numpy as np
import pytest
import torch

from playground3d_tpu_torch.data import native as N
from playground3d_tpu_torch.data.timestamps import encode_timestamp, parse_frame_timestamp
from playground3d_tpu_torch.data.video import VideoFrameSource, _Y4MReader, pack_s2d, rgb_from_planes, write_y4m
from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD
from test_torch_jax_native import jax_video

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jax_host_libraries():
    """The JAX package's host libraries whole and ``data.video``'s decoder
    probed with them (``test_torch_jax_native``): JAX's host tail follows
    them, and test processes that build them at once leave its loaders on
    their fallback paths."""
    jax_video()


@pytest.fixture(scope="module")
def frame4k():
    return np.random.default_rng(0).integers(0, 255, (432, 768, 3), dtype=np.uint8)


def _planes(rng, h, w):
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return (rng.integers(0, 256, (h, w), dtype=np.uint8), rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8))


def test_library_builds_into_the_ports_build_dir():
    from playground3d_tpu_torch.ops.cuda_build import BUILD_DIR

    assert N.native_available()
    path = N.LIB.build()
    assert path.parent == BUILD_DIR and path.name.startswith("libframepipe-") and path.exists()
    assert N.LIB.source == N.NATIVE_DIR / "framepipe.cc"


def test_failed_build_raises_with_the_compilers_output(tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    lib = N.HostLibrary("broken_for_test", "framepipe.cc", lambda lib: None)
    lib.source = bad
    with pytest.raises(RuntimeError, match="undeclared_name"):
        lib.load()
    with pytest.raises(RuntimeError, match="pkg-config finds no"):
        N.HostLibrary("absent", "avdecode.cc", lambda lib: None, pkgs=("no-such-package-xyz",)).load()


def test_resize_half_matches_numpy(frame4k):
    half = N.resize_half(frame4k)
    f = frame4k.astype(np.uint16)
    ref = ((f[0::2, 0::2] + f[0::2, 1::2] + f[1::2, 0::2] + f[1::2, 1::2] + 2) >> 2).astype(np.uint8)
    np.testing.assert_array_equal(half, ref)
    np.testing.assert_array_equal(half, N.resize_half_plain(frame4k))


def test_normalize_matches_numpy(frame4k):
    half = N.resize_half(frame4k)
    ref = (half.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    np.testing.assert_allclose(N.normalize(half), ref, atol=1e-5)


def test_fused_preprocess(frame4k):
    half = N.resize_half(frame4k)
    ref = (half.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    # the fused path averages before quantization: it differs by at most the
    # 0.5 LSB rounding of the two-step path
    np.testing.assert_allclose(N.preprocess(frame4k), ref, atol=0.5 / 255.0 / IMAGENET_STD.min() + 1e-5)
    np.testing.assert_allclose(N.preprocess_s2d(frame4k), pack_s2d(N.preprocess(frame4k)), atol=1e-6)
    f32 = N.normalize(half)
    np.testing.assert_array_equal(N.pack_s2d_native(f32), pack_s2d(f32))


def test_native_timestamp_decode():
    burned = encode_timestamp(np.zeros((256, 512, 3), np.uint8), 1623877088.77)
    got = N.parse_timestamp_native(burned)
    assert got == pytest.approx(1623877088.77, abs=0.005)
    assert got == parse_frame_timestamp(burned)[0]
    burned[16:44, 48:64] = 170  # a corrupted digit
    assert N.parse_timestamp_native(burned) is None
    assert parse_frame_timestamp(burned)[0] is None


def test_s2d_u8_matches_pack(frame4k):
    from playground3d_tpu.data.video import pack_s2d as jax_pack_s2d

    np.testing.assert_array_equal(N.s2d_u8(frame4k), pack_s2d(frame4k))
    np.testing.assert_array_equal(pack_s2d(frame4k), jax_pack_s2d(frame4k))


def test_preprocess_s2d_u8_exact(frame4k):
    np.testing.assert_array_equal(N.preprocess_s2d_u8(frame4k), pack_s2d(N.resize_half_plain(frame4k)))


def test_yuv420_to_rgb_matches_float_decoder():
    from playground3d_tpu.data.video import VideoFrameSource as JaxSource

    Y, U, V = _planes(np.random.default_rng(3), 216, 384)
    w = 384
    got = N.yuv420_to_rgb(Y, U, V)
    ref = rgb_from_planes(Y, U, V)
    np.testing.assert_array_equal(ref, JaxSource._rgb_from_planes(Y, U, V))
    # 16.16 fixed point vs float32: at most 1 LSB apart
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    # a width off the SIMD multiple runs the scalar tail; it must agree with
    # the SIMD body (-march=native builds the AVX-512 body where the CPU has it)
    got2 = N.yuv420_to_rgb(Y[:, : w - 10], U[:, : (w - 10) // 2], V[:, : (w - 10) // 2])
    np.testing.assert_array_equal(got2, got[:, : w - 10])


def test_yuv420_to_s2d_u8_fused_equals_two_step():
    Y, U, V = _planes(np.random.default_rng(4), 216, 384)
    np.testing.assert_array_equal(N.yuv420_to_s2d_u8(Y, U, V), pack_s2d(N.yuv420_to_rgb(Y, U, V)))


def test_yuv420_half_to_s2d_u8_equals_downsampled_planes():
    """The fused 4K tail equals the stored-size tail on box-downsampled
    planes, at even sizes and at odd luma extents (ceil chroma strides)."""
    rng = np.random.default_rng(6)
    for h, w in [(432, 768), (216, 368), (104, 200), (104, 201), (105, 201)]:
        Y, U, V = _planes(rng, h, w)
        ref = N.yuv420_to_s2d_u8(N.box2_plane(Y), N.box2_plane(U), N.box2_plane(V))
        np.testing.assert_array_equal(N.yuv420_half_to_s2d_u8(Y, U, V), ref)


def test_plane_half_matches_numpy_twin():
    from playground3d_tpu.data.native import box2_plane as jax_box2

    rng = np.random.default_rng(8)
    for h, w in [(256, 512), (216, 368), (34, 66), (7, 9)]:
        p = rng.integers(0, 256, (h, w), dtype=np.uint8)
        got = N.plane_half(p)
        assert got.shape == (h // 2, w // 2)
        np.testing.assert_array_equal(got, N.box2_plane(p))
        np.testing.assert_array_equal(got, jax_box2(p))


def _y4m(tmp_path, name, hw, n, seed):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for _ in range(n)]
    path = str(tmp_path / name)
    write_y4m(path, frames)
    return path


def test_video_source_4k_yuv420_emit_ships_quarter_planes(tmp_path):
    path = _y4m(tmp_path, "t4k_yuv.y4m", (128, 192), 2, 9)
    out = list(VideoFrameSource(path, resize_hw=(64, 96), parse_ts=False, emit="yuv420"))
    assert len(out) == 2
    rd = _Y4MReader(path)
    for flat, _t in out:
        assert flat.shape == (64 * 96 * 3 // 2,) and flat.dtype == np.uint8
        Y, U, V = rd.read_planes()
        ref = np.concatenate([N.box2_plane(Y).ravel(), N.box2_plane(U).ravel(), N.box2_plane(V).ravel()])
        np.testing.assert_array_equal(flat, ref)


def test_video_source_4k_y4m_uses_fused_half_tail(tmp_path):
    path = _y4m(tmp_path, "t4k.y4m", (128, 192), 2, 7)
    out = [f for f, _ in VideoFrameSource(path, resize_hw=(64, 96), parse_ts=False, emit="s2d_u8")]
    assert len(out) == 2 and out[0].shape == (16, 24, 48) and out[0].dtype == np.uint8
    rd = _Y4MReader(path)
    for f in out:
        Y, U, V = rd.read_planes()
        np.testing.assert_array_equal(f, N.yuv420_to_s2d_u8(N.box2_plane(Y), N.box2_plane(U), N.box2_plane(V)))


def test_video_source_emit_s2d_u8(tmp_path):
    """emit='s2d_u8' is within 1 LSB (the fixed-point decode) of packing the
    f32 path's frame, de-normalized."""
    path = _y4m(tmp_path, "t.y4m", (64, 96), 3, 5)
    fast = list(VideoFrameSource(path, resize_hw=(64, 96), parse_ts=False, emit="s2d_u8"))
    slow = list(VideoFrameSource(path, resize_hw=(64, 96), parse_ts=False))
    assert len(fast) == len(slow) == 3
    for (fs, tf), (ss, ts) in zip(fast, slow):
        assert fs.dtype == np.uint8 and fs.shape == (16, 24, 48) and tf == ts
        u8 = np.clip((ss * IMAGENET_STD + IMAGENET_MEAN) * 255.0 + 0.5, 0, 255).astype(np.uint8)
        assert np.abs(fs.astype(int) - pack_s2d(u8).astype(int)).max() <= 1


def test_device_yuv420_flat_to_s2d_matches_native():
    """The card's YUV420 converter (its plain version here) is within 1 LSB
    of the native fused host tail, s2d layout included."""
    from playground3d_tpu_torch.ops.yuv420 import yuv420_flat_to_s2d

    Y, U, V = _planes(np.random.default_rng(6), 64, 96)
    flat = np.concatenate([Y.ravel(), U.ravel(), V.ravel()])
    got = yuv420_flat_to_s2d(torch.as_tensor(flat[None, None]), (64, 96))[0, 0].numpy()
    ref = N.yuv420_to_s2d_u8(Y, U, V)
    assert got.shape == ref.shape == (16, 24, 48)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert np.abs(got.astype(int) - pack_s2d(rgb_from_planes(Y, U, V)).astype(int)).max() <= 1


def test_video_source_emit_yuv420_roundtrip(tmp_path):
    from playground3d_tpu_torch.ops.yuv420 import yuv420_flat_to_s2d

    path = _y4m(tmp_path, "t.y4m", (64, 96), 3, 8)
    raw = list(VideoFrameSource(path, resize_hw=(64, 96), parse_ts=False, emit="yuv420"))
    fast = list(VideoFrameSource(path, resize_hw=(64, 96), parse_ts=False, emit="s2d_u8"))
    assert len(raw) == 3
    for (buf, tr), (fs, tf) in zip(raw, fast):
        assert buf.dtype == np.uint8 and buf.shape == (64 * 96 * 3 // 2,) and tr == tf
        dev = yuv420_flat_to_s2d(torch.as_tensor(buf[None, None]), (64, 96))[0, 0].numpy()
        assert np.abs(dev.astype(int) - fs.astype(int)).max() <= 1
    half, _t = next(iter(VideoFrameSource(path, resize_hw=(32, 48), parse_ts=False, emit="yuv420")))
    assert half.shape == (32 * 48 * 3 // 2,)
    with pytest.raises(RuntimeError):  # any other ratio fails loudly
        next(iter(VideoFrameSource(path, resize_hw=(16, 24), parse_ts=False, emit="yuv420")))
