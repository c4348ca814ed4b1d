"""The s2d crop-and-resize of the PyTorch port (``ops/crop_mxu.py``, plain
version on the CPU) against the JAX function on the same numpy inputs.

Tolerances:

* compute type bfloat16 (the tracker's): **0**. Every rounding of the JAX
  function (levels, normalization, weights, the row product) is copied, and
  products of bfloat16 values are exact in float32, so nothing depends on the
  order of a sum.
* compute type float32: 1e-5 on [0, 1] frames and on normalized uint8 frames
  (|values| below 2.7), 2e-5 on 0-255 values (one float32 ulp at 255 is
  1.5e-5): XLA's CPU dot contracts ``w0*p0 + w1*p1`` into a multiply-add,
  torch's rounds the products first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.data.video import pack_s2d as jax_pack_s2d
from playground3d_tpu.ops import crop_mxu as J
from playground3d_tpu_torch.ops import crop_mxu as P

torch.set_num_threads(1)

JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _frames_u8(seed, C, H, W):
    rng = np.random.default_rng(seed)
    return np.stack([P.pack_s2d(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)) for _ in range(C)])


def _both(frames, boxes, cams, **kw):
    jkw = dict(kw, dtype=JDT[kw.get("dtype", torch.bfloat16)])
    want = np.asarray(J.crop_and_resize_s2d(jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(cams), **jkw))
    got = P.crop_and_resize_s2d(torch.as_tensor(frames), torch.as_tensor(boxes), torch.as_tensor(cams), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


BOXES = np.array(
    [
        [10.5, 20.25, 90.5, 100.25], [40, 8, 120, 88], [0, 0, 32, 32],  # level 0
        [-20, -30, 100, 90], [380, 250, 470, 330], [500, 400, 600, 500],  # partly and wholly outside
        [5, 5, 253, 253], [3, 3, 251.5, 200], [0, 0, 399, 271], [100, 50, 380, 260],  # levels 1 and 2
        [300, 200, 100, 80],  # corners swapped
    ],
    np.float32,
)
CAMS = np.array([0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1], np.int32)


def test_pack_s2d_is_the_jax_packing():
    fr = np.random.default_rng(0).integers(0, 256, (37, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(P.pack_s2d(fr), jax_pack_s2d(fr))


def test_max_crop_span():
    for wc, nl in ((64, 3), (32, 2), (16, 1)):
        assert P.max_crop_span_s2d(wc, nl) == J.max_crop_span_s2d(wc, nl)
    assert P.max_crop_span_s2d() == 992.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_s2d_halve(dtype, kind):
    """Odd cell counts (17 x 25 cells -> 8 x 12) drop their last cell."""
    fr = _frames_u8(1, 2, 68, 100)
    if kind == "float":
        fr = (fr / 255.0).astype(np.float32)
    want = np.asarray(J.s2d_halve(jnp.asarray(fr), dtype=JDT[dtype]).astype(jnp.float32))
    got = P.s2d_halve(torch.as_tensor(fr), dtype)
    assert got.dtype == dtype and tuple(got.shape) == (2, 8, 12, 48)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0 if dtype == torch.bfloat16 or kind == "uint8" else 1e-7)


def test_s2d_halve_is_the_pixel_average_pool():
    raw = np.random.default_rng(12).uniform(0, 1, (1, 64, 96, 3)).astype(np.float32)
    got = P.s2d_halve(torch.as_tensor(P.pack_s2d(raw[0])[None]), torch.float32).numpy()
    want = P.pack_s2d(raw[0].reshape(32, 2, 48, 2, 3).mean((1, 3)))[None]
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_packed_layout_is_space_to_depth_of_hwc():
    from playground3d_tpu_torch.models.resnet import space_to_depth

    fr = torch.as_tensor(_frames_u8(13, 2, 128, 192))
    boxes, cams = torch.tensor([[16.0, 16.0, 80.0, 80.0], [3.5, 9.0, 190.0, 120.0]]), torch.tensor([0, 1])
    kw = dict(out_size=32, win_cells=16, normalize=True)
    hwc = P.crop_and_resize_s2d(fr, boxes, cams, layout="hwc", **kw)
    chw = P.crop_and_resize_s2d(fr, boxes, cams, layout="chw", **kw)
    assert torch.equal(space_to_depth(hwc, 4), P.crop_and_resize_s2d(fr, boxes, cams, layout="s2d", **kw))
    assert torch.equal(chw.permute(0, 2, 3, 1), hwc)


def test_unpack_chw():
    w = np.random.default_rng(2).normal(size=(3, 5, 7, 48)).astype(np.float32)
    np.testing.assert_array_equal(P._unpack_chw(torch.as_tensor(w)).numpy(), np.asarray(J._unpack_chw(jnp.asarray(w))))


@pytest.mark.parametrize("layout", ["s2d", "hwc", "chw"])
@pytest.mark.parametrize("n_levels", [1, 2, 3])
def test_bf16_uint8_normalize_equals_jax(layout, n_levels):
    """The tracker's call: uint8 frames, normalize, bfloat16; two cameras,
    odd cell counts (68 x 100 cells), boxes outside the frame."""
    fr = _frames_u8(3, 2, 272, 400)
    got, want = _both(fr, BOXES, CAMS, out_size=32, win_cells=16, n_levels=n_levels,
                      layout=layout, normalize=True)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalize", [False, True])
def test_bf16_float_frames_equal_jax(normalize):
    fr = (_frames_u8(4, 2, 272, 400) / 255.0).astype(np.float32) * (255.0 if normalize else 1.0)
    got, want = _both(fr, BOXES, CAMS, out_size=28, win_cells=16, n_levels=3, layout="s2d",
                      normalize=normalize)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["unit", "uint8", "uint8_normalize"])
def test_float32_close_to_jax(case):
    fr = _frames_u8(5, 2, 272, 400)
    if case == "unit":
        fr = (fr / 255.0).astype(np.float32)
    got, want = _both(fr, BOXES, CAMS, out_size=32, win_cells=16, n_levels=3, layout="hwc",
                      dtype=torch.float32, normalize=case == "uint8_normalize")
    np.testing.assert_allclose(got, want, atol=2e-5 if case == "uint8" else 1e-5, rtol=0)


def test_level_edges_at_the_default_window():
    """Spans of exactly 248, 496 and 992 px and one ulp either side pick the
    level JAX picks (cap = 248 px at win_cells = 64), and crop equally."""
    spans = []
    for base in (248.0, 496.0, 992.0):
        f = np.float32(base)
        spans += [np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(2000))]
    spans = np.array(spans, np.float32)
    boxes = np.stack([np.full_like(spans, 8.0), np.full_like(spans, 4.0), 8.0 + spans, 4.0 + spans * 0.5], 1)
    # as the jitted function computes it: compiled, the division by the
    # constant 248 is a multiply by its float32 reciprocal, which moves the
    # edge at 248 px by one ulp against the same expression run op by op
    level_of = jax.jit(lambda s: jnp.clip(jnp.ceil(jnp.log2(s / 248.0)).astype(jnp.int32), 0, 2))
    want_level = np.asarray(level_of(jnp.asarray(spans)))
    np.testing.assert_array_equal(P._levels_of(torch.as_tensor(boxes), 64, 3).numpy(), want_level)
    assert sorted(set(want_level.tolist())) == [0, 1, 2]
    fr = _frames_u8(6, 1, 544, 1040)
    got, want = _both(fr, boxes, np.zeros(len(spans), np.int32), out_size=28, normalize=True)
    np.testing.assert_array_equal(got, want)


def test_frames_smaller_than_the_window():
    """16 x 24 cells against a 64-cell window: the JAX function pads."""
    fr = _frames_u8(7, 2, 64, 96)
    boxes = np.array([[4, 4, 60, 60], [-10, -10, 120, 80], [30, 20, 95.5, 63.5]], np.float32)
    got, want = _both(fr, boxes, np.array([0, 1, 1], np.int32), out_size=32, normalize=True)
    np.testing.assert_array_equal(got, want)


def test_window_rule_darkens_boxes_beyond_the_span():
    """A box wider than max_crop_span_s2d: taps past the window get weight
    zero, here as there (callers clamp; the op does not repair)."""
    fr = _frames_u8(8, 1, 272, 400)
    boxes = np.array([[0, 0, 399, 271]], np.float32)  # 399 px > (16*4-8)*2 = 112
    got, want = _both(fr, boxes, np.zeros(1, np.int32), out_size=32, win_cells=16, n_levels=2, layout="hwc")
    np.testing.assert_array_equal(got, want)
    assert (got[0, :, -1] == 0).all() and (got[0, 0, 0] != 0).any()


def test_level0_matches_the_gather_crop():
    """Level-0 crops at float32 are the port's plain crop-and-resize of the
    unpacked frames (the JAX package's own cross-check, tests/test_ops.py)."""
    from playground3d_tpu_torch.ops.roi_align import crop_and_resize_plain

    rng = np.random.default_rng(9)
    raw = rng.uniform(0, 1, (2, 128, 192, 3)).astype(np.float32)
    s2d = np.stack([P.pack_s2d(f) for f in raw])
    boxes = torch.tensor([[10.5, 20.25, 90.5, 100.25], [40, 8, 120, 88], [0, 0, 32, 32]])
    cams = torch.tensor([0, 1, 1], dtype=torch.int32)
    got = P.crop_and_resize_s2d(torch.as_tensor(s2d), boxes, cams, out_size=32, win_cells=32,
                                layout="hwc", dtype=torch.float32)
    want = crop_and_resize_plain(torch.as_tensor(raw), boxes, cams, 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("bad", ["layout", "dtype", "channels", "s2d_size", "too_deep", "device"])
def test_refusals(bad):
    fr = torch.zeros((1, 8, 8, 48), dtype=torch.uint8)
    boxes, cams = torch.zeros((1, 4)), torch.zeros(1, dtype=torch.int32)
    kw = dict(out_size=8, win_cells=4, n_levels=2)
    if bad == "layout":
        kw["layout"] = "nhwc"
    elif bad == "dtype":
        kw["dtype"] = torch.float16
    elif bad == "channels":
        fr = fr[..., :47]
    elif bad == "s2d_size":
        kw["out_size"] = 10
    elif bad == "too_deep":
        kw["n_levels"] = 5
    elif bad == "device":
        fr = fr.to("meta")
    with pytest.raises(ValueError):
        P.crop_and_resize_s2d(fr, boxes, cams, **kw)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        P.crop_and_resize_s2d_cuda(torch.zeros((1, 8, 8, 48), dtype=torch.uint8), torch.zeros((1, 4)),
                                   torch.zeros(1, dtype=torch.int32), 8, 4, 2)


@pytest.mark.parametrize("C,Hs,Ws,n,S,levels", [(1, 270, 480, 32, 112, 3), (2, 17, 25, 5, 37, 2), (1, 4, 4, 1, 4, 1),
                                                (2, 67, 101, 3, 28, 5)])
def test_launch_plan(C, Hs, Ws, n, S, levels):
    plan = P.launch_plan(C, Hs, Ws, n, S, levels)
    assert plan.tiles == -(-S // P.TILE_ROWS) and plan.blocks == n * plan.tiles
    shapes = P.level_shapes(Hs, Ws, levels)
    # one kernel builds levels 1 and 2 (a block per PYRAMID_CELLS level-1
    # cells of a cell row, a thread per pixel row of each), one more per deeper level
    assert len(plan.level_offsets) == levels and len(plan.pyramid_blocks) == (levels > 1) + max(levels - 3, 0)
    assert P.THREADS == 4 * P.PYRAMID_CELLS
    if levels > 1:
        rows, cells = C * shapes[1][0], shapes[1][1]
        assert plan.pyramid_blocks[0] % rows == 0
        per_row = plan.pyramid_blocks[0] // rows
        assert per_row * P.PYRAMID_CELLS >= cells > (per_row - 1) * P.PYRAMID_CELLS
    assert plan.shared_bytes == P.sample_shared_bytes(S)
    total = 0
    for k in range(1, levels):
        assert plan.level_offsets[k] == total
        elems = C * shapes[k][0] * shapes[k][1] * 48
        if k >= 3:
            blocks = plan.pyramid_blocks[k - 2]
            assert blocks * P.THREADS >= elems > (blocks - 1) * P.THREADS
        total += elems
    assert plan.pyramid_elems == total
    if (Hs, Ws) == (270, 480):
        assert shapes == [(270, 480), (135, 240), (67, 120)]  # 1080p: level 2 drops a cell row
        assert plan.pyramid_blocks == (540,)  # 135 cell rows of 4 blocks: ~4 blocks of 256 an SM of 132


@pytest.mark.parametrize("frames_dtype", [torch.uint8, torch.float32], ids=["u8", "f32frames"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("win_cells", [3, 4, 16, 37, 64])
def test_sample_shared_bytes_fit_every_size(win_cells, dtype, frames_dtype):
    """The staged rows are sized for the widest a crop can stage (the
    window, 4 * win_cells pixels of 3 values), once as the frames' type and
    once as the compute type; the column table for S rounded up to 4. Every
    S up to MAX_OUT_SIZE fits a block, and both areas start on a 16-byte
    boundary (vector copies and loads)."""
    value_bytes = 2 if dtype == torch.bfloat16 else 4
    frame_bytes = 1 if frames_dtype == torch.uint8 else 4
    rows = 2 * P.TILE_ROWS * 12 * win_cells
    for S in range(1, P.MAX_OUT_SIZE + 1):
        got = P.sample_shared_bytes(S, win_cells, dtype, frames_dtype)
        assert got <= P.MAX_SHARED_BYTES
        tables = got - rows * (frame_bytes + value_bytes)
        assert tables == 16 * (-(-S // 4) * 4) + 8 * 2 * P.TILE_ROWS and tables % 16 == 0
        assert (tables + rows * frame_bytes) % 16 == 0
        assert P.launch_plan(1, 64, 64, 3, S, 3, win_cells, dtype, frames_dtype).shared_bytes == got
    assert P.sample_shared_bytes(112, 64) == 38784  # the main path's call


@pytest.mark.parametrize("dtype,frames_dtype,win_cells", [(torch.float32, torch.float32, 141),
                                                          (torch.bfloat16, torch.uint8, 375)])
def test_launch_plan_refuses_a_window_that_does_not_fit(dtype, frames_dtype, win_cells):
    S = P.MAX_OUT_SIZE
    assert P.sample_shared_bytes(S, win_cells - 1, dtype, frames_dtype) <= P.MAX_SHARED_BYTES
    P.launch_plan(1, 16, 16, 1, S, 2, win_cells - 1, dtype, frames_dtype)
    with pytest.raises(ValueError, match="win_cells=.*shared memory"):
        P.launch_plan(1, 16, 16, 1, S, 2, win_cells, dtype, frames_dtype)


@pytest.mark.parametrize("kw,match", [
    (dict(n_levels=9), "n_levels"), (dict(out_size=2000), "out_size"), (dict(n=0), "nothing to launch"),
    (dict(Hs=1, n_levels=2), "empty"), (dict(win_cells=500), "shared memory"),
    (dict(n=2**28, out_size=1024), "blocks"),
])
def test_launch_plan_refuses(kw, match):
    args = dict(C=1, Hs=16, Ws=16, n=1, out_size=16, n_levels=2)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        P.launch_plan(**args)


def test_kernel_source_holds_the_same_constants():
    import re

    src = P.LIB.source.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["kThreads"] == P.THREADS and consts["kTileRows"] == P.TILE_ROWS
    assert consts["kMaxLevels"] == P.MAX_LEVELS and consts["kMaxOutSize"] == P.MAX_OUT_SIZE
    assert consts["kMaxSharedBytes"] == P.MAX_SHARED_BYTES and consts["kPyramidCells"] == P.PYRAMID_CELLS
    # the shared-memory formula the launcher checks the plan's bytes against
    assert "return 16 * ((S + 3) & ~3);" in src and "kRowTableBytes = 8 * 2 * kTileRows;" in src
    assert "return 12 * win_cells;" in src
    assert ("col_table_bytes(S) + kRowTableBytes + 2 * kTileRows * stage_pitch(win_cells) * (frame_bytes + value_bytes)"
            in src)
