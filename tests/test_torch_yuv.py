"""``yuv420_flat_to_s2d`` of the PyTorch port (plain version on the CPU)
against the JAX function: every byte within +-1 LSB (the JAX docstring's own
contract against the host decoder; XLA may contract a multiply into the add
that follows, the port rounds each operation), and the share of bytes that
differ at all below 1e-3. On this CPU the two are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.pipeline.multi_cam import yuv420_flat_to_s2d as jax_yuv
from playground3d_tpu_torch.ops import yuv420 as P
from playground3d_tpu_torch.pipeline.multi_cam import yuv420_flat_to_s2d

torch.set_num_threads(1)


def _buf(seed, t, c, h, w, extremes=False):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (t, c, h * w * 3 // 2), dtype=np.uint8)
    if extremes:  # saturated luma with saturated chroma: both clamps of the output
        buf[0, 0, : h * w // 2] = 255
        buf[0, 0, h * w // 2: h * w] = 0
        buf[0, 0, h * w:] = rng.choice(np.array([0, 255], np.uint8), buf.shape[2] - h * w)
    return buf


@pytest.mark.parametrize("t,c,h,w,extremes", [(2, 2, 64, 96, False), (1, 3, 36, 52, True), (3, 1, 8, 4, True)])
def test_yuv420_flat_to_s2d_matches_jax(t, c, h, w, extremes):
    buf = _buf(t + c, t, c, h, w, extremes)
    want = np.asarray(jax_yuv(jnp.asarray(buf), (h, w)))
    got = yuv420_flat_to_s2d(torch.as_tensor(buf), (h, w))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape == (t, c, h // 4, w // 4, 48)
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 1e-3
    if extremes:
        assert got.min() == 0 and got.max() == 255


def test_gray_frame_is_gray():
    """Y = 126, U = V = 128 is RGB (128, 128, 128): (126 - 16) * 255 / 219 = 128.08."""
    h, w = 8, 8
    buf = np.full((1, 1, h * w * 3 // 2), 128, np.uint8)
    buf[..., : h * w] = 126
    out = yuv420_flat_to_s2d(torch.as_tensor(buf), (h, w))
    assert (out == 128).all()


@pytest.mark.parametrize("bad", ["size", "dtype", "hw", "rank"])
def test_refusals(bad):
    h, w = 8, 8
    buf = torch.zeros((1, 1, h * w * 3 // 2), dtype=torch.uint8)
    if bad == "size":
        buf = buf[..., :-1]
    elif bad == "dtype":
        buf = buf.float()
    elif bad == "hw":
        h = 6
    elif bad == "rank":
        buf = buf[0]
    with pytest.raises(ValueError):
        yuv420_flat_to_s2d(buf, (h, w))


def test_cuda_wrapper_refuses_cpu_tensors_and_other_devices_raise():
    buf = torch.zeros((1, 1, 96), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        P.yuv420_flat_to_s2d_cuda(buf, (8, 8))
    with pytest.raises(ValueError, match="no implementation"):
        P.yuv420_flat_to_s2d(buf.to("meta"), (8, 8))
