"""Crop-and-resize in the PyTorch port against the JAX package.

The plain PyTorch version (``ops/roi_align.py::crop_and_resize_plain``) is
held against the Pallas kernel in interpret mode and the XLA
``roi_align.crop_and_resize``; the dispatch and the CUDA wrapper's argument
checks are exercised without a GPU. Tolerances: atol 1e-5 on [0,1] frames,
1e-3 on 0-255 frames (float32 rounding of ~1e3-magnitude sample
coordinates).
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.ops.pallas.crop_resize import crop_and_resize_pallas
from playground3d_tpu.ops.roi_align import crop_and_resize as jax_crop
from playground3d_tpu_torch.ops import crop_resize
from playground3d_tpu_torch.ops.roi_align import crop_and_resize, crop_and_resize_plain


# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _both(frames, boxes, fi, S):
    ref = np.asarray(jax_crop(jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(fi), out_size=S))
    pal = np.asarray(crop_and_resize_pallas(
        jnp.asarray(frames), jnp.asarray(boxes), jnp.asarray(fi), out_size=S, interpret=True
    ))
    got = crop_and_resize_plain(
        torch.as_tensor(frames), torch.as_tensor(boxes), torch.as_tensor(fi, dtype=torch.int32), S
    ).numpy()
    return ref, pal, got


BOX_CASES = {
    # the two cases of tests/test_pallas.py
    "pallas_case": [[10.0, 10, 40, 40], [5.0, 20, 60, 55], [0.0, 0, 96, 64], [-5.0, -5, 30, 30]],
    "partly_outside": [[-20.0, 30, 20, 90], [80.0, -10, 120, 20], [90.0, 60, 130, 100]],
    "wholly_outside": [[-50.0, -50, -10, -10], [200.0, 100, 260, 160], [-30.0, 70, -5, 90]],
    "zero_width": [[30.0, 10, 30, 40], [12.0, 33, 50, 33], [7.0, 7, 7, 7]],
}


@pytest.mark.parametrize("case", sorted(BOX_CASES))
@pytest.mark.parametrize("hw", [(64, 96), (65, 97)])
def test_plain_matches_pallas_and_xla(rng, case, hw):
    frames = rng.uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
    boxes = np.asarray(BOX_CASES[case], np.float32)
    fi = (np.arange(len(boxes)) % 2).astype(np.int32)
    ref, pal, got = _both(frames, boxes, fi, 16)
    np.testing.assert_allclose(got, pal, atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_constant_region():
    frames = np.zeros((1, 64, 64, 3), np.float32)
    frames[0, 16:48, 16:48] = 3.0
    boxes = np.array([[20.0, 20, 40, 40]], np.float32)
    _, pal, got = _both(frames, boxes, np.zeros(1, np.int32), 8)
    np.testing.assert_allclose(got, pal, atol=1e-5)
    np.testing.assert_allclose(got, 3.0, atol=1e-5)


def test_several_frames_and_large_coordinates(rng):
    """Four frames; random boxes at 1080p-scale coordinates, where one ulp
    of a sample coordinate is ~1e-4 px (the port rounds as XLA does)."""
    frames = rng.integers(0, 256, (4, 120, 1920, 3)).astype(np.float32)
    c = rng.uniform(0, 1, (24, 2)) * [1920, 120]
    s = rng.uniform(2, 300, (24, 1))
    boxes = np.concatenate([c - s / 2, c + s / 2], 1).astype(np.float32)
    fi = rng.integers(0, 4, 24).astype(np.int32)
    ref, pal, got = _both(frames, boxes, fi, 32)
    np.testing.assert_allclose(got, pal, atol=1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_uint8_frames_equal_the_float_cast(rng):
    frames = rng.integers(0, 256, (2, 65, 97, 3)).astype(np.uint8)
    boxes = np.asarray(BOX_CASES["pallas_case"] + BOX_CASES["partly_outside"], np.float32)
    fi = (np.arange(len(boxes)) % 2).astype(np.int32)
    ref, pal, _ = _both(frames.astype(np.float32), boxes, fi, 16)
    got = crop_and_resize_plain(
        torch.as_tensor(frames), torch.as_tensor(boxes), torch.as_tensor(fi), 16
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pal, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


def test_dispatch_takes_plain_on_cpu_and_counts_no_launch(rng):
    frames = torch.as_tensor(rng.uniform(0, 1, (1, 64, 96, 3)).astype(np.float32))
    boxes = torch.as_tensor(np.asarray(BOX_CASES["pallas_case"], np.float32))
    fi = torch.zeros(4, dtype=torch.int32)
    before = crop_resize.crop_and_resize_cuda.launches
    out = crop_and_resize(frames, boxes, fi, 16)
    assert torch.equal(out, crop_and_resize_plain(frames, boxes, fi, 16))
    assert crop_resize.crop_and_resize_cuda.launches == before == 0


def _good_args():
    return (
        torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
        torch.zeros((2, 4), dtype=torch.float32),
        torch.zeros((2,), dtype=torch.int32),
    )


@pytest.mark.parametrize("bad", [
    "frames_f64", "frames_rank3", "frames_noncontig", "boxes_f64", "boxes_shape",
    "idx_int64", "idx_len", "out_size_zero",
])
def test_cuda_wrapper_argument_checks_raise(bad):
    frames, boxes, fi = _good_args()
    size = 16
    if bad == "frames_f64":
        frames = frames.double()
    elif bad == "frames_rank3":
        frames = frames[0]
    elif bad == "frames_noncontig":
        frames = torch.zeros((1, 8, 16, 3), dtype=torch.uint8)[:, :, ::2]
    elif bad == "boxes_f64":
        boxes = boxes.double()
    elif bad == "boxes_shape":
        boxes = torch.zeros((2, 5))
    elif bad == "idx_int64":
        fi = fi.long()
    elif bad == "idx_len":
        fi = torch.zeros((3,), dtype=torch.int32)
    elif bad == "out_size_zero":
        size = 0
    crop_resize.check_args(*_good_args(), 16)  # the good arguments pass
    with pytest.raises(ValueError):
        crop_resize.check_args(frames, boxes, fi, size)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never hands a tensor to the plain version: a CPU
    tensor is refused before anything is built or launched."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        crop_resize.crop_and_resize_cuda(*_good_args(), 16)
    assert crop_resize.crop_and_resize_cuda.launches == 0


def test_import_needs_no_nvcc_or_gpu():
    code = (
        "import os, shutil\n"
        "os.environ['PATH'] = ''\n"
        "import playground3d_tpu_torch.ops.crop_resize as m\n"
        "import playground3d_tpu_torch.ops.roi_align\n"
        "assert m.LIB._lib is None and shutil.which('nvcc') is None\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
