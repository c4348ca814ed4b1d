"""``apps/detect_video.py`` and ``tools/benchmark_speed.py`` of the PyTorch
port, run in-process on the CPU (``--device cpu``), against the JAX
package's apps.

``detect_video`` runs from a checkpoint that the JAX ``save_params`` wrote
(ResNet-18, 64x96 synthetic frames) with zero output convs and per-channel
biases, so every score and box is computed exactly by both packages: the
rows' frames, timestamps and classes are equal, confidences within rtol
1e-6 and the 20 box values within rtol 1e-5 / atol 1e-3 (the tolerances of
``tests/test_torch_model.py``'s detection test); the fps trailer is the
last row of both files.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.apps import detect_video as jax_app
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.nn import save_params as jax_save_params
from playground3d_tpu_torch.apps import detect_video as port_app
from playground3d_tpu_torch.tools import benchmark_speed

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

HW = (64, 96)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX ResNet-18 conv7 tree with zero output convs: the class biases
    spread so some scores pass ``--conf`` and classes differ by anchor, the
    regression biases random."""
    p = jax.jit(jax_init, static_argnames=("depth",))(jax.random.PRNGKey(2), depth=18)
    rng = np.random.default_rng(12)
    p["heads"]["cls_out"]["b"] = jnp.asarray(rng.normal(-1.0, 1.5, 72).astype(np.float32))
    p["heads"]["reg_out"]["b"] = jnp.asarray(rng.normal(0.0, 0.2, 108).astype(np.float32))
    path = str(tmp_path_factory.mktemp("ckpt") / "det.npz")
    jax_save_params(path, p)
    return path


def _read(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:-1], rows[-1]


def test_detect_video_matches_jax(tmp_path, checkpoint, capsys):
    argv = ["--frames", "3", "--depth", "18", "--height", str(HW[0]), "--width", str(HW[1]),
            "--checkpoint", checkpoint, "--conf", "0.5"]
    jout, pout = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    assert jax_app.main(argv + ["--out", jout]) is None
    assert port_app.main(argv + ["--out", pout, "--device", "cpu"]) is None
    out = capsys.readouterr().out
    assert f"to {pout} (" in out and "fps)" in out
    jh, jrows, jtrail = _read(jout)
    ph, prows, ptrail = _read(pout)
    assert ph == jh and len(ph) == 24
    assert len(prows) == len(jrows) and len(jrows) >= 3 * 8, len(jrows)
    assert {r[0] for r in prows} == {"0", "1", "2"}
    j, p = np.asarray(jrows, np.float64), np.asarray(prows, np.float64)
    np.testing.assert_array_equal(p[:, [0, 1, 2]], j[:, [0, 1, 2]])  # frame, timestamp, class
    assert len(np.unique(p[:, 2])) > 1
    assert (p[:, 3] > 0.5).all()
    np.testing.assert_allclose(p[:, 3], j[:, 3], rtol=1e-6)
    np.testing.assert_allclose(p[:, 4:], j[:, 4:], rtol=1e-5, atol=1e-3)
    assert len(ptrail) == len(jtrail) == 1
    assert ptrail[0].startswith("Processing fps: ") and float(ptrail[0].split(": ")[1]) > 0


def test_detect_video_pack_is_exact():
    """The one read a frame carries every field exactly."""
    from playground3d_tpu_torch.models.retinanet import Detections

    rng = np.random.default_rng(0)
    det = Detections(
        scores=torch.as_tensor(rng.uniform(0, 1, 7).astype(np.float32)),
        classes=torch.as_tensor(rng.integers(0, 8, 7).astype(np.int32)),
        boxes=torch.as_tensor(rng.normal(0, 500, (7, 20)).astype(np.float32)),
        cam_idx=torch.zeros(7, dtype=torch.int32),
        mask=torch.as_tensor(rng.uniform(size=7) > 0.5),
    )
    packed = port_app.pack_detections(det).numpy()
    assert packed.shape == (7, 23)
    np.testing.assert_array_equal(packed[:, 0].astype(np.float32), det.scores.numpy())
    np.testing.assert_array_equal(packed[:, 1] > 0, det.mask.numpy())
    np.testing.assert_array_equal(packed[:, 2].astype(np.int32), det.classes.numpy())
    np.testing.assert_array_equal(packed[:, 3:].astype(np.float32), det.boxes.numpy())


def test_benchmark_speed_prints_the_jax_tools_lines(capsys):
    """The port's sweep prints the JAX tool's lines: a device line, then a
    stage / compute / images-a-second line a batch size."""
    benchmark_speed.main(["--depth", "18", "--height", "64", "--width", "96", "--batches", "1", "2",
                          "--iters", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device: cpu  64x96 resnet18"
    assert [ln.split(":")[0] for ln in lines[1:]] == ["b=  1", "b=  2"]
    for ln in lines[1:]:
        parts = ln.split()
        assert parts[2] == "stage" and parts[5] == "compute" and ln.endswith("im/s)")
        assert float(parts[3]) >= 0 and float(parts[6]) > 0
