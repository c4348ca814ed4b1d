"""``apps/demo_e2e.py`` and ``apps/auto_label_e2e.py`` of the PyTorch port,
run in-process on the CPU (``--device cpu``), against the JAX package's
apps.

With ``--det-ckpt`` (no training) both packages load one checkpoint that
the JAX ``save_params`` wrote: a ResNet-18 s2d detector with zero output
convs, its class bias raised by 6 and its regression bias aimed at a car on
the dataset camera's road (``aimed_regression_bias``), so every score and
box is the same in both. The prediction CSVs then have equal (frame, id)
keys and classes, states within 1e-3 ft; the MOT metrics are equal. The
auto-label session saved by the shell holds the same labels (states within
1e-3 ft). Training is checked for its plumbing only, a few steps on the CPU:
finite losses, a checkpoint written that loads back.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.nn import save_params as jax_save_params
from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
from playground3d_tpu_torch.data.synthetic import aimed_regression_bias
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

KEYS = ["TP", "FP", "FN", "Recall", "Precision", "MOTA", "ID switches"]
CAR = (550.0, 40.0, 18.0, 6.0, 5.0, 1.0)


def steered_checkpoint(path, hw, stem="s2d", seed=0):
    """A JAX ResNet-18 tree whose anchors of cell (0, 0) decode to ``CAR``
    on the synthetic dataset camera at ``hw``, written by JAX's
    ``save_params``."""
    P = SyntheticDetectionDataset(image_shape=hw).camera_registry().P[0, 0]
    p = jax.jit(jax_init, static_argnames=("depth", "stem"))(jax.random.PRNGKey(seed), depth=18, stem=stem)
    p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 6.0
    p["heads"]["reg_out"]["b"] = jnp.asarray(aimed_regression_bias(P, CAR, hw))
    jax_save_params(path, p)
    return path


def rows(path):
    _, data = load_i24_csv(path)
    return {(f, int(r[2])): (r[3], parse_state_row(r)) for f, rs in data.items() for r in rs}


def same_rows(ppath, jpath, min_rows):
    p, j = rows(ppath), rows(jpath)
    assert set(p) == set(j) and len(j) >= min_rows, (len(p), len(j))
    for k in j:
        assert p[k][0] == j[k][0], k
        np.testing.assert_allclose(p[k][1], j[k][1], rtol=0, atol=1e-3, err_msg=str(k))


def same_metrics(pm, jm):
    for k in KEYS:
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-9, abs=1e-9), k


# --------------------------------------------------------------------------
# demo_e2e
# --------------------------------------------------------------------------


def test_demo_e2e_from_checkpoint_matches_jax(tmp_path):
    from playground3d_tpu.apps import demo_e2e as jax_app
    from playground3d_tpu_torch.apps import demo_e2e as port_app

    hw = (64, 96)
    ckpt = steered_checkpoint(str(tmp_path / "det.npz"), hw)
    argv = ["--det-ckpt", ckpt, "--frames", "8", "--height", str(hw[0]), "--width", str(hw[1])]
    jm = jax_app.main(argv + ["--out-prefix", str(tmp_path / "jax")])
    pm = port_app.main(argv + ["--out-prefix", str(tmp_path / "port"), "--device", "cpu"])
    same_rows(str(tmp_path / "port_pred.csv"), str(tmp_path / "jax_pred.csv"), min_rows=4)
    assert open(tmp_path / "port_gt.csv").read() == open(tmp_path / "jax_gt.csv").read()
    same_metrics(pm, jm)
    assert pm["FP"] + pm["TP"] > 0


def test_demo_e2e_trains_and_tracks(tmp_path, capsys):
    """A few training steps (the plumbing: finite losses, the checkpoint
    written and loaded back), then ``--quantize`` and tracking."""
    from playground3d_tpu_torch.apps import demo_e2e as port_app
    from playground3d_tpu_torch.models import load_params, retinanet_init

    prefix = str(tmp_path / "demo")
    metrics = port_app.main(["--steps", "3", "--batch", "2", "--frames", "4", "--height", "64", "--width", "96",
                             "--zoom", "3", "--feature-size", "32", "--tower-depth", "1", "--quantize",
                             "--out-prefix", prefix, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "training done; loss" in out and "backbone quantized to int8" in out
    loss = [float(x) for x in out.split("training done; loss ")[1].split("\n")[0].split(" -> ")]
    assert np.isfinite(loss).all()
    assert set(KEYS) <= set(metrics)
    like = retinanet_init(torch.Generator().manual_seed(1), depth=18, stem="s2d", feature_size=32, tower_depth=1,
                          device="cpu")
    model = load_params(prefix + "_detector.npz", like)
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())
    assert os.path.exists(prefix + "_pred.csv") and os.path.exists(prefix + "_gt.csv")


# --------------------------------------------------------------------------
# auto_label_e2e
# --------------------------------------------------------------------------


def test_auto_label_e2e_from_checkpoint_matches_jax(tmp_path):
    """The shell's ``auto`` labels from the same detector: the saved
    sessions hold the same objects and labels, the CSVs the same rows."""
    from playground3d_tpu.apps import auto_label_e2e as jax_app
    from playground3d_tpu_torch.apps import auto_label_e2e as port_app
    from playground3d_tpu_torch.tools.annotator import AnnotationSession

    hw = (96, 144)
    ckpt = steered_checkpoint(str(tmp_path / "det.npz"), hw)
    argv = ["--det-ckpt", ckpt, "--frames", "8", "--height", str(hw[0]), "--width", str(hw[1])]
    jm = jax_app.main(argv + ["--out-prefix", str(tmp_path / "jax")])
    pm = port_app.main(argv + ["--out-prefix", str(tmp_path / "port"), "--device", "cpu"])
    js = AnnotationSession.load(str(tmp_path / "jax_session.npz"))
    ps = AnnotationSession.load(str(tmp_path / "port_session.npz"))
    assert sorted(ps.labels) == sorted(js.labels) and len(ps.labels) >= 1
    for oid in js.labels:
        assert [(l.t, l.class_id) for l in ps.labels[oid]] == [(l.t, l.class_id) for l in js.labels[oid]]
        np.testing.assert_allclose(np.stack([l.state7 for l in ps.labels[oid]]),
                                   np.stack([l.state7 for l in js.labels[oid]]), rtol=0, atol=1e-3)
    same_rows(str(tmp_path / "port_pred.csv"), str(tmp_path / "jax_pred.csv"), min_rows=8)
    same_metrics(pm, jm)


def test_auto_label_e2e_pixels_to_scored_csv(tmp_path):
    """The JAX test's argv (``tests/test_annotator.py``) with its training
    cut to a few steps: real decode happened, a session and a scored CSV
    exist, the trained checkpoint loads back finite."""
    from playground3d_tpu_torch.apps import auto_label_e2e as port_app
    from playground3d_tpu_torch.models import load_params, retinanet_init

    prefix = str(tmp_path / "al")
    metrics = port_app.main([
        "--steps", "3", "--batch", "2", "--frames", "8",
        "--height", "96", "--width", "144", "--sigma-d", "0.01",
        "--out-prefix", prefix, "--device", "cpu",
    ])
    for suffix in (".y4m", "_det.npz", "_session.npz", "_pred.csv", "_gt.csv"):
        assert os.path.exists(prefix + suffix), suffix
    assert isinstance(metrics, dict) and "MOTA" in metrics
    model = load_params(prefix + "_det.npz", retinanet_init(depth=18, stem="s2d", device="cpu"))
    assert all(torch.isfinite(t).all() for t in model.state_dict().values())
