"""``apps/demo_e2e_mc.py`` of the PyTorch port, run in-process on the CPU
(``--device cpu``), against the JAX package's app.

With ``--det-ckpt --crop-ckpt`` (no training) both packages load the same
checkpoints, written by the JAX ``save_params``: the ResNet-18 s2d detector
of ``tests/test_torch_apps_demo.py`` (zero output convs, class bias +6, the
regression bias aimed at a car, so each of the three shifted cameras sees
one) and a ResNet-18 conv7 crop net with zero output convs (class bias +4).
Every score and box is then the same in both; the prediction CSVs have
equal (frame, id) keys and classes, states within 1e-3 ft, as
``tests/test_torch_multicam.py::test_clip_matches_jax`` holds the clip, and
the MOT metrics and the gate's log lines (what ``scripts/ship_decision.py``
reads) are equal. Training is checked for its plumbing: a few steps, the
checkpoints and their ``.step`` sidecars, ``--resume`` skipping, and
tracking per frame from them.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.nn import save_params as jax_save_params
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

HW = (64, 96)
KEYS = ["TP", "FP", "FN", "Recall", "Precision", "MOTA", "ID switches"]


def _rows(path):
    _, data = load_i24_csv(path)
    return {(f, int(r[2])): (r[3], parse_state_row(r)) for f, rs in data.items() for r in rs}


def _gate_lines(out):
    """The log lines the ship decision reads, without their clock."""
    return [re.sub(r"^\[ *[0-9.]+s\] ", "", ln) for ln in out.splitlines()
            if "seq seed=" in ln or "MC e2e metrics" in ln or re.match(r"^  [A-Za-z ]+: ", ln)]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    import jax.numpy as jnp

    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.data.synthetic import aimed_regression_bias

    d = tmp_path_factory.mktemp("ckpt")
    init = jax.jit(jax_init, static_argnames=("depth", "stem"))
    P = SyntheticDetectionDataset(image_shape=HW).camera_registry().P[0, 0]
    det = init(jax.random.PRNGKey(0), depth=18, stem="s2d")
    det["heads"]["cls_out"]["b"] = det["heads"]["cls_out"]["b"] + 6.0
    det["heads"]["reg_out"]["b"] = jnp.asarray(aimed_regression_bias(P, (550.0, 40.0, 18.0, 6.0, 5.0, 1.0), HW))
    crop = init(jax.random.PRNGKey(1), depth=18, stem="conv7")
    crop["heads"]["cls_out"]["b"] = crop["heads"]["cls_out"]["b"] + 4.0
    paths = str(d / "det.npz"), str(d / "crop.npz")
    jax_save_params(paths[0], det)
    jax_save_params(paths[1], crop)
    return paths


def test_demo_e2e_mc_from_checkpoints_matches_jax(tmp_path, checkpoints, capsys, monkeypatch):
    """The clip loop: one 24-frame clip of three cameras."""
    import playground3d_tpu.utils.jaxcache as jaxcache
    from playground3d_tpu.apps import demo_e2e_mc as jax_app
    from playground3d_tpu_torch.apps import demo_e2e_mc as port_app

    # the JAX app points JAX's compile cache into the repo: not in a test
    monkeypatch.setattr(jaxcache, "enable_persistent_cache", lambda *a, **k: None)
    argv = ["--det-ckpt", checkpoints[0], "--crop-ckpt", checkpoints[1], "--frames", "24",
            "--height", str(HW[0]), "--width", str(HW[1])]
    jm = jax_app.main(argv + ["--out-prefix", str(tmp_path / "jax")])
    jout = capsys.readouterr().out
    pm = port_app.main(argv + ["--out-prefix", str(tmp_path / "port"), "--device", "cpu"])
    pout = capsys.readouterr().out

    p, j = _rows(str(tmp_path / "port_s99r5_pred.csv")), _rows(str(tmp_path / "jax_s99r5_pred.csv"))
    assert set(p) == set(j) and len(j) >= 24, (len(p), len(j))
    assert len({k[1] for k in j}) >= 3  # a track in each camera
    for k in j:
        assert p[k][0] == j[k][0], k
        np.testing.assert_allclose(p[k][1], j[k][1], rtol=0, atol=1e-3, err_msg=str(k))
    assert open(tmp_path / "port_s99r5_gt.csv").read() == open(tmp_path / "jax_s99r5_gt.csv").read()
    for k in KEYS:
        assert pm[k] == pytest.approx(jm[k], rel=1e-9, abs=1e-9), k
        assert pm["spread"][k] == pytest.approx(jm["spread"][k], rel=1e-9, abs=1e-9), k
    assert _gate_lines(pout) == _gate_lines(jout) and len(_gate_lines(pout)) == 9


def test_demo_e2e_mc_trains_resumes_and_tracks(tmp_path, capsys):
    """Training plumbing: a train-only run (``--sequences 0``) writes both
    checkpoints and their sidecars; ``--resume`` at the same step count
    skips training and tracks from them per frame. (``--quantize`` is left
    to the card: the plain int8 convs take ~20 s here.)"""
    from playground3d_tpu_torch.apps import demo_e2e_mc as port_app
    from playground3d_tpu_torch.models import load_params, retinanet_init

    prefix = str(tmp_path / "mc")
    base = ["--steps", "2", "--crop-steps", "2", "--batch", "2", "--workers", "1", "--height", str(HW[0]),
            "--width", str(HW[1]), "--zoom", "3", "--out-prefix", prefix, "--device", "cpu"]
    assert port_app.main(base + ["--sequences", "0"]) is None
    out = capsys.readouterr().out
    assert "train-only run complete" in out
    for tag in ("detector", "crop-detector"):
        loss = float(re.search(rf"{tag} done: loss=([-0-9.naninf]+)", out).group(1))
        assert np.isfinite(loss), tag
    for name, stem in (("_det.npz", "s2d"), ("_crop.npz", "conv7")):
        assert open(prefix + name + ".step").read() == "2"
        m = load_params(prefix + name, retinanet_init(torch.Generator().manual_seed(0), depth=18, stem=stem,
                                                        device="cpu"))
        assert all(torch.isfinite(t).all() for t in m.state_dict().values())

    metrics = port_app.main(base + ["--resume", "--per-frame", "--frames", "4"])
    out = capsys.readouterr().out
    assert "detector: checkpoint already at step 2 >= 2, skipping" in out
    assert "crop-detector: checkpoint already at step 2 >= 2, skipping" in out
    assert set(KEYS) <= set(metrics) and len(metrics["runs"]) == 1
    assert os.path.exists(prefix + "_s99r5_pred.csv")
