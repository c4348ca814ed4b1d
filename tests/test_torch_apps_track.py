"""``apps/track.py`` of the PyTorch port against the JAX package's app, both
run in-process on the CPU, and the checkpoint format they share.

Each pair of runs takes the same arguments (the port's adds ``--device
cpu``): the output CSVs have equal (frame, id) keys and classes and states
within rtol/atol 1e-4, and the ``--eval`` metrics print alike. The real
detector runs from a ``--checkpoint`` that the JAX package's ``save_params``
wrote (ResNet-18, 64x128 frames), with zero output convs so every logit and
box is its bias: the class bias raised by 3, the regression bias aimed at a
car on the toy camera's road. ``load_params`` / ``save_params`` round-trip
float and int8-quantized trees between the packages exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.apps import track as jax_app
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.nn import load_params as jax_load_params
from playground3d_tpu.models.nn import save_params as jax_save_params
from playground3d_tpu.models.quant import quantize_detector as jax_quantize_detector
from playground3d_tpu_torch.apps import track as port_app
from playground3d_tpu_torch.data.synthetic import aimed_regression_bias
from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row
from playground3d_tpu_torch.models.bridge import flatten_tree, params_from_jax_numpy
from playground3d_tpu_torch.models.nn import load_params, save_params
from playground3d_tpu_torch.models.retinanet import retinanet_init

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

HW = (64, 128)
_init = jax.jit(jax_init, static_argnames=("depth", "stem"))


def _run(app, argv, capsys):
    app.main(argv)
    out = capsys.readouterr().out
    return out[out.index("wrote GT to"):].split("\n", 1)[1] if "--eval" in argv else out


def _rows(path):
    _, data = load_i24_csv(path)
    return {(f, int(r[2])): (r[3], parse_state_row(r)) for f, rows in data.items() for r in rows}


def _compare(tmp_path, argv, capsys, min_rows):
    jout, pout = str(tmp_path / "jax.csv"), str(tmp_path / "port.csv")
    jm = _run(jax_app, argv + ["--out", jout], capsys)
    pm = _run(port_app, argv + ["--out", pout, "--device", "cpu"], capsys)
    j, p = _rows(jout), _rows(pout)
    assert set(p) == set(j) and len(j) >= min_rows, (len(p), len(j))
    for k in j:
        assert p[k][0] == j[k][0], k
        np.testing.assert_allclose(p[k][1], j[k][1], rtol=1e-4, atol=1e-4, err_msg=str(k))
    assert open(jout + ".gt.csv").read() == open(pout + ".gt.csv").read()
    assert "MOTA" in pm and pm == jm, (pm, jm)


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_oracle_app_matches_jax(tmp_path, capsys, mode):
    _compare(tmp_path, ["--mode", mode, "--oracle", "--frames", "24", "--eval"], capsys, min_rows=100)


def _steered_checkpoint(path):
    """A JAX ResNet-18 tree whose every anchor of cell (0, 0) decodes to a
    car on the toy camera's road, written by the JAX ``save_params``."""
    reg, ranges, _, _ = toy_camera_chain(1)
    lo, hi = ranges["p1c1"]
    p = _init(jax.random.PRNGKey(5), depth=18)
    p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    p["heads"]["reg_out"]["b"] = jnp.asarray(
        aimed_regression_bias(reg.P[0, 0], ((lo + hi) / 2, 40.0, 18.0, 6.0, 5.0, 1.0), HW))
    jax_save_params(path, p)


def test_checkpoint_app_matches_jax(tmp_path, capsys):
    """``--mode single`` with the real detector from a JAX-written checkpoint
    over rendered synthetic frames."""
    ckpt = str(tmp_path / "det.npz")
    _steered_checkpoint(ckpt)
    _compare(tmp_path, ["--mode", "single", "--frames", "6", "--depth", "18", "--checkpoint", ckpt,
                        "--height", str(HW[0]), "--width", str(HW[1]), "--eval"], capsys, min_rows=6)


def _tree(kind):
    p = _init(jax.random.PRNGKey(6), depth=18, stem="s2d")
    if kind == "float":
        return p
    calib = np.random.default_rng(60).integers(0, 256, (1, 16, 24, 48), dtype=np.uint8)
    return jax_quantize_detector(p, calib, 18, stem="s2d")


@pytest.mark.parametrize("kind", ["float", "int8"])
def test_load_params_round_trips(tmp_path, kind):
    """JAX ``save_params`` -> port ``load_params`` gives the bridged model;
    port ``save_params`` writes JAX's keys and arrays, which JAX's
    ``load_params`` and the port's read back unchanged."""
    tree = _tree(kind)
    want = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_save_params(jpath, tree)
    got = load_params(jpath, want)
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert sd_got.keys() == sd_want.keys()
    for k in sd_want:
        assert torch.equal(sd_got[k], sd_want[k]), k

    save_params(ppath, got)
    with np.load(jpath) as jz, np.load(ppath) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        for k in jz.files:
            assert jz[k].dtype == pz[k].dtype and np.array_equal(jz[k], pz[k]), k
    back = jax_load_params(ppath, tree)
    flat_back, flat_tree = flatten_tree(back), flatten_tree(tree)
    assert flat_back.keys() == flat_tree.keys()
    for k in flat_tree:
        assert np.array_equal(np.asarray(flat_back[k]), np.asarray(flat_tree[k])), k
    again = load_params(ppath, want)
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd_want[k]), k


def test_load_params_refuses_another_model(tmp_path):
    path = str(tmp_path / "r18.npz")
    jax_save_params(path, _init(jax.random.PRNGKey(7), depth=18, stem="conv7"))
    with pytest.raises(ValueError, match="does not match"):
        load_params(path, retinanet_init(torch.Generator().manual_seed(0), depth=34, device="cpu"))
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
