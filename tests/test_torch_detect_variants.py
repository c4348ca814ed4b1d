"""The detector variants of the PyTorch port against the JAX package:
``num_anchors_for_shape``, ``detect_singleframe`` (per-class NMS over the
flattened (anchor, class) scores) and the stock 2D RetinaNet
(``models/retinanet2d.py``), weights carried across by the bridge.

Tolerances are those of ``tests/test_torch_model.py``: float32 forwards
within rtol/atol 1e-4 of the largest output; with zero output convs (every
logit its bias, so both packages compute them exactly) the detections'
integer outputs and masks are equal, boxes within rtol 1e-5 / atol 1e-3 and
scores within rtol 1e-6. With random heads the bf16 logits differ in their
last bits, so only the kept mask is compared, as for ``detect_multiframe``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.models import anchors as JA
from playground3d_tpu.models import retinanet as JR
from playground3d_tpu.models import retinanet2d as J2
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.nn import save_params as jax_save_params
from playground3d_tpu_torch import models as PM
from playground3d_tpu_torch.models import anchors as PA
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models import retinanet2d as P2
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.models.nn import load_params, save_params

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

IMG = (128, 192)
_init = jax.jit(jax_init, static_argnames=("depth", "stem"))
_init2d = jax.jit(J2.retinanet2d_init, static_argnames=("depth", "num_classes"))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _check(p, j, rtol, scale_tol):
    j = np.asarray(j, np.float32)
    p = p.to(torch.float32).numpy()
    np.testing.assert_allclose(p, j, rtol=rtol, atol=scale_tol * np.abs(j).max())


@pytest.mark.parametrize("hw,levels", [
    ((64, 96), PA.PYRAMID_LEVELS), ((65, 97), PA.PYRAMID_LEVELS), ((128, 192), PA.PYRAMID_LEVELS),
    ((1080, 1920), PA.PYRAMID_LEVELS), ((1080, 1920), (4, 5, 6, 7)), ((112, 112), (3,)),
])
def test_num_anchors_for_shape(hw, levels):
    n = PA.num_anchors_for_shape(hw, levels)
    assert n == JA.num_anchors_for_shape(hw, levels) == PA.anchors_for_shape(hw, levels).shape[0]
    assert PM.num_anchors_for_shape is PA.num_anchors_for_shape
    assert PA.num_anchors_for_shape(list(hw), levels) == n  # any sequence of two ints


# --------------------------------------------------------------------------
# detect_singleframe
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tie_nets():
    """Focal-prior heads with per-anchor biases: output convs zero, so every
    score is a sigmoid of its bias in both packages, with ties across
    anchors of one class and distinct values across classes."""
    p = _init(jax.random.PRNGKey(3), depth=18, stem="conv7")
    rng = np.random.default_rng(11)
    b = p["heads"]["cls_out"]["b"].shape[0]
    p["heads"]["cls_out"]["b"] = jnp.asarray(rng.normal(-1.0, 1.0, b).astype(np.float32))
    p["heads"]["reg_out"]["b"] = jnp.asarray(rng.normal(0.0, 0.1, p["heads"]["reg_out"]["b"].shape[0]).astype(np.float32))
    return p, params_from_jax_numpy(_np_tree(p), device="cpu")


@pytest.fixture(scope="module")
def random_nets():
    rng = np.random.default_rng(5)
    p = _init(jax.random.PRNGKey(0), depth=18, stem="conv7")
    for k in ("cls_out", "reg_out"):
        w = p["heads"][k]["w"]
        p["heads"][k]["w"] = jnp.asarray(rng.normal(0, 0.02, w.shape).astype(np.float32))
    return p, params_from_jax_numpy(_np_tree(p), device="cpu")


@pytest.mark.parametrize("hw,pre_topk", [((64, 96), 256), ((64, 96), 10**6), ((128, 192), 4096)])
def test_detect_singleframe_matches_jax(tie_nets, hw, pre_topk):
    """``pre_topk`` below A·K and above it (the clamp to A·K: 9,288 pairs
    at 64x96), and the default 4,096 (the two-launch NMS route's size on
    the card) at 128x192. The clamp at 128x192 (36,864 pairs) is left
    out: the JAX NMS over them takes ~100 s on the CPU."""
    p, m = tie_nets
    a = PA.num_anchors_for_shape(hw)
    assert (pre_topk < a * 8) == (pre_topk != 10**6)
    x = np.random.default_rng(6).uniform(-1, 1, hw + (3,)).astype(np.float32)
    dj = JR.detect_singleframe(p, jnp.asarray(x), depth=18, pre_topk=pre_topk, max_dets=64)
    dp = PR.detect_singleframe(m, torch.as_tensor(x), pre_topk=pre_topk, max_dets=64)
    assert dp.classes.dtype == torch.int32 and dp.cam_idx.dtype == torch.int32
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))
    assert dp.mask.sum() > 4
    np.testing.assert_array_equal(dp.classes.numpy(), np.asarray(dj.classes))
    np.testing.assert_array_equal(dp.cam_idx.numpy(), np.asarray(dj.cam_idx))
    np.testing.assert_allclose(dp.boxes.numpy(), np.asarray(dj.boxes), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dp.scores.numpy(), np.asarray(dj.scores), rtol=1e-6)


def test_detect_singleframe_random_heads_keep_mask(random_nets):
    p, m = random_nets
    x = np.random.default_rng(7).uniform(-1, 1, (64, 96, 3)).astype(np.float32)
    dj = JR.detect_singleframe(p, jnp.asarray(x), depth=18, pre_topk=512, max_dets=16)
    dp = PR.detect_singleframe(m, torch.as_tensor(x), pre_topk=512, max_dets=16)
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))


def test_detect_singleframe_shapes(random_nets):
    """Mirror of ``tests/test_model.py::test_detect_singleframe_shapes``."""
    _, m = random_nets
    det = PR.detect_singleframe(m, torch.zeros(IMG + (3,)), pre_topk=512, max_dets=16)
    assert det.scores.shape == (16,)
    assert int(det.classes.max()) < 8


# --------------------------------------------------------------------------
# retinanet2d
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets2d():
    """Mirror of ``tests/test_retinanet2d.py``'s fixture (4 classes, depth
    18), with random output convs so the heads carry the backbone."""
    p = _init2d(jax.random.PRNGKey(0), num_classes=4, depth=18)
    rng = np.random.default_rng(9)
    for k in ("cls_out", "reg_out"):
        w = p["heads"][k]["w"]
        p["heads"][k]["w"] = jnp.asarray(rng.normal(0, 0.0015, w.shape).astype(np.float32))
    return p, params_from_jax_numpy(_np_tree(p), device="cpu")


def _logit(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


def test_decode_identity():
    anchors = torch.tensor([[10.0, 10, 30, 50]])
    out = P2.decode_boxes_2d(torch.zeros((1, 4)), anchors).numpy()
    np.testing.assert_allclose(out[0], [10, 10, 30, 50], atol=1e-5)


def test_decode_boxes_2d_matches_jax():
    rng = np.random.default_rng(1)
    anchors = PA.anchors_for_shape((64, 96))
    reg = rng.normal(0, 1, (2, anchors.shape[0], 4)).astype(np.float32)
    want = J2.decode_boxes_2d(jnp.asarray(reg), jnp.asarray(anchors))
    got = P2.decode_boxes_2d(torch.as_tensor(reg), torch.as_tensor(anchors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)


def test_init_matches_the_jax_tree_layout():
    """The port's init builds the JAX tree's keys and shapes (so checkpoints
    and the bridge carry across) with the focal-prior output convs."""
    from playground3d_tpu_torch.models.bridge import flatten_tree, to_jax_layout

    j = flatten_tree(_np_tree(_init2d(jax.random.PRNGKey(1), num_classes=4, depth=18)))
    m = P2.retinanet2d_init(torch.Generator().manual_seed(0), num_classes=4, depth=18, device="cpu")
    p = to_jax_layout(m)
    assert sorted(p) == sorted(j)
    assert all(p[k].shape == j[k].shape for k in j)
    for k in ("heads/cls_out/w", "heads/cls_out/b", "heads/reg_out/w", "heads/reg_out/b"):
        np.testing.assert_array_equal(p[k], j[k])


def test_forward_and_detect_shapes():
    """Mirror of ``tests/test_retinanet2d.py::test_forward_and_detect``."""
    m = P2.retinanet2d_init(torch.Generator().manual_seed(0), num_classes=4, depth=18, device="cpu")
    img = torch.zeros(IMG + (3,))
    cls, reg = P2.forward_raw_2d(m, img[None])
    a = PA.anchors_for_shape(IMG).shape[0]
    assert cls.shape == (1, a, 4) and reg.shape == (1, a, 4)
    scores, classes, boxes, mask = P2.detect_2d(m, img, pre_topk=256, max_dets=16)
    assert scores.shape == (16,) and boxes.shape == (16, 4)


@pytest.mark.parametrize("hw", [(64, 96), (65, 97)])
def test_forward_raw_2d_f32_matches_jax(nets2d, hw):
    p, m = nets2d
    x = np.random.default_rng(2).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    cj, rj = J2.forward_raw_2d(p, jnp.asarray(x), depth=18, num_classes=4, dtype=jnp.float32)
    cp, rp = P2.forward_raw_2d(m, torch.as_tensor(x), dtype=torch.float32)
    assert cp.shape == cj.shape and rp.shape == rj.shape
    _check(cp, cj, 1e-4, 1e-4)
    _check(rp, rj, 1e-4, 1e-4)


def test_forward_raw_2d_bf16_matches_jax(nets2d):
    p, m = nets2d
    x = np.random.default_rng(3).uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32)
    cj, rj = J2.forward_raw_2d(p, jnp.asarray(x), depth=18, num_classes=4)
    cp, rp = P2.forward_raw_2d(m, torch.as_tensor(x))
    # the bf16 logits are held as in test_torch_model.py (2e-2 of the
    # largest), recovered from the float32 sigmoids (every |logit| < 15)
    lj, lp = _logit(cj), _logit(cp.numpy())
    assert np.abs(lj).max() < 15
    np.testing.assert_allclose(lp, lj, rtol=2e-2, atol=2e-2 * np.abs(lj).max())
    _check(rp, rj, 2e-2, 2e-2)


def test_detect_2d_matches_jax():
    """Zero output convs with per-channel biases: the scores are exact in
    both packages, so the top-k, the class-grouped NMS and the boxes agree."""
    p = _init2d(jax.random.PRNGKey(2), num_classes=4, depth=18)
    rng = np.random.default_rng(4)
    p["heads"]["cls_out"]["b"] = jnp.asarray(rng.normal(-1.0, 1.0, 36).astype(np.float32))
    p["heads"]["reg_out"]["b"] = jnp.asarray(rng.normal(0.0, 0.3, 36).astype(np.float32))
    m = params_from_jax_numpy(_np_tree(p), device="cpu")
    x = np.random.default_rng(8).uniform(-1, 1, IMG + (3,)).astype(np.float32)
    sj, cj, bj, mj = J2.detect_2d(p, jnp.asarray(x), depth=18, num_classes=4, pre_topk=1000, max_dets=32)
    sp, cp, bp, mp = P2.detect_2d(m, torch.as_tensor(x), pre_topk=1000, max_dets=32)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
    assert mp.sum() > 4
    np.testing.assert_array_equal(cp.numpy(), np.asarray(cj))
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(sp.numpy(), np.asarray(sj), rtol=1e-6)


def _loss_inputs(rng, b=2, hw=IMG, k=4):
    anchors = PA.anchors_for_shape(hw)
    a = anchors.shape[0]
    ann = np.full((b, 6, 5), -1, np.float32)
    ann[0, 0] = [80, 50, 120, 80, 2]
    ann[0, 1] = [10, 10, 60, 40, 0]
    ann[0, 2] = [82, 52, 121, 79, 3]  # overlaps the first: the first greater IoU wins
    ann[1, 3] = [100, 20, 180, 100, 1]
    cls = rng.uniform(0.0, 1.0, (b, a, k)).astype(np.float32)
    reg = rng.normal(0, 0.5, (b, a, 4)).astype(np.float32)
    return cls, reg, ann, anchors


def test_focal_loss_2d_matches_jax():
    cls, reg, ann, anchors = _loss_inputs(np.random.default_rng(10))
    lj = J2.focal_loss_2d(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(ann), jnp.asarray(anchors))
    lp = P2.focal_loss_2d(torch.as_tensor(cls), torch.as_tensor(reg), torch.as_tensor(ann), torch.as_tensor(anchors))
    for got, want in zip(lp, lj):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        assert float(got) > 0


def test_focal_loss_2d():
    """Mirror of ``tests/test_retinanet2d.py::test_focal_loss_2d``."""
    anchors = torch.as_tensor(PA.anchors_for_shape(IMG))
    a = anchors.shape[0]
    ann = torch.full((1, 4, 5), -1.0)
    ann[0, 0] = torch.tensor([80, 50, 120, 80, 2.0])
    cls = torch.full((1, a, 4), 0.01)
    reg = torch.zeros((1, a, 4))
    l_cls, l_reg = P2.focal_loss_2d(cls, reg, ann, anchors)
    assert np.isfinite(float(l_cls)) and np.isfinite(float(l_reg))
    assert float(l_reg) > 0
    # empty annotations -> zero reg loss
    _, l_reg0 = P2.focal_loss_2d(cls, reg, torch.full((1, 4, 5), -1.0), anchors)
    assert float(l_reg0) == 0.0


def test_checkpoint_of_the_2d_tree_round_trips(tmp_path, nets2d):
    """The JAX ``save_params`` of a 2D tree loads into the port through
    ``load_params`` (the bridge builds a RetinaNet2D), and the port writes
    JAX's keys back."""
    p, m = nets2d
    path, back = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jax_save_params(path, p)
    got = load_params(path, m)
    assert isinstance(got, P2.RetinaNet2D) and got.num_classes == 4
    for k, v in m.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    save_params(back, got)
    with np.load(path) as jz, np.load(back) as pz:
        assert sorted(jz.files) == sorted(pz.files)
        assert all(np.array_equal(jz[k], pz[k]) for k in jz.files)
