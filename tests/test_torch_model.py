"""The detector in the PyTorch port against the JAX package, weights carried
across by the bridge.

``forward_raw`` at float32 within rtol/atol 1e-4 (relative to the largest
output), at even and odd extents (pins the ``"SAME"`` padding, the head
flatten order and the BN fold); at bf16 within 2e-2 of the largest output
(the frameworks round bf16 intermediates at different places).
``detect_multiframe`` keep indices and mask exactly equal with focal-prior
heads, where every logit ties and the tie-breaks decide the set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models import retinanet as JR
from playground3d_tpu_torch.models import nn as PNN
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


_init = jax.jit(jax_init, static_argnames=("depth", "stem", "tower_depth", "shared_tower", "feature_size"))


def _randomize_heads(p, rng, std=0.02):
    """Non-zero output convs, so the heads carry the backbone's signal."""
    for k in ("cls_out", "reg_out"):
        w = p["heads"][k]["w"]
        p["heads"][k]["w"] = jnp.asarray(rng.normal(0, std, w.shape).astype(np.float32))
        b = p["heads"][k]["b"]
        p["heads"][k]["b"] = jnp.asarray(rng.normal(0, 0.1, b.shape).astype(np.float32))
    return p


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


@pytest.fixture(scope="module")
def nets():
    rng = np.random.default_rng(5)
    p18 = _randomize_heads(_init(jax.random.PRNGKey(0), depth=18, stem="conv7"), rng)
    # BN statistics away from identity so the fold is exercised
    for blk in p18["backbone"]["layer2"]:
        for k in ("bn1", "bn2"):
            ch = blk[k]["mean"].shape[0]
            blk[k] = {
                "scale": jnp.asarray(rng.uniform(0.5, 1.5, ch).astype(np.float32)),
                "offset": jnp.asarray(rng.normal(0, 0.1, ch).astype(np.float32)),
                "mean": jnp.asarray(rng.normal(0, 0.1, ch).astype(np.float32)),
                "var": jnp.asarray(rng.uniform(0.5, 2.0, ch).astype(np.float32)),
            }
    return p18, params_from_jax_numpy(_np_tree(p18), device="cpu")


def _check(p, j, rtol, scale_tol):
    j = np.asarray(j, np.float32)
    p = p.to(torch.float32).numpy()
    np.testing.assert_allclose(p, j, rtol=rtol, atol=scale_tol * np.abs(j).max())


@pytest.mark.parametrize("hw", [(64, 96), (65, 97)])
def test_forward_raw_f32(nets, hw):
    p18, m18 = nets
    x = np.random.default_rng(1).uniform(-1, 1, (2,) + hw + (3,)).astype(np.float32)
    cj, rj = JR.forward_raw(p18, jnp.asarray(x), depth=18, dtype=jnp.float32)
    cp, rp = PR.forward_raw(m18, torch.as_tensor(x), dtype=torch.float32)
    assert cp.shape == cj.shape and rp.shape == rj.shape
    _check(cp, cj, 1e-4, 1e-4)
    _check(rp, rj, 1e-4, 1e-4)


def test_forward_raw_bf16_score_path(nets):
    p18, m18 = nets
    x = np.random.default_rng(2).integers(0, 256, (1, 64, 96, 3)).astype(np.uint8)
    cj, aj, rj = JR.forward_raw(p18, jnp.asarray(x), depth=18, compact=True, score_path=True)
    cp, ap, rp = PR.forward_raw(m18, torch.as_tensor(x), compact=True, score_path=True)
    assert cp.dtype == torch.bfloat16 and ap.dtype == torch.int32
    _check(cp, cj, 2e-2, 2e-2)
    _check(rp, rj, 2e-2, 2e-2)
    # the class argmax agrees wherever JAX's top class is clear of the runner-up
    assert np.mean(ap.numpy() == np.asarray(aj)) > 0.9


def test_localize(nets):
    p18, m18 = nets
    crops = np.random.default_rng(3).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    bj, cj = JR.localize(p18, jnp.asarray(crops), depth=18)
    bp, cp = PR.localize(m18, torch.as_tensor(crops))
    assert bp.shape == bj.shape and cp.shape == cj.shape
    _check(cp, cj, 2e-2, 2e-2)
    _check(bp, bj, 2e-2, 2e-2)
    # at float32 the decode itself is held tight
    bp32, cp32 = PR.localize(m18, torch.as_tensor(crops), dtype=torch.float32)
    cjf, rjf = JR.forward_raw(p18, jnp.asarray(crops), depth=18, dtype=jnp.float32)
    from playground3d_tpu.models.anchors import anchors_for_shape
    from playground3d_tpu.models.decode import decode_regression

    bjf = decode_regression(rjf, jnp.asarray(anchors_for_shape((32, 32))))
    _check(bp32, bjf, 1e-4, 1e-4)
    _check(cp32, cjf, 1e-4, 1e-4)


@pytest.mark.parametrize("hw", [(64, 96), (65, 97)])
def test_detect_multiframe_focal_prior_ties(hw):
    """Focal-prior heads (+3 on the class bias, as the dryrun does): every
    logit is equal, so the top-k and NMS tie-breaks pick the whole set."""
    p = _init(jax.random.PRNGKey(4), depth=18, stem="conv7")
    p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    m = params_from_jax_numpy(_np_tree(p), device="cpu")
    x = np.random.default_rng(6).integers(0, 256, (3,) + hw + (3,)).astype(np.uint8)
    dj = JR.detect_multiframe(p, jnp.asarray(x), depth=18, pre_topk=128, max_dets=32)
    dp = PR.detect_multiframe(m, torch.as_tensor(x), pre_topk=128, max_dets=32)
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))
    np.testing.assert_array_equal(dp.cam_idx.numpy(), np.asarray(dj.cam_idx))
    np.testing.assert_array_equal(dp.classes.numpy(), np.asarray(dj.classes))
    np.testing.assert_allclose(dp.boxes.numpy(), np.asarray(dj.boxes), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(dp.scores.numpy(), np.asarray(dj.scores), rtol=1e-6)


def test_detect_multiframe_random_heads_keep_mask(nets):
    """With distinct logits (bf16 forward) the kept slots agree."""
    p18, m18 = nets
    x = np.random.default_rng(7).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    dj = JR.detect_multiframe(p18, jnp.asarray(x), depth=18, pre_topk=64, max_dets=16)
    dp = PR.detect_multiframe(m18, torch.as_tensor(x), pre_topk=64, max_dets=16)
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))
    assert dp.boxes.shape == dj.boxes.shape


def test_approx_topk_is_refused(nets):
    """The TPU's approximation is refused in the sense that matters: the
    port accepts ``approx_topk=True`` and runs its exact top-k (what JAX's
    ``approx_max_k`` returns off the TPU), so the flag changes nothing in
    the port, and the kept slots agree with JAX's run of the same flag
    (with random heads the bf16 logits differ in their last bits, so only
    the mask is compared, as in the test above; ``tests/test_torch_single_cam.py``
    compares every field on logits that both packages compute exactly)."""
    p18, m18 = nets
    x = np.random.default_rng(8).integers(0, 256, (2, 64, 96, 3)).astype(np.uint8)
    dj = JR.detect_multiframe(p18, jnp.asarray(x), depth=18, pre_topk=64, max_dets=16, approx_topk=True)
    dp = PR.detect_multiframe(m18, torch.as_tensor(x), pre_topk=64, max_dets=16, approx_topk=True)
    de = PR.detect_multiframe(m18, torch.as_tensor(x), pre_topk=64, max_dets=16)
    np.testing.assert_array_equal(dp.mask.numpy(), np.asarray(dj.mask))
    for a, b in zip(dp, de):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,k,s,expect", [
    (64, 7, 2, (2, 3)), (65, 7, 2, (3, 3)), (64, 3, 2, (0, 1)), (65, 3, 2, (1, 1)),
    (32, 3, 1, (1, 1)), (7, 1, 2, (0, 0)),
])
def test_same_padding_splits_like_xla(n, k, s, expect):
    assert PNN.same_pads(n, k, s) == expect


def test_max_pool_pads_with_neg_inf():
    x = -torch.ones((1, 1, 4, 4)) * 5.0  # all negative: a zero pad would win
    out = PNN.max_pool(x, 3, 2)
    assert out.shape == (1, 1, 2, 2) and torch.all(out == -5.0)
    jx = jnp.asarray(-np.ones((1, 5, 5, 1), np.float32) * 5.0)
    from playground3d_tpu.models.nn import max_pool as jax_max_pool

    np.testing.assert_array_equal(
        PNN.max_pool(torch.as_tensor(np.array(jx)).permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jax_max_pool(jx, 3, 2)),
    )

