"""IoU, NMS and the auction in the PyTorch port against the JAX package.

IoU within 1e-6; NMS keep indices/masks and auction assignments exactly
equal (the port runs the same float32 arithmetic in the same order, with
the JAX tie-breaks).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

JA = importlib.import_module("playground3d_tpu.ops.assignment")
JI = importlib.import_module("playground3d_tpu.ops.iou")
JN = importlib.import_module("playground3d_tpu.ops.nms")
from playground3d_tpu_torch.ops import assignment as PA
from playground3d_tpu_torch.ops import iou as PI
from playground3d_tpu_torch.ops import nms as PN
from playground3d_tpu_torch.ops.topk import HostSyncs, top_k

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


def _boxes(rng, n, lo=0.0, span=100.0, size=(5.0, 40.0)):
    xy = rng.uniform(lo, lo + span, (n, 2))
    wh = rng.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_pairwise_and_elementwise_iou(rng):
    a, b = _boxes(rng, 17), _boxes(rng, 11)
    np.testing.assert_allclose(
        PI.pairwise_iou(_t(a), _t(b)).numpy(), np.asarray(JI.pairwise_iou(a, b)), atol=1e-6
    )
    c = _boxes(rng, 11)
    c[3, 2:] = c[3, :2]  # zero-area box: union guard
    np.testing.assert_allclose(
        PI.elementwise_iou(_t(b), _t(c)).numpy(), np.asarray(JI.elementwise_iou(b, c)), atol=1e-6
    )


def test_top_k_puts_the_lower_index_first_on_ties():
    v = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0])
    vals, idx = top_k(v, 4)
    assert idx.tolist() == [1, 2, 4, 3] and vals.tolist() == [3.0, 3.0, 3.0, 2.0]


def _nms_case(rng, kind):
    n = 48
    if kind == "random":
        boxes, scores = _boxes(rng, n), rng.uniform(0, 1, n)
    elif kind == "score_ties":
        boxes, scores = _boxes(rng, n, size=(20.0, 60.0)), rng.integers(0, 4, n) / 4.0
    elif kind == "negative_coords":
        boxes, scores = _boxes(rng, n, lo=-80.0, span=60.0), rng.uniform(0, 1, n)
    elif kind == "chain":
        # each box overlaps only its neighbours, scores falling along the
        # chain: greedy keeps every other box (a long suppression chain)
        x = np.arange(n, dtype=np.float32) * 6.0
        boxes = np.stack([x, np.zeros(n), x + 10.0, np.full(n, 10.0)], 1)
        scores = np.linspace(1.0, 0.1, n)
    mask = rng.uniform(0, 1, n) > 0.15
    return boxes.astype(np.float32), scores.astype(np.float32), mask


@pytest.mark.parametrize("kind", ["random", "score_ties", "negative_coords", "chain"])
@pytest.mark.parametrize("max_keep", [16, 64])
def test_nms_exact(rng, kind, max_keep):
    boxes, scores, mask = _nms_case(rng, kind)
    ji, jm = JN.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), 0.3, max_keep=max_keep)
    pi, pm = PN.nms(_t(boxes), _t(scores), _t(mask), 0.3, max_keep=max_keep)
    assert pi.dtype == torch.int32 and pm.dtype == torch.bool
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kind", ["random", "score_ties", "negative_coords"])
def test_batched_nms_exact(rng, kind):
    boxes, scores, mask = _nms_case(rng, kind)
    groups = rng.integers(0, 3, len(boxes)).astype(np.int32)
    ji, jm = JN.batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(groups), jnp.asarray(mask), 0.3,
        max_keep=40,
    )
    pi, pm = PN.batched_nms(_t(boxes), _t(scores), _t(groups), _t(mask), 0.3, max_keep=40)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


def test_nms_counts_one_host_sync_per_round(rng):
    boxes, scores, mask = _nms_case(rng, "chain")
    before, nms_before = HostSyncs.count, HostSyncs.by_loop["nms"]
    PN.nms(_t(boxes), _t(scores), _t(mask), 0.3, max_keep=8)
    assert HostSyncs.count - before >= 2
    assert HostSyncs.by_loop["nms"] - nms_before == HostSyncs.count - before


def _benefit(rng, n, m, kind):
    b = rng.uniform(0, 1, (n, m)).astype(np.float32)
    if kind == "sparse_iou":
        b = np.where(rng.uniform(0, 1, (n, m)) > 0.85, b, 0.0).astype(np.float32)
    elif kind == "ties":
        b = (rng.integers(0, 3, (n, m)) / 2.0).astype(np.float32)
    rm = rng.uniform(0, 1, n) > 0.2
    cm = rng.uniform(0, 1, m) > 0.2
    return b, rm, cm


@pytest.mark.parametrize("kind", ["dense", "sparse_iou", "ties"])
@pytest.mark.parametrize("shape", [(16, 12), (12, 16), (64, 48)])
def test_auction_exact_and_optimal(rng, kind, shape):
    b, rm, cm = _benefit(rng, *shape, kind)
    ref = np.asarray(JA.assign_auction(jnp.asarray(b), jnp.asarray(rm), jnp.asarray(cm)))
    got = PA.assign_auction(_t(b), _t(rm), _t(cm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)

    # optimal against the scipy Hungarian on the masked problem
    masked = np.where(rm[:, None] & cm[None, :], b, 0.0)
    opt = PA.assign_hungarian(masked)
    best = sum(masked[r, c] for r, c in enumerate(opt) if c >= 0)
    g = got.numpy()
    total = sum(masked[r, c] for r, c in enumerate(g) if c >= 0)
    assert total >= best - 1e-3 * max(best, 1.0)
    assert len(set(c for c in g if c >= 0)) == int((g >= 0).sum())  # one-to-one
    assert not np.any(g[~rm] >= 0)
