"""IoU, NMS and the auction in the PyTorch port against the JAX package.

IoU within 1e-6; NMS keep indices/masks and auction assignments exactly
equal (the port runs the same float32 arithmetic in the same order, with
the JAX tie-breaks). On the CPU the port runs the plain versions; the CUDA
kernels (``csrc/nms.cu``, ``csrc/auction.cu``) are held against those on
the card by ``chip_smoke.py``; their launch plans and layout constants are
checked here.
"""

import importlib
import re
from pathlib import Path

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
    if kind == "car_512":
        # the single camera's 512 tied candidates: one car box repeated at
        # 8 px steps, suppressed one link of the chain a round
        i = np.arange(512)
        boxes = np.stack([8.0 * (i % 64), 8.0 * (i // 64), 8.0 * (i % 64) + 180.0, 8.0 * (i // 64) + 90.0], 1)
        return boxes.astype(np.float32), np.full(512, 0.5, np.float32), np.ones(512, bool)
    if kind == "all_masked":
        return _boxes(rng, n), rng.uniform(0, 1, n).astype(np.float32), np.zeros(n, bool)
    if kind == "single":
        return _boxes(rng, 1), np.ones(1, np.float32), np.ones(1, bool)
    if kind == "long_chain":
        # neighbours overlap at IoU 0.54, boxes two apart at 0.25: at 0.3 each
        # box is suppressed by the one before it only while that one is kept,
        # so the fixed point takes a round for every other box
        x = np.arange(64, dtype=np.float32) * 3.0
        boxes = np.stack([x, np.zeros(64), x + 10.0, np.full(64, 10.0)], 1)
        return boxes.astype(np.float32), np.linspace(1.0, 0.1, 64).astype(np.float32), np.ones(64, bool)
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


@pytest.mark.parametrize("kind", ["random", "score_ties", "negative_coords", "chain", "car_512", "all_masked",
                                  "single", "long_chain"])
@pytest.mark.parametrize("max_keep", [16, 64])
def test_nms_exact(rng, kind, max_keep):
    boxes, scores, mask = _nms_case(rng, kind)
    ji, jm = JN.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), 0.3, max_keep=max_keep)
    pi, pm = PN.nms(_t(boxes), _t(scores), _t(mask), 0.3, max_keep=max_keep)
    assert pi.dtype == torch.int32 and pm.dtype == torch.bool
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("kind", ["random", "score_ties", "negative_coords", "car_512", "all_masked"])
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


@pytest.mark.parametrize("n_iter", [1, 3, 7])
def test_nms_iteration_cap_exact(rng, n_iter):
    """A suppression chain stopped at ``n_iter`` rounds, before its fixed
    point: the same partial result as JAX's capped ``while_loop``."""
    boxes, scores, mask = _nms_case(rng, "long_chain")
    args = (0.3,)
    ji, jm = JN.nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(mask), *args, max_keep=64, n_iter=n_iter)
    before = HostSyncs.by_loop["nms"]
    pi, pm = PN.nms(_t(boxes), _t(scores), _t(mask), *args, max_keep=64, n_iter=n_iter)
    assert HostSyncs.by_loop["nms"] - before == n_iter  # the cap, not the fixed point, ended the loop
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    full = PN.nms(_t(boxes), _t(scores), _t(mask), *args, max_keep=64)
    assert not torch.equal(full[1], pm)


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


@pytest.mark.parametrize("kind", ["tie_heavy_unmasked", "capped", "all_rows_masked", "k1"])
def test_auction_edges_exact(rng, kind):
    """Edges of the auction against JAX: the tracker's 64 x 48 tie-heavy
    benefit with every entry real, a ``max_iters`` cap that stops it early,
    every row masked, and a 1 x 1 problem; the uncapped ones also against
    scipy's optimum."""
    b, rm, cm = _benefit(rng, 64, 48, "ties")
    max_iters = 5000
    if kind == "tie_heavy_unmasked":
        rm, cm = np.ones(64, bool), np.ones(48, bool)
    elif kind == "capped":
        max_iters = 5
    elif kind == "all_rows_masked":
        rm = np.zeros(64, bool)
    elif kind == "k1":
        b, rm, cm = np.full((1, 1), 0.7, np.float32), np.ones(1, bool), np.ones(1, bool)
    ref = np.asarray(JA.assign_auction(jnp.asarray(b), jnp.asarray(rm), jnp.asarray(cm), max_iters=max_iters))
    before = HostSyncs.by_loop["auction"]
    got = PA.assign_auction(_t(b), _t(rm), _t(cm), max_iters=max_iters).numpy()
    np.testing.assert_array_equal(got, ref)
    if kind == "capped":
        assert HostSyncs.by_loop["auction"] - before == max_iters
        return
    masked = np.where(rm[:, None] & cm[None, :], b, 0.0)
    opt = PA.assign_hungarian(masked)
    best = sum(masked[r, c] for r, c in enumerate(opt) if c >= 0)
    assert sum(masked[r, c] for r, c in enumerate(got) if c >= 0) >= best - 1e-3 * max(best, 1.0)
    if kind == "all_rows_masked":
        assert np.all(got == -1)
    if kind == "k1":
        assert got.tolist() == [0]


_CSRC = Path(PN.__file__).resolve().parents[1] / "csrc"


def _cu_constant(source, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", (_CSRC / source).read_text()).group(1))


@pytest.mark.parametrize("source, name, value", [
    ("nms.cu", "kMaxBoxes", PN.MAX_BOXES),
    ("nms.cu", "kMaxPerThread", PN.MAX_PER_THREAD),
    ("nms.cu", "kSmemMaxBoxes", PN.SMEM_MAX_BOXES),
    ("nms.cu", "kMaxCluster", PN.MAX_CLUSTER),
    ("nms.cu", "kClusterBoxes", PN.CLUSTER_BOXES),
    ("nms.cu", "kRegWords", PN.REG_WORDS),
    ("auction.cu", "kMaxK", PA.MAX_K),
    ("auction.cu", "kSmemMaxK", PA.SMEM_MAX_K),
    ("auction.cu", "kSmemMaxThreads", PA.SMEM_MAX_THREADS),
])
def test_kernel_sources_hold_the_plans_constants(source, name, value):
    """The C launchers recompute launch_plan's threads and shared memory and
    refuse a mismatch: both sides hold the same limits."""
    assert _cu_constant(source, name) == value


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 48, 64, 512, 1000, 1024, 1025, 4096, 8192])
def test_nms_launch_plan(n):
    """The rounds: a thread a box in whole warps up to 1,024 threads, then
    up to MAX_PER_THREAD boxes a thread; a word per 32 boxes for each box.
    Up to SMEM_MAX_BOXES one cluster launch of 1,024-thread CTAs (all of
    them compute beats words; the rounds take the first round_threads of
    the leader), the table in the leader's shared memory (a CTA per 64
    boxes in powers of two, at most 8); above it the [words, n] table and
    the shifted boxes in a workspace, and the loop block's keep words in
    shared memory."""
    plan = PN.launch_plan(n)
    assert plan.round_threads % 32 == 0 and 32 <= plan.round_threads <= plan.threads <= 1024
    assert plan.round_threads * plan.per_thread >= n and plan.per_thread <= PN.MAX_PER_THREAD
    assert plan.per_thread == 1 or plan.round_threads == 1024
    assert plan.words * 32 >= n and (plan.words - 1) * 32 < max(n, 1)
    assert plan.one_launch == (n <= PN.SMEM_MAX_BOXES)
    assert plan.threads == (1024 if plan.one_launch else plan.round_threads)
    if plan.one_launch:
        assert plan.cluster in (1, 2, 4, 8) and (plan.cluster == 1 or (plan.cluster // 2) * PN.CLUSTER_BOXES < n)
        assert plan.cluster * PN.CLUSTER_BOXES >= n or plan.cluster == PN.MAX_CLUSTER
        assert plan.workspace_words == 0 and plan.per_thread <= 2
        assert plan.shared_bytes >= 4 * plan.words * n + 24 * n and plan.shared_bytes <= PN.MAX_SHARED_BYTES
    else:
        assert plan.cluster == 0 and plan.shared_bytes == 4 * plan.words + 4
        assert plan.workspace_words == plan.words * n + 4 * n


@pytest.mark.parametrize("n, m", [(64, 48), (48, 64), (1, 1), (3, 2), (224, 10), (225, 10), (300, 260), (200, 1024)])
def test_auction_launch_plan(n, m):
    """A block of 32 * ceil(k / 4) threads up to 256 with the formed
    benefit in shared memory (odd row stride) up to SMEM_MAX_K, within the
    card's 227 KB; 1,024 threads and the benefit formed on the fly above.
    A group of lanes per bidder, a power of two within a warp."""
    plan = PA.launch_plan(n, m)
    k = max(n, m)
    assert plan.k == k and plan.threads >= k and plan.threads % 32 == 0
    assert plan.benefit_in_shared == (k <= PA.SMEM_MAX_K)
    if plan.benefit_in_shared:
        assert plan.threads == min(PA.SMEM_MAX_THREADS, 32 * -(-k // 4))
        assert plan.row_stride % 2 == 1 and k <= plan.row_stride <= k + 1
    else:
        assert plan.threads == 1024 and plan.row_stride == 0 and plan.lanes == 32
    assert plan.lanes in (4, 8, 16, 32) and plan.threads % plan.lanes == 0
    assert plan.shared_bytes == k * plan.row_stride * 4 + 8 * k * 4 + 16
    assert plan.shared_bytes <= 232448


@pytest.mark.parametrize("call", [lambda: PN.launch_plan(8193), lambda: PA.launch_plan(1025, 3),
                                  lambda: PA.launch_plan(0, 0)])
def test_launch_plans_refuse_what_the_kernels_cannot_take(call):
    with pytest.raises(ValueError, match="kernel takes"):
        call()
