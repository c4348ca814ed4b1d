"""The host side of ``csrc/nms.cu`` and ``csrc/auction.cu``: their launch
plans, the auction's column key and ``batched_nms``'s groups.

The kernels run only on the card (``chip_smoke.py`` holds them against the
plain versions there, bit for bit and round for round). Here: the plans the
C launchers recompute and refuse on a mismatch (both NMS routes, the
cluster size by n, shared memory within the 232,448 bytes a Hopper block
may opt into; the auction's block, lane groups and shared memory), the
order of the auction kernel's column key, the positive bids that key
relies on (read from the plain version), ``batched_nms`` on the CPU
against JAX with the groups the card's wrapper now takes, and the
recording of launches that the smoke run replays.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu_torch.ops import assignment as PA
from playground3d_tpu_torch.ops import nms as PN

JN = importlib.import_module("playground3d_tpu.ops.nms")

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("n, cluster", [(0, 1), (1, 1), (48, 1), (64, 1), (65, 2), (128, 2), (129, 4), (256, 4),
                                        (257, 8), (512, 8), (1024, 8), (PN.SMEM_MAX_BOXES, 8)])
def test_nms_one_launch_cluster_by_n(n, cluster):
    """A cluster CTA for each 64 boxes, in powers of two up to the portable
    8: the tracker's n 48 and 64 run in one CTA, the detector's 512 in 8.
    Every CTA has 1,024 threads (a warp a beats word); the rounds take a
    thread a box of the leader's."""
    plan = PN.launch_plan(n)
    assert plan.one_launch and plan.cluster == cluster and plan.threads == 1024
    assert plan.round_threads == min(1024, max(32, -(-n // 32) * 32)) and plan.workspace_words == 0


@pytest.mark.parametrize("n", [1, 48, 64, 512, 1000, 1024, PN.SMEM_MAX_BOXES])
def test_nms_one_launch_shared_bytes(n):
    """The leader's [words][n] table, the staged boxes (float4), masked
    scores and areas, keep words (two buffers) and mask words padded to
    whole uint4s (16 words while the rounds keep columns in registers, up to
    n 512), four words: within what a block may opt into."""
    plan = PN.launch_plan(n)
    words4 = PN.REG_WORDS if n <= 32 * PN.REG_WORDS else -(-plan.words // 4) * 4
    assert plan.shared_bytes == 4 * plan.words * n + 16 * n + 8 * n + 12 * words4 + 16
    assert plan.shared_bytes <= PN.MAX_SHARED_BYTES


def test_nms_route_switch_at_smem_max():
    """SMEM_MAX_BOXES is the largest n whose one-launch layout fits; one
    past it runs the two-launch route (a beats grid, then the loop block as
    its programmatic dependent), whose block needs only its keep words."""
    at, past = PN.launch_plan(PN.SMEM_MAX_BOXES), PN.launch_plan(PN.SMEM_MAX_BOXES + 1)
    assert at.one_launch and not past.one_launch
    assert PN.SMEM_MAX_BOXES >= 1024
    n = PN.SMEM_MAX_BOXES + 1
    words = -(-n // 32)
    one_launch_bytes_past = 4 * words * n + 24 * n + 12 * (-(-words // 4) * 4) + 16
    assert one_launch_bytes_past > PN.MAX_SHARED_BYTES >= at.shared_bytes
    assert past.cluster == 0 and past.shared_bytes == 4 * words + 4
    assert past.workspace_words == 4 * n + words * n


@pytest.mark.parametrize("k, threads, lanes", [(1, 32, 4), (4, 32, 4), (5, 64, 4), (16, 128, 4), (17, 160, 8),
                                               (48, 256, 8), (64, 256, 8), (65, 256, 16), (224, 256, 16),
                                               (225, 1024, 32), (1024, 1024, 32)])
def test_auction_plan_threads_and_lanes(k, threads, lanes):
    """32 * ceil(k / 4) threads capped at 256 while the benefit is in shared
    memory (the tracker's 64 x 48: 8 warps, not 32), 1,024 above;
    groups of 4 lanes up to k 16, 8 up to 64, 16 up to SMEM_MAX_K, a warp
    above."""
    for n, m in ((k, max(1, k // 2)), (max(1, k // 3), k)):
        plan = PA.launch_plan(n, m)
        assert (plan.k, plan.threads, plan.lanes) == (k, threads, lanes)
        assert plan.threads // plan.lanes >= 8  # at least 8 bidders served at once


@pytest.mark.parametrize("k", [1, 2, 63, 64, 223, 224, 225, 1024])
def test_auction_plan_shared_bytes(k):
    """The benefit at an odd row stride (k or k + 1) up to SMEM_MAX_K, then
    eight [k] arrays (price, best_of, bid_of, the bidder list, two parities
    of column keys and winners) and four words; within 232,448 bytes."""
    plan = PA.launch_plan(k, k)
    stride = (k | 1) if k <= PA.SMEM_MAX_K else 0
    assert plan.row_stride == stride
    assert plan.shared_bytes == 4 * k * stride + 32 * k + 16 <= 232448


def _bid_key(bids: np.ndarray) -> np.ndarray:
    """csrc/auction.cu's column key of a bid: its float32 bits as uint32."""
    return np.ascontiguousarray(bids, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("scale", [1e-12, 1e-6, 1.0, 1e6, 3e38])
def test_auction_bid_key_orders_positive_floats(rng, scale):
    """For positive float32 (denormals to the largest) the key's unsigned
    order is the float order, ties included, and 0 is below every key: the
    kernel's atomicMax of keys is the plain version's amax of bids."""
    x = (rng.uniform(0, 1, 4096) * scale).astype(np.float32)
    x = np.concatenate([x, x[:64], np.float32([np.finfo(np.float32).tiny / 8, np.finfo(np.float32).max])])
    x = x[x > 0]
    keys = _bid_key(x)
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"), np.argsort(x, kind="stable"))
    assert _bid_key(x.max()) == keys.max() and keys.min() > 0
    assert np.array_equal(keys[:, None] < keys[None, :], x[:, None] < x[None, :])


class _BidSpy:
    """The ``torch`` the plain auction sees, recording each round's bids:
    the one ``torch.where`` whose third argument is all NEG (``bid_eff``)."""

    def __init__(self):
        self.bids = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def where(self, cond, a, b):
        if (cond.dtype == torch.bool and cond.ndim == 1 and isinstance(b, torch.Tensor) and b.is_floating_point()
                and b.ndim == 1 and bool((b == PA.NEG).all())):
            self.bids.append(a[cond].clone())
        return torch.where(cond, a, b)


@pytest.mark.parametrize("kind", ["ties", "sparse_iou", "dense", "k1"])
def test_plain_auction_bids_are_positive(rng, monkeypatch, kind):
    """Every bid of a bidding row is > 0 (prices start at 0 and only take
    bids, best - second >= 0, eps > 0): the premise of the kernel's key."""
    n, m = (1, 1) if kind == "k1" else (64, 48)
    b = rng.uniform(0, 1, (n, m)).astype(np.float32)
    if kind == "ties":
        b = (rng.integers(0, 3, (n, m)) / 2.0).astype(np.float32)
    elif kind == "sparse_iou":
        b = np.where(rng.uniform(0, 1, (n, m)) > 0.85, b, 0.0).astype(np.float32)
    rm, cm = rng.uniform(0, 1, n) < 0.8, rng.uniform(0, 1, m) < 0.8
    if kind == "k1":
        rm, cm = np.ones(1, bool), np.ones(1, bool)
    spy = _BidSpy()
    monkeypatch.setattr(PA, "torch", spy)
    PA.assign_auction_plain(torch.as_tensor(b), torch.as_tensor(rm), torch.as_tensor(cm), max_iters=600)
    assert len(spy.bids) > 0
    bids = torch.cat(spy.bids)
    assert bids.numel() >= len(spy.bids) and bool((bids > 0).all())


def _boxes(rng, n, lo=0.0, span=100.0, size=(5.0, 40.0)):
    xy = rng.uniform(lo, lo + span, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], 1).astype(np.float32)


@pytest.mark.parametrize("kind", ["negative_coords", "all_in_one_group", "masked_extremes"])
def test_batched_nms_cpu_matches_jax_with_groups(rng, kind):
    """``batched_nms`` on the CPU (``group_shift``'s ops, then the plain
    loop) equal to JAX's; the card's wrapper takes the same groups as an
    argument (the kernel shifts) and refuses CPU tensors before anything
    else."""
    n = 96
    boxes = _boxes(rng, n, lo=-900.0 if kind == "negative_coords" else 0.0)
    scores = (rng.integers(0, 4, n) / 3).astype(np.float32)
    mask = rng.uniform(0, 1, n) < 0.8
    groups = np.zeros(n, np.int32) if kind == "all_in_one_group" else rng.integers(0, 3, n).astype(np.int32)
    if kind == "masked_extremes":  # masked-out boxes far out must not move the shift
        boxes[~mask] *= 1e4
    ji, jm = JN.batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(groups), jnp.asarray(mask), 0.3,
                            max_keep=40)
    t = [torch.as_tensor(a) for a in (boxes, scores, groups, mask)]
    pi, pm = PN.batched_nms(t[0], t[1], t[2], t[3], 0.3, max_keep=40)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    with pytest.raises(ValueError, match="CUDA tensors"):
        PN.nms_cuda(t[0], t[1], t[3], 0.3, 40, groups=t[2])


def _cut_above(inter: np.ndarray, union: np.ndarray, thr: float) -> np.ndarray:
    """csrc/nms.cu's division-free test of ``inter / union > thr`` for thr
    0 or a normal float: inter > mu * union in double, mu the midpoint
    between thr and the next float."""
    thr = np.float32(thr) + np.float32(0.0)
    up = (np.array([thr], np.float32).view(np.uint32) + np.uint32(1)).view(np.float32)[0]
    mu = (np.float64(thr) + np.float64(up)) * 0.5
    return inter.astype(np.float64) > mu * union.astype(np.float64)


@pytest.mark.parametrize("thr", [0.5, 0.3, 0.2, 0.4, 1e-6, 0.0, 0.7, 1.0, 1.1754944e-38])
def test_iou_cut_without_division_equals_float32_division(rng, thr):
    """The kernel's exact IoU test: for the correctly rounded float32
    quotient, fl(inter / union) > thr if and only if inter > mu * union
    (exact in double); held against numpy's float32 division on pairs near
    the threshold (a few ulps either side, where rounding decides) and on
    random ones, at union scales from 1e-8 to 1e20."""
    thr = np.float32(thr)
    for scale in (1e-8, 1e-3, 1.0, 1e3, 1e6, 1e20):
        union = np.maximum((rng.uniform(1e-8, 1.0, 20000) * scale).astype(np.float32), np.float32(1e-8))
        near = union.astype(np.float64) * np.float64(thr) * (1 + rng.integers(-40, 40, union.size) * 2.0**-24)
        for inter in (np.maximum(near.astype(np.float32), np.float32(0.0)),
                      (rng.uniform(0, 1, union.size) * union).astype(np.float32)):
            with np.errstate(all="ignore"):
                want = (inter / union) > thr  # float32 / float32: correctly rounded
            np.testing.assert_array_equal(_cut_above(inter, union, thr), want)


@pytest.mark.parametrize("wrapper", [PN.nms_cuda, PA.assign_auction_cuda])
def test_calls_recorded_lists_launches_instead_of_counting(wrapper):
    """Inside ``calls_recorded`` a wrapper's launch is listed with its
    arguments, the tensors cloned, and its count stays as it was (the
    smoke run replays the main path's NMS and auction calls this way)."""
    from playground3d_tpu_torch.ops.cuda_build import calls_recorded, count_launch

    before = wrapper.launches
    boxes = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    with calls_recorded() as seen:
        count_launch(wrapper, (boxes, 0.5, None))
    boxes += 1.0
    assert wrapper.launches == before and len(seen) == 1
    got_wrapper, (got_boxes, thr, none) = seen[0]
    assert got_wrapper is wrapper and thr == 0.5 and none is None
    assert torch.equal(got_boxes, torch.arange(8, dtype=torch.float32).reshape(2, 4))
    count_launch(wrapper)
    assert wrapper.launches == before + 1
    wrapper.launches = before


def test_calls_recorded_refuses_to_nest():
    from playground3d_tpu_torch.ops.cuda_build import calls_recorded

    with calls_recorded():
        with pytest.raises(RuntimeError, match="already recording"):
            with calls_recorded():
                pass
    with calls_recorded() as seen:  # the first recording ended cleanly
        assert seen == []
