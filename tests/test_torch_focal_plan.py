"""What the host decides for the training loss's CUDA kernels, tested without
a card: ``ops/focal_loss.py::launch_plan`` (the forward's split of tiles
over blocks, both kernels' shared memory, from shapes alone), that
``csrc/focal_loss.cu`` holds the same layout constants, and that the
forward's label cull, as its plain model ``assign_culled``, gives
``losses/focal.py::assign_plain``'s assignment bit for bit at its edges.
The kernels themselves are held against the plain version on the card
(``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from playground3d_tpu_torch.losses import focal as PF
from playground3d_tpu_torch.models.anchors import anchors_for_shape
from playground3d_tpu_torch.ops import focal_loss as FL

torch.set_num_threads(1)


def _walk(plan, g):
    """The flat tile indices (image-major) forward block g walks, as the
    kernel computes them from the plan."""
    t, ppi = plan.tiles, plan.parts_per_image
    img = g // ppi
    return list(range(img * t + g % ppi, (img + 1) * t, ppi))


def _check_plan(plan, b, a, k, m):
    assert plan.tiles == -(-a // FL.THREADS) and 1 <= plan.grid <= max(FL.SLOTS, b)
    walks = [_walk(plan, g) for g in range(plan.grid)]
    assert all(walks) and max(map(len, walks)) == plan.tiles_per_block
    flat = sorted(i for w in walks for i in w)
    assert flat == list(range(b * plan.tiles))  # every tile once
    # block g holds image g // ppi, in slot g % ppi of partials [B][ppi][4]
    assert plan.grid == b * plan.parts_per_image
    assert all({i // plan.tiles for i in w} == {g // plan.parts_per_image} for g, w in enumerate(walks))
    assert plan.partials == 4 * plan.grid
    assert plan.forward_smem == FL.HEADER_BYTES + m * FL.LABEL_BYTES <= 48 * 1024  # no opt-in needed
    assert plan.backward_smem == FL.THREADS * (k + FL.N_REG) * 4 <= 48 * 1024


@pytest.mark.parametrize("b,hw,ppi,grid,per_block", [
    (4, (512, 768), 66, 264, 5),  # the app's default
    (2, (1080, 1920), 132, 264, 12),  # TrainConfig's own shape
    (4, (112, 112), 10, 40, 1),  # the crop net: a block a tile
])
def test_launch_plan_at_the_three_shapes(b, hw, ppi, grid, per_block):
    a = anchors_for_shape(hw).shape[0]
    plan = FL.launch_plan(b, a)
    assert (plan.parts_per_image, plan.grid, plan.tiles_per_block) == (ppi, grid, per_block)
    assert (plan.forward_smem, plan.backward_smem) == (5008, 20480)
    _check_plan(plan, b, a, 8, 32)


@pytest.mark.parametrize("b,a,m,ppi", [
    (1, 1, 1, 1), (1, 400000, 64, 264), (17, 100, 16, 1), (17, 3000, 16, 12), (264, 10, 32, 1),
    (265, 600, 32, 1), (528, 300, 32, 1), (65535, 2394, 32, 1), (65535, 1, 64, 1),
])
def test_launch_plan_modes(b, a, m, ppi):
    """One split at every batch: min(SLOTS // b, tiles) blocks an image, at
    least one (one block an image above SLOTS images)."""
    plan = FL.launch_plan(b, a, 8, m)
    assert (plan.parts_per_image, plan.grid) == (ppi, b * ppi)
    if b * plan.tiles < 20000:
        _check_plan(plan, b, a, 8, m)


@settings(max_examples=200, deadline=None, database=None)
@given(b=st.integers(1, 65535), a=st.integers(1, 400000), k=st.integers(1, 16), m=st.integers(1, 64))
def test_launch_plan_limits(b, a, k, m):
    """Grid and shared memory stay inside the card's limits at every batch
    the kernels take (the tile walk is checked where it is small)."""
    if b * a * FL.N_REG >= 2 ** 40:
        with pytest.raises(ValueError, match="40-bit"):
            FL.launch_plan(b, a, k, m)
        return
    plan = FL.launch_plan(b, a, k, m)
    assert 1 <= plan.grid <= max(FL.SLOTS, b) <= 65535 and plan.forward_smem <= FL.MAX_SHARED_BYTES
    assert plan.backward_smem <= FL.MAX_SHARED_BYTES and plan.partials == 4 * plan.grid
    if b * plan.tiles <= 3000:
        _check_plan(plan, b, a, k, m)


@pytest.mark.parametrize("b,a,k,m", [(0, 10, 8, 32), (65536, 10, 8, 32), (4, 0, 8, 32), (4, 10, 17, 32),
                                     (4, 10, 8, 65), (4, 10, 8, 0)])
def test_launch_plan_refuses_what_the_kernels_do_not_take(b, a, k, m):
    with pytest.raises(ValueError, match="focal_loss"):
        FL.launch_plan(b, a, k, m)


def _cu_constants():
    """The integer ``constexpr int`` values of csrc/focal_loss.cu, each
    initialiser evaluated with the constants defined before it."""
    env = {}
    for mt in re.finditer(r"constexpr int (\w+) = ([^;]+);", FL.SOURCE.read_text()):
        env[mt.group(1)] = eval(mt.group(2), {"__builtins__": {}}, dict(env))
    return env


@pytest.mark.parametrize("cu_name,py_value", [
    ("kThreads", FL.THREADS), ("kGroup", FL.GROUP), ("kMaxLabels", FL.MAX_LABELS),
    ("kMaxClasses", FL.MAX_CLASSES), ("kReg", FL.N_REG), ("kAnn", FL.N_ANN), ("kSms", FL.SMS),
    ("kBlocksPerSm", FL.BLOCKS_PER_SM), ("kSlots", FL.SLOTS), ("kHeaderBytes", FL.HEADER_BYTES),
    ("kLabelBytes", FL.LABEL_BYTES),
])
def test_kernel_source_holds_the_plans_constants(cu_name, py_value):
    """The launcher in the .cu computes grid and shared memory by
    launch_plan's rule and refuses a launch where they differ: both sides
    must hold the same layout."""
    assert _cu_constants()[cu_name] == py_value


def test_kernel_source_holds_the_cull_bound():
    mt = re.search(r"constexpr float kBig = ([0-9.]+)f;", FL.SOURCE.read_text())
    assert float(mt.group(1)) == FL.BIG == 2.0 ** 60


# --- the cull ---------------------------------------------------------------

HW = (112, 112)  # 14 x 14 cells: the 8-pixel level ends inside a group of 32 anchors
ANCHORS = anchors_for_shape(HW)


def _box(x0, y0, x1, y1, cls=1):
    lab = np.zeros(21, np.float32)
    for k in range(8):
        lab[2 * k] = x0 if k % 2 == 0 else x1
        lab[2 * k + 1] = y1 if k < 4 else y0
    lab[16:20] = x0, y0, x1, y1
    lab[20] = cls
    return lab


def _group_hull(g, anchors=ANCHORS):
    w = anchors[FL.GROUP * g : FL.GROUP * (g + 1)]
    return w[:, 0].min(), w[:, 1].min(), w[:, 2].max(), w[:, 3].max()


def _ann(*rows, m=8):
    ann = np.full((1, m, 21), -1.0, np.float32)
    for j, r in enumerate(rows):
        if r is not None:
            ann[0, j] = r
    return ann


def _same(ann, anchors=ANCHORS):
    an, ann = torch.as_tensor(anchors), torch.as_tensor(ann)
    best, arg = PF.assign_plain(an, ann)
    best_c, arg_c = FL.assign_culled(an, ann)
    assert torch.equal(arg_c, arg)
    assert torch.equal(best_c >= PF.POS_IOU, best >= PF.POS_IOU)
    assert torch.equal(best_c < PF.NEG_IOU, best < PF.NEG_IOU)
    assert torch.equal(best_c == -1.0, best == -1.0)
    return FL.kept_labels(an, ann), best, arg


def test_a_label_that_only_touches_a_group_is_culled_there_and_scores_zero():
    g = 20
    x0, y0, x1, y1 = _group_hull(g)
    first = _box(x0 + 4, y0 + 4, x0 + 20, y0 + 20)  # overlaps group g
    touch = _box(x1, y0, x1 + 30, y1, cls=2)  # its left edge on the group's right edge
    (keep, start), best, arg = _same(_ann(first, touch))
    assert not keep[0, g, 1] and keep[0, g, 0] and start[0, g] == -1
    an, hull = torch.as_tensor(ANCHORS[FL.GROUP * g : FL.GROUP * (g + 1)]), torch.as_tensor(touch[None])
    iou, _ = PF.assign_plain(an, hull[None])
    assert (iou == 0).all()  # exactly 0 at every anchor of the group


def test_every_iou_zero_the_first_valid_label_wins():
    """Labels beyond every anchor: each IoU is 0, so the first valid label
    (after padding) wins everywhere; the cull starts there and evaluates
    nothing."""
    far = [_box(5000 + 10 * j, 5000, 5020 + 10 * j, 5020) for j in range(3)]
    (keep, start), best, arg = _same(_ann(None, None, *far))
    assert (arg == 2).all() and (best == 0).all()
    assert not keep.any() and (start == 2).all()


def test_padding_rows_between_valid_rows():
    rng = np.random.default_rng(3)
    rows = [None if j % 2 else _box(*sorted(rng.uniform(-20, 130, 2)), *sorted(rng.uniform(-20, 130, 2)))
            for j in range(16)]
    rows = [None if r is None else np.concatenate([r[:16], r[16:20], [j % 8]]).astype(np.float32)
            for j, r in enumerate(rows)]
    (keep, _), _, arg = _same(_ann(*rows, m=16))
    assert not keep[..., 1::2].any()  # padding is never evaluated
    assert set(arg.unique().tolist()) <= set(range(0, 16, 2))


@pytest.mark.parametrize("where", [0, 2, 16, 17])
def test_a_nan_coordinate(where):
    """A NaN corner coordinate: the label's hull is NaN, it is kept
    wherever it is valid (no comparison rules it out) and never wins. As
    the first valid label it does not start the cull: the next bounded
    label does, and is kept even where it is disjoint."""
    g = 20
    x0, y0, x1, y1 = _group_hull(g)
    nan = _box(x0, y0, x1, y1)
    nan[where] = np.nan
    far = _box(5000, 5000, 5020, 5020, cls=3)  # disjoint from every group
    near = _box(x0 + 2, y0 + 2, x1 - 2, y1 - 2, cls=4)
    (keep, start), best, arg = _same(_ann(None, nan, far, near))
    if where < 16:  # a corner: the hull is NaN
        assert keep[0, :, 1].all() and not (arg == 1).any()
        assert keep[0, :, 2].all() and (start == -1).all()  # f = 2 starts the cull, evaluated
    else:  # the 2D box is not part of the hull: an ordinary first label, over group g
        assert keep[0, g, 1] and (start[0] != 1).all() and not keep[0, g, 2]


def test_an_image_with_no_valid_label():
    ann = _ann(None, None, m=4)
    ann[0, 1, :20] = 50.0  # coordinates but class -1
    (keep, start), best, arg = _same(ann)
    assert not keep.any() and (start == -1).all() and (arg == 0).all() and (best == -1).all()


def test_a_group_that_spans_two_pyramid_levels():
    l3 = 14 * 14 * 9
    g = l3 // FL.GROUP
    assert l3 % FL.GROUP and FL.GROUP * g < l3 < FL.GROUP * (g + 1)  # the group holds both levels' anchors
    x0, y0, x1, y1 = _group_hull(g)
    small = ANCHORS[FL.GROUP * g : l3]
    rows = [_box(x0 + 1, y0 + 1, x0 + 30, y0 + 30), _box(x1, y0, x1 + 20, y1, 2),
            _box(float(small[:, 0].max()) + 1, float(small[:, 1].max()) + 1, x1 - 1, y1 - 1, 3)]
    (keep, _), _, _ = _same(_ann(*rows))
    assert keep[0, g, 0] and not keep[0, g, 1] and keep[0, g, 2]


@pytest.mark.parametrize("case", ["first_beyond_2^60", "inf", "anchor_nan", "anchor_beyond_2^60"])
def test_values_beyond_the_bound(case):
    """A first label beyond 2^60 or infinite is kept everywhere and does not
    start the cull; a group with a NaN anchor or one beyond 2^60 keeps every
    valid label."""
    anchors = ANCHORS.copy()
    wide = _box(-(2.0 ** 62), 10, 2.0 ** 62, 20)
    if case == "inf":
        wide[0] = -np.inf
    if case == "anchor_nan":
        anchors[5, 2] = np.nan
    if case == "anchor_beyond_2^60":
        anchors[40, 0] = -(2.0 ** 61)
    rows = [wide if case in ("first_beyond_2^60", "inf") else _box(2, 2, 30, 30), _box(5000, 5000, 5010, 5010, 2),
            _box(40, 40, 90, 90, 3)]
    (keep, start), _, _ = _same(_ann(*rows), anchors)
    if case in ("first_beyond_2^60", "inf"):
        assert keep[0, :, 0].all() and keep[0, :, 1].all()  # f is row 1: every row up to it kept
    else:
        g = 0 if case == "anchor_nan" else 1
        assert keep[0, g, :3].all() and start[0, g] == -1


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n=st.integers(0, 32), pad=st.floats(0.0, 0.5))
def test_random_labels_match_the_plain_loop(seed, n, pad):
    """Random boxes at 112x112, dyadic, some exactly on group edges, with
    padding rows mixed in."""
    rng = np.random.default_rng(seed)
    rows = []
    for j in range(n):
        if rng.random() < pad:
            rows.append(None)
            continue
        if rng.random() < 0.3:
            x0, y0, x1, y1 = _group_hull(int(rng.integers(0, len(ANCHORS) // FL.GROUP)))
            rows.append(_box(x1, y0, x1 + 16.0, y1, j % 8) if rng.random() < 0.5 else _box(x0, y1, x1, y1 + 8.0))
        else:
            c = rng.integers(-40, 152, 2) / 4.0
            s = rng.integers(8, 400, 2) / 4.0
            rows.append(_box(c[0], c[1], c[0] + s[0], c[1] + s[1], j % 8))
    _same(_ann(*rows, m=32))
