"""The training loss in the PyTorch port against the JAX package's.

Same seeded numpy inputs through ``playground3d_tpu.losses.focal.
detection_loss`` and ``playground3d_tpu_torch.losses.focal.detection_loss``
on the CPU (the plain version; the CUDA kernels are held against it on the
card by ``chip_smoke.py``): batch 2, the 4,608 anchors of 128x192, 8
classes, 32 label rows. The inputs carry the edge cases: an image with no
valid label, hulls equal to an anchor (IoU 1.0), IoUs exactly at and just
either side of 0.4 and 0.5 (dyadic boxes, so every IoU is exact in either
rounding order), classification exactly at both clamp bounds and beyond
them, and zero-length axis vectors in the regression and in the labels.

Tolerances: the three losses within 1e-5 relative (float32 sums over
36,864 terms taken in another order); gradients with respect to
classification and regression within 1e-5 relative + 1e-7 absolute (the
same arithmetic, other rounding order); the assignment (argmax, positive,
negative) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.losses import focal as JF
from playground3d_tpu_torch.losses import focal as PF
from playground3d_tpu_torch.models.anchors import anchors_for_shape
from playground3d_tpu_torch.ops import focal_loss as FL

torch.set_num_threads(1)

HW = (128, 192)
K, M = 8, 32
LO, HI = np.float32(1e-4), np.float32(1.0 - 1e-4)


def _box_label(x0, y0, x1, y1, cls):
    """A label whose 16 corners span exactly [x0,y0,x1,y1]: left corners at
    x0, right at x1, bottom at y1, top at y0 (front and back coincide, so
    the length axis vector is zero)."""
    lab = np.zeros(21, np.float32)
    for k in range(8):
        lab[2 * k] = x0 if k % 2 == 0 else x1
        lab[2 * k + 1] = y1 if k < 4 else y0
    lab[16:20] = x0, y0, x1, y1
    lab[20] = cls
    return lab


def _random_label(rng, cls):
    """A box-like label: centre, half length / width / height vectors and
    the decode sign pattern, in the image's lower part."""
    c = np.array([rng.uniform(30, 170), rng.uniform(80, 120)])
    l, w, h = (rng.normal(0, 1, 2) * s for s in (10.0, 6.0, 8.0))
    S = np.array(PF._SIGNS)
    corners = c + S[:, 0, None] * l + S[:, 1, None] * w + S[:, 2, None] * h
    lab = np.zeros(21, np.float32)
    lab[:16] = corners.reshape(-1)
    lab[16:18], lab[18:20] = corners.min(0), corners.max(0)
    lab[20] = cls
    return lab


def _cell_anchor(y, x):
    """Index and box of the 32x32 level-3 anchor of cell (y, x)."""
    return (y * (HW[1] // 8) + x) * 9 + 3, np.array([8 * x - 12, 8 * y - 12, 8 * x + 20, 8 * y + 20], np.float32)


# edge labels: (cell, box relative to the anchor's x0, y0, x1, y1, IoU)
_EDGES = [
    ((3, 2), lambda a: (a[0], a[1], a[2], a[3]), 1.0),
    ((3, 8), lambda a: (a[0], a[1], a[0] + 16, a[3]), 0.5),
    ((3, 14), lambda a: (a[0], a[1], a[0] + 15.9375, a[3]), 0.498046875),
    ((3, 20), lambda a: (a[0], a[1], a[0] + 13, a[3]), 0.40625),
    ((6, 2), lambda a: (a[0], a[1], a[0] + 12.75, a[3]), 0.3984375),
    ((6, 10), lambda a: (a[0], a[1] - 24, a[2], a[3] + 24), 0.4),
]


def _inputs(scenario: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    anchors = anchors_for_shape(HW)
    a = anchors.shape[0]
    ann = np.full((2, M, 21), -1.0, np.float32)
    if scenario == "edges":
        rows = [_box_label(*fn(_cell_anchor(*cell)[1]), cls=j % K) for j, (cell, fn, _) in enumerate(_EDGES)]
        rows += [_random_label(rng, rng.integers(0, K)) for _ in range(10)]
        ann[0, : len(rows)] = rows  # image 1 has no valid label
    else:  # "full": 32 labels in image 0, one in image 1
        ann[0] = [_random_label(rng, rng.integers(0, K)) for _ in range(M)]
        ann[1, 5] = _random_label(rng, 3)
    cls = (1.0 / (1.0 + np.exp(-rng.normal(-2.0, 1.5, (2, a, K))))).astype(np.float32)
    reg = rng.normal(0.0, 0.5, (2, a, 12)).astype(np.float32)
    if scenario == "edges":
        i1 = _cell_anchor(3, 2)[0]  # a positive anchor of class 0
        cls[0, i1] = [LO, HI, 5e-5, 0.99995, LO, HI, 0.3, 0.7]
        cls[0, i1 + 9] = [HI, LO, 1e-6, 1.0, 0.5, LO, HI, 0.2]  # a neighbour
        cls[1, :4] = [[LO] * K, [HI] * K, [0.0] * K, [1.0] * K]
        reg[0, i1, 2:4] = 0.0  # zero-length regressed length vector
        reg[0, _cell_anchor(3, 8)[0], 4:8] = 0.0
    return cls, reg, ann, anchors


def _jax_assignment(anchors, ann):
    def one(a):
        valid = a[:, 20] >= 0
        iou_max, arg = JF._assign(jnp.asarray(anchors), a, valid)
        has = jnp.any(valid)
        return arg, (iou_max >= JF.POS_IOU) & has, (iou_max < JF.NEG_IOU) | ~has

    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(jnp.asarray(ann))]


def _port_assignment(anchors, ann):
    iou_max, arg = PF.assign_plain(torch.as_tensor(anchors), torch.as_tensor(ann))
    has = torch.as_tensor(ann[..., 20] >= 0).any(1)[:, None]
    return arg.numpy(), ((iou_max >= PF.POS_IOU) & has).numpy(), ((iou_max < PF.NEG_IOU) | ~has).numpy()


@pytest.mark.parametrize("scenario", ["edges", "full"])
def test_losses_match_jax(scenario):
    cls, reg, ann, anchors = _inputs(scenario)
    want = [float(x) for x in JF.detection_loss(*map(jnp.asarray, (cls, reg, ann, anchors)))]
    got = [float(x) for x in PF.detection_loss(*map(torch.as_tensor, (cls, reg, ann, anchors)))]
    assert all(np.isfinite(got)) and want[1] > 0 and want[2] > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("scenario", ["edges", "full"])
def test_assignment_matches_jax(scenario):
    _, _, ann, anchors = _inputs(scenario)
    want, got = _jax_assignment(anchors, ann), _port_assignment(anchors, ann)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert got[1].sum() > 20  # there are positives to train on


def test_edge_ious_fall_where_they_should():
    """The dyadic edge boxes give IoUs exactly 1.0, 0.5, 0.498, 0.406,
    0.398 and 0.4 at their anchors: positive at 1.0 and 0.5, ignored at
    0.498, 0.406 and exactly 0.4, negative at 0.398."""
    _, _, ann, anchors = _inputs("edges")
    iou_max, arg = PF.assign_plain(torch.as_tensor(anchors), torch.as_tensor(ann))
    arg_j, pos, neg = _port_assignment(anchors, ann)
    for j, (cell, _, iou) in enumerate(_EDGES):
        i = _cell_anchor(*cell)[0]
        assert float(iou_max[0, i]) == np.float32(iou) and int(arg[0, i]) == j
        assert bool(pos[0, i]) == (iou >= 0.5) and bool(neg[0, i]) == (np.float32(iou) < np.float32(0.4))
    assert not pos[1].any() and neg[1].all()  # the empty image: every anchor negative


@pytest.mark.parametrize("scenario", ["edges", "full"])
@pytest.mark.parametrize("cot", [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0), (1.0, 0.7, 1.3)])
def test_gradients_match_jax(scenario, cot):
    """d(cot . (cls, reg, vp)) / d classification and / d regression."""
    cls, reg, ann, anchors = _inputs(scenario)
    _, vjp = jax.vjp(lambda c, r: JF.detection_loss(c, r, jnp.asarray(ann), jnp.asarray(anchors)),
                     jnp.asarray(cls), jnp.asarray(reg))
    want = [np.asarray(g) for g in vjp(tuple(jnp.float32(c) for c in cot))]
    c_t = torch.tensor(cls, requires_grad=True)
    r_t = torch.tensor(reg, requires_grad=True)
    out = PF.detection_loss(c_t, r_t, torch.as_tensor(ann), torch.as_tensor(anchors))
    got = torch.autograd.grad(out, (c_t, r_t), grad_outputs=[torch.tensor(c) for c in cot], allow_unused=True)
    for g, w in zip(got, want):
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
    if cot[0]:
        assert np.abs(want[0]).max() > 0


def test_clamp_bound_gradient_is_half_of_the_interior_one():
    """At exactly 1e-4 or 1 - 1e-4 the class gradient is half the one just
    inside the bound (JAX's ``jnp.clip``, where torch's ``clamp`` would
    pass all of it); beyond the bounds it is 0."""
    cls, reg, ann, anchors = _inputs("edges")
    i1 = _cell_anchor(3, 2)[0]

    def grad_row(row):
        c = cls.copy()
        c[0, i1] = row
        c_t = torch.tensor(c, requires_grad=True)
        PF.detection_loss(c_t, torch.as_tensor(reg), torch.as_tensor(ann), torch.as_tensor(anchors))[0].backward()
        return c_t.grad[0, i1].numpy()

    row = cls[0, i1]
    on_bound = (row == LO) | (row == HI)
    beyond = (row < LO) | (row > HI)
    inside = np.where(row == LO, np.nextafter(LO, np.float32(1)), np.where(row == HI, np.nextafter(HI, np.float32(0)), row))
    g, g_in = grad_row(row), grad_row(inside.astype(np.float32))
    assert on_bound.sum() == 4 and beyond.sum() == 2
    np.testing.assert_allclose(g[on_bound], 0.5 * g_in[on_bound], rtol=1e-3)
    assert (g[beyond] == 0).all() and (g_in[on_bound] != 0).all()


def test_no_label_image_is_all_negative_with_zero_targets():
    """An image without a valid label assigns row 0 (class -1): every anchor
    is a negative with an all-zero one-hot, and its reg and vp terms are 0."""
    cls, reg, ann, anchors = _inputs("edges")
    empty = tuple(torch.as_tensor(x[1:]) for x in (cls, reg, ann)) + (torch.as_tensor(anchors),)
    c, r, v = PF.detection_loss_plain(*empty)
    want = float(np.sum(0.75 * np.clip(cls[1], LO, HI) ** 2 * -np.log(1 - np.clip(cls[1], LO, HI))))
    np.testing.assert_allclose(float(c), want, rtol=1e-5)
    assert float(r) == 0.0 and float(v) == 0.0


def test_autograd_function_routes_the_kernels_gradients(monkeypatch):
    """``FocalLoss`` (the card's path) with its two kernels stood in for by
    the plain version on the CPU: the losses it returns and the gradients
    it hands back are the plain version's, and grad_output reaches the
    backward as one [3] tensor."""
    cls, reg, ann, anchors = _inputs("edges")
    seen = {}

    def fwd(c, r, a, an):
        losses = torch.stack(PF.detection_loss_plain(c, r, a, an)).detach()
        iou_max, arg = PF.assign_plain(an, a)
        return losses, torch.ones(c.shape[0]), arg, torch.zeros(arg.shape, dtype=torch.uint8)

    def bwd(c, r, a, an, argmax, flags, num_pos, grad_out):
        seen["grad_out"] = grad_out.clone()
        c, r = c.detach().requires_grad_(True), r.detach().requires_grad_(True)
        with torch.enable_grad():  # a Function's backward runs without grad mode
            return torch.autograd.grad(PF.detection_loss_plain(c, r, a, an), (c, r), grad_outputs=list(grad_out))

    monkeypatch.setattr(FL, "focal_loss_forward_cuda", fwd)
    monkeypatch.setattr(FL, "focal_loss_backward_cuda", bwd)
    c_t, r_t = torch.tensor(cls, requires_grad=True), torch.tensor(reg, requires_grad=True)
    out = FL.FocalLoss.apply(c_t, r_t, torch.as_tensor(ann), torch.as_tensor(anchors))
    (out[0] + 2.0 * out[2]).backward()  # reg unused: its grad_output is None
    assert seen["grad_out"].tolist() == [1.0, 0.0, 2.0]
    c_p, r_p = torch.tensor(cls, requires_grad=True), torch.tensor(reg, requires_grad=True)
    ref = PF.detection_loss_plain(c_p, r_p, torch.as_tensor(ann), torch.as_tensor(anchors))
    (ref[0] + 2.0 * ref[2]).backward()
    assert [float(x.detach()) for x in out] == [float(x.detach()) for x in ref]
    assert torch.equal(c_t.grad, c_p.grad) and torch.equal(r_t.grad, r_p.grad)


@pytest.mark.parametrize("bad", ["cls_rank", "reg_width", "ann_width", "anchors_count", "dtype"])
def test_check_args_refuses_what_the_kernel_does_not_take(bad):
    cls, reg, ann, anchors = (torch.as_tensor(x) for x in _inputs("full"))
    args = {"cls_rank": (cls[0], reg, ann, anchors), "reg_width": (cls, reg[..., :8], ann, anchors),
            "ann_width": (cls, reg, ann[..., :20], anchors), "anchors_count": (cls, reg, ann, anchors[:-1]),
            "dtype": (cls.double(), reg, ann, anchors)}[bad]
    with pytest.raises(ValueError, match="detection_loss"):
        FL.check_args(*args)


def test_cuda_wrappers_refuse_cpu_tensors():
    cls, reg, ann, anchors = (torch.as_tensor(x) for x in _inputs("full"))
    with pytest.raises(ValueError, match="CUDA"):
        FL.focal_loss_forward_cuda(cls, reg, ann, anchors)
    z = torch.zeros
    with pytest.raises(ValueError, match="CUDA"):
        FL.focal_loss_backward_cuda(cls, reg, ann, anchors, z((2, 4608), dtype=torch.int32),
                                    z((2, 4608), dtype=torch.uint8), z(2), z(3))
    assert FL.LIB._lib is None  # nothing built on the CPU
