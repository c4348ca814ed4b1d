"""Kalman filter, geometry transforms and the camera bank in the PyTorch
port against the JAX package.

KF floats within rtol 1e-5 (the absolute part scales with the largest
entry: covariances reach 1e4); geometry within rtol/atol 1e-4 (pixels and
feet at ~1e3 magnitude in float32, where lengths are differences of two
such coordinates and the frameworks contract multiply-adds differently).
Masked KF slots must come back bit for bit untouched.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.geometry import transforms as JT
from playground3d_tpu.geometry.homography import CameraRegistry as JaxRegistry
from playground3d_tpu.pipeline import camera_bank as JB
from playground3d_tpu_torch.geometry import transforms as PT
from playground3d_tpu_torch.geometry.homography import CameraRegistry
from playground3d_tpu_torch.pipeline import camera_bank as PB
from playground3d_tpu_torch.track import kf as PK

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


JK = importlib.import_module("playground3d_tpu.track.kf")


def _t(a):
    return torch.as_tensor(np.array(a))


def _slots(rng, n=12):
    A = rng.normal(0, 1, (n, 6, 6)).astype(np.float32)
    P = (A @ A.transpose(0, 2, 1) + np.eye(6, dtype=np.float32) * 2).astype(np.float32)
    x = rng.uniform([300, 0, 10, 5, 4, -40], [800, 120, 20, 8, 6, 40], (n, 6)).astype(np.float32)
    d = np.where(rng.uniform(0, 1, n) > 0.5, 1.0, -1.0).astype(np.float32)
    mask = rng.uniform(0, 1, n) > 0.3
    return (x, P, d, mask)


def _jslots(s):
    return JK.KFSlots(*(jnp.asarray(a) for a in s))


def _pslots(s):
    return PK.KFSlots(*(_t(a) for a in s))


def _close(p, j, tol=1e-5):
    j = np.asarray(j)
    np.testing.assert_allclose(p.numpy(), j, rtol=tol, atol=tol * max(1.0, np.abs(j).max()) * 1e-1)


def test_default_params_match():
    jp, pp = JK.default_params(), PK.default_params(device="cpu")
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(pp, name).numpy(), np.asarray(getattr(jp, name)))


def test_kf_view_and_predict(rng):
    s = _slots(rng)
    dt = rng.uniform(-0.1, 0.3, len(s[0])).astype(np.float32)
    jp, pp = JK.default_params(), PK.default_params(device="cpu")
    _close(PK.kf_view(_pslots(s), _t(dt), pp), JK.kf_view(_jslots(s), jnp.asarray(dt), jp))
    jo = JK.kf_predict(_jslots(s), jnp.asarray(dt), jp)
    po = PK.kf_predict(_pslots(s), _t(dt), pp)
    _close(po.x, jo.x)
    _close(po.P, jo.P)
    dead = ~s[3]
    assert torch.equal(po.x[dead], _t(s[0])[dead]) and torch.equal(po.P[dead], _t(s[1])[dead])


@pytest.mark.parametrize("midx", [1, 2, 3])
def test_kf_update(rng, midx):
    s = _slots(rng)
    m = 3 if midx == 3 else 5
    z = (s[0][:, 2:5] if midx == 3 else s[0][:, :5]) + rng.normal(0, 1, (len(s[0]), m))
    z = z.astype(np.float32)
    upd = rng.uniform(0, 1, len(s[0])) > 0.4
    jp, pp = JK.default_params(), PK.default_params(device="cpu")
    jo = JK.kf_update(_jslots(s), jnp.asarray(z), jnp.asarray(upd), jp, measurement_idx=midx)
    po = PK.kf_update(_pslots(s), _t(z), _t(upd), pp, measurement_idx=midx)
    _close(po.x, jo.x)
    _close(po.P, jo.P)
    untouched = ~(upd & s[3])
    assert torch.equal(po.x[untouched], _t(s[0])[untouched])
    assert torch.equal(po.P[untouched], _t(s[1])[untouched])


def test_spd_solve_clamps_instead_of_raising(rng):
    S = np.zeros((3, 5, 5), np.float32)  # singular: the pivot clamp keeps it finite
    S[1] = np.eye(5)
    B = rng.normal(0, 1, (3, 5, 6)).astype(np.float32)
    j = np.asarray(JK._spd_solve(jnp.asarray(S), jnp.asarray(B)))
    p = PK._spd_solve(_t(S), _t(B)).numpy()
    np.testing.assert_allclose(p, j, rtol=1e-5)


def test_kf_add_and_remove(rng):
    s = _slots(rng)
    n = len(s[0])
    new_x = rng.uniform(0, 100, (n, 6)).astype(np.float32)
    new_d = np.where(rng.uniform(0, 1, n) > 0.5, 1.0, -1.0).astype(np.float32)
    add = rng.uniform(0, 1, n) > 0.5
    cls = rng.integers(0, 8, n).astype(np.int32)
    jp, pp = JK.default_params(), PK.default_params(device="cpu")
    jo = JK.kf_add(_jslots(s), jnp.asarray(new_x), jnp.asarray(new_d), jnp.asarray(add), jp,
                   jnp.asarray(cls))
    po = PK.kf_add(_pslots(s), _t(new_x), _t(new_d), _t(add), pp, _t(cls))
    for a, b in zip(po, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rm = rng.uniform(0, 1, n) > 0.5
    assert np.array_equal(
        PK.kf_remove(po, _t(rm)).mask.numpy(), np.asarray(JK.kf_remove(jo, jnp.asarray(rm)).mask)
    )


def _im_boxes(rng, reg, n=20):
    """Image corners of random roadway states through camera rows."""
    states = rng.uniform([360, 0, 12, 5, 4, 0], [820, 120, 30, 9, 12, 1], (n, 6)).astype(np.float32)
    states[:, 5] = np.where(states[:, 5] > 0.5, 1.0, -1.0)
    cam = rng.integers(0, reg.num_cameras, n).astype(np.int32)
    return states, cam


def test_transforms(rng, toy_cameras3):
    reg = toy_cameras3["registry"]
    states, cam = _im_boxes(rng, reg)
    P = reg.P[cam, 0].astype(np.float32)
    H = reg.H[cam, 0].astype(np.float32)
    j_im = np.asarray(JT.state_to_im(jnp.asarray(states), jnp.asarray(P)))
    p_im = PT.state_to_im(_t(states), _t(P))
    np.testing.assert_allclose(p_im.numpy(), j_im, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        PT.state_to_space(_t(states)).numpy(), np.asarray(JT.state_to_space(jnp.asarray(states))), atol=1e-4
    )
    heights = states[:, 4]
    j_st = np.asarray(JT.im_to_state(jnp.asarray(j_im), jnp.asarray(H), jnp.asarray(heights)))
    p_st = PT.im_to_state(_t(j_im), _t(H), _t(heights))
    np.testing.assert_allclose(p_st.numpy(), j_st, rtol=1e-4, atol=1e-4)
    # shared (unbatched) camera matrices
    np.testing.assert_allclose(
        PT.space_to_im(PT.state_to_space(_t(states)), _t(P[0])).numpy(),
        np.asarray(JT.space_to_im(JT.state_to_space(jnp.asarray(states)), jnp.asarray(P[0]))),
        rtol=1e-4, atol=1e-4,
    )
    for name in ("space_footprint_xyxy",):
        sp = JT.state_to_space(jnp.asarray(states))
        np.testing.assert_allclose(
            getattr(PT, name)(_t(sp)).numpy(), np.asarray(getattr(JT, name)(sp)), atol=1e-4
        )
    np.testing.assert_allclose(PT.im_hull_xyxy(_t(j_im)).numpy(), np.asarray(JT.im_hull_xyxy(j_im)))
    np.testing.assert_allclose(
        PT.height_from_template(_t(j_im), _t(heights), _t(j_im * 1.1)).numpy(),
        np.asarray(JT.height_from_template(j_im, heights, j_im * 1.1)), rtol=1e-5,
    )
    sel = PT.select_eb_wb(_t(states[:, 1]), _t(H), _t(H * 2))
    np.testing.assert_array_equal(
        sel.numpy(), np.asarray(JT.select_eb_wb(states[:, 1], H, H * 2))
    )


def test_camera_bank(rng, toy_cameras3):
    reg = toy_cameras3["registry"]
    jbank = JB.bank_from_registry(reg)
    pbank = PB.bank_from_registry(reg, device="cpu")
    states, cam = _im_boxes(rng, reg, n=32)
    j_im = np.asarray(JB.state_to_im_banked(jbank, jnp.asarray(states), jnp.asarray(cam)))
    p_im = PB.state_to_im_banked(pbank, _t(states), _t(cam))
    np.testing.assert_allclose(p_im.numpy(), j_im, rtol=1e-4, atol=1e-4)

    heights = np.full(len(states), 5.0, np.float32)
    for fn in ("im_to_state_banked", "im_to_state_refined"):
        j = np.asarray(getattr(JB, fn)(jbank, jnp.asarray(j_im), jnp.asarray(cam), jnp.asarray(heights)))
        p = getattr(PB, fn)(pbank, _t(j_im), _t(cam), _t(heights))
        np.testing.assert_allclose(p.numpy(), j, rtol=1e-4, atol=1e-4)
    j = np.asarray(JB.refine_heights_banked(
        jbank, jnp.asarray(states), jnp.asarray(cam), jnp.asarray(j_im), jnp.asarray(heights)
    ))
    p = PB.refine_heights_banked(pbank, _t(states), _t(cam), _t(j_im), _t(heights))
    np.testing.assert_allclose(p.numpy(), j, rtol=1e-4, atol=1e-4)


def test_ignore_hits(rng):
    grid = rng.uniform(0, 1, (2, 6, 9)) > 0.5
    H = np.zeros((2, 2, 3, 3), np.float32)
    P = np.zeros((2, 2, 3, 4), np.float32)
    jbank = JB.CameraBank(H=jnp.asarray(H), P=jnp.asarray(P), ignore=jnp.asarray(grid), ignore_cell=8.0)
    pbank = PB.CameraBank(H=_t(H), P=_t(P), ignore=_t(grid), ignore_cell=8.0)
    centers = rng.uniform(-10, 90, (40, 2)).astype(np.float32)
    cam = rng.integers(0, 2, 40).astype(np.int32)
    np.testing.assert_array_equal(
        PB.ignore_hits(pbank, _t(centers), _t(cam)).numpy(),
        np.asarray(JB.ignore_hits(jbank, jnp.asarray(centers), jnp.asarray(cam))),
    )


def test_registry_fit_matches(toy_cameras3):
    """The port's numpy CameraRegistry fits the same correspondences."""
    proj = toy_cameras3["projectors"]["p1c2"]
    rng = np.random.default_rng(8)
    sp = np.stack([rng.uniform(480, 700, 24), rng.uniform(0, 120, 24)], 1)
    im = proj(np.concatenate([sp, np.zeros((24, 1))], 1))
    vps = np.array([[1e6, 540.0], [960.0, 1e6], proj(np.array([[640.0, 60.0, -1e7]]))[0]])
    jreg, preg = JaxRegistry(), CameraRegistry()
    jreg.add_camera("p1c2", im, sp, vps)
    preg.add_camera("p1c2", im, sp, vps)
    for k in ("H", "H_inv", "P"):
        np.testing.assert_allclose(preg.device_arrays()[k], jreg.device_arrays()[k], rtol=1e-6)


@pytest.mark.parametrize("name", [
    "CLASS_NAMES", "NUM_CLASSES", "CLASS_HEIGHTS", "CLASS_DIMS", "EB_WB_Y_SPLIT_FT",
    "IMAGENET_MEAN", "IMAGENET_STD", "DT_DEFAULT",
])
def test_constants_match(name):
    """The port's copy of the class and geometry tables equals the JAX
    package's, value for value."""
    jc = importlib.import_module("playground3d_tpu.utils.constants")
    from playground3d_tpu_torch.utils import constants as pc

    np.testing.assert_array_equal(np.asarray(getattr(pc, name)), np.asarray(getattr(jc, name)))
