"""The slice as a whole: the multi-camera clip tracker (conv7 stems, uint8
frames) in the PyTorch port against the JAX package.

The scenario is the JAX package's multichip dryrun (``__graft_entry__.py``)
on the ``toy_cameras3`` fixture: random-init ResNet-18 detector and crop
net with the class bias raised by 3 so detections fire, live tracks seeded
one per camera, and a cadence that takes the detect, crop and passthrough
branches. JAX weights are carried into the port by the bridge. Per frame
``ids``, ``raw_mask`` and ``classes`` must be equal, ``states7`` within
rtol/atol 1e-4; the final ``kf.x``, ``kf.P`` and ``ts_bias`` within 1e-4
(relative, since covariances reach 1e4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
from playground3d_tpu.pipeline.multi_cam import make_mc_clip_step as jax_clip_step
from playground3d_tpu.pipeline.tracker_state import init_track_state as jax_init_state
from playground3d_tpu.track.kf import default_params as jax_kf_params
from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker, make_mc_clip_step
from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
from playground3d_tpu_torch.track.kf import default_params
from playground3d_tpu_torch.utils.config import TrackerConfig

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


T_CLIP = 6
BASE = dict(
    max_tracks=16, max_dets=16, pre_topk=128, x_range=(320.0, 880.0), f_init=1,
    det_step=3, skip_step=2, cd_max=8, cs=32, crop_slots=8,
    sigma_d=0.003, sigma_c=0.003, sigma_min=0.003,
)
SHIPPED = dict(size_nudge=True, crop_conf_gate=True, tentative_age=4)
SHIPPED_FULL_GATE = dict(SHIPPED, sigma_c=0.5)  # the gate shuts: crop frames coast


@pytest.fixture(scope="module")
def setup(toy_cameras3):
    init = jax.jit(jax_init, static_argnames=("depth", "stem", "tower_depth", "shared_tower"))
    det = init(jax.random.PRNGKey(0), depth=18, stem="conv7")
    crop = init(jax.random.PRNGKey(1), depth=18, stem="conv7", tower_depth=2, shared_tower=True)
    for p in (det, crop):
        p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    rng = np.random.default_rng(21)
    C = len(toy_cameras3["ranges"])
    frames = rng.integers(0, 256, (T_CLIP, C, 64, 96, 3)).astype(np.uint8)
    cam_times = (np.arange(T_CLIP)[:, None] / 30.0 + np.zeros((1, C))).astype(np.float32)
    return dict(
        jax_det=det, jax_crop=crop,
        det=params_from_jax_numpy(to_np(det), device="cpu"),
        crop=params_from_jax_numpy(to_np(crop), device="cpu"),
        frames=frames, cam_times=cam_times,
        bias0=np.array([0.0, 0.01, -0.02], np.float32),
    )


def _seed(state, ranges, n_slots):
    """Live tracks at the centre of each camera's range (the dryrun's seed)."""
    n = len(ranges)
    kfx = np.zeros((n_slots, 6), np.float32)
    kfx[:n, 0] = [(a + b) / 2.0 for a, b in ranges]
    kfx[:n, 1] = 60.0
    kfx[:n, 2:5] = (18.0, 6.0, 5.0)
    kfx[:n, 5] = 80.0
    kfP = np.tile(np.eye(6, dtype=np.float32)[None] * 0.5, (n_slots, 1, 1))
    mask = np.arange(n_slots) < n
    fields = dict(
        ids=np.where(mask, np.arange(n_slots), -1).astype(np.int32),
        age=np.where(mask, 5, 0).astype(np.int32),
        conf_cnt=mask.astype(np.float32),
        conf_sum=mask.astype(np.float32) * 0.9,
    )
    if isinstance(state.ids, torch.Tensor):
        t = torch.as_tensor
        return state._replace(
            kf=state.kf._replace(x=t(kfx), P=t(kfP), mask=t(mask)),
            next_id=torch.tensor(n, dtype=torch.int32), **{k: t(v) for k, v in fields.items()},
        )
    j = jnp.asarray
    return state._replace(
        kf=state.kf._replace(x=j(kfx), P=j(kfP), mask=j(mask)),
        next_id=jnp.asarray(n, jnp.int32), **{k: j(v) for k, v in fields.items()},
    )


def _run_jax(setup, toy_cameras3, knobs):
    cfg = JaxConfig(**knobs)
    clip = jax_clip_step(
        setup["jax_det"], 18, jax_bank(toy_cameras3["registry"]),
        jnp.asarray(toy_cameras3["centers"]), jax_kf_params(), cfg,
        crop_params=setup["jax_crop"], crop_depth=18, stem="conv7", crop_stem="conv7",
    )
    state0 = _seed(jax_init_state(cfg.max_tracks), list(toy_cameras3["ranges"].values()), cfg.max_tracks)
    return clip(
        state0, jnp.asarray(setup["bias0"]), jnp.asarray(setup["frames"]),
        jnp.asarray(setup["cam_times"]), jnp.int32(0),
    )


def _run_port(setup, toy_cameras3, knobs):
    cfg = TrackerConfig(**knobs)
    clip = make_mc_clip_step(
        setup["det"], bank_from_registry(toy_cameras3["registry"], device="cpu"),
        torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), cfg,
        crop_model=setup["crop"],
    )
    state0 = _seed(init_track_state(cfg.max_tracks, "cpu"), list(toy_cameras3["ranges"].values()),
                   cfg.max_tracks)
    return clip(
        state0, torch.as_tensor(setup["bias0"]), torch.as_tensor(setup["frames"]),
        torch.as_tensor(setup["cam_times"]), 0,
    )


@pytest.mark.parametrize("knobs", [BASE, dict(BASE, **SHIPPED), dict(BASE, **SHIPPED_FULL_GATE)],
                         ids=["reference", "shipped", "shipped_gate_shut"])
def test_clip_matches_jax(setup, toy_cameras3, knobs):
    js, jb, jsn = _run_jax(setup, toy_cameras3, knobs)
    ps, pb, psn = _run_port(setup, toy_cameras3, knobs)
    raw = np.asarray(jsn.raw_mask)
    assert raw[:4, :3].all(), "the seeded tracks are live through the first crop frame"
    for i in range(T_CLIP):
        np.testing.assert_array_equal(psn.ids[i].numpy(), np.asarray(jsn.ids[i]), err_msg=f"ids {i}")
        np.testing.assert_array_equal(psn.raw_mask[i].numpy(), raw[i], err_msg=f"raw_mask {i}")
        np.testing.assert_array_equal(psn.classes[i].numpy(), np.asarray(jsn.classes[i]), err_msg=f"classes {i}")
        np.testing.assert_array_equal(psn.mask[i].numpy(), np.asarray(jsn.mask[i]), err_msg=f"mask {i}")
        live = raw[i]
        np.testing.assert_allclose(
            psn.states7[i].numpy()[live], np.asarray(jsn.states7[i])[live], rtol=1e-4, atol=1e-4,
            err_msg=f"states7 {i}",
        )
    live = np.asarray(js.kf.mask)
    np.testing.assert_array_equal(ps.kf.mask.numpy(), live)
    np.testing.assert_allclose(ps.kf.x.numpy()[live], np.asarray(js.kf.x)[live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ps.kf.P.numpy()[live], np.asarray(js.kf.P)[live], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=1e-4)
    for f in ("fsld", "misses", "age", "next_id"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)


def _tracker(setup, toy_cameras3, cfg):
    t = MultiCameraTracker(
        toy_cameras3["registry"], list(toy_cameras3["ranges"]), cfg=cfg,
        det_model=setup["det"], crop_model=setup["crop"], centers=toy_cameras3["centers"],
        device="cpu",
    )
    t.state = _seed(t.state, list(toy_cameras3["ranges"].values()), cfg.max_tracks)
    return t


def test_track_clips_matches_per_frame_process(setup, toy_cameras3):
    cfg = TrackerConfig(**dict(BASE, **SHIPPED))
    frames = setup["frames"]

    def sources():
        return [
            ((frames[f, ci], 1.6e9 + f / 30.0) for f in range(T_CLIP))
            for ci in range(frames.shape[1])
        ]

    t1 = _tracker(setup, toy_cameras3, cfg)
    t1.track(sources(), per_frame=True)
    t2 = _tracker(setup, toy_cameras3, cfg)
    stats = t2.track_clips(sources(), clip_len=4)  # a full clip and a partial one
    assert stats["frames"] == T_CLIP
    assert [r[0] for r in t1.rows] == [r[0] for r in t2.rows] == list(range(T_CLIP))
    for r1, r2 in zip(t1.rows, t2.rows):
        assert r1[1] == pytest.approx(r2[1])
        np.testing.assert_array_equal(r1[2], r2[2])
        np.testing.assert_allclose(r1[3], r2[3], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(r1[4], r2[4])
    assert sum(len(r[2]) for r in t2.rows) > 0
