"""The main path as a whole: the multi-camera clip tracker in the PyTorch port
against the JAX package, on raw uint8 frames with conv7 stems, on s2d-packed
uint8 frames with s2d stems (float and int8-quantized models), and fed planar
YUV420 bytes through ``track_clips(yuv_hw=...)``.

The scenario is the JAX package's multichip dryrun (``__graft_entry__.py``)
on the ``toy_cameras3`` fixture: random-init ResNet-18 detector and crop
net with the class bias raised by 3 so detections fire, live tracks seeded
one per camera, and a cadence that takes the detect, crop and passthrough
branches. JAX weights are carried into the port by the bridge. Per frame
``ids``, ``raw_mask`` and ``classes`` must be equal, ``states7`` within
rtol/atol 1e-4; the final ``kf.x``, ``kf.P`` and ``ts_bias`` within 1e-4
(relative, since covariances reach 1e4). The same tolerances hold on the s2d
path and for the quantized pair: with focal-prior output convs (zero weights,
which quantize to zero) every logit is the bias whatever the backbone
computes, so ties decide the detections in both packages alike, and the crop
pixels reach nothing but the tie-broken candidates' scores.
"""

import collections
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.quant import quantize_detector as jax_quantize_detector
from playground3d_tpu.pipeline.multi_cam import MultiCameraTracker as JaxTracker
from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
from playground3d_tpu.pipeline.multi_cam import make_mc_clip_step as jax_clip_step
from playground3d_tpu.pipeline.tracker_state import init_track_state as jax_init_state
from playground3d_tpu.track.kf import default_params as jax_kf_params
from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.models.quant import is_quantized
from playground3d_tpu_torch.ops.crop_mxu import pack_s2d
from playground3d_tpu_torch.pipeline import multi_cam
from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker, make_mc_clip_step
from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
from playground3d_tpu_torch.track.kf import default_params
from playground3d_tpu_torch.utils.config import TrackerConfig
from playground3d_tpu_torch.utils.profiling import Spans

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
    out = dict(
        jax_det=det, jax_crop=crop,
        det=params_from_jax_numpy(to_np(det), device="cpu"),
        crop=params_from_jax_numpy(to_np(crop), device="cpu"),
        frames=frames, cam_times=cam_times,
        bias0=np.array([0.0, 0.01, -0.02], np.float32),
    )
    # the shipped transport: the same frames s2d-packed, s2d stems, and the
    # pair quantized by the JAX package (as bench.py quantizes its pair)
    packed = np.stack([np.stack([pack_s2d(f) for f in cams]) for cams in frames])
    det_s = init(jax.random.PRNGKey(0), depth=18, stem="s2d")
    crop_s = init(jax.random.PRNGKey(1), depth=18, stem="s2d", tower_depth=2, shared_tower=True)
    for p in (det_s, crop_s):
        p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    det_q = jax_quantize_detector(det_s, packed[0, :1], 18, stem="s2d")
    crop_q = jax_quantize_detector(crop_s, rng.integers(0, 256, (4, 8, 8, 48), dtype=np.uint8), 18, stem="s2d")
    for name, jd, jc in (("s2d", det_s, crop_s), ("int8", det_q, crop_q)):
        out[f"jax_det_{name}"], out[f"jax_crop_{name}"] = jd, jc
        out[f"det_{name}"] = params_from_jax_numpy(to_np(jd), device="cpu")
        out[f"crop_{name}"] = params_from_jax_numpy(to_np(jc), device="cpu")
    out["packed"] = packed
    return out


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


def _models(setup, path):
    """(suffix of the models in ``setup``, stem, the frames they take)."""
    if path == "conv7":
        return "", "conv7", setup["frames"]
    return f"_{path}", "s2d", setup["packed"]


def _run_jax(setup, toy_cameras3, knobs, path="conv7"):
    sfx, stem, frames = _models(setup, path)
    cfg = JaxConfig(**knobs)
    clip = jax_clip_step(
        setup[f"jax_det{sfx}"], 18, jax_bank(toy_cameras3["registry"]),
        jnp.asarray(toy_cameras3["centers"]), jax_kf_params(), cfg,
        crop_params=setup[f"jax_crop{sfx}"], crop_depth=18, stem=stem, crop_stem=stem,
    )
    state0 = _seed(jax_init_state(cfg.max_tracks), list(toy_cameras3["ranges"].values()), cfg.max_tracks)
    return clip(
        state0, jnp.asarray(setup["bias0"]), jnp.asarray(frames),
        jnp.asarray(setup["cam_times"]), jnp.int32(0),
    )


def _run_port(setup, toy_cameras3, knobs, path="conv7"):
    sfx, stem, frames = _models(setup, path)
    cfg = TrackerConfig(**knobs)
    clip = make_mc_clip_step(
        setup[f"det{sfx}"], bank_from_registry(toy_cameras3["registry"], device="cpu"),
        torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), cfg,
        crop_model=setup[f"crop{sfx}"], stem=stem, crop_stem=stem,
    )
    state0 = _seed(init_track_state(cfg.max_tracks, "cpu"), list(toy_cameras3["ranges"].values()),
                   cfg.max_tracks)
    return clip(
        state0, torch.as_tensor(setup["bias0"]), torch.as_tensor(frames),
        torch.as_tensor(setup["cam_times"]), 0,
    )


@pytest.mark.parametrize("knobs", [BASE, dict(BASE, **SHIPPED), dict(BASE, **SHIPPED_FULL_GATE)],
                         ids=["reference", "shipped", "shipped_gate_shut"])
def test_clip_matches_jax(setup, toy_cameras3, knobs):
    _check_clip(_run_jax(setup, toy_cameras3, knobs), _run_port(setup, toy_cameras3, knobs))


@pytest.mark.parametrize("path", ["s2d", "int8"])
def test_s2d_clip_matches_jax(setup, toy_cameras3, path):
    """s2d-packed uint8 frames, s2d stems for both nets, the shipped knobs;
    ``int8``: both nets quantized by the JAX package and bridged."""
    assert is_quantized(setup[f"det_{path}"]) == is_quantized(setup[f"crop_{path}"]) == (path == "int8")
    knobs = dict(BASE, **SHIPPED)
    # the JAX clip itself loses the third seeded track at the first crop
    # frame on this path (frame 2); the first two stay
    _check_clip(_run_jax(setup, toy_cameras3, knobs, path), _run_port(setup, toy_cameras3, knobs, path),
                live_through_crop=2)


def _check_clip(jax_out, port_out, live_through_crop=3):
    js, jb, jsn = jax_out
    ps, pb, psn = port_out
    raw = np.asarray(jsn.raw_mask)
    assert raw[:4, :live_through_crop].all(), "seeded tracks are live through the first crop frame"
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


def _yuv_sources(n_frames, n_cams, hw, seed=31):
    """Per-camera streams of flat planar YUV420 frames."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (n_frames, n_cams, hw[0] * hw[1] * 3 // 2), dtype=np.uint8)
    return lambda: [((buf[f, ci], 1.6e9 + f / 30.0) for f in range(n_frames)) for ci in range(n_cams)]


def test_track_clips_yuv_matches_jax(setup, toy_cameras3):
    """Flat YUV420 bytes through ``track_clips(yuv_hw=...)``: converted and
    packed on the device in both packages, then the s2d clip."""
    knobs = dict(BASE, **SHIPPED)
    cams, ranges = list(toy_cameras3["ranges"]), list(toy_cameras3["ranges"].values())
    sources = _yuv_sources(T_CLIP, len(cams), (64, 96))
    jt = JaxTracker(
        toy_cameras3["registry"], cams, cfg=JaxConfig(**knobs), det_params=setup["jax_det_s2d"],
        crop_params=setup["jax_crop_s2d"], depth=18, crop_depth=18, centers=toy_cameras3["centers"],
        stem="s2d", crop_stem="s2d", image_hw=(64, 96),
    )
    jt.state = _seed(jt.state, ranges, jt.cfg.max_tracks)
    jt.track_clips(sources(), clip_len=T_CLIP, yuv_hw=(64, 96))
    pt = MultiCameraTracker(
        toy_cameras3["registry"], cams, cfg=TrackerConfig(**knobs), det_model=setup["det_s2d"],
        crop_model=setup["crop_s2d"], centers=toy_cameras3["centers"], stem="s2d", crop_stem="s2d",
        device="cpu",
    )
    pt.state = _seed(pt.state, ranges, pt.cfg.max_tracks)
    stats = pt.track_clips(sources(), clip_len=T_CLIP, yuv_hw=(64, 96))
    assert stats["frames"] == T_CLIP == len(pt.rows) == len(jt.rows)
    for rp, rj in zip(pt.rows, jt.rows):
        assert rp[0] == rj[0] and rp[1] == pytest.approx(rj[1])
        np.testing.assert_array_equal(rp[2], rj[2])
        np.testing.assert_allclose(rp[3], rj[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(rp[4], rj[4])
    assert sum(len(r[2]) for r in pt.rows) > 0


def test_s2d_crop_step_clamps_boxes_like_jax(setup):
    """The crop branch alone on a 1080p s2d frame through the bench camera,
    whose unrefined z column makes crop boxes wider than the s2d crop's
    largest span: both packages clamp them to 992 px before the box and the
    crop-to-frame mapping are built, and sample pyramid level 2."""
    from playground3d_tpu.data.toy_cameras import register_bench_camera
    from playground3d_tpu.pipeline.multi_cam import make_crop_step as jax_crop_step
    from playground3d_tpu_torch.geometry import transforms as PT
    from playground3d_tpu_torch.ops.crop_mxu import max_crop_span_s2d
    from playground3d_tpu_torch.pipeline.camera_bank import state_to_im_banked
    from playground3d_tpu_torch.pipeline.multi_cam import make_crop_step

    reg, _ = register_bench_camera()
    knobs = dict(BASE, **SHIPPED, x_range=(300.0, 800.0))
    n_live, n_slots = 6, knobs["max_tracks"]
    kfx = np.zeros((n_slots, 6), np.float32)
    i = np.arange(n_live)
    kfx[:n_live, 0], kfx[:n_live, 1] = 440.0 + 35.0 * i, 12.0 + 12.0 * i
    kfx[:n_live, 2:5], kfx[:n_live, 5] = (18.0, 6.0, 5.0), 80.0
    kfP = np.tile(np.eye(6, dtype=np.float32)[None] * 0.5, (n_slots, 1, 1))
    live = np.arange(n_slots) < n_live
    ids = np.where(live, np.arange(n_slots), -1).astype(np.int32)
    age = np.where(live, 5, 0).astype(np.int32)

    def seeded(state, conv):
        return state._replace(
            kf=state.kf._replace(x=conv(kfx), P=conv(kfP), mask=conv(live)), ids=conv(ids), age=conv(age),
            conf_cnt=conv(live.astype(np.float32)), conf_sum=conv(live.astype(np.float32) * 0.9),
        )

    rng = np.random.default_rng(41)
    frame = pack_s2d(rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8))[None]
    centers = np.array([[565.0, 60.0]], np.float32)
    times, bias = np.array([0.1], np.float32), np.zeros(1, np.float32)

    bank = bank_from_registry(reg, device="cpu")
    st0 = seeded(init_track_state(n_slots, "cpu"), torch.as_tensor)
    s6 = torch.cat([st0.kf.x[:n_live, :5], st0.kf.d[:n_live, None]], 1)
    hull = PT.im_hull_xyxy(state_to_im_banked(bank, s6, torch.zeros(n_live, dtype=torch.long)))
    side = torch.maximum(hull[:, 2] - hull[:, 0], hull[:, 3] - hull[:, 1]) * TrackerConfig(**knobs).crop_expand
    assert (side > max_crop_span_s2d()).sum() >= n_live // 2, "the scenario must reach the clamp"

    step_p = make_crop_step(setup["crop_s2d"], bank, torch.as_tensor(centers), default_params(device="cpu"),
                            TrackerConfig(**knobs), stem="s2d", frame_stem="s2d")
    sp, snap_p = step_p(st0, torch.as_tensor(frame), torch.as_tensor(times), torch.as_tensor(bias))
    step_j = jax_crop_step(setup["jax_crop_s2d"], 18, jax_bank(reg), jnp.asarray(centers), jax_kf_params(),
                           JaxConfig(**knobs), stem="s2d", frame_stem="s2d")
    sj, snap_j = step_j(seeded(jax_init_state(n_slots), jnp.asarray), jnp.asarray(frame), jnp.asarray(times),
                        jnp.asarray(bias))
    mask = np.asarray(sj.kf.mask)
    np.testing.assert_array_equal(sp.kf.mask.numpy(), mask)
    assert mask.sum() > 0
    np.testing.assert_allclose(sp.kf.x.numpy()[mask], np.asarray(sj.kf.x)[mask], rtol=1e-4, atol=1e-4)
    for f in ("fsld", "misses", "age"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(), np.asarray(getattr(sj, f)), err_msg=f)
    np.testing.assert_array_equal(snap_p.ids.numpy(), np.asarray(snap_j.ids))
    np.testing.assert_array_equal(snap_p.raw_mask.numpy(), np.asarray(snap_j.raw_mask))
    # the crop measurements moved the states: the step did more than coast
    assert not np.allclose(sp.kf.x.numpy()[mask][:, :2], kfx[mask][:, :2], atol=1e-3)


def test_s2d_tracker_packs_raw_frames_on_the_device(setup, toy_cameras3):
    """An s2d tracker fed raw [H,W,3] frames packs them itself, per frame
    (``process``) and per clip (``track_clips``), and the two agree."""
    cfg = TrackerConfig(**dict(BASE, **SHIPPED))
    frames = setup["frames"]

    def sources():
        return [((frames[f, ci], 1.6e9 + f / 30.0) for f in range(T_CLIP)) for ci in range(frames.shape[1])]

    def tracker():
        t = MultiCameraTracker(
            toy_cameras3["registry"], list(toy_cameras3["ranges"]), cfg=cfg, det_model=setup["det_int8"],
            crop_model=setup["crop_int8"], centers=toy_cameras3["centers"], stem="s2d", crop_stem="s2d",
            device="cpu",
        )
        t.state = _seed(t.state, list(toy_cameras3["ranges"].values()), cfg.max_tracks)
        return t

    t1, t2 = tracker(), tracker()
    t1.track(sources(), per_frame=True)
    t2.track_clips(sources(), clip_len=4)
    assert [r[0] for r in t1.rows] == [r[0] for r in t2.rows] == list(range(T_CLIP))
    for r1, r2 in zip(t1.rows, t2.rows):
        np.testing.assert_array_equal(r1[2], r2[2])
        np.testing.assert_allclose(r1[3], r2[3], rtol=1e-5, atol=1e-5)
    assert sum(len(r[2]) for r in t2.rows) > 0


def test_stem_arguments_are_checked(setup, toy_cameras3):
    def tracker(**kw):
        return MultiCameraTracker(
            toy_cameras3["registry"], list(toy_cameras3["ranges"]), det_model=setup["det"],
            crop_model=setup["crop"], centers=toy_cameras3["centers"], device="cpu", **kw,
        )

    with pytest.raises(ValueError, match="yuv_hw"):
        tracker().track_clips([], yuv_hw=(64, 96))  # conv7 stem: no on-device YUV
    with pytest.raises(ValueError, match="stem"):
        tracker(stem="s2d")  # the detector was built with the conv7 stem
    with pytest.raises(ValueError, match="stem"):
        tracker(crop_stem="s2d")
    with pytest.raises(ValueError, match="stem"):
        make_mc_clip_step(setup["det"], None, None, None, TrackerConfig())  # default stem is "s2d"


@pytest.mark.parametrize("path", ["conv7", "s2d", "int8"])
def test_graph_path_buffers_match_the_eager_clip(setup, toy_cameras3, path):
    """``make_mc_clip_step(graphs=True)`` on the CPU runs what the card
    captures - the static state, frame and snapshot buffers, each branch
    writing its new state back into them - without the capture: two clips
    through the same buffers give the eager clip's results bit for bit."""
    sfx, stem, frames = _models(setup, path)
    cfg = TrackerConfig(**dict(BASE, **SHIPPED))
    ranges = list(toy_cameras3["ranges"].values())
    out = {}
    for graphs in (False, True):
        clip = make_mc_clip_step(
            setup[f"det{sfx}"], bank_from_registry(toy_cameras3["registry"], device="cpu"),
            torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), cfg,
            crop_model=setup[f"crop{sfx}"], stem=stem, crop_stem=stem, graphs=graphs,
        )
        st, tb = _seed(init_track_state(cfg.max_tracks, "cpu"), ranges, cfg.max_tracks), torch.as_tensor(setup["bias0"])
        snaps = []
        for frame0 in (0, T_CLIP):
            st, tb, snap = clip(st, tb, torch.as_tensor(frames), torch.as_tensor(setup["cam_times"]) + frame0 / 30.0,
                                frame0)
            snaps.append(snap)
        out[graphs] = (st, tb, snaps)
    (st0, tb0, snaps0), (st1, tb1, snaps1) = out[False], out[True]
    for a, b in zip(snaps0, snaps1):
        for name in a._fields:
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert all(torch.equal(a, b) for a, b in zip([*st0.kf, *st0[1:]], [*st1.kf, *st1[1:]]))
    assert torch.equal(tb0, tb1) and int(snaps0[1].raw_mask.sum()) > 0


N_CLIPS_FRAMES = 14  # five clips of 3 frames, the last one 2


def _clip_sources(seed=34):
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, (N_CLIPS_FRAMES, 3, 64, 96, 3), dtype=np.uint8)

    def camera(ci):
        return ((buf[f, ci], 1.6e9 + f / 30.0) for f in range(N_CLIPS_FRAMES))

    return lambda: [camera(ci) for ci in range(3)]


def test_track_clips_over_five_clips_matches_jax(setup):
    """Five clips of 3 frames, the last one partial, through both packages'
    ``track_clips`` (JAX keeps 3 clips in flight and logs the bias each clip
    returned; the port reads each clip once, 3 clips later): every row and
    every logged bias equal, with the bias moved by detect frames.

    Two cameras share one fitted pose, and with zero output convs every
    box is the regression bias (aimed at a car) applied to its anchor, so
    the cameras detect the same roadway boxes. The frames are 32 x 32, so
    the top-k holds every anchor of both cameras; their clocks differ by
    4 ms, which the clock-bias estimator picks up on each detect frame."""
    from playground3d_tpu.data.toy_cameras import make_projector, register_toy_camera
    from playground3d_tpu.geometry.homography import CameraRegistry
    from playground3d_tpu_torch.data.synthetic import aimed_regression_bias

    hw, car = (32, 32), (330.0, 30.0, 18.0, 6.0, 5.0, 1.0)
    project = make_projector(cam_x=250.0, cam_y=60.0, height=30.0, f=2000.0 * 32 / 1920, cx=16.0, cy=16.0)
    reg = CameraRegistry()
    for name in ("p1c1", "p1c2"):
        register_toy_camera(reg, name, project, (450.0, 680.0), seed=7)
    det = jax.tree_util.tree_map(lambda a: a, setup["jax_det"])
    det["heads"]["reg_out"]["b"] = jnp.asarray(aimed_regression_bias(reg.P[0, 0], car, hw))
    centers = np.array([[565.0, 60.0], [565.0, 60.0]], np.float32)
    knobs = dict(BASE, **SHIPPED, pre_topk=512, max_dets=128)
    rng = np.random.default_rng(33)
    buf = rng.integers(0, 256, (N_CLIPS_FRAMES, 2) + hw + (3,), dtype=np.uint8)

    def camera(ci):  # one camera's stream (a function, so each generator keeps its own ci)
        return ((buf[f, ci], 1.6e9 + f / 30.0 + 0.004 * ci) for f in range(N_CLIPS_FRAMES))

    def sources():
        return [camera(ci) for ci in range(2)]

    jt = JaxTracker(
        reg, ["p1c1", "p1c2"], cfg=JaxConfig(**knobs), det_params=det, crop_params=setup["jax_crop"], depth=18,
        crop_depth=18, centers=centers, stem="conv7", crop_stem="conv7", image_hw=hw,
    )
    jt.track_clips(sources(), clip_len=3)
    pt = MultiCameraTracker(
        reg, ["p1c1", "p1c2"], cfg=TrackerConfig(**knobs),
        det_model=params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, det), device="cpu"),
        crop_model=setup["crop"], centers=centers, device="cpu",
    )
    stats = pt.track_clips(sources(), clip_len=3)
    assert stats["frames"] == N_CLIPS_FRAMES == len(pt.rows) == len(jt.rows)
    for rp, rj in zip(pt.rows, jt.rows):
        assert rp[0] == rj[0] and rp[1] == pytest.approx(rj[1])
        np.testing.assert_array_equal(rp[2], rj[2])
        np.testing.assert_allclose(rp[3], rj[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(rp[4], rj[4])
    assert len(pt.ts_bias_log) == len(jt.ts_bias_log) == N_CLIPS_FRAMES
    for bp, bj in zip(pt.ts_bias_log, jt.ts_bias_log):
        np.testing.assert_allclose(bp, np.asarray(bj), rtol=0, atol=1e-6)
    log = np.asarray(pt.ts_bias_log)
    assert np.abs(log[:, 1]).max() > 1e-4 and len(np.unique(log[:, 1])) > 2  # moved, clip after clip
    assert sum(len(r[2]) for r in pt.rows) > 0


def test_track_clips_reads_each_clip_once_three_clips_later(setup, toy_cameras3, monkeypatch):
    """The port's drain: one read a clip, started when the clip is enqueued
    and waited for three clips later (the last ones at the end)."""
    from playground3d_tpu_torch.ops.topk import HostSyncs

    events = []
    pt = _tracker(setup, toy_cameras3, TrackerConfig(**dict(BASE, **SHIPPED)))
    clip = pt._clip_fn()

    def logged_clip(state, ts_bias, frames, cam_times, frame0):
        events.append(("clip", frame0))
        return clip(state, ts_bias, frames, cam_times, frame0)

    real = HostSyncs.fetch_later.__func__

    def logged_fetch(cls, t, loop="drain"):
        frame0 = events[-1][1]
        wait = real(cls, t, loop)
        return lambda: (events.append(("read", frame0)), wait())[1]

    pt._clip = logged_clip
    monkeypatch.setattr(HostSyncs, "fetch_later", classmethod(logged_fetch))
    drains = HostSyncs.by_loop["drain"]
    pt.track_clips(_clip_sources()(), clip_len=3)
    assert HostSyncs.by_loop["drain"] - drains == 5
    assert events == [("clip", 0), ("clip", 3), ("clip", 6), ("clip", 9), ("read", 0), ("clip", 12),
                      ("read", 3), ("read", 6), ("read", 9), ("read", 12)]
    assert [r[0] for r in pt.rows] == list(range(N_CLIPS_FRAMES))


# ---------------------------------------------------------------------------
# host spans (utils/profiling.py::Spans)
# ---------------------------------------------------------------------------


def _by_name(log):
    out = collections.defaultdict(list)
    for sp in log:
        out[sp.name].append(sp)
    return out


def test_spans_total_always_and_are_kept_only_while_recording(monkeypatch):
    """A span adds its seconds to its total whether or not it is recorded;
    the log keeps it whole only inside ``recorded_if_profiled`` under a
    running profiler: under the span open on its thread (or the one another
    thread gives by ``within``), with its parent's clip unless given one."""
    monkeypatch.setattr(Spans, "log", [])
    spans = Spans(["a"])
    with Spans.recorded_if_profiled():
        with spans("a", 3):
            time.sleep(0.001)
    assert Spans.log == [] and spans.totals["a"] >= 0.001 and not Spans.recording
    totals0 = dict(spans.totals)

    with profile(activities=[ProfilerActivity.CPU]):
        with Spans.recorded_if_profiled():
            assert Spans.recording
            with spans("root") as root:
                with spans("a", 3) as a:
                    with spans("b") as b:
                        time.sleep(0.001)

                def other():
                    with Spans.within(root):
                        with spans("c", 6):
                            pass
                    with spans("d"):
                        pass

                thread = threading.Thread(target=other)
                thread.start()
                thread.join(timeout=10)
                assert not thread.is_alive()
    assert not Spans.recording
    spans_by = _by_name(Spans.log)
    assert sorted(spans_by) == ["a", "b", "c", "d", "root"]
    c, d = spans_by["c"][0], spans_by["d"][0]
    assert root.parent is None and a.parent is root and b.parent is a and c.parent is root and d.parent is None
    assert (a.clip, b.clip, c.clip, d.clip, root.clip) == (3, 3, 6, None, None)
    assert root.thread == a.thread == b.thread != c.thread == d.thread
    for sp in (a, b, c):
        assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns <= sp.parent.end_ns
    for name, recorded in spans_by.items():
        assert spans.totals[name] - totals0.get(name, 0.0) == pytest.approx(
            sum(sp.end_ns - sp.start_ns for sp in recorded) / 1e9, rel=1e-9)
    # realtime - perf_counter, sampled at the start and at the end: the same clock pair
    lo, hi = Spans.offsets_ns
    assert lo and hi and abs(hi - lo) < 50_000_000 and Spans.offset_ns() == (lo + hi) // 2
    assert Spans.log[-1] is root and Spans.log[-1].end_ns > 0  # kept as it closes


def test_replay_timers_are_read_when_their_clip_is_drained(monkeypatch):
    """While recording, ``device_timer`` gives a span a pair of timing events
    from its device's pool; ``settle(clip)`` reads that clip's pairs alone and
    returns them to their device's pool, the end of the recording the rest;
    a later recording reuses them."""

    class Event:  # a CUDA timing event's interface, on the host clock
        made = 0

        def __init__(self, enable_timing):
            Event.made += 1
            self.t = None

        def record(self):
            self.t = time.perf_counter_ns()

        def synchronize(self):
            assert self.t is not None

        def elapsed_time(self, end):
            return (end.t - self.t) / 1e6

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(Spans, "_free_events", {})
    spans = Spans()

    def recorded_clips(check):
        with profile(activities=[ProfilerActivity.CPU]):
            with Spans.recorded_if_profiled():
                for clip in (0, 4):
                    with spans("enqueue", clip):
                        for dev in ("cuda:0", "cuda:1"):
                            with spans("replay.frame") as sp:
                                start, end = Spans.device_timer(sp, dev)
                                start.record()
                                time.sleep(0.001)
                                end.record()
                check()
        return [sp for sp in Spans.log if sp.name == "replay.frame"]

    def drain_first():
        Spans.settle(0)
        assert [sp.device_ms is not None for sp in Spans.log if sp.name == "replay.frame"] == [True, True, False, False]
        assert {dev: len(free) for dev, free in Spans._free_events.items()} == {"cuda:0": 1, "cuda:1": 1}

    replays = recorded_clips(drain_first)
    assert all(sp.device_ms >= 1.0 and sp.events is None for sp in replays) and Event.made == 8
    assert {dev: len(free) for dev, free in Spans._free_events.items()} == {"cuda:0": 2, "cuda:1": 2}
    recorded_clips(lambda: None)
    assert Event.made == 8  # the pools served the second recording


def test_track_clips_records_spans_only_under_a_profiler(setup, toy_cameras3, monkeypatch):
    """``track_clips`` keeps no span outside a profiler. Inside one it
    records the call; the producer thread's ``source``, ``stack``, ``stage``
    and ``put_wait``; the consumer's ``get_wait``, ``enqueue`` (each graph
    run inside) and ``drain`` (``drain_wait`` inside). Each span nests in
    its parent, a clip's consumer spans do not overlap, each total is the
    sum of its spans, and ``stage`` covers what it covered as a timer: one
    span a frame between the frame's stack and its clip's ``put_wait`` (and
    one more for a last, partial clip), the clip's staging inside the last."""
    cfg = TrackerConfig(**dict(BASE, **SHIPPED))
    frames = setup["frames"]

    def sources():
        return [((frames[f, ci], 1.6e9 + f / 30.0) for f in range(T_CLIP)) for ci in range(frames.shape[1])]

    pt = MultiCameraTracker(
        toy_cameras3["registry"], list(toy_cameras3["ranges"]), cfg=cfg, det_model=setup["det_int8"],
        crop_model=setup["crop_int8"], centers=toy_cameras3["centers"], stem="s2d", crop_stem="s2d",
        device="cpu",
    )
    pt.state = _seed(pt.state, list(toy_cameras3["ranges"].values()), cfg.max_tracks)
    monkeypatch.setattr(Spans, "log", [])
    pt.track_clips(sources(), clip_len=4)
    assert Spans.log == []

    staged = []  # (perf_counter ns, thread) of each clip's packing on the device, in its staging
    real = multi_cam.space_to_depth

    def packing(x, block):
        staged.append((time.perf_counter_ns(), threading.get_ident()))
        return real(x, block)

    monkeypatch.setattr(multi_cam, "space_to_depth", packing)
    runners = list(pt._clip.runners.values()) + [sd for sds in pt._clip.shard_runners.values() for sd in sds]
    totals0 = dict(pt.timers), [dict(r.programs.spans.totals) for r in runners]
    with profile(activities=[ProfilerActivity.CPU]):
        stats = pt.track_clips(sources(), clip_len=4)  # a full clip and a partial one
    assert stats["frames"] == T_CLIP and len(pt.rows) == 2 * T_CLIP
    log = Spans.log
    by = _by_name(log)
    (root,) = by.pop("track_clips")
    producer = {"source", "stack", "stage", "put_wait"}
    consumer = {"get_wait", "enqueue", "drain"}
    graphs = {f"replay.{g}" for g in ("frame", "detect", "crop", "passthrough")}
    assert set(by) == producer | consumer | graphs | {"drain_wait"}
    for sp in log:
        if sp is not root:
            assert sp.parent.start_ns <= sp.start_ns <= sp.end_ns <= sp.parent.end_ns, sp
    for name in producer | consumer:
        assert all(sp.parent is root for sp in by[name]), name
    threads = {name: {sp.thread for sp in by[name]} for name in by}
    assert {t for n in producer for t in threads[n]} == threads["source"] != {root.thread}
    assert len(threads["source"]) == 1 and all(threads[n] == {root.thread} for n in consumer)
    assert all(sp.parent.name == "enqueue" for n in graphs for sp in by[n])
    assert all(sp.parent.name == "drain" for sp in by["drain_wait"])
    # clips by their first frame index; a clip's consumer spans apart
    assert sorted(sp.clip for sp in by["enqueue"]) == sorted(sp.clip for sp in by["drain"]) == [0, 4]
    assert [sp.clip for sp in by["stack"]] == [0, 0, 0, 0, 4, 4]
    assert all(sp.clip == sp.parent.clip for n in graphs | {"drain_wait"} for sp in by[n])
    for clip in (0, 4):
        mine = sorted((sp.start_ns, sp.end_ns) for n in consumer for sp in by[n] if sp.clip == clip)
        assert len(mine) == 3 and all(a[1] <= b[0] for a, b in zip(mine, mine[1:]))
    totals1 = {k: v - totals0[0].get(k, 0.0) for k, v in pt.timers.items()}
    for r, t0 in zip(runners, totals0[1]):
        totals1.update({k: v - t0.get(k, 0.0) for k, v in r.programs.spans.totals.items()})
    for name, recorded in list(by.items()) + [("track_clips", [root])]:
        assert totals1[name] == pytest.approx(sum(sp.end_ns - sp.start_ns for sp in recorded) / 1e9, rel=1e-9), name
    # stage: a span a frame and one for the partial clip's staging; each
    # after its frame's stack, the clips' packing inside their last
    stage = sorted(by["stage"], key=lambda sp: sp.start_ns)
    stacks = sorted(by["stack"], key=lambda sp: sp.start_ns)
    puts = sorted(by["put_wait"], key=lambda sp: sp.start_ns)
    assert len(stage) == T_CLIP + 1 and len(puts) == 2
    assert all(st.end_ns <= sg.start_ns for st, sg in zip(stacks, stage))
    assert [sp.clip for sp in stage] == [0, 0, 0, 0, 4, 4, 4]
    assert len(staged) == 2 and {t for _, t in staged} == threads["source"]
    for (t, _), last, put in zip(staged, (stage[3], stage[6]), puts):
        assert last.start_ns <= t <= last.end_ns <= put.start_ns
