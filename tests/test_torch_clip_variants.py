"""The multi-camera clip's two variants in the PyTorch port against the JAX
package: ``make_mc_clip_step(batch_detects=True)`` (the clip's detect frames
detected together before the branches) and ``unroll=True`` (a straight-line
clip, one CUDA graph on the card).

The scenario mirrors the JAX package's own variant tests
(``tests/test_multicam.py``: ``toy_cameras3``, ResNet-18 s2d detector and crop
net, 64x96 frames, T = 6, ``det_step`` 3, ``skip_step`` 1, clock-bias
estimation on) with the port's clip-test set-up: uint8 s2d-packed frames, the
class bias raised by 3 so detections fire, and three live tracks seeded one
per camera. The tolerances are the JAX tests': ``raw_mask`` (and ids and
classes) equal, ``states7`` and ``kf.x`` within rtol/atol 1e-5, ``ts_bias``
within 1e-6. The output convs have zero weights (the focal prior), so every
logit is its bias and ties decide the detections alike in both packages; one
case gives the detector random output convs, so that detections follow each
frame's pixels and a variant that reads another frame's would differ.

``detect_frames`` keeps the top-k pool and the NMS cap per frame: with
distinct biases per (anchor, class) every frame ranks the same logits, and a
pool over the clip's frames would hand most of the top-k, and the NMS cap,
to frame 0 (ties go to the lower index), which the JAX ``vmap`` never does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.models import retinanet as JR
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
from playground3d_tpu.pipeline.multi_cam import make_mc_clip_step as jax_clip_step
from playground3d_tpu.pipeline.tracker_state import init_track_state as jax_init_state
from playground3d_tpu.track.kf import default_params as jax_kf_params
from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.ops.crop_mxu import pack_s2d
from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
from playground3d_tpu_torch.pipeline.multi_cam import make_mc_clip_step
from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
from playground3d_tpu_torch.track.kf import default_params
from playground3d_tpu_torch.utils.config import TrackerConfig

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

T_CLIP = 6
KNOBS = dict(
    max_tracks=16, max_dets=16, pre_topk=128, x_range=(320.0, 880.0), f_init=1,
    det_step=3, skip_step=1, cd_max=8, cs=32, crop_slots=8, estimate_ts_bias=True,
    sigma_d=0.003, sigma_c=0.003, sigma_min=0.003, size_nudge=True, crop_conf_gate=True, tentative_age=4,
)
VARIANTS = {"batch_detects": dict(batch_detects=True), "unroll": dict(unroll=True)}


@pytest.fixture(scope="module")
def nets(toy_cameras3):
    init = jax.jit(jax_init, static_argnames=("depth", "stem", "tower_depth", "shared_tower"))
    det = init(jax.random.PRNGKey(0), depth=18, stem="s2d")
    crop = init(jax.random.PRNGKey(1), depth=18, stem="s2d", tower_depth=2, shared_tower=True)
    for p in (det, crop):
        p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    rng = np.random.default_rng(21)
    C = len(toy_cameras3["ranges"])
    raw = rng.integers(0, 256, (2 * T_CLIP, C, 64, 96, 3)).astype(np.uint8)
    return dict(
        jax_det=det, jax_crop=crop,
        det=params_from_jax_numpy(to_np(det), device="cpu"),
        crop=params_from_jax_numpy(to_np(crop), device="cpu"),
        frames=np.stack([np.stack([pack_s2d(f) for f in cams]) for cams in raw]),
        cam_times=(np.arange(2 * T_CLIP)[:, None] / 30.0 + np.zeros((1, C))).astype(np.float32),
        bias0=np.array([0.0, 0.01, -0.02], np.float32),
        ranges=list(toy_cameras3["ranges"].values()),
        cache={},
    )


def _seed(state, ranges, n_slots, to):
    """Live tracks at the centre of each camera's range (``to``: the
    package's array constructor)."""
    n = len(ranges)
    kfx = np.zeros((n_slots, 6), np.float32)
    kfx[:n, 0] = [(a + b) / 2.0 for a, b in ranges]
    kfx[:n, 1] = 60.0
    kfx[:n, 2:5] = (18.0, 6.0, 5.0)
    kfx[:n, 5] = 80.0
    mask = np.arange(n_slots) < n
    return state._replace(
        kf=state.kf._replace(x=to(kfx), P=to(np.tile(np.eye(6, dtype=np.float32)[None] * 0.5, (n_slots, 1, 1))),
                             mask=to(mask)),
        next_id=to(np.int32(n)), ids=to(np.where(mask, np.arange(n_slots), -1).astype(np.int32)),
        age=to(np.where(mask, 5, 0).astype(np.int32)), conf_cnt=to(mask.astype(np.float32)),
        conf_sum=to(mask.astype(np.float32) * 0.9),
    )


def _jax(nets, toy_cameras3, variant):
    if variant not in nets["cache"]:
        cfg = JaxConfig(**KNOBS)
        clip = jax_clip_step(
            nets["jax_det"], 18, jax_bank(toy_cameras3["registry"]), jnp.asarray(toy_cameras3["centers"]),
            jax_kf_params(), cfg, crop_params=nets["jax_crop"], crop_depth=18, stem="s2d", crop_stem="s2d",
            **VARIANTS[variant],
        )
        state0 = _seed(jax_init_state(cfg.max_tracks), nets["ranges"], cfg.max_tracks, jnp.asarray)
        nets["cache"][variant] = clip(
            state0, jnp.asarray(nets["bias0"]), jnp.asarray(nets["frames"][:T_CLIP]),
            jnp.asarray(nets["cam_times"][:T_CLIP]), jnp.int32(0),
        )
    return nets["cache"][variant]


def _port_clip(nets, toy_cameras3, graphs=True, **variant):
    return make_mc_clip_step(
        nets["det"], bank_from_registry(toy_cameras3["registry"], device="cpu"),
        torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), TrackerConfig(**KNOBS),
        crop_model=nets["crop"], stem="s2d", crop_stem="s2d", graphs=graphs, **variant,
    )


def _port(nets, toy_cameras3, variant=None, graphs=True, n_clips=1):
    """The port's clip over ``n_clips`` clips of T_CLIP frames, one clip
    function for all, each clip from the seeded state at its own frame0
    (the tracks of this scenario do not outlive a clip): [(state, ts_bias,
    snapshots) of each clip]."""
    key = ("port", variant, graphs, n_clips)
    if key not in nets["cache"]:
        clip = _port_clip(nets, toy_cameras3, graphs, **(VARIANTS[variant] if variant else {}))
        out = []
        for k in range(n_clips):
            st = _seed(init_track_state(KNOBS["max_tracks"], "cpu"), nets["ranges"], KNOBS["max_tracks"],
                       torch.as_tensor)
            sl = slice(k * T_CLIP, (k + 1) * T_CLIP)
            out.append(clip(st, torch.as_tensor(nets["bias0"]), torch.as_tensor(nets["frames"][sl]),
                            torch.as_tensor(nets["cam_times"][sl]), k * T_CLIP))
        nets["cache"][key] = out
    return nets["cache"][key]


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(a, b):
    """Clip outputs (state, ts_bias, snapshots) of either package within
    the JAX variant tests' tolerances."""
    (sa, ba, na), (sb, bb, nb) = a, b
    raw = _as_np(na.raw_mask)
    assert raw.sum() > 0
    for f in ("raw_mask", "ids", "classes"):
        np.testing.assert_array_equal(_as_np(getattr(na, f)), _as_np(getattr(nb, f)), err_msg=f)
    np.testing.assert_allclose(_as_np(na.states7)[raw], _as_np(nb.states7)[raw], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_as_np(ba), _as_np(bb), rtol=0, atol=1e-6)
    live = _as_np(sa.kf.mask)
    np.testing.assert_array_equal(_as_np(sb.kf.mask), live)
    np.testing.assert_allclose(_as_np(sa.kf.x)[live], _as_np(sb.kf.x)[live], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_jax(nets, toy_cameras3, variant):
    """The port's variant (static buffers, as the card runs it) against the
    JAX variant."""
    _check(_jax(nets, toy_cameras3, variant), _port(nets, toy_cameras3, variant)[0])


@pytest.mark.parametrize("graphs", [True, False], ids=["static_buffers", "eager"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_matches_the_default_clip(nets, toy_cameras3, variant, graphs):
    """Each variant equals the port's three-branch clip (the JAX tests'
    check), on the static buffers and eagerly."""
    _check(_port(nets, toy_cameras3)[0], _port(nets, toy_cameras3, variant, graphs)[0])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_static_buffers_match_the_eager_variant_over_two_clips(nets, toy_cameras3, variant):
    """What the card captures - the variant's static buffers, written back
    and loaded again for the next clip - gives the eager variant's results
    bit for bit, over two clips."""
    eager, static = (_port(nets, toy_cameras3, variant, graphs, n_clips=2) for graphs in (False, True))
    for (s0, b0, n0), (s1, b1, n1) in zip(eager, static):
        for name in n0._fields:
            assert torch.equal(getattr(n0, name), getattr(n1, name)), name
        assert all(torch.equal(a, b) for a, b in zip([*s0.kf, *s0[1:]], [*s1.kf, *s1[1:]]))
        assert torch.equal(b0, b1) and int(n0.raw_mask.sum()) > 0


# (variant, skip_step, crop net, frame0, raises): both packages check
# frame0 % det_step, and the unrolled clip with a crop net frame0 % skip_step
ALIGNMENT = [
    ("batch_detects", 1, True, 1, True),
    ("unroll", 1, True, 2, True),
    ("unroll", 2, True, 3, True),
    ("unroll", 2, False, 3, False),
    ("batch_detects", 2, True, 3, False),
]


@pytest.mark.parametrize("variant,skip_step,with_crop,frame0,raises", ALIGNMENT,
                         ids=["batch_det_step", "unroll_det_step", "unroll_skip_step", "unroll_no_crop",
                              "batch_skip_free"])
def test_frame0_alignment(nets, toy_cameras3, variant, skip_step, with_crop, frame0, raises):
    """A misaligned ``frame0`` raises ``ValueError`` in both packages, before
    anything runs; an aligned one runs (one detect frame, on the port)."""
    knobs = dict(KNOBS, skip_step=skip_step)
    crop = nets["crop"] if with_crop else None
    clip = make_mc_clip_step(
        nets["det"], bank_from_registry(toy_cameras3["registry"], device="cpu"),
        torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), TrackerConfig(**knobs),
        crop_model=crop, **VARIANTS[variant],
    )
    args = (init_track_state(16, "cpu"), torch.zeros(3), torch.as_tensor(nets["frames"][:1]),
            torch.as_tensor(nets["cam_times"][:1]), frame0)
    if not raises:
        _, _, snaps = clip(*args)
        assert snaps.ids.shape == (1, 16)
        return
    with pytest.raises(ValueError, match="frame0"):
        clip(*args)
    jclip = jax_clip_step(
        nets["jax_det"], 18, jax_bank(toy_cameras3["registry"]), jnp.asarray(toy_cameras3["centers"]),
        jax_kf_params(), JaxConfig(**knobs), crop_params=nets["jax_crop"] if with_crop else None,
        crop_depth=18, **VARIANTS[variant],
    )
    with pytest.raises(ValueError, match="frame0"):
        jclip(jax_init_state(16), jnp.zeros(3), jnp.asarray(nets["frames"][:1]),
              jnp.asarray(nets["cam_times"][:1]), jnp.int32(frame0))


@pytest.fixture(scope="module")
def spread(nets):
    """The clip's s2d detector with a distinct class bias per (anchor,
    class) (its output convs stay zero: the same logits in every image), and
    two frames of the three cameras."""
    p = dict(nets["jax_det"], heads=dict(nets["jax_det"]["heads"]))
    b = np.random.default_rng(36).normal(-1.0, 1.0, p["heads"]["cls_out"]["b"].shape)
    p["heads"]["cls_out"] = dict(p["heads"]["cls_out"], b=jnp.asarray(b.astype(np.float32)))
    m = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    return p, m, nets["frames"][:2]


@pytest.mark.parametrize("pre_topk,max_dets", [(12, 64), (96, 5)], ids=["top_k_pool", "nms_cap"])
def test_detect_frames_keeps_top_k_and_nms_per_frame(spread, pre_topk, max_dets):
    """One detector forward over the frames' six images, then a top-k and
    an NMS a frame: equal to JAX's ``vmap`` of ``detect_multiframe`` over the
    frames and to the port's per-frame calls; a pool over both frames would
    differ (the canary: the test sees the difference)."""
    p, m, frames = spread
    kw = dict(pre_topk=pre_topk, max_dets=max_dets)
    got = PR.detect_frames(m, torch.as_tensor(frames), **kw)
    want = jax.vmap(lambda f: JR.detect_multiframe(p, f, depth=18, stem="s2d", **kw))(jnp.asarray(frames))
    for f in ("mask", "cam_idx", "classes"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-3)
    for j in range(frames.shape[0]):
        one = PR.detect_multiframe(m, torch.as_tensor(frames[j]), **kw)
        for f in one._fields:
            assert torch.equal(getattr(got, f)[j], getattr(one, f)), (j, f)
    pooled = PR.detect_multiframe(m, torch.as_tensor(frames.reshape((6,) + frames.shape[2:])), **kw)
    kept = int(got.mask[0].sum())
    assert kept > 0 and (int(pooled.mask.sum()) != int(got.mask.sum()) or
                         not torch.equal(pooled.cam_idx[pooled.mask], got.cam_idx[0][got.mask[0]]))


@pytest.fixture(scope="module")
def pixels(nets, toy_cameras3):
    """The clip's detector with random output convs (weights N(0, 0.01)), so
    that every logit and box depends on its own image's pixels: the port's
    default clip, each variant, and the default clip on the frames with
    detect frames 0 and 3 swapped, each from the seeded state at frame0 0."""
    p = dict(nets["jax_det"], heads=dict(nets["jax_det"]["heads"]))
    rng = np.random.default_rng(41)
    for name in ("cls_out", "reg_out"):
        w = p["heads"][name]["w"]
        p["heads"][name] = dict(p["heads"][name], w=jnp.asarray(rng.normal(0.0, 0.01, w.shape).astype(np.float32)))
    det = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    frames = torch.as_tensor(nets["frames"][:T_CLIP])

    def run(fr, **variant):
        clip = make_mc_clip_step(
            det, bank_from_registry(toy_cameras3["registry"], device="cpu"),
            torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), TrackerConfig(**KNOBS),
            crop_model=nets["crop"], stem="s2d", crop_stem="s2d", **variant,
        )
        st = _seed(init_track_state(KNOBS["max_tracks"], "cpu"), nets["ranges"], KNOBS["max_tracks"],
                   torch.as_tensor)
        return clip(st, torch.as_tensor(nets["bias0"]), fr, torch.as_tensor(nets["cam_times"][:T_CLIP]), 0)

    out = {name: run(frames, **kw) for name, kw in VARIANTS.items()}
    out["default"] = run(frames)
    out["swapped"] = run(frames[[3, 1, 2, 0, 4, 5]])
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_detects_each_frame_from_its_own_pixels(pixels, variant):
    """With detections that depend on the pixels, each variant (static
    buffers) still equals the port's default clip: the batched forward,
    its per-frame detections and the slot each detect frame reads, and the
    unrolled clip's frame index, all follow the frame."""
    _check(pixels["default"], pixels[variant])


def test_the_pixel_case_sees_a_swapped_detect_frame(pixels):
    """The canary of the case above: a clip that detects frame 3's pixels at
    frame 0 and frame 0's at frame 3 fails its check."""
    with pytest.raises(AssertionError):
        _check(pixels["default"], pixels["swapped"])
