"""The device mesh in the PyTorch port (``parallel/mesh.py``) against the
JAX package on its virtual 8-device CPU mesh (``tests/conftest.py``): the
camera-sharded forward and detection, the camera-sharded multi-camera clip
(``make_mc_clip_step(mesh=)``, ``track_clips(mesh=)``, also fed YUV420 bytes) and data-parallel
training over two gloo ranks. The port's meshes list the CPU once a shard
(``make_mesh(devices=["cpu"] * n)``), as the JAX tests' virtual devices do.

Tolerances, each with its reason:

* the forward at float32, sharded over 8 devices: within rtol 1e-4 and
  atol 1e-4 of the largest output of the unsharded forward and of JAX's
  sharded forward (``tests/test_torch_model.py``'s float32 bound). JAX's
  own test holds its two forwards within atol 2e-5; the port's CPU
  convolutions pick another algorithm for a batch of 1 than for 8, and the
  two differ by up to 4.3e-5 on the sigmoid scores (measured), as the port
  and JAX do. The heads' output convs are random, so every output depends
  on its image.
* detections, zero output convs (every logit its bias: all tie): scores
  within 1e-5 of JAX's sharded ``detect_multiframe``, ``cam_idx`` and the
  mask equal. With random output convs the bf16 logits of the two
  frameworks differ in their last bits and tie differently (the finding of
  ``tests/test_torch_detect_variants.py``), so there the sharded detections
  are held bit for bit against the port's unsharded ones instead.
* the clip: ``raw_mask`` (ids, classes) equal, ``states7`` and ``kf.x``
  within rtol/atol 1e-4, the JAX sharded-clip test's bound
  (``tests/test_multicam.py``), against JAX's ``make_mc_clip_step(mesh=
  make_mesh(3))`` with zero output convs. With random output convs, so that
  detections follow each frame's and camera's pixels, and a gather of the
  shards in swapped order must fail: against JAX's sharded clip with both
  packages' detectors in float32, ``raw_mask`` (ids, classes) equal and
  the states within rtol 1e-4 and atol 0.05 ft: the two packages' float32
  forwards differ by up to ~1e-4 of the largest output (the forward's
  bound above), which the parse carries into feet on the roadway. The six
  float32 clips (each package's default and ``batch_detects`` clip, the
  port's sharded and not) agree on ``raw_mask``, ids and classes and
  differ by at most 0.0216 ft in a state (measured; JAX's two variants
  0.0035, the port's sharded and unsharded 0.007). In bf16 the random-head
  logits tie at roundings that depend on the batch, so there the port's
  sharded clip is held against its unsharded one at the 1e-4 bound.
* data parallelism, float32: the gradient of step 1 within 1e-5 of the
  one-process gradient on the global batch, relative to its norm (the
  gradients of the two shards' mean losses average to the global mean's up
  to rounding); after 2 steps the two ranks' parameters bit-equal, within
  0.01 lr of the one-process trainer's, and the losses within 1e-5
  (relative).
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from playground3d_tpu.models import retinanet as JR
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.parallel.mesh import make_mesh as jax_mesh
from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
from playground3d_tpu.pipeline.multi_cam import make_mc_clip_step as jax_clip_step
from playground3d_tpu.pipeline.tracker_state import init_track_state as jax_init_state
from playground3d_tpu.track.kf import default_params as jax_kf_params
from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.ops.crop_mxu import pack_s2d
from playground3d_tpu_torch.parallel import mesh as PM
from playground3d_tpu_torch.pipeline import multi_cam as PMC
from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
from playground3d_tpu_torch.track.kf import default_params
from playground3d_tpu_torch.utils.config import TrackerConfig

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

_init = jax.jit(jax_init, static_argnames=("depth", "stem", "num_classes", "tower_depth", "shared_tower"))


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _random_heads(p, seed=41, std=0.01):
    """``p`` with random output convs: every logit and box depends on its
    own image's pixels."""
    p = dict(p, heads=dict(p["heads"]))
    rng = np.random.default_rng(seed)
    for name in ("cls_out", "reg_out"):
        w = p["heads"][name]["w"]
        p["heads"][name] = dict(p["heads"][name], w=jnp.asarray(rng.normal(0.0, std, w.shape).astype(np.float32)))
    return p


def _cpu_mesh(n):
    return PM.make_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_shards_and_replicates():
    mesh = PM.make_mesh(4, devices=["cpu"] * 8)
    assert mesh.size == 4 and mesh.axis == "data" and mesh.lead == torch.device("cpu")
    x = torch.arange(24).reshape(8, 3)
    parts = PM.shard_batch(mesh, x)
    assert [p.shape for p in parts] == [(2, 3)] * 4 and torch.equal(torch.cat(parts), x)
    cols = PM.shard_batch(_cpu_mesh(3), x, dim=1)
    assert torch.equal(torch.cat(cols, dim=1), x)
    with pytest.raises(ValueError, match="does not divide"):
        PM.shard_batch(_cpu_mesh(3), x)
    model = torch.nn.Linear(2, 2)
    assert PM.replicate(mesh, model) == (model,) * 4  # one copy a device: the model itself on its own
    assert PM.data_parallel_backend(mesh) == "gloo"
    with pytest.raises(ValueError, match="n_devices"):
        PM.make_mesh(9, devices=["cpu"] * 8)


# ---------------------------------------------------------------------------
# camera-sharded forward and detection (tests/test_parallel.py:21-62)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nets8():
    p = _init(jax.random.PRNGKey(0), num_classes=8, depth=18)
    pr = _random_heads(p)
    frames = np.random.default_rng(1).normal(0, 1, (8, 64, 128, 3)).astype(np.float32)
    return dict(jax=p, jax_random=pr, port=params_from_jax_numpy(_np_tree(p), device="cpu"),
                port_random=params_from_jax_numpy(_np_tree(pr), device="cpu"), frames=frames)


def test_camera_sharded_forward_matches(nets8):
    """The float32 forward of 8 frames, one a device of an 8-entry mesh,
    equals the unsharded forward and JAX's sharded one (random output
    convs)."""
    mesh = _cpu_mesh(8)
    frames = torch.as_tensor(nets8["frames"])
    model = nets8["port_random"]
    parts = [PR.forward_raw(m, x, dtype=torch.float32)
             for m, x in zip(PM.replicate(mesh, model), PM.shard_batch(mesh, frames))]
    cls, reg = (torch.cat(xs) for xs in zip(*parts))
    ref_cls, ref_reg = PR.forward_raw(model, frames, dtype=torch.float32)
    jcls, jreg = jax.jit(lambda x: JR.forward_raw(nets8["jax_random"], x, depth=18, dtype=jnp.float32))(
        jax.device_put(nets8["frames"], NamedSharding(jax_mesh(8), P("data"))))
    assert float(torch.std(cls)) > 1e-4  # the outputs follow the pixels
    for got, ref, jx in ((cls, ref_cls, jcls), (reg, ref_reg, jreg)):
        jx = np.asarray(jx)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4 * np.abs(jx).max())
        np.testing.assert_allclose(got.numpy(), jx, rtol=1e-4, atol=1e-4 * np.abs(jx).max())


def _sharded_detect(model, frames, mesh, reverse_merge=False, **kw):
    """``detect_multiframe`` over the mesh; ``reverse_merge``: the shards'
    candidates, each with its right global indices, merged in reversed
    order (the canary)."""
    models, shards = PM.replicate(mesh, model), PM.shard_batch(mesh, torch.as_tensor(frames))
    if not reverse_merge:
        return PR.detect_multiframe(models, shards, **kw)
    firsts = np.cumsum([0] + [x.shape[0] for x in shards]).tolist()
    parts = [PR.image_candidates(m, x, kw["pre_topk"], first_image=f) for m, x, f in zip(models, shards, firsts)]
    return PR.merge_candidates(PR.gather_candidates(parts[::-1], mesh.lead),
                               PR.frame_anchors(shards[0], model.stem), firsts[-1], mesh.size, **kw)


@pytest.mark.parametrize("reverse_merge", [False, True], ids=["mesh_order", "reversed_canary"])
def test_camera_sharded_detect_matches_jax_on_ties(nets8, reverse_merge):
    """Zero output convs: every logit ties, so the merge's order alone
    decides which anchors survive. The mesh-ordered merge equals JAX's
    sharded ``detect_multiframe``; merged in reversed shard order, the
    cameras differ."""
    kw = dict(pre_topk=512, max_dets=32)
    got = _sharded_detect(nets8["port"], nets8["frames"], _cpu_mesh(8), reverse_merge, **kw)
    want = JR.detect_multiframe(nets8["jax"], jax.device_put(nets8["frames"], NamedSharding(jax_mesh(8), P("data"))),
                                depth=18, **kw)
    same = np.array_equal(got.cam_idx.numpy(), np.asarray(want.cam_idx))
    if reverse_merge:
        assert not same
        return
    assert same and int(got.mask.sum()) == 32
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_camera_sharded_detect_equals_unsharded_with_random_heads(nets8, n_shards):
    """Random output convs: the sharded detections equal the unsharded
    ones bit for bit, for ``detect_multiframe`` and ``detect_frames``."""
    model, frames, mesh = nets8["port_random"], nets8["frames"], _cpu_mesh(n_shards)
    kw = dict(pre_topk=512, max_dets=32)
    got, ref = _sharded_detect(model, frames, mesh, **kw), PR.detect_multiframe(model, torch.as_tensor(frames), **kw)
    two = torch.as_tensor(frames).reshape((2, 4) + frames.shape[1:])  # two frames of 4 cameras
    small = _cpu_mesh(2)
    got_j = PR.detect_frames(PM.replicate(small, model), PM.shard_batch(small, two, dim=1), **kw)
    ref_j = PR.detect_frames(model, two, **kw)
    assert int(ref.mask.sum()) > 0
    for f in ref._fields:
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
        assert torch.equal(getattr(got_j, f), getattr(ref_j, f)), f


# ---------------------------------------------------------------------------
# the camera-sharded clip (tests/test_multicam.py:421-468)
# ---------------------------------------------------------------------------

T_CLIP = 6
KNOBS = dict(
    max_tracks=16, max_dets=16, pre_topk=128, x_range=(320.0, 880.0), f_init=1,
    det_step=2, skip_step=1, cd_max=8, cs=32, crop_slots=8, sigma_d=0.003, sigma_c=0.003, sigma_min=0.003,
    size_nudge=True, crop_conf_gate=True, tentative_age=4,
)


@pytest.fixture(scope="module")
def clip_nets(toy_cameras3):
    """The JAX sharded-clip test's pair (ResNet-18 s2d detector and crop
    net), the class bias raised by 3 so detections fire, and T_CLIP frames
    of the three cameras, s2d-packed uint8."""
    det = _init(jax.random.PRNGKey(0), depth=18, stem="s2d")
    crop = _init(jax.random.PRNGKey(1), depth=18, stem="s2d", tower_depth=2, shared_tower=True)
    for p in (det, crop):
        p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    det_r = _random_heads(det)
    raw = np.random.default_rng(5).integers(0, 256, (T_CLIP, 3, 64, 96, 3), dtype=np.uint8)
    return dict(
        jax_det=det, jax_crop=crop, jax_det_random=det_r,
        det=params_from_jax_numpy(_np_tree(det), device="cpu"),
        det_random=params_from_jax_numpy(_np_tree(det_r), device="cpu"),
        crop=params_from_jax_numpy(_np_tree(crop), device="cpu"),
        frames=np.stack([np.stack([pack_s2d(f) for f in cams]) for cams in raw]),
        cam_times=(np.arange(T_CLIP)[:, None] / 30.0 + np.zeros((1, 3))).astype(np.float32),
        ranges=list(toy_cameras3["ranges"].values()), cache={},
    )


def _seed(state, ranges, to):
    """A live track at the centre of each camera's range (``to``: the
    package's array constructor)."""
    n, n_slots = len(ranges), state.ids.shape[0]
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


def _jax_clip(clip_nets, toy_cameras3, batch_detects):
    key = ("jax", batch_detects)
    if key not in clip_nets["cache"]:
        clip = jax_clip_step(
            clip_nets["jax_det"], 18, jax_bank(toy_cameras3["registry"]), jnp.asarray(toy_cameras3["centers"]),
            jax_kf_params(), JaxConfig(**KNOBS), crop_params=clip_nets["jax_crop"], crop_depth=18, stem="s2d",
            crop_stem="s2d", mesh=jax_mesh(3), batch_detects=batch_detects,
        )
        state0 = _seed(jax_init_state(KNOBS["max_tracks"]), clip_nets["ranges"], jnp.asarray)
        clip_nets["cache"][key] = clip(state0, jnp.zeros((3,), jnp.float32), jnp.asarray(clip_nets["frames"]),
                                       clip_nets["cam_times"], 0)
    return clip_nets["cache"][key]


def _port_clip(clip_nets, toy_cameras3, det, mesh=None, **variant):
    clip = PMC.make_mc_clip_step(
        clip_nets[det], bank_from_registry(toy_cameras3["registry"], device="cpu"),
        torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), TrackerConfig(**KNOBS),
        crop_model=clip_nets["crop"], stem="s2d", crop_stem="s2d", mesh=mesh, **variant,
    )
    state0 = _seed(init_track_state(KNOBS["max_tracks"], "cpu"), clip_nets["ranges"], torch.as_tensor)
    return clip(state0, torch.zeros(3), torch.as_tensor(clip_nets["frames"]),
                torch.as_tensor(clip_nets["cam_times"]), 0)


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _check(a, b, atol=1e-4):
    """Clip outputs (state, ts_bias, snapshots) of either package: ids,
    ``raw_mask`` and classes equal, states within rtol 1e-4 and ``atol``
    (the JAX sharded-clip test's tolerances by default)."""
    (sa, _, na), (sb, _, nb) = a, b
    raw = _as_np(na.raw_mask)
    assert raw.sum() > 0
    for f in ("raw_mask", "ids", "classes"):
        np.testing.assert_array_equal(_as_np(getattr(na, f)), _as_np(getattr(nb, f)), err_msg=f)
    np.testing.assert_allclose(_as_np(na.states7)[raw], _as_np(nb.states7)[raw], rtol=1e-4, atol=atol)
    live = _as_np(sa.kf.mask)
    np.testing.assert_array_equal(_as_np(sb.kf.mask), live)
    np.testing.assert_allclose(_as_np(sa.kf.x)[live], _as_np(sb.kf.x)[live], rtol=1e-4, atol=atol)


def _reversed_parts(monkeypatch):
    """The canary: the lead gathers the shards' parts (frames and
    candidates) in reversed order, into static buffers and eagerly."""
    copy_parts, concat = PMC._copy_parts, PMC._concat
    monkeypatch.setattr(PMC, "_copy_parts", lambda dst, parts: copy_parts(dst, parts[::-1]))
    monkeypatch.setattr(PMC, "_concat", lambda parts, device: concat(parts[::-1], device))


VARIANTS = {"default": {}, "batch_detects": dict(batch_detects=True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_clip_matches_jax_sharded_clip(clip_nets, toy_cameras3, variant):
    """Zero output convs (ties decide the detections alike in both
    packages): the port's clip over a 3-shard mesh equals JAX's
    ``make_mc_clip_step(mesh=make_mesh(3))``."""
    want = _jax_clip(clip_nets, toy_cameras3, variant == "batch_detects")
    _check(want, _port_clip(clip_nets, toy_cameras3, "det", _cpu_mesh(3), **VARIANTS[variant]))


@pytest.fixture
def float32_detectors(monkeypatch):
    """Both packages' detectors and crop nets in float32 (the JAX clip has
    no dtype option; its detection and ``localize`` call ``forward_raw``
    with the default, as the port's candidates do; the port's clip passes
    ``localize`` its dtype): the logits then differ between the packages
    by float32 rounding, far below the spacing of random-head logits, and
    no longer tie at bf16 roundings that depend on the batch. JAX's caches are cleared on both
    sides: a clip traced before would otherwise reuse the bf16 forward it
    traced (measured: 7 of 96 ``raw_mask`` entries then differ), and a
    later one the float32 forward."""
    jax.clear_caches()
    monkeypatch.setattr(JR, "forward_raw", functools.partial(JR.forward_raw, dtype=jnp.float32))
    monkeypatch.setattr(PR, "forward_raw", functools.partial(PR.forward_raw, dtype=torch.float32))
    monkeypatch.setattr(PMC, "localize", functools.partial(PR.localize, dtype=torch.float32))
    yield
    jax.clear_caches()


@pytest.mark.parametrize("swapped", [False, True], ids=["mesh_order", "swapped_canary"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_clip_matches_jax_with_random_heads_in_float32(clip_nets, toy_cameras3, variant, swapped,
                                                               float32_detectors, monkeypatch):
    """Random output convs in the detector, the nets in float32: detections
    follow each frame's and camera's pixels, and JAX's sharded clip
    (``make_mc_clip_step(mesh=make_mesh(3))``) is the reference for which
    frame and camera each came from. The port's clip over a 3-shard mesh
    equals it (ids, ``raw_mask``, classes; states within 0.05 ft, see the
    module's docstring); with the camera blocks handed to the shards in
    swapped order (each shard's detections then carry another block's
    camera indices), it does not. Without ties the merge's own order
    cannot matter: a stable top-k of distinct logits is one set."""
    key = ("jax float32 random heads", variant)
    if key not in clip_nets["cache"]:
        clip = jax_clip_step(
            clip_nets["jax_det_random"], 18, jax_bank(toy_cameras3["registry"]),
            jnp.asarray(toy_cameras3["centers"]), jax_kf_params(), JaxConfig(**KNOBS),
            crop_params=clip_nets["jax_crop"], crop_depth=18, stem="s2d", crop_stem="s2d", mesh=jax_mesh(3),
            batch_detects=variant == "batch_detects",
        )
        state0 = _seed(jax_init_state(KNOBS["max_tracks"]), clip_nets["ranges"], jnp.asarray)
        clip_nets["cache"][key] = clip(state0, jnp.zeros((3,), jnp.float32), jnp.asarray(clip_nets["frames"]),
                                       clip_nets["cam_times"], 0)
    want = clip_nets["cache"][key]
    if swapped:
        shard_batch = PMC.shard_batch
        monkeypatch.setattr(PMC, "shard_batch", lambda mesh, x, dim=0: shard_batch(mesh, x, dim)[::-1])
    got = _port_clip(clip_nets, toy_cameras3, "det_random", _cpu_mesh(3), **VARIANTS[variant])
    if swapped:
        with pytest.raises(AssertionError):
            _check(want, got, atol=0.05)
        return
    _check(want, got, atol=0.05)


@pytest.mark.parametrize("swapped", [False, True], ids=["mesh_order", "swapped_canary"])
@pytest.mark.parametrize("graphs", [True, False], ids=["static_buffers", "eager"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_clip_follows_each_cameras_pixels(clip_nets, toy_cameras3, variant, graphs, swapped, monkeypatch):
    """Random output convs, so that detections follow each frame's and
    camera's pixels: the port's clip over a 3-shard mesh (its static
    buffers, as the card runs it, and eagerly) equals its unsharded clip;
    gathered in swapped shard order, it does not."""
    want = _port_clip(clip_nets, toy_cameras3, "det_random", **VARIANTS[variant])
    if swapped:
        _reversed_parts(monkeypatch)
    got = _port_clip(clip_nets, toy_cameras3, "det_random", PM.make_mesh(devices=["cpu"] * 3), graphs=graphs,
                     **VARIANTS[variant])
    if swapped:
        with pytest.raises(AssertionError):
            _check(want, got)
        return
    _check(want, got)


def test_sharded_clip_takes_camera_shards_on_their_devices(clip_nets, toy_cameras3):
    """Frames given as one tensor a mesh device (as ``track_clips(mesh=)``
    stages them) run as the whole tensor does; shards of the wrong count
    or shape raise."""
    mesh = PM.make_mesh(devices=["cpu"] * 3)
    whole = _port_clip(clip_nets, toy_cameras3, "det_random", mesh)
    clip = PMC.make_mc_clip_step(
        clip_nets["det_random"], bank_from_registry(toy_cameras3["registry"], device="cpu"),
        torch.as_tensor(toy_cameras3["centers"]), default_params(device="cpu"), TrackerConfig(**KNOBS),
        crop_model=clip_nets["crop"], stem="s2d", crop_stem="s2d", mesh=mesh,
    )
    shards = PM.shard_batch(mesh, torch.as_tensor(clip_nets["frames"]), dim=1)
    state0 = _seed(init_track_state(KNOBS["max_tracks"], "cpu"), clip_nets["ranges"], torch.as_tensor)
    args = (torch.zeros(3), torch.as_tensor(clip_nets["frames"]), torch.as_tensor(clip_nets["cam_times"]), 0)
    got = clip(state0, args[0], shards, *args[2:])
    for a, b in zip(whole[2], got[2]):  # bit for bit (dead slots' states are NaN in both)
        assert torch.allclose(a, b, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="shards"):
        clip(state0, args[0], shards[:2], *args[2:])


@pytest.mark.parametrize("case", ["unroll", "cameras"])
def test_sharded_clip_raises_where_jax_does(clip_nets, toy_cameras3, case):
    """``unroll`` with a mesh raises in both packages; three cameras do not
    divide over a 2-device mesh."""
    kw = dict(stem="s2d", crop_stem="s2d")
    bank, centers = bank_from_registry(toy_cameras3["registry"], device="cpu"), torch.as_tensor(toy_cameras3["centers"])
    if case == "unroll":
        with pytest.raises(ValueError, match="unroll"):
            PMC.make_mc_clip_step(clip_nets["det"], bank, centers, default_params(device="cpu"),
                                  TrackerConfig(**KNOBS), crop_model=clip_nets["crop"], mesh=_cpu_mesh(3),
                                  unroll=True, **kw)
        with pytest.raises(ValueError, match="unroll"):
            jax_clip_step(clip_nets["jax_det"], 18, jax_bank(toy_cameras3["registry"]),
                          jnp.asarray(toy_cameras3["centers"]), jax_kf_params(), JaxConfig(**KNOBS),
                          mesh=jax_mesh(3), unroll=True)
        return
    with pytest.raises(ValueError, match="does not divide"):
        _port_clip(clip_nets, toy_cameras3, "det", _cpu_mesh(2))


def test_track_clips_on_a_mesh_gives_the_unsharded_rows(clip_nets, toy_cameras3):
    """``MultiCameraTracker.track`` over a 3-shard mesh (each camera staged
    on its shard, raw frames packed there; random output convs): every row
    and logged bias equals ``track`` without a mesh, over a full clip and a
    partial one; a mesh whose lead is not the tracker's device raises."""
    rng = np.random.default_rng(34)
    buf = rng.integers(0, 256, (5, 3, 64, 96, 3), dtype=np.uint8)

    def camera(ci):  # one camera's stream (a function, so each generator keeps its own ci)
        return ((buf[f, ci], 1.6e9 + f / 30.0) for f in range(buf.shape[0]))

    rows = {}
    for name, mesh in (("plain", None), ("mesh", _cpu_mesh(3))):
        trk = PMC.MultiCameraTracker(
            toy_cameras3["registry"], list(toy_cameras3["ranges"]), cfg=TrackerConfig(**KNOBS),
            det_model=clip_nets["det_random"], crop_model=clip_nets["crop"], centers=toy_cameras3["centers"],
            stem="s2d", crop_stem="s2d", device="cpu",
        )
        trk.state = _seed(trk.state, clip_nets["ranges"], torch.as_tensor)
        stats = trk.track([camera(ci) for ci in range(3)], clip_len=3, mesh=mesh)
        assert stats["frames"] == 5
        rows[name] = trk
    plain, mesh = rows["plain"], rows["mesh"]
    assert len(plain.rows) == len(mesh.rows) == 5 and sum(len(r[2]) for r in plain.rows) > 0
    for rp, rm in zip(plain.rows, mesh.rows):
        assert rp[0] == rm[0] and rp[1] == rm[1]
        np.testing.assert_array_equal(rp[2], rm[2])
        np.testing.assert_allclose(rp[3], rm[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(rp[4], rm[4])
    np.testing.assert_array_equal(np.asarray(plain.ts_bias_log), np.asarray(mesh.ts_bias_log))
    with pytest.raises(ValueError, match="lead"):
        plain._clip_fn(PM.Mesh((torch.device("meta"), torch.device("cpu"))))


def test_track_clips_yuv_on_a_mesh_gives_the_unsharded_rows(clip_nets, monkeypatch):
    """Flat YUV420 bytes through ``track_clips(yuv_hw=, mesh=)`` over a
    2-shard mesh (each shard's cameras converted and packed on its device;
    random output convs): every row and logged bias equals the unsharded
    YUV clip's, over a full clip and a partial one."""
    from playground3d_tpu.data.toy_cameras import make_projector, register_toy_camera
    from playground3d_tpu.geometry.homography import CameraRegistry

    ranges = {"p1c1": (350, 560), "p1c2": (480, 700)}
    reg = CameraRegistry()
    for i, (name, rx) in enumerate(ranges.items()):
        register_toy_camera(reg, name, make_projector(cam_x=rx[0] - 30.0), rx, seed=7 + i)
    centers = np.array([[(a + b) / 2.0, 60.0] for a, b in ranges.values()], np.float32)
    buf = np.random.default_rng(35).integers(0, 256, (5, 2, 64 * 96 * 3 // 2), dtype=np.uint8)

    def camera(ci):
        return ((buf[f, ci], 1.6e9 + f / 30.0) for f in range(buf.shape[0]))

    convert, converted = PMC.yuv420_flat_to_s2d, []  # the cameras of each conversion
    monkeypatch.setattr(PMC, "yuv420_flat_to_s2d", lambda ft, hw: converted.append(ft.shape[1]) or convert(ft, hw))
    rows = {}
    for name, mesh in (("plain", None), ("mesh", _cpu_mesh(2))):
        converted.clear()
        trk = PMC.MultiCameraTracker(
            reg, list(ranges), cfg=TrackerConfig(**KNOBS), det_model=clip_nets["det_random"],
            crop_model=clip_nets["crop"], centers=centers, stem="s2d", crop_stem="s2d", device="cpu",
        )
        trk.state = _seed(trk.state, list(ranges.values()), torch.as_tensor)
        stats = trk.track_clips([camera(ci) for ci in range(2)], clip_len=3, mesh=mesh, yuv_hw=(64, 96))
        assert stats["frames"] == 5
        assert converted == ([2, 2] if mesh is None else [1, 1, 1, 1])  # two clips; a shard converts its own
        rows[name] = trk
    plain, mesh = rows["plain"], rows["mesh"]
    assert len(plain.rows) == len(mesh.rows) == 5 and sum(len(r[2]) for r in plain.rows) > 0
    for rp, rm in zip(plain.rows, mesh.rows):
        assert rp[0] == rm[0] and rp[1] == rm[1]
        np.testing.assert_array_equal(rp[2], rm[2])
        np.testing.assert_allclose(rp[3], rm[3], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(rp[4], rm[4])
    np.testing.assert_array_equal(np.asarray(plain.ts_bias_log), np.asarray(mesh.ts_bias_log))


# ---------------------------------------------------------------------------
# data-parallel training (tests/test_train.py:85-94)
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent(
    """
    import functools
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.parallel.mesh import join_data_parallel, make_mesh
    from playground3d_tpu_torch.train import trainer as PT

    rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    PT.loss_fn = functools.partial(PT.loss_fn, dtype=torch.float32)  # the check is at float32
    grads = []  # the gradients Adam is given at each step (before the clip)
    adam_step = PT.Optimizer.step
    PT.Optimizer.step = lambda self: (grads.append([t.grad.detach().clone() for t in self.leaves]), adam_step(self))
    mesh = make_mesh(devices=["cpu"] * 2)
    join_data_parallel(mesh, rank, init)
    ds = SyntheticDetectionDataset(image_shape=(64, 128), n_objects=3, seed=0, augment=False, zoom=6.0)
    trainer = PT.Trainer(PT.TrainConfig(depth=18, image_shape=(64, 128), lr=1e-4),
                         generator=torch.Generator().manual_seed(rank), mesh=mesh)
    batches = ds.batches(4)
    losses = [float(trainer.train_step(*next(batches))["loss"]) for _ in range(2)]
    try:
        trainer.train_step(*[x[:3] for x in next(batches)])
        odd = "ran"
    except ValueError as e:
        odd = str(e)
    keys = list(PT.train_leaves(trainer.model))
    torch.save({"losses": losses, "odd": odd, "device": str(trainer.device),
                "grad1": dict(zip(keys, grads[0])),
                "leaves": {k: t.detach().clone() for k, t in PT.train_leaves(trainer.model).items()}}, out)
    torch.distributed.destroy_process_group()
    """
)


def _rel(a: dict, b: dict) -> float:
    """||a - b|| / ||b|| over every leaf of two gradient trees, in float64."""
    num = sum(float((a[k].double() - b[k].double()).square().sum()) for k in b)
    return (num / sum(float(b[k].double().square().sum()) for k in b)) ** 0.5


def _step1_grads(PT, images, labels, monkeypatch) -> dict:
    """The gradient a one-process trainer from rank 0's parameters hands
    Adam at its first step on ``images``."""
    grads = []
    adam_step = PT.Optimizer.step
    monkeypatch.setattr(PT.Optimizer, "step", lambda self: (
        grads.append([t.grad.detach().clone() for t in self.leaves]), adam_step(self)))
    tr = PT.Trainer(PT.TrainConfig(depth=18, image_shape=(64, 128), lr=1e-4),
                    generator=torch.Generator().manual_seed(0), device="cpu")
    tr.train_step(images, labels)
    monkeypatch.setattr(PT.Optimizer, "step", adam_step)
    return dict(zip(PT.train_leaves(tr.model), grads[0]))


def test_two_gloo_ranks_train_as_one_process_on_the_global_batch(tmp_path, monkeypatch):
    """Two ranks (processes of their own, ``file://`` rendezvous, gloo on
    the CPU), each given the global batch of 4, their generators seeded
    apart (rank 0's parameters are broadcast), 2 float32 steps:

    * the gradient both ranks hand Adam at step 1 is the one-process
      gradient of the global batch, within 1e-5 of its norm (the mean of
      the two halves' mean-loss gradients is the global mean's up to
      float32 rounding: 9.4e-8 measured). Rank 0's half alone, the gradient
      that a missing all-reduce would leave it, is 2.6e-2 away (measured;
      the class bias's gradient, the same for every image, dominates the
      norm at initialisation), and twice the mean (a missing divide) 1.0:
      both fail this bound;
    * both ranks' parameters are bit-equal after 2 steps, and within
      0.01 lr of the one-process trainer's (Adam moves an element by about
      lr at each of these steps, so a gradient of the other sign shows as
      ~2 lr); their losses within 1e-5 (relative) of its losses;
    * a batch of 3 raises on both ranks."""
    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.train import trainer as PT

    init = f"file://{tmp_path}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), init, str(tmp_path / f"rank{r}.pt")],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, PYTHONPATH=os.getcwd()))
             for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    monkeypatch.setattr(PT, "loss_fn", functools.partial(PT.loss_fn, dtype=torch.float32))
    ds = SyntheticDetectionDataset(image_shape=(64, 128), n_objects=3, seed=0, augment=False, zoom=6.0)
    batches = ds.batches(4)
    images, labels = next(batches)
    want = _step1_grads(PT, images, labels, monkeypatch)
    half = _step1_grads(PT, images[:2], labels[:2], monkeypatch)
    for r in ranks:
        assert _rel(r["grad1"], want) <= 1e-5
    assert _rel(half, want) > 100 * 1e-5  # the canary: rank 0's half alone is far outside the bound
    assert _rel({k: 2 * t for k, t in want.items()}, want) == pytest.approx(1.0)

    one = PT.Trainer(PT.TrainConfig(depth=18, image_shape=(64, 128), lr=1e-4),
                     generator=torch.Generator().manual_seed(0), device="cpu")
    losses = [float(one.train_step(images, labels)["loss"]), float(one.train_step(*next(batches))["loss"])]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-5)
    worst = 0.0
    for k, t in PT.train_leaves(one.model).items():
        assert torch.equal(ranks[0]["leaves"][k], ranks[1]["leaves"][k]), k
        worst = max(worst, float((ranks[0]["leaves"][k] - t.detach()).abs().max()))
    assert worst <= 0.01 * 1e-4
    for r in ranks:
        assert "does not divide" in r["odd"] and r["device"] == "cpu"


def test_trainer_on_a_mesh_needs_its_process_group():
    """``Trainer(mesh=)`` runs one process a mesh device: without a joined
    group it raises rather than train on one device."""
    from playground3d_tpu_torch.train import trainer as PT

    with pytest.raises(RuntimeError, match="join_data_parallel"):
        PT.Trainer(PT.TrainConfig(depth=18), mesh=_cpu_mesh(2), device="cpu")
