"""The single-camera tracker in the PyTorch port against the JAX package.

* The golden scenario (``tests/test_golden.py``: 40 frames, 6 objects, seed
  9, oracle detector) run with the port's modules reproduces
  ``tests/golden/single_cam_golden.csv``: the same (frame, id) keys, states
  within 1e-2 ft.
* Oracle tracking, port against JAX ``SingleCameraTracker`` on the same
  seeded scene: per frame the ids and classes equal, states within rtol/atol
  1e-4; given the same rows, the CSV is byte-equal.
* ``make_full_step`` and ``make_clip_step`` at depth 18 on 64x96 frames, conv7
  + float and s2d + int8 (the pair quantized by the JAX package and bridged):
  ids, masks and classes equal, ``states7`` and ``kf.x`` within rtol/atol
  1e-4. The output convs have zero weights (the focal prior; zero also after
  quantization), so every logit is its bias and every box decodes from the
  regression bias, whatever the backbone computes. The class bias is raised
  by 3 so detections pass the gates, and the regression bias is set so that
  each anchor of cell (0, 0) decodes to a car on the road: the detector
  then yields boxes that parse to roadway states, and tracks are born,
  matched and updated.
* ``approx_topk=True`` gives JAX's ``approx_max_k`` result off the TPU, with
  distinct and with tied logits.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.data.synthetic import SyntheticScene as JaxScene
from playground3d_tpu.data.synthetic import oracle_detections as jax_oracle
from playground3d_tpu.data.toy_cameras import register_bench_camera as jax_bench_camera
from playground3d_tpu.data.toy_cameras import toy_camera_chain as jax_chain
from playground3d_tpu.models import retinanet as JR
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.quant import quantize_detector as jax_quantize_detector
from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
from playground3d_tpu.pipeline.single_cam import SingleCameraTracker as JaxTracker
from playground3d_tpu.pipeline.single_cam import make_clip_step as jax_clip_step
from playground3d_tpu.pipeline.single_cam import make_full_step as jax_full_step
from playground3d_tpu.pipeline.tracker_state import init_track_state as jax_init_state
from playground3d_tpu.track.kf import default_params as jax_kf_params
from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
from playground3d_tpu_torch.data.synthetic import SyntheticScene, aimed_regression_bias, oracle_detections
from playground3d_tpu_torch.data.toy_cameras import register_bench_camera, toy_camera_chain
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.models.quant import is_quantized
from playground3d_tpu_torch.ops.crop_mxu import pack_s2d
from playground3d_tpu_torch.ops.topk import HostSyncs
from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
from playground3d_tpu_torch.pipeline.single_cam import (
    SingleCameraTracker,
    make_clip_step,
    make_full_step,
)
from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
from playground3d_tpu_torch.track.kf import default_params
from playground3d_tpu_torch.utils.config import TrackerConfig

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "single_cam_golden.csv")
HW = (64, 96)
CAR = (330.0, 30.0, 18.0, 6.0, 5.0, 1.0)  # 80 ft down the road from the pole
T_STEPS = 4
KNOBS = dict(max_tracks=16, max_dets=16, pre_topk=128, x_range=(200.0, 800.0), f_init=1,
             sigma_d=0.003, sigma_min=0.003)


# ---------------------------------------------------------------------------
# oracle tracking
# ---------------------------------------------------------------------------


def _oracle_run(pkg, n_frames, n_objects, seed, noise_px, drop_prob, out_csv=None):
    """The golden scenario (``tests/test_golden.py``) on either
    package: a one-camera toy chain, a seeded scene, oracle detections."""
    chain, Scene, oracle, Tracker, Config = (
        (jax_chain, JaxScene, jax_oracle, JaxTracker, JaxConfig) if pkg == "jax"
        else (toy_camera_chain, SyntheticScene, oracle_detections, SingleCameraTracker, TrackerConfig)
    )
    reg, ranges, _, _ = chain(1)
    cam = list(ranges.keys())[0]
    lo, hi = ranges[cam]
    scene = Scene(n_objects=n_objects, seed=seed, x_spawn=(lo + 20, hi - 20), x_visible=(lo, hi))
    cfg = Config(max_tracks=16, max_dets=16, x_range=(lo - 50, hi + 50), f_init=2)
    rng = np.random.default_rng(4)
    holder = {"f": 0}
    P = reg.P[0, 0]
    dev = {} if pkg == "jax" else {"device": "cpu"}

    def detect_fn(frames):
        return oracle(scene, holder["f"] / 30.0, P, K=cfg.max_dets, noise_px=noise_px,
                      drop_prob=drop_prob, rng=rng, **dev)

    tracker = Tracker(reg, cam, cfg=cfg, detect_fn=detect_fn, **dev)

    def frames():
        for f in range(n_frames):
            holder["f"] = f
            yield np.zeros((4, 4, 3), np.float32), 1.6e9 + f / 30.0

    tracker.track(frames())
    if out_csv is not None:
        tracker.write_results_csv(out_csv)
    return tracker


def _state_dict(path):
    _, data = load_i24_csv(path)
    return {(frame, int(r[2])): parse_state_row(r) for frame, rows in data.items() for r in rows}


def test_golden_scenario_reproduced(tmp_path):
    """Done condition 2: the port's single camera reproduces the golden CSV."""
    out = str(tmp_path / "run.csv")
    _oracle_run("port", 40, 6, 9, 0.5, 0.0, out)
    got, want = _state_dict(out), _state_dict(GOLDEN)
    assert set(got) == set(want), (sorted(set(want) - set(got))[:5], sorted(set(got) - set(want))[:5])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-2, err_msg=str(k))


@pytest.mark.parametrize("scenario", [(40, 6, 9, 0.5, 0.0), (30, 10, 3, 1.0, 0.2)],
                         ids=["golden", "noisy_drops"])
def test_oracle_tracking_matches_jax(tmp_path, scenario):
    """Per frame: ids and classes equal, states within 1e-4; the CSV the
    port writes from JAX's rows is byte-equal to JAX's."""
    jt = _oracle_run("jax", *scenario, out_csv=str(tmp_path / "jax.csv"))
    pt = _oracle_run("port", *scenario)
    assert len(pt.rows) == len(jt.rows) == scenario[0]
    live = 0
    for (pf, pts, pids, pst, pcl), (jf, jts, jids, jst, jcl) in zip(pt.rows, jt.rows):
        assert (pf, pts) == (jf, jts)
        np.testing.assert_array_equal(pids, jids, err_msg=f"ids, frame {pf}")
        np.testing.assert_array_equal(pcl, jcl, err_msg=f"classes, frame {pf}")
        np.testing.assert_allclose(pst, jst, rtol=1e-4, atol=1e-4, err_msg=f"states, frame {pf}")
        live += len(pids)
    assert live > 50
    pt.rows = jt.rows
    pt.write_results_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_drain_is_one_read_per_frame(monkeypatch):
    """``process_frame`` fetches each snapshot in one device->host read,
    counted in ``HostSyncs``, and keeps exactly the live slots."""
    fetched = []
    real = HostSyncs.fetch.__func__

    def counting(cls, t, loop="drain"):
        fetched.append(tuple(t.shape))
        return real(cls, t, loop)

    monkeypatch.setattr(HostSyncs, "fetch", classmethod(counting))
    drains = HostSyncs.by_loop["drain"]
    tracker = _oracle_run("port", 5, 6, 9, 0.5, 0.0)
    assert fetched == [(16, 11)] * 5 and HostSyncs.by_loop["drain"] - drains == 5
    assert all(len(ids) == len(st) == len(cl) for _, _, ids, st, cl in tracker.rows)


def test_timers_total_the_stage_spans():
    """The tracker's ``timers`` are its spans' totals, a plain dict of host
    seconds under the stage names it always had, and ``track`` returns them
    beside the frame count."""
    tracker = _oracle_run("port", 5, 6, 9, 0.5, 0.0)
    assert type(tracker.timers) is dict and tracker.timers is tracker.spans.totals
    assert set(tracker.timers) == {"detect+track", "stage", "drain"}
    assert all(isinstance(v, float) and v > 0 for v in tracker.timers.values()), tracker.timers
    stats = tracker.track(iter([(np.zeros((4, 4, 3), np.float32), 1.6e9 + 5 / 30.0)]))
    assert set(stats) == {"frames", "fps", "detect+track", "stage", "drain"} and stats["frames"] == 1


# ---------------------------------------------------------------------------
# the detector path: make_full_step / make_clip_step
# ---------------------------------------------------------------------------


def _steer(p):
    """Class bias +3 and a regression bias under which each anchor of cell
    (0, 0) decodes to a car 80 ft down the road from the camera."""
    reg, _ = register_bench_camera(HW)
    p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    p["heads"]["reg_out"]["b"] = jnp.asarray(aimed_regression_bias(reg.P[0, 0], CAR, HW))
    return p


@pytest.fixture(scope="module")
def nets():
    init = jax.jit(jax_init, static_argnames=("depth", "stem"))
    to_np = lambda p: jax.tree_util.tree_map(np.asarray, p)  # noqa: E731
    rng = np.random.default_rng(31)
    frames = rng.integers(0, 256, (T_STEPS, 1) + HW + (3,)).astype(np.uint8)
    packed = np.stack([np.stack([pack_s2d(f) for f in cams]) for cams in frames])
    conv7 = _steer(init(jax.random.PRNGKey(0), depth=18, stem="conv7"))
    s2d = _steer(init(jax.random.PRNGKey(0), depth=18, stem="s2d"))
    int8 = jax_quantize_detector(s2d, packed[0], 18, stem="s2d")
    out = {}
    for name, p, stem, fr in (("conv7", conv7, "conv7", frames), ("int8", int8, "s2d", packed)):
        out[name] = dict(jax=p, port=params_from_jax_numpy(to_np(p), device="cpu"), stem=stem, frames=fr)
    assert is_quantized(out["int8"]["port"]) and not is_quantized(out["conv7"]["port"])
    return out


def _times():
    return (np.arange(T_STEPS, dtype=np.float32)[:, None] / 30.0)


def _run_steps(net, clip=False):
    """(JAX snapshots, JAX state, port snapshots, port state) over T_STEPS
    frames, frame by frame or as one clip."""
    stem, frames, times = net["stem"], net["frames"], _times()
    jcfg, pcfg = JaxConfig(**KNOBS), TrackerConfig(**KNOBS)
    jreg, _ = jax_bench_camera(HW)
    preg, _ = register_bench_camera(HW)
    jargs = (net["jax"], 18, jax_bank(jreg), jax_kf_params(), jcfg)
    pargs = (net["port"], bank_from_registry(preg, device="cpu"), default_params(device="cpu"), pcfg)
    js, ps = jax_init_state(jcfg.max_tracks), init_track_state(pcfg.max_tracks, "cpu")
    if clip:
        js, jsn = jax_clip_step(*jargs, stem=stem)(js, jnp.asarray(frames), jnp.asarray(times))
        ps, psn = make_clip_step(*pargs, stem=stem)(ps, torch.as_tensor(frames), torch.as_tensor(times))
        return jsn, js, psn, ps
    jstep, pstep = jax_full_step(*jargs, stem=stem), make_full_step(*pargs, stem=stem)
    jsn, psn = [], []
    for t in range(T_STEPS):
        js, s = jstep(js, jnp.asarray(frames[t]), jnp.asarray(times[t]))
        jsn.append(s)
        ps, s = pstep(ps, torch.as_tensor(frames[t]), torch.as_tensor(times[t]))
        psn.append(s)
    stack = lambda snaps: type(snaps[0])(*(np.stack([np.asarray(x) for x in xs]) for xs in zip(*snaps)))  # noqa: E731
    return stack(jsn), js, stack(psn), ps


def _check_steps(jsn, js, psn, ps):
    raw = np.asarray(jsn.raw_mask)
    assert raw[0].sum() >= 3 and raw[-1].sum() >= 3, "the steered detector gives births and keeps them"
    for t in range(T_STEPS):
        for f in ("ids", "raw_mask", "mask", "classes"):
            np.testing.assert_array_equal(np.asarray(getattr(psn, f)[t]), np.asarray(getattr(jsn, f)[t]),
                                          err_msg=f"{f} {t}")
        live = raw[t]
        np.testing.assert_allclose(np.asarray(psn.states7[t])[live], np.asarray(jsn.states7[t])[live],
                                   rtol=1e-4, atol=1e-4, err_msg=f"states7 {t}")
    live = np.asarray(js.kf.mask)
    np.testing.assert_array_equal(ps.kf.mask.numpy(), live)
    np.testing.assert_allclose(ps.kf.x.numpy()[live], np.asarray(js.kf.x)[live], rtol=1e-4, atol=1e-4)
    for f in ("fsld", "misses", "age", "next_id"):
        np.testing.assert_array_equal(getattr(ps, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("path", ["conv7", "int8"])
def test_full_step_matches_jax(nets, path):
    """conv7 + float, and s2d + int8 on packed uint8 frames."""
    _check_steps(*_run_steps(nets[path]))


def test_clip_step_matches_jax_and_frame_steps(nets):
    """The clip (a host loop here, ``lax.scan`` in JAX) equals JAX's clip
    and the port's own frame-by-frame steps."""
    jsn, js, psn, ps = _run_steps(nets["conv7"], clip=True)
    _check_steps(jsn, js, psn, ps)
    _, _, fsn, fs = _run_steps(nets["conv7"])
    for f in ("ids", "raw_mask", "classes", "states7"):
        np.testing.assert_array_equal(getattr(psn, f).numpy(), getattr(fsn, f), err_msg=f)
    np.testing.assert_array_equal(ps.kf.x.numpy(), fs.kf.x.numpy())


@pytest.mark.parametrize("path", ["conv7", "int8"])
def test_tracker_with_detector_matches_jax(nets, path):
    """``SingleCameraTracker`` driving the detector (raw uint8 frames; the
    s2d detector packs them itself): the rows equal JAX's."""
    net = nets[path]
    jreg, _ = jax_bench_camera(HW)
    preg, _ = register_bench_camera(HW)
    raw = np.random.default_rng(32).integers(0, 256, (T_STEPS,) + HW + (3,)).astype(np.uint8)
    jt = JaxTracker(jreg, "p1c1", cfg=JaxConfig(**KNOBS), det_params=net["jax"], depth=18, stem=net["stem"])
    pt = SingleCameraTracker(preg, "p1c1", cfg=TrackerConfig(**KNOBS), det_model=net["port"],
                             stem=net["stem"], device="cpu")
    src = [(raw[k], 1.6e9 + k / 30.0) for k in range(T_STEPS)]
    if net["stem"] == "s2d":  # the JAX tracker takes what its detector takes: packed frames
        jsrc = [(pack_s2d(f), t) for f, t in src]
    else:
        jsrc = src
    jt.track(jsrc)
    pt.track(src)
    for (pf, pts, pids, pst, pcl), (jf, jts, jids, jst, jcl) in zip(pt.rows, jt.rows, strict=True):
        assert (pf, pts) == (jf, jts)
        np.testing.assert_array_equal(pids, jids)
        np.testing.assert_array_equal(pcl, jcl)
        np.testing.assert_allclose(pst, jst, rtol=1e-4, atol=1e-4)
    assert sum(len(r[2]) for r in pt.rows) >= 3 * T_STEPS


@pytest.mark.parametrize("path", ["conv7", "int8"])
def test_static_buffer_step_matches_eager_and_jax(nets, path):
    """The step over static buffers (what the card captures as one CUDA
    graph; on the CPU the same buffers and write-backs without capture):
    ``make_clip_step`` replays it frame by frame and equals the eager
    ``make_full_step`` bit for bit and JAX's within 1e-4; the tracker on it
    equals the eager tracker bit for bit, returns snapshots that later
    frames leave alone, keeps its state in the buffers and copies a state
    it is given into them."""
    net = nets[path]
    jsn, js, esn, es = _run_steps(net)
    preg, _ = register_bench_camera(HW)
    args = (net["port"], bank_from_registry(preg, device="cpu"), default_params(device="cpu"), TrackerConfig(**KNOBS))
    clip = make_clip_step(*args, stem=net["stem"])
    ps, psn = clip(init_track_state(KNOBS["max_tracks"], "cpu"), torch.as_tensor(net["frames"]),
                   torch.as_tensor(_times()))
    assert len(clip.runners) == 1
    _check_steps(jsn, js, psn, ps)
    for f in psn._fields:
        np.testing.assert_array_equal(getattr(psn, f).numpy(), getattr(esn, f), err_msg=f)
    assert all(torch.equal(a, b) for a, b in zip([*ps.kf, *ps[1:]], [*es.kf, *es[1:]]))

    raw = np.random.default_rng(32).integers(0, 256, (T_STEPS,) + HW + (3,)).astype(np.uint8)
    src = [(pack_s2d(f) if net["stem"] == "s2d" else f, 1.6e9 + k / 30.0) for k, f in enumerate(raw)]
    trackers = [SingleCameraTracker(preg, "p1c1", cfg=TrackerConfig(**KNOBS), det_model=net["port"],
                                    stem=net["stem"], device="cpu", graphs=g) for g in (True, False)]
    snaps = [[t.process_frame(f, ts, k) for k, (f, ts) in enumerate(src)] for t in trackers]
    for a, b in zip(*snaps):  # each frame's own snapshot, not the buffers' last one
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for ra, rb in zip(trackers[0].rows, trackers[1].rows, strict=True):
        assert ra[:2] == rb[:2] and all(np.array_equal(x, y) for x, y in zip(ra[2:], rb[2:]))
    assert sum(len(r[2]) for r in trackers[0].rows) >= 3 * T_STEPS
    graph = trackers[0]._graph
    assert trackers[0].state is graph.state
    fresh = init_track_state(KNOBS["max_tracks"], "cpu")
    trackers[0].state = fresh
    trackers[0].process_frame(*src[0], T_STEPS)
    assert trackers[0].state is graph.state and int(fresh.next_id) == 0
    assert trackers[0].rows[-1][2].tolist() == trackers[1].rows[0][2].tolist()


@pytest.mark.parametrize("heads", ["distinct", "tied"])
def test_approx_topk_matches_jax(heads):
    """``approx_topk=True`` through ``detect_multiframe``: the port's exact
    top-k equals JAX's ``approx_max_k`` on the CPU. The output convs are
    zero, so the logits are their biases in both packages: a distinct bias
    per (anchor, class), or the focal prior on every logit (all tied)."""
    p = jax.jit(jax_init, static_argnames=("depth",))(jax.random.PRNGKey(3), depth=18)
    if heads == "distinct":
        b = np.random.default_rng(33).normal(-1.0, 1.0, p["heads"]["cls_out"]["b"].shape)
        p["heads"]["cls_out"]["b"] = jnp.asarray(b.astype(np.float32))
    else:
        p["heads"]["cls_out"]["b"] = p["heads"]["cls_out"]["b"] + 3.0
    m = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu")
    x = np.random.default_rng(34).integers(0, 256, (2,) + HW + (3,)).astype(np.uint8)
    dj = JR.detect_multiframe(p, jnp.asarray(x), depth=18, pre_topk=96, max_dets=24, approx_topk=True)
    dp = PR.detect_multiframe(m, torch.as_tensor(x), pre_topk=96, max_dets=24, approx_topk=True)
    de = PR.detect_multiframe(m, torch.as_tensor(x), pre_topk=96, max_dets=24)
    for f in ("mask", "cam_idx", "classes"):
        np.testing.assert_array_equal(getattr(dp, f).numpy(), np.asarray(getattr(dj, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(dp, f).numpy(), getattr(de, f).numpy(), err_msg=f)
    assert int(dp.mask.sum()) > 0
    np.testing.assert_allclose(dp.scores.numpy(), np.asarray(dj.scores), rtol=1e-6)
    np.testing.assert_allclose(dp.boxes.numpy(), np.asarray(dj.boxes), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("logits", ["distinct", "ties"])
def test_top_k_equals_approx_max_k_off_the_tpu(logits):
    """The function itself: ``approx_max_k(x, k, recall_target=0.99)`` on the
    CPU returns the indices of the port's ``top_k`` (lower index first on
    ties), at the main path's candidate count (512 of ~400k)."""
    from playground3d_tpu_torch.ops.topk import top_k

    rng = np.random.default_rng(35)
    x = rng.normal(size=400_000).astype(np.float32)
    if logits == "ties":
        x = np.round(x * 4) / 4  # a few dozen distinct values
    jv, ji = jax.lax.approx_max_k(jnp.asarray(x), 512, recall_target=0.99)
    pv, pi = top_k(torch.as_tensor(x), 512)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("entry", ["make_full_step", "make_clip_step", "SingleCameraTracker"])
def test_stem_mismatch_raises(nets, entry):
    """A detector built with one stem refuses to run under the other."""
    reg, _ = register_bench_camera(HW)
    model, cfg = nets["conv7"]["port"], TrackerConfig(**KNOBS)
    args = (model, bank_from_registry(reg, device="cpu"), default_params(device="cpu"), cfg)
    calls = {
        "make_full_step": lambda: make_full_step(*args, stem="s2d"),
        "make_clip_step": lambda: make_clip_step(*args, stem="s2d"),
        "SingleCameraTracker": lambda: SingleCameraTracker(reg, "p1c1", cfg=cfg, det_model=model,
                                                           stem="s2d", device="cpu"),
    }
    with pytest.raises(ValueError, match="stem"):
        calls[entry]()
