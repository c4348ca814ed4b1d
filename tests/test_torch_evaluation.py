"""The evaluation modules of the PyTorch port (numpy copies) against the JAX
package's on the same inputs and files: ``geometry_np``, ``csv_io``,
``datareader``, ``ap``, ``coco_eval``, ``mot`` and the two helpers they need
(``class_heights_for``, ``matches_from_assignment``). Integer counts must be
equal, floats within 1e-9 relative. Then the multi-camera tracker's CSV on
the oracle multi-camera scenario: keys and classes equal and states within
rtol/atol 1e-4 end to end, and byte-equal when written from the same rows.
"""

import re

import numpy as np
import pytest
import torch

from playground3d_tpu.evaluation import ap as JA
from playground3d_tpu.evaluation import coco_eval as JC
from playground3d_tpu.evaluation import csv_io as JIO
from playground3d_tpu.evaluation import datareader as JD
from playground3d_tpu.evaluation import geometry_np as JG
from playground3d_tpu.evaluation import mot as JM
from playground3d_tpu.ops.assignment import matches_from_assignment as jax_matches
from playground3d_tpu.utils.constants import class_heights_for as jax_heights
from playground3d_tpu_torch.evaluation import ap as PA
from playground3d_tpu_torch.evaluation import coco_eval as PC
from playground3d_tpu_torch.evaluation import csv_io as PIO
from playground3d_tpu_torch.evaluation import datareader as PD
from playground3d_tpu_torch.evaluation import geometry_np as PG
from playground3d_tpu_torch.evaluation import mot as PM
from playground3d_tpu_torch.ops.assignment import matches_from_assignment
from playground3d_tpu_torch.utils.constants import class_heights_for

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

RTOL = 1e-9


def _same(got, want, what=""):
    """Equal structure; ints and strings equal, floats within RTOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray) and want.dtype.kind in "fc":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)
    elif isinstance(want, (float, np.floating)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)
        assert type(got) is type(want) or isinstance(want, np.ndarray), what


@pytest.fixture(scope="module")
def geom():
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain

    reg, ranges, _, _ = toy_camera_chain(1)
    return reg.H[0, 0], reg.P[0, 0], reg.P[0, 1]


def _states(rng, n):
    return np.stack([
        rng.uniform(400, 620, n), rng.uniform(10, 110, n), rng.uniform(12, 60, n),
        rng.uniform(5, 9, n), rng.uniform(3, 13, n), np.sign(rng.normal(size=n) + 0.1),
        rng.uniform(-40, 40, n),
    ], 1)


GEOMETRY = {
    "state_to_space": lambda M, s, g, rng: M.state_to_space(s),
    "space_to_state": lambda M, s, g, rng: M.space_to_state(M.state_to_space(s)),
    "space_to_im": lambda M, s, g, rng: M.space_to_im(M.state_to_space(s), g[1]),
    "im_to_space": lambda M, s, g, rng: M.im_to_space(M.state_to_im(s, g[1]), g[0], s[:, 4]),
    "im_to_state": lambda M, s, g, rng: M.im_to_state(M.state_to_im(s, g[1]), g[0], s[:, 4]),
    "state_to_im_banked": lambda M, s, g, rng: M.state_to_im_banked(s, g[1], g[2]),
    "state_to_im_banked_empty": lambda M, s, g, rng: M.state_to_im_banked(s[:0], g[1], g[2]),
    "height_from_template": lambda M, s, g, rng: M.height_from_template(
        M.state_to_im(s, g[1]), s[:, 4], M.state_to_im(s[::-1], g[1])),
    "footprint_xyxy": lambda M, s, g, rng: M.footprint_xyxy(M.state_to_space(s)),
    "iou_xyxy": lambda M, s, g, rng: M.iou_xyxy(
        M.footprint_xyxy(M.state_to_space(s)), M.footprint_xyxy(M.state_to_space(s[::-1] + 3.0))),
}


@pytest.mark.parametrize("fn", sorted(GEOMETRY))
def test_geometry_np_matches_jax(geom, fn):
    s = _states(np.random.default_rng(40), 9)
    got = GEOMETRY[fn](PG, s, geom, None)
    want = GEOMETRY[fn](JG, s, geom, None)
    assert got.shape == want.shape
    _same(got, want, fn)


def _records(IO, G, geom, seed=41, n_frames=12, n_objs=5, noise=0.0, id_offset=0, frame_none=False,
             ts_bias=None):
    """Constant-velocity tracks as CSV records (``tests/test_evaluation.py``'s
    fixture), in either package's types."""
    rng = np.random.default_rng(seed)
    _, P, _ = geom
    base = _states(rng, n_objs)
    classes = ["sedan", "midsize", "van", "pickup", "truck"]
    out = []
    for f in range(n_frames):
        for i in range(n_objs):
            s = base[i].copy()
            s[0] += s[5] * abs(s[6]) * f / 30.0 + rng.normal(0, noise)
            space = G.state_to_space(s[None])[0]
            out.append(IO.TrackRecord(
                frame=None if frame_none else f, timestamp=1.6e9 + f / 30.0, obj_id=i + id_offset,
                class_name=classes[i % 5], state7=s, im_corners=G.space_to_im(space[None], P)[0],
                space_footprint=space[0:4, :2], camera="p1c1", ts_bias=ts_bias,
            ))
    return out


@pytest.mark.parametrize("variant", ["frames", "time_indexed", "ts_bias"])
def test_csv_io_matches_jax(tmp_path, geom, variant):
    """The writers give the same bytes; the readers parse them alike."""
    kw = dict(frame_none=variant == "time_indexed",
              ts_bias=[0.0, 0.012, -0.5] if variant == "ts_bias" else None)
    cams = ["p1c1", "p1c2", "p1c3"] if variant == "ts_bias" else None
    pp, jp = str(tmp_path / "p.csv"), str(tmp_path / "j.csv")
    PIO.write_results_csv(pp, _records(PIO, PG, geom, **kw), ts_bias_cameras=cams)
    JIO.write_results_csv(jp, _records(JIO, JG, geom, **kw), ts_bias_cameras=cams)
    assert open(pp).read() == open(jp).read()
    assert PIO.DATA_HEADER == JIO.DATA_HEADER
    _same(PIO.load_i24_csv(pp), JIO.load_i24_csv(jp), "load_i24_csv")
    _same(PIO.load_i24_csv_by_time(pp), JIO.load_i24_csv_by_time(jp), "by_time")
    _, rows = PIO.load_i24_csv(pp)
    for frame_rows in rows.values():
        for r in frame_rows:
            _same(PIO.parse_state_row(r), JIO.parse_state_row(r), "parse_state_row")
            _same(PIO.parse_state_row(r[:44]), JIO.parse_state_row(r[:44]), "parse_state_row 44")


def test_datareader_matches_jax(tmp_path, geom):
    path = str(tmp_path / "t.csv")
    recs = _records(PIO, PG, geom, frame_none=True, noise=0.3)
    recs = [r for k, r in enumerate(recs) if k % 7]  # ragged tracks
    PIO.write_results_csv(path, recs)
    pt, jt = PD.TimeIndexedTracks.from_csv(path), JD.TimeIndexedTracks.from_csv(path)
    _same((pt.times, pt.states, pt.classes), (jt.times, jt.states, jt.classes), "tracks")
    assert pt.ids() == jt.ids() and pt.span() == jt.span()
    for tq in (1.6e9 + 0.05, 1.6e9 + 0.2, 1.6e9 + 0.61):
        _same(PD.states_at(pt, tq), JD.states_at(jt, tq), f"states_at {tq}")
    pr, jr = PD.reinterpolate(pt, hz=45.0), JD.reinterpolate(jt, hz=45.0)
    _same((pr.times, pr.states, pr.classes), (jr.times, jr.states, jr.classes), "reinterpolate")
    _same(PD.rollforward(pt.states[0], 0.3), JD.rollforward(jt.states[0], 0.3), "rollforward")
    ts = [1.0, 1.1, 1.1, 1.05, 1.3, 1.31]
    assert PD.test_integrity(ts) == JD.test_integrity(ts)


def _det_sets(seed, n_frames=6, n_classes=3):
    rng = np.random.default_rng(seed)
    gt, det = [], []
    for f in range(n_frames):
        for _ in range(rng.integers(0, 6)):
            c = int(rng.integers(0, n_classes))
            xy = rng.uniform(0, 200, 2)
            box = np.concatenate([xy, xy + rng.uniform(10, 60, 2)])
            gt.append((f, c, box))
            if rng.uniform() < 0.8:  # found, a little off
                det.append((f, c, float(rng.uniform(0.3, 1.0)), box + rng.normal(0, 4, 4)))
        for _ in range(rng.integers(0, 3)):  # false positives
            xy = rng.uniform(0, 200, 2)
            det.append((f, int(rng.integers(0, n_classes)), float(rng.uniform(0, 0.8)),
                        np.concatenate([xy, xy + 30])))
    return det, gt


@pytest.mark.parametrize("seed", [42, 43])
def test_ap_matches_jax(seed):
    det, gt = _det_sets(seed)
    for thr in (0.3, 0.5, 0.75):
        p = PA.evaluate_detections(det, gt, num_classes=4, iou_threshold=thr)
        j = JA.evaluate_detections(det, gt, num_classes=4, iou_threshold=thr)
        _same(p, j, f"aps {thr}")
        _same(PA.mean_ap(p), JA.mean_ap(j), "mean_ap")
    r = np.sort(np.random.default_rng(seed).uniform(size=20))
    pr = np.random.default_rng(seed + 1).uniform(size=20)
    _same(PA.compute_ap(r, pr), JA.compute_ap(r, pr), "compute_ap")


@pytest.mark.parametrize("seed", [44, 45])
def test_coco_map_matches_jax(seed):
    det, gt = _det_sets(seed)
    _same(PC.coco_map(det, gt, num_classes=4), JC.coco_map(det, gt, num_classes=4), "coco_map")
    _same(PC.coco_map(det, gt, num_classes=4, max_dets=2), JC.coco_map(det, gt, num_classes=4, max_dets=2),
          "coco_map max_dets")
    _same(PC.coco_map([], gt, num_classes=2), JC.coco_map([], gt, num_classes=2), "coco_map empty")


@pytest.mark.parametrize("case", ["perfect", "noisy", "pred_from_image", "camera_and_gaps"])
def test_mot_evaluator_matches_jax(tmp_path, geom, case, capsys):
    H, P, _ = geom
    gt = _records(PIO, PG, geom, n_frames=20)
    pred = _records(PIO, PG, geom, n_frames=20, id_offset=100, noise=0.0 if case == "perfect" else 1.5)
    if case == "camera_and_gaps":  # frames missing on either side, rows of another camera
        gt = [r for r in gt if r.frame % 5 != 3]
        pred = [r for r in pred if r.frame % 4 != 1]
        for r in pred[::6]:
            r.camera = "p1c2"
    gp, pp = str(tmp_path / "gt.csv"), str(tmp_path / "pred.csv")
    PIO.write_results_csv(gp, gt)
    PIO.write_results_csv(pp, pred)
    kw = dict(match_iou=0.3, cutoff_frame=22, pred_from_image=case == "pred_from_image",
              camera="p1c1" if case == "camera_and_gaps" else None)
    pe, je = PM.MOTEvaluator(gp, pp, H, P, **kw), JM.MOTEvaluator(gp, pp, H, P, **kw)
    pm, jm = pe.evaluate(), je.evaluate()
    _same(pm, jm, "metrics")
    np.testing.assert_array_equal(pe.confusion, je.confusion)
    assert pm["TP"] > 0
    pe.print_metrics()
    p_out = capsys.readouterr().out
    je.print_metrics()
    assert p_out == capsys.readouterr().out


def test_class_heights_and_matches_match_jax():
    labels = ["sedan", "truck", "other", "semi", "unknown", 0, 3, 7, np.int32(4)]
    np.testing.assert_array_equal(class_heights_for(labels), jax_heights(labels))
    rng = np.random.default_rng(47)
    benefit = rng.uniform(size=(6, 5))
    col = np.array([2, -1, 0, 4, 1, -1], np.int32)
    for thr in (0.0, 0.4, 0.9):
        np.testing.assert_array_equal(matches_from_assignment(col, benefit, thr), jax_matches(col, benefit, thr))


# ---------------------------------------------------------------------------
# the multi-camera tracker's CSV
# ---------------------------------------------------------------------------


def _mc_oracle_run(pkg, n_frames=20):
    """``apps/track.py --mode multi --oracle``'s scenario, in-process."""
    if pkg == "jax":
        from playground3d_tpu.data.synthetic import SyntheticScene, mc_oracle_detections
        from playground3d_tpu.data.toy_cameras import toy_camera_chain
        from playground3d_tpu.pipeline.multi_cam import MultiCameraTracker
        from playground3d_tpu.utils.config import TrackerConfig
        dev = {}
    else:
        from playground3d_tpu_torch.data.synthetic import SyntheticScene, mc_oracle_detections
        from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
        from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
        from playground3d_tpu_torch.utils.config import TrackerConfig
        dev = {"device": "cpu"}
    reg, ranges, centers, _ = toy_camera_chain(3)
    cameras = list(ranges)
    lo = min(r[0] for r in ranges.values()) - 20
    hi = max(r[1] for r in ranges.values()) + 20
    scene = SyntheticScene(n_objects=10, seed=3, x_spawn=(lo + 30, hi - 30), x_visible=(lo, hi))
    cfg = TrackerConfig(max_tracks=64, max_dets=64, x_range=(lo - 50, hi + 50), f_init=2)
    rng = np.random.default_rng(0)
    holder = {"f": 0}

    def detect_fn(frames, frame_num):
        return mc_oracle_detections(scene, [holder["f"] / 30.0] * 3, reg, cameras, ranges,
                                    cfg.max_dets, rng, **dev)

    trk = MultiCameraTracker(reg, cameras, cfg=cfg, detect_fn=detect_fn, centers=centers, **dev)
    for f in range(n_frames):
        holder["f"] = f
        trk.process(np.zeros((3, 8, 8, 3), np.float32), [1.6e9 + f / 30.0] * 3, f)
    return trk


def _biases(rows):
    """The clock-bias column (a printed list of three numbers) as floats."""
    out = [[float(v) for v in re.findall(r"-?\d+\.?\d*(?:e-?\d+)?", r[45].replace("float32", ""))] for r in rows]
    assert all(len(b) == 3 for b in out)
    return np.array(out)


@pytest.fixture(scope="module")
def mc_runs():
    return _mc_oracle_run("jax"), _mc_oracle_run("port")


@pytest.mark.parametrize("camera", [None, "p1c2"])
def test_multicam_csv_matches_jax(tmp_path, mc_runs, camera):
    jt, pt = mc_runs
    jp, pp, sp = (str(tmp_path / n) for n in ("j.csv", "p.csv", "same_rows.csv"))
    jt.write_results_csv(jp, camera=camera)
    pt.write_results_csv(pp, camera=camera)
    _, jrows = PIO.load_i24_csv(jp)
    _, prows = PIO.load_i24_csv(pp)
    assert set(jrows) == set(prows) and sum(map(len, prows.values())) > 100
    for f in jrows:
        assert [r[:4] for r in prows[f]] == [r[:4] for r in jrows[f]]
        assert [r[36] for r in prows[f]] == [r[36] for r in jrows[f]] == [camera or "p1c1"] * len(jrows[f])
        np.testing.assert_allclose(np.stack([PIO.parse_state_row(r) for r in prows[f]]),
                                   np.stack([JIO.parse_state_row(r) for r in jrows[f]]), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_biases(prows[f]), _biases(jrows[f]), atol=1e-4)
    # from the same rows the port's writer gives JAX's bytes
    pt.rows, pt.ts_bias_log = jt.rows, jt.ts_bias_log
    pt.write_results_csv(sp, camera=camera)
    assert open(sp, "rb").read() == open(jp, "rb").read()
