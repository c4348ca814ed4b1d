"""Kalman-filter fitting and the host-side datasets of the PyTorch port
against the JAX package's: ``train/fit_kf.py``, ``params_from_arrays``,
``BatchedKF`` (on the scenarios of ``tests/test_kf.py``), the filtering,
CSV and COCO datasets on files the tests write, and ``apps/fit_filter.py``.

Tolerances: the fitting, the datasets and the app are numpy copies, so
their arrays are equal; ``BatchedKF`` runs float32 filter math in each
framework (other summation order in the matmuls), within 1e-4 relative
and absolute, as the tracker's own KF tests allow.
"""

import json

import numpy as np
import pytest
import torch

from playground3d_tpu.track import kf as JK
from playground3d_tpu.train import fit_kf as JF
from playground3d_tpu_torch.track import kf as PK
from playground3d_tpu_torch.train import fit_kf as PF

torch.set_num_threads(1)


def _tracklets(seed=0, n=12):
    from playground3d_tpu_torch.data.synthetic import SyntheticScene

    rng = np.random.default_rng(seed)
    out, cls = [], []
    for k in range(n):
        scene = SyntheticScene(n_objects=1, seed=k)
        rows = [scene.states_at(f / 30.0)[0][0] + np.concatenate([rng.normal(0, 0.05, 5), [0, 0]])
                for f in range(20) if len(scene.states_at(f / 30.0)[0])]
        if len(rows) >= 9:
            out.append(np.stack(rows))
            cls.append(scene.classes[0])
    gts = np.concatenate([t[:, :5] for t in out])
    dets = gts + rng.normal(0, 0.5, gts.shape)
    sizes = np.stack([t[0, 2:5] for t in out])
    return out, dets, gts, np.asarray(cls), sizes


@pytest.mark.parametrize("stage", ["process", "measurement", "class_sizes", "velocity", "initial", "all"])
def test_fit_kf_equals_jax(stage):
    tr, dets, gts, cls, sizes = _tracklets()
    calls = {
        "process": lambda m: m.fit_process_noise(tr),
        "measurement": lambda m: m.fit_measurement_noise(dets, gts),
        "class_sizes": lambda m: m.fit_class_sizes(cls, sizes),
        "velocity": lambda m: m.fit_velocity_prior(tr),
        "initial": lambda m: m.fit_initial_covariance(dets, gts, 3.0),
        "all": lambda m: m.fit_all(tr, dets, gts, class_ids=cls, sizes=sizes),
    }[stage]
    want, got = calls(JF), calls(PF)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_kf_params_save_load_and_params_from_arrays_equal_jax(tmp_path):
    tr, dets, gts, cls, sizes = _tracklets(1)
    fitted = PF.fit_all(tr, dets, gts, class_ids=cls, sizes=sizes)
    path = str(tmp_path / "kf.npz")
    PF.save_kf_params(path, fitted)
    loaded = JF.load_kf_params(path)
    want = JK.params_from_arrays(loaded)
    got = PK.params_from_arrays(PF.load_kf_params(path), device="cpu")
    assert got._fields == want._fields
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert got.Q.dtype == torch.float32 and not np.array_equal(got.Q.numpy(), PK.default_params(device="cpu").Q.numpy())


def _scenario(name, m, rng):
    """The operations of one ``tests/test_kf.py`` scenario through the
    BatchedKF of module ``m``; -> what the scenario reads back."""
    dp = m.default_params() if m is JK else m.default_params(device="cpu")
    make = (lambda **kw: m.BatchedKF(**kw)) if m is JK else (lambda **kw: m.BatchedKF(device="cpu", **kw))
    out = {}
    if name == "scalar_filter":
        kf = make(params=dp, capacity=16)
        det0 = rng.uniform(0, 50, (4, 5)).astype(np.float32)
        kf.add(det0, list(range(4)), np.array([1, -1, 1, -1], np.float32), np.zeros(4))
        for step in range(5):
            kf.predict(JK.DT_DEFAULT * (1 + step * 0.1))
            kf.update(rng.uniform(0, 50, (4, 5)).astype(np.float32), list(range(4)))
            out[f"view{step}"] = kf.view()[1]
    elif name == "direction_velocity":
        kf = make(params=dp, capacity=8)
        det = np.array([[100.0, 50, 20, 6, 5], [100.0, 50, 20, 6, 5]], np.float32)
        kf.add(det, [0, 1], np.array([1.0, -1.0]), np.zeros(2), init_speed=True)
        kf.predict(1.0)
        out["view"] = kf.view()[1]
    elif name == "lifecycle":
        kf = make(capacity=8)
        det = rng.uniform(0, 50, (3, 5)).astype(np.float32)
        kf.add(det, [10, 11, 12], np.ones(3), np.zeros(3))
        kf.remove([11])
        kf.add(det[:1], [13], np.ones(1), np.zeros(1))
        ids, states = kf.view()
        out["ids"], out["view"] = np.array(ids), states
    elif name == "view_direction":
        kf = make(capacity=8)
        kf.add(rng.uniform(0, 50, (2, 5)).astype(np.float32), [0, 1], np.array([1.0, -1.0]), np.zeros(2))
        out["view"] = kf.view(with_direction=True)[1]
        out["view_dt"] = kf.view(dt=0.5, with_direction=True)[1]
    elif name == "class_size":
        kf = make(params=dp, capacity=8)
        kf.add(np.array([[100.0, 50, 99, 99, 99]], np.float32), [0], np.ones(1), np.zeros(1), classes=[4])
        out["view"] = kf.view()[1]
    elif name == "size_nudge":
        kf = make(params=dp, capacity=8)
        kf.add(np.array([[100.0, 50, 20, 6, 5]], np.float32), [0], np.ones(1), np.zeros(1))
        kf.update(np.array([[30.0, 8.0, 7.0]], np.float32), [0], measurement_idx=3)
        kf.update(np.array([[101.0, 51, 21, 6.5, 5.5]], np.float32), [0], measurement_idx=2)
        out["view"] = kf.view()[1]
    elif name == "per_object_dt":
        kf = make(capacity=8)
        kf.add(rng.uniform(0, 50, (2, 5)).astype(np.float32), [0, 1], np.ones(2), np.array([0.0, 0.5]))
        out["dt"] = kf.get_dt(1.0)
        out["dt_sub"] = kf.get_dt([2.0], idxs=[1])
        kf.predict(kf.get_dt(1.0))
        out["view"], out["T"] = kf.view()[1], kf.T.copy()
    elif name == "dead_slots":
        kf = make(capacity=8)
        kf.add(rng.uniform(0, 50, (1, 5)).astype(np.float32), [0], np.ones(1), np.zeros(1))
        kf.predict(1.0)
        out["x"] = np.asarray(kf.slots.x)
        out["P"] = np.asarray(kf.slots.P)
    return out


@pytest.mark.parametrize("name", ["scalar_filter", "direction_velocity", "lifecycle", "view_direction",
                                  "class_size", "size_nudge", "per_object_dt", "dead_slots"])
def test_batched_kf_matches_jax(name):
    want = _scenario(name, JK, np.random.default_rng(0))
    got = _scenario(name, PK, np.random.default_rng(0))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=1e-4, atol=1e-4, err_msg=k)


def _tracks_csv(path, n_frames=24):
    from playground3d_tpu_torch.data.synthetic import SyntheticScene
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
    from playground3d_tpu_torch.evaluation import geometry_np as G
    from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
    from playground3d_tpu_torch.utils.constants import CLASS_NAMES

    P = toy_camera_chain(1)[0].P[0, 0]
    scene = SyntheticScene(n_objects=3, seed=1)
    recs = []
    for f in range(n_frames):
        states, idx = scene.states_at(f / 30.0)
        space = G.state_to_space(states)
        im = G.space_to_im(space, P)
        for i in range(len(states)):
            recs.append(TrackRecord(
                frame=f, timestamp=1.6e9 + f / 30.0, obj_id=int(idx[i]),
                class_name=CLASS_NAMES[int(scene.classes[idx[i]])], state7=states[i], im_corners=im[i],
                space_footprint=space[i, 0:4, :2], camera="p1c1",
            ))
    write_results_csv(path, recs)
    return path


def test_filtering_dataset_matches_jax(tmp_path):
    from playground3d_tpu.data.fit_filter_dataset import FilteringDataset as JFD
    from playground3d_tpu_torch.data.fit_filter_dataset import FilteringDataset as PFD

    path = _tracks_csv(str(tmp_path / "tracks.csv"))

    def lookup(camera, frame_num):
        return np.full((4, 6, 3), frame_num / 30.0, np.float32)

    j, p = JFD(path, min_length=6, frame_lookup=lookup), PFD(path, min_length=6, frame_lookup=lookup)
    assert len(p) == len(j) >= 1
    for wj, wp in zip(j.windows(with_images=True), p.windows(with_images=True)):
        assert sorted(wp) == sorted(wj) and wp["camera"] == wj["camera"] and wp["obj_id"] == wj["obj_id"]
        for k in ("frames", "times", "states", "images"):
            np.testing.assert_array_equal(wp[k], wj[k])
    assert PFD(path, camera="p9c9").tracklets == []


def test_csv_detection_dataset_matches_jax(tmp_path):
    from playground3d_tpu.data.csv_dataset import CSVDetectionDataset as JC
    from playground3d_tpu_torch.data.csv_dataset import CSVDetectionDataset as PC
    from playground3d_tpu_torch.data.video import write_png

    for i in range(3):
        write_png(str(tmp_path / f"im{i}.png"),
                  np.random.default_rng(i).integers(0, 255, (96, 128, 3), dtype=np.uint8))
    np.save(tmp_path / "im3.npy", np.random.default_rng(3).uniform(0, 1, (70, 100, 3)).astype(np.float32))
    ann, cls = str(tmp_path / "ann.csv"), str(tmp_path / "classes.csv")
    with open(ann, "w") as f:
        f.write("im0.png,10,10,50,40,car\nim0.png,60,20,90,60,truck\nim1.png,5,5,30,30,car\nim2.png,,,,,\n"
                "im3.npy,3,4,40,50,truck\n")
    with open(cls, "w") as f:
        f.write("car,0\ntruck,1\n")
    kw = dict(root=str(tmp_path), min_side=64, max_side=128, seed=1)
    j, p = JC(ann, cls, **kw), PC(ann, cls, **kw)
    assert len(p) == len(j) == 4 and p.num_classes == j.num_classes == 2
    for i in range(4):
        (ij, aj), (ip, ap) = j.sample(i), p.sample(i)
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(ap, aj)
    gj, gp = j.batches(2), p.batches(2)
    for _ in range(3):
        (ij, aj), (ip, ap) = next(gj), next(gp)
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(ap, aj)
    with open(ann, "a") as f:
        f.write("im1.png,30,30,20,40,car\n")
    with pytest.raises(ValueError, match="degenerate"):
        PC(ann, cls, **kw)


def test_coco_dataset_matches_jax(tmp_path):
    from PIL import Image

    from playground3d_tpu.data.coco import CocoDataset as JCO
    from playground3d_tpu_torch.data.coco import CocoDataset as PCO

    rng = np.random.default_rng(0)
    for name in ("a.png", "b.png"):
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(tmp_path / name)
    coco = {
        "images": [{"id": 7, "file_name": "a.png"}, {"id": 9, "file_name": "b.png"}],
        "categories": [{"id": 11, "name": "truck"}, {"id": 3, "name": "car"}],
        "annotations": [
            {"id": 1, "image_id": 7, "category_id": 3, "bbox": [20, 10, 30, 20], "iscrowd": 0},
            {"id": 2, "image_id": 7, "category_id": 11, "bbox": [5, 5, 10, 12], "iscrowd": 0},
            {"id": 3, "image_id": 9, "category_id": 3, "bbox": [40, 20, 20, 18], "iscrowd": 0},
            {"id": 4, "image_id": 9, "category_id": 3, "bbox": [1, 1, 0.5, 8], "iscrowd": 0},
            {"id": 5, "image_id": 9, "category_id": 3, "bbox": [2, 2, 9, 9], "iscrowd": 1},
        ],
    }
    with open(tmp_path / "ann.json", "w") as f:
        json.dump(coco, f)
    j, p = JCO(str(tmp_path), "ann.json"), PCO(str(tmp_path), "ann.json")
    assert len(p) == 2 and p.num_classes == 2 and p.label_to_name == j.label_to_name == ["car", "truck"]
    for (ij, aj), (ip, ap) in zip(j.iter_samples(), p.iter_samples()):
        np.testing.assert_array_equal(ip, ij)
        np.testing.assert_array_equal(ap, aj)
    assert p.annotations(1).shape == (1, 5)


@pytest.mark.parametrize("source", ["synthetic", "csv"])
def test_fit_filter_app_equals_jax_and_drives_a_tracker(tmp_path, source):
    from playground3d_tpu.apps import fit_filter as jax_app
    from playground3d_tpu_torch.apps import fit_filter as port_app
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker

    extra = ["--n-tracklets", "12"] if source == "synthetic" else ["--csv", _tracks_csv(str(tmp_path / "t.csv"))]
    jax_app.main(["--out", str(tmp_path / "j.npz")] + extra)
    fitted = port_app.main(["--out", str(tmp_path / "p.npz")] + extra)
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "p.npz") as zp:
        assert sorted(zp.files) == sorted(zj.files)
        for k in zj.files:
            np.testing.assert_array_equal(zp[k], zj[k])
    params = PK.params_from_arrays(PF.load_kf_params(str(tmp_path / "p.npz")), device="cpu")
    np.testing.assert_array_equal(params.R.numpy(), fitted["R"].astype(np.float32))
    # the fitted filter drives a tracker over oracle detections
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, oracle_detections
    from playground3d_tpu_torch.utils.config import TrackerConfig

    reg = toy_camera_chain(1)[0]
    scene, rng, t = SyntheticScene(n_objects=4, seed=1), np.random.default_rng(0), [0.0]
    det = lambda frames: oracle_detections(scene, t[0], reg.P[0, 0], 8, rng=rng, device="cpu")
    trk = SingleCameraTracker(reg, "p1c1", cfg=TrackerConfig(max_tracks=8, max_dets=8), kf_params=params,
                              detect_fn=det, device="cpu")
    assert trk.kfp is params
    for f in range(4):
        t[0] = f / 30.0
        trk.process_frame(np.zeros((4, 4, 3), np.float32), 1.6e9 + t[0], f)
    assert sum(len(r[2]) for r in trk.rows) > 0 and all(np.isfinite(np.asarray(r[3])).all() for r in trk.rows)
