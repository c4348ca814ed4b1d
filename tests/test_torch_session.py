"""Session mode of the PyTorch port against the JAX package, on the CPU:
session discovery (``data/session.py``), ignore regions (``data/regions.py``,
``bank_from_registry``'s grid, detections dropped at parse time), the
registry's npz format, ``tools/ref_interop.py`` on pickles the tests write,
``data/frame_cache.py``'s shards, ``MultiCameraTracker(on_frame=)``, and
``apps/track.py --mode session`` end to end.

Tolerances: every numpy port (session, regions, registry, ref_interop,
frame cache) equals the JAX function exactly. The session app's CSV against
the JAX app's (``--emit yuv420`` at the stored size, the same ``.npz``
checkpoints for both packages): the same (frame, id) keys and classes,
positions and sizes within 1e-3 ft and speeds within 1e-4 relative (the
port's float32 order differs from XLA's by ulps, and a birth's speed comes
out of a few more operations than its position). The detectors are random ResNet-18s with zero
output convs, so every box is its bias: the class bias raised by 3 and the
regression bias aimed at a car on camera 0's road, as in
``tests/test_torch_apps_track.py``.

The JAX package's ``data.video`` builds ``native/`` when it is imported, so
its app is imported inside the test that runs it.
"""

import os
import pickle

import numpy as np
import pytest
import torch

from playground3d_tpu_torch.apps import track as port_app
from playground3d_tpu_torch.data import regions as R
from playground3d_tpu_torch.data import session as S
from playground3d_tpu_torch.data.synthetic import SyntheticScene, aimed_regression_bias
from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
from playground3d_tpu_torch.data.video import SyntheticVideoSource, write_y4m
from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row
from playground3d_tpu_torch.geometry.homography import CameraRegistry
from playground3d_tpu_torch.models.nn import save_params
from playground3d_tpu_torch.models.retinanet import retinanet_init
from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry, ignore_hits
from test_torch_jax_native import jax_video

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jax_host_libraries():
    """The JAX package's host libraries whole and ``data.video``'s decoder
    probed with them (``test_torch_jax_native``): JAX's session reader follows
    them, and test processes that build them at once leave its loaders on
    their fallback paths."""
    jax_video()


T0 = 1.6e9


def _session_dir(root, n_cams=2, n_segs=3, ext="mp4"):
    """The ingest layout of ``tests/test_data.py``'s session tests: a config,
    an info file, empty segment files and manager logs."""
    root.mkdir()
    (root / "_SESSION_CONFIG.config").write_text(
        "# ingest session\n"
        "__CAMERA__\nname == p1c1\nrtsp == rtsp://10.0.0.1/stream\n"
        "__CAMERA__\nname == p1c2\nrtsp == rtsp://10.0.0.2/stream\n"
        "__IMAGE-SNAPSHOT__\ninterval == 60\n"
        "__PERSISTENT-RECORDING__\n"
        f"recording_filename == ./recording/record_{{cam_name}}_{{session_num}}_%05d.{ext}\n"
        "segment_duration == 15\n"
    )
    (root / "_SESSION_INFO.txt").write_text(
        "SESSION #4\n"
        "Session initialization time (local): 2021-06-16 15:58:08.770000\n"
        "Recording segment duration: 15.0\n"
    )
    rec = root / "recording"
    rec.mkdir()
    for cam in ["p1c1", "p1c2"][:n_cams]:
        for seg in range(n_segs):
            (rec / f"record_{cam}_4_{seg:05d}.{ext}").write_bytes(b"x")
        (rec / f"other_{cam}.txt").write_text("not a segment")
    logs = root / "logs"
    logs.mkdir()
    (logs / "manager-2021-06-16.log").write_text("ok")
    (logs / "other.txt").write_text("no")
    return str(root)


def test_parse_config_and_session_info_equal_jax(tmp_path):
    from playground3d_tpu.data import session as JS

    root = _session_dir(tmp_path / "s")
    cfg = root + "/_SESSION_CONFIG.config"
    got = S.parse_config_file(cfg)
    assert got == JS.parse_config_file(cfg)
    cams, img, vid, rec = got
    assert [c["name"] for c in cams] == ["p1c1", "p1c2"] and img == {"interval": "60"} and vid == []
    assert rec["segment_duration"] == "15"
    info = root + "/_SESSION_INFO.txt"
    for fn in ("get_session_number", "get_session_recording_segment_time", "get_session_start_time_local"):
        assert getattr(S, fn)(info) == getattr(JS, fn)(info), fn
    assert S.get_session_start_time_local(info).microsecond == 770000
    assert S.get_manager_log_files(root) == JS.get_manager_log_files(root) == ["manager-2021-06-16.log"]


@pytest.mark.parametrize("text", [
    "__CAMERA__\nnot a key value\n",
    "__PERSISTENT-RECORDING__\na == 1\n__PERSISTENT-RECORDING__\nb == 2\n",
    "a == 1\n",
    "__NOT-A-BLOCK__\n",
])
def test_parse_config_rejects_garbage_as_jax_does(tmp_path, text):
    from playground3d_tpu.data import session as JS

    p = tmp_path / "bad.config"
    p.write_text(text)
    for mod in (S, JS):
        with pytest.raises(AttributeError):
            mod.parse_config_file(str(p))


@pytest.mark.parametrize("kwargs", [
    {}, {"drop_last_file": True}, {"first_file_index": 2}, {"filter_filenames": ["p1c2"]},
])
def test_recording_params_and_find_files_equal_jax(tmp_path, kwargs):
    from playground3d_tpu.data import session as JS

    root = _session_dir(tmp_path / "s")
    params = S.get_recording_params(root)
    assert params == JS.get_recording_params(root)
    rec_dirs, names, cams = params
    assert cams == ["p1c1", "p1c2"] and names[0] == "record_p1c1_4_%05d.mp4"
    got = S.find_files(rec_dirs, names, cams, **kwargs)
    assert got == JS.find_files(rec_dirs, names, cams, **kwargs)
    assert len(got) == {(): 6, ("drop_last_file",): 4, ("first_file_index",): 2,
                        ("filter_filenames",): 3}[tuple(kwargs)]


def _polygons(rng):
    return {
        "p1c1": np.array([[100, 100], [300, 100], [300, 300], [100, 300]], float),
        "p1c2": rng.uniform(0, 400, (7, 2)),  # self-intersecting: crossing-number parity
    }


def test_ignore_region_files_and_masks_equal_jax(tmp_path):
    from playground3d_tpu.data import regions as JR

    polys = _polygons(np.random.default_rng(0))
    for cam, poly in polys.items():
        (tmp_path / f"{cam}_ignored.csv").write_text("".join(f"{x},{y}\n" for x, y in poly) + "\n")
    (tmp_path / "p1c3_ignored.csv").write_text("1,2\n3,4\n")  # under 3 vertices: ignored
    (tmp_path / "readme.txt").write_text("x")
    got = R.load_ignore_regions(str(tmp_path))
    want = JR.load_ignore_regions(str(tmp_path))
    assert sorted(got) == sorted(want) == ["p1c1", "p1c2"]
    for cam in got:
        np.testing.assert_array_equal(got[cam], want[cam])
        np.testing.assert_allclose(got[cam], polys[cam])
    assert sorted(R.load_ignore_regions(str(tmp_path), ["p1c2"])) == ["p1c2"]
    assert R.load_ignore_regions(str(tmp_path / "missing")) == {}

    pts = np.random.default_rng(1).uniform(-20, 420, (500, 2))
    frame = np.ones((48, 64, 3), np.float32)
    for poly in polys.values():
        np.testing.assert_array_equal(R.points_in_polygon(pts, poly), JR.points_in_polygon(pts, poly))
        small = poly / 8.0
        np.testing.assert_array_equal(R.polygon_mask(small, 48, 64), JR.polygon_mask(small, 48, 64))
        np.testing.assert_array_equal(R.blackout(frame, small), JR.blackout(frame, small))
    assert np.all(frame == 1)


@pytest.mark.parametrize("cell", [8, 16])
def test_ignore_grid_and_bank_equal_jax(toy_cameras3, cell):
    """``bank_from_registry``'s ignore grid equals JAX's, as does the cell
    lookup of box centres (``ignore_hits``)."""
    import jax.numpy as jnp

    from playground3d_tpu.data.regions import ignore_grid as jax_grid
    from playground3d_tpu.pipeline import camera_bank as JB

    reg = toy_cameras3["registry"]
    polys = _polygons(np.random.default_rng(2))
    grid = R.ignore_grid(polys, reg.names, 540, 960, cell)
    np.testing.assert_array_equal(grid, jax_grid(polys, reg.names, 540, 960, cell))
    assert grid.shape == (3, 540 // cell, 960 // cell) and grid[0].any() and not grid[2].any()

    bank = bank_from_registry(reg, ignore_polygons=polys, image_hw=(540, 960), ignore_cell=cell, device="cpu")
    jbank = JB.bank_from_registry(reg, ignore_polygons=polys, image_hw=(540, 960), ignore_cell=cell)
    np.testing.assert_array_equal(bank.ignore.numpy(), np.asarray(jbank.ignore))
    np.testing.assert_array_equal(bank.H.numpy(), np.asarray(jbank.H))
    np.testing.assert_array_equal(bank.P.numpy(), np.asarray(jbank.P))
    assert bank.ignore_cell == jbank.ignore_cell == float(cell)
    assert bank_from_registry(reg, device="cpu").ignore is None

    rng = np.random.default_rng(3)
    centers = rng.uniform(-50, 1000, (300, 2)).astype(np.float32)
    cam = rng.integers(0, 3, 300).astype(np.int32)
    got = ignore_hits(bank, torch.as_tensor(centers), torch.as_tensor(cam)).numpy()
    want = np.asarray(JB.ignore_hits(jbank, jnp.asarray(centers), jnp.asarray(cam)))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_parse_drops_detections_in_region(toy_camera):
    """As ``tests/test_data.py``'s case: of two detections, the one whose box
    centre lies in camera 0's polygon is dropped at parse time, in the port
    and in JAX alike."""
    import jax.numpy as jnp

    from playground3d_tpu.models.retinanet import Detections as JaxDetections
    from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
    from playground3d_tpu.pipeline.tracker_state import parse_detections_pre as jax_parse
    from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
    from playground3d_tpu_torch.models.retinanet import Detections
    from playground3d_tpu_torch.pipeline.tracker_state import parse_detections_pre
    from playground3d_tpu_torch.utils.config import TrackerConfig

    reg = toy_camera["registry"]

    def box20(cx, cy, s=60.0):
        corners = np.array([[cx - s, cy - s], [cx + s, cy - s], [cx - s, cy], [cx + s, cy],
                            [cx - s, cy + s], [cx + s, cy + s], [cx - s, cy + s / 2], [cx + s, cy + s / 2]])
        return np.concatenate([corners.ravel(), [cx - s, cy - s, cx + s, cy + s]]).astype(np.float32)

    K = 8
    boxes = np.zeros((K, 20), np.float32)
    boxes[0], boxes[1] = box20(200.0, 200.0), box20(1200.0, 700.0)
    scores = np.array([0.9, 0.8] + [0.0] * 6, np.float32)
    mask = np.array([True, True] + [False] * 6)
    poly = {"p1c1": np.array([[100, 100], [300, 100], [300, 300], [100, 300]], float)}
    det = Detections(torch.as_tensor(scores), torch.zeros(K, dtype=torch.int32), torch.as_tensor(boxes),
                     torch.zeros(K, dtype=torch.int32), torch.as_tensor(mask))
    jdet = JaxDetections(jnp.asarray(scores), jnp.zeros(K, jnp.int32), jnp.asarray(boxes), jnp.zeros(K, jnp.int32),
                         jnp.asarray(mask))
    times = np.zeros((1,), np.float32)
    for ignore, n_kept in ((None, 2), (poly, 1)):
        got = parse_detections_pre(det, bank_from_registry(reg, ignore_polygons=ignore, device="cpu"),
                                   torch.as_tensor(times), TrackerConfig(x_range=(300, 900)))
        want = jax_parse(jdet, jax_bank(reg, ignore_polygons=ignore), jnp.asarray(times),
                         JaxConfig(x_range=(300, 900)))
        m = got.mask.numpy()
        np.testing.assert_array_equal(m, np.asarray(want.mask))
        assert int(m.sum()) == n_kept
        np.testing.assert_allclose(got.state.numpy()[m], np.asarray(want.state)[m], rtol=1e-5, atol=1e-4)
    assert abs(float(got.scores[got.mask][0]) - 0.8) < 1e-6  # the survivor lies outside


def test_registry_npz_round_trips_between_packages(tmp_path, toy_cameras3):
    from playground3d_tpu.geometry.homography import CameraRegistry as JaxRegistry

    jreg = toy_cameras3["registry"]
    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jreg.save(jpath)
    reg = CameraRegistry.load(jpath)
    assert reg.names == jreg.names
    for k in ("H", "H_inv", "P", "vps"):
        np.testing.assert_array_equal(getattr(reg, k), getattr(jreg, k))
    reg.save(ppath)
    back = JaxRegistry.load(ppath)
    assert back.names == jreg.names
    for k in ("H", "H_inv", "P", "vps"):
        np.testing.assert_array_equal(getattr(back, k), getattr(jreg, k))
    with np.load(ppath, allow_pickle=False) as z:  # no object arrays
        assert sorted(z.files) == ["H", "H_inv", "P", "names", "vps"]


class Homography:
    """Stand-in for the reference's pickled class: the restricted unpickler
    must rebuild it as an inert shell, never run it."""

    def __setstate__(self, state):
        raise AssertionError("reference code ran while unpickling")


class Homography_Wrapper(Homography):
    pass


def _reference_pickle(path, reg, wrapped):
    """Write ``reg`` in the reference's layout (homography.py:336-380,
    :816-827): torch tensors with a leading batch dim, as the reference
    stores them."""
    def hg(bank):
        obj = Homography.__new__(Homography)
        obj.__dict__["correspondence"] = {
            name: {"H": torch.as_tensor(reg.H[c, bank])[None], "H_inv": torch.as_tensor(reg.H_inv[c, bank])[None],
                   "P": reg.P[c, bank], "vps": reg.vps[c, bank].tolist()}
            for c, name in enumerate(reg.names)
        }
        return obj

    obj = hg(0)
    if wrapped:
        obj = Homography_Wrapper.__new__(Homography_Wrapper)
        obj.__dict__.update(hg1=hg(0), hg2=hg(1))
    with open(path, "wb") as f:
        pickle.dump(obj, f)


@pytest.mark.parametrize("wrapped", [False, True])
def test_ref_interop_registry_from_pickle_equals_jax(tmp_path, toy_cameras3, wrapped):
    from playground3d_tpu.tools import ref_interop as JI
    from playground3d_tpu_torch.tools import ref_interop as PI

    reg = toy_cameras3["registry"]
    reg.P[1, 1] = reg.P[1, 1] * 1.01  # a WB bank unlike the EB one
    path = str(tmp_path / "hg.cpkl")
    try:
        _reference_pickle(path, reg, wrapped)
    finally:
        reg.P[1, 1] = reg.P[1, 1] / 1.01
    got, want = PI.registry_from_reference_pickle(path), JI.registry_from_reference_pickle(path)
    assert got.names == want.names == reg.names
    for k in ("H", "H_inv", "P", "vps"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert wrapped == (not np.array_equal(got.P[1, 0], got.P[1, 1]))


def test_ref_interop_kf_params_from_pickle_equal_jax(tmp_path):
    from playground3d_tpu.tools import ref_interop as JI
    from playground3d_tpu_torch.tools import ref_interop as PI

    rng = np.random.default_rng(5)
    init = {"F": rng.random((6, 6)), "H": torch.as_tensor(rng.random((5, 6))), "R": rng.random((5, 5)),
            "mu_R": rng.random((1, 5)), "Q": rng.random((6, 6)), "mu_Q": rng.random(6), "P": rng.random((6, 6)),
            "mu_v": np.array([[42.0]])}
    path = str(tmp_path / "kf.cpkl")
    with open(path, "wb") as f:
        pickle.dump(init, f)
    got, want = PI.kf_params_from_reference_pickle(path, device="cpu"), JI.kf_params_from_reference_pickle(path)
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == np.asarray(b).shape, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert float(got.mu_v) == 42.0


def test_ref_interop_fit_camera_from_tracking_csv_equals_jax(tmp_path, toy_camera):
    """A camera re-fit from a tracking CSV whose rows carry both image
    corners and roadway footprints (written from a toy camera's truth)."""
    from playground3d_tpu.tools import ref_interop as JI
    from playground3d_tpu_torch.evaluation import geometry_np as G
    from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
    from playground3d_tpu_torch.tools import ref_interop as PI
    from playground3d_tpu_torch.utils.constants import CLASS_NAMES

    P = toy_camera["registry"].P[0, 0]
    scene = SyntheticScene(n_objects=6, seed=4, x_spawn=(420, 560), x_visible=(380, 600))
    recs = []
    for f in range(10):
        states, idx = scene.states_at(f / 30.0)
        space = G.state_to_space(states)
        im = G.space_to_im(space, P)
        recs += [TrackRecord(frame=f, timestamp=T0 + f / 30.0, obj_id=int(idx[i]),
                             class_name=CLASS_NAMES[int(scene.classes[idx[i]])], state7=states[i], im_corners=im[i],
                             space_footprint=space[i, 0:4, :2], camera="p1c1") for i in range(len(states))]
    path = str(tmp_path / "track.csv")
    write_results_csv(path, recs)
    got = PI.fit_camera_from_tracking_csv(path, "p1c1", name="refit")
    want = JI.fit_camera_from_tracking_csv(path, "p1c1", name="refit")
    assert got.names == want.names == ["refit"]
    for k in ("H", "H_inv", "P", "vps"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def test_frame_cache_shards_equal_jax(tmp_path, toy_camera):
    from playground3d_tpu.data.frame_cache import cache_corrected_frames as jax_cache
    from playground3d_tpu.data.frame_cache import labels_by_frame_from_csv as jax_labels
    from playground3d_tpu_torch.data.frame_cache import cache_corrected_frames, labels_by_frame_from_csv
    from playground3d_tpu_torch.data.video import VideoFrameSource
    from playground3d_tpu_torch.evaluation import geometry_np as G
    from playground3d_tpu_torch.evaluation.csv_io import TrackRecord, write_results_csv
    from playground3d_tpu_torch.utils.constants import CLASS_NAMES

    P = toy_camera["registry"].P[0, 0]
    scene = SyntheticScene(n_objects=4, seed=3)
    src = SyntheticVideoSource(scene, P, n_frames=8, t0=T0, height=128, width=192, normalized=False)
    video = str(tmp_path / "p1c1.y4m")
    write_y4m(video, [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f, _ in src])
    recs = []
    for f in range(8):
        states, idx = scene.states_at(f / 30.0)
        space = G.state_to_space(states)
        im = G.space_to_im(space, P)
        recs += [TrackRecord(frame=f, timestamp=T0 + f / 30.0, obj_id=int(idx[i]),
                             class_name=CLASS_NAMES[int(scene.classes[idx[i]])], state7=states[i], im_corners=im[i],
                             space_footprint=space[i, 0:4, :2], camera="p1c1") for i in range(len(states))]
    labels_csv = str(tmp_path / "labels.csv")
    write_results_csv(labels_csv, recs)
    got_l, want_l = labels_by_frame_from_csv(labels_csv, "p1c1"), jax_labels(labels_csv, "p1c1")
    assert sorted(got_l) == sorted(want_l) and len(got_l) >= 4
    for k in got_l:
        np.testing.assert_array_equal(got_l[k], want_l[k])

    kw = dict(label_csvs={"p1c1": labels_csv}, last_corrected_frame={"p1c1": 6}, skip_frames=1,
              ignore_polygons={"p1c1": np.array([[0, 0], [60, 0], [60, 40], [0, 40]], float)}, shard_size=3,
              resize_hw=(64, 96))
    mine = cache_corrected_frames({"p1c1": VideoFrameSource(video, resize_hw=(128, 192), parse_ts=False)},
                                  output_dir=str(tmp_path / "port"), **kw)
    theirs = jax_cache({"p1c1": VideoFrameSource(video, resize_hw=(128, 192), parse_ts=False)},
                       output_dir=str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in mine] == [os.path.basename(p) for p in theirs] == \
        ["shard_0000.npz", "shard_0001.npz"]
    for a, b in zip(mine, theirs):
        with np.load(a) as za, np.load(b) as zb:
            for k in ("frames", "labels"):
                np.testing.assert_array_equal(za[k], zb[k])
            assert za["frames"].dtype == np.uint8 and za["frames"][0, :20, :30].max() == 0
            assert za["labels"].shape[1:] == (32, 21)


def test_on_frame_is_called_once_a_frame(toy_cameras3):
    """``process`` calls ``on_frame(frame_num, frames, snapshot, ts_bias)``
    after every frame, and the ignore polygons reach the tracker's bank."""
    from playground3d_tpu_torch.data.synthetic import mc_oracle_detections
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig

    reg = toy_cameras3["registry"]
    cameras = list(toy_cameras3["ranges"])
    scene = SyntheticScene(n_objects=6, seed=2, x_spawn=(380, 820), x_visible=(340, 860))
    rng = np.random.default_rng(0)
    cfg = TrackerConfig(max_tracks=16, max_dets=16, x_range=(300.0, 900.0), f_init=1, det_step=2)
    calls = []

    def detect(frames, frame_num):
        return mc_oracle_detections(scene, [frame_num / 30.0] * 3, reg, cameras, toy_cameras3["ranges"], 16, rng,
                                    device="cpu")

    trk = MultiCameraTracker(reg, cameras, cfg=cfg, detect_fn=detect, centers=toy_cameras3["centers"],
                             device="cpu", ignore_polygons=_polygons(rng), image_hw=(540, 960),
                             on_frame=lambda *a: calls.append(a))
    assert tuple(trk.bank.ignore.shape) == (3, 540 // 8, 960 // 8)
    frames = [((np.zeros((4, 4, 3), np.float32), T0 + f / 30.0) for f in range(5)) for _ in cameras]
    trk.track(frames, per_frame=True)
    assert [c[0] for c in calls] == list(range(5)) and len(trk.rows) == 5
    for frame_num, frames_c, snap, bias in calls:
        assert frames_c.shape == (3, 4, 4, 3) and bias.shape == (3,)
        assert snap.states7.shape[0] == cfg.max_tracks
    assert sum(len(r[2]) for r in trk.rows) > 0


# ---------------------------------------------------------------------------
# the session app end to end
# ---------------------------------------------------------------------------

H, W = 64, 256  # wide enough for the burned timestamp strip


def _checkpoints(tmp_path, reg, lo, hi):
    det = retinanet_init(torch.Generator().manual_seed(0), depth=18, stem="s2d", device="cpu")
    with torch.no_grad():
        det.heads.cls_out.b += 3.0
        det.heads.reg_out.b.copy_(torch.as_tensor(
            aimed_regression_bias(reg.P[0, 0], ((lo + hi) / 2, 40.0, 18.0, 6.0, 5.0, 1.0), (H, W))))
    crop = retinanet_init(torch.Generator().manual_seed(1), depth=18, stem="s2d", device="cpu")
    with torch.no_grad():
        crop.heads.cls_out.b += 3.0
    paths = str(tmp_path / "det.npz"), str(tmp_path / "crop.npz")
    save_params(paths[0], det)
    save_params(paths[1], crop)
    return paths


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A session of two toy cameras, each with two 6-frame y4m segments at
    the stored size and at 2x it (the 4K case), burned timestamps, a
    registry .npz and the detector and crop checkpoints."""
    d = tmp_path_factory.mktemp("session")
    reg, ranges, _, _ = toy_camera_chain(2)
    cams = list(ranges)
    lo, hi = ranges["p1c1"]
    scene = SyntheticScene(n_objects=6, seed=2, x_spawn=(lo + 20, ranges["p1c2"][1] - 20),
                           x_visible=(lo - 20, ranges["p1c2"][1] + 20))
    out = {"registry": str(d / "registry.npz"), "reg": reg, "cams": cams, "range": (lo, hi)}
    reg.save(out["registry"])
    for scale in (1, 2):
        root = d / f"x{scale}"
        (root / "recording").mkdir(parents=True)
        (root / "_SESSION_CONFIG.config").write_text(
            "".join(f"__CAMERA__\nname == {c}\n" for c in cams)
            + "__PERSISTENT-RECORDING__\nrecording_filename == ./recording/record_{cam_name}_%05d.y4m\n")
        (root / "_SESSION_INFO.txt").write_text("SESSION #1\n")
        for ci, cam in enumerate(cams):
            src = SyntheticVideoSource(scene, reg.P[ci, 0], n_frames=12, t0=T0, height=H * scale,
                                       width=W * scale, normalized=False, burn_timestamp=True)
            frames = [(np.clip(f, 0, 1) * 255).astype(np.uint8) for f, _ in src]
            for seg in range(2):
                write_y4m(str(root / "recording" / f"record_{cam}_{seg:05d}.y4m"), frames[seg * 6:(seg + 1) * 6])
        out[scale] = str(root)
    out["det"], out["crop"] = _checkpoints(d, reg, lo, hi)
    return out


def _argv(rec, scale, emit, out, extra=(), crop=False):
    """The app's arguments; with ``crop`` the crop net runs (every frame
    between detect frames is a crop frame at the app's ``skip_step`` 1)."""
    return ["--mode", "session", "--session-dir", rec[scale], "--registry", rec["registry"], "--depth", "18",
            "--clip-len", "6", "--det-step", "3", "--height", str(H), "--width", str(W), "--emit", emit,
            "--checkpoint", rec["det"], "--out", out, *(["--crop-checkpoint", rec["crop"]] if crop else []), *extra]


def _rows(path):
    _, data = load_i24_csv(path)
    return {(f, int(r[2])): (r[3], parse_state_row(r), float(r[1])) for f, rows in data.items() for r in rows}


def _assert_same_csv(got, want, min_rows):
    assert set(got) == set(want) and len(want) >= min_rows, (len(got), len(want))
    for k in want:
        assert got[k][0] == want[k][0], k
        np.testing.assert_allclose(got[k][1][:6], want[k][1][:6], rtol=0, atol=1e-3, err_msg=str(k))
        np.testing.assert_allclose(got[k][1][6], want[k][1][6], rtol=1e-4, err_msg=str(k))


def test_session_app_matches_jax(tmp_path, recorded):
    """``--mode session --emit yuv420`` at the stored size: the port's CSV
    against the JAX app's with the same checkpoints, and the burned
    timestamps in both."""
    from playground3d_tpu.apps import track as jax_app

    pout, jout = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    stats = port_app.main(_argv(recorded, 1, "yuv420", pout, ["--device", "cpu"], crop=True))
    jax_app.main(_argv(recorded, 1, "yuv420", jout, crop=True))
    got, want = _rows(pout), _rows(jout)
    _assert_same_csv(got, want, min_rows=12)
    assert stats["frames"] == 12 and all(stats[k] > 0 for k in ("read", "ts", "tail", "stage"))
    stamps = sorted({(k[0], v[2]) for k, v in got.items()})
    np.testing.assert_allclose([t for _f, t in stamps], [T0 + f / 30.0 for f, _t in stamps], atol=5e-3)


def test_session_app_reads_4k_sessions_through_every_emit(tmp_path, recorded):
    """From 2x recordings, every emit tracks to the stored-size yuv420 CSV
    (the heads' zero output convs make the boxes pixel-independent, so this
    holds the wiring of the host tails, the card-side colour conversion and
    the timestamps), and a reference pickle serves as the registry. The
    crop net stays off: these frames reach the detector only."""
    ref_out = str(tmp_path / "stored.csv")
    port_app.main(_argv(recorded, 1, "yuv420", ref_out, ["--device", "cpu"]))
    base = _rows(ref_out)
    for emit in ("yuv420", "s2d_u8", "f32"):
        out = str(tmp_path / f"x2_{emit}.csv")
        port_app.main(_argv(recorded, 2, emit, out, ["--device", "cpu"]))
        _assert_same_csv(_rows(out), base, min_rows=12)

    pkl = str(tmp_path / "registry.cpkl")
    _reference_pickle(pkl, recorded["reg"], wrapped=True)
    out = str(tmp_path / "pickle.csv")
    argv = _argv(recorded, 1, "yuv420", out, ["--device", "cpu"])
    argv[argv.index("--registry") + 1] = pkl
    port_app.main(argv)
    _assert_same_csv(_rows(out), base, min_rows=12)


def test_session_app_ignore_region_stops_births(tmp_path, recorded):
    """An ignore polygon over all of camera 0's image drops its detections:
    the tracks its detections bear without the polygon are never born,
    while camera 1's still are."""
    free = str(tmp_path / "free.csv")
    port_app.main(_argv(recorded, 1, "yuv420", free, ["--device", "cpu"]))
    ig = tmp_path / "ignored_regions"
    ig.mkdir()
    (ig / "p1c1_ignored.csv").write_text(f"-1,-1\n{W + 1},-1\n{W + 1},{H + 1}\n-1,{H + 1}\n")
    masked = str(tmp_path / "masked.csv")
    port_app.main(_argv(recorded, 1, "yuv420", masked, ["--device", "cpu", "--ignore-dir", str(ig)]))

    def births(rows):
        first = {}
        for (f, i), (_c, state, _t) in sorted(rows.items()):
            first.setdefault(i, state)
        return np.array([s[0] for s in first.values()])

    lo, hi = recorded["range"]
    x_cam0 = (lo + hi) / 2  # where camera 0's aimed box lies on the road
    free_x, masked_x = births(_rows(free)), births(_rows(masked))
    assert np.any(np.abs(free_x - x_cam0) < 10.0), free_x
    assert len(masked_x) > 0 and not np.any(np.abs(masked_x - x_cam0) < 10.0), masked_x
