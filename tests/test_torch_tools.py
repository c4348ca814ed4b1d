"""The host tools of the PyTorch port against the JAX package's: overlays
(``tools/visualize.py``), the annotation session and its shell
(``tools/annotator.py``, ``tools/annotator_shell.py``), the annotation and
playback web servers (``tools/annotator_web.py``, ``tools/playback_web.py``).

Each mirrors a JAX test (``tests/test_visualize.py``, ``tests/test_misc.py::
test_plot_boxes_and_birdseye``, ``tests/test_annotator.py``,
``tests/test_annotator_web.py``, ``tests/test_playback.py``) and, where the
output is an array or a file, holds it against the JAX module's on the same
input: frames and PNGs equal to the byte, sessions and CSVs equal (the
camera registries of the two packages agree to 1e-9, so projected pixels
within 1e-6 px), numbers within 1e-9 unless stated.
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from playground3d_tpu_torch.data.video import read_png, write_png
from playground3d_tpu_torch.evaluation import geometry_np as G
from playground3d_tpu_torch.geometry.homography import CameraRegistry
from playground3d_tpu_torch.pipeline.tracker_state import Snapshot
from playground3d_tpu_torch.tools import annotator_shell, visualize
from playground3d_tpu_torch.tools.annotator import AnnotationSession
from playground3d_tpu_torch.tools.annotator_shell import AnnotatorShell, session_from_csv, session_to_records
from playground3d_tpu_torch.utils.constants import CLASS_NAMES

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)

FPS = 30.0


@pytest.fixture(scope="module")
def port_camera(toy_camera):
    """The port's registry of the JAX fixture's toy camera: the same
    correspondences (``tests/conftest.py::toy_camera`` draws them from
    ``default_rng(7)``), fitted by the port's ``CameraRegistry``."""
    project = toy_camera["project"]
    rng = np.random.default_rng(7)
    sp = np.stack([rng.uniform(380, 650, size=24), rng.uniform(0, 120, size=24)], axis=1)
    corr = project(np.concatenate([sp, np.zeros((24, 1))], axis=1))
    vp_z = project(np.array([[500.0, 60.0, -1e7]]))[0]
    reg = CameraRegistry()
    reg.add_camera("p1c1", corr, sp, np.array([[1e6, 540.0], [960.0, 1e6], vp_z]))
    jreg = toy_camera["registry"]
    np.testing.assert_allclose(reg.P, jreg.P, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(reg.H, jreg.H, rtol=1e-9, atol=1e-9)
    return {"registry": reg, "project": project, "jax_registry": jreg}


def _snap(states7, t):
    n = len(states7)
    return Snapshot(
        states7=torch.as_tensor(np.asarray(states7, np.float32)),
        ids=torch.arange(n, dtype=torch.int32),
        classes=torch.zeros((n,), dtype=torch.int32),
        mask=torch.ones((n,), dtype=torch.bool),
        raw_mask=torch.ones((n,), dtype=torch.bool),
        t=torch.tensor(t, dtype=torch.float32),
    )


def _jax_snap(states7, t):
    import jax.numpy as jnp

    from playground3d_tpu.pipeline.tracker_state import Snapshot as JSnapshot

    n = len(states7)
    return JSnapshot(
        states7=jnp.asarray(np.asarray(states7, np.float32)), ids=jnp.arange(n, dtype=jnp.int32),
        classes=jnp.zeros((n,), jnp.int32), mask=jnp.ones((n,), bool), raw_mask=jnp.ones((n,), bool),
        t=jnp.asarray(t, jnp.float32),
    )


# --------------------------------------------------------------------------
# visualize
# --------------------------------------------------------------------------


def test_overlay_writer_renders_boxes_and_bias(tmp_path, port_camera):
    """Mirror of ``test_visualize.py``'s test; the port's PNGs equal the
    JAX writer's on the same snapshots."""
    from playground3d_tpu.tools.visualize import TrackOverlayWriter as JWriter

    frame = np.zeros((1, 1080, 1920, 3), np.float32)
    s0 = np.array([[450.0, 60.0, 18.0, 6.0, 5.0, 1.0, 30.0]], np.float32)
    s1 = s0.copy()
    s1[0, 0] += 6.0
    bias = np.asarray([0.02], np.float32)
    w = visualize.TrackOverlayWriter(port_camera["registry"], ["p1c1"], str(tmp_path / "ov"))
    w(0, frame, _snap(s0, 0.0), ts_bias=bias)
    w(1, frame, _snap(s1, 1 / FPS), ts_bias=bias)
    w.close()
    jw = JWriter(port_camera["jax_registry"], ["p1c1"], str(tmp_path / "jov"))
    jw(0, frame, _jax_snap(s0, 0.0), ts_bias=bias)
    jw(1, frame, _jax_snap(s1, 1 / FPS), ts_bias=bias)
    jw.close()

    files = sorted(os.listdir(str(tmp_path / "ov" / "p1c1")))
    assert files == ["00000.png", "00001.png"] == sorted(os.listdir(str(tmp_path / "jov" / "p1c1")))
    for f in files:
        np.testing.assert_array_equal(read_png(str(tmp_path / "ov" / "p1c1" / f)),
                                      read_png(str(tmp_path / "jov" / "p1c1" / f)))
    img0 = read_png(str(tmp_path / "ov" / "p1c1" / files[0])) / 255.0
    img1 = read_png(str(tmp_path / "ov" / "p1c1" / files[1])) / 255.0
    green0 = ((img0[:, :, 1] > 0.8) & (img0[:, :, 0] < 0.4)).sum()
    assert green0 > 50, green0
    blue0 = ((img0[:, :, 2] > 0.8) & (img0[:, :, 1] < 0.6)).sum()
    blue1 = ((img1[:, :, 2] > 0.8) & (img1[:, :, 1] < 0.6)).sum()
    assert blue0 <= 64
    assert blue1 > 50, blue1
    assert img0[2, 2, 0] > 0.75 and img0[2, 2, 0] > img0[2, 2, 2] + 0.2
    assert w.frames_written == 2


def test_overlay_writer_unpacks_s2d_frames(tmp_path, port_camera):
    """s2d-packed uint8 frames, packed by the port's ``pack_s2d`` (and by
    ``space_to_depth`` on the device), unpack back to RGB."""
    from playground3d_tpu_torch.models.resnet import space_to_depth
    from playground3d_tpu_torch.ops.crop_mxu import pack_s2d

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 255, (1, 64, 96, 3), np.uint8)
    s2d = pack_s2d(rgb[0])
    np.testing.assert_array_equal(s2d, space_to_depth(torch.as_tensor(rgb), 4)[0].numpy())
    np.testing.assert_array_equal(visualize._depth_to_space(s2d), rgb[0])
    w = visualize.TrackOverlayWriter(port_camera["registry"], ["p1c1"], str(tmp_path / "ov"))
    w(0, s2d, _snap(np.zeros((0, 7), np.float32), 0.0))
    w.close()
    img = read_png(str(tmp_path / "ov" / "p1c1" / "00000.png"))
    np.testing.assert_allclose(img, rgb[0], atol=1)


def test_trackers_invoke_on_frame(port_camera):
    """Both of the port's drivers call the callback once a processed frame
    with (frame_num, frames, snap, ts_bias)."""
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, mc_oracle_detections, oracle_detections
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig

    reg = port_camera["registry"]
    P = reg.P[reg.index("p1c1"), 0]
    scene = SyntheticScene(n_objects=4, seed=3)
    cfg = TrackerConfig(max_tracks=16, max_dets=16, x_range=(300.0, 750.0), f_init=2)
    calls, holder = [], {"f": 0}

    def detect_fn(frames):
        return oracle_detections(scene, holder["f"] / FPS, P, K=cfg.max_dets, rng=np.random.default_rng(0),
                                 device="cpu")

    tr = SingleCameraTracker(reg, "p1c1", cfg=cfg, detect_fn=detect_fn, device="cpu",
                             on_frame=lambda fn, frames, snap, bias: calls.append((fn, frames.shape, bias)))

    def frames():
        for f in range(4):
            holder["f"] = f
            yield np.zeros((8, 8, 3), np.float32), 1.6e9 + f / FPS

    tr.track(frames())
    assert [c[0] for c in calls] == [0, 1, 2, 3]
    assert all(c[1] == (1, 8, 8, 3) for c in calls)

    ranges = {"p1c1": (350.0, 750.0)}
    mc_calls = []
    mc = MultiCameraTracker(
        reg, ["p1c1"], cfg=cfg, device="cpu",
        detect_fn=lambda frames, fn: mc_oracle_detections(scene, [fn / FPS], reg, ["p1c1"], ranges, cfg.max_dets,
                                                          device="cpu"),
        centers=np.array([[550.0, 60.0]], np.float32),
        on_frame=lambda fn, frames, snap, bias: mc_calls.append((fn, bias.shape)),
    )
    for f in range(3):
        mc.process(np.zeros((1, 8, 8, 3), np.float32), [1.6e9 + f / FPS], f)
    assert [c[0] for c in mc_calls] == [0, 1, 2]
    assert all(c[1] == (1,) for c in mc_calls)


def test_frames_dir_to_video_roundtrip(tmp_path):
    """Overlay PNGs -> y4m video -> decoded frames match; the y4m file
    equals the JAX function's byte for byte."""
    from playground3d_tpu.tools.visualize import frames_dir_to_video as jax_frames_dir_to_video
    from playground3d_tpu_torch.data.video import VideoFrameSource
    from playground3d_tpu_torch.utils.constants import IMAGENET_MEAN, IMAGENET_STD

    d = tmp_path / "frames"
    d.mkdir()
    yy, xx = np.mgrid[0:64, 0:96].astype(np.float32)
    frames = np.stack([
        np.stack([xx / 96 * 255, yy / 64 * 255, np.full_like(xx, 40.0 * i)], -1).astype(np.uint8)
        for i in range(4)
    ])
    for i, f in enumerate(frames):
        write_png(str(d / f"{i:05d}.png"), f)
    out, jout = str(tmp_path / "overlay.y4m"), str(tmp_path / "jax.y4m")
    assert visualize.frames_dir_to_video(str(d), out, fps=15) == 4
    assert jax_frames_dir_to_video(str(d), jout, fps=15) == 4
    assert open(out, "rb").read() == open(jout, "rb").read()

    decoded = [f for f, _ in VideoFrameSource(out, resize_hw=(64, 96), parse_ts=False)]
    assert len(decoded) == 4
    mean, std = np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)
    for orig, dec in zip(frames, decoded):
        rgb = np.clip((dec * std + mean) * 255.0, 0, 255)
        assert rgb.shape == (64, 96, 3)
        assert np.abs(rgb - orig.astype(np.float32)).mean() < 12.0


def test_np_banked_projection_matches_device_bank(port_camera):
    """``geometry_np.state_to_im_banked`` (the overlay/annotator host twin)
    dispatches as the port's ``camera_bank.state_to_im_banked``: by roadway
    side (y > 60 ft), not by direction sign."""
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry, state_to_im_banked

    reg = port_camera["registry"]
    bank = bank_from_registry(reg, device="cpu")
    rng = np.random.default_rng(11)
    n = 16
    states = np.zeros((n, 6), np.float32)
    states[:, 0] = rng.uniform(380.0, 520.0, n)
    states[:, 1] = np.where(np.arange(n) % 2 == 0, 30.0, 90.0)
    states[:, 2:5] = [18.0, 6.0, 5.0]
    states[:, 5] = np.where(np.arange(n) % 4 < 2, 1.0, -1.0)
    host = G.state_to_im_banked(states, reg.P[0, 0], reg.P[0, 1])
    dev = state_to_im_banked(bank, torch.as_tensor(states), torch.zeros((n,), dtype=torch.int32)).numpy()
    np.testing.assert_allclose(host, dev, rtol=1e-4, atol=5e-2)


def test_plot_boxes_and_birdseye(tmp_path):
    """Mirror of ``tests/test_misc.py::test_plot_boxes_and_birdseye``: the
    port's frame equals the JAX function's; ``birdseye_plot`` (matplotlib,
    imported only when called) writes its PNG."""
    from playground3d_tpu.tools.visualize import plot_boxes as jax_plot_boxes

    frame = np.zeros((64, 96, 3), np.float32)
    boxes = np.array([[[10, 10], [30, 10], [10, 30], [30, 30],
                       [10, 5], [30, 5], [10, 25], [30, 25]],
                      [[50, 40], [90, 44], [52, 60], [95, 63],
                       [50, 20], [90, 24], [52, 41], [95, 43]],
                      [[np.nan, 0]] * 8], np.float32)
    out = visualize.plot_boxes(frame, boxes, color=(1, 0, 0), thickness=2)
    assert out.sum() > 0 and frame.sum() == 0
    np.testing.assert_array_equal(out, jax_plot_boxes(frame, boxes, color=(1, 0, 0), thickness=2))
    states = np.array([[450.0, 30, 16, 6, 4, 1, 30]])
    visualize.birdseye_plot(states, (400, 500), path=str(tmp_path / "b.png"), ids=[7])
    assert (tmp_path / "b.png").exists()


# --------------------------------------------------------------------------
# annotator: the session's operations
# --------------------------------------------------------------------------


def _make_session(cls=AnnotationSession):
    s = cls()
    for f in range(0, 30, 5):
        t = f / 30.0
        s.add_box(t, [400 + 30 * t, 30, 16, 6, 4, 1, 30], 0, obj_id=0)
    return s


def _jax_session():
    from playground3d_tpu.tools.annotator import AnnotationSession as JSession

    return _make_session(JSession)


def _same_labels(a, b, atol=0.0):
    assert sorted(a.labels) == sorted(b.labels)
    for oid in a.labels:
        la, lb = a.labels[oid], b.labels[oid]
        assert len(la) == len(lb), oid
        for x, y in zip(la, lb):
            assert x.t == y.t and x.class_id == y.class_id
            np.testing.assert_allclose(x.state7, y.state7, rtol=0, atol=atol)


def test_add_shift_resize_class():
    s = _make_session()
    s.shift(0, 0.0, dx=2.0)
    assert s.labels[0][0].state7[0] == 402.0
    s.resize(0, 0.0, dl=1.0)
    assert s.labels[0][0].state7[2] == 17.0
    s.set_class(0, 3)
    assert all(l.class_id == 3 for l in s.labels[0])


def test_paste_forward_and_interpolate():
    s, j = _make_session(), _jax_session()
    for sess in (s, j):
        sess.paste_forward(0, 25 / 30.0, 1.0)
    last = max(s.labels[0], key=lambda l: l.t)
    assert last.t == pytest.approx(1.0)
    np.testing.assert_allclose(last.state7[0], 400 + 30 * 1.0, atol=0.2)
    for sess in (s, j):
        sess.interpolate(0, hz=30.0)
    ts = sorted(l.t for l in s.labels[0])
    assert len(ts) > 25
    np.testing.assert_allclose(np.diff(ts), 1 / 30.0, atol=1e-3)
    _same_labels(s, j)


def test_outlier_removal():
    s, j = _make_session(), _jax_session()
    for sess in (s, j):
        sess.interpolate(0, hz=30.0)
        sess.labels[0][10].state7[0] += 50.0
    assert s.remove_outliers(0, sigma=3.0) == 1 == j.remove_outliers(0, sigma=3.0)
    _same_labels(s, j)


def test_trajectory_fit():
    s, j = _make_session(), _jax_session()
    fx, fy = s.fit_trajectory(0, smoothing=0.1)
    jx, jy = j.fit_trajectory(0, smoothing=0.1)
    np.testing.assert_allclose(fx(0.5), 415.0, atol=1.0)
    np.testing.assert_allclose(fy(0.5), 30.0, atol=1.0)
    ts = np.linspace(0, 0.8, 9)
    np.testing.assert_allclose(fx(ts), jx(ts), rtol=1e-12)
    np.testing.assert_allclose(fy(ts), jy(ts), rtol=1e-12)


def test_ts_bias_solve():
    s = _make_session()
    s.interpolate(0, hz=30.0)
    obs = {
        "A": [(0, t, 400 + 30 * t) for t in (0.2, 0.4, 0.6)],
        "B": [(0, t + 0.05, 400 + 30 * t) for t in (0.2, 0.4, 0.6)],
    }
    biases = s.solve_ts_bias(obs, reference_camera="A")
    assert biases["A"] == 0.0
    assert biases["B"] == pytest.approx(-0.05, abs=0.01)
    j = _jax_session()
    j.interpolate(0, hz=30.0)
    assert j.solve_ts_bias(obs, reference_camera="A") == biases


def test_auto_label_matches_and_creates():
    s, j = _make_session(), _jax_session()
    dets = np.array([[400 + 30 * 1.0, 30, 16, 6, 4, 1], [500, 90, 18, 6, 5, -1.0]])
    ids = s.auto_label(dets, np.array([0, 2]), t=1.0)
    assert ids[0] == 0
    assert ids[1] != 0
    assert len(s.labels[ids[1]]) == 1
    assert j.auto_label(dets, np.array([0, 2]), t=1.0) == ids
    _same_labels(s, j)


def test_save_load_across_packages(tmp_path):
    """A session saved by either package loads in the other unchanged."""
    from playground3d_tpu.tools.annotator import AnnotationSession as JSession

    s = _make_session()
    s.auto_label(np.array([[500, 90, 18, 6, 5, -1.0]]), np.array([2]), t=0.5)
    p, jp = str(tmp_path / "sess.npz"), str(tmp_path / "jsess.npz")
    s.save(p)
    JSession.load(p).save(jp)
    with np.load(p) as a, np.load(jp) as b:
        np.testing.assert_array_equal(a["rows"], b["rows"])
    s2 = AnnotationSession.load(jp)
    assert set(s2.labels.keys()) == {0, 1}
    _same_labels(s2, s)


def test_reprojection_errors(port_camera):
    reg = port_camera["registry"]
    s = _make_session()
    errs = s.reprojection_errors(0, reg.H[0, 0], reg.P[0, 0])
    assert errs.shape == (6,)
    assert np.isfinite(errs).all()
    jreg = port_camera["jax_registry"]
    np.testing.assert_allclose(errs, _jax_session().reprojection_errors(0, jreg.H[0, 0], jreg.P[0, 0]),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# annotator_shell
# --------------------------------------------------------------------------


def _shell_session(cls=AnnotationSession):
    sess = cls()
    t0 = 1.6e9
    for f in range(6):
        t = t0 + f / 30.0
        sess.add_box(t, [500.0 + 3 * f, 24.0, 18.0, 6.0, 5.0, 1.0, 90.0], 1, 0)
        sess.add_box(t, [540.0 + 3 * f, 36.0, 20.0, 6.5, 5.5, 1.0, 90.0], 2, 1)
    return sess, t0


def _script(png, out_csv):
    return ["next 3", "show", "shift 0 2.5 -1.0", "dim 1 1.0 0 0", "class 1 semi", "copy 0", "next 1",
            "prev 1", f"render {png} 256 512", f"save {out_csv}", "quit"]


def test_scripted_edit_workflow_matches_jax(tmp_path, port_camera):
    """The JAX test's scripted session, run by both packages' shells on the
    same CSV: the rendered PNGs equal, the saved CSVs equal, and the edits
    land where the JAX test says."""
    from playground3d_tpu.evaluation.csv_io import write_results_csv as jax_write
    from playground3d_tpu.tools.annotator import AnnotationSession as JSession
    from playground3d_tpu.tools.annotator_shell import AnnotatorShell as JShell
    from playground3d_tpu.tools.annotator_shell import session_from_csv as jax_from_csv
    from playground3d_tpu.tools.annotator_shell import session_to_records as jax_to_records
    from playground3d_tpu_torch.evaluation.csv_io import write_results_csv

    reg, jreg = port_camera["registry"], port_camera["jax_registry"]
    sess, t0 = _shell_session()
    csv_in, jcsv_in = str(tmp_path / "in.csv"), str(tmp_path / "jin.csv")
    write_results_csv(csv_in, session_to_records(sess, reg, "p1c1"))
    jax_write(jcsv_in, jax_to_records(_shell_session(JSession)[0], jreg, "p1c1"))
    assert open(csv_in).read() == open(jcsv_in).read()

    out = {}
    for name, shell_cls, load, r in (("port", AnnotatorShell, session_from_csv, reg),
                                     ("jax", JShell, jax_from_csv, jreg)):
        png, out_csv = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}.csv")
        shell = shell_cls(load(csv_in), t0=t0, out=io.StringIO(), registry=r, cameras=["p1c1"])
        shell.run(_script(png, out_csv))
        assert shell.done and os.path.exists(png) and os.path.exists(out_csv)
        out[name] = (read_png(png), open(out_csv).read(), shell.out.getvalue().replace(str(tmp_path / name), "OUT"))
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert out["port"][2] == out["jax"][2]

    back = session_from_csv(str(tmp_path / "port.csv"))
    l3 = [l for l in back.labels[0] if abs(l.t - (t0 + 3 / 30.0)) < 1e-3][0]
    assert abs(l3.state7[0] - (500.0 + 9 + 2.5)) < 1e-2
    assert abs(l3.state7[1] - 23.0) < 1e-2
    for l in back.labels[1]:
        assert abs(l.state7[2] - 21.0) < 1e-2
        assert l.class_id == list(CLASS_NAMES).index("semi")


def test_copy_paste_rollforward_and_undo():
    sess, t0 = _shell_session()
    shell = AnnotatorShell(sess, t0=t0, out=io.StringIO())
    shell.run(["copy 0", "goto 10", "paste"])
    ls = sorted(sess.labels[0], key=lambda l: l.t)
    assert abs(ls[-1].t - (t0 + 10 / 30.0)) < 1e-6
    assert abs(ls[-1].state7[0] - ((500.0 + 15) + 90.0 * (5 / 30.0))) < 1e-3
    n_before = len(sess.labels[0])
    shell.execute("undo")
    assert len(sess.labels[0]) == n_before - 1


def test_delete_onward_and_auto():
    sess, t0 = _shell_session()

    def detector(t, camera):
        return np.array([[700.0, 48.0, 17.0, 6.0, 5.0, 1.0]]), np.array([0])

    shell = AnnotatorShell(sess, t0=t0, out=io.StringIO(), detector=detector)
    shell.run(["goto 3", "delete 1"])
    assert all(l.t < t0 + 3 / 30.0 - 1e-9 for l in sess.labels[1])
    assert len(sess.labels[1]) == 3
    shell.run(["auto"])
    new_id = max(sess.labels.keys())
    assert new_id >= 2
    assert abs(sess.labels[new_id][0].state7[0] - 700.0) < 1e-3


def test_interactive_error_recovery():
    sess, t0 = _shell_session()
    shell = AnnotatorShell(sess, t0=t0, out=io.StringIO())
    shell.run(["bogus command", "shift 99 1 1", "next 2"])
    assert shell.frame == 2
    assert "unknown command: bogus" in shell.out.getvalue()


def test_cli_script_mode(tmp_path):
    """``main`` on an npz session and a command file; the JAX shell's CLI
    on the same files writes the same session."""
    from playground3d_tpu.tools import annotator_shell as jax_shell

    sess, _ = _shell_session()
    npz, jnpz = str(tmp_path / "sess.npz"), str(tmp_path / "jsess.npz")
    sess.save(npz)
    sess.save(jnpz)
    script = tmp_path / "cmds.txt"
    script.write_text("next 2\nshift 0 1 0\nsave\nquit\n")
    annotator_shell.main([npz, "--script", str(script)])
    jax_shell.main([jnpz, "--script", str(script)])
    back = AnnotationSession.load(npz)
    assert len([l for l in back.labels[0] if abs(l.state7[0] - 507.0) < 1e-6]) == 1
    with np.load(npz) as a, np.load(jnpz) as b:
        np.testing.assert_array_equal(a["rows"], b["rows"])


# --------------------------------------------------------------------------
# annotator_web
# --------------------------------------------------------------------------


@pytest.fixture()
def server(port_camera):
    from playground3d_tpu_torch.tools.annotator_web import AnnotatorWeb

    sess = AnnotationSession()
    sess.add_box(0.0, [450.0, 30.0, 16.0, 6.0, 4.0, 1.0, 30.0], 2, obj_id=0)
    shell = AnnotatorShell(sess, registry=port_camera["registry"], cameras=["p1c1"], t0=0.0)
    web = AnnotatorWeb(shell)
    srv = web.make_server(port=0)  # a free port: the suite runs in parallel workers
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield {"base": f"http://127.0.0.1:{srv.server_address[1]}", "web": web, "shell": shell, "sess": sess,
           "project": port_camera["project"], "jax_registry": port_camera["jax_registry"]}
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_page_state_and_png(server):
    """The page, the state JSON and the frame PNG; the PNG's bytes equal
    what the JAX server renders for the same session."""
    from playground3d_tpu.tools.annotator import AnnotationSession as JSession
    from playground3d_tpu.tools.annotator_shell import AnnotatorShell as JShell
    from playground3d_tpu.tools.annotator_web import AnnotatorWeb as JWeb

    code, page = _get(server["base"] + "/")
    assert code == 200 and b"<canvas" in page
    code, raw = _get(server["base"] + "/state")
    st = json.loads(raw)
    assert st["camera"] == "p1c1" and st["frame"] == 0
    assert len(st["labels"]) == 1
    lab = st["labels"][0]
    assert lab["oid"] == 0 and lab["class_id"] == 2
    assert np.asarray(lab["corners_px"]).shape == (8, 2)
    code, png = _get(server["base"] + "/frame.png")
    assert code == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"

    js = JSession()
    js.add_box(0.0, [450.0, 30.0, 16.0, 6.0, 4.0, 1.0, 30.0], 2, obj_id=0)
    jweb = JWeb(JShell(js, registry=server["jax_registry"], cameras=["p1c1"], t0=0.0))
    srv = jweb.make_server(port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        jbase = f"http://127.0.0.1:{srv.server_address[1]}"
        assert _get(jbase + "/frame.png")[1] == png
        jst = json.loads(_get(jbase + "/state")[1])
        np.testing.assert_allclose(np.asarray(lab["corners_px"]), np.asarray(jst["labels"][0]["corners_px"]),
                                   atol=1e-6)
        assert _get(jbase + "/")[1] == page
    finally:
        srv.shutdown()
        srv.server_close()


def test_pixel_add_round_trips_through_homography(server):
    px = server["project"](np.array([[500.0, 40.0, 0.0]]))[0]
    code, st = _post(server["base"] + "/pixel", {"op": "add", "x": float(px[0]), "y": float(px[1])})
    assert code == 200
    assert len(st["labels"]) == 2
    new = [l for l in st["labels"] if l["oid"] != 0][0]
    assert abs(new["state7"][0] - 500.0) < 0.5
    assert abs(new["state7"][1] - 40.0) < 0.5


def test_pixel_drag_shifts_in_roadway_feet(server):
    p0 = server["project"](np.array([[450.0, 30.0, 0.0]]))[0]
    p1 = server["project"](np.array([[458.0, 33.0, 0.0]]))[0]
    code, st = _post(server["base"] + "/pixel", {"op": "shift", "oid": 0, "x0": float(p0[0]), "y0": float(p0[1]),
                                                  "x1": float(p1[0]), "y1": float(p1[1])})
    assert code == 200
    lab = [l for l in st["labels"] if l["oid"] == 0][0]
    assert abs(lab["state7"][0] - 458.0) < 0.5
    assert abs(lab["state7"][1] - 33.0) < 0.5
    code, st = _post(server["base"] + "/cmd", {"line": "undo"})
    assert code == 200
    lab = [l for l in st["labels"] if l["oid"] == 0][0]
    assert lab["state7"][0] == pytest.approx(450.0, abs=1e-6)


def test_bad_requests_keep_session_alive(server):
    code, body = _post(server["base"] + "/pixel", {"op": "explode", "x": 1, "y": 2})
    assert code == 400 and "error" in body
    code, st = _post(server["base"] + "/cmd", {"line": "frobnicate 1"})
    assert code == 200
    assert any("unknown command" in m for m in st["log"])
    code, _ = _get(server["base"] + "/state")
    assert code == 200


def test_malformed_json_body_answers_400(server):
    req = urllib.request.Request(server["base"] + "/cmd", data=b"{not json", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read().decode())
    with urllib.request.urlopen(server["base"] + "/state", timeout=10) as r:
        assert r.status == 200


# --------------------------------------------------------------------------
# playback_web
# --------------------------------------------------------------------------


def _tracks(cls):
    ts = np.arange(0.0, 4.0, 0.1)
    states = np.zeros((len(ts), 7))
    states[:, 0] = 400.0 + 30.0 * ts
    states[:, 1] = 40.0
    states[:, 2:5] = (16.0, 6.0, 4.0)
    states[:, 5] = 1.0
    states[:, 6] = 30.0
    return cls(times={3: ts}, states={3: states}, classes={3: "sedan"})


def _playback(pkg):
    """``tests/test_playback.py``'s fixture, built from either package."""
    import importlib

    dr = importlib.import_module(f"{pkg}.evaluation.datareader")
    pw = importlib.import_module(f"{pkg}.tools.playback_web")
    tc = importlib.import_module(f"{pkg}.data.toy_cameras")
    hg = importlib.import_module(f"{pkg}.geometry.homography")
    reg = hg.CameraRegistry()
    for i, name in enumerate(["p1c1", "p1c1b"]):
        tc.register_toy_camera(reg, name, tc.make_projector(cam_x=350.0), (380.0, 650.0), seed=7 + i)
    ts_a = np.arange(0.0, 4.0, 1 / 30.0)
    return pw.SyncPlayback(_tracks(dr.TimeIndexedTracks), reg, ["p1c1", "p1c1b"],
                           {"p1c1": ts_a, "p1c1b": ts_a - 0.1}, biases={"p1c1b": 0.1})


@pytest.fixture()
def playback():
    return _playback("playground3d_tpu_torch")


def test_frame_selection_under_bias(playback):
    pb = playback
    assert pb.frame_at("p1c1", 1.0) == 30
    assert pb.frame_at("p1c1b", 1.0) == 30
    assert pb.frame_at("p1c1", 1.02) == 31
    assert pb.frame_at("p1c1", -5.0) == 0
    assert pb.frame_at("p1c1", 99.0) == len(pb.cam_times["p1c1"]) - 1


def test_rollforward_to_camera_time_matches_jax(playback):
    jpb = _playback("playground3d_tpu")
    for t in (0.0, 1.05, 2.51, 99.0):
        views, jviews = playback.view_at(t), jpb.view_at(t)
        for v, jv in zip(views, jviews):
            assert v["ids"] == jv["ids"] == [3] and v["t_frame"] == jv["t_frame"]
            np.testing.assert_allclose(v["states"][0][0], 400.0 + 30.0 * v["t_frame"], atol=1e-6)
            np.testing.assert_allclose(v["states"], jv["states"], rtol=1e-12)
            assert v["corners_px"].shape == (1, 8, 2)
            np.testing.assert_allclose(v["corners_px"], jv["corners_px"], rtol=1e-9, atol=1e-6)


def test_span_is_common_coverage(playback):
    lo, hi = playback.span()
    np.testing.assert_allclose(lo, 0.0, atol=1e-9)
    assert 3.8 < hi <= 4.0


def test_view_marks_dead_tracks_absent(playback):
    from playground3d_tpu_torch.evaluation.datareader import TimeIndexedTracks
    from playground3d_tpu_torch.tools.playback_web import SyncPlayback

    assert playback.view_at(99.0)[0]["ids"] == [3]
    pb2 = SyncPlayback(_tracks(TimeIndexedTracks), None, ["c"], {"c": np.array([10.0])}, max_extrapolate=0.5)
    assert pb2.view_at(10.0)[0]["ids"] == []


def test_http_scrubber(playback):
    from playground3d_tpu_torch.tools.playback_web import PlaybackWeb

    srv = PlaybackWeb(playback).make_server(port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/", timeout=10) as r:
            page = r.read()
        assert r.status == 200 and b"scrub" in page and b"p1c1b" in page
        with urllib.request.urlopen(base + "/view?t=1.05", timeout=10) as r:
            view = json.loads(r.read())
        assert [c["camera"] for c in view["cameras"]] == ["p1c1", "p1c1b"]
        assert view["cameras"][0]["ids"] == [3]
        assert view["cameras"][0]["classes"] == ["sedan"]
        with urllib.request.urlopen(base + "/pframe.png?cam=p1c1&t=1.05", timeout=10) as r:
            png = r.read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/pframe.png?cam=nope&t=1.0", timeout=10)
        assert ei.value.code == 400
        with urllib.request.urlopen(base + "/view?t=0.0", timeout=10) as r:
            assert r.status == 200
    finally:
        srv.shutdown()
        srv.server_close()
