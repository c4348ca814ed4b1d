"""The PyTorch port stands alone: importing it and running a CPU step loads
no JAX and nothing of the JAX package, and its entry points refuse to fall
back to the CPU when CUDA is absent."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

_STEP = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import playground3d_tpu_torch
    from playground3d_tpu_torch.geometry.homography import CameraRegistry
    from playground3d_tpu_torch.models import bridge
    from playground3d_tpu_torch.models.retinanet import retinanet_init
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig

    rng = np.random.default_rng(0)
    sp = np.stack([rng.uniform(400, 600, 12), rng.uniform(0, 120, 12)], 1)
    im = sp * [3.0, 4.0] + [-1000.0, 100.0]
    reg = CameraRegistry()
    reg.add_camera("p1c1", im, sp, np.array([[1e6, 540.0], [960.0, 1e6], [960.0, -1e5]]))
    g = torch.Generator().manual_seed(0)
    det = retinanet_init(g, depth=18, device="cpu")
    crop = retinanet_init(g, depth=18, tower_depth=2, shared_tower=True, device="cpu")
    cfg = TrackerConfig(max_tracks=8, max_dets=8, pre_topk=32, det_step=2, cs=32, cd_max=4)
    trk = MultiCameraTracker(reg, ["p1c1"], cfg=cfg, det_model=det, crop_model=crop,
                             centers=np.array([[500.0, 60.0]]), device="cpu")
    src = [((np.zeros((64, 96, 3), np.uint8), 1.6e9 + f / 30.0) for f in range(3))]
    assert trk.track(src, clip_len=3)["frames"] == 3

    # the camera-sharded clip, on a mesh of the CPU listed twice
    from playground3d_tpu_torch.parallel.mesh import make_mesh

    trk = MultiCameraTracker(reg, ["p1c1", "p1c1"], cfg=cfg, det_model=det, crop_model=crop,
                             centers=np.array([[500.0, 60.0]] * 2), device="cpu")
    src = [((np.zeros((64, 96, 3), np.uint8), 1.6e9 + f / 30.0) for f in range(3)) for _ in range(2)]
    assert trk.track(src, clip_len=3, mesh=make_mesh(devices=["cpu"] * 2))["frames"] == 3

    # the shipped transport: s2d stems, int8-quantized nets, YUV420 bytes in
    from playground3d_tpu_torch.models.quant import is_quantized, quantize_detector
    from playground3d_tpu_torch.ops import assignment, crop_mxu, crop_resize, nms, qconv, yuv420

    det = retinanet_init(g, depth=18, stem="s2d", device="cpu")
    crop = retinanet_init(g, depth=18, stem="s2d", tower_depth=2, shared_tower=True, device="cpu")
    det = quantize_detector(det, torch.zeros((1, 16, 24, 48), dtype=torch.uint8))
    crop = quantize_detector(crop, torch.zeros((2, 8, 8, 48), dtype=torch.uint8))
    assert is_quantized(det) and is_quantized(crop)
    trk = MultiCameraTracker(reg, ["p1c1"], cfg=cfg, det_model=det, crop_model=crop,
                             centers=np.array([[500.0, 60.0]]), stem="s2d", crop_stem="s2d",
                             device="cpu")
    src = [((np.full((64 * 96 * 3 // 2,), 128, np.uint8), 1.6e9 + f / 30.0) for f in range(3))]
    assert trk.track_clips(src, clip_len=3, yuv_hw=(64, 96))["frames"] == 3
    # importing and running on the CPU built and loaded no kernel library
    assert all(lib._lib is None for lib in (crop_mxu.LIB, crop_resize.LIB, qconv.LIB, yuv420.LIB, nms.LIB,
                                            assignment.LIB))
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "playground3d_tpu" or m.startswith("playground3d_tpu."))
    print("BAD", bad)
    assert not bad, bad
    """
)


_SINGLE = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    from playground3d_tpu_torch.apps import track
    from playground3d_tpu_torch.data import synthetic, timestamps, toy_cameras, video
    from playground3d_tpu_torch.evaluation import ap, coco_eval, csv_io, datareader, geometry_np, mot
    from playground3d_tpu_torch.models.nn import load_params, save_params
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig
    from playground3d_tpu_torch.utils.profiling import Spans

    reg, ranges, _, _ = toy_cameras.toy_camera_chain(1)
    scene = synthetic.SyntheticScene(n_objects=4, seed=1)
    rng = np.random.default_rng(0)
    det = lambda frames: synthetic.oracle_detections(scene, 0.0, reg.P[0, 0], 8, rng=rng, device="cpu")
    trk = SingleCameraTracker(reg, "p1c1", cfg=TrackerConfig(max_tracks=8, max_dets=8), detect_fn=det,
                              device="cpu")
    trk.process_frame(np.zeros((4, 4, 3), np.float32), 1.6e9, 0)
    assert len(trk.rows) == 1
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "playground3d_tpu" or m.startswith("playground3d_tpu."))
    print("BAD", bad)
    assert not bad, bad
    """
)


_SESSION = textwrap.dedent(
    """
    import os
    import sys
    import tempfile
    import numpy as np
    from playground3d_tpu_torch.apps import track
    from playground3d_tpu_torch.data import avdecode, dataset, frame_cache, native, regions, session, video
    from playground3d_tpu_torch.geometry.homography import CameraRegistry
    from playground3d_tpu_torch.tools import ref_interop

    d = tempfile.mkdtemp()
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (64, 96, 3), dtype=np.uint8) for _ in range(2)]
    video.write_y4m(os.path.join(d, "c.y4m"), frames)
    for emit in ("s2d_u8", "yuv420", "f32"):
        out = list(video.VideoFrameSource(os.path.join(d, "c.y4m"), resize_hw=(32, 48), emit=emit))
        assert len(out) == 2
    from playground3d_tpu_torch.ops.cuda_build import BUILD_DIR

    assert native.LIB._lib is not None and native.LIB.build().parent == BUILD_DIR
    grid = regions.ignore_grid({"a": np.array([[0, 0], [40, 0], [0, 40]])}, ["a"], 64, 96)
    assert grid.any() and dataset.pad_labels(np.zeros((2, 21))).shape == (32, 21)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "playground3d_tpu" or m.startswith("playground3d_tpu."))
    print("BAD", bad)
    assert not bad, bad
    """
)


_TRAIN = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    from playground3d_tpu_torch.apps import fit_filter, train_detector
    from playground3d_tpu_torch.data import coco, csv_dataset, dataset, fit_filter_dataset
    from playground3d_tpu_torch.geometry.homography import find_vanishing_point, scale_P_z
    from playground3d_tpu_torch.losses.focal import detection_loss
    from playground3d_tpu_torch.ops import focal_loss
    from playground3d_tpu_torch.track.kf import BatchedKF, params_from_arrays
    from playground3d_tpu_torch.train import fit_kf
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer
    from playground3d_tpu_torch.utils import checkpoint
    from playground3d_tpu_torch.utils.config import DetectorConfig

    ds = dataset.SyntheticDetectionDataset(image_shape=(64, 96), zoom=3.0, output_dtype="uint8")
    frames, labels = next(ds.batches(2))
    tr = Trainer(TrainConfig(depth=18, image_shape=(64, 96), feature_size=32, tower_depth=1), device="cpu")
    m = tr.train_step(frames, labels)
    assert np.isfinite(float(m["loss"])) and tr.state.step == 1
    kf = BatchedKF(device="cpu")
    kf.add(np.ones((1, 5), np.float32), [0], np.ones(1), np.zeros(1))
    kf.predict()
    assert focal_loss.LIB._lib is None  # the CPU built no kernel
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "playground3d_tpu" or m.startswith("playground3d_tpu."))
    print("BAD", bad)
    assert not bad, bad
    """
)


def test_training_loads_no_jax_and_nothing_of_the_jax_package():
    """The training modules and one CPU training step."""
    out = subprocess.run(
        [sys.executable, "-c", _TRAIN], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_host_io_loads_no_jax_and_nothing_of_the_jax_package():
    """The host I/O modules of the session slice: the native tails built
    and run, the decoders, the session, region and cache helpers."""
    out = subprocess.run(
        [sys.executable, "-c", _SESSION], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_port_never_runs_make_nor_names_the_jax_packages_native_builds():
    """The port reads ``native/*.cc`` and builds into its own ``_build/``:
    no source of it runs ``make`` or names a ``native/lib*.so``."""
    import re
    from pathlib import Path

    import playground3d_tpu_torch
    from playground3d_tpu_torch.data import avdecode, native
    from playground3d_tpu_torch.ops.cuda_build import BUILD_DIR

    sources = sorted(Path(playground3d_tpu_torch.__file__).parent.rglob("*.py")) + [Path("chip_smoke.py")]
    assert len(sources) > 40
    for path in sources:
        text = path.read_text()
        assert not re.search(r"[\"']make[\"']", text), path
        assert not re.search(r"lib(framepipe|avdecode)\.so|native/lib", text), path
    for lib in (native.LIB, avdecode.LIB):
        assert lib.source.parent == native.NATIVE_DIR and lib.source.suffix == ".cc" and lib.source.exists()
    assert native.LIB.build().parent == BUILD_DIR


def test_single_camera_loads_no_jax_and_nothing_of_the_jax_package():
    """The slice's new modules and one oracle single-camera step."""
    out = subprocess.run(
        [sys.executable, "-c", _SINGLE], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def test_port_loads_no_jax_and_nothing_of_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _STEP], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


def _entry_points():
    from playground3d_tpu_torch.geometry.homography import CameraRegistry
    from playground3d_tpu_torch.models.retinanet import retinanet_init
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
    from playground3d_tpu_torch.track.kf import default_params
    from playground3d_tpu_torch.apps import track
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, oracle_detections
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker
    from playground3d_tpu_torch.apps import train_detector
    from playground3d_tpu_torch.track.kf import BatchedKF
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer
    from playground3d_tpu_torch.apps import auto_label_e2e, demo_e2e, demo_e2e_mc, detect_video
    from playground3d_tpu_torch.models.retinanet import detect_singleframe
    from playground3d_tpu_torch.models.retinanet2d import retinanet2d_init
    from playground3d_tpu_torch.tools import benchmark_speed
    from playground3d_tpu_torch.parallel.mesh import make_mesh

    return {
        "retinanet_init": lambda: retinanet_init(depth=18),
        "default_params": lambda: default_params(),
        "init_track_state": lambda: init_track_state(4),
        "MultiCameraTracker": lambda: MultiCameraTracker(CameraRegistry(), [], detect_fn=print),
        "SingleCameraTracker": lambda: SingleCameraTracker(toy_camera_chain(1)[0], "p1c1", detect_fn=print),
        "oracle_detections": lambda: oracle_detections(SyntheticScene(), 0.0, np.eye(3, 4), 16),
        "track_app": lambda: track.main(["--oracle", "--frames", "1"]),
        "track_app_session": lambda: track.main(["--mode", "session", "--session-dir", ".", "--registry", "r.npz"]),
        "Trainer": lambda: Trainer(TrainConfig(depth=18)),
        "train_app": lambda: train_detector.main(["--steps", "1", "--depth", "18"]),
        "BatchedKF": lambda: BatchedKF(),
        "detect_video": lambda: detect_video.main(["--frames", "1", "--depth", "18"]),
        "benchmark_speed": lambda: benchmark_speed.main(["--depth", "18", "--batches", "1"]),
        "demo_e2e": lambda: demo_e2e.main(["--steps", "1"]),
        "demo_e2e_mc": lambda: demo_e2e_mc.main(["--steps", "1", "--crop-steps", "1"]),
        "auto_label_e2e": lambda: auto_label_e2e.main(["--steps", "1"]),
        "retinanet2d_init": lambda: retinanet2d_init(num_classes=4, depth=18),
        "detect_singleframe": lambda: detect_singleframe(retinanet_init(depth=18), torch.zeros((64, 96, 3))),
        "make_mesh": lambda: make_mesh(),
    }


@pytest.mark.parametrize(
    "name", ["retinanet_init", "default_params", "init_track_state", "MultiCameraTracker",
             "SingleCameraTracker", "oracle_detections", "track_app", "track_app_session", "Trainer",
             "train_app", "BatchedKF", "detect_video", "benchmark_speed", "demo_e2e", "demo_e2e_mc",
             "auto_label_e2e", "retinanet2d_init", "detect_singleframe", "make_mesh"]
)
def test_default_device_raises_without_cuda(monkeypatch, name):
    """Entry points default to the card; without CUDA they raise instead
    of running on the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


_ALL_MODULES = textwrap.dedent(
    """
    import importlib
    import pkgutil
    import sys
    import playground3d_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(playground3d_tpu_torch.__path__, "playground3d_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith(("jax.", "jaxlib"))
                 or m == "playground3d_tpu" or m.startswith("playground3d_tpu."))
    print("MODULES", len(names), "BAD", bad)
    assert not bad, bad
    """
)


def test_no_module_of_the_port_imports_jax():
    """Every module of the package, imported one after another in a fresh
    interpreter, loads neither JAX nor anything of the JAX package."""
    out = subprocess.run(
        [sys.executable, "-c", _ALL_MODULES], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout and "MODULES" in out.stdout


@pytest.mark.parametrize("module", ["ops.qconv", "ops.crop_resize", "ops.nms", "models.nn", "models", "pipeline.graphs",
                                    "parallel.mesh", "ops.quantize"])
def test_a_module_imports_first_in_a_fresh_interpreter(module):
    """``chip_smoke.py`` imports the kernel loaders before anything else:
    each imports with nothing of the package loaded before it (the
    ``models`` exports load lazily, or ``ops.qconv`` -> ``models.nn`` ->
    ``models.retinanet`` -> ``models.quant`` -> ``ops.qconv`` is a cycle)."""
    out = subprocess.run(
        [sys.executable, "-c", f"import playground3d_tpu_torch.{module} as m; print(m.__name__)"],
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr


_SOURCES = ["crop_resize", "crop_resize_s2d", "yuv420_s2d", "qconv", "nms", "auction", "focal_loss", "quantize"]
_LOADERS = {
    "crop_resize": "crop_resize", "crop_resize_s2d": "crop_mxu", "yuv420_s2d": "yuv420", "qconv": "qconv",
    "nms": "nms", "auction": "assignment", "focal_loss": "focal_loss", "quantize": "quantize",
}


@pytest.mark.parametrize("source", _SOURCES)
def test_every_kernel_source_is_built_by_the_one_loader(source):
    """Each ``csrc/*.cu`` has one module whose ``KernelLibrary`` builds it,
    and ``chip_smoke.py`` builds that module's library in its build phase."""
    import importlib
    from pathlib import Path

    import chip_smoke
    from playground3d_tpu_torch.ops.cuda_build import CSRC_DIR, KernelLibrary

    assert sorted(p.stem for p in Path(CSRC_DIR).glob("*.cu")) == sorted(_SOURCES)
    module = f"playground3d_tpu_torch.ops.{_LOADERS[source]}"
    lib = importlib.import_module(module).LIB
    assert isinstance(lib, KernelLibrary) and lib.source == Path(CSRC_DIR) / f"{source}.cu"
    assert lib.source.exists() and module in chip_smoke.KERNEL_MODULES


def _wrapper_calls():
    """wrapper name -> (CUDA wrapper call, plain call, dispatching call) on
    small CPU tensors."""
    from playground3d_tpu_torch.losses import focal
    from playground3d_tpu_torch.ops import (assignment, crop_mxu, crop_resize, focal_loss, nms, qconv, quantize,
                                            roi_align, yuv420)

    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    s2d = torch.zeros((1, 4, 4, 48), dtype=torch.uint8)
    boxes = torch.tensor([[0.0, 0.0, 6.0, 6.0]])
    idx = torch.zeros(1, dtype=torch.int32)
    buf = torch.zeros((1, 1, 8 * 8 * 3 // 2), dtype=torch.uint8)
    x, wq, scale = torch.zeros((1, 4, 4, 16), dtype=torch.int8), torch.ones((8, 1, 1, 16), dtype=torch.int8), torch.ones(8)
    nb, ns, nm = torch.tensor([[0.0, 0.0, 2.0, 2.0], [1.0, 1.0, 3.0, 3.0]]), torch.tensor([0.9, 0.5]), torch.ones(2, dtype=torch.bool)
    b, rm, cm = torch.rand(3, 2), torch.ones(3, dtype=torch.bool), torch.ones(2, dtype=torch.bool)
    ann = torch.full((1, 2, 21), -1.0)
    ann[0, 0] = torch.tensor([0.0, 0.0, 6.0, 6.0] * 4 + [0.0, 0.0, 6.0, 6.0, 1.0])
    loss_in = (torch.full((1, 1, 8), 0.25), torch.zeros((1, 1, 12)), ann, boxes)
    return {
        "crop_resize": (lambda: crop_resize.crop_and_resize_cuda(frames, boxes, idx, 4),
                        lambda: roi_align.crop_and_resize_plain(frames, boxes, idx, 4),
                        lambda: roi_align.crop_and_resize(frames, boxes, idx, 4)),
        "crop_resize_s2d": (lambda: crop_mxu.crop_and_resize_s2d_cuda(s2d, boxes, idx, 8),
                            lambda: crop_mxu.crop_and_resize_s2d_plain(s2d, boxes, idx, 8),
                            lambda: crop_mxu.crop_and_resize_s2d(s2d, boxes, idx, 8)),
        "yuv420_s2d": (lambda: yuv420.yuv420_flat_to_s2d_cuda(buf, (8, 8)),
                       lambda: yuv420.yuv420_flat_to_s2d_plain(buf, (8, 8)),
                       lambda: yuv420.yuv420_flat_to_s2d(buf, (8, 8))),
        "qconv": (lambda: qconv.qconv_cuda(x, wq, scale), lambda: qconv.qconv_plain(x, wq, scale),
                  lambda: qconv.qconv(x, wq, scale)),
        "nms": (lambda: nms.nms_cuda(nb, ns, nm, 0.1), lambda: nms.nms_plain(nb, ns, nm, 0.1),
                lambda: nms.nms(nb, ns, nm, 0.1)),
        "auction": (lambda: assignment.assign_auction_cuda(b, rm, cm),
                    lambda: assignment.assign_auction_plain(b, rm, cm),
                    lambda: assignment.assign_auction(b, rm, cm)),
        "quantize": (lambda: quantize.quantize_cuda(frames.float(), scale[0]),
                     lambda: quantize.quantize_plain(frames.float(), scale[0]),
                     lambda: quantize.quantize(frames.float(), scale[0])),
        "focal_loss": (lambda: focal_loss.focal_loss_forward_cuda(*loss_in),
                       lambda: focal.detection_loss_plain(*loss_in),
                       lambda: focal.detection_loss(*loss_in)),
    }


@pytest.mark.parametrize("source", _SOURCES)
def test_cuda_wrappers_refuse_cpu_tensors_and_the_plain_versions_run(source):
    """A kernel's wrapper launches its kernel or raises: given CPU tensors
    it raises. The plain version beside it is what the dispatching entry
    runs for those tensors."""
    cuda_call, plain_call, entry = _wrapper_calls()[source]
    with pytest.raises(ValueError, match="CUDA"):
        cuda_call()
    want, got = plain_call(), entry()
    want, got = (want if isinstance(want, tuple) else (want,)), (got if isinstance(got, tuple) else (got,))
    assert all(torch.equal(a, b) for a, b in zip(want, got))
