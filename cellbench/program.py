"""The system under test: ``playground3d_tpu_torch``'s multi-camera tracker,
built from the benchmark's inputs through the program's own entry points,
and the graph replays of its clip."""

from __future__ import annotations

import concurrent.futures
import statistics

import numpy as np
import torch

from cellbench import archs, cell
from cellbench.window import Recorder

COMMON_KERNELS = ("nms", "assignment", "crop_mxu", "crop_resize", "yuv420")  # every cell's, whatever its nets


def build_kernels(cfg: dict) -> None:
    """Compile the kernels the configuration needs side by side (the
    common ones and those of each net's architecture), each unless its
    library is in the program's build cache already."""
    import importlib

    names = list(COMMON_KERNELS)
    for name in cell.NETS:
        names += [k for k in archs.of(cfg[name]).KERNELS if k not in names]
    libs = [importlib.import_module(f"playground3d_tpu_torch.ops.{m}").LIB for m in names]
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.build) for lib in libs]:
            f.result()


def build(cfg: dict, traffic: dict, weights: dict, calib: dict, device):
    """(the tracker with its seeded tracks, the recorder of its clip): each
    net built by its architecture module through the program's entry points,
    holding ``weights`` and, for an int8 configuration, quantized by the
    program on ``calib``; the clip is the tracker's own (the one
    ``track_clips`` makes for its users: the default clip, each branch a
    CUDA graph on the card), wrapped in a recorder."""
    from playground3d_tpu_torch.geometry import homography
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.utils.config import TrackerConfig

    det, crop = (archs.of(cfg[name]).build(cfg[name], weights[name], device, cfg["precision"], calib.get(name),
                                           "program") for name in cell.NETS)
    cams = cell.cameras(traffic)
    trk = MultiCameraTracker(
        cell.registry(homography, cams), [c.name for c in cams], cfg=cell.tracker_config(TrackerConfig, cfg),
        det_model=det, crop_model=crop, centers=np.asarray([c.centre for c in cams], np.float32),
        stem=archs.layout(cfg["detector"]), crop_stem=archs.layout(cfg["crop_net"]), device=device, graphs=True,
    )
    trk.state = cell.seed_tracks(trk.state, cfg["seeded_tracks"])
    rec = Recorder(trk._clip_fn())
    trk._clip = rec  # ``track_clips`` takes the clip from here
    return trk, rec


def replay_ms(rec: Recorder) -> dict:
    """Each captured graph of the clip replayed alone on its card: median of
    5 by CUDA events, ms. Keys: the shard's ``frame`` (a detect frame's
    forward and top-k), the lead's ``detect`` (merge, NMS, parse), ``crop``
    and ``passthrough``."""
    out = {}
    programs = [sd.programs for shards in rec.shard_runners.values() for sd in shards]
    programs += [runner.programs for runner in rec.runners.values()]
    for prog in programs:
        for name, (graph, _) in prog.graphs.items():
            times = []
            with torch.cuda.device(prog.device):
                for _ in range(5):
                    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    s.record()
                    graph.replay()
                    e.record()
                    e.synchronize()
                    times.append(s.elapsed_time(e))
            out[name] = statistics.median(times)
    return out
