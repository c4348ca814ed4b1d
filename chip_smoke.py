#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``playground3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build   - compile every hand-written kernel from ``playground3d_tpu_torch/
             csrc`` with nvcc (one nvcc per source, all started together);
2. kernels - run each kernel at the shapes the main path gives it and at
             odd and edge shapes, hold it against its plain PyTorch version,
             and time the kernel, an empty kernel, the plain version and the
             nearest PyTorch library call (never used by the port):
             ``crop_resize.cu`` (raw frames), ``crop_resize_s2d.cu`` (s2d
             frames, every pyramid level), ``yuv420_s2d.cu`` and ``qconv.cu``
             (every conv shape that the quantized detector and crop net
             launch at 1080p, listed by a hook), ``quantize.cu`` (edge
             values, then every quantize step of a detect frame of 6
             cameras and of a crop frame, and both frames' forwards as
             graphs with the plain ops and with the kernel), ``nms.cu`` and
             ``auction.cu`` (the tracker's NMS and auction loops, at the main
             path's sizes and at edges; equal to the plain loops, round
             counts included; NMS on both routes, at every cluster size of
             the one-launch route, batched cases shifted in the kernel, and
             one ``batched_nms`` at n 512 one kernel launch), and
             ``focal_loss.cu`` (the training loss and its gradient, batch 4
             at 512x768, batch 2 at 1080x1920 and batch 4 at 112x112, with
             edge cases and labels at the edges of the forward's label
             cull: the assignment equal, a second forward bit-equal, losses
             and gradients within 1e-5; each pass's events time beside the
             kernel's own under the profiler);
3. main    - the multi-camera tracker at full width through
             ``MultiCameraTracker.track_clips``: one 1080p camera, ResNet-50
             detector (FPN/heads 256 wide), ResNet-18 crop net, 24-frame
             clips, live tracks seeded so every crop frame crops and updates
             real slots. The shipped configuration first (uint8 s2d-packed
             frames, s2d stems, both nets int8-quantized), then for
             comparison in the same run: s2d frames with float nets, raw
             frames with conv7 stems and float nets (the path the port ran first),
             and planar YUV420 bytes converted on the card. Each runs its
             branches as captured CUDA graphs, three times, and each run
             must equal the eager clip on the card and read the card once a
             clip (``track_clips``' lagged drain) and nowhere inside it; the
             NMS and auction calls of one eager detect and one crop frame
             are recorded, replayed through their kernels and timed.
             Before that, the card's clip is held against the CPU's on a
             small input for each transport and for a quantized pair;
4. variants - the JAX clip's two variants, ``make_mc_clip_step(
             batch_detects=True)`` (the clip's detect frames through one
             detector forward, a CUDA graph of its own) and ``unroll=True``
             (the whole clip one CUDA graph), called directly as ``bench.py``
             calls them: the shipped configuration over the main phase's two
             clips, each an eager clip and three captured runs that must
             equal the three-branch captured clip and read the card once a
             clip, launches a clip as the code implies; a conv7 + float
             unrolled clip (``crop_resize.cu`` inside the clip graph); and
             the batched detector pass at N 4 against four single-frame
             passes with random output convs (reported bit for bit);
5. mesh    - the device mesh: 4 cameras of 1080p s2d + int8 (the shipped
             knobs, the detector's output convs random, so detections
             follow each camera's pixels) through ``track_clips``, unsharded
             and camera-sharded (``mesh=``) over every visible card and, on
             one card, that card listed twice, each for the three-branch
             clip and ``batch_detects``: a run under the sync-debug mode
             reads the card once and equals the unsharded rows (ids,
             raw_mask, classes equal; states7 and kf.x within 1e-4);
             ``unroll`` with a mesh raises; each shard's graphs (nodes,
             launches a replay, replay time), the crop frame's gather to the
             lead and camera-frames/s; then ``apps/train_detector.py --dp``
             over every visible card (NCCL ranks) and two gloo ranks
             sharing one card, bit-equal to each other after 3 steps and
             within 6 lr of one process on the same global batches;
6. single  - the single-camera tracker: ``SingleCameraTracker`` on the card
             against the CPU at 64x96 (conv7 + float, s2d + int8); the shipped
             int8 ResNet-50 s2d detector on 24 uint8 s2d-packed 1080p frames
             through ``SingleCameraTracker.track``, its step one CUDA graph
             a frame, against an eager run of the same frames (``qconv.cu``
             exactly 102 launches a frame, no crop or YUV kernel, one host
             read a frame and no other synchronizing call under the
             sync-debug mode (besides one event wait a frame, which the
             mode does not see: the end of the step's timer), the
             NMS and auction rounds read from the card's counters, the CSV
             written and read back); then ``apps/track.py --mode single``
             (real conv7 detector, rendered 1080p frames) and ``--mode multi
             --oracle``, both with ``--eval``;
7. session - recorded sessions through ``apps/track.py --mode session``: a
             session directory of two cameras' 3840x2160 y4m segments with
             burned timestamps, an ignore region and checkpoints, tracked at
             1080p on the card with ``--emit s2d_u8`` (the fused 4K host
             tail) and ``--emit yuv420`` (quarter planes, colour
             conversion on the card); parsed timestamps equal the burned
             ones, the two emits' frames within 1 LSB, no birth from an
             ignored detection, native host functions equal their numpy
             twins, the card's session CSV equal the CPU's on a small
             session, an H.264 leg where libav exists; session frames/s,
             host ms per frame by stage and the card's busy share;
8. train   - detector training: one ``Trainer.train_step`` on the card
             against the CPU (depth 18, 64x128); ``apps/train_detector.py``
             in-process at its defaults (ResNet-50, conv7, FPN/heads 256
             wide, 4-conv towers, 512x768, batch 4, uint8 frames) for 20
             steps of 10 an epoch, and the crop net (112 px crops,
             ResNet-18, 2-conv shared tower): finite losses, the plateau
             rule, ``focal_loss.cu`` twice a step (and its device time a
             step), checkpoints that load
             into a RetinaNet, the detector's through ``apps/track.py
             --mode single``; one Trainer at 1080x1920, batch 2; steps/s,
             images/s, card busy, host ms per batch, peak memory; then
             ``apps/fit_filter.py`` into a tracker;
9. apps    - the last one-card apps and tools: ``apps/detect_video.py``
             (card against CPU at 64x96, then its defaults: ResNet-50
             conv7, 1080p, 24 frames; the CSV and its fps trailer),
             ``detect_singleframe`` (card against CPU at 128x192; at 1080p
             its NMS at n 4,096 takes the two-launch route) and
             ``models/retinanet2d.py`` (``forward_raw_2d`` card against
             CPU at 64x96 with random output convs, ``detect_2d`` at
             128x192; ResNet-50, 80 classes at 1080p); at 1080p each
             detector's heads have spread biases, so detections pass the
             thresholds and each NMS call has boxes to suppress, ``tools/
             benchmark_speed.py`` at its defaults, the demos with short
             training at 512x768 (``demo_e2e --quantize``; ``demo_e2e_mc``
             trained once, then tracked float and ``--quantize --cd-max 8``
             from its checkpoints; ``auto_label_e2e``), each run's
             ``qconv``, ``nms``, ``auction``, ``crop_resize_s2d`` and
             ``focal_loss`` launches counted on their own, and
             ``TrackOverlayWriter`` as the ``on_frame`` of one clip of the
             multi-camera tracker (a PNG a camera a frame);
10. report - the ``kernels`` JSON line, the card's name and power limit, and
             the final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --kernels-only`` stops after phase 2 (for work on a
kernel; it prints no result line). ``--loop-calls PATH`` also saves the main
path's recorded NMS and auction calls to PATH, for
``scripts/nms_auction_times.py --calls PATH``.

Only the port and PyTorch are imported; nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

H, W = 1080, 1920
T_CLIP = 24
N_SEED = 32  # live tracks seeded = crop_slots, so every crop slot is real
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
FP64_FLOPS = 34e12  # H100 SXM, outside the tensor cores (NVIDIA data sheet)
INT8_OPS = 1979e12  # H100 SXM, dense int8 on the tensor cores
# the kernel and the plain version do the same rounded ops in the same order:
# integer-valued pixels must agree exactly, [0,1] floats to 1e-5
CROP_TOL = {"uint8": 0.0, "float32": 1e-5}


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# the main path's configuration
# ---------------------------------------------------------------------------


def tracker_config(small: bool = False):
    from playground3d_tpu_torch.utils.config import TrackerConfig

    cfg = dict(
        max_tracks=64, max_dets=48, pre_topk=512, x_range=(300.0, 800.0), det_step=6,
        skip_step=3, crop_slots=32, cd_max=8, cs=112, f_max=5, f_init=5, tentative_age=4,
        size_nudge=True, crop_conf_gate=True, estimate_ts_bias=False, approx_topk=False,
        det_min_level=3, ghost_frames=0,
    )
    if small:
        cfg.update(max_tracks=16, max_dets=16, pre_topk=128, cs=32, crop_slots=8)
    return TrackerConfig(**cfg)


def bench_registry(h: int = H, w: int = W, cameras=(("p1c1", 0.0),)):
    """Fitted pole cameras: each a 30 ft pole at road-x 250 + dx looking
    down-road over x in [450, 680] + dx (the JAX package's
    ``register_bench_camera``), for each (name, dx) of ``cameras``."""
    from playground3d_tpu_torch.geometry.homography import CameraRegistry

    f, cx, cy = 2000.0 * w / 1920.0, w / 2.0, h / 2.0
    yaw, pitch = np.deg2rad(4.0), np.deg2rad(6.0)
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])
    def project(p3, cam_pos):
        d = p3 - cam_pos
        cam = np.stack([d[:, 1], -d[:, 2], d[:, 0]], 1) @ Ry.T @ Rx.T
        return np.stack([f * cam[:, 0] / cam[:, 2] + cx, f * cam[:, 1] / cam[:, 2] + cy], 1)

    reg = CameraRegistry()
    for name, dx in cameras:
        cam_pos = np.array([250.0 + dx, 60.0, -30.0])
        rng = np.random.default_rng(7)
        sp = np.stack([rng.uniform(450, 680, 24) + dx, rng.uniform(0, 120, 24)], 1)
        im = project(np.concatenate([sp, np.zeros((24, 1))], 1), cam_pos)
        vp_z = project(np.array([[550.0 + dx, 60.0, -1e7]]), cam_pos)[0]
        reg.add_camera(name, im, sp, np.array([[1e6, cy], [cx, 1e6], vp_z]))
    return reg


def build_models(device, crop_target, small: bool = False, stem: str = "conv7"):
    """Random-init detector and crop net from fixed seeds, with two bias
    tweaks so the random heads drive the tracker like a trained pair:

    * the class bias is raised by 3, so scores (at the focal prior, equal
      for every anchor) cross the confidence gates;
    * the crop net's regression bias puts the candidates it ranks first
      (equal scores: the stride-8 anchors of cell (0, 0), centred at
      (4, 4)) at ``crop_target``, the crop pixel where the tracked object's
      bottom centre lies (see :func:`crop_target`), so crop updates keep the
      seeded tracks on the road instead of dragging them to the crop's
      corner."""
    import torch

    from playground3d_tpu_torch.models.anchors import base_anchors
    from playground3d_tpu_torch.models.retinanet import retinanet_init

    if small:
        det = retinanet_init(torch.Generator().manual_seed(0), depth=18, stem=stem, device=device)
        crop = retinanet_init(torch.Generator().manual_seed(1), depth=18, stem=stem, tower_depth=2,
                              shared_tower=True, device=device)
    else:
        det = retinanet_init(torch.Generator().manual_seed(0), depth=50, stem=stem,
                             feature_size=256, tower_depth=4, shared_tower=False, device=device)
        crop = retinanet_init(torch.Generator().manual_seed(1), depth=18, stem=stem,
                              tower_depth=2, shared_tower=True, device=device)
    wh = base_anchors(32.0)[:, 2:] * 2.0  # [9, (w, h)] of the stride-8 anchors
    offset = (np.asarray(crop_target, np.float64)[None, :] - 4.0) / wh
    with torch.no_grad():
        for m in (det, crop):
            m.heads.cls_out.b += 3.0
        b = crop.heads.reg_out.b.view(9, 12)
        b[:, 0:2] = torch.as_tensor(offset, dtype=torch.float32, device=b.device)
    return det, crop


def quantize_pair(det, crop, frame_s2d, cs: int, seed: int = 5):
    """Both nets int8-quantized as the JAX package's benchmark quantizes its
    pair: the detector calibrated on one packed uint8 frame, the crop net on
    four random uint8 crops in the packed layout."""
    import torch

    from playground3d_tpu_torch.models.quant import quantize_detector

    gen = torch.Generator().manual_seed(seed)
    crop_calib = torch.randint(0, 256, (4, cs // 4, cs // 4, 48), generator=gen, dtype=torch.uint8)
    return (quantize_detector(det, frame_s2d[None]),
            quantize_detector(crop, crop_calib.to(frame_s2d.device)))


def pack_frames(frames: np.ndarray) -> np.ndarray:
    """[T,H,W,3] -> [T,H/4,W/4,48], the packing the frame sources do."""
    from playground3d_tpu_torch.ops.crop_mxu import pack_s2d

    return np.stack([pack_s2d(f) for f in frames])


def seed_crop_boxes(reg, cfg, n_seed: int, s2d: bool = False):
    """The seeded tracks' crop boxes [n,4] and image corners [n,8,2], built
    as the crop branch builds them (``multi_cam.py::make_crop_step``); on the
    s2d frame path the box side is clamped to ``max_crop_span_s2d()``."""
    import torch

    from playground3d_tpu_torch.geometry import transforms as T
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry, state_to_im_banked
    from playground3d_tpu_torch.pipeline.tracker_state import init_track_state

    st = seed_tracks(init_track_state(cfg.max_tracks, "cpu"), n_seed)
    s6 = torch.cat([st.kf.x[:n_seed, :5], st.kf.d[:n_seed, None]], 1)
    im = state_to_im_banked(bank_from_registry(reg, device="cpu"), s6, torch.zeros(n_seed, dtype=torch.long))
    hull = T.im_hull_xyxy(im)
    scale = torch.maximum(hull[:, 2] - hull[:, 0], hull[:, 3] - hull[:, 1]) * cfg.crop_expand
    if s2d:
        from playground3d_tpu_torch.ops.crop_mxu import max_crop_span_s2d

        scale = torch.clamp(scale, max=max_crop_span_s2d())
    corner = (hull[:, :2] + hull[:, 2:]) / 2 - scale[:, None] / 2
    return torch.cat([corner, corner + scale[:, None]], 1), im


def crop_target(reg, cfg, n_seed: int, s2d: bool = False):
    """Mean crop pixel (x, y) of the seeded tracks' bottom centres, for
    crops built as the crop branch builds them."""
    boxes, im = seed_crop_boxes(reg, cfg, n_seed, s2d)
    scale = boxes[:, 2:3] - boxes[:, 0:1]
    bottom = im[:, 0:4].mean(1)
    return ((bottom - boxes[:, :2]) / scale * cfg.cs).mean(0).tolist()


def seed_tracks(state, n_seed: int):
    """Live eastbound tracks spread over the camera's view, far enough
    apart that the lifecycle's overlap pruning keeps them all."""
    import torch

    dev = state.ids.device
    n_slots = state.ids.shape[0]
    x = state.kf.x.clone()
    i = torch.arange(n_seed, device=dev, dtype=torch.float32)
    x[:n_seed, 0] = 440.0 + (i // 8) * 40.0 + (i % 8) * 5.0  # 40 ft apart in a lane
    x[:n_seed, 1] = 12.0 + (i % 8) * 12.0  # 8 lanes
    x[:n_seed, 2:5] = torch.tensor([18.0, 6.0, 5.0], device=dev)
    x[:n_seed, 5] = 80.0
    P = torch.eye(6, device=dev).expand(n_slots, 6, 6) * 0.5
    live = torch.arange(n_slots, device=dev) < n_seed
    return state._replace(
        kf=state.kf._replace(x=x, P=P.contiguous(), mask=live),
        ids=torch.where(live, torch.arange(n_slots, device=dev, dtype=torch.int32), -1).to(torch.int32),
        age=torch.where(live, 5, 0).to(torch.int32),
        conf_cnt=live.to(torch.float32),
        conf_sum=live.to(torch.float32) * 0.9,
        next_id=torch.tensor(n_seed, dtype=torch.int32, device=dev),
    )


def make_tracker(reg, det, crop, cfg, device, n_seed, graphs=True, ignore=None):
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker

    trk = MultiCameraTracker(reg, ["p1c1"], cfg=cfg, det_model=det, crop_model=crop,
                             centers=np.array([[565.0, 60.0]], np.float32), stem=det.stem,
                             crop_stem=crop.stem, device=device, graphs=graphs, ignore_polygons=ignore)
    trk.state = seed_tracks(trk.state, n_seed)
    return trk


def sources(frames: np.ndarray, t0: float = 1.6e9):
    """One camera's (frame, time) stream from [T,...] frames."""
    return [((frames[k], t0 + k / 30.0) for k in range(frames.shape[0]))]


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------


def gpu_ms(fn, iters: int = 50, flush=None) -> float:
    """Mean device time of ``fn()`` in ms from CUDA events. A long sleep is
    queued first so the host enqueues every launch before the card reaches
    them: the events then bracket device work only, not Python overhead.
    With ``flush``, a write of a buffer larger than L2 precedes each call
    (outside its events), so each call finds its inputs cold."""
    import torch

    fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    torch.cuda._sleep(int(3e8))
    for s, e in zip(starts, ends):
        if flush is not None:
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def kernel_split(fn, names, iters: int = 20, flush=None) -> dict:
    """Mean device time in ms, per call of ``fn()``, of the kernels whose
    names hold each of ``names``, from torch.profiler (None where it saw no
    device time). Kernels that overlap count each in full."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    out = {}
    for name in names:
        total = sum(e.self_device_time_total for e in kern if name in e.key)
        out[name] = total / iters / 1e3 if total > 0 else None
    return out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


KERNEL_MODULES = (
    "playground3d_tpu_torch.ops.crop_resize",
    "playground3d_tpu_torch.ops.crop_mxu",
    "playground3d_tpu_torch.ops.yuv420",
    "playground3d_tpu_torch.ops.qconv",
    "playground3d_tpu_torch.ops.nms",
    "playground3d_tpu_torch.ops.assignment",
    "playground3d_tpu_torch.ops.focal_loss",
    "playground3d_tpu_torch.ops.quantize",
)


def phase_build():
    import importlib

    libs = [importlib.import_module(m).LIB for m in KERNEL_MODULES]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as ex:
        paths = list(ex.map(lambda lib: lib.build(), libs))
    log(f"build: {len(libs)} kernel sources in {time.time() - t0:.2f} s, one nvcc each, side by side")
    for lib, p in zip(libs, paths):
        regs = sorted({int(line.split("Used ")[1].split(" registers")[0])
                       for line in lib.build_log.splitlines() if "registers" in line})
        spills = any("spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line
                     for line in lib.build_log.splitlines())
        log(f"build: {p.name}: registers per kernel {regs}, spills {'yes' if spills else 'none'}")


def crop_case(gen, device, n, hw, frame_count=1):
    """Crop boxes like the tracker's: squares of 20-600 px around points of
    the frame, a few partly or wholly outside it."""
    import torch

    h, w = hw
    c = torch.rand(n, 2, generator=gen) * torch.tensor([w, h])
    s = torch.rand(n, 1, generator=gen) * 580.0 + 20.0
    boxes = torch.cat([c - s / 2, c + s / 2], 1)
    boxes[0] = torch.tensor([-60.0, -40.0, 90.0, 110.0])
    if n > 1:
        boxes[1] = torch.tensor([w - 80.0, h - 50.0, w + 150.0, h + 180.0])
    if n > 2:
        boxes[2] = torch.tensor([w + 100.0, 10.0, w + 300.0, 210.0])
    fi = torch.randint(0, frame_count, (n,), generator=gen, dtype=torch.int32)
    return boxes.to(device).contiguous(), fi.to(device)


def edge_case(device, hw, frame_count):
    """Boxes that reach the ends of the tensor and of the frame: row 0 of
    frame 0 and the last row of the last frame, boxes as wide as the frame,
    wholly outside it, narrower than the output (each source row sampled
    several times), and one with its corners swapped."""
    import torch

    h, w = float(hw[0]), float(hw[1])
    last = frame_count - 1
    rows = [
        ([0.0, 0.0, w, 10.0], 0),  # row 0 of frame 0, as wide as the frame
        ([-5.0, -5.0, 30.0, 4.0], 0),  # the tensor's first bytes
        ([w - 40.0, h - 6.0, w + 3.0, h + 2.0], last),  # the tensor's last bytes
        ([0.0, h - 3.0, w, h], last),
        ([0.0, 0.0, w, h], last),  # the whole frame
        ([w + 100.0, 10.0, w + 300.0, 210.0], 0),  # wholly outside, to the right
        ([-300.0, -300.0, -100.0, -100.0], last),  # wholly outside, up and left
        ([w / 2, h / 2, w / 2 + 9.5, h / 2 + 7.25], 0),  # narrower than the output
        ([w * 0.7, h * 0.6, w * 0.2, h * 0.1], 0),  # corners swapped
    ]
    boxes = torch.tensor([r[0] for r in rows], dtype=torch.float32, device=device)
    return boxes, torch.tensor([r[1] for r in rows], dtype=torch.int32, device=device)


def crop_bytes(frames, boxes, fi, S) -> int:
    """Bytes the crop must move: each output byte once, each distinct input
    pixel it samples once, the boxes and indices."""
    import torch

    from playground3d_tpu_torch.ops.roi_align import _sample_axis

    C, h, w, ch = frames.shape
    j = torch.arange(S, dtype=torch.float32, device=boxes.device)
    x0, x1, _ = _sample_axis(boxes[:, 0], boxes[:, 2], j, w)
    y0, y1, _ = _sample_axis(boxes[:, 1], boxes[:, 3], j, h)
    f = fi.long().clamp(0, C - 1)[:, None, None]
    lin = [
        (f * h + yy[:, :, None]) * w + xx[:, None, :]
        for yy in (y0, y1) for xx in (x0, x1)
    ]
    distinct = torch.unique(torch.cat([t.reshape(-1) for t in lin])).numel()
    n = boxes.shape[0]
    return distinct * ch * frames.element_size() + n * S * S * ch * 4 + n * 4 * 4 + n * 4


def crop_shapes(gen, device, frames_u8, frames_f32, boxes, fi, main_boxes):
    """(label, frames, boxes, frame_idx, S) of every comparison with the
    plain version: the main path's shape in both types and at the boxes the
    main path really crops, then odd and edge shapes."""
    import torch

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(device)

    def with_edges(frames, n_random):
        C, h, w, _ = frames.shape
        rb, rfi = crop_case(gen, device, n_random, (h, w), frame_count=C)
        eb, efi = edge_case(device, (h, w), C)
        return torch.cat([rb, eb]).contiguous(), torch.cat([rfi, efi]).contiguous()

    yield "main shape uint8", frames_u8, boxes, fi, 112
    yield "main shape float32", frames_f32, boxes, fi, 112
    yield "main shape uint8, main-path boxes", frames_u8, main_boxes, fi, 112
    yield "main shape uint8, edge boxes", frames_u8, *with_edges(frames_u8, 3), 112

    # 3 frames of 517x923x3: the row pitch, 2769 bytes, is no multiple of 16
    odd = u8(3, 517, 923, 3)
    ob, ofi = with_edges(odd, 7)
    ofi[3] = 5  # out of range: clamps to the last frame, as XLA's gather does
    for S in (37, 1, 112):
        yield f"odd pitch uint8 S={S}", odd, ob, ofi, S
    yield "odd pitch float32 S=37", odd.float() / 255.0, ob, ofi, 37
    yield "odd pitch uint8 n=1", odd, ob[4:5].contiguous(), ofi[4:5].contiguous(), 37
    for ch, S in ((1, 37), (4, 112), (4, 37)):
        fr = u8(2, 211, 333, ch)
        yield f"ch={ch} uint8 S={S}", fr, *with_edges(fr, 5), S
    fr = u8(2, 130, 251, 4).float() / 255.0
    yield "ch=4 float32 S=112", fr, *with_edges(fr, 5), 112

    # views that start off a 16-byte boundary: 3 bytes (uint8), 4 bytes (float32)
    view = u8(3 + 2 * 97 * 131 * 3)[3:].view(2, 97, 131, 3)
    yield "storage offset 3 uint8", view, *with_edges(view, 4), 37
    viewf = (u8(1 + 2 * 97 * 131 * 3).float() / 255.0)[1:].view(2, 97, 131, 3)
    yield "storage offset 4 bytes float32", viewf, *with_edges(viewf, 4), 37

    # many crops (full-height tiles, several blocks an SM) and very long rows
    yield "main shape uint8, 300 crops", frames_u8, *with_edges(frames_u8, 291), 112
    long_rows = u8(1, 3, 30011, 4).float() / 255.0
    yield "long rows float32", long_rows, *with_edges(long_rows, 3), 37


def grid_sample_call(frames_u8, boxes, S):
    """The yardstick: ``F.grid_sample`` computes the same sampling (border
    clamp, half-pixel centres). It is given a frame already converted to
    float32 NCHW and a prebuilt grid, so it does less than the kernel, which
    reads uint8 NHWC and computes its own sample positions."""
    import torch
    import torch.nn.functional as F

    n = boxes.shape[0]
    j = torch.arange(S, dtype=torch.float32, device=boxes.device)
    inv = 1.0 / S
    xs = boxes[:, 0:1] + (j[None] + 0.5) * ((boxes[:, 2:3] - boxes[:, 0:1]) * inv) - 0.5
    ys = boxes[:, 1:2] + (j[None] + 0.5) * ((boxes[:, 3:4] - boxes[:, 1:2]) * inv) - 0.5
    grid = torch.stack(
        [((2 * xs + 1) / W - 1)[:, None, :].expand(n, S, S), ((2 * ys + 1) / H - 1)[:, :, None].expand(n, S, S)],
        dim=-1,
    ).contiguous()
    src = (frames_u8.float()).permute(0, 3, 1, 2).contiguous().expand(n, -1, -1, -1)
    return lambda: F.grid_sample(src, grid, mode="bilinear", padding_mode="border", align_corners=False)


def kernels_crop_resize(device, flush, noop_ms):
    """``crop_resize.cu`` (raw NHWC frames, the conv7 frame path)."""
    import torch

    from playground3d_tpu_torch.ops import crop_resize
    from playground3d_tpu_torch.ops.roi_align import crop_and_resize, crop_and_resize_plain

    gen = torch.Generator().manual_seed(3)
    S, n = 112, 32
    frames_u8 = torch.randint(0, 256, (1, H, W, 3), generator=gen, dtype=torch.uint8).to(device)
    frames_f32 = frames_u8.float() / 255.0
    boxes, fi = crop_case(gen, device, n, (H, W))
    main_boxes = seed_crop_boxes(bench_registry(), tracker_config(), N_SEED)[0].to(device).contiguous()

    # held against the plain version, a synchronize after each so that a
    # fault inside the kernel surfaces at the shape that caused it
    errs = {}
    for label, fr, b, f, s_out in crop_shapes(gen, device, frames_u8, frames_f32, boxes, fi, main_boxes):
        got = crop_and_resize(fr, b, f, s_out)
        ref = crop_and_resize_plain(fr, b, f, s_out)
        torch.cuda.synchronize()
        errs[label] = e = float((got - ref).abs().max())
        tol = CROP_TOL[str(fr.dtype).replace("torch.", "")]
        plan = crop_resize.launch_plan(s_out, b.shape[0])
        log(f"kernels: crop_and_resize {label}: frames {list(fr.shape)}, {b.shape[0]} crops of "
            f"{s_out}, {plan.tiles} tiles of {plan.tile_rows} rows, {plan.smem_bytes} B shared: "
            f"max_abs_diff vs plain {e:.3g} (tolerance {tol:g})")
        if tuple(got.shape) != (b.shape[0], s_out, s_out, fr.shape[3]) or not e <= tol:
            fail(f"crop_and_resize {label}: max_abs_diff {e} > {tol}")

    # times at the main path's shape (uint8 frame, 32 crops of 112x112), at
    # two box sets: crop_case's 20-600 px squares, and the squares the main
    # path really crops around its seeded tracks
    sets = {}
    for label, bx in (("crop_case boxes", boxes), ("main-path boxes", main_boxes)):
        def run(bx=bx):
            return crop_resize.crop_and_resize_cuda(frames_u8, bx, fi, S)

        cold = [gpu_ms(run, flush=flush) for _ in range(3)]
        kernel_ms, kernel_warm_ms = float(np.median(cold)), gpu_ms(run)
        lib = grid_sample_call(frames_u8, bx, S)
        lib_err = float((lib().permute(0, 2, 3, 1) - run()).abs().max())
        library_ms = gpu_ms(lib, flush=flush)
        plain_ms = gpu_ms(lambda: crop_and_resize_plain(frames_u8, bx, fi, S), iters=20, flush=flush)
        nbytes = crop_bytes(frames_u8, bx, fi, S)
        # per output element of a uint8 frame: two x blends of 5 float32 ops
        # (pixels to float, 1 - w, multiply, multiply-add) and one y blend of a
        # float32 and two float64 ops; the coordinate math is once per column
        # and block. Far below the byte bound either way
        elems = n * S * S * 3
        ops_s = elems * 11 / FP32_FLOPS + elems * 2 / FP64_FLOPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops_s) * 1e3
        log(f"kernels: crop_and_resize at [1,{H},{W},3] uint8, {n} crops of {S}x{S}, {label} "
            f"(mean side {float((bx[:, 2] - bx[:, 0]).mean()):.0f} px): kernel {kernel_ms * 1e3:.2f} us "
            f"(L2 cold, median of 3 x 50: {' '.join(f'{c * 1e3:.2f}' for c in cold)}; "
            f"{kernel_warm_ms * 1e3:.2f} us warm), grid_sample on a float32 NCHW frame with a "
            f"prebuilt grid {library_ms * 1e3:.2f} us (max_abs_diff vs kernel {lib_err:.3g}), "
            f"plain version {plain_ms * 1e3:.2f} us, "
            f"bound {bound_ms * 1e3:.3f} us ({nbytes} bytes at 3.35 TB/s), "
            f"{bound_ms / kernel_ms * 100:.1f}% of bound")
        sets[label] = dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms)
    # the record is of the boxes the main path crops; crop_case's times stay
    # on the log line above, for comparison with the first version's
    return {
        "name": "crop_and_resize",
        "route": "cuda",
        "source": "playground3d_tpu_torch/csrc/crop_resize.cu",
        "replaces": "playground3d_tpu/ops/pallas/crop_resize.py:57",
        "max_abs_err": max(errs.values()),
        "bound_by": "bytes",
        **sets["main-path boxes"],
    }


# ---- crop_resize_s2d.cu -----------------------------------------------------


def s2d_box_sets(gen, device, hw, frame_count, main_boxes):
    """(label, boxes, cam_idx) that between them sample every pyramid level:
    spans up to 248 px (level 0), ``crop_case``'s 20-600 px squares (levels 0
    to 2), the main path's own boxes (clamped to 992 px: level 2), the level
    edges (248, 496, 992 px and one ulp either side), and boxes partly
    outside the frame, on its last cell row and column, and swapped."""
    import torch

    h, w = hw
    n = main_boxes.shape[0]

    def cams(k):
        return torch.randint(0, frame_count, (k,), generator=gen, dtype=torch.int32).to(device)

    c = torch.rand(n, 2, generator=gen) * torch.tensor([w, h])
    s0 = torch.rand(n, 1, generator=gen) * 228.0 + 20.0
    yield "spans <= 248 px (level 0)", torch.cat([c - s0 / 2, c + s0 / 2], 1).to(device).contiguous(), cams(n)
    cb, _ = crop_case(gen, device, n, hw)
    yield "crop_case boxes (levels 0-2)", cb, cams(n)
    yield "main-path boxes (992 px, level 2)", main_boxes, cams(n)
    spans = []
    for base in (248.0, 496.0, 992.0):
        f = np.float32(base)
        spans += [np.nextafter(f, np.float32(0)), f, np.nextafter(f, np.float32(4000))]
    sp = torch.tensor(np.array(spans, np.float32))
    yield ("level-edge spans", torch.stack([0 * sp + 40.0, 0 * sp + 30.0, 40.0 + sp, 30.0 + sp * 0.7], 1)
           .to(device).contiguous(), cams(len(spans)))
    eb, _ = edge_case(device, hw, frame_count)
    last = torch.tensor([[w - 4.0, h - 4.0, w, h], [w - 300.0, h - 5.0, w + 40.0, h + 200.0],
                         [0.0, h - 1000.0, 992.0, h - 8.0], [w - 992.0, 0.0, w, 992.0]], device=device)
    yield "edge boxes", torch.cat([eb, last]).contiguous(), cams(eb.shape[0] + 4)
    yield from s2d_far_box_sets(gen, device, hw, frame_count)


def s2d_far_box_sets(gen, device, hw, frame_count, n=32):
    """(label, boxes, cam_idx) far from the main path's: upsampling (spans of
    8-60 px, many output rows on one source row) and spans of 2-4x the top
    level's cap at the default window (the rows of a tile lie far apart;
    taps past the window have weight zero), some with swapped corners."""
    import torch

    h, w = hw
    c = torch.rand(n, 2, generator=gen) * torch.tensor([w, h])
    cam = torch.randint(0, frame_count, (n,), generator=gen, dtype=torch.int32).to(device)
    s = torch.rand(n, 2, generator=gen) * 52.0 + 8.0
    yield "upsampling spans 8-60 px", torch.cat([c - s / 2, c + s / 2], 1).to(device).contiguous(), cam
    s = (torch.rand(n, 2, generator=gen) * 2.0 + 2.0) * 992.0
    b = torch.cat([c - s / 2, c + s / 2], 1)
    b[::4] = b[::4][:, [2, 3, 0, 1]]  # corners swapped
    yield "spans 2-4x the top level's cap", b.to(device).contiguous(), cam


def s2d_crop_bytes(frames, boxes, cam, S, win_cells=64, n_levels=3, level_bytes=2) -> int:
    """Bytes the s2d crop must move: the frames read once and the levels
    written once for the pyramid, each distinct cell the samples touch read
    once (48 values of its level's type), the crops written, the boxes."""
    import torch

    from playground3d_tpu_torch.ops import crop_mxu

    C, Hs, Ws, _ = frames.shape
    shapes = crop_mxu.level_shapes(Hs, Ws, n_levels)
    pyramid = sum(C * hl * wl * 48 * level_bytes for hl, wl in shapes[1:])
    level = crop_mxu._levels_of(boxes, win_cells, n_levels)
    ls = torch.exp2(level.float())
    hl = torch.tensor([s[0] for s in shapes], device=boxes.device)[level]
    wl = torch.tensor([s[1] for s in shapes], device=boxes.device)[level]
    xs = crop_mxu._sample_positions(boxes[:, 0], boxes[:, 2], ls, S, (wl * 4).float())
    ys = crop_mxu._sample_positions(boxes[:, 1], boxes[:, 3], ls, S, (hl * 4).float())
    cells = 0
    for b in range(boxes.shape[0]):
        cx = torch.unique(torch.cat([xs[b].floor().long() >> 2, (xs[b].floor().long() + 1).clamp(max=int(wl[b]) * 4 - 1) >> 2]))
        cy = torch.unique(torch.cat([ys[b].floor().long() >> 2, (ys[b].floor().long() + 1).clamp(max=int(hl[b]) * 4 - 1) >> 2]))
        cells += int(cx.numel() * cy.numel()) * 48 * (frames.element_size() if int(level[b]) == 0 else level_bytes)
    n = boxes.shape[0]
    return frames.numel() * frames.element_size() + pyramid + cells + n * S * S * 3 * 4 + n * 20


def pooled_grid_sample_call(frames_s2d_u8, boxes, S, level=2):
    """The yardstick for the s2d crop at boxes that all sample ``level``:
    ``avg_pool2d`` down to that level, then ``F.grid_sample``. It is given
    the frame already unpacked to float32 NCHW and a prebuilt grid, and it
    neither normalizes nor rounds to bfloat16."""
    import torch
    import torch.nn.functional as F

    from playground3d_tpu_torch.ops.crop_mxu import _pixels

    img = _pixels(frames_s2d_u8).float().permute(0, 3, 1, 2).contiguous()  # [1,3,H,W]
    hl, wl = img.shape[2] >> level, img.shape[3] >> level
    n = boxes.shape[0]
    j = torch.arange(S, dtype=torch.float32, device=boxes.device)
    b = boxes / float(2 ** level)
    xs = b[:, 0:1] + (j[None] + 0.5) * ((b[:, 2:3] - b[:, 0:1]) / S) - 0.5
    ys = b[:, 1:2] + (j[None] + 0.5) * ((b[:, 3:4] - b[:, 1:2]) / S) - 0.5
    grid = torch.stack(
        [((2 * xs + 1) / wl - 1)[:, None, :].expand(n, S, S), ((2 * ys + 1) / hl - 1)[:, :, None].expand(n, S, S)],
        dim=-1,
    ).contiguous()

    def call():
        lv = img
        for _ in range(level):
            lv = F.avg_pool2d(lv, 2)
        return F.grid_sample(lv.expand(n, -1, -1, -1), grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    return call


def kernels_crop_s2d(device, flush, noop_ms):
    """``crop_resize_s2d.cu`` (s2d-packed frames, the shipped frame path)."""
    import torch

    from playground3d_tpu_torch.ops import crop_mxu

    gen = torch.Generator().manual_seed(4)
    S, n = 112, 32
    cfg = tracker_config()
    main_boxes = seed_crop_boxes(bench_registry(), cfg, N_SEED, s2d=True)[0].to(device).contiguous()

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8).to(device)

    frames1, frames2 = u8(1, H // 4, W // 4, 48), u8(2, H // 4, W // 4, 48)
    errs = {}

    def hold(label, fr, b, cam, tol, **kw):
        got = crop_mxu.crop_and_resize_s2d(fr, b, cam, **kw)
        ref = crop_mxu.crop_and_resize_s2d_plain(fr, b, cam, **kw)
        torch.cuda.synchronize()
        e = float((got - ref).abs().max())
        errs[label] = e / max(float(ref.abs().max()), 1e-30) if tol else e
        log(f"kernels: crop_and_resize_s2d {label}: frames {list(fr.shape)} {str(fr.dtype)[6:]}, "
            f"{b.shape[0]} crops -> {list(got.shape)}: max_abs_diff vs plain {e:.3g} "
            f"({'tolerance ' + format(tol, 'g') + ' of the largest value' if tol else 'must be 0'})")
        if got.shape != ref.shape or not e <= tol * float(ref.abs().max()):
            fail(f"crop_and_resize_s2d {label}: max_abs_diff {e}")

    # the compute type of the tracker is bfloat16: kernel and plain version
    # do the same rounded operations, so they must agree exactly. At float32
    # the plain version's two products run through a library matmul whose
    # sums may contract, so 1e-6 of the largest value is allowed there
    for cams_label, fr in (("1 camera", frames1), ("2 cameras", frames2)):
        for label, b, cam in s2d_box_sets(gen, device, (H, W), fr.shape[0], main_boxes):
            hold(f"uint8 normalize bf16 s2d, {cams_label}, {label}", fr, b, cam, 0.0, out_size=S, normalize=True)
    ff = frames2.float() / 255.0
    for label, b, cam in s2d_box_sets(gen, device, (H, W), 2, main_boxes):
        hold(f"float bf16 s2d, 2 cameras, {label}", ff, b, cam, 0.0, out_size=S)
    cb, _ = crop_case(gen, device, n, (H, W))
    cam2 = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int32).to(device)
    for layout in ("hwc", "chw"):
        hold(f"uint8 normalize bf16 {layout}, crop_case boxes", frames2, cb, cam2, 0.0, out_size=S,
             layout=layout, normalize=True)
        hold(f"float bf16 {layout}, crop_case boxes", ff, cb, cam2, 0.0, out_size=37, layout=layout)
        # S = 1 and 37: column groups with a tail, scalar stores
        for size in (1, 37):
            for label, b, cam in s2d_far_box_sets(gen, device, (H, W), 2):
                hold(f"uint8 normalize bf16 {layout} S={size}, 2 cameras, {label}", frames2, b, cam, 0.0,
                     out_size=size, layout=layout, normalize=True)
    for label, b, cam in s2d_far_box_sets(gen, device, (H, W), 2):
        hold(f"float float32 hwc, 2 cameras, {label}", ff, b, cam, 1e-6, out_size=S, layout="hwc",
             dtype=torch.float32)
    for layout in ("s2d", "hwc", "chw"):
        hold(f"uint8 normalize float32 {layout}, crop_case boxes", frames2, cb, cam2, 1e-6, out_size=S,
             layout=layout, dtype=torch.float32, normalize=True)
    hold("float float32 s2d, crop_case boxes", ff, cb, cam2, 1e-6, out_size=S, dtype=torch.float32)
    # odd cell counts (67 x 101 -> 33 x 50 -> 16 x 25) and frames smaller than the window
    odd = u8(2, 67, 101, 48)
    ob = torch.cat([crop_case(gen, device, 12, (268, 404))[0], edge_case(device, (268, 404), 2)[0]]).contiguous()
    ocam = torch.randint(0, 2, (ob.shape[0],), generator=gen, dtype=torch.int32).to(device)
    hold("uint8 normalize bf16 s2d, odd cells, window 16", odd, ob, ocam, 0.0, out_size=28, win_cells=16, normalize=True)
    hold("uint8 normalize bf16 hwc, odd cells, window 64 (frame below the window)", odd, ob, ocam, 0.0,
         out_size=37, layout="hwc", normalize=True)
    hold("uint8 bf16 s2d, one level", odd, ob, ocam, 0.0, out_size=28, win_cells=16, n_levels=1)
    # five levels: levels 3 and 4 built from the ones above, as they are, while
    # the pyramid holds them normalized; float frames normalized at bfloat16
    # (each value checked for a near-zero quotient)
    hold("uint8 normalize bf16 s2d, five levels, window 16", frames2, cb, cam2, 0.0, out_size=S, win_cells=16,
         n_levels=5, normalize=True)
    hold("uint8 bf16 hwc, five levels, window 16", frames2, cb, cam2, 0.0, out_size=37, layout="hwc", win_cells=16,
         n_levels=5)
    hold("float normalize float32 s2d, five levels, window 16", ff, cb, cam2, 1e-6, out_size=S, win_cells=16,
         n_levels=5, dtype=torch.float32, normalize=True)
    hold("float normalize bf16 s2d, crop_case boxes", ff, cb, cam2, 0.0, out_size=S, normalize=True)
    # staged rows wider than 85 cells (a thread stages two cells of a row) and
    # more than 48 KB of shared memory a block (the launcher raises the limit)
    for dtype, tol in ((torch.bfloat16, 0.0), (torch.float32, 1e-6)):
        hold(f"uint8 normalize {str(dtype)[6:]} s2d, one level, window 128", frames2, cb, cam2, tol, out_size=S,
             win_cells=128, n_levels=1, dtype=dtype, normalize=True)

    # times at the main path's call: uint8 [1,270,480,48], 32 boxes of 992 px,
    # normalize, bfloat16, packed crops
    cam = torch.zeros(n, dtype=torch.int32, device=device)

    def run():
        return crop_mxu.crop_and_resize_s2d_cuda(frames1, main_boxes, cam, S, normalize=True)

    cold = [gpu_ms(run, flush=flush) for _ in range(3)]
    kernel_ms, warm_ms = float(np.median(cold)), gpu_ms(run)
    split = kernel_split(run, ("pyramid_kernel", "sample_kernel"), flush=flush)
    case_cold = float(np.median([
        gpu_ms(lambda: crop_mxu.crop_and_resize_s2d_cuda(frames1, cb, cam, S, normalize=True), flush=flush)
        for _ in range(3)]))
    plain_ms = gpu_ms(lambda: crop_mxu.crop_and_resize_s2d_plain(frames1, main_boxes, cam, S, normalize=True),
                      iters=10, flush=flush)
    lib = pooled_grid_sample_call(frames1, main_boxes, S)
    library_ms = gpu_ms(lib, flush=flush)
    nbytes = s2d_crop_bytes(frames1, main_boxes, cam, S)
    # per output element: four pixels normalized (3 ops each) and three
    # two-term products: ~24 float32 ops, far below the byte bound
    bound_ms = max(nbytes / HBM_BYTES_PER_S, n * S * S * 3 * 24 / FP32_FLOPS) * 1e3
    log(f"kernels: crop_and_resize_s2d at [1,{H // 4},{W // 4},48] uint8, {n} crops of {S}x{S} (packed), "
        f"main-path boxes: pyramid + sampling (2 kernels, one call) {kernel_ms * 1e3:.2f} us "
        f"(L2 cold, median of 3 x 50: {' '.join(f'{c * 1e3:.2f}' for c in cold)}; {warm_ms * 1e3:.2f} us warm; "
        f"an empty kernel {noop_ms * 1e3:.2f} us; by kernel under the profiler, L2 cold, overlapping: "
        + ", ".join(f"{k} {'not measured' if v is None else format(v * 1e3, '.2f') + ' us'}" for k, v in split.items())
        + f"; the whole call at crop_case boxes {case_cold * 1e3:.2f} us), "
        f"avg_pool2d x 2 + grid_sample on the unpacked float32 frame "
        f"{library_ms * 1e3:.2f} us, plain version {plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.3f} us "
        f"({nbytes} bytes at 3.35 TB/s), {bound_ms / kernel_ms * 100:.1f}% of bound")
    return {
        "name": "crop_and_resize_s2d", "route": "cuda",
        "source": "playground3d_tpu_torch/csrc/crop_resize_s2d.cu",
        "replaces": "playground3d_tpu/ops/crop_mxu.py:87",
        "max_abs_err": max(errs.values()), "bound_by": "bytes",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
    }


# ---- yuv420_s2d.cu ----------------------------------------------------------


def kernels_yuv(device, flush, noop_ms):
    """``yuv420_s2d.cu``: a clip of planar YUV420 bytes to packed RGB."""
    import torch

    from playground3d_tpu_torch.ops import yuv420

    gen = torch.Generator().manual_seed(6)
    worst = 0
    for t, c, h, w in ((2, 2, 36, 52), (1, 3, 8, 4), (T_CLIP, 1, H, W)):
        buf = torch.randint(0, 256, (t, c, h * w * 3 // 2), generator=gen, dtype=torch.uint8).to(device)
        got = yuv420.yuv420_flat_to_s2d(buf, (h, w))
        ref = yuv420.yuv420_flat_to_s2d_plain(buf, (h, w))
        torch.cuda.synchronize()
        differ = int((got != ref).sum())
        worst = max(worst, int((got.int() - ref.int()).abs().max()))
        log(f"kernels: yuv420_flat_to_s2d [{t},{c},{h * w * 3 // 2}] ({h}x{w}) -> {list(got.shape)}: "
            f"{differ} of {got.numel()} bytes differ from the plain version (must be 0)")
        if got.shape != ref.shape or differ:
            fail(f"yuv420_flat_to_s2d {t}x{c}x{h}x{w}: {differ} bytes differ")
        del ref
    cold = [gpu_ms(lambda: yuv420.yuv420_flat_to_s2d_cuda(buf, (H, W)), iters=20, flush=flush) for _ in range(3)]
    kernel_ms = float(np.median(cold))
    warm_ms = gpu_ms(lambda: yuv420.yuv420_flat_to_s2d_cuda(buf, (H, W)), iters=20)
    plain_ms = gpu_ms(lambda: yuv420.yuv420_flat_to_s2d_plain(buf, (H, W)), iters=3, flush=flush)
    nbytes = buf.numel() + T_CLIP * H * W * 3
    # per pixel ~14 float32 ops (three scalings shared by four pixels, the
    # colour matrix, + 0.5 and clamp): below the byte bound
    bound_ms = max(nbytes / HBM_BYTES_PER_S, T_CLIP * H * W * 14 / FP32_FLOPS) * 1e3
    log(f"kernels: yuv420_flat_to_s2d at [{T_CLIP},1,{H * W * 3 // 2}] uint8 (one clip): kernel "
        f"{kernel_ms * 1e3:.1f} us (L2 cold, median of 3 x 20: {' '.join(f'{c * 1e3:.1f}' for c in cold)}; "
        f"{warm_ms * 1e3:.1f} us warm; an empty kernel {noop_ms * 1e3:.2f} us), plain version "
        f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.1f} us ({nbytes} bytes at 3.35 TB/s), "
        f"{bound_ms / kernel_ms * 100:.1f}% of bound; no single library call computes it")
    return {
        "name": "yuv420_flat_to_s2d", "route": "cuda",
        "source": "playground3d_tpu_torch/csrc/yuv420_s2d.cu",
        "replaces": "playground3d_tpu/pipeline/multi_cam.py:62",
        "max_abs_err": float(worst), "bound_by": "bytes",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
    }


# ---- qconv.cu ---------------------------------------------------------------


QCONV_CHECK_SHAPES = (  # N, H, W, Cin, Cout, k, stride
    (1, 135, 240, 256, 256, 3, 1), (1, 135, 67, 128, 72, 3, 1), (2, 67, 135, 256, 108, 3, 2),
    (1, 135, 240, 512, 128, 1, 1), (1, 67, 67, 1024, 256, 1, 2), (1, 270, 480, 256, 64, 1, 1),
    (1, 17, 30, 2048, 256, 3, 2), (32, 7, 7, 512, 512, 3, 1), (1, 20, 30, 144, 40, 3, 1),
    # split K: FPN P6 (34x60 2048->256 s2), a 1x1 crop map, 144 steps over 29 splits, 256-wide tiles split;
    # a partial channel chunk
    (1, 34, 60, 2048, 256, 3, 2), (32, 1, 1, 256, 256, 3, 1), (1, 7, 9, 2048, 256, 3, 1),
    (1, 20, 30, 2048, 2048, 3, 1), (1, 9, 15, 48, 256, 3, 1),
    # narrow N: 108 and 72 filters at N = 112 and 80 on small maps, and an odd filter count (scalar stores)
    (1, 34, 60, 256, 108, 3, 1), (32, 4, 4, 256, 72, 3, 1), (1, 7, 9, 32, 33, 3, 1),
)


def shipped_models(device):
    """The main path's models, built once: (registry, config, float s2d
    pair, quantized pair, the packed calibration frame)."""
    import torch

    if "models" not in _CACHE:
        reg, cfg = bench_registry(), tracker_config()
        det, crop = build_models(device, crop_target(reg, cfg, N_SEED, s2d=True), stem="s2d")
        raw = np.random.default_rng(1).integers(0, 256, (1, H, W, 3), dtype=np.uint8)
        calib = torch.as_tensor(pack_frames(raw)[0]).to(device)
        det_q, crop_q = quantize_pair(det, crop, calib, cfg.cs)
        _CACHE["models"] = (reg, cfg, (det, crop), (det_q, crop_q), calib)
    return _CACHE["models"]


_CACHE: dict = {}


def record_qconv_shapes(device):
    """Every call of the int8 conv kernel in one detect frame and one crop
    frame of the main path, by shape: {branch: {(N,H,W,Cin,Cout,k,stride,
    pads, relu, has_offset, int8_out, residual): launches}}, ``pads`` the
    call's ((top, bottom), (left, right)) as given or the ``"SAME"`` pads
    of its input, residual "none", "int8" or "bf16" (a block's tail fused
    into its last conv)."""
    import collections

    import torch

    from playground3d_tpu_torch.models import quant
    from playground3d_tpu_torch.models.retinanet import detect_multiframe, localize
    from playground3d_tpu_torch.ops import qconv as QC

    if "qconv_shapes" in _CACHE:
        return _CACHE["qconv_shapes"]
    reg, cfg, _, (det_q, crop_q), calib = shipped_models(device)
    seen = {"detect": collections.Counter(), "crop": collections.Counter()}
    real = quant.qconv  # the one entry models/quant.py calls the int8 conv through
    branch = ["detect"]

    def recording(x, wq, scale, offset=None, stride=1, relu=False, emit_xs=None, res=None, res_xs=None, pads=None):
        kind = "none" if res is None else ("int8" if res.dtype == torch.int8 else "bf16")
        pads = QC.explicit_pads(x.shape[1], x.shape[2], wq.shape[1], stride, pads)
        key = (*x.shape, wq.shape[0], wq.shape[1], stride, pads, bool(relu), offset is not None, emit_xs is not None,
               kind)
        seen[branch[0]][key] += 1
        return real(x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)

    quant.qconv = recording
    try:
        detect_multiframe(det_q, calib[None], pre_topk=cfg.pre_topk, max_dets=cfg.max_dets,
                          min_level=cfg.det_min_level)
        branch[0] = "crop"
        localize(crop_q, torch.zeros((cfg.crop_slots, cfg.cs // 4, cfg.cs // 4, 48), device=device))
        torch.cuda.synchronize()
    finally:
        quant.qconv = real
    _CACHE["qconv_shapes"] = seen
    return seen


def qconv_blocks(device):
    """Two whole bottleneck blocks of the quantized detector at 1080p, the
    tail fused into conv3's epilogue on the card, against the unfused chain
    of plain convs on the card: layer2[1] (135x240x512, identity residual:
    int8 in, int8 out) and layer2[0] (270x480x256 in, ``down_conv``'s
    bfloat16 residual, stride 2). Every value must be equal."""
    import torch

    from playground3d_tpu_torch.models import quant as Q
    from playground3d_tpu_torch.ops import qconv as QC

    _, _, _, (det_q, _), _ = shipped_models(device)
    bb = det_q.backbone
    gen = torch.Generator().manual_seed(9)
    for name, bp, hw, out_xs in (("layer2[1]", bb.layer2[1], (135, 240), bb.layer2[2].conv1.xs),
                                 ("layer2[0]", bb.layer2[0], (270, 480), bb.layer2[1].conv1.xs)):
        cin = bp.conv1.w.shape[1]
        q = torch.randint(-127, 128, (1, *hw, cin), generator=gen, dtype=torch.int8).to(device)
        cur = ("i8", q.permute(0, 3, 1, 2), bp.conv1.xs)
        launches = QC.qconv_cuda.launches
        got = Q._chain_block(bp, cur, out_xs, basic=False)
        fused_launches = QC.qconv_cuda.launches - launches
        real = Q.qconv
        Q.qconv = QC.qconv_plain
        try:
            want = Q._chain_block_unfused(bp, cur, out_xs, basic=False)
        finally:
            Q.qconv = real
        torch.cuda.synchronize()
        differ = int((got[1].float() != want[1].float()).sum())
        log(f"kernels: qconv whole bottleneck {name} on [1,{hw[0]},{hw[1]},{cin}] int8 -> {list(got[1].shape)} "
            f"{str(got[1].dtype)[6:]}: fused on the card ({fused_launches} qconv launches) against the unfused "
            f"plain chain on the card: {differ} of {got[1].numel()} values differ (must be 0)")
        if got[0] != want[0] or got[1].shape != want[1].shape or differ:
            fail(f"qconv bottleneck {name}: fused differs from unfused ({differ} values)")


def kernels_qconv(device, flush, noop_ms):
    """``qconv.cu``: exactness at odd and edge shapes (accumulators, the
    eight plain epilogues, the residual epilogues) and on whole blocks, then
    the time of every conv shape that the quantized pair launches on the
    main path."""
    import torch
    import torch.nn.functional as F

    from playground3d_tpu_torch.ops import qconv as QC

    gen = torch.Generator().manual_seed(8)

    def operands(N, Hh, Ww, cin, cout, k):
        x = torch.randint(-127, 128, (N, Hh, Ww, cin), generator=gen, dtype=torch.int8).to(device)
        wq = torch.randint(-127, 128, (cout, k, k, cin), generator=gen, dtype=torch.int8).to(device)
        scale = (torch.rand(cout, generator=gen) * 2e-5 + 1e-6).to(device)
        offset = torch.randn(cout, generator=gen).to(device)
        return x, wq, scale, offset

    def residual(kind, shape):
        if kind == "int8":
            return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8).to(device), res_xs
        if kind == "bf16":
            return (torch.randn(shape, generator=gen) * 3).to(torch.bfloat16).to(device), None
        return None, None

    xs = torch.tensor(0.043, device=device)
    res_xs = torch.tensor(0.0371, device=device)
    worst = 0.0
    uneven = 0
    for N, Hh, Ww, cin, cout, k, stride in QCONV_CHECK_SHAPES:
        x, wq, scale, offset = operands(N, Hh, Ww, cin, cout, k)
        plan = QC.launch_plan(N, Hh, Ww, cin, cout, k, stride)
        uneven += plan.steps % plan.splits != 0
        acc = QC.qconv_cuda(x, wq, scale, offset, stride, store=QC.ACC)
        ref = QC.conv_int32_plain(x, wq, stride)
        torch.cuda.synchronize()
        acc_equal = bool(torch.equal(acc, ref))
        differ = res_differ = 0
        for relu in (False, True):
            for emit in (None, xs):
                for off in (offset, None):
                    got = QC.qconv(x, wq, scale, off, stride, relu, emit)
                    want = QC.epilogue_plain(ref, scale, off, relu, emit)
                    torch.cuda.synchronize()
                    differ += int((got.float() != want.float()).sum())
                    worst = max(worst, float((got.float() - want.float()).abs().max()))
        for kind in ("int8", "bf16"):
            res, rxs = residual(kind, tuple(ref.shape))
            for emit in (None, xs):
                got = QC.qconv(x, wq, scale, offset, stride, False, emit, res, rxs)
                want = QC.epilogue_plain(ref, scale, offset, False, emit, res, rxs)
                torch.cuda.synchronize()
                res_differ += int((got.float() != want.float()).sum())
                worst = max(worst, float((got.float() - want.float()).abs().max()))
        log(f"kernels: qconv x [{N},{Hh},{Ww},{cin}] w [{cout},{k},{k},{cin}] stride {stride} (tile N {plan.tile_n}, "
            f"{plan.tiles_m * plan.tiles_n} tiles, K {plan.steps} steps over {plan.splits} splits): int32 "
            f"accumulators {'equal' if acc_equal else 'DIFFER'} (max |acc| {int(ref.abs().max())}), int8 and "
            f"bfloat16 outputs over 8 epilogues: {differ} values differ, over 4 residual epilogues (int8 and "
            f"bfloat16 residual, int8 and bfloat16 out): {res_differ} differ (must be 0)")
        if not acc_equal or differ or res_differ:
            fail(f"qconv {N}x{Hh}x{Ww}x{cin}->{cout} k{k} s{stride}: accumulators equal={acc_equal}, "
                 f"{differ} + {res_differ} outputs differ")
    if not uneven:
        fail("qconv: no check shape splits K unevenly")
    qconv_blocks(device)

    # every shape of the main path, from a hook on the wrapper
    seen = record_qconv_shapes(device)
    shapes = sorted(set(seen["detect"]) | set(seen["crop"]))
    rows = []
    host_us = None
    for key in shapes:
        N, Hh, Ww, cin, cout, k, stride, pads, relu, has_off, int8_out, res_kind = key
        x, wq, scale, offset = operands(N, Hh, Ww, cin, cout, k)
        off, emit = (offset if has_off else None), (xs if int8_out else None)
        plan = QC.launch_plan(N, Hh, Ww, cin, cout, k, stride, pads)
        res, rxs = residual(res_kind, (N, plan.ho, plan.wo, cout))

        def run():
            return QC.qconv_cuda(x, wq, scale, off, stride, relu, emit, res, rxs, pads=pads)

        kernel_ms = gpu_ms(run, iters=20)
        ref = QC.conv_int32_plain(x, wq, stride, pads)
        got = run()
        if not torch.equal(got, QC.epilogue_plain(ref, scale, off, relu, emit, res, rxs)):
            fail(f"qconv main-path shape {key}: output differs from the plain version")
        if host_us is None:  # the host's part of a launch: wrapper, checks, plan, cached weight map, launch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                run()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
        plain_ms = gpu_ms(lambda: QC.qconv_plain(x, wq, scale, off, stride, relu, emit, res, rxs, pads), iters=3)
        # the library call: the bf16 channels-last convolution of the same
        # shape (what the float path runs there), operands already cast and padded
        ph, pw = pads
        xb = F.pad(x.permute(0, 3, 1, 2).to(torch.bfloat16), (pw[0], pw[1], ph[0], ph[1])).contiguous(
            memory_format=torch.channels_last)
        wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        library_ms = gpu_ms(lambda: F.conv2d(xb, wb, stride=stride), iters=20)
        # a second yardstick where one exists: at k = 1, stride 1 the int32
        # accumulators are one int8 matrix product (epilogue excluded)
        int_mm_ms = None
        if k == 1 and stride == 1 and N * Hh * Ww > 16 and pads == ((0, 0), (0, 0)):
            xm, wm = x.view(N * Hh * Ww, cin), wq.view(cout, cin).t()
            if not torch.equal(torch._int_mm(xm, wm).view(ref.shape), ref):
                fail(f"qconv main-path shape {key}: torch._int_mm differs from the plain accumulators")
            int_mm_ms = gpu_ms(lambda: torch._int_mm(xm, wm), iters=20)
        ho, wo = got.shape[1], got.shape[2]
        macs = N * ho * wo * cout * cin * k * k
        nbytes = (x.numel() + wq.numel() + got.numel() * got.element_size() + cout * 8
                  + (res.numel() * res.element_size() if res is not None else 0))
        t_ops, t_bytes = 2 * macs / INT8_OPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(
            N=N, H=Hh, W=Ww, Cin=cin, Cout=cout, k=k, stride=stride, pads=pads, relu=relu, offset=has_off,
            out="int8" if int8_out else "bf16", residual=res_kind, per_detect=seen["detect"][key],
            per_crop=seen["crop"][key], tile_n=plan.tile_n, splits=plan.splits, macs=macs, ms=kernel_ms,
            plain_ms=plain_ms, library_ms=library_ms, int_mm_ms=int_mm_ms,
            bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
        ))
        del x, wq, ref, got, xb, wb, res
    log(f"kernels: qconv on the main path: {len(rows)} distinct calls (warm, mean of 20 between CUDA events; "
        f"library = F.conv2d bf16 channels_last on cast and padded operands; int_mm = torch._int_mm, the "
        f"accumulators alone, at k = 1 stride 1; an empty kernel {noop_ms * 1e3:.2f} us; host time of one "
        f"launch {host_us:.1f} us)")
    log("kernels: qconv   N   H   W  Cin Cout k s relu off  out  res |det crop| tileN splits  kernel us  "
        "bf16 conv us  int_mm us  plain us  bound us (by)   TMAC/s")
    for r in rows:
        mm = f"{r['int_mm_ms'] * 1e3:10.2f}" if r["int_mm_ms"] is not None else f"{'-':>10s}"
        log(f"kernels: qconv {r['N']:3d} {r['H']:3d} {r['W']:3d} {r['Cin']:4d} {r['Cout']:4d} {r['k']} {r['stride']} "
            f"{int(r['relu']):4d} {int(r['offset']):3d} {r['out']:>4s} {r['residual']:>4s} |{r['per_detect']:3d} "
            f"{r['per_crop']:4d}| {r['tile_n']:5d} {r['splits']:6d} {r['ms'] * 1e3:10.2f} {r['library_ms'] * 1e3:13.2f} "
            f"{mm} {r['plain_ms'] * 1e3:9.1f} {r['bound_ms'] * 1e3:9.3f} ({r['bound_by'][:5]}) "
            f"{r['macs'] / r['ms'] / 1e9:8.2f}")
    totals = {}
    for branch, per in (("detect", "per_detect"), ("crop", "per_crop")):
        tot = {f: sum(r[per] * r[f] for r in rows) for f in ("ms", "plain_ms", "library_ms", "bound_ms", "macs")}
        tot["launches"] = sum(r[per] for r in rows)
        tot["fused"] = sum(r[per] for r in rows if r["residual"] != "none")
        tot["by_ops"] = sum(r[per] * r["bound_ms"] for r in rows if r["bound_by"] == "operations")
        mm = [r for r in rows if r[per] and r["int_mm_ms"] is not None]
        tot["int_mm"] = (sum(r[per] * r["ms"] for r in mm), sum(r[per] * r["int_mm_ms"] for r in mm), len(mm))
        totals[branch] = tot
        log(f"kernels: qconv total per {branch} frame: {tot['launches']} launches ({tot['fused']} with a block's "
            f"tail fused), {tot['macs'] / 1e9:.1f} GMAC, kernel {tot['ms']:.3f} ms, bf16 convs of the same shapes "
            f"{tot['library_ms']:.3f} ms, plain {tot['plain_ms']:.1f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['by_ops'] / max(tot['bound_ms'], 1e-12) * 100:.0f}% of it from shapes bound by operations), "
            f"{tot['bound_ms'] / tot['ms'] * 100:.1f}% of bound; the {tot['int_mm'][2]} k=1 stride-1 shapes: kernel "
            f"{tot['int_mm'][0]:.3f} ms, torch._int_mm {tot['int_mm'][1]:.3f} ms")
    os.makedirs("_outputs", exist_ok=True)
    with open(os.path.join("_outputs", "qconv_shapes.json"), "w") as fh:
        json.dump({"rows": rows, "totals": totals, "host_us_per_launch": host_us}, fh, indent=1)
    det = totals["detect"]
    # the record is of one detect frame's int8 convs, all shapes together
    return {
        "name": "qconv", "route": "cuda", "source": "playground3d_tpu_torch/csrc/qconv.cu",
        "replaces": "playground3d_tpu/models/quant.py:180",
        "max_abs_err": worst,
        "bound_by": "operations" if det["by_ops"] >= 0.5 * det["bound_ms"] else "bytes",
        "ms": det["ms"], "plain_ms": det["plain_ms"], "library_ms": det["library_ms"], "bound_ms": det["bound_ms"],
    }


# ---- quantize.cu ---------------------------------------------------------------

QUANTIZE_EDGE_SCALES = (0.0625, 0.043, 7.874015748031496e-11, 1.0, 255.0 / 127.0,  # powers of two keep ties exact
                        0.0, -0.5, 1e-40, float("inf"), float("nan"))  # scales that take the division everywhere


def quantize_counts(device):
    """The quantize steps (``models/quant.py::_quantize_act``) of one detect
    frame and one crop frame of the main path -> {"detect": n, "crop": n};
    the count does not depend on the number of cameras."""
    if "quantize_counts" not in _CACHE:
        _CACHE["quantize_counts"] = {b: len(calls) for b, calls in quantize_inputs(device, cameras=1)[0].items()}
    return _CACHE["quantize_counts"]


def check_quantize_launches(tag: str, launches: dict, device) -> None:
    """The quantize launches of a run against the forwards its other
    launches imply: one ``crop_and_resize_s2d`` a crop frame, so
    ``qconv`` = detect forwards x its launches a detect forward (a mesh
    shard's forward counted apiece) + crop frames x its launches a crop
    frame; ``quantize`` must be those detect forwards x 25 + crop frames
    x 33 (:func:`quantize_counts`)."""
    seen, counts = record_qconv_shapes(device), quantize_counts(device)
    per_detect, per_crop = sum(seen["detect"].values()), sum(seen["crop"].values())
    n_crop = launches["crop_and_resize_s2d"]
    n_detect, rest = divmod(launches["qconv"] - n_crop * per_crop, per_detect)
    want = n_detect * counts["detect"] + n_crop * counts["crop"]
    if rest or n_detect < 1 or launches["quantize"] != want:
        fail(f"{tag}: quantize launched {launches['quantize']} times; qconv {launches['qconv']} and "
             f"crop_and_resize_s2d {n_crop} imply {n_detect} detect forwards and {n_crop} crop frames, so {want}")


def quantize_inputs(device, cameras: int = 6):
    """The input and scale of every quantize step of one detect frame of
    ``cameras`` 1080p cameras and of one crop frame (32 crops of 112 px),
    as the shipped int8 pair runs them on random pixels: ({branch: [(x,
    xs)]}, each x a copy with its strides; (frames, crops))."""
    import torch

    from playground3d_tpu_torch.models import quant
    from playground3d_tpu_torch.models.retinanet import forward_raw, localize

    _, cfg, _, (det_q, crop_q), _ = shipped_models(device)
    gen = np.random.default_rng(11)
    frames = torch.as_tensor(pack_frames(gen.integers(0, 256, (cameras, H, W, 3), dtype=np.uint8))).to(device)
    crops = torch.as_tensor(gen.integers(0, 256, (cfg.crop_slots, cfg.cs // 4, cfg.cs // 4, 48),
                                         dtype=np.uint8)).to(device)
    seen = {"detect": [], "crop": []}
    branch = ["detect"]
    real = quant.quantize

    def recording(x, xs):
        seen[branch[0]].append((x.clone(), xs))
        return real(x, xs)

    quant.quantize = recording
    try:
        with torch.no_grad():
            forward_raw(det_q, frames, compact=True, min_level=cfg.det_min_level, score_path=True)
            branch[0] = "crop"
            localize(crop_q, crops)
        torch.cuda.synchronize()
    finally:
        quant.quantize = real
    return seen, (frames, crops)


def quantize_graph(fn, device):
    """``fn()`` captured in a CUDA graph after a warm-up on a side stream:
    (graph, {wrapper name: launches a replay credits}, nodes, replay ms)."""
    import torch

    from playground3d_tpu_torch.ops.cuda_build import launches_recorded

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with launches_recorded() as tally:
        with torch.cuda.graph(graph):
            fn()
    graph.instantiate()
    tally = {w.__name__: n for w, n in tally.items()}
    return graph, tally, graph_nodes(graph), graph_replay_ms(graph, device)


def quantize_entry(device) -> None:
    """``ops/quantize.py::quantize`` on the card sends every tensor to the
    kernel: a view with gaps, a transpose, a broadcast, float16 and float64
    raise ValueError there, and nothing runs the plain ops."""
    import torch

    from playground3d_tpu_torch.ops import quantize as QZ

    x = (torch.randn(2, 16, 6, 10, device=device) * 3).to(torch.bfloat16)
    xs = torch.tensor(0.043, device=device)
    cases = {"gaps": x[:, ::2], "transpose": x.transpose(2, 3), "broadcast": x[:1].expand(2, -1, -1, -1),
             "float16": x.half(), "float64": x.double()}
    for name, v in cases.items():
        try:
            QZ.quantize(v, xs)
            fail(f"quantize: the entry took a {name} tensor on the card")
        except ValueError:
            pass
    log(f"kernels: quantize's entry on the card raises ValueError for {', '.join(cases)}")


def kernels_quantize(device, flush, noop_ms):
    """``quantize.cu``: equal to the five plain ops at the edges (every
    scale of ``QUANTIZE_EDGE_SCALES``, bfloat16 and float32, aligned,
    unaligned and channels-last) and at every quantize step of a detect
    frame of 6 cameras and of a crop frame, each at its own calibrated scale
    (bfloat16 as the nets give it, and widened to float32); each step timed
    L2 cold and warm against its bytes, beside the plain ops; then a detect
    frame's and a crop frame's forward captured as a CUDA graph with the
    plain ops (as before the kernel) and with the kernel: nodes, launches a
    replay credits, replay time."""
    import torch

    from playground3d_tpu_torch.models import quant
    from playground3d_tpu_torch.models.retinanet import forward_raw, localize
    from playground3d_tpu_torch.ops import quantize as QZ

    t_phase = time.time()
    gen = torch.Generator().manual_seed(12)
    differ, checked = 0, 0
    for xs in QUANTIZE_EDGE_SCALES:
        edges = QZ.edge_values(xs)
        rand = (torch.randn(4100 - len(edges), generator=gen) * 60 * (xs if math.isfinite(xs) and xs else 1.0))
        values = torch.cat([torch.tensor(edges, dtype=torch.float32), rand.to(torch.float32)])
        scale = torch.tensor(xs, dtype=torch.float32, device=device)
        for dtype in (torch.bfloat16, torch.float32):
            x = values.to(dtype).to(device)
            views = {"aligned": x, "unaligned": x[1:],
                     "channels-last": x[:4096].view(2, 8, 16, 16).permute(0, 3, 1, 2)}
            for name, v in views.items():
                got, want = QZ.quantize_cuda(v, scale), QZ.quantize_plain(v, scale)
                torch.cuda.synchronize()
                n = int((got != want).sum())
                if n or got.stride() != v.stride():
                    log(f"kernels: quantize edge case xs {xs!r} {str(dtype)[6:]} {name}: {n} values differ "
                        f"(strides {got.stride()} for {v.stride()})")
                differ += n
                checked += v.numel()
    log(f"kernels: quantize at the edges: {len(QUANTIZE_EDGE_SCALES)} scales x bfloat16 and float32 x aligned, "
        f"unaligned (the tail loop alone) and channels-last: {differ} of {checked} values differ from the five "
        f"plain ops (must be 0)")
    if differ:
        fail(f"quantize: {differ} edge values differ from the plain ops")
    quantize_entry(device)

    seen, (frames, crops) = quantize_inputs(device)
    rows = []
    for branch in ("detect", "crop"):
        for i, (x, xs) in enumerate(seen[branch]):
            n_diff = 0
            for v in (x, x.to(torch.float32)):
                got = QZ.quantize_cuda(v, xs)
                n_diff += int((got != QZ.quantize_plain(v, xs)).sum()) + (got.stride() != v.stride())
            torch.cuda.synchronize()
            if n_diff:
                fail(f"quantize: the {branch} frame's step {i} {tuple(x.shape)} differs from the plain ops "
                     f"({n_diff})")
            nbytes = x.numel() * (x.element_size() + 1)
            rows.append(dict(
                branch=branch, i=i, shape=tuple(x.shape), channels_last=x.is_contiguous(
                    memory_format=torch.channels_last) and not x.is_contiguous(), dtype=str(x.dtype)[6:],
                numel=x.numel(), xs=float(xs), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                cold_ms=gpu_ms(lambda: QZ.quantize_cuda(x, xs), iters=20, flush=flush),
                warm_ms=gpu_ms(lambda: QZ.quantize_cuda(x, xs), iters=20),
                plain_cold_ms=gpu_ms(lambda: QZ.quantize_plain(x, xs), iters=5, flush=flush),
                plain_warm_ms=gpu_ms(lambda: QZ.quantize_plain(x, xs), iters=5),
            ))
    log(f"kernels: quantize at every step of a detect frame of 6 cameras ({len(seen['detect'])} steps) and a crop "
        f"frame ({len(seen['crop'])}), each at its calibrated scale: equal to the plain ops in bfloat16 and "
        f"float32 (CUDA events, mean of 20, L2 cold = a 256 MB write before each; plain: mean of 5; an empty "
        f"kernel {noop_ms * 1e3:.2f} us)")
    log("kernels: quantize branch  #  shape                   CL  dtype   M elems  cold us  warm us  bound us  "
        "cold % of bound  plain cold us  plain warm us")
    for r in rows:
        log(f"kernels: quantize {r['branch']:>6s} {r['i']:2d}  {str(list(r['shape'])):22s} {int(r['channels_last']):3d}  "
            f"{r['dtype']:8s} {r['numel'] / 1e6:7.2f} {r['cold_ms'] * 1e3:8.1f} {r['warm_ms'] * 1e3:8.1f} "
            f"{r['bound_ms'] * 1e3:9.1f} {r['bound_ms'] / r['cold_ms'] * 100:16.1f} {r['plain_cold_ms'] * 1e3:14.1f} "
            f"{r['plain_warm_ms'] * 1e3:14.1f}")
    totals = {}
    for branch in ("detect", "crop"):
        br = [r for r in rows if r["branch"] == branch]
        tot = {f: sum(r[f] for r in br) for f in ("cold_ms", "warm_ms", "bound_ms", "plain_cold_ms", "plain_warm_ms",
                                                   "numel")}
        totals[branch] = tot
        log(f"kernels: quantize total per {branch} frame: {len(br)} launches, {tot['numel'] / 1e6:.1f} M elements, "
            f"kernel {tot['cold_ms']:.3f} ms cold ({tot['warm_ms']:.3f} warm), bound {tot['bound_ms']:.3f} ms "
            f"({tot['bound_ms'] / tot['cold_ms'] * 100:.1f}% of it cold), the five plain ops {tot['plain_cold_ms']:.3f} "
            f"ms cold ({tot['plain_warm_ms']:.3f} warm)")
    big = [r for r in rows if r["numel"] >= 1e8]
    if big:
        log(f"kernels: quantize at the {len(big)} steps of 100 M elements or more (layer1's outputs): "
            + ", ".join(f"{r['bound_ms'] / r['cold_ms'] * 100:.1f}%" for r in big) + " of the 3-byte bound, cold")

    _, cfg, _, (det_q, crop_q), _ = shipped_models(device)
    programs = {"detect": lambda: forward_raw(det_q, frames, compact=True, min_level=cfg.det_min_level,
                                              score_path=True),
                "crop": lambda: localize(crop_q, crops)}
    real = quant.quantize
    graphs = {}
    for branch, fn in programs.items():
        for label, entry in (("plain ops", QZ.quantize_plain), ("kernel", real)):
            quant.quantize = entry
            try:
                with torch.no_grad():
                    graph, tally, nodes, replay_ms = quantize_graph(fn, device)
            finally:
                quant.quantize = real
            graphs[(branch, label)] = (tally, nodes, replay_ms)
            del graph
            torch.cuda.synchronize()
        (t0, n0, ms0), (t1, n1, ms1) = graphs[(branch, "plain ops")], graphs[(branch, "kernel")]
        log(f"kernels: quantize in a {branch} frame's forward ({'6 cameras' if branch == 'detect' else '32 crops'}) "
            f"captured as one CUDA graph: with the plain ops {n0} nodes, launches a replay {t0}, replay {ms0:.3f} ms; "
            f"with the kernel {n1} nodes, launches a replay {t1}, replay {ms1:.3f} ms (median of 5)")
        want = len(seen[branch])
        if t1.get("quantize_cuda") != want or t0.get("quantize_cuda"):
            fail(f"quantize: the {branch} graph credits {t1} with the kernel and {t0} with the plain ops; "
                 f"{want} quantize steps a frame")
    del seen, frames, crops
    torch.cuda.synchronize()
    os.makedirs("_outputs", exist_ok=True)
    with open(os.path.join("_outputs", "quantize_shapes.json"), "w") as fh:
        json.dump({"rows": rows, "totals": totals,
                   "graphs": {f"{b} {lbl}": v for (b, lbl), v in graphs.items()}}, fh, indent=1)
    log(f"kernels: quantize phase took {time.time() - t_phase:.1f} s")
    det = totals["detect"]
    return {
        "name": "quantize", "route": "cuda", "source": "playground3d_tpu_torch/csrc/quantize.cu",
        "replaces": "none: the quantize-input expression, playground3d_tpu/models/quant.py:140",
        "max_abs_err": 0.0, "bound_by": "bytes", "ms": det["cold_ms"], "plain_ms": det["plain_cold_ms"],
        "library_ms": None, "bound_ms": det["bound_ms"],
    }


# ---- nms.cu and auction.cu --------------------------------------------------


def nms_cases(rng):
    """(label, boxes [n,4], scores [n], mask [n], thr, max_keep, n_iter,
    groups or None) at the main path's sizes (512 candidates into the
    detector's camera-grouped NMS, 48 detections into the parse NMS, 64
    slots into the lifecycle's), at edges, at each cluster size of the
    one-launch route and on both sides of its limit (cases are appended at
    the end, so the earlier ones draw the same numbers)."""
    def rand_boxes(n, lo=0.0, span=1800.0, size=(20.0, 300.0)):
        xy = rng.uniform(lo, lo + span, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(*size, (n, 2))], 1).astype(np.float32)

    i = np.arange(512)
    car = np.stack([8.0 * (i % 64), 8.0 * (i // 64), 8.0 * (i % 64) + 180.0, 8.0 * (i // 64) + 90.0], 1)
    x = np.arange(64, dtype=np.float32) * 3.0  # neighbours at IoU 0.54: a round for every other box
    chain = np.stack([x, np.zeros(64), x + 10.0, np.full(64, 10.0)], 1).astype(np.float32)
    tied = lambda n: np.full(n, 0.5, np.float32)  # noqa: E731
    some = lambda n, p=0.85: rng.uniform(0, 1, n) < p  # noqa: E731
    return [
        ("one car box at 8 px steps, all scores tied (the single camera's 512)", car.astype(np.float32),
         tied(512), np.ones(512, bool), 0.5, 48, None, np.zeros(512, np.int32)),
        ("512 random candidates, one camera", rand_boxes(512), rng.uniform(0, 1, 512).astype(np.float32),
         some(512), 0.5, 48, None, np.zeros(512, np.int32)),
        ("48 detections, tied scores, negative coordinates, 3 cameras", rand_boxes(48, lo=-900.0),
         (rng.integers(0, 3, 48) / 2).astype(np.float32), some(48), 0.3, 48, None,
         rng.integers(0, 3, 48).astype(np.int32)),
        ("48 detections, random", rand_boxes(48), rng.uniform(0, 1, 48).astype(np.float32), some(48), 0.3,
         48, None, None),
        ("64 slots by age (ties)", rand_boxes(64, size=(5.0, 400.0)), rng.integers(0, 6, 64).astype(np.float32),
         some(64, 0.6), 0.2, 64, None, None),
        ("a suppression chain capped at 5 rounds", chain, np.linspace(1.0, 0.1, 64).astype(np.float32),
         np.ones(64, bool), 0.3, 64, 5, None),
        ("a suppression chain to its fixed point", chain, np.linspace(1.0, 0.1, 64).astype(np.float32),
         np.ones(64, bool), 0.3, 64, None, None),
        ("max_keep 80 > n 48", rand_boxes(48), rng.uniform(0, 1, 48).astype(np.float32), some(48), 0.3, 80,
         None, None),
        ("all masked", rand_boxes(64), rng.uniform(0, 1, 64).astype(np.float32), np.zeros(64, bool), 0.3, 64,
         None, None),
        ("a single box", rand_boxes(1), np.ones(1, np.float32), np.ones(1, bool), 0.3, 4, None, None),
        ("no box", np.zeros((0, 4), np.float32), np.zeros(0, np.float32), np.zeros(0, bool), 0.3, 5, None, None),
        ("1,024 random boxes", rand_boxes(1024), rng.uniform(0, 1, 1024).astype(np.float32),
         some(1024), 0.4, 300, None, None),
        ("4,096 candidates, tied scores (TrackerConfig's default pre_topk), 3 cameras", rand_boxes(4096),
         np.full(4096, 0.5, np.float32), some(4096), 0.5, 128, None, rng.integers(0, 3, 4096).astype(np.int32)),
        ("8,192 random boxes (the kernel's cap)", rand_boxes(8192), rng.uniform(0, 1, 8192).astype(np.float32),
         some(8192), 0.5, 256, None, None),
        # each cluster size, batched, and both sides of the one-launch route's limit
        ("100 candidates, 2 cameras (a 2-CTA cluster)", rand_boxes(100, lo=-300.0), rng.uniform(0, 1, 100)
         .astype(np.float32), some(100), 0.4, 48, None, rng.integers(0, 2, 100).astype(np.int32)),
        ("200 candidates, tied scores, 4 cameras (a 4-CTA cluster)", rand_boxes(200),
         (rng.integers(0, 4, 200) / 3).astype(np.float32), some(200), 0.3, 64, None,
         rng.integers(0, 4, 200).astype(np.int32)),
        ("300 random boxes (an 8-CTA cluster)", rand_boxes(300), rng.uniform(0, 1, 300).astype(np.float32),
         some(300), 0.5, 100, None, None),
        ("1,260 boxes, 3 cameras (the one-launch route's cap)", rand_boxes(1260, size=(40.0, 400.0)),
         rng.uniform(0, 1, 1260).astype(np.float32), some(1260), 0.5, 300, None,
         rng.integers(0, 3, 1260).astype(np.int32)),
        ("1,260 boxes, tied scores", rand_boxes(1260), np.full(1260, 0.5, np.float32), some(1260), 0.5, 300,
         None, None),
        ("1,261 boxes, 3 cameras (two launches, shifted by the shift kernel)", rand_boxes(1261, lo=-500.0),
         rng.uniform(0, 1, 1261).astype(np.float32), some(1261), 0.5, 300, None,
         rng.integers(0, 3, 1261).astype(np.int32)),
        ("1,261 boxes (two launches)", rand_boxes(1261), rng.uniform(0, 1, 1261).astype(np.float32), some(1261),
         0.5, 300, None, None),
        ("64 slots, 2 groups, capped at 2 rounds", chain, np.linspace(1.0, 0.1, 64).astype(np.float32),
         np.ones(64, bool), 0.3, 64, 2, (np.arange(64) % 2).astype(np.int32)),
    ]


def launched_kernels(fn) -> int:
    """Kernels one call of ``fn()`` launches: the nodes of a CUDA graph that
    captures it (it allocates with ``torch.empty`` only, which adds none)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept, to read its nodes
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    return graph_nodes(graph)


def kernels_nms(device, flush, noop_ms):
    """``nms.cu``: every case against the plain version on the card (keep
    indices and masks equal, its rounds equal to the plain loop's host
    reads; batched cases pass their groups to the kernel and are held
    against ``group_shift`` + the plain loop), both routes and every
    cluster size of the one-launch route, the kernels one batched call
    launches, then times at the main path's sizes."""
    import torch

    from playground3d_tpu_torch.ops import nms as N
    from playground3d_tpu_torch.ops.iou import pairwise_iou
    from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs

    rng = np.random.default_rng(41)
    tensors, worst, seen = {}, 0, set()
    for label, boxes, scores, mask, thr, max_keep, n_iter, groups in nms_cases(rng):
        b, sc, m = (torch.as_tensor(a, device=device) for a in (boxes, scores, mask))
        g = None if groups is None else torch.as_tensor(groups, device=device)
        plan = N.launch_plan(len(boxes))
        DeviceRounds.reset()
        got_i, got_m = N.nms_cuda(b, sc, m, thr, max_keep, n_iter, groups=g)
        rounds = DeviceRounds.read()["nms"]
        shifted = b if g is None else N.group_shift(b, g, m)  # the plain version's batched_nms
        reads0 = HostSyncs.by_loop["nms"]
        ref_i, ref_m = N.nms_plain(shifted, sc, m, thr, max_keep, n_iter)
        reads = HostSyncs.by_loop["nms"] - reads0
        torch.cuda.synchronize()
        ok = torch.equal(got_i, ref_i) and torch.equal(got_m, ref_m) and got_i.dtype == ref_i.dtype
        if len(got_i):  # the largest difference of a keep index or a keep flag
            worst = max(worst, int((got_i.long() - ref_i.long()).abs().max()), int((got_m != ref_m).any()))
        route = f"one launch, {plan.cluster}-CTA cluster" if plan.one_launch else "two launches"
        seen.add((plan.one_launch, plan.cluster, g is not None))
        log(f"kernels: nms, {label} (n {len(boxes)}, max_keep {max_keep}, n_iter {n_iter}; {route}"
            f"{', groups shifted in the kernel' if g is not None else ''}): keep indices and masks "
            f"{'equal to' if ok else 'DIFFER from'} the plain version's ({int(got_m.sum())} kept); {rounds} rounds "
            f"on the card, {reads} host reads by the plain loop")
        if not ok or rounds != reads:
            fail(f"nms ({label}): the kernel differs from the plain version (rounds {rounds} vs {reads})")
        tensors[label] = (b.contiguous(), sc, m, thr, max_keep, n_iter, rounds, int(got_m.sum()), g, shifted)
    clusters = {c for one, c, _ in seen if one}
    if clusters != {1, 2, 4, 8} or not {(True, 8, True), (False, 0, True), (False, 0, False)} <= seen:
        fail(f"nms: the cases missed a route, a cluster size or a batched case: {sorted(seen)}")

    labels = [case[0] for case in nms_cases(np.random.default_rng(41))]
    two_launch_batched = next(label for label in labels if label.startswith("1,261 boxes, 3 cameras"))
    for label in (labels[0], two_launch_batched):  # n 512 and 1,261, batched
        b, sc, m, thr, max_keep, n_iter, _, _, g, _ = tensors[label]
        kernels = launched_kernels(lambda: N.batched_nms(b, sc, g, m, thr, max_keep, n_iter))
        want = 1 if N.launch_plan(b.shape[0]).one_launch else 3  # else shift, beats and loop kernels
        log(f"kernels: nms, one batched_nms call at n {b.shape[0]} is {kernels} kernel launch(es) (nodes of a "
            f"CUDA graph that captures it; must be {want})")
        if kernels != want:
            fail(f"nms: batched_nms at n {b.shape[0]} launched {kernels} kernels, not {want}")

    times = {}
    for label in (labels[0], labels[3], labels[4]):  # n 512, 48, 64: the main path's three sizes
        b, sc, m, thr, max_keep, n_iter, rounds, kept, g, shifted = tensors[label]
        # the work these inputs need: the IoU of each pair of masked boxes (one of the two
        # ranks ahead of the other), a round's test of each box's beaters, the kept boxes' order
        s = torch.where(m, sc, torch.full_like(sc, N.NEG_INF))
        ar = torch.arange(b.shape[0], device=device)
        ahead = (s[:, None] > s[None, :]) | ((s[:, None] == s[None, :]) & (ar[:, None] < ar[None, :]))
        beats = ahead & (pairwise_iou(shifted, shifted) > thr) & m[:, None] & m[None, :]
        work = dict(masked=int(m.sum()), beats=int(beats.sum()), kept=kept)
        shifted = shifted.contiguous()
        kernel_ms = gpu_ms(lambda: N.nms_cuda(shifted, sc, m, thr, max_keep, n_iter), iters=50)
        batched_ms = gpu_ms(lambda: N.nms_cuda(b, sc, m, thr, max_keep, n_iter, groups=g), iters=50) if g is not None else None
        plain_ms = gpu_ms(lambda: N.nms_plain(shifted, sc, m, thr, max_keep, n_iter), iters=3)
        n = b.shape[0]
        nbytes = n * (16 + 4 + 1) + max_keep * (4 + 1)
        # operations: each masked box's area (3), for each pair of masked boxes the order
        # (1 compare) and the IoU against thr (14), in each round an AND for each beats pair,
        # and a compare for each pair of kept boxes; bytes: the inputs and outputs once (the
        # beats table is the kernels' own, kept on chip)
        mm = work["masked"]
        ops = 3 * mm + 15 * (mm * (mm - 1) // 2) + rounds * work["beats"] + kept * (kept - 1) // 2
        bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3
        times[n] = (kernel_ms, plain_ms, bound_ms, ops, nbytes, rounds)
        log(f"kernels: nms at n {n} ({rounds} rounds, {work['masked']} boxes masked in, {work['beats']} beats "
            f"pairs, {work['kept']} kept; {N.launch_plan(n).cluster}-CTA cluster): kernel {kernel_ms * 1e3:.2f} us"
            + (f" ({batched_ms * 1e3:.2f} us with the groups shifted in the kernel)" if batched_ms else "")
            + f" (an empty kernel {noop_ms * 1e3:.2f} us), plain version {plain_ms * 1e3:.1f} us (one host read a "
            f"round), bound {bound_ms * 1e3:.4f} us ({ops} float32 ops at 67 TFLOP/s; {nbytes} bytes), "
            f"{bound_ms / kernel_ms * 100:.2f}% of bound; no library call (torchvision is not installed)")
    kernel_ms, plain_ms, bound_ms, ops, nbytes, _ = times[512]
    return {
        "name": "nms", "route": "cuda", "source": "playground3d_tpu_torch/csrc/nms.cu",
        "replaces": "playground3d_tpu/ops/nms.py:92",
        "max_abs_err": float(worst), "bound_by": "operations" if ops / FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
    }


def auction_cases(rng):
    """(label, benefit [n,m], row_mask, col_mask, max_iters): the tracker's
    64 x 48 IoU and edges, both sides of the shared-memory limit, every
    lane-group width (appended at the end, so the earlier cases draw the
    same numbers)."""
    def iou_like(n, m, p=0.85):
        return np.where(rng.uniform(0, 1, (n, m)) > p, rng.uniform(0, 1, (n, m)), 0.0).astype(np.float32)

    some = lambda n, p=0.8: rng.uniform(0, 1, n) < p  # noqa: E731
    ties = (rng.integers(0, 3, (64, 48)) / 2.0).astype(np.float32)
    return [
        ("64 x 48, tie-heavy", ties, some(64), some(48), 5000),
        ("64 x 48, IoU-like", iou_like(64, 48), some(64), some(48), 5000),
        ("64 x 48, dense", rng.uniform(0, 1, (64, 48)).astype(np.float32), some(64), some(48), 5000),
        ("64 x 48, tie-heavy, capped at 7 rounds", ties, some(64), some(48), 7),
        ("48 x 64, dense", rng.uniform(0, 1, (48, 64)).astype(np.float32), some(48), some(64), 5000),
        ("64 x 48, all rows masked", iou_like(64, 48), np.zeros(64, bool), some(48), 5000),
        ("1 x 1", np.full((1, 1), 0.7, np.float32), np.ones(1, bool), np.ones(1, bool), 5000),
        ("300 x 260, dense (benefit formed on the fly)", rng.uniform(0, 1, (300, 260)).astype(np.float32),
         some(300), some(260), 5000),
        ("200 x 1024, IoU-like (the kernel's cap)", iou_like(200, 1024, 0.97), some(200), some(1024), 2000),
        # every lane-group width and the shared-memory route's cap
        ("16 x 12, tie-heavy (groups of 4 lanes)", (rng.integers(0, 3, (16, 12)) / 2.0).astype(np.float32),
         some(16), some(12), 5000),
        ("100 x 80, IoU-like (groups of 16 lanes)", iou_like(100, 80), some(100), some(80), 5000),
        ("224 x 200, dense (the shared-memory cap)", rng.uniform(0, 1, (224, 200)).astype(np.float32), some(224),
         some(200), 5000),
    ]


def kernels_auction(device, flush, noop_ms):
    """``auction.cu``: every case against the plain version on the card
    (assignments equal, its rounds equal to the plain loop's host reads)
    and the uncapped ones against scipy's optimum, then times at the
    tracker's 64 x 48."""
    import torch
    from scipy.optimize import linear_sum_assignment

    from playground3d_tpu_torch.ops import assignment as A
    from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs

    rng = np.random.default_rng(43)
    main, worst = None, 0
    for label, b, rm, cm, max_iters in auction_cases(rng):
        bt, rt, ct = (torch.as_tensor(a, device=device) for a in (b, rm, cm))
        DeviceRounds.reset()
        got = A.assign_auction(bt, rt, ct, max_iters)
        counts = DeviceRounds.read()
        rounds, bids = counts["auction"], counts["auction_bids"]
        reads0 = HostSyncs.by_loop["auction"]
        ref = A.assign_auction_plain(bt, rt, ct, max_iters)
        reads = HostSyncs.by_loop["auction"] - reads0
        ok = torch.equal(got, ref)
        worst = max(worst, int((got.long() - ref.long()).abs().max()) if len(got) else 0)
        g = got.cpu().numpy()
        masked = np.where(rm[:, None] & cm[None, :], b, 0.0)
        r, c = linear_sum_assignment(masked, maximize=True)
        best = float(masked[r, c].sum())
        total = float(sum(masked[i, j] for i, j in enumerate(g) if j >= 0))
        # optimal within the auction's eps slack once it converged (a run
        # stopped by max_iters, in either version alike, is not held to it)
        optimal = rounds >= max_iters or total >= best - 1e-3 * max(best, 1.0)
        plan = A.launch_plan(*b.shape)
        log(f"kernels: auction, {label} ({plan.threads} threads, groups of {plan.lanes} lanes, benefit "
            f"{'in shared memory' if plan.benefit_in_shared else 'formed on the fly'}): assignment "
            f"{'equal to' if ok else 'DIFFERS from'} the plain version's ({int((g >= 0).sum())} rows assigned, "
            f"benefit {total:.4f}, scipy's optimum {best:.4f}); {rounds} rounds on the card, {reads} host reads "
            f"by the plain loop, {bids} bids")
        if not rounds - 1 <= bids <= rounds * max(b.shape):  # a bid in each round but the last
            fail(f"auction ({label}): {bids} bids in {rounds} rounds of {max(b.shape)} rows")
        if not ok or rounds != reads or not optimal:
            fail(f"auction ({label}): kernel {'equal' if ok else 'differs'}, rounds {rounds} vs {reads}, "
                 f"benefit {total} vs optimum {best}")
        if main is None:
            main = (bt, rt, ct, rounds, bids)

    bt, rt, ct, rounds, bids = main
    kernel_ms = gpu_ms(lambda: A.assign_auction_cuda(bt, rt, ct), iters=50)
    plain_ms = gpu_ms(lambda: A.assign_auction_plain(bt, rt, ct), iters=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        host = torch.where(rt[:, None] & ct[None, :], bt, torch.zeros_like(bt)).cpu().numpy()
        linear_sum_assignment(host, maximize=True)
    library_ms = (time.perf_counter() - t0) / 20 * 1e3
    n, m = bt.shape
    k = max(n, m)
    nbytes = n * m * 4 + n + m + n * 4
    # the work these inputs need: the scale (an abs and a max an entry) and the squared-up
    # benefit (k^2); for each row that bids in a round, k subtractions, best and second (2k
    # compares) and its bid (3), the column's amax and winner test (2); a round's update (k)
    ops = 2 * n * m + k * k + bids * (3 * k + 5) + rounds * k
    bound_ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS) * 1e3
    log(f"kernels: auction at 64 x 48 tie-heavy ({rounds} rounds, {bids} bids): kernel {kernel_ms * 1e3:.2f} us (an empty "
        f"kernel {noop_ms * 1e3:.2f} us), plain version {plain_ms * 1e3:.1f} us (one host read a round), "
        f"scipy.optimize.linear_sum_assignment with the copy to the host {library_ms * 1e3:.1f} us, bound "
        f"{bound_ms * 1e3:.4f} us ({ops} float32 ops at 67 TFLOP/s; {nbytes} bytes), "
        f"{bound_ms / kernel_ms * 100:.2f}% of bound")
    return {
        "name": "auction", "route": "cuda", "source": "playground3d_tpu_torch/csrc/auction.cu",
        "replaces": "playground3d_tpu/ops/assignment.py:138",
        "max_abs_err": float(worst), "bound_by": "operations" if ops / FP32_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes",
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
    }


def phase_kernels(device):
    """Every kernel against its plain version, with times -> the entries of
    the ``kernels`` line (their ``launches`` come from the main phase)."""
    import torch

    from playground3d_tpu_torch.ops import crop_resize

    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    noop_ms = gpu_ms(crop_resize.launch_noop)
    log(f"kernels: an empty kernel takes {noop_ms * 1e3:.2f} us between CUDA events "
        f"(that much of every launch below is the launch itself)")
    return [fn(device, flush, noop_ms) for fn in (kernels_crop_resize, kernels_crop_s2d, kernels_yuv, kernels_qconv,
                                                   kernels_quantize, kernels_nms, kernels_auction, kernels_focal)]


def phase_small_reference(device):
    """The clip on the card (CUDA kernels) against the same clip on the CPU
    (plain versions) at 64x96 with ResNet-18 nets, for each frame transport
    and for an int8-quantized pair (quantized once on the CPU, then copied to
    the card, so both run the same integers): ids and masks equal, states
    within 1e-3 ft. The output convs have zero weights, so every logit is its
    bias whatever the backbone computes and ties decide alike on both."""
    import torch

    from playground3d_tpu_torch.ops.yuv420 import yuv420_flat_to_s2d
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
    from playground3d_tpu_torch.pipeline.multi_cam import make_mc_clip_step
    from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
    from playground3d_tpu_torch.track.kf import default_params

    reg = bench_registry(64, 96)
    cfg = tracker_config(small=True)
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, (12, 64, 96, 3), dtype=np.uint8)
    yuv = rng.integers(0, 256, (12, 1, 64 * 96 * 3 // 2), dtype=np.uint8)
    times = (np.arange(12, dtype=np.float32)[:, None] / 30.0)
    cases = (
        ("raw frames, conv7 stems, float", "conv7", False, raw[:, None]),
        ("s2d frames, s2d stems, float", "s2d", False, pack_frames(raw)[:, None]),
        ("s2d frames, s2d stems, int8", "s2d", True, pack_frames(raw)[:, None]),
        ("YUV420 bytes, s2d stems, int8", "s2d", True, yuv),
    )
    for label, stem, int8, frames in cases:
        det, crop = build_models("cpu", crop_target(reg, cfg, 6, s2d=stem == "s2d"), small=True, stem=stem)
        if int8:
            det, crop = quantize_pair(det, crop, torch.as_tensor(pack_frames(raw)[0]), cfg.cs)
        out = {}
        for dev in ("cpu", device):
            d, c = (det, crop) if dev == "cpu" else (copy.deepcopy(det).to(dev), copy.deepcopy(crop).to(dev))
            clip = make_mc_clip_step(d, bank_from_registry(reg, device=dev),
                                     torch.tensor([[565.0, 60.0]], device=dev), default_params(device=dev),
                                     cfg, crop_model=c, stem=stem, crop_stem=stem)
            st0 = seed_tracks(init_track_state(cfg.max_tracks, dev), 6)
            fr = torch.as_tensor(frames, device=dev)
            if fr.ndim == 3:
                fr = yuv420_flat_to_s2d(fr, (64, 96))
            st, _, snaps = clip(st0, torch.zeros(1, device=dev), fr, torch.as_tensor(times, device=dev), 0)
            out[str(dev)] = {k: getattr(snaps, k).cpu() for k in ("ids", "raw_mask", "classes", "states7")}
        cpu, gpu = out["cpu"], out[str(device)]
        for k in ("ids", "raw_mask", "classes"):
            if not torch.equal(cpu[k], gpu[k]):
                fail(f"small clip ({label}): {k} differs between the card and the CPU")
        live = cpu["raw_mask"]
        diff = float((cpu["states7"] - gpu["states7"])[live].abs().max()) if live.any() else 0.0
        log(f"main: small clip (12 frames, 64x96; {label}) card vs CPU: ids/raw_mask/classes equal, "
            f"{int(live.sum())} live slot-frames, states7 max_abs_diff {diff:.3g} (tolerance 1e-3)")
        if not diff <= 1e-3:
            fail(f"small clip ({label}): states7 differ by {diff}")
        if int(live.sum()) == 0:
            fail(f"small clip ({label}): no live tracks")


def profile_branches(trk, frames_dev, device, label: str, top: int = 6):
    """One detect and one crop frame under torch.profiler: the card's busy
    share of the branch's wall time and its largest kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = torch.zeros(1, device=device)
    bias = torch.zeros(1, device=device)
    runs = {
        "detect": lambda: trk._detect_step(trk.state, frames_dev, t, bias),
        "crop": lambda: trk._crop_step(trk.state, frames_dev, t, bias),
    }
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kern)
        if busy <= 0:
            log(f"profile ({label}): {name}: the profiler saw no device time (not measured)")
            continue
        parts = {}
        for part, words in (("qconv", ("qconv_kernel",)), ("elementwise", ("elementwise",))):
            ks = [e for e in kern if any(w in e.key for w in words)]
            parts[part] = (sum(e.self_device_time_total for e in ks) / 1e3, sum(e.count for e in ks))
        log(f"profile ({label}): {name}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({busy / wall_us * 100:.0f}%), {sum(e.count for e in kern)} kernel launches; qconv_kernel "
            f"{parts['qconv'][0]:.3f} ms over {parts['qconv'][1]}, PyTorch's elementwise kernels "
            f"{parts['elementwise'][0]:.3f} ms over {parts['elementwise'][1]}")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"profile ({label}): {name}:   {e.self_device_time_total / 1e3:7.3f} ms  x{e.count:<4d} {e.key[:90]}")


def tracker_loop_calls(trk, frames_dev, device) -> dict:
    """The arguments of every NMS and auction launch of one eager detect
    frame and one crop frame of ``trk``, listed by the wrappers inside
    ``calls_recorded`` (these launches are measurement, not counted):
    {branch: [(kind, args)]}, the tensors cloned."""
    import torch

    from playground3d_tpu_torch.ops import assignment as A
    from playground3d_tpu_torch.ops import nms as N
    from playground3d_tpu_torch.ops.cuda_build import calls_recorded

    kinds = {N.nms_cuda: "nms", A.assign_auction_cuda: "auction"}
    t, bias = torch.zeros(1, device=device), torch.zeros(1, device=device)
    calls = {}
    for branch, step in (("detect", trk._detect_step), ("crop", trk._crop_step)):
        with calls_recorded() as seen:
            step(trk.state, frames_dev, t, bias)
            torch.cuda.synchronize()
        calls[branch] = [(kinds[wrapper], args) for wrapper, args in seen if wrapper in kinds]
    return calls


def time_tracker_loops(calls, per_clip: dict, label: str, save: str | None = None) -> None:
    """Each recorded NMS / auction call replayed through its kernel (time,
    rounds), and launches x time per clip; with ``save``, the calls are also
    written there (``scripts/nms_auction_times.py --calls`` replays them on
    another checkout)."""
    import torch

    from playground3d_tpu_torch.ops import assignment as A
    from playground3d_tpu_torch.ops import nms as N
    from playground3d_tpu_torch.ops.topk import DeviceRounds

    total = {"nms": 0.0, "auction": 0.0}
    for branch, branch_calls in calls.items():
        for kind, args in branch_calls:
            if kind == "nms":
                b, sc, m, thr, max_keep, n_iter, g = args
                fn = lambda: N.nms_cuda(b, sc, m, thr, max_keep, n_iter, groups=g)  # noqa: E731
                what = f"n {b.shape[0]}{' batched' if g is not None else ''}, {int(m.sum())} masked in"
            else:
                fn = lambda: A.assign_auction_cuda(*args)  # noqa: E731
                what = f"{args[0].shape[0]} x {args[0].shape[1]}"
            DeviceRounds.reset()
            fn()
            rounds = DeviceRounds.read()
            ms = gpu_ms(fn, iters=50)
            total[kind] += ms * per_clip[branch]
            log(f"main ({label}): {branch} frame's {kind} at {what}: {rounds[kind]} rounds"
                + (f" ({rounds['auction_bids']} bids)" if kind == "auction" else "")
                + f", {ms * 1e3:.2f} us (CUDA events, mean of 50; {per_clip[branch]} such frames a clip)")
    log(f"main ({label}): on the main path's own inputs, a 24-frame clip's launches take nms "
        f"{total['nms'] * 1e3:.2f} us and auction {total['auction'] * 1e3:.2f} us of card time "
        f"(launches x time; {sum(k == 'nms' for k, _ in calls['detect'])} NMS and "
        f"{sum(k == 'auction' for k, _ in calls['detect'])} auction a detect frame, "
        f"{sum(k == 'nms' for k, _ in calls['crop'])} NMS a crop frame)")
    if save:
        cpu = {br: [(kind, tuple(a.cpu() if isinstance(a, torch.Tensor) else a for a in args)) for kind, args in cs]
               for br, cs in calls.items()}
        os.makedirs(os.path.dirname(save) or ".", exist_ok=True)
        torch.save({"calls": cpu, "per_clip": per_clip}, save)
        log(f"main ({label}): the NMS and auction calls saved to {save}")


def kernel_counters():
    """name in the ``kernels`` line -> the wrapper that counts its launches."""
    from playground3d_tpu_torch.ops import assignment, crop_mxu, crop_resize, nms, qconv, quantize, yuv420

    return {
        "crop_and_resize": crop_resize.crop_and_resize_cuda,
        "crop_and_resize_s2d": crop_mxu.crop_and_resize_s2d_cuda,
        "yuv420_flat_to_s2d": yuv420.yuv420_flat_to_s2d_cuda,
        "qconv": qconv.qconv_cuda,
        "quantize": quantize.quantize_cuda,
        "nms": nms.nms_cuda,
        "auction": assignment.assign_auction_cuda,
    }


def graph_nodes(graph) -> int:
    """Nodes of a captured CUDA graph (kernels, copies, fills), from the
    CUDA library (libcuda's ``cuGraphGetNodes``; the clip keeps its graphs)."""
    import ctypes

    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        fail(f"cuGraphGetNodes returned {err}")
    return int(n.value)


def graph_replay_ms(graph, device) -> float:
    """A graph's replay time on its card: median of 5, CUDA events."""
    import torch

    times = []
    with torch.cuda.device(device):
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()  # alone, credits no launch: this replay is measurement
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
    return float(np.median(times))


def clip_programs(clip):
    """(where, StaticGraphs) of every program of a captured clip: each
    camera shard's (its forward and top-k, ``frame`` or ``batched``; one
    shard, every camera, without a mesh), then the lead's (the branches,
    or the whole unrolled clip)."""
    out = [(f"shard {i}", sd.programs) for shards in clip.shard_runners.values() for i, sd in enumerate(shards)]
    return out + [("lead", runner.programs) for runner in clip.runners.values()]


def graph_detail(clip, label: str, phase: str = "main"):
    """Per graph of the captured clip (a shard's forward and top-k, a
    branch, or the whole unrolled clip): graph nodes, the launches it credits, its
    capture and instantiate time (host), a replay's time (CUDA events,
    median of 5), and the card's busy time and kernels in one replay under
    the profiler. Replays run on the clip's static buffers (the timed runs
    are over)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    medians = {}
    for where, programs in clip_programs(clip):
        for name, (graph, tally) in programs.graphs.items():
            medians[name] = replay_ms = graph_replay_ms(graph, programs.device)
            cap_s, inst_s = programs.capture_s[name]
            line = (f"{phase} ({label}): {where}'s graph {name}: {graph_nodes(graph)} nodes, kernel launches credited "
                    f"{ {k.__name__: v for k, v in tally.items()} }, captured in {cap_s:.3f} s and instantiated "
                    f"in {inst_s:.3f} s (host), replay {replay_ms:.3f} ms median of 5 (CUDA events)")
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                graph.replay()
                torch.cuda.synchronize()
            kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
            busy_ms = sum(ev.self_device_time_total for ev in kern) / 1e3
            qk = [ev for ev in kern if "qconv_kernel" in ev.key]
            line += (f"; one replay under the profiler: card busy {busy_ms:.3f} ms ({busy_ms / replay_ms * 100:.0f}% "
                     f"of the replay's time), {sum(ev.count for ev in kern)} kernels"
                     + (f", qconv_kernel {sum(ev.self_device_time_total for ev in qk) / 1e3:.3f} ms over "
                        f"{sum(ev.count for ev in qk)}" if qk else "") if busy_ms > 0
                     else "; the profiler saw no device time (card busy not measured)")
            log(line)
    return medians


def clip_outcome(trk, conf_cnt0):
    """(births, crop measurements) of a tracker after its clips."""
    births = int(trk.state.next_id) - N_SEED
    return births, float((trk.state.conf_cnt - conf_cnt0).clamp(min=0).sum())


def variant_clip(trk, det, crop, graphs: bool, variant: dict):
    """``make_mc_clip_step`` with a variant of the JAX clip, called
    directly as ``bench.py`` calls it (the tracker exposes no variant)."""
    from playground3d_tpu_torch.pipeline.multi_cam import make_mc_clip_step

    return make_mc_clip_step(det, trk.bank, trk.centers, trk.kfp, trk.cfg, crop_model=crop, stem=det.stem,
                             crop_stem=crop.stem, graphs=graphs, **variant)


def captured_names(variant: dict):
    """The graphs a clip of ``make_mc_clip_step(**variant)`` captures: the
    shard's forward and top-k (of each detect frame, or batched) and the
    lead's branches, or the one unrolled clip."""
    if variant.get("unroll"):
        return ["clip"]
    return sorted(["batched" if variant.get("batch_detects") else "frame", "crop", "detect", "passthrough"])


def rows_diff(what: str, trk, other):
    """(states7, final kf.x) max abs differences of ``trk`` from ``other``
    (trackers or their kept rows and state); fails unless the rows' frames,
    ids and classes and the final masks and ids are equal and both
    differences are within 1e-4."""
    if len(trk.rows) != len(other.rows):
        fail(f"{what}: {len(trk.rows)} rows against {len(other.rows)}")
    worst = 0.0
    for rg, re_ in zip(trk.rows, other.rows):
        if rg[0] != re_[0] or not (np.array_equal(rg[2], re_[2]) and np.array_equal(rg[4], re_[4])):
            fail(f"{what}: frame {rg[0]}: ids or classes differ")
        if not np.isfinite(rg[3]).all():
            fail(f"{what}: non-finite states at frame {rg[0]}")
        if len(rg[3]):
            worst = max(worst, float(np.abs(rg[3] - re_[3]).max()))
    import torch

    live = other.state.kf.mask
    if not torch.equal(trk.state.kf.mask, live) or not torch.equal(trk.state.ids, other.state.ids):
        fail(f"{what}: the final masks or ids differ")
    kfx = float((trk.state.kf.x - other.state.kf.x)[live].abs().max()) if live.any() else 0.0
    if not (worst <= 1e-4 and kfx <= 1e-4):
        fail(f"{what}: states7 differ by {worst}, kf.x by {kfx} (tolerance 1e-4)")
    return worst, kfx


def run_clips(label, det, crop, frames, device, n_warm: int, yuv_hw=None, detail: bool = False,
              repeats: int = 3, loop_calls: str | None = None, ignore=None, variant: dict | None = None,
              reference=None, phase: str = "main"):
    """One configuration of the main path through ``track_clips``:

    * a warm-up clip of ``n_warm`` frames (all three branches) on a tracker
      of its own captures the clip's CUDA graphs (the three branches; with
      ``variant``, ``make_mc_clip_step(**variant)``'s graphs);
    * the eager clip on the card (``graphs=False``) over all of ``frames``
      (a multiple of 24);
    * ``repeats`` runs of the captured clip over the same frames, each on a
      fresh tracker that shares the warm-up's graphs, with PyTorch's
      sync-debug mode on: each must equal the eager run (ids, masks,
      classes equal, states7 and the final kf.x within 1e-4; births and
      crop measurements equal) and read the card exactly once a clip and
      nowhere else. Every launch count is set to 0 just before the first
      and read just after; they must equal the eager run's. With
      ``reference`` (the three-branch captured run's rows and state) the
      eager and the captured runs must equal it as well.

    With ``detail``, the eager branches are profiled and the NMS and auction
    calls of one detect and one crop frame are replayed and timed (and saved
    to ``loop_calls`` when it is given). ``ignore`` gives every tracker
    these ignore polygons (the bank's grid is then read inside the graphs).

    Returns a dict: the median frames/s and each run's, the eager frames/s,
    the launch counts, the crop and detect frame counts, the graphs'
    replay medians, the peak device memory, and the first captured run's
    rows and final state (``kept``)."""
    import types
    import warnings

    import torch

    from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs

    variant = variant or {}
    reg, cfg = bench_registry(), tracker_config()
    counters = kernel_counters()
    warm = make_tracker(reg, det, crop, cfg, device, N_SEED, ignore=ignore)
    if variant:
        warm._clip = variant_clip(warm, det, crop, True, variant)
    warm.track_clips(sources(frames[:n_warm]), clip_len=n_warm, yuv_hw=yuv_hw)
    torch.cuda.synchronize()
    clip = warm._clip_fn()
    captured = sorted(name for _, programs in clip_programs(clip) for name in programs.graphs)
    if captured != captured_names(variant):
        fail(f"{phase} ({label}): the warm-up captured {captured}, not {captured_names(variant)}")

    def timed(trk, watch_syncs: bool = False):
        for fn in counters.values():
            fn.launches = 0
        DeviceRounds.reset()
        syncs0, loops0 = HostSyncs.count, dict(HostSyncs.by_loop)
        conf_cnt0 = trk.state.conf_cnt.clone()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.time()
        s.record()
        # PyTorch's sync-debug mode warns at every call that waits for the
        # card (.item(), .cpu(), a blocking copy, a stream or device sync)
        torch.cuda.set_sync_debug_mode("warn" if watch_syncs else 0)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                stats = trk.track_clips(sources(frames), clip_len=T_CLIP, yuv_hw=yuv_hw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        e.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        syncing = [f"{w.filename}:{w.lineno}" for w in caught if "synchronizing CUDA operation" in str(w.message)]
        if syncing:
            fail(f"{phase} ({label}): {len(syncing)} synchronizing calls inside track_clips, at "
                 f"{sorted(set(syncing))}")
        loops = {k: v - loops0.get(k, 0) for k, v in HostSyncs.by_loop.items() if v - loops0.get(k, 0)}
        return dict(fps=frames.shape[0] / s.elapsed_time(e) * 1e3, wall=wall, stats=stats,
                    launches={name: fn.launches for name, fn in counters.items()},
                    syncs=HostSyncs.count - syncs0, loops=loops, rounds=DeviceRounds.read(),
                    outcome=clip_outcome(trk, conf_cnt0), trk=trk)

    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    eager_trk = make_tracker(reg, det, crop, cfg, device, N_SEED, graphs=False, ignore=ignore)
    if variant:
        eager_trk._clip = variant_clip(eager_trk, det, crop, False, variant)
    ref = timed(eager_trk)
    n_frames, n_clips = frames.shape[0], -(-frames.shape[0] // T_CLIP)
    eager = ref["trk"]
    if len(eager.rows) != n_frames:
        fail(f"{phase} ({label}): the eager clip gave {len(eager.rows)} rows for {n_frames} frames")
    if reference is not None:
        ediff = rows_diff(f"{phase} ({label}): the eager clip against the three-branch captured clip", eager,
                          reference)

    runs = []
    for r in range(repeats):
        trk = make_tracker(reg, det, crop, cfg, device, N_SEED, ignore=ignore)
        trk._clip = clip
        run = timed(trk, watch_syncs=True)
        if run["syncs"] != n_clips or run["loops"] != {"drain": n_clips}:
            fail(f"{phase} ({label}): {run['syncs']} host reads ({run['loops']}) for {n_clips} clips; "
                 f"exactly one a clip is the contract")
        run["diff"] = rows_diff(f"{phase} ({label}): graph run {r} against the eager clip", trk, eager)
        if reference is not None:
            run["diff"] = rows_diff(f"{phase} ({label}): graph run {r} against the three-branch captured clip",
                                    trk, reference)
        if run["outcome"] != ref["outcome"] or run["rounds"] != ref["rounds"]:
            fail(f"{phase} ({label}): births / crop measurements {run['outcome']} or rounds {run['rounds']} differ "
                 f"from the eager clip's {ref['outcome']} / {ref['rounds']}")
        if r == 0 and run["launches"] != ref["launches"]:
            fail(f"{phase} ({label}): the graph run credited {run['launches']} launches, the eager run made "
                 f"{ref['launches']}")
        runs.append(run)
    if len(clip.runners) != 1:
        fail(f"{phase} ({label}): the timed runs made {len(clip.runners)} runners; the warm-up's graphs serve all")

    crop_frames = [k for k in range(n_frames) if k % cfg.det_step and k % cfg.skip_step == 0]
    n_detect = sum(1 for k in range(n_frames) if k % cfg.det_step == 0)
    live_at_crop = [len(eager.rows[k][2]) for k in crop_frames]
    births, crop_measured = ref["outcome"]
    if births <= 0:
        fail(f"{phase} ({label}): the detector produced no births")
    if min(live_at_crop) == 0 or crop_measured <= 0:
        fail(f"{phase} ({label}): crop frames found no live tracks ({live_at_crop}) or updated none")
    fps = [run["fps"] for run in runs]
    first = runs[0]
    peak = torch.cuda.max_memory_allocated()
    log(f"{phase} ({label}): {n_frames} frames ({n_detect} detect, {len(crop_frames)} crop) of 1x{H}x{W}, "
        f"{n_clips} clips: graphs {float(np.median(fps)):.2f} frames/s median of {repeats} "
        f"({', '.join(f'{f:.2f}' for f in fps)}; CUDA events), eager {ref['fps']:.2f} frames/s; host wall "
        f"{first['wall']:.2f} s; peak device memory {peak / 2**30:.2f} GiB ({(peak - base_bytes) / 2**30:.2f} GiB "
        f"above what was allocated before the eager run)")
    against = "the eager run and the three-branch captured clip" if reference is not None else "the eager run"
    log(f"{phase} ({label}): graph runs equal {against}: ids/raw_mask/classes equal, states7 within "
        f"{max(run['diff'][0] for run in runs):.3g}, final kf.x within {max(run['diff'][1] for run in runs):.3g} "
        f"(tolerance 1e-4)" + (f"; the eager run within {ediff[0]:.3g} / {ediff[1]:.3g} of the three-branch clip"
                               if reference is not None else "")
        + f"; births {births}, crop measurements {crop_measured:.0f}, live tracks at crop frames {live_at_crop}")
    timers = {k: v for k, v in first["stats"].items() if k not in ("frames", "fps", "detect", "crop")}
    log(f"{phase} ({label}): host time in the first graph run (wall {first['wall'] * 1e3:.1f} ms): "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in timers.items())
        + " (the producer thread's source, stack: pulling and stacking the cameras' frames; stage: filling "
        "pinned buffers and queueing the copies; put_wait: the queue full; the consumer's get_wait: the queue "
        "empty; enqueue: enqueueing the clips; drain: reading back and unpacking, drain_wait its wait)")
    log(f"{phase} ({label}): host reads {first['syncs']} ({first['loops']}; the eager run {ref['syncs']}), none "
        f"inside a clip (sync-debug mode); device rounds {first['rounds']} "
        f"({first['rounds']['nms'] / n_frames:.2f} NMS and {first['rounds']['auction'] / n_frames:.2f} auction "
        f"a frame); kernel launches {first['launches']}")
    replay = graph_detail(clip, label, phase)
    n_pass = n_frames - n_detect - len(crop_frames)
    if variant.get("unroll"):
        branch_ms = n_clips * replay["clip"]
    else:
        branch_ms = (n_detect * (replay.get("frame", 0.0) + replay["detect"]) + len(crop_frames) * replay["crop"]
                     + n_pass * replay["passthrough"] + n_clips * replay.get("batched", 0.0))
    log(f"{phase} ({label}): the graphs' replays alone take {branch_ms:.2f} ms for these {n_frames} frames "
        f"({n_frames / branch_ms * 1e3:.1f} frames/s if nothing else ran); the timed runs took "
        + ", ".join(f"{n_frames / run['fps'] * 1e3:.2f}" for run in runs) + " ms")
    if detail:
        frames_dev = torch.as_tensor(frames[:1]).to(device)  # [C=1,...]
        profile_branches(eager, frames_dev, device, label + ", eager")
        per_clip = {"detect": n_detect // n_clips, "crop": len(crop_frames) // n_clips}
        time_tracker_loops(tracker_loop_calls(eager, frames_dev, device), per_clip, label, save=loop_calls)
    kept = types.SimpleNamespace(rows=first["trk"].rows, state=first["trk"].state)
    return dict(fps=float(np.median(fps)), runs=fps, eager_fps=ref["fps"], launches=first["launches"],
                n_crop=len(crop_frames), n_detect=n_detect, n_clips=n_clips, replay=replay, peak=peak, kept=kept)


def phase_main(device, loop_calls: str | None = None):
    """The shipped configuration at full width, then the three comparison
    configurations in the same run (the shipped one's NMS and auction calls
    saved to ``loop_calls`` when it is given). Returns the launches of each
    kernel on the path that runs it, and what the variants phase holds its
    clips against: for the shipped and the conv7 configuration, the models,
    frames and result of the three-branch captured run."""
    phase_small_reference(device)

    _, cfg, (det_f, crop_f), (det_q, crop_q), _ = shipped_models(device)
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (2 * T_CLIP, H, W, 3), dtype=np.uint8)
    packed = pack_frames(raw)
    seen = record_qconv_shapes(device)
    per_detect, per_crop = sum(seen["detect"].values()), sum(seen["crop"].values())

    # the shipped configuration: uint8 s2d frames, s2d stems, int8 nets
    res = run_clips("s2d + int8", det_q, crop_q, packed, device, T_CLIP, detail=True, loop_calls=loop_calls)
    launches, n_crop, n_detect = res["launches"], res["n_crop"], res["n_detect"]
    if launches["crop_and_resize_s2d"] != n_crop:
        fail(f"main: crop_and_resize_s2d launched {launches['crop_and_resize_s2d']} times for {n_crop} crop frames")
    if launches["qconv"] != n_detect * per_detect + n_crop * per_crop:
        fail(f"main: qconv launched {launches['qconv']} times, expected {n_detect} x {per_detect} + {n_crop} x {per_crop}")
    q_counts = quantize_counts(device)
    if launches["quantize"] != n_detect * q_counts["detect"] + n_crop * q_counts["crop"]:
        fail(f"main: quantize launched {launches['quantize']} times, expected {n_detect} x {q_counts['detect']} + "
             f"{n_crop} x {q_counts['crop']}")
    if launches["crop_and_resize"] or launches["yuv420_flat_to_s2d"]:
        fail(f"main: the s2d path launched a kernel of another path: {launches}")
    if launches["nms"] < 1 or launches["auction"] < 1:
        fail(f"main: the NMS or auction kernel was launched no time: {launches}")
    report = {"s2d + int8": res["fps"]}
    path_launches = {k: launches[k] for k in ("crop_and_resize_s2d", "qconv", "quantize", "nms", "auction")}
    refs = {"s2d + int8": (det_q, crop_q, packed, res)}

    # comparisons, one clip each after a short warm-up
    res_f = run_clips("s2d + float", det_f, crop_f, packed[:T_CLIP], device, 6)
    l_f = res_f["launches"]
    if l_f["qconv"] or l_f["quantize"] or l_f["crop_and_resize_s2d"] != res_f["n_crop"]:
        fail(f"main: the float s2d path's launches are off: {l_f}")
    report["s2d + float"] = res_f["fps"]

    reg = bench_registry()
    det_c, crop_c = build_models(device, crop_target(reg, cfg, N_SEED), stem="conv7")
    res_c = run_clips("conv7 + float", det_c, crop_c, raw[:T_CLIP], device, 6)
    l_c = res_c["launches"]
    if l_c["crop_and_resize"] != res_c["n_crop"] or l_c["qconv"] or l_c["crop_and_resize_s2d"]:
        fail(f"main: the conv7 path's launches are off: {l_c}")
    report["conv7 + float"] = res_c["fps"]
    path_launches["crop_and_resize"] = l_c["crop_and_resize"]
    refs["conv7 + float"] = (det_c, crop_c, raw[:T_CLIP], res_c)

    # with an ignore region over the image's right half: its grid is read
    # inside the captured branches, and one read a clip must still hold
    yuv = rng.integers(0, 256, (T_CLIP, H * W * 3 // 2), dtype=np.uint8)
    right_half = {"p1c1": np.array([[W / 2, 0.0], [W, 0.0], [W, H], [W / 2, H]])}
    res_y = run_clips("YUV420 bytes -> s2d + int8, ignore region", det_q, crop_q, yuv, device, 6,
                      yuv_hw=(H, W), ignore=right_half)
    l_y = res_y["launches"]
    if l_y["yuv420_flat_to_s2d"] != 1 or l_y["crop_and_resize_s2d"] != res_y["n_crop"]:
        fail(f"main: the YUV path's launches are off: {l_y}")
    report["yuv + int8"] = res_y["fps"]
    path_launches["yuv420_flat_to_s2d"] = l_y["yuv420_flat_to_s2d"]

    log("main: frames/s of the captured clips side by side, medians, one call, one card: "
        + ", ".join(f"{k} {v:.2f}" for k, v in report.items()))
    return path_launches, refs


# ---------------------------------------------------------------------------
# the JAX clip's two variants
# ---------------------------------------------------------------------------


def random_head_detector(device, quantized: bool = True):
    """The shipped int8 detector with random output convs (weights N(0,
    0.01), seed 17), quantized on the calibration frame: every logit and
    box depends on its own image's pixels (``quantized=False``: the float
    detector it was quantized from). Built once."""
    import torch

    from playground3d_tpu_torch.models.quant import quantize_detector

    if "random_head" not in _CACHE:
        _, _, (det_f, _), _, calib = shipped_models(device)
        det = copy.deepcopy(det_f)
        gen = torch.Generator().manual_seed(17)
        with torch.no_grad():
            for conv in (det.heads.cls_out, det.heads.reg_out):
                conv.w.copy_(torch.randn(conv.w.shape, generator=gen) * 0.01)
        _CACHE["random_head_float"] = det
        _CACHE["random_head"] = quantize_detector(det, calib[None])
    return _CACHE["random_head" if quantized else "random_head_float"]


def batched_detections(device, n: int = 4):
    """The batched detector pass of ``batch_detects`` (``detect_frames``:
    one forward over ``n`` 1080p frames, ``qconv`` at N ``n``) against ``n``
    single-frame ``detect_multiframe`` calls, for the shipped int8 detector
    with random output convs (so that every logit and box depends on the
    pixels; the main path's are zero, so the clips' own equality cannot see
    a frame's detections handed to another): the forward's outputs and the
    detections must be equal bit for bit (int8 accumulates exactly); a
    difference fails, reported with where it lies and how large it is."""
    import torch

    from playground3d_tpu_torch.models.retinanet import detect_frames, detect_multiframe, forward_raw

    _, cfg, _, _, _ = shipped_models(device)
    det_q = random_head_detector(device)
    raw = np.random.default_rng(23).integers(0, 256, (n, H, W, 3), dtype=np.uint8)
    frames = torch.as_tensor(pack_frames(raw)).to(device)[:, None]  # [n, C=1, ...]
    kw = dict(pre_topk=cfg.pre_topk, max_dets=cfg.max_dets, min_level=cfg.det_min_level)
    batched = forward_raw(det_q, frames[:, 0], compact=True, min_level=cfg.det_min_level, score_path=True)
    single = [forward_raw(det_q, frames[j], compact=True, min_level=cfg.det_min_level, score_path=True)
              for j in range(n)]
    parts, forward_differs = [], False
    for name, b, s in zip(("max logit", "class", "regression"), batched, zip(*single)):
        s = torch.cat(s)
        differ = int((b != s).sum())
        forward_differs |= differ > 0
        parts.append(f"{name} {differ} of {b.numel()} differ"
                     + (f" (max abs {float((b.float() - s.float()).abs().max()):.4g})" if differ else ""))
    got = detect_frames(det_q, frames, **kw)
    det_differ = []
    for j in range(n):
        one = detect_multiframe(det_q, frames[j], **kw)
        for f in one._fields:
            if not torch.equal(getattr(got, f)[j], getattr(one, f)):
                det_differ.append(f"frame {j} {f}")
    kept = int(got.mask.sum())
    log(f"variants: the batched detector pass at N {n} (qconv at N {n}; random output convs, int8) against {n} "
        f"single-frame passes: forward {', '.join(parts)}; detections ({kept} kept) "
        + ("bit-equal" if not det_differ else f"differ in {det_differ}"))
    if kept == 0:
        fail("variants: the batched detector pass kept no detection")
    if forward_differs or det_differ:
        fail("variants: the batched detector pass differs from the single-frame passes")


def phase_variants(device, refs: dict) -> None:
    """``make_mc_clip_step(batch_detects=True)`` and ``(unroll=True)`` at
    full width, called directly as ``bench.py`` calls them: the shipped
    configuration (s2d + int8, ``bench_config.json``'s knobs) over the main
    phase's two 24-frame clips, each variant one eager clip and three
    captured runs that must equal the three-branch captured clip and read
    the card once a clip; launches a clip checked against the counts the
    code implies. Then the conv7 + float unrolled clip, held against its
    three-branch clip, so ``crop_resize.cu`` runs inside the one clip
    graph."""
    t_phase = time.time()
    seen = record_qconv_shapes(device)
    per_detect, per_crop = sum(seen["detect"].values()), sum(seen["crop"].values())
    q_counts = quantize_counts(device)
    batched_detections(device)
    det_q, crop_q, packed, res = refs["s2d + int8"]
    base = res["launches"]
    report = {"three branches": (res["fps"], res["runs"], res["peak"])}
    for name, variant in (("batch_detects", dict(batch_detects=True)), ("unroll", dict(unroll=True))):
        out = run_clips(f"s2d + int8, {name}", det_q, crop_q, packed, device, T_CLIP, variant=variant,
                        reference=res["kept"], phase="variants")
        got, n_clips, n_crop = out["launches"], out["n_clips"], out["n_crop"]
        want = dict(base)
        if name == "batch_detects":  # one detector forward a clip, over its 4 detect frames
            want["qconv"] = n_clips * per_detect + n_crop * per_crop
            want["quantize"] = n_clips * q_counts["detect"] + n_crop * q_counts["crop"]
        if got != want:
            fail(f"variants ({name}): launches {got}, the code implies {want}")
        log(f"variants (s2d + int8, {name}): launches a clip "
            + ", ".join(f"{k} {v // n_clips}" for k, v in got.items() if v)
            + f" (three branches: qconv {base['qconv'] // n_clips} a clip), as the code implies")
        report[name] = (out["fps"], out["runs"], out["peak"])

    det_c, crop_c, raw, res_c = refs["conv7 + float"]
    out = run_clips("conv7 + float, unroll", det_c, crop_c, raw, device, T_CLIP, variant=dict(unroll=True),
                    reference=res_c["kept"], phase="variants")
    if out["launches"] != res_c["launches"] or out["launches"]["crop_and_resize"] != out["n_crop"]:
        fail(f"variants (conv7 unroll): launches {out['launches']}, the three-branch clip's {res_c['launches']}")
    log("variants: s2d + int8 frames/s, medians (each run; peak device memory), one call, one card: "
        + "; ".join(f"{k} {v[0]:.2f} ({', '.join(f'{f:.2f}' for f in v[1])}; {v[2] / 2**30:.2f} GiB)"
                    for k, v in report.items())
        + f"; conv7 + float unrolled {out['fps']:.2f} against its three branches {res_c['fps']:.2f}")
    log(f"variants: phase took {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the device mesh: the camera-sharded clip and data-parallel training
# ---------------------------------------------------------------------------

MESH_CAMERAS = (("p1c1", 0.0), ("p1c2", 100.0), ("p1c3", 200.0), ("p1c4", 300.0))  # poles 100 ft apart


def mesh_tracker(det, crop, device, graphs: bool = True):
    """The 4-camera tracker at the shipped knobs, live tracks seeded in
    camera 0's view."""
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker

    reg = bench_registry(cameras=MESH_CAMERAS)
    centers = np.array([[565.0 + dx, 60.0] for _, dx in MESH_CAMERAS], np.float32)
    trk = MultiCameraTracker(reg, [name for name, _ in MESH_CAMERAS], cfg=tracker_config(), det_model=det,
                             crop_model=crop, centers=centers, stem="s2d", crop_stem="s2d", device=device,
                             graphs=graphs)
    trk.state = seed_tracks(trk.state, N_SEED)
    return trk


def camera_sources(frames: np.ndarray, t0: float = 1.6e9):
    """Each camera's (frame, time) stream from [T,C,...] frames."""
    def camera(c):  # a function, so that each generator keeps its own camera
        return ((frames[k, c], t0 + k / 30.0) for k in range(frames.shape[0]))

    return [camera(c) for c in range(frames.shape[1])]


def sync_all() -> None:
    import torch

    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def mesh_track(det, crop, frames, device, mesh=None, variant=None, clip=None, watch: bool = False,
               yuv_hw=None):
    """One run of the 4-camera tracker through ``track_clips`` (camera-
    sharded over ``mesh`` when one is given; ``frames`` YUV420 bytes of
    ``yuv_hw`` when it is given) on ``clip`` (an earlier run's,
    with its graphs) or on a new clip step of ``variant``; every count set
    to 0 just before and read just after. With ``watch``, under PyTorch's
    sync-debug mode: any synchronizing call inside fails. -> (tracker, its
    clip, camera-frames/s by the host's clock around the run and a
    synchronize of every card, host reads, launches)."""
    import warnings

    import torch

    from playground3d_tpu_torch.ops.topk import HostSyncs
    from playground3d_tpu_torch.pipeline.multi_cam import make_mc_clip_step

    trk = mesh_tracker(det, crop, device)
    if clip is None:
        clip = make_mc_clip_step(det, trk.bank, trk.centers, trk.kfp, trk.cfg, crop_model=crop, stem="s2d",
                                 crop_stem="s2d", mesh=mesh, **(variant or {}))
    if mesh is None:
        trk._clip = clip
    else:
        trk._mesh_clips[mesh] = clip
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    syncs0 = HostSyncs.count
    sync_all()
    t0 = time.time()
    torch.cuda.set_sync_debug_mode("warn" if watch else 0)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            trk.track_clips(camera_sources(frames), clip_len=T_CLIP, mesh=mesh, yuv_hw=yuv_hw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_all()
    wall = time.time() - t0
    syncing = [f"{w.filename}:{w.lineno}" for w in caught if "synchronizing CUDA operation" in str(w.message)]
    if syncing:
        fail(f"mesh: {len(syncing)} synchronizing calls inside track_clips, at {sorted(set(syncing))}")
    return (trk, clip, frames.shape[0] * frames.shape[1] / wall, HostSyncs.count - syncs0,
            {k: fn.launches for k, fn in counters.items()})


def mesh_graph_lines(clip, label: str, n_frames: int, n_cams: int) -> float:
    """Each shard's graphs and the lead's: nodes, launches a replay, replay
    time; -> the camera-frames/s the replays alone allow: the lead's
    replays after the busiest card's shard replays (shards on one card
    replay one after another)."""
    cfg = tracker_config()
    n_detect = len(range(0, n_frames, cfg.det_step))
    n_crop = sum(1 for k in range(n_frames) if k % cfg.det_step and k % cfg.skip_step == 0)
    per_frame = {"frame": n_detect, "batched": -(-n_frames // T_CLIP), "detect": n_detect, "crop": n_crop,
                 "passthrough": n_frames - n_detect - n_crop}
    shard_ms, lead_ms = {}, 0.0  # shard device -> its shards' replay ms a run
    for where, prog in clip_programs(clip):
        for name, (graph, tally) in prog.graphs.items():
            ms = graph_replay_ms(graph, prog.device)
            if where == "lead":
                lead_ms += per_frame[name] * ms
            else:
                shard_ms[prog.device] = shard_ms.get(prog.device, 0.0) + per_frame[name] * ms
            log(f"mesh ({label}): {where} {prog.device}: graph {name}: {graph_nodes(graph)} nodes, launches a "
                f"replay { {k.__name__: v for k, v in tally.items()} }, replay {ms:.3f} ms median of 5 (CUDA events)")
    return n_frames * n_cams / (max(shard_ms.values(), default=0.0) + lead_ms) * 1e3


def peer_copy_ms(clip, mesh) -> float:
    """The crop frame's gather to the lead (one copy a shard into the crop
    branch's static buffer, as the clip makes it): median of 20, CUDA
    events on the lead."""
    import torch

    from playground3d_tpu_torch.pipeline.multi_cam import _copy_parts

    runner = next(iter(clip.runners.values()))
    dst = runner.inputs["crop"]
    parts = [sd.frames["frame"] for sd in next(iter(clip.shard_runners.values()))]
    times = []
    for _ in range(20):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(torch.cuda.current_stream(mesh.lead))
        _copy_parts(dst, parts)
        e.record(torch.cuda.current_stream(mesh.lead))
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def mesh_clips(device, refs: dict) -> None:
    """4 cameras of 1080p s2d + int8 (the main phase's packed frames, each
    camera another offset into them), the detector with random output
    convs: the unsharded captured clip, then the camera-sharded clip over
    each mesh (every visible card, and on one card that card listed twice),
    the three-branch clip and ``batch_detects``, each a warm-up that
    captures and a run under the sync-debug mode that must read the card
    once and equal the unsharded rows; ``unroll`` with a mesh raises."""
    import torch

    from playground3d_tpu_torch.parallel.mesh import make_mesh
    from playground3d_tpu_torch.pipeline.multi_cam import make_mc_clip_step

    _, crop_q, packed, _ = refs["s2d + int8"]
    det = random_head_detector(device)
    n_cams, n_frames = len(MESH_CAMERAS), 2 * T_CLIP
    frames = np.stack([packed[(np.arange(n_frames) + 12 * c) % packed.shape[0]] for c in range(n_cams)], axis=1)
    n_cards = torch.cuda.device_count()
    n_mesh = max(k for k in (1, 2, 4) if k <= n_cards)  # the 4 cameras divide over 1, 2 or 4 cards
    meshes = {f"{n_mesh} of the {n_cards} visible card(s)": make_mesh(n_mesh)}
    if n_cards == 1:
        meshes["cuda:0 listed twice"] = make_mesh(devices=["cuda:0", "cuda:0"])

    n_clips = n_frames // T_CLIP
    _, clip, _, _, _ = mesh_track(det, crop_q, frames[:T_CLIP], device)  # captures
    ref, _, ref_fps, syncs, ref_launches = mesh_track(det, crop_q, frames, device, clip=clip, watch=True)
    if syncs != n_clips:
        fail(f"mesh: the unsharded clip read the card {syncs} times for {n_clips} clips")
    births = int(ref.state.next_id) - N_SEED
    dets = sum(len(r[2]) for r in ref.rows)
    ref_replay = mesh_graph_lines(clip, "unsharded", n_frames, n_cams)
    log(f"mesh: unsharded captured clip, {n_cams} cameras x {n_frames} frames of {H}x{W} s2d + int8, random output "
        f"convs: {ref_fps:.1f} camera-frames/s (host clock, {n_clips} clips), the replays alone "
        f"{ref_replay:.1f}; births {births}, track rows {dets}; launches {ref_launches}")
    if births <= 0:
        fail("mesh: the random-head detector produced no births")
    check_quantize_launches("mesh (unsharded)", ref_launches, device)

    fps = {"unsharded": (ref_fps, ref_replay)}
    for label, mesh in meshes.items():
        for name, variant in (("three branches", {}), ("batch_detects", dict(batch_detects=True))):
            tag = f"{label}, {name}"
            _, clip, _, _, _ = mesh_track(det, crop_q, frames[:T_CLIP], device, mesh, variant)
            trk, _, f, syncs, launches = mesh_track(det, crop_q, frames, device, mesh, clip=clip, watch=True)
            if syncs != n_clips:
                fail(f"mesh ({tag}): {syncs} host reads for {n_clips} clips; one a clip is the contract")
            worst, kfx = rows_diff(f"mesh ({tag}) against the unsharded clip", trk, ref)
            shards = next(iter(clip.shard_runners.values()))
            if len(shards) != mesh.size or any(not sd.programs.graphs for sd in shards):
                fail(f"mesh ({tag}): not every shard captured its graphs")
            replay = mesh_graph_lines(clip, tag, n_frames, n_cams)
            log(f"mesh ({tag}): {mesh.size} shards on {[str(d) for d in mesh.devices]}: {f:.1f} camera-frames/s "
                f"(unsharded {ref_fps:.1f}, same call), the replays alone {replay:.1f} (unsharded {ref_replay:.1f}); "
                f"rows equal the unsharded clip's (ids, raw_mask, classes; states7 within {worst:.3g}, kf.x within "
                f"{kfx:.3g}, tolerance 1e-4); one host read a clip; launches {launches} (unsharded {ref_launches})")
            if launches["qconv"] < 1 or launches["nms"] < 1 or launches["auction"] < 1 or \
                    launches["crop_and_resize_s2d"] < 1:
                fail(f"mesh ({tag}): a kernel of the path was launched no time: {launches}")
            check_quantize_launches(f"mesh ({tag})", launches, device)
            fps[tag] = (f, replay)
            if name == "three branches":
                log(f"mesh ({tag}): the crop frame's gather of {n_cams} cameras to the lead: "
                    f"{peer_copy_ms(clip, mesh):.3f} ms median of 20 (CUDA events"
                    + ("; one card: copies within it, not NVLink)" if len(set(mesh.devices)) == 1 else ")"))
        try:
            make_mc_clip_step(det, ref.bank, ref.centers, ref.kfp, ref.cfg, crop_model=crop_q, stem="s2d",
                              crop_stem="s2d", mesh=mesh, unroll=True)
            fail(f"mesh ({label}): unroll with a mesh did not raise")
        except ValueError:
            pass
    log("mesh: camera-frames/s side by side, one call (host clock; the replays alone): "
        + ", ".join(f"{k} {v[0]:.1f} ({v[1]:.1f})" for k, v in fps.items()) + "; unroll with a mesh raises ValueError")
    mesh_yuv(det, crop_q, device, meshes)


def mesh_yuv(det, crop, device, meshes: dict) -> None:
    """YUV420 bytes in (one 24-frame clip of the 4 cameras): the unsharded
    clip, then the camera-sharded clip over each mesh, where each shard
    converts its own cameras on its card (``yuv420_s2d.cu``); rows equal
    the unsharded clip's, one host read a clip."""
    from playground3d_tpu_torch.pipeline import multi_cam as PMC

    n_cams = len(MESH_CAMERAS)
    yuv = np.random.default_rng(7).integers(0, 256, (T_CLIP, n_cams, H * W * 3 // 2), dtype=np.uint8)
    convert, converted = PMC.yuv420_flat_to_s2d, []  # (device, cameras) of each conversion
    PMC.yuv420_flat_to_s2d = lambda ft, hw: converted.append((str(ft.device), ft.shape[1])) or convert(ft, hw)
    try:
        _, clip, _, _, _ = mesh_track(det, crop, yuv, device, yuv_hw=(H, W))  # captures
        converted.clear()
        ref, _, ref_fps, syncs, ref_launches = mesh_track(det, crop, yuv, device, clip=clip, watch=True,
                                                          yuv_hw=(H, W))
        if syncs != 1 or ref_launches["yuv420_flat_to_s2d"] != 1 or converted != [(str(device), n_cams)]:
            fail(f"mesh (YUV420): the unsharded clip read the card {syncs} times, converted {converted}, "
                 f"launches {ref_launches}")
        log(f"mesh (unsharded, YUV420 bytes): {ref_fps:.1f} camera-frames/s (host clock, one clip); track rows "
            f"{sum(len(r[2]) for r in ref.rows)}; conversions {converted}; launches {ref_launches}")
        for label, mesh in meshes.items():
            tag = f"{label}, YUV420 bytes"
            _, clip, _, _, _ = mesh_track(det, crop, yuv, device, mesh, yuv_hw=(H, W))
            converted.clear()
            trk, _, f, syncs, launches = mesh_track(det, crop, yuv, device, mesh, clip=clip, watch=True,
                                                    yuv_hw=(H, W))
            worst, kfx = rows_diff(f"mesh ({tag}) against the unsharded YUV clip", trk, ref)
            want = [(str(d), n_cams // mesh.size) for d in mesh.devices]
            if syncs != 1 or launches["yuv420_flat_to_s2d"] != mesh.size or converted != want:
                fail(f"mesh ({tag}): {syncs} host reads, conversions {converted} (want {want}), launches {launches}")
            log(f"mesh ({tag}): {f:.1f} camera-frames/s (unsharded {ref_fps:.1f}, same call); each shard converts "
                f"its cameras on its card: {converted}; rows equal the unsharded clip's (states7 within {worst:.3g}, "
                f"kf.x within {kfx:.3g}); one host read; launches {launches}")
    finally:
        PMC.yuv420_flat_to_s2d = convert


DP_RANK = """
import sys, time
import torch
import torch.distributed as dist
from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
from playground3d_tpu_torch.parallel.mesh import join_data_parallel, make_mesh
from playground3d_tpu_torch.train import trainer as PT

rank, init, out, devices, batch = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4].split(","), int(sys.argv[5])
grads = []  # the flat gradient Adam is given at the first step (before the clip)
adam_step = PT.Optimizer.step
PT.Optimizer.step = lambda self: (grads or grads.append(torch.cat([t.grad.reshape(-1) for t in self.leaves])),
                                  adam_step(self))
mesh = make_mesh(devices=devices)
dev = join_data_parallel(mesh, rank, init)
ds = SyntheticDetectionDataset(image_shape=(64, 128), n_objects=6, seed=2, zoom=8.0, output_dtype="uint8")
tr = PT.Trainer(PT.TrainConfig(depth=18, image_shape=(64, 128)), generator=torch.Generator().manual_seed(rank),
                mesh=mesh)
batches = ds.batches(batch)
losses, step_ms = [], []
for _ in range(3):
    images, labels = next(batches)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    losses.append(float(tr.train_step(images, labels)["loss"]))
    torch.cuda.synchronize(dev)
    step_ms.append((time.perf_counter() - t0) * 1e3)
flat = torch.zeros(sum(t.numel() for t in PT.train_leaves(tr.model).values()) + 4, device=dev)
reduce_ms = []
for _ in range(5):
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    dist.all_reduce(flat)
    torch.cuda.synchronize(dev)
    reduce_ms.append((time.perf_counter() - t0) * 1e3)
torch.save({"losses": losses, "step_ms": step_ms, "reduce_ms": reduce_ms, "numel": flat.numel(),
            "backend": dist.get_backend(), "grad1": grads[0].cpu() if rank == 0 else None,
            "leaves": {k: t.detach().cpu() for k, t in PT.train_leaves(tr.model).items()}}, out)
dist.destroy_process_group()
"""

DP_GRAD_TOL = 1e-3  # the all-reduced gradient against the mean of the ranks' slices' gradients, relative


def slice_grads(trainer, images, labels, row_sets):
    """The flat gradient ``trainer`` hands Adam at a step on each set of
    rows of one batch; no update is made."""
    import torch

    from playground3d_tpu_torch.train import trainer as PT

    out = []
    adam_step = PT.Optimizer.step
    PT.Optimizer.step = lambda self: out.append(torch.cat([t.grad.reshape(-1) for t in self.leaves]))
    try:
        for rows in row_sets:
            trainer.train_step(images[rows], labels[rows])
    finally:
        PT.Optimizer.step = adam_step
    return out


def accumulated_step(trainer, images, labels, row_sets) -> None:
    """The data-parallel step in one process: the mean of the slices'
    gradients, then the clip and Adam."""
    import torch
    from torch._utils import _unflatten_dense_tensors

    mean = torch.stack(slice_grads(trainer, images, labels, row_sets)).mean(0)
    leaves = trainer.opt.leaves
    torch._foreach_copy_([t.grad for t in leaves], _unflatten_dense_tensors(mean, [t.grad for t in leaves]))
    trainer.opt.step()


def rel_diff(a, b) -> float:
    """||a - b|| / ||b|| of two flat tensors, in float64."""
    return float((a.double() - b.double()).norm() / b.double().norm())


def dp_ranks(label: str, device, devices, batch: int) -> None:
    """One process a mesh device of ``devices`` (``DP_RANK``; depth 18,
    64x128, global batch ``batch``, 3 bf16 steps from rank 0's init)
    against one process on ``device`` from the same init:

    * the gradient the ranks hand Adam at step 1 against the mean of the
      gradients that one process computes for each rank's slice of the
      batch: within ``DP_GRAD_TOL`` of its norm (this holds the all-reduce,
      its divide and the slicing; a rank's slice alone, what a missing
      all-reduce leaves, must read more than 10x the tolerance), and,
      reported, both against the one process's gradient of the whole
      batch (bf16 convolutions at another batch size round otherwise);
    * after 3 steps the ranks' parameters bit-equal to each other, within
      0.01 lr of one process that averages the slices' gradients at each
      step, and within 6 lr of one process on the whole batches, losses
      within 1e-3 (relative) of its; the elements beyond 0.01 lr of the
      whole-batch process are counted for both;
    * each rank's steps and an all-reduce of the gradients' flat buffer
      timed on the host's clock."""
    import tempfile

    import torch

    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.parallel.mesh import batch_sharding, make_mesh
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer, train_leaves

    root = tempfile.mkdtemp(dir="_outputs")
    init = f"file://{os.path.abspath(root)}/rendezvous"
    procs = [subprocess.Popen([sys.executable, "-c", DP_RANK, str(r), init, os.path.join(root, f"rank{r}.pt"),
                               ",".join(devices), str(batch)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(len(devices))]
    ds = SyntheticDetectionDataset(image_shape=(64, 128), n_objects=6, seed=2, zoom=8.0, output_dtype="uint8")
    batches = ds.batches(batch)
    steps = [next(batches) for _ in range(3)]
    rows = batch_sharding(make_mesh(devices=devices), batch)
    one, acc = (Trainer(TrainConfig(depth=18, image_shape=(64, 128)), generator=torch.Generator().manual_seed(0),
                        device=device) for _ in range(2))
    whole, *slices = slice_grads(one, *steps[0], [slice(None)] + rows)
    mean = torch.stack(slices).mean(0)
    losses = [float(one.train_step(*b)["loss"]) for b in steps]
    for b in steps:
        accumulated_step(acc, *b, rows)
    logs = [p.communicate(timeout=300)[0] for p in procs]
    if any(p.returncode for p in procs):
        fail(f"mesh ({label}): a rank failed:\n" + "\n".join(x[-3000:] for x in logs))
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(len(devices))]
    dp = ranks[0]["grad1"].to(mean.device)
    g_reduce, g_alone, g_dp, g_mean = (rel_diff(dp, mean), rel_diff(slices[0], mean), rel_diff(dp, whole),
                                       rel_diff(mean, whole))
    lr = TrainConfig().lr
    equal = all(torch.equal(r["leaves"][k], ranks[0]["leaves"][k]) for r in ranks[1:] for k in ranks[0]["leaves"])

    def param_diffs(trainer):
        want = {k: t.detach().cpu() for k, t in train_leaves(trainer.model).items()}
        return torch.cat([(ranks[0]["leaves"][k] - want[k]).abs().reshape(-1) for k in want])

    diffs, acc_diffs = param_diffs(one), param_diffs(acc)
    acc_vs_one = torch.cat([(a.detach() - b.detach()).abs().reshape(-1).cpu() for a, b in
                            zip(train_leaves(acc.model).values(), train_leaves(one.model).values())])
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(ranks[0]["losses"], losses))
    log(f"mesh ({label}): {len(devices)} {ranks[0]['backend']} ranks on {devices} (depth 18, 64x128, global batch "
        f"{batch}, 3 bf16 steps): step 1's gradient within {g_reduce:.3g} of the mean of one process's gradients of "
        f"the ranks' slices (tolerance {DP_GRAD_TOL:g}; rank 0's slice alone {g_alone:.3g}), within {g_dp:.3g} of "
        f"one process's gradient of the whole batch (that mean {g_mean:.3g}); ranks' parameters "
        f"{'bit-equal' if equal else 'DIFFER'}, within {float(acc_diffs.max()) / lr:.3g} lr of one process averaging "
        f"the slices' gradients (tolerance 0.01 lr); against one process on the whole batches: losses "
        f"{ranks[0]['losses']} vs {losses} (max rel {rel:.2e}, tolerance 1e-3), parameters max abs diff "
        f"{float(diffs.max()):.3g} = {float(diffs.max()) / lr:.2f} lr (tolerance 6 lr), {int((diffs > 1e-6).sum())} "
        f"of {diffs.numel()} elements beyond 0.01 lr (the averaging process: {int((acc_vs_one > 1e-6).sum())}); "
        f"step ms per rank {[[round(x, 2) for x in r['step_ms']] for r in ranks]} (host clock, each ended by a "
        f"synchronize), all-reduce of the {ranks[0]['numel']}-float buffer "
        f"{np.median(ranks[0]['reduce_ms']):.2f} ms median of 5")
    if g_reduce > DP_GRAD_TOL or g_alone <= 10 * DP_GRAD_TOL or float(acc_diffs.max()) > 0.01 * lr:
        fail(f"mesh ({label}): step 1's gradient is {g_reduce:.3g} from the mean of the slices' gradients (a slice "
             f"alone {g_alone:.3g}; tolerance {DP_GRAD_TOL:g}), the parameters {float(acc_diffs.max()) / lr:.3g} lr "
             f"from the averaging process's (tolerance 0.01 lr)")
    if not equal or rel > 1e-3 or float(diffs.max()) > 6 * lr:
        fail(f"mesh ({label}): the ranks differ from each other or from the one-process step beyond the tolerance")


def mesh_train(device) -> None:
    """``apps/train_detector.py --dp`` over every visible card (NCCL ranks;
    one card trains as without it), then :func:`dp_ranks` for two gloo
    ranks sharing the card and, with more cards, NCCL ranks over every
    card."""
    import torch

    from playground3d_tpu_torch.apps import train_detector

    os.makedirs("_outputs", exist_ok=True)
    n_cards = torch.cuda.device_count()
    out = os.path.join("_outputs", "mesh_dp.npz")
    t0 = time.time()
    summary = train_detector.main(["--dp", "--depth", "18", "--height", "128", "--width", "192", "--zoom", "4",
                                   "--steps", "3", "--steps-per-epoch", "3", "--batch", str(2 * n_cards),
                                   "--out", out])
    if summary["ranks"] != n_cards or summary["steps"] != 3 or not np.isfinite(summary["epochs"][0]["loss"]):
        fail(f"mesh: train_detector --dp over {n_cards} cards: {summary}")
    log(f"mesh: apps.train_detector --dp over {n_cards} card(s) ({'NCCL ranks' if n_cards > 1 else 'one process'}"
        f"): 3 steps, epoch loss {summary['epochs'][0]['loss']:.5f}, {summary['seconds']:.2f} s of training "
        f"({time.time() - t0:.1f} s with start-up)")
    dp_ranks("one card shared", device, ["cuda:0", "cuda:0"], 4)
    if n_cards > 1:
        dp_ranks("every card", device, [f"cuda:{i}" for i in range(n_cards)], 2 * n_cards)


def phase_mesh(device, refs: dict) -> None:
    """The device mesh on the card(s): the camera-sharded clip and
    data-parallel training (see :func:`mesh_clips`, :func:`mesh_train`)."""
    import torch

    t_phase = time.time()
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    log(f"mesh: {torch.cuda.device_count()} visible card(s): " + "; ".join(
        f"cuda:{i} {torch.cuda.get_device_name(i)} ({lines[i] if i < len(lines) else 'not in nvidia-smi'})"
        for i in range(torch.cuda.device_count())))
    mesh_clips(device, refs)
    mesh_train(device)
    log(f"mesh: phase took {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# spatial partitioning: one frame's width over the mesh
# ---------------------------------------------------------------------------

SPATIAL_F32_TOL = 1e-4  # tests/test_torch_spatial.py's bound: the largest error over the largest output


def rel_errors(got, want) -> "tuple[float, float]":
    """The worst output of a forward against its reference: (largest
    |error| over the largest |output|, ||error|| over ||output||)."""
    mx = nm = 0.0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        mx = max(mx, float((g - w).abs().max() / w.abs().max()))
        nm = max(nm, float((g - w).norm() / w.norm()))
    return mx, nm


def forward_ms(fn, device, iters: int = 5) -> float:
    """Median ms of ``fn()`` between CUDA events on ``device``'s current
    stream, every card synchronized before each call, after a warm-up (the
    outputs are joined on ``device``, which waits for every card's work)."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        sync_all()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record(torch.cuda.current_stream(device))
        fn()
        e.record(torch.cuda.current_stream(device))
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def float32_exact(fn):
    """``fn()`` with TF32 off in cuDNN and matmuls."""
    import torch

    was = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return fn()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = was


def swapped_halos(fn):
    """``fn()`` with the left and right halo columns of every window that
    has both, of equal width, swapped (the canary)."""
    from playground3d_tpu_torch.parallel import spatial as PS

    window = PS._window

    def broken(src, d, line, i, lo, hi, fill=None):
        w = window(src, d, line, i, lo, hi, fill)
        if isinstance(src, PS.Slabs):
            left, right = i * src.width - lo, hi - (i + 1) * src.width
            if left == right > 0:
                a, b = w.narrow(d, 0, left).clone(), w.narrow(d, w.shape[d] - right, right).clone()
                w.narrow(d, 0, left).copy_(b)
                w.narrow(d, w.shape[d] - right, right).copy_(a)
        return w

    PS._window = broken
    try:
        return fn()
    finally:
        PS._window = window


def halo_windows(fn) -> "tuple[int, int, int, float]":
    """One ``fn()`` with its windows recorded: (bytes and pieces the
    windows took from other slabs, joins of slabs onto the lead, ms of the
    windows alone, replayed one after another by the host's clock with
    every card synchronized)."""
    from playground3d_tpu_torch.parallel import spatial as PS

    window, calls = PS._window, []
    PS._window = lambda *a: calls.append(a) or window(*a)
    PS.HALO.update(bytes=0, copies=0, joins=0)
    try:
        fn()
    finally:
        PS._window = window
    took = dict(PS.HALO)
    sync_all()
    t0 = time.perf_counter()
    for a in calls:
        window(*a)
    sync_all()
    return took["bytes"], took["copies"], took["joins"], (time.perf_counter() - t0) * 1e3


def window_ops(fn) -> list:
    """``fn()`` with each conv, int8 conv and max pool that runs on slabs
    run a second time whole, on its joined input on the lead (the unsharded
    op on the same values): one row a split op, in order: (kind, output
    shape, dtype, values that differ, excess). A halo fault shows in the op
    it is made in, before the network carries it on.

    An int8 conv and a max pool must equal the unsharded op: excess is the
    largest difference. A float conv may add in another order (cuDNN picks
    its algorithm by shape): excess is the largest difference over the
    bound that rounding allows any two orders, element by element,
    ``2 g S + u (|a| + |b| + |a - bias| + |b - bias|)``: ``S`` the conv of
    the input's and the weight's magnitudes (in float64, the operands cast
    as the conv casts them), ``g = K e / (1 - K e)`` for the K = Cin k k
    products summed in float32 (``e`` = 2^-24), ``u`` the unit roundoff of
    the output (bfloat16 2^-8, float32 2^-24) for the conv's and the bias
    add's roundings, ``a`` and ``b`` the two outputs. It must be at most 1."""
    import torch
    import torch.nn.functional as F

    from playground3d_tpu_torch.models.nn import Conv, same_pads
    from playground3d_tpu_torch.parallel import spatial as PS

    split, conv_op, rows, convs = PS._split_conv, PS._SPLIT[Conv.forward], [], []

    def noted(conv, x, stride=1, dtype=torch.bfloat16, pads=None):
        convs.append((conv, dtype))
        try:
            return conv_op(conv, x, stride, dtype, pads)
        finally:
            convs.pop()

    def checked(x, k, stride, run, fill):
        out = split(x, k, stride, run, fill)
        if not isinstance(out, PS.Slabs):
            return out
        whole = x.join()
        got, want = out.join().double(), run(0, whole, None, 0, out.size).double()
        kind = "qconv" if x.dtype == torch.int8 else "pool" if fill else "conv"
        excess = float((got - want).abs().max())
        if kind == "conv":
            conv, dtype = convs[-1]
            ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride)
            mag = F.pad(whole.to(dtype).double().abs(), (pw[0], pw[1], ph[0], ph[1]))
            S = F.conv2d(mag, conv.w.to(dtype).double().abs(), stride=stride)
            K, e = conv.w[0].numel(), 2.0 ** -24
            u = {torch.bfloat16: 2.0 ** -8, torch.float32: e}[dtype]
            b = 0 if conv.b is None else conv.b.to(dtype).double()[None, :, None, None]
            bound = 2 * K * e / (1 - K * e) * S + u * (got.abs() + want.abs() + (got - b).abs() + (want - b).abs())
            excess = float(((got - want).abs() / bound.clamp_min(1e-300)).max())
        rows.append((f"{kind} {k}x{k}/{stride}", tuple(want.shape), out.dtype, int((got != want).sum()), excess))
        return out

    PS._split_conv, PS._SPLIT[Conv.forward] = checked, noted
    try:
        fn()
    finally:
        PS._split_conv, PS._SPLIT[Conv.forward] = split, conv_op
    return rows


def op_faults(rows) -> list:
    """The window ops that miss their bound (see :func:`window_ops`)."""
    return [(i, r) for i, r in enumerate(rows) if (r[4] > 1 if r[0].startswith("conv") else r[4] != 0)]


def first_differing(rows) -> str:
    """How many window ops differ from the unsharded op, the first, and
    the float conv nearest its rounding bound."""
    differs = [(i, r) for i, r in enumerate(rows) if r[3]]
    if not differs:
        return f"all {len(rows)} equal"

    def say(i, r):
        excess = f"{r[4]:.3g} of its rounding bound" if r[0].startswith("conv") else f"by up to {r[4]:.3g}"
        return f"op {i + 1} ({r[0]} -> {list(r[1])} {str(r[2])[6:]}: {r[3]:,} of {int(np.prod(r[1])):,} values, {excess})"

    floats = [(i, r) for i, r in enumerate(rows) if r[0].startswith("conv")]
    worst = f", nearest its bound {say(*max(floats, key=lambda ir: ir[1][4]))}" if floats else ""
    return f"{len(differs)} of {len(rows)} differ, the first {say(*differs[0])}{worst}"


def spatial_levels(build, mesh, model, x, kw) -> list:
    """The pyramid levels a sharded forward's heads ran on, in order (one
    line's after another's): (came split, the level joined on the lead)."""
    from playground3d_tpu_torch.parallel import mesh as PM
    from playground3d_tpu_torch.parallel import spatial as PS

    real, seen = PM.spatial_constrainer, []

    def recording(*a, **k):
        cons = real(*a, **k)
        return lambda f: seen.append(f) or cons(f)

    PM.spatial_constrainer = recording
    try:
        build(mesh, **kw)(model, x)
    finally:
        PM.spatial_constrainer = real
    return [(isinstance(f, PS.Slabs), PS._joined(f)) for f in seen]


def level_distances(levels, ref_levels) -> list:
    """||level - unsharded level|| / ||unsharded level|| for each pyramid
    level, the worst over the lines (each line holds one frame of the
    unsharded batch)."""
    n = len(ref_levels)
    out = [0.0] * n
    for j, (_, f) in enumerate(levels):
        want = ref_levels[j % n][j // n:j // n + 1].double()
        out[j % n] = max(out[j % n], float((f.to(want.device).double() - want).norm() / want.norm()))
    return out


def spatial_meshes():
    """(label, mesh, camera x space) of the spatial phase: every visible
    card as 1, 2 or 4 shards, cuda:0 listed 2 and 4 times, and a 2 x 2
    camera x space mesh (on four cards where there are four)."""
    import torch

    from playground3d_tpu_torch.parallel import mesh as PM

    n_cards = torch.cuda.device_count()
    n_vis = max(k for k in (1, 2, 4) if k <= n_cards)
    four = [f"cuda:{i}" for i in range(4)] if n_cards >= 4 else ["cuda:0"] * 4
    return [(f"{n_vis} of the {n_cards} visible card(s)", PM.make_mesh(n_vis), False),
            ("cuda:0 listed twice", PM.make_mesh(devices=["cuda:0"] * 2), False),
            ("cuda:0 listed 4 times", PM.make_mesh(devices=["cuda:0"] * 4), False),
            (f"2 cameras x 2 on {four}", PM.make_mesh2(2, 2, devices=four), True)]


def spatial_small_reference(device) -> None:
    """The CPU test's case on the card (``tests/test_torch_spatial.py``):
    a depth-18 s2d detector with random output convs, a [1, 34, 64, 48]
    uint8 frame (seed 2) over cuda:0 listed 8 times and over every visible
    card, float32 with TF32 off, within that test's bound."""
    import torch

    from playground3d_tpu_torch.models.retinanet import forward_raw, retinanet_init
    from playground3d_tpu_torch.parallel import mesh as PM

    gen = torch.Generator().manual_seed(0)
    det = retinanet_init(gen, depth=18, stem="s2d", device=device)
    with torch.no_grad():
        for conv in (det.heads.cls_out, det.heads.reg_out):
            conv.w.copy_(torch.randn(conv.w.shape, generator=gen) * 0.01)
    x = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8)).to(device)
    ref = float32_exact(lambda: forward_raw(det, x, dtype=torch.float32))
    for label, mesh in (("cuda:0 listed 8 times", PM.make_mesh(devices=["cuda:0"] * 8)),
                        (f"the {torch.cuda.device_count()} visible card(s)", PM.make_mesh())):
        err = rel_errors(float32_exact(lambda: PM.spatial_forward(mesh, dtype=torch.float32)(det, x)), ref)[0]
        if err > SPATIAL_F32_TOL:
            fail(f"spatial (the CPU test's case, {label}): {err} of the largest output, bound {SPATIAL_F32_TOL}")
        log(f"spatial (the CPU test's case, {label}): depth 18, [1, 34, 64, 48], float32: {err:.3g} of the "
            f"largest output from the unsharded forward (bound {SPATIAL_F32_TOL})")


def qconv_checked(per_card, shapes, differ):
    """``quant.qconv`` that also runs the plain version on the same inputs
    (the slab's window, its explicit pads) and notes each call by card and
    by shape, and each shape whose output is not equal."""
    import torch

    from playground3d_tpu_torch.models import quant
    from playground3d_tpu_torch.ops import qconv as QC

    real = quant.qconv

    def call(x, wq, scale, offset=None, stride=1, relu=False, emit_xs=None, res=None, res_xs=None, pads=None):
        got = real(x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)
        key = (*x.shape, wq.shape[0], wq.shape[1], stride, QC.explicit_pads(x.shape[1], x.shape[2], wq.shape[1],
                                                                             stride, pads))
        per_card[str(x.device)] += 1
        shapes[key] += 1
        if not torch.equal(got, QC.qconv_plain(x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)):
            differ.add(key)
        return got

    return real, call


def quantize_checked(per_card, elements, differ):
    """``quant.quantize`` that also runs the plain ops on the same slab and
    notes each call's elements by card, and each call whose output is not
    equal or that got a tensor off the card."""
    import torch

    from playground3d_tpu_torch.models import quant
    from playground3d_tpu_torch.ops import quantize as QZ

    real = quant.quantize

    def call(x, xs):
        got = real(x, xs)
        per_card[str(x.device)] += 1
        elements[str(x.device)] += x.numel()
        if x.device.type != "cuda" or not torch.equal(got, QZ.quantize_plain(x, xs)):
            differ.add((tuple(x.shape), str(x.device)))
        return got

    return real, call


def phase_spatial(device) -> None:
    """Spatial partitioning (``parallel/mesh.py::spatial_forward``,
    ``camera_spatial_forward``): the CPU test's case on the card, then one
    1080p s2d uint8 frame [1, 270, 480, 48] through the shipped ResNet-50
    detector (FPN and heads 256 wide) with random output convs (seed 17),
    float and int8, over each of :func:`spatial_meshes`. Each run is held
    against the unsharded forward on the lead:

    * each conv, int8 conv and max pool on slabs against the same op run
      whole on its joined input (:func:`window_ops`, :func:`op_faults`):
      bf16 and int8 forwards;
    * each ``qconv.cu`` launch against ``qconv_plain`` on the same window
      and pads: equal;
    * the outputs: int8 equal; float32 (TF32 off) no farther from the
      float64 forward than twice the unsharded float32 forward is (largest
      error over the largest output, as the CPU test measures; the spread
      of two float32 orders, the frame alone and in a batch of two, is
      printed beside it); bf16 within twice the unsharded bf16 forward's
      distance from float32 (relative norm); both measured here;
    * the levels reach the heads split while their extent divides the
      axis, and the slabs are joined onto the lead only where that rule
      and the heads' anchors need it.

    Swapped halos must fail the window ops of bf16 and int8 and the float32
    and int8 outputs. Prints ms a frame (CUDA events on the lead around the
    whole forward) beside the unsharded forward's, each level's distance
    from the unsharded forward, the first window op that differs, the halo
    bytes and the windows' ms, and ``qconv`` launches per card."""
    import collections

    import torch

    from playground3d_tpu_torch.models import quant
    from playground3d_tpu_torch.models.retinanet import forward_raw
    from playground3d_tpu_torch.parallel import mesh as PM

    t_phase = time.time()
    spatial_small_reference(device)
    det_q, det_f = random_head_detector(device), random_head_detector(device, quantized=False)
    raw = np.random.default_rng(11).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    frames = torch.as_tensor(pack_frames(raw)).to(device)  # [2, 270, 480, 48]
    kinds = {"float32": (det_f, dict(dtype=torch.float32)), "bf16": (det_f, {}), "int8": (det_q, dict(compact=True))}

    def run(kind, fn):
        return float32_exact(fn) if kind == "float32" else fn()

    refs, ref_levels, unsharded_ms = {}, {}, {}
    for n in (1, 2):
        x = frames[:n]
        for k, (m, kw) in kinds.items():
            levels = []
            refs.setdefault(n, {})[k] = run(k, lambda: forward_raw(m, x, constrain=lambda f: levels.append(f) or f,
                                                                   **kw))
            ref_levels.setdefault(n, {})[k] = levels
        for k in ("bf16", "int8"):
            m, kw = kinds[k]
            unsharded_ms[n, k] = forward_ms(lambda: forward_raw(m, x, **kw), device)
    widths = [f.shape[3] for f in ref_levels[1]["bf16"]]
    exact = {n: forward_raw(det_f, frames[:n], dtype=torch.float64) for n in refs}
    f32_own = {n: rel_errors(refs[n]["float32"], exact[n])[0] for n in refs}
    bf_own = max(rel_errors(refs[n]["bf16"], refs[n]["float32"])[1] for n in refs)
    f32_orders = rel_errors([o[:1] for o in refs[2]["float32"]], refs[1]["float32"])[0]
    tol = 2 * bf_own
    log(f"spatial: unsharded on {device}: bf16 {unsharded_ms[1, 'bf16']:.3f} ms, int8 {unsharded_ms[1, 'int8']:.3f} ms "
        f"a 1080p s2d frame (eager, CUDA events, median of 5); levels {widths} columns wide; the float32 forward "
        f"{f32_own[1]:.4g} (a batch of two {f32_own[2]:.4g}) of the largest output from float64: a sharded float32 "
        f"forward may be twice that far; two float32 orders (the frame alone and in a batch of two) "
        f"{f32_orders:.4g} apart; the bf16 forward's distance from float32 {bf_own:.4g} (relative norm): the bf16 "
        f"bound is {tol:.4g}; int8 must equal")

    def e2e_faults(k, errs, n, got):
        if k == "float32":
            return rel_errors(got, exact[n])[0] > 2 * f32_own[n]
        return errs[1] > tol if k == "bf16" else errs[0] != 0

    counter, q_counter = kernel_counters()["qconv"], kernel_counters()["quantize"]
    per_card, shapes, differ = collections.Counter(), collections.Counter(), set()
    q_cards, q_elems, q_differ = collections.Counter(), collections.Counter(), set()
    q_whole = {}  # frames -> elements the unsharded int8 forward quantizes
    for n in refs:
        real, quant.quantize = quantize_checked(q_cards, q_elems, q_differ)
        try:
            forward_raw(det_q, frames[:n], compact=True)
        finally:
            quant.quantize = real
        q_whole[n] = sum(q_elems.values())
        q_cards.clear()
        q_elems.clear()
    for label, mesh, cams in spatial_meshes():
        n = 2 if cams else 1
        x = frames[:n]
        axis = PM.SPACE_AXIS if cams else PM.DATA_AXIS
        slabs = mesh.shape[axis]
        build = PM.camera_spatial_forward if cams else PM.spatial_forward
        errs, ms, dist, first = {}, {}, {}, {}
        n_lines = len(mesh.lines(axis)[:n])
        split = [all(w % slabs == 0 for w in widths[:i + 1]) for i in range(len(widths))]
        for k, (m, kw) in kinds.items():
            fwd = build(mesh, **kw)
            got = run(k, lambda: fwd(m, x))
            if tuple(g.shape for g in got) != tuple(r.shape for r in refs[n][k]) or \
                    not all(torch.isfinite(g.float()).all() for g in got):
                fail(f"spatial ({label}, {k}): outputs {[tuple(g.shape) for g in got]} not finite or not the "
                     f"unsharded forward's shapes")
            errs[k] = rel_errors(got, refs[n][k])
            if k == "float32":
                to_exact = rel_errors(got, exact[n])[0]
            if e2e_faults(k, errs[k], n, got):
                fail(f"spatial ({label}, {k}): {errs[k]} from the unsharded forward, {rel_errors(got, exact[n])} from "
                     f"float64 (float32: at most {2 * f32_own[n]:.4g} of the largest output from float64; bf16 "
                     f"{tol:.4g} relative norm from the unsharded; int8 equal)")
            levels = run(k, lambda: spatial_levels(build, mesh, m, x, kw))
            dist[k] = level_distances(levels, ref_levels[n][k])
            if [s for s, _ in levels] != split * n_lines:
                fail(f"spatial ({label}, {k}): levels {widths} reached the heads split {[s for s, _ in levels]}, the "
                     f"rule says {split}")
            ops = run(k, lambda: window_ops(lambda: fwd(m, x)))
            first[k] = first_differing(ops)
            if k != "float32":  # float32 is held by its outputs; its window ops are reported
                faults = op_faults(ops)
                if faults:
                    fail(f"spatial ({label}, {k}): window ops miss their bound: {faults[:4]}")
                ms[k] = forward_ms(lambda: fwd(m, x), device)
        fwd = build(mesh, compact=True)
        counter.launches = q_counter.launches = 0
        per_card.clear()
        shapes.clear()
        q_cards.clear()
        q_elems.clear()
        qconv, quant.qconv = qconv_checked(per_card, shapes, differ)
        quantize, quant.quantize = quantize_checked(q_cards, q_elems, q_differ)
        try:
            fwd(det_q, x)
        finally:
            quant.qconv, quant.quantize = qconv, quantize
        launches, q_launches = counter.launches, q_counter.launches
        if launches < 1 or launches != sum(per_card.values()):
            fail(f"spatial ({label}): qconv launched {launches} times ({dict(per_card)} by card)")
        if differ:
            fail(f"spatial ({label}): qconv.cu differs from qconv_plain at {sorted(differ)}")
        if q_launches != sum(q_cards.values()) or sum(q_elems.values()) != q_whole[n] or q_differ:
            fail(f"spatial ({label}): quantize launched {q_launches} times for {dict(q_cards)} calls by "
                 f"card over {dict(q_elems)} elements (the unsharded forward quantizes {q_whole[n]}); differing or "
                 f"off the card: {sorted(q_differ)}")
        want_joins = n_lines * (2 * sum(split) + (not all(split))) if slabs > 1 else 0
        halo = {k: halo_windows(lambda: build(mesh, **kinds[k][1])(kinds[k][0], x)) for k in ("bf16", "int8")}
        if any(h[2] != want_joins for h in halo.values()):
            fail(f"spatial ({label}): slabs joined {halo['bf16'][2]} (bf16) and {halo['int8'][2]} (int8) times onto "
                 f"the lead, the levels' rule and the heads' anchors need {want_joins}")
        log(f"spatial ({label}): {mesh.size} shards on {[str(d) for d in mesh.devices]}, {n} frame(s): "
            f"ms a frame bf16 {ms['bf16'] / n:.3f} (unsharded {unsharded_ms[n, 'bf16'] / n:.3f}), int8 "
            f"{ms['int8'] / n:.3f} (unsharded {unsharded_ms[n, 'int8'] / n:.3f}), same call; against the unsharded "
            f"forward: float32 {errs['float32'][0]:.3g} of the largest output ({to_exact:.4g} from float64, bound "
            f"{2 * f32_own[n]:.4g}), bf16 "
            f"{errs['bf16'][1]:.4g} relative norm (bound {tol:.4g}), int8 {errs['int8'][0]:.3g} (equal); halos bf16 "
            f"{halo['bf16'][0]:,} bytes in {halo['bf16'][1]} pieces, the windows alone {halo['bf16'][3]:.3f} ms; "
            f"int8 {halo['int8'][0]:,} bytes in {halo['int8'][1]} pieces, {halo['int8'][3]:.3f} ms (host clock); "
            f"{want_joins} joins onto the lead; qconv {launches} launches a forward, by card {dict(per_card)}, "
            f"{len(shapes)} shapes and pads, each equal to qconv_plain; quantize {q_launches} launches, by card "
            f"{dict(q_cards)}, {sum(q_elems.values()):,} elements as the unsharded forward, each equal to the plain "
            f"ops")
        for k in kinds:
            log(f"spatial ({label}, {k}): each level's distance from the unsharded level (relative norm) "
                + ", ".join(f"P{3 + i} [{w}] {d:.3g}" for i, (w, d) in enumerate(zip(widths, dist[k])))
                + f"; window ops against the unsharded op: {first[k]}")
        if mesh.size == 4 and not cams:
            f32_got = float32_exact(lambda: swapped_halos(lambda: PM.spatial_forward(mesh, dtype=torch.float32)(
                det_f, x)))
            f32 = rel_errors(f32_got, exact[1])
            canary = {}
            for k in ("bf16", "int8"):
                m, kw = kinds[k]
                got = swapped_halos(lambda: PM.spatial_forward(mesh, **kw)(m, x))
                ops = swapped_halos(lambda: window_ops(lambda: PM.spatial_forward(mesh, **kw)(m, x)))
                canary[k] = rel_errors(got, refs[1][k]), len(op_faults(ops)), len(ops)
            if not e2e_faults("float32", None, 1, f32_got) or not e2e_faults("int8", canary["int8"][0], 1, None) or \
                    not all(c[1] for c in canary.values()):
                fail(f"spatial ({label}): swapped halos pass the bounds: float32 {f32}, {canary}")
            log(f"spatial ({label}): the canary, halos swapped: float32 {f32[0]:.3g} of the largest output from "
                f"float64 (bound {2 * f32_own[1]:.4g}); bf16 {canary['bf16'][0][1]:.4g} relative norm (bound {tol:.4g}), "
                f"{canary['bf16'][1]} of {canary['bf16'][2]} window ops miss theirs; int8 {canary['int8'][0][0]:.3g} "
                f"of the largest output (must be 0), {canary['int8'][1]} of {canary['int8'][2]} window ops miss "
                f"theirs")
    log(f"spatial: phase took {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# the single camera
# ---------------------------------------------------------------------------


def steer_detector(det, reg, hw, car):
    """Aim the detector's regression bias so that each anchor of cell (0, 0)
    decodes to the image box of ``car`` [x, y, l, w, h, dir] (with zero
    output convs every box is its bias): the frames then yield boxes that
    parse to roadway states, and tracks are born, matched and updated."""
    import torch

    from playground3d_tpu_torch.data.synthetic import aimed_regression_bias

    bias = aimed_regression_bias(reg.P[0, 0], car, hw)
    with torch.no_grad():
        det.heads.reg_out.b.copy_(torch.as_tensor(bias))
    return det


def single_small_reference(device):
    """``SingleCameraTracker`` on the card against the CPU at 64x96 with a
    ResNet-18 detector (conv7 + float, and s2d + int8 quantized once on the
    CPU and copied), 8 frames: ids, masks and classes equal, states within
    1e-3 ft."""
    import torch

    from playground3d_tpu_torch.models.quant import quantize_detector
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker

    hw = (64, 96)
    reg = bench_registry(*hw)
    cfg = tracker_config(small=True)
    raw = np.random.default_rng(12).integers(0, 256, (8,) + hw + (3,), dtype=np.uint8)
    for label, stem, int8 in (("conv7 + float", "conv7", False), ("s2d + int8", "s2d", True)):
        det, _ = build_models("cpu", (16.0, 16.0), small=True, stem=stem)
        det = steer_detector(det, reg, hw, car=(330.0, 30.0, 18.0, 6.0, 5.0, 1.0))
        frames = raw
        if int8:
            det = quantize_detector(det, torch.as_tensor(pack_frames(raw[:1])))
            frames = pack_frames(raw)
        out = {}
        for dev in ("cpu", device):
            d = det if dev == "cpu" else copy.deepcopy(det).to(dev)
            trk = SingleCameraTracker(reg, "p1c1", cfg=cfg, det_model=d, stem=stem, device=dev)
            snaps = [trk.process_frame(frames[k], 1.6e9 + k / 30.0, k) for k in range(len(frames))]
            out[str(dev)] = {k: torch.stack([getattr(s, k).cpu() for s in snaps])
                             for k in ("ids", "raw_mask", "mask", "classes", "states7")}
        cpu, gpu = out["cpu"], out[str(device)]
        for k in ("ids", "raw_mask", "mask", "classes"):
            if not torch.equal(cpu[k], gpu[k]):
                fail(f"single camera small ({label}): {k} differs between the card and the CPU")
        live = cpu["raw_mask"]
        if int(live.sum()) == 0:
            fail(f"single camera small ({label}): no live tracks")
        diff = float((cpu["states7"] - gpu["states7"])[live].abs().max())
        log(f"single: small run (8 frames, 64x96; {label}) card vs CPU: ids/masks/classes equal, "
            f"{int(live.sum())} live slot-frames, states7 max_abs_diff {diff:.3g} (tolerance 1e-3)")
        if not diff <= 1e-3:
            fail(f"single camera small ({label}): states7 differ by {diff}")


def single_full_width(device, n_warm: int = 3, n_frames: int = T_CLIP):
    """The shipped detector on uint8 s2d-packed 1080p frames through
    ``SingleCameraTracker.track`` at the main path's knobs: the ResNet-50 s2d
    detector of :func:`shipped_models` (same seed, class bias +3), its
    regression bias aimed at a car on the road (the shipped one's boxes
    parse to states that the lifecycle drops at once, so no track would
    outlive its frame), int8-quantized on the same packed frame. A warm-up
    tracker captures the step's CUDA graph; the timed tracker replays it
    (one replay, one event wait - the end of the step's timer, which the
    sync-debug mode does not see - and one host read a frame, no other
    synchronizing call under PyTorch's sync-debug mode); an eager tracker (``graphs=False``) runs the same frames, and the
    two must be equal. Launch counts set to 0 just before the timed frames
    and read just after; the CSV written and read back."""
    import types
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv
    from playground3d_tpu_torch.models.quant import quantize_detector
    from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker

    reg, cfg, _, _, calib = shipped_models(device)
    det, _ = build_models(device, (56.0, 56.0), stem="s2d")
    det_q = quantize_detector(steer_detector(det, reg, (H, W), car=(480.0, 54.0, 18.0, 6.0, 5.0, 1.0)),
                              calib[None])
    per_detect = sum(record_qconv_shapes(device)["detect"].values())
    q_detect = quantize_counts(device)["detect"]
    raw = np.random.default_rng(3).integers(0, 256, (n_warm + n_frames, H, W, 3), dtype=np.uint8)
    packed = pack_frames(raw)
    stream = [(packed[k], 1.6e9 + k / 30.0) for k in range(len(packed))]

    warm = SingleCameraTracker(reg, "p1c1", cfg=cfg, det_model=det_q, stem="s2d", device=device)
    warm.track(stream[:n_warm])
    torch.cuda.synchronize()
    graph, tally = warm._graph.programs.graphs["step"]

    counters = kernel_counters()

    def timed(graphs: bool):
        trk = SingleCameraTracker(reg, "p1c1", cfg=cfg, det_model=det_q, stem="s2d", device=device, graphs=graphs)
        if graphs:
            trk._graph = warm._graph  # the warm-up's graph: no capture inside the timed frames
        for fn in counters.values():
            fn.launches = 0
        syncs0, loops0 = HostSyncs.count, dict(HostSyncs.by_loop)
        DeviceRounds.reset()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        torch.cuda.set_sync_debug_mode("warn" if graphs else 0)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                stats = trk.track(stream[n_warm:])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        e.record()
        torch.cuda.synchronize()
        syncing = [f"{w.filename}:{w.lineno}" for w in caught if "synchronizing CUDA operation" in str(w.message)]
        if syncing:
            fail(f"single: {len(syncing)} synchronizing calls in the graph run, at {sorted(set(syncing))}")
        loops = {k: v - loops0.get(k, 0) for k, v in HostSyncs.by_loop.items() if v - loops0.get(k, 0)}
        return types.SimpleNamespace(trk=trk, stats=stats, ms=s.elapsed_time(e), rounds=DeviceRounds.read(),
                                     launches={name: fn.launches for name, fn in counters.items()},
                                     syncs=HostSyncs.count - syncs0, loops=loops)

    run = timed(graphs=True)
    eager = timed(graphs=False)
    trk, stats, rounds, launches, syncs, loops, ms = (run.trk, run.stats, run.rounds, run.launches, run.syncs,
                                                       run.loops, run.ms)
    if stats["frames"] != n_frames or len(trk.rows) != n_frames:
        fail(f"single: {stats['frames']} frames tracked, {len(trk.rows)} rows, expected {n_frames}")
    if launches["qconv"] != n_frames * per_detect or launches["quantize"] != n_frames * q_detect or \
            eager.launches != launches:
        fail(f"single: qconv launched {launches['qconv']} times, expected {n_frames} x {per_detect}; quantize "
             f"{launches['quantize']}, expected {n_frames} x {q_detect}; the eager run launched {eager.launches}, "
             f"the graph run credited {launches}")
    if launches["crop_and_resize"] or launches["crop_and_resize_s2d"] or launches["yuv420_flat_to_s2d"]:
        fail(f"single: the single camera launched a crop or YUV kernel: {launches}")
    if syncs != n_frames or loops != {"drain": n_frames}:
        fail(f"single: {syncs} host reads ({loops}) for {n_frames} frames; one a frame (the drain) is the contract")
    if rounds != eager.rounds:
        fail(f"single: device rounds {rounds} in the graph run, {eager.rounds} eager")
    diff = rows_diff("single: the graph run against the eager run", trk, eager.trk)
    live_pairs = sum(len(row[2]) for row in trk.rows)
    if live_pairs == 0:
        fail("single: the detector produced no tracks")
    os.makedirs("_outputs", exist_ok=True)
    path = os.path.join("_outputs", "single_cam.csv")
    trk.write_results_csv(path)
    _, data = load_i24_csv(path)
    n_rows = sum(len(rows) for rows in data.values())
    if n_rows != live_pairs:
        fail(f"single: the CSV holds {n_rows} rows for {live_pairs} live (id, frame) pairs")

    timers = {k: v for k, v in stats.items() if k not in ("frames", "fps")}
    fps = n_frames / ms * 1e3
    cap_s, inst_s = warm._graph.programs.capture_s["step"]
    log(f"single: {n_frames} frames of 1x{H}x{W} uint8 s2d-packed, s2d + int8 ResNet-50, one CUDA graph a frame "
        f"({graph_nodes(graph)} nodes, captured in {cap_s:.3f} s and instantiated in {inst_s:.3f} s, host), in "
        f"{ms:.1f} ms (CUDA events) = {fps:.2f} frames/s; eager {n_frames / eager.ms * 1e3:.2f} frames/s; host "
        f"syncs {syncs} ({syncs / n_frames:.2f} per frame; by loop {loops}) and one event wait a frame (the step's timer; unseen by the sync-debug mode, which "
        f"flagged no other call); "
        f"NMS rounds {rounds['nms'] / n_frames:.2f} and auction rounds {rounds['auction'] / n_frames:.2f} a frame "
        f"on the card (its counters, read once); drain {timers['drain'] / sum(timers.values()) * 100:.1f}% of the "
        f"stage timers ({', '.join(f'{k} {v * 1e3:.1f} ms' for k, v in timers.items())})")
    log(f"single: the graph run equals the eager run: ids/classes equal, states7 within {diff[0]:.3g}, final kf.x "
        f"within {diff[1]:.3g} (tolerance 1e-4); kernel launches {launches} ({per_detect} qconv and {q_detect} "
        f"quantize a frame, credited "
        f"{ {k.__name__: v for k, v in tally.items()} } a replay); {live_pairs} live (id, frame) pairs = CSV rows "
        f"read back")

    frame_dev = stream[0][0]
    trk.process_frame(frame_dev, stream[-1][1] + 1 / 30.0, n_frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trk.process_frame(frame_dev, stream[-1][1] + 2 / 30.0, n_frames + 1)
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(ev.self_device_time_total for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
    if busy > 0:
        log(f"single: profile of one frame (a replay): wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({busy / wall_us * 100:.0f}%)")
    else:
        log("single: profile of one frame: the profiler saw no device time (not measured)")


def single_app():
    """``apps/track.py`` on the card, in-process: ``--mode single`` with the
    real detector (conv7 + float ResNet-50, the app's default) on rendered
    1080p frames, and ``--mode multi --oracle``, both with ``--eval``."""
    from playground3d_tpu_torch.apps import track
    from playground3d_tpu_torch.ops.topk import DeviceRounds, HostSyncs

    os.makedirs("_outputs", exist_ok=True)
    for mode, extra in (("single", ["--frames", "4"]), ("multi", ["--oracle", "--frames", "30"])):
        out = os.path.join("_outputs", f"track_{mode}.csv")
        gt = out + ".gt.csv"
        for f in (out, gt):
            if os.path.exists(f):
                os.remove(f)
        t0, loops0 = time.time(), dict(HostSyncs.by_loop)
        DeviceRounds.reset()
        metrics = track.main(["--mode", mode, "--out", out, "--eval"] + extra)
        loops = {k: v - loops0.get(k, 0) for k, v in HostSyncs.by_loop.items() if v - loops0.get(k, 0)}
        loops.update({f"{k} on the card": v for k, v in DeviceRounds.read().items()})
        if not (os.path.exists(out) and os.path.exists(gt)):
            fail(f"single: apps.track --mode {mode} wrote no CSV or no GT CSV")
        if not metrics or "MOTA" not in metrics or "TP" not in metrics:
            fail(f"single: apps.track --mode {mode} --eval gave no MOT metrics")
        log(f"single: apps.track --mode {mode} {' '.join(extra)} --eval on the card: {time.time() - t0:.1f} s, "
            f"host syncs by loop {loops}; TP {metrics['TP']}, FP {metrics['FP']}, FN {metrics['FN']}, "
            f"MOTA {metrics['MOTA']:.3f}")


def phase_single(device):
    """The single camera: card against CPU on a small input, the shipped
    int8 detector at full width, then the tracking app's two modes."""
    single_small_reference(device)
    single_full_width(device)
    single_app()


# ---------------------------------------------------------------------------
# recorded sessions
# ---------------------------------------------------------------------------


SESSION_CAMERAS = (("p1c1", 0.0), ("p1c2", 100.0))  # the second pole 100 ft down the road
SESSION_CAR = (480.0, 54.0, 18.0, 6.0, 5.0, 1.0)  # where camera 0's steered detections lie
T0_SESSION = 1.6e9


def write_session(root, reg, hw, seg_frames: int, n_segments: int = 2, scale: int = 1):
    """A recording session in the ingest layout of ``tests/test_multicam.py``:
    ``_SESSION_CONFIG.config``, ``_SESSION_INFO.txt`` and, for each camera
    of ``reg``, ``n_segments`` y4m segments of ``seg_frames`` 4:2:0 frames
    of a synthetic scene with burned-in timestamps, rendered at ``scale``
    times the ``hw`` that ``reg`` projects to (camera c seen through
    ``reg.P[c, 0]`` scaled by it). Returns each camera's frames [C][T]
    (uint8) and their burned times [T]."""
    from playground3d_tpu_torch.data.synthetic import SyntheticScene
    from playground3d_tpu_torch.data.video import SyntheticVideoSource, write_y4m

    rec = os.path.join(root, "recording")
    os.makedirs(rec)
    with open(os.path.join(root, "_SESSION_CONFIG.config"), "w") as f:
        f.write("".join(f"__CAMERA__\nname == {c}\n" for c in reg.names)
                + "__PERSISTENT-RECORDING__\nrecording_filename == ./recording/record_{cam_name}_%05d.y4m\n")
    with open(os.path.join(root, "_SESSION_INFO.txt"), "w") as f:
        f.write("SESSION #1\n")
    scene = SyntheticScene(n_objects=8, seed=2, x_spawn=(460.0, 740.0), x_visible=(440.0, 780.0))
    n = seg_frames * n_segments
    zoom = np.diag([float(scale), float(scale), 1.0])

    def camera(c):
        src = SyntheticVideoSource(scene, zoom @ reg.P[c, 0], n_frames=n, t0=T0_SESSION, height=hw[0] * scale,
                                   width=hw[1] * scale, normalized=False, burn_timestamp=True, seed=c)
        return [(np.clip(fr, 0, 1) * 255).astype(np.uint8) for fr, _ in src]

    def segment(job):
        c, k = job
        write_y4m(os.path.join(rec, f"record_{reg.names[c]}_{k:05d}.y4m"),
                  frames[c][k * seg_frames:(k + 1) * seg_frames])

    with concurrent.futures.ThreadPoolExecutor(len(reg.names) * n_segments) as ex:
        frames = list(ex.map(camera, range(len(reg.names))))
        list(ex.map(segment, [(c, k) for c in range(len(reg.names)) for k in range(n_segments)]))
    return frames, [T0_SESSION + k / 30.0 for k in range(n)]


def session_checkpoints(d, reg, hw, depth: int):
    """The app's detector (``depth``, s2d stem) and ResNet-18 s2d crop net
    from the app's seeds, written with the port's ``save_params``: class
    biases raised by 3, the detector's regression bias aimed at
    ``SESSION_CAR`` in camera 0 (:func:`steer_detector`). Returns their paths."""
    import torch

    from playground3d_tpu_torch.models.nn import save_params
    from playground3d_tpu_torch.models.retinanet import retinanet_init

    det = retinanet_init(torch.Generator().manual_seed(0), depth=depth, stem="s2d", device="cpu")
    crop = retinanet_init(torch.Generator().manual_seed(1), depth=18, stem="s2d", device="cpu")
    steer_detector(det, reg, hw, SESSION_CAR)
    with torch.no_grad():
        for m in (det, crop):
            m.heads.cls_out.b += 3.0
    paths = os.path.join(d, "det.npz"), os.path.join(d, "crop.npz")
    save_params(paths[0], det)
    save_params(paths[1], crop)
    return paths


def session_ignore(d, reg, hw, right: float = 0.25):
    """An ignore polygon for camera 0 over the image box of ``SESSION_CAR``
    and ``right`` of the image width to its right, written as
    ``ignored_regions/p1c1_ignored.csv``. With zero output convs every
    anchor scores alike, and the top-k's ties keep camera 0's first anchors:
    the cells of the top rows, whose boxes are the aimed box shifted right
    one stride a cell. The polygon takes the first of them. Returns the
    directory."""
    from playground3d_tpu_torch.evaluation import geometry_np as G

    corners = G.state_to_im(np.asarray(SESSION_CAR, np.float64)[None], reg.P[0, 0])[0]
    pad = 16.0 * hw[1] / W
    (x1, y1), (x2, y2) = corners.min(0) - pad, corners.max(0) + pad
    x2 += right * hw[1]
    ig = os.path.join(d, "ignored_regions")
    os.makedirs(ig)
    with open(os.path.join(ig, f"{reg.names[0]}_ignored.csv"), "w") as f:
        f.write(f"{x1},{y1}\n{x2},{y1}\n{x2},{y2}\n{x1},{y2}\n")
    return ig


def session_argv(root, reg_path, ckpts, ig, emit, out, hw, depth, device, clip_len, det_step):
    return ["--mode", "session", "--session-dir", root, "--registry", reg_path, "--ignore-dir", ig,
            "--checkpoint", ckpts[0], "--crop-checkpoint", ckpts[1], "--depth", str(depth),
            "--det-step", str(det_step), "--clip-len", str(clip_len), "--height", str(hw[0]),
            "--width", str(hw[1]), "--emit", emit, "--out", out, "--device", str(device)]


def session_rows(path):
    from playground3d_tpu_torch.evaluation.csv_io import load_i24_csv, parse_state_row

    _, data = load_i24_csv(path)
    return {(f, int(r[2])): parse_state_row(r) for f, rows in data.items() for r in rows}


def session_small_reference(device, d):
    """The session app on the card against the CPU on a small session (two
    cameras, 64x96, ResNet-18 detector, ``--emit yuv420``, the ignore
    region): the same (frame, id) keys, positions and sizes within 1e-3 ft,
    speeds within 1e-4 relative."""
    from playground3d_tpu_torch.apps import track

    hw = (64, 96)
    reg = bench_registry(*hw, cameras=SESSION_CAMERAS)
    root = os.path.join(d, "small")
    write_session(root, reg, hw, seg_frames=6)
    reg_path = os.path.join(d, "small_registry.npz")
    reg.save(reg_path)
    ckpts = session_checkpoints(root, reg, hw, depth=18)
    ig = session_ignore(root, reg, hw, right=0.0)
    rows = {}
    for dev in ("cpu", device):
        out = os.path.join(d, f"small_{dev}.csv")
        track.main(session_argv(root, reg_path, ckpts, ig, "yuv420", out, hw, 18, dev, clip_len=6, det_step=3))
        rows[str(dev)] = session_rows(out)
    cpu, gpu = rows["cpu"], rows[str(device)]
    if set(cpu) != set(gpu) or len(cpu) < 12:
        fail(f"session small: (frame, id) keys differ between the card and the CPU ({len(gpu)} vs {len(cpu)} rows)")
    pos = max(float(np.abs(cpu[k][:6] - gpu[k][:6]).max()) for k in cpu)
    speed = max(float(abs(cpu[k][6] - gpu[k][6]) / max(abs(cpu[k][6]), 1.0)) for k in cpu)
    log(f"session: small run (2 cameras, 64x96, 12 frames, ResNet-18, yuv420, ignore region) card vs CPU: "
        f"{len(cpu)} rows, keys equal, positions/sizes max_abs_diff {pos:.3g} ft (tolerance 1e-3), speeds "
        f"max_rel_diff {speed:.3g} (tolerance 1e-4)")
    if not (pos <= 1e-3 and speed <= 1e-4):
        fail(f"session small: states differ between the card and the CPU by {pos} ft, speeds by {speed}")


def session_native_twins(path):
    """The port's native host functions on the first 4K frame of ``path``
    against their numpy twins: the box filters, s2d packs and the timestamp
    parse equal, the fixed-point YUV converter within 1 LSB of the float one."""
    from playground3d_tpu_torch.data import native as N
    from playground3d_tpu_torch.data.timestamps import parse_frame_timestamp
    from playground3d_tpu_torch.data.video import _Y4MReader, pack_s2d, rgb_from_planes

    rd = _Y4MReader(path)
    Y, U, V = rd.read_planes()
    rd.close()
    rgb = rgb_from_planes(Y, U, V)
    half = [N.box2_plane(p) for p in (Y, U, V)]
    exact = {
        "plane_half": all(np.array_equal(N.plane_half(p), N.box2_plane(p)) for p in (Y, U, V)),
        "resize_half": np.array_equal(N.resize_half(rgb), N.resize_half_plain(rgb)),
        "s2d_u8": np.array_equal(N.s2d_u8(rgb), pack_s2d(rgb)),
        "preprocess_s2d_u8": np.array_equal(N.preprocess_s2d_u8(rgb), pack_s2d(N.resize_half_plain(rgb))),
        "yuv420_half_to_s2d_u8": np.array_equal(N.yuv420_half_to_s2d_u8(Y, U, V), N.yuv420_to_s2d_u8(*half)),
        "parse_timestamp": N.parse_timestamp_native(rgb) == parse_frame_timestamp(rgb)[0] is not None,
    }
    lsb = {
        "yuv420_to_rgb": int(np.abs(N.yuv420_to_rgb(Y, U, V).astype(int) - rgb.astype(int)).max()),
        "yuv420_half_to_s2d_u8": int(np.abs(N.yuv420_half_to_s2d_u8(Y, U, V).astype(int)
                                            - pack_s2d(rgb_from_planes(*half)).astype(int)).max()),
    }
    bad = [k for k, ok in exact.items() if not ok] + [k for k, v in lsb.items() if v > 1]
    if bad:
        fail(f"session: native host functions differ from their numpy twins on a 4K frame: {bad} ({lsb})")
    log(f"session: native host functions on one {Y.shape[0]}x{Y.shape[1]} frame equal their numpy twins "
        f"({', '.join(exact)}); the fixed-point YUV converter within {max(lsb.values())} LSB of the float one")


def session_sources(root, reg, emit, hw):
    """Each camera's segments through ``VideoFrameSource``, read in full on
    the host alone (no tracker): the frames, the parsed timestamps, and the
    host seconds by stage."""
    from playground3d_tpu_torch.data.session import find_files, get_recording_params
    from playground3d_tpu_torch.data.video import VideoFrameSource

    rec_dirs, fmts, cams = get_recording_params(root)
    files = find_files(rec_dirs, fmts, cams)
    out, timers = {}, {"read": 0.0, "ts": 0.0, "tail": 0.0}
    t0 = time.perf_counter()
    for cam in reg.names:
        items = []
        for dd, fn, _, c in files:
            if c == cam:
                src = VideoFrameSource(os.path.join(dd, fn), resize_hw=hw, emit=emit)
                items += list(src)
                for k in timers:
                    timers[k] += src.timers[k]
        out[cam] = items
    return out, timers, time.perf_counter() - t0


def session_app_run(device, argv, n_frames):
    """``apps/track.py`` ``main()`` in-process under the profiler (CUDA
    activity), with every launch count set to 0 just before and read just
    after. Returns its stats, launches, host reads, and the card's busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from playground3d_tpu_torch.apps import track
    from playground3d_tpu_torch.ops.topk import HostSyncs

    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    loops0 = dict(HostSyncs.by_loop)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        stats = track.main(argv)
        torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    loops = {k: v - loops0.get(k, 0) for k, v in HostSyncs.by_loop.items() if v - loops0.get(k, 0)}
    busy = sum(ev.self_device_time_total for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA) / 1e3
    if stats["frames"] != n_frames:
        fail(f"session: the app tracked {stats['frames']} frames of {n_frames}")
    return stats, launches, loops, busy


def session_births(rows):
    """(x, y) of each track at its first row [n,2]."""
    first = {}
    for (f, i), state in sorted(rows.items()):
        first.setdefault(i, state)
    return np.array([s[:2] for s in first.values()]).reshape(-1, 2)


def near(p, q, ft: float = 3.0):
    """[len(p)] bool: whether each road point of ``p`` [n,2] lies within
    ``ft`` of some point of ``q`` [m,2]."""
    if not len(q):
        return np.zeros(len(p), bool)
    return np.sqrt(((p[:, None] - q[None]) ** 2).sum(-1)).min(1) < ft


def session_ignore_check(device, reg, ckpt, ig, frames, hw, depth):
    """The app's detector on one frame of each camera (s2d, on the card) and
    its parse with the ignore grid: equal to the parse without it of the
    detections whose box centre (the corners' hull's) lies in no ignored
    cell, and some did lie in one. Returns the roadway (x, y) of the
    ignored detections and of the kept ones (each set as the parse leaves
    it), and the counts of ignored and of all detections."""
    import torch

    from playground3d_tpu_torch.data.regions import load_ignore_regions
    from playground3d_tpu_torch.geometry import transforms as T
    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import detect_multiframe, retinanet_init
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry, ignore_hits
    from playground3d_tpu_torch.pipeline.tracker_state import parse_detections_pre
    from playground3d_tpu_torch.utils.config import TrackerConfig, tracking_x_range

    det = load_params(ckpt, retinanet_init(torch.Generator().manual_seed(0), depth=depth, stem="s2d", device=device))
    # the session app's configuration (apps/track.py::track_session)
    cfg = TrackerConfig(max_tracks=64, max_dets=64, x_range=tracking_x_range(reg.names), f_init=2, det_step=6,
                        crop_slots=32)
    dets = detect_multiframe(det, frames, pre_topk=cfg.pre_topk, max_dets=cfg.max_dets,
                             approx_topk=cfg.approx_topk, min_level=cfg.det_min_level)
    plain = bank_from_registry(reg, device=device)
    masked = bank_from_registry(reg, ignore_polygons=load_ignore_regions(ig), image_hw=hw, device=device)
    times = torch.zeros(frames.shape[0], device=device)
    hull = T.im_hull_xyxy(dets.boxes[:, :16].reshape(-1, 8, 2))
    hit = ignore_hits(masked, (hull[:, :2] + hull[:, 2:]) / 2, dets.cam_idx) & dets.mask
    kept = parse_detections_pre(dets, masked, times, cfg)
    want = parse_detections_pre(dets._replace(mask=dets.mask & ~hit), plain, times, cfg)
    ignored = parse_detections_pre(dets._replace(mask=hit), plain, times, cfg)
    if not (torch.equal(kept.mask, want.mask) and torch.equal(kept.state[kept.mask], want.state[want.mask])):
        fail("session: the parse with the ignore grid differs from the parse of the detections outside it")
    if not bool(ignored.mask.any()):
        fail(f"session: {int(hit.sum())} detections lie in the ignored cells and none of them parses")
    return (ignored.state[ignored.mask][:, :2].cpu().numpy(), kept.state[kept.mask][:, :2].cpu().numpy(),
            int(hit.sum()), int(dets.mask.sum()))


def session_mp4_leg(device, d, reg, frames, reg_path, ckpts, ig, hw, depth):
    """Where this host has the FFmpeg libraries: one H.264 segment of 12 4K
    frames per camera through ``AvWriter``, read back by ``AvReader`` inside
    ``VideoFrameSource`` (timestamps equal the burned ones) and tracked by
    the session app (``--emit s2d_u8``, the reference's default .mp4
    layout)."""
    from playground3d_tpu_torch.data import avdecode
    from playground3d_tpu_torch.data.video import VideoFrameSource

    root = os.path.join(d, "mp4")
    os.makedirs(os.path.join(root, "recording"))
    with open(os.path.join(root, "_SESSION_CONFIG.config"), "w") as f:
        f.write("".join(f"__CAMERA__\nname == {c}\n" for c in reg.names))
    with open(os.path.join(root, "_SESSION_INFO.txt"), "w") as f:
        f.write("SESSION #1\n")
    t0 = time.time()
    for c, cam in enumerate(reg.names):
        path = os.path.join(root, "recording", f"record_{cam}_00000.mp4")
        with avdecode.AvWriter(path, frames[c][0].shape[1], frames[c][0].shape[0], fps=30, crf=12) as w:
            for fr in frames[c][:12]:
                w.add(fr)
        codec = w.codec
        got = [t for _f, t in VideoFrameSource(path, resize_hw=hw, emit="s2d_u8")]
        want = [float(f"{T0_SESSION + k / 30.0:.2f}") for k in range(12)]
        if got != want:
            fail(f"session mp4: {cam}'s parsed timestamps {got[:3]}... differ from the burned {want[:3]}...")
    out = os.path.join("_outputs", "session_mp4.csv")
    stats, launches, _, _ = session_app_run(
        device, session_argv(root, reg_path, ckpts, ig, "s2d_u8", out, hw, depth, device, 24, 6), 12)
    log(f"session: libav found; the mp4 leg ran ({codec}, 2 cameras x 12 4K frames encoded, timestamps "
        f"equal the burned ones, tracked at {stats['fps']:.2f} "
        f"frames/s, {len(session_rows(out))} CSV rows) in {time.time() - t0:.1f} s")


def phase_session(device, hw=(H, W), depth: int = 50):
    """Recorded sessions: 2 cameras, each with 2 y4m segments of 12 frames
    at 3840x2160 4:2:0 with burned timestamps, a registry .npz, an ignore
    region for camera 0, and checkpoints from the port's ``save_params``
    (ResNet-50 s2d detector aimed at a car, ResNet-18 s2d crop net), run
    through ``apps/track.py --mode session`` on the card with ``--emit
    s2d_u8`` and ``--emit yuv420``. Checks: every parsed timestamp equals
    the burned one; the two emits' s2d frames on the card are within 1 LSB
    (the card's YUV kernel equal to its plain version on the session's
    frames); the parse drops every detection whose centre lies in camera 0's
    ignored cells, and no track is born at a road position only such
    detections reach; the native host functions equal their numpy twins on
    a 4K frame; the card's session CSV equals the CPU's on a small session;
    the H.264 leg where libav exists.
    ``hw`` and ``depth`` (the tracked size, the detector's depth) are for a
    rehearsal at a small size."""
    import shutil
    import tempfile

    import torch

    from playground3d_tpu_torch.data import avdecode
    from playground3d_tpu_torch.ops import yuv420

    t_phase = time.time()
    os.makedirs("_outputs", exist_ok=True)
    d = tempfile.mkdtemp(prefix="session_", dir=os.path.abspath("_outputs"))
    try:
        session_small_reference(device, d)
        reg = bench_registry(*hw, cameras=SESSION_CAMERAS)
        reg_path = os.path.join(d, "registry.npz")
        reg.save(reg_path)
        root = os.path.join(d, "session")
        t0 = time.time()
        frames, burned = write_session(root, reg, hw, seg_frames=12, scale=2)
        ckpts = session_checkpoints(d, reg, hw, depth=depth)
        ig = session_ignore(d, reg, hw)
        n_frames, n_cams = len(burned), len(reg.names)
        log(f"session: wrote 2 cameras x 2 segments x 12 frames of {2 * hw[1]}x{2 * hw[0]} y4m, checkpoints and the "
            f"ignore region "
            f"in {time.time() - t0:.1f} s")
        session_native_twins(os.path.join(root, "recording", "record_p1c1_00000.y4m"))

        # the host alone: every frame read, parsed and converted by each emit
        host, first = {}, {}
        want = [float(f"{t:.2f}") for t in burned]
        for emit in ("s2d_u8", "yuv420"):
            items, timers, wall = session_sources(root, reg, emit, hw)
            for cam, its in items.items():
                got = [t for _f, t in its]
                if got != want:
                    fail(f"session ({emit}): {cam}'s parsed timestamps differ from the burned ones: {got} vs {want}")
            first[emit] = np.stack([items[c][0][0] for c in reg.names])
            host[emit] = (timers, wall)
        s2d_host = torch.as_tensor(first["s2d_u8"]).to(device)
        buf = torch.as_tensor(first["yuv420"][None]).to(device)  # [1, C, L]
        on_card = yuv420.yuv420_flat_to_s2d_cuda(buf, hw)[0]
        if not torch.equal(on_card, yuv420.yuv420_flat_to_s2d_plain(buf, hw)[0]):
            fail("session: the YUV kernel differs from its plain version on the session's frames")
        lsb = int((on_card.int() - s2d_host.int()).abs().max())
        if lsb > 1:
            fail(f"session: s2d frames from the two emits differ by {lsb} LSB on the card")
        log(f"session: timestamps parsed from every 4K frame of both cameras equal the burned ones (both emits); "
            f"the card's s2d frames from --emit yuv420 are within {lsb} LSB of --emit s2d_u8's host-packed ones "
            f"(tolerance 1); the YUV kernel equals its plain version on them")

        # where the detections in the ignored cells lie on the road, and the others
        at_ign, at_kept, n_hit, n_det = session_ignore_check(device, reg, ckpts[0], ig, s2d_host, hw, depth)
        only_ign = at_ign[~near(at_ign, at_kept)]
        if not len(only_ign):
            fail("session: every ignored detection parses within 3 ft of a kept one; the check would not bite")
        log(f"session: of the detector's {n_det} detections on one frame of each camera, {n_hit} lie in camera 0's "
            f"ignored cells and none survives the parse; {len(only_ign)} road positions only ignored detections "
            f"reach, {len(at_kept)} kept ones")

        report = {}
        for emit in ("s2d_u8", "yuv420"):
            out = os.path.join("_outputs", f"session_{emit}.csv")
            argv = session_argv(root, reg_path, ckpts, ig, emit, out, hw, depth, device, 24, 6)
            stats, launches, loops, busy = session_app_run(device, argv, n_frames)
            need = ["crop_and_resize_s2d", "nms", "auction"] + (["yuv420_flat_to_s2d"] if emit == "yuv420" else [])
            if any(launches[k] < 1 for k in need) or launches["qconv"] or launches["crop_and_resize"] or (
                    emit == "s2d_u8" and launches["yuv420_flat_to_s2d"]):
                fail(f"session ({emit}): kernel launches off for this path: {launches}")
            if loops.get("drain") != 1:
                fail(f"session ({emit}): host reads {loops}; one read a clip is the contract")
            rows = session_rows(out)
            if not all(np.isfinite(v).all() for v in rows.values()):
                fail(f"session ({emit}): non-finite states in the CSV")
            births = session_births(rows)
            bad = births[near(births, only_ign) & ~near(births, at_kept)]
            if len(bad) or not len(births):
                fail(f"session ({emit}): {len(births)} births, {len(bad)} of them where only ignored detections "
                     f"lie: {bad.tolist()}")
            wall = stats["frames"] / stats["fps"]
            timers, host_wall = host[emit]
            per = n_frames * n_cams
            log(f"session ({emit}): {n_frames} frames x {n_cams} cameras of {2 * hw[0]}p y4m tracked at {hw[0]}p in one "
                f"clip at "
                f"{stats['fps']:.2f} frames/s (track_clips wall {wall:.2f} s, graph capture included; under the "
                f"profiler); card busy {busy:.1f} ms ({busy / (wall * 1e3) * 100:.1f}% of that wall); host ms per "
                f"camera-frame in the app: read {stats['read'] / per * 1e3:.2f}, timestamp {stats['ts'] / per * 1e3:.2f},"
                f" tail {stats['tail'] / per * 1e3:.2f}, pinned staging {stats['stage'] / per * 1e3:.2f}; the host "
                f"alone: read {timers['read'] / per * 1e3:.2f}, timestamp {timers['ts'] / per * 1e3:.2f}, tail "
                f"{timers['tail'] / per * 1e3:.2f} ({n_frames / host_wall:.2f} frames/s of 2 cameras); launches "
                f"{launches}; host reads {loops}; {len(births)} births, none within 3 ft of a road position only "
                f"ignored detections reach")
            report[emit] = stats["fps"]
        log("session: frames/s of the two emits, one call, one card: "
            + ", ".join(f"{k} {v:.2f}" for k, v in report.items()))
        if avdecode.available():
            session_mp4_leg(device, d, reg, frames, reg_path, ckpts, ig, hw, depth)
        else:
            log("session: libav not found on this host (pkg-config finds no FFmpeg libraries): the H.264 leg did "
                "not run; the y4m legs ran")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    log(f"session: phase took {time.time() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the app's default batch and shape, TrainConfig's own image shape, and the
# crop net's (the app's batch at --crop-size 112)
FOCAL_SHAPES = ((4, (512, 768)), (2, (H, W)), (4, (112, 112)))
# checked, not timed: more images than the forward has slots, one block an image
FOCAL_MANY = (300, (128, 128))
FOCAL_GRAD_OUT = (1.0, 0.7, 1.3)  # d total / d (cls, reg, vp) in the checks: each term weighs differently


def focal_inputs(rng, b: int, hw):
    """Loss inputs on the host for ``b`` images at ``hw``: image i holds
    [32, 1, 0, 17][i % 4] valid labels; the first image's first six are
    dyadic boxes on 32x32 anchors of the 8-pixel level, two rows of three
    apart from each other (IoU exactly 1.0, 0.5, 0.498, 0.406, 0.398 and 0.4
    at their anchor), the rest box-like labels of 16-400 px;
    classification carries values exactly at both clamp bounds and beyond
    them, regression zero-length axis vectors. The second image then gets
    labels at the edges of the forward's cull (:func:`cull_edge_labels`)
    after its own, drawn from no random numbers."""
    from playground3d_tpu_torch.losses.focal import _SIGNS
    from playground3d_tpu_torch.models.anchors import anchors_for_shape

    anchors = anchors_for_shape(hw)
    a, cells_x = anchors.shape[0], hw[1] // 8
    ann = np.full((b, 32, 21), -1.0, np.float32)
    S = np.array(_SIGNS)

    def box_label(x0, y0, x1, y1, c):
        lab = np.zeros(21, np.float32)
        for k in range(8):
            lab[2 * k] = x0 if k % 2 == 0 else x1
            lab[2 * k + 1] = y1 if k < 4 else y0
        lab[16:21] = x0, y0, x1, y1, c
        return lab

    def random_label(c):
        size = rng.uniform(16, 400)
        ctr = np.array([rng.uniform(0, hw[1]), rng.uniform(0, hw[0])])
        l, w, h = (rng.normal(0, 1, 2) * size * f for f in (0.3, 0.15, 0.2))
        corners = ctr + S[:, 0, None] * l + S[:, 1, None] * w + S[:, 2, None] * h
        return np.concatenate([corners.reshape(-1), corners.min(0), corners.max(0), [c]]).astype(np.float32)

    edge_anchors = []
    for i in range(b):
        rows = []
        if i == 0:
            fracs = (None, 0.5, 0.498046875, 0.40625, 0.3984375, "tall")
            for j, frac in enumerate(fracs):
                idx = ((2 + 8 * (j // 3)) * cells_x + 2 + 5 * (j % 3)) * 9 + 3  # a 32x32 anchor
                x0, y0, x1, y1 = (float(v) for v in anchors[idx])
                if frac is None:
                    rows.append(box_label(x0, y0, x1, y1, j))
                elif frac == "tall":
                    rows.append(box_label(x0, y0 - 24.0, x1, y1 + 24.0, j))  # IoU 1024 / 2560 = 0.4
                else:
                    rows.append(box_label(x0, y0, x0 + 32.0 * frac, y1, j))
                edge_anchors.append(idx)
        n = [32, 1, 0, 17][i % 4]
        rows += [random_label(rng.integers(0, 8)) for _ in range(n - len(rows))]
        if rows:
            ann[i, : len(rows)] = rows
    cls = (1.0 / (1.0 + np.exp(-rng.normal(-2.0, 1.5, (b, a, 8))))).astype(np.float32)
    lo, hi = np.float32(1e-4), np.float32(1.0 - 1e-4)
    cls[0, edge_anchors[0]] = [lo, hi, 5e-5, 0.99995, lo, hi, 0.3, 0.7]
    cls[-1, :4] = [[lo] * 8, [hi] * 8, [0.0] * 8, [1.0] * 8]
    reg = rng.normal(0.0, 0.5, (b, a, 12)).astype(np.float32)
    reg[0, edge_anchors[0], 2:4] = 0.0
    reg[0, edge_anchors[1], 4:8] = 0.0
    if b > 1:
        edges = cull_edge_labels(anchors, hw, box_label)
        ann[1, 1 : 1 + len(edges)] = edges
    return cls, reg, ann, anchors


def cull_edge_labels(anchors, hw, box_label):
    """Label rows at the edges of ``focal_loss.cu``'s cull, for an image
    whose first label is an ordinary one (rows with class -1 are padding
    between them): a box whose left edge lies exactly on the right edge of
    one warp's 32 anchors (disjoint from that warp, IoU 0 there), one that
    overlaps another warp by one ulp (kept there), one whose top edge lies
    on the bottom edge of the warp that spans the 8- and 16-pixel levels,
    a box with a NaN corner coordinate (kept, never assigned), and a band
    beyond 2^60 wide (outside the bound that lets a first label start the
    cull; an IoU just above 0)."""
    cells_y, cells_x = -(-hw[0] // 8), -(-hw[1] // 8)

    def warp_hull(cy, cx):
        g = (cy * cells_x + cx) * 9 // 32
        w = anchors[32 * g : 32 * g + 32]
        return w[:, 0].min(), w[:, 1].min(), w[:, 2].max(), w[:, 3].max()

    pad = np.full(21, -1.0, np.float32)
    x0, y0, x1, y1 = warp_hull(cells_y * 3 // 5, cells_x // 3)
    touch_right = box_label(x1, y0, x1 + 48.0, y1, 1)
    x0, y0, x1, y1 = warp_hull(cells_y // 3, cells_x * 3 // 5)
    sliver = box_label(np.nextafter(x1, np.float32(-np.inf)), y0, x1 + 48.0, y1, 2)
    g = cells_y * cells_x * 9 // 32  # the warp at the end of the 8-pixel level
    w = anchors[32 * g : 32 * g + 32]
    touch_below = box_label(w[:, 0].min(), w[:, 3].max(), w[:, 2].max(), w[:, 3].max() + 40.0, 3)
    nan_corner = box_label(0.25 * hw[1], 0.25 * hw[0], 0.5 * hw[1], 0.5 * hw[0], 4)
    nan_corner[2] = np.nan
    wide = box_label(-(2.0 ** 61), 0.7 * hw[0], 2.0 ** 61, 0.7 * hw[0] + 12.0, 5)
    return np.stack([pad, touch_right, pad, sliver, touch_below, nan_corner, pad, wide])


def focal_bytes(b: int, a: int, n_care: int, n_pos: int) -> "tuple[int, int]":
    """Bytes each kernel must move for this run's data (each value it needs
    read once, each output written once). Forward: the labels, the anchors,
    classification at the ``n_care`` anchors that count (positive or
    negative) and regression at the ``n_pos`` positives; it writes argmax
    (4) and flags (1) per anchor, the positive counts and the three losses.
    Backward: the labels, the flags, the positive counts and grad_output,
    classification at the anchors that count, argmax, anchor and regression
    at the positives (an anchor that is not positive needs no label); it
    writes both gradients in full."""
    labels = b * 32 * 21 * 4
    fwd = labels + a * 16 + n_care * 8 * 4 + n_pos * 12 * 4 + b * a * 5 + b * 4 + 12
    bwd = labels + b * a + b * 4 + 12 + n_care * 8 * 4 + n_pos * (1 + 4 + 12) * 4 + b * a * (8 + 12) * 4
    return fwd, bwd


def kernels_focal(device, flush, noop_ms):
    """``focal_loss.cu``: the loss and its gradient against the plain
    version (autograd), at batch 4 x 512x768 (the app's default), batch
    2 x 1080x1920 and batch 4 x 112x112 (the crop net), with the edge cases
    of :func:`focal_inputs`, and at ``FOCAL_MANY`` (checked, not timed). The
    assignment (argmax, positive, positive-or-negative) must be equal, the
    three losses within 1e-5 relative, the gradients within 1e-5 relative +
    1e-7 absolute. Times: forward and backward between CUDA events, L2 cold
    and warm, and each kernel's own device time under the profiler
    (:func:`kernel_split`, L2 cold); the plain version's forward and
    backward."""
    import torch

    from playground3d_tpu_torch.losses import focal
    from playground3d_tpu_torch.ops import focal_loss as FL

    rng = np.random.default_rng(11)
    worst, row = 0.0, None
    us = lambda ms: "not seen by the profiler" if ms is None else f"{ms * 1e3:.1f} us"
    for b, hw in FOCAL_SHAPES + (FOCAL_MANY,):
        cls, reg, ann, anchors = (torch.as_tensor(x, device=device) for x in focal_inputs(rng, b, hw))
        a = anchors.shape[0]
        losses, num_pos, argmax, flags = FL.focal_loss_forward_cuda(cls, reg, ann, anchors)
        g_out = torch.tensor(FOCAL_GRAD_OUT, device=device)
        dcls, dreg = FL.focal_loss_backward_cuda(cls, reg, ann, anchors, argmax, flags, num_pos, g_out)
        iou_max, arg_ref = focal.assign_plain(anchors, ann)
        has = (ann[..., 20] >= 0).any(1)[:, None]
        pos_ref = (iou_max >= focal.POS_IOU) & has
        care_ref = pos_ref | (iou_max < focal.NEG_IOU) | ~has
        c_t, r_t = cls.clone().requires_grad_(True), reg.clone().requires_grad_(True)
        ref = focal.detection_loss_plain(c_t, r_t, ann, anchors)
        gc_ref, gr_ref = torch.autograd.grad(ref, (c_t, r_t), grad_outputs=list(g_out))
        torch.cuda.synchronize()
        same = (torch.equal(argmax, arg_ref) and torch.equal((flags & 1).bool(), pos_ref)
                and torch.equal(((flags >> 1) & 1).bool(), care_ref))
        if not same:
            fail(f"focal_loss b{b} {hw}: the kernel's assignment differs from the plain version's")
        again = FL.focal_loss_forward_cuda(cls, reg, ann, anchors)
        if not (torch.equal(again[0], losses) and torch.equal(again[1], num_pos)):
            fail(f"focal_loss b{b} {hw}: a second forward gave other losses {again[0].tolist()} ({losses.tolist()})")
        want = torch.stack([x.detach() for x in ref])
        rel = float(((losses - want).abs() / want.abs().clamp_min(1e-30)).max())
        over = max(float(((g - w).abs() - (1e-7 + 1e-5 * w.abs())).max()) for g, w in ((dcls, gc_ref), (dreg, gr_ref)))
        err = max(float((losses - want).abs().max()), float((dcls - gc_ref).abs().max()),
                  float((dreg - gr_ref).abs().max()))
        worst = max(worst, err)
        n_pos = int(pos_ref.sum())
        log(f"kernels: focal_loss b{b} {hw[0]}x{hw[1]} ({a} anchors, {int((ann[..., 20] >= 0).sum())} labels, "
            f"{n_pos} positives): assignment equal, a second run bit-equal; losses "
            f"{[round(float(x), 6) for x in losses]} (plain "
            f"{[round(float(x), 6) for x in want]}) max rel err {rel:.2e} (tolerance 1e-5); gradients worst excess "
            f"over 1e-5 rel + 1e-7 abs {over:.2e} (must be <= 0); max_abs_err {err:.3g}")
        if not rel <= 1e-5 or not over <= 0 or n_pos == 0:
            fail(f"focal_loss b{b} {hw}: losses rel err {rel}, gradient excess {over}, positives {n_pos}")
        del ref, c_t, r_t, gc_ref, gr_ref
        if (b, hw) == FOCAL_MANY:
            continue

        fwd = lambda: FL.focal_loss_forward_cuda(cls, reg, ann, anchors)
        bwd = lambda: FL.focal_loss_backward_cuda(cls, reg, ann, anchors, argmax, flags, num_pos, g_out)

        def plain():
            c, r = cls.detach().requires_grad_(True), reg.detach().requires_grad_(True)
            torch.autograd.grad(focal.detection_loss_plain(c, r, ann, anchors), (c, r), grad_outputs=list(g_out))

        fwd_ms = float(np.median([gpu_ms(fwd, iters=20, flush=flush) for _ in range(3)]))
        bwd_ms = float(np.median([gpu_ms(bwd, iters=20, flush=flush) for _ in range(3)]))
        fwd_warm, bwd_warm = gpu_ms(fwd, iters=20), gpu_ms(bwd, iters=20)
        fwd_k = kernel_split(fwd, ["focal_forward_kernel"], flush=flush)["focal_forward_kernel"]
        bwd_k = kernel_split(bwd, ["focal_backward_kernel"], flush=flush)["focal_backward_kernel"]
        plain_ms = gpu_ms(plain, iters=3, flush=flush)
        fb, bb = focal_bytes(b, a, int(care_ref.sum()), n_pos)
        bound_f, bound_b = fb / HBM_BYTES_PER_S * 1e3, bb / HBM_BYTES_PER_S * 1e3
        log(f"kernels: focal_loss b{b} {hw[0]}x{hw[1]} times: forward {fwd_ms * 1e3:.1f} us (L2 cold, median of 3 x "
            f"20; {fwd_warm * 1e3:.1f} warm; kernel alone {us(fwd_k)}), bound {bound_f * 1e3:.1f} us ({fb} bytes "
            f"at 3.35 TB/s), {bound_f / fwd_ms * 100:.1f}% of bound; backward {bwd_ms * 1e3:.1f} us "
            f"({bwd_warm * 1e3:.1f} warm; kernel alone {us(bwd_k)}), bound "
            f"{bound_b * 1e3:.1f} us ({bb} bytes), {bound_b / bwd_ms * 100:.1f}% of bound; plain version forward + "
            f"backward (autograd) {plain_ms * 1e3:.1f} us; an empty kernel {noop_ms * 1e3:.2f} us; no single "
            f"library call computes it")
        if row is None:  # the app's default shape is the row's
            row = {
                "name": "focal_loss", "route": "cuda", "source": "playground3d_tpu_torch/csrc/focal_loss.cu",
                "replaces": "playground3d_tpu/losses/focal.py:187", "bound_by": "bytes",
                "ms": fwd_ms + bwd_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_f + bound_b,
            }
        del cls, reg, ann, anchors, dcls, dreg, argmax, flags
    row["max_abs_err"] = worst
    return row


def plateau_lrs(lr: float, losses, factor: float = 0.3, patience: int = 1):
    """The learning rates ReduceLROnPlateau gives after each epoch's loss."""
    best, bad, out = float("inf"), 0, []
    for v in losses:
        if v < best - 1e-6:
            best, bad = v, 0
        else:
            bad += 1
            if bad > patience:
                lr, bad = lr * factor, 0
        out.append(lr)
    return out


def train_small_reference(device):
    """The card against the CPU at depth 18 and 64x128 on the same batch,
    from the port's init with a fixed generator. First the whole-model
    gradient at float32 (TF32 off on the card), with non-zero output convs
    so the gradient reaches every layer and layer2's BN statistics away
    from identity, as ``tests/test_torch_train.py`` holds the CPU against
    JAX: per leaf within 2e-3 of the CPU's by norm. Then one
    ``Trainer.train_step`` at its bf16 from the init itself (its output
    convs are zero, so only they and the biases get a gradient; with the
    random ones the sigmoids saturate, and a bf16 rounding that moves an
    output across the clamp changes its gradient by up to 1e4): losses
    within 1e-3 relative; the step's gradients (clipped, before Adam) per
    leaf within 3e-2 by norm; every updated leaf within 2 lr (a near-zero
    gradient may have the other sign on the other device, and Adam's first
    step moves each element by lr either way)."""
    import torch

    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.models.anchors import anchors_for_shape
    from playground3d_tpu_torch.models.retinanet import retinanet_init
    from playground3d_tpu_torch.ops import focal_loss as FL
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer, loss_fn, make_optimizer, train_leaves

    cfg = TrainConfig(depth=18, image_shape=(64, 128))
    ds = SyntheticDetectionDataset(image_shape=(64, 128), n_objects=6, seed=2, zoom=8.0, output_dtype="uint8")
    frames, labels = next(ds.batches(2))
    model = retinanet_init(torch.Generator().manual_seed(0), depth=18, device="cpu")
    randomized = copy.deepcopy(model)
    rng = np.random.default_rng(5)
    with torch.no_grad():
        for k, t in train_leaves(randomized).items():
            if k.endswith(("cls_out/w", "reg_out/w")):
                t.copy_(torch.as_tensor(rng.normal(0, 0.02, tuple(t.shape)).astype(np.float32)))
            elif k.startswith("backbone/layer2/") and "/bn1/" in k:
                lo, hi = {"scale": (0.5, 1.5), "var": (0.5, 2.0)}.get(k.rsplit("/", 1)[1], (-0.1, 0.1))
                t.copy_(torch.as_tensor(rng.uniform(lo, hi, tuple(t.shape)).astype(np.float32)))

    def worst_leaf(got, want):
        """-> (the largest |got - want| / |want| over the leaves, its leaf)."""
        rel = {k: float((got[k] - want[k]).norm() / want[k].norm().clamp_min(1e-30)) for k in want}
        k = max(rel, key=rel.get)
        return rel[k], k

    grads = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", device):
            m = copy.deepcopy(randomized).to(dev)
            make_optimizer(cfg, m)
            anchors = torch.as_tensor(anchors_for_shape((64, 128)), device=dev)
            total, parts = loss_fn(m, torch.as_tensor(frames, device=dev), torch.as_tensor(labels, device=dev),
                                   anchors, dtype=torch.float32)
            total.backward()
            grads[str(dev)] = {k: t.grad.detach().cpu() for k, t in train_leaves(m).items()}
            if float(parts[1].detach()) <= 0:
                fail("train small: the batch has no positive anchor")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    f32_rel, f32_leaf = worst_leaf(grads[str(device)], grads["cpu"])
    zero = sum(float(g.norm()) == 0.0 for g in grads["cpu"].values())
    if zero >= len(grads["cpu"]) // 10:
        fail(f"train small: {zero} of {len(grads['cpu'])} leaves have no gradient")

    out = {}
    for dev in ("cpu", device):
        tr = Trainer(cfg, model=copy.deepcopy(model), device=dev)
        n0 = FL.focal_loss_forward_cuda.launches
        m = tr.train_step(frames, labels)
        leaves = train_leaves(tr.model)
        out[str(dev)] = ({k: float(v) for k, v in m.items()}, {k: t.detach().cpu() for k, t in leaves.items()},
                         {k: t.grad.detach().cpu() for k, t in leaves.items()})
        if dev != "cpu" and FL.focal_loss_forward_cuda.launches != n0 + 1:
            fail("train small: the card's step did not run the loss kernel")
    (m_c, p_c, g_c), (m_g, p_g, g_g) = out["cpu"], out[str(device)]
    rel = max(abs(m_g[k] - m_c[k]) / max(abs(m_c[k]), 1e-12) for k in m_c)
    bf16_rel, bf16_leaf = worst_leaf({k: g_g[k] for k in g_c if float(g_c[k].norm()) > 0},
                                     {k: g for k, g in g_c.items() if float(g.norm()) > 0})
    worst = max(float((p_g[k] - p_c[k]).abs().max()) for k in p_c)
    log(f"train: small reference (depth 18, 64x128, batch 2) card vs CPU: float32 gradient worst leaf "
        f"{f32_rel:.2e} ({f32_leaf}; tolerance 2e-3 by norm); one bf16 step: losses {m_g} (CPU {m_c}), max rel diff "
        f"{rel:.2e} (tolerance 1e-3); step gradient ({sum(float(g.norm()) > 0 for g in g_c.values())} leaves) worst leaf {bf16_rel:.2e} ({bf16_leaf}; tolerance 3e-2 by norm); "
        f"updated leaves max abs diff {worst:.3g} = {worst / cfg.lr:.2f} lr (tolerance 2 lr)")
    if not f32_rel <= 2e-3 or not rel <= 1e-3 or not bf16_rel <= 3e-2 or not worst <= 2 * cfg.lr:
        fail(f"train small reference: float32 gradient {f32_rel} ({f32_leaf}), losses rel diff {rel}, bf16 "
             f"gradient {bf16_rel} ({bf16_leaf}), parameters differ by {worst}")


def train_app_run(device, argv, label: str, batch: int):
    """``apps/train_detector.py`` in-process under the profiler (CUDA
    activity), the loss kernels' counts set to 0 just before and read just
    after; checks finite losses, the plateau rule and the checkpoint.
    Returns the summary and the kernels' launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from playground3d_tpu_torch.apps import train_detector
    from playground3d_tpu_torch.ops import focal_loss as FL

    FL.focal_loss_forward_cuda.launches = FL.focal_loss_backward_cuda.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        summary = train_detector.main(argv)
        torch.cuda.synchronize()
    launches = (FL.focal_loss_forward_cuda.launches, FL.focal_loss_backward_cuda.launches)
    kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in kern) / 1e3
    loss_ms = sum(ev.self_device_time_total for ev in kern if "focal_" in ev.key) / 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = summary["steps"]
    losses = [e["loss"] for e in summary["epochs"]]
    want_lrs = plateau_lrs(float(argv[argv.index("--lr") + 1]) if "--lr" in argv else 1e-4, losses)
    if launches != (steps, steps):
        fail(f"train ({label}): loss kernel launches {launches} for {steps} steps (one forward, one backward a step)")
    if not losses or not all(np.isfinite(losses)):
        fail(f"train ({label}): epoch losses {losses}")
    if [e["lr"] for e in summary["epochs"]] != want_lrs:
        fail(f"train ({label}): learning rates {[e['lr'] for e in summary['epochs']]}, the plateau rule gives {want_lrs}")
    pf = summary["prefetch"]
    log(f"train ({label}): {steps} steps in {summary['seconds']:.2f} s (first step included; under the profiler): "
        f"{steps / summary['seconds']:.3f} steps/s, {steps * batch / summary['seconds']:.2f} images/s; card busy "
        f"{busy:.1f} ms ({busy / (summary['seconds'] * 1e3) * 100:.1f}% of the wall); host ms per batch in the "
        f"Prefetcher: produce {pf['produce'] / pf['batches'] * 1e3:.1f}, stage {pf['stage'] / pf['batches'] * 1e3:.2f} "
        f"({pf['batches']} batches); peak device memory {peak:.2f} GiB; focal_loss launches {sum(launches)} "
        f"({sum(launches) / steps:.0f} a step), their device time {loss_ms / steps * 1e3:.1f} us a step; epoch "
        f"losses {[round(v, 4) for v in losses]}, lr {want_lrs}")
    return summary, sum(launches)


def check_checkpoint(path: str, depth: int, hw, **arch):
    """The app's checkpoint loads into a RetinaNet (``load_params``) and
    runs a finite forward."""
    import torch

    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import forward_raw, retinanet_init

    model = load_params(path, retinanet_init(depth=depth, **arch))
    with torch.no_grad():
        cls, reg = forward_raw(model, torch.zeros((1,) + tuple(hw) + (3,), dtype=torch.uint8, device="cuda"))
    if not (torch.isfinite(cls).all() and torch.isfinite(reg).all()):
        fail(f"train: the checkpoint {path} gives a non-finite forward")
    return model


def train_full_trainer(device, n_steps: int = 5):
    """One ``Trainer`` at TrainConfig's own image shape (1080x1920, the
    ResNet-50 of the defaults), batch 2, ``n_steps`` steps from the
    Prefetcher: steps/s and images/s after a warm-up step, card busy over
    the timed steps, host ms per batch, peak memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from playground3d_tpu_torch.data.dataset import Prefetcher, SyntheticDetectionDataset
    from playground3d_tpu_torch.ops import focal_loss as FL
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg = TrainConfig()
    tr = Trainer(cfg, generator=torch.Generator().manual_seed(0), device=device)
    ds = SyntheticDetectionDataset(image_shape=cfg.image_shape, output_dtype="uint8", seed=4)
    batches = Prefetcher(ds.batches(2), depth=3, device=device)
    try:
        tr.train_step(*next(batches))  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        FL.focal_loss_forward_cuda.launches = FL.focal_loss_backward_cuda.launches = 0
        t0, pf0 = time.time(), dict(batches.seconds, n=batches.batches)
        losses = []
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_steps):
                losses.append(tr.train_step(*next(batches)))
            torch.cuda.synchronize()
        wall = time.time() - t0
        pf = {k: batches.seconds[k] - pf0[k] for k in ("produce", "stage")}
        n_pf = batches.batches - pf0["n"]
    finally:
        batches.close()
    kern = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy = sum(ev.self_device_time_total for ev in kern) / 1e3
    loss_ms = sum(ev.self_device_time_total for ev in kern if "focal_" in ev.key) / 1e3
    vals = [{k: float(v) for k, v in m.items()} for m in losses]
    if not all(np.isfinite(list(v.values())).all() for v in vals):
        fail(f"train (1080x1920): non-finite losses {vals}")
    tr.end_epoch(float(np.mean([v["loss"] for v in vals])))
    if tr.lr != plateau_lrs(cfg.lr, tr.history)[-1]:
        fail(f"train (1080x1920): lr {tr.lr} off the plateau rule")
    launches = FL.focal_loss_forward_cuda.launches + FL.focal_loss_backward_cuda.launches
    if launches != 2 * n_steps:
        fail(f"train (1080x1920): {launches} loss kernel launches over {n_steps} steps")
    os.makedirs("_outputs", exist_ok=True)
    tr.save(os.path.join("_outputs", "train_1080p.npz"))
    check_checkpoint(os.path.join("_outputs", "train_1080p.npz"), 50, (H // 4, W // 4))
    log(f"train (Trainer, 1080x1920, ResNet-50, batch 2): {n_steps} steps after a warm-up in {wall:.2f} s: "
        f"{n_steps / wall:.3f} steps/s, {2 * n_steps / wall:.2f} images/s; card busy {busy:.1f} ms "
        f"({busy / (wall * 1e3) * 100:.1f}% of the wall, under the profiler); host ms per batch in the Prefetcher: "
        f"produce {pf['produce'] / max(n_pf, 1) * 1e3:.1f}, stage {pf['stage'] / max(n_pf, 1) * 1e3:.2f} ({n_pf} "
        f"batches produced meanwhile); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"focal_loss launches {launches} ({launches / n_steps:.0f} a step), their device time "
        f"{loss_ms / n_steps * 1e3:.1f} us a step; losses {[round(v['loss'], 4) for v in vals]}")
    del tr


def train_fit_filter(device):
    """``apps/fit_filter.py`` on the tracks of synthetic scenes; its npz
    through ``params_from_arrays`` into a ``SingleCameraTracker`` on the
    card, driven by oracle detections."""
    from playground3d_tpu_torch.apps import fit_filter
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, oracle_detections
    from playground3d_tpu_torch.data.toy_cameras import toy_camera_chain
    from playground3d_tpu_torch.pipeline.single_cam import SingleCameraTracker
    from playground3d_tpu_torch.track.kf import params_from_arrays
    from playground3d_tpu_torch.train.fit_kf import load_kf_params
    from playground3d_tpu_torch.utils.config import TrackerConfig

    os.makedirs("_outputs", exist_ok=True)
    path = os.path.join("_outputs", "kf_params.npz")
    fit_filter.main(["--out", path])
    params = params_from_arrays(load_kf_params(path), device=device)
    reg = toy_camera_chain(1)[0]
    scene, rng, t = SyntheticScene(n_objects=4, seed=1), np.random.default_rng(0), [0.0]
    det = lambda frames: oracle_detections(scene, t[0], reg.P[0, 0], 8, rng=rng, device=device)
    trk = SingleCameraTracker(reg, "p1c1", cfg=TrackerConfig(max_tracks=8, max_dets=8), kf_params=params,
                              detect_fn=det, device=device)
    for f in range(8):
        t[0] = f / 30.0
        trk.process_frame(np.zeros((4, 4, 3), np.float32), 1.6e9 + t[0], f)
    n = sum(len(r[2]) for r in trk.rows)
    if n == 0 or not all(np.isfinite(np.asarray(r[3])).all() for r in trk.rows):
        fail("train: the fitted filter's tracker gave no finite tracks")
    log(f"train: apps.fit_filter -> {path}; its params drove SingleCameraTracker on the card over 8 oracle frames: "
        f"{n} live (id, frame) rows, all finite")


def phase_train(device) -> dict:
    """Detector training on the card: the card's step against the CPU's on a
    small input; ``apps/train_detector.py`` at its defaults (ResNet-50,
    conv7, FPN/heads 256 wide, 4-conv separate towers, 512x768, batch 4,
    uint8 frames), 20 steps of 10 a epoch, and the crop net (112 px crops,
    ResNet-18, 2-conv shared tower), each checkpoint loaded back, the
    detector's run through ``apps/track.py --mode single``; one Trainer at
    1080x1920; KF fitting into a tracker. Returns the loss kernel's launches
    on the app's default run (forward + backward)."""
    import torch

    from playground3d_tpu_torch.apps import track

    t_phase = time.time()
    train_small_reference(device)
    os.makedirs("_outputs", exist_ok=True)
    det_path, crop_path = os.path.join("_outputs", "train_det.npz"), os.path.join("_outputs", "train_crop.npz")
    for p in (det_path, crop_path):
        if os.path.exists(p):
            os.remove(p)
    _, launches = train_app_run(device, ["--steps", "20", "--steps-per-epoch", "10", "--out", det_path],
                                "apps.train_detector defaults: ResNet-50, 512x768, batch 4", 4)
    check_checkpoint(det_path, 50, (512, 768))
    train_app_run(device, ["--steps", "20", "--steps-per-epoch", "10", "--crop", "--crop-size", "112", "--depth", "18",
                           "--tower-depth", "2", "--shared-tower", "--out", crop_path],
                  "apps.train_detector --crop: ResNet-18 crop net, 112 px", 4)
    check_checkpoint(crop_path, 18, (112, 112), tower_depth=2, shared_tower=True)
    out = os.path.join("_outputs", "track_trained.csv")
    t0 = time.time()
    track.main(["--mode", "single", "--checkpoint", det_path, "--frames", "4", "--out", out])
    with open(out) as fh:
        n_rows = sum(1 for _ in fh)
    log(f"train: apps.track --mode single --checkpoint {det_path} (the trained detector, 1080p rendered frames, "
        f"4 frames): {time.time() - t0:.1f} s, {n_rows} CSV lines")
    torch.cuda.empty_cache()
    train_full_trainer(device)
    train_fit_filter(device)
    log(f"train: phase took {time.time() - t_phase:.1f} s")
    return {"focal_loss": launches}


# ---------------------------------------------------------------------------
# phase 7: the apps and tools
# ---------------------------------------------------------------------------


def app_counters():
    """name in the apps phase's lines -> the wrappers that count its
    launches (the loss: forward and backward)."""
    from playground3d_tpu_torch.ops import assignment, crop_mxu, focal_loss, nms, qconv

    return {
        "qconv": (qconv.qconv_cuda,),
        "nms": (nms.nms_cuda,),
        "auction": (assignment.assign_auction_cuda,),
        "crop_resize_s2d": (crop_mxu.crop_and_resize_s2d_cuda,),
        "focal_loss": (focal_loss.focal_loss_forward_cuda, focal_loss.focal_loss_backward_cuda),
    }


def counted(fn):
    """Run ``fn()`` with every app counter set to 0 just before and read
    just after -> (its result, {name: launches})."""
    import torch

    counters = app_counters()
    for wrappers in counters.values():
        for w in wrappers:
            w.launches = 0
    torch.cuda.synchronize()
    out = fn()
    torch.cuda.synchronize()
    return out, {name: sum(w.launches for w in wrappers) for name, wrappers in counters.items()}


def counts_text(launches: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in launches.items())


def quiet(fn):
    """Run ``fn()`` with its standard output captured -> (result, text): an
    app's own progress lines stay out of the run's tail."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def spread_biases(heads, rng, cls_sd: float, reg_sd: float) -> None:
    """Random per-channel biases for a detector's output convs (class
    logits around -1, regression around 0): a fresh detector's focal-prior
    heads score every anchor 0.01, below every app's threshold. With the
    output convs' weights zero, as initialized, every score and box is its
    bias, whatever the backbone computes, so the card and the CPU decide
    ties alike."""
    import torch

    with torch.no_grad():
        for conv, mean, sd in ((heads.cls_out, -1.0, cls_sd), (heads.reg_out, 0.0, reg_sd)):
            conv.b.copy_(torch.as_tensor(rng.normal(mean, sd, conv.b.shape[0]), dtype=torch.float32))


def zero_head_checkpoint(path: str, depth: int = 18, seed: int = 0):
    """A conv7 RetinaNet checkpoint with zero output convs and random
    per-channel biases (:func:`spread_biases`)."""
    import torch

    from playground3d_tpu_torch.models.nn import save_params
    from playground3d_tpu_torch.models.retinanet import retinanet_init

    m = retinanet_init(torch.Generator().manual_seed(seed), depth=depth, device="cpu")
    spread_biases(m.heads, np.random.default_rng(seed + 40), 1.5, 0.2)
    save_params(path, m)
    return path


def recorded_nms(fn, label: str):
    """Run ``fn()`` with its launches listed, not counted, and replay its
    one NMS call alone -> (n, text): the kernels of that call are the
    nodes of a CUDA graph that captures it, which must be the route that
    ``launch_plan(n)`` names (one launch, or the beats grid and the loop
    block), plus, on the two-launch route, the kernel that shifts the
    class groups apart when the call passes groups (the one launch shifts
    them inside)."""
    import torch

    from playground3d_tpu_torch.ops import nms as N
    from playground3d_tpu_torch.ops.cuda_build import calls_recorded

    with calls_recorded() as seen:  # measurement: the NMS call's own arguments, uncounted
        fn()
        torch.cuda.synchronize()
    calls = [args for wrapper, args in seen if wrapper is N.nms_cuda]
    if len(calls) != 1:
        fail(f"apps: {label}: {len(calls)} NMS calls, n {[c[0].shape[0] for c in calls]}")
    n, grouped = calls[0][0].shape[0], calls[0][-1] is not None
    one = N.launch_plan(n).one_launch
    nodes = launched_kernels(lambda: N.nms_cuda(*calls[0]))
    shift = grouped and not one  # the one-launch route shifts the groups inside
    if nodes != (1 if one else 2) + shift:
        fail(f"apps: {label}: its NMS at n {n} is {nodes} kernels, not launch_plan({n})'s route"
             f"{' and the class shift' if shift else ''}")
    return n, (f"its NMS call at n {n:,} is {nodes} kernels: the {'one' if one else 'two'}-launch route"
               f"{' after the class shift' if shift else ''}")


def detections_equal(label: str, cpu, card) -> str:
    """Two Detections (or detect_2d tuples): masks and classes equal, boxes
    within 1e-3, scores within 1e-6 relative."""
    cpu = [t.cpu() for t in cpu]
    card = [t.cpu() for t in card]
    named = dict(zip(("scores", "classes", "boxes", "mask") if len(cpu) == 4 else
                     ("scores", "classes", "boxes", "cam_idx", "mask"), range(len(cpu))))
    for k in ("classes", "mask") + (("cam_idx",) if "cam_idx" in named else ()):
        if not np.array_equal(cpu[named[k]].numpy(), card[named[k]].numpy()):
            fail(f"apps: {label}: {k} differs between the card and the CPU")
    mask = cpu[named["mask"]].numpy()
    if mask.sum() < 4:
        fail(f"apps: {label}: only {mask.sum()} detections kept on the small input")
    db = float(np.abs(cpu[named["boxes"]].numpy() - card[named["boxes"]].numpy())[mask].max())
    s0, s1 = cpu[named["scores"]].numpy()[mask], card[named["scores"]].numpy()[mask]
    ds = float(np.max(np.abs(s0 - s1) / np.abs(s0)))
    if not (db <= 1e-3 and ds <= 1e-6):
        fail(f"apps: {label}: boxes differ by {db} or scores by {ds} (relative) between the card and the CPU")
    return f"{int(mask.sum())} kept, masks/classes equal, boxes max_abs_diff {db:.3g}, scores max_rel_diff {ds:.3g}"


def read_detections_csv(path):
    import csv

    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], rows[1:-1], rows[-1]


def apps_detect_video(device, ckpt: str):
    """``apps/detect_video.py`` in-process: the card against the CPU at
    64x96, depth 18 (a zero-head checkpoint), then at its defaults
    (ResNet-50 conv7, 1080x1920 synthetic frames) for 24 frames from
    ``ckpt`` (ResNet-50, zero output convs with spread biases, so rows pass
    the app's confidence threshold and its NMS has boxes to suppress)."""
    from playground3d_tpu_torch.apps import detect_video

    small_ckpt = zero_head_checkpoint(os.path.join("_outputs", "apps_det_small.npz"))
    small = ["--frames", "3", "--depth", "18", "--height", "64", "--width", "96", "--checkpoint", small_ckpt,
             "--conf", "0.5"]
    got = {}
    for dev in ("cpu", str(device)):
        out = os.path.join("_outputs", f"detect_video_small_{dev.replace(':', '')}.csv")
        quiet(lambda: detect_video.main(small + ["--out", out, "--device", dev]))
        got[dev] = read_detections_csv(out)
    (h0, r0, _), (h1, r1, _) = got["cpu"], got[str(device)]
    if h0 != h1 or len(r0) != len(r1) or len(r0) < 24:
        fail(f"apps: detect_video small: {len(r1)} rows on the card, {len(r0)} on the CPU")
    a, b = np.asarray(r0, np.float64), np.asarray(r1, np.float64)
    if not np.array_equal(a[:, :3], b[:, :3]):
        fail("apps: detect_video small: frames, timestamps or classes differ between the card and the CPU")
    dc, db = float(np.max(np.abs(a[:, 3] - b[:, 3]) / a[:, 3])), float(np.abs(a[:, 4:] - b[:, 4:]).max())
    if not (dc <= 1e-6 and db <= 1e-3):
        fail(f"apps: detect_video small: confidences differ by {dc} (relative) or corners by {db}")
    log(f"apps: detect_video small (depth 18, 64x96, 3 frames) card vs CPU: {len(r1)} rows, frames/classes equal, "
        f"confidence max_rel_diff {dc:.3g}, corners max_abs_diff {db:.3g}")

    out = os.path.join("_outputs", "detect_video.csv")
    argv = ["--out", out, "--checkpoint", ckpt, "--device", str(device)]
    n, route = recorded_nms(lambda: quiet(lambda: detect_video.main(argv + ["--frames", "1"])), "detect_video")
    _, launches = counted(lambda: quiet(lambda: detect_video.main(argv + ["--frames", str(T_CLIP)])))
    header, rows, trailer = read_detections_csv(out)
    if len(header) != 24 or len(trailer) != 1 or not trailer[0].startswith("Processing fps: "):
        fail(f"apps: detect_video: header {header[:4]}..., trailer {trailer}")
    if not rows or not np.isfinite(np.asarray(rows, np.float64)).all():
        fail(f"apps: detect_video: {len(rows)} rows above conf 0.3, or non-finite values in the CSV")
    if {int(r[0]) for r in rows} != set(range(T_CLIP)):
        fail(f"apps: detect_video: rows for frames {sorted({int(r[0]) for r in rows})}, not each of {T_CLIP}")
    fps = float(trailer[0].split(": ")[1])
    if launches["nms"] != T_CLIP or launches["qconv"] or launches["auction"]:
        fail(f"apps: detect_video: launches {launches} for {T_CLIP} frames (one batched_nms a frame)")
    t0 = time.time()
    for _ in detect_video.synthetic_source(H, W, T_CLIP):
        pass
    host_fps = T_CLIP / (time.time() - t0)
    log(f"apps: detect_video defaults (ResNet-50 conv7, {H}x{W}, {T_CLIP} synthetic frames, spread-bias heads): "
        f"{fps:.2f} frames/s (the CSV's trailer: host clock, first frame and every read included), {len(rows)} rows "
        f"above conf 0.3 (every frame); nms {launches['nms'] / T_CLIP:.0f} call a frame, {route}; the app's "
        f"synthetic source alone (rendering and normalizing on the host): {host_fps:.2f} frames/s")
    return launches


def apps_detect_singleframe(device, ckpt: str):
    """``detect_singleframe``: the card against the CPU at 128x192 (depth
    18, zero-head weights), then ResNet-50 conv7 from ``ckpt`` at 1080x1920
    with its defaults (pre_topk 4,096, max_dets 256): its NMS takes the
    two-launch route and is called once."""
    import torch

    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import detect_singleframe, retinanet_init

    small = load_params(zero_head_checkpoint(os.path.join("_outputs", "apps_single_small.npz"), seed=3),
                        retinanet_init(depth=18, device="cpu"))
    x = torch.as_tensor(np.random.default_rng(6).uniform(-1, 1, (128, 192, 3)).astype(np.float32))
    cpu = detect_singleframe(small, x, max_dets=64)
    card = detect_singleframe(copy.deepcopy(small).to(device), x.to(device), max_dets=64)
    log(f"apps: detect_singleframe small (depth 18, 128x192, pre_topk 4,096) card vs CPU: "
        f"{detections_equal('detect_singleframe small', cpu, card)}")

    model = load_params(ckpt, retinanet_init(depth=50, device=device))
    image = torch.as_tensor(np.random.default_rng(7).uniform(-1, 1, (H, W, 3)).astype(np.float32)).to(device)
    n, route = recorded_nms(lambda: detect_singleframe(model, image), "detect_singleframe")
    if n != 4096 or "two-launch" not in route:
        fail(f"apps: detect_singleframe: {route}, not the two-launch route at n 4,096")
    det, launches = counted(lambda: detect_singleframe(model, image))
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        detect_singleframe(model, image)
    e.record()
    torch.cuda.synchronize()
    kept = int(det.mask.sum())
    if launches["nms"] != 1 or not kept or not torch.isfinite(det.boxes[det.mask]).all() or det.scores.shape != (256,):
        fail(f"apps: detect_singleframe 1080p: launches {launches}, {kept} kept")
    log(f"apps: detect_singleframe (ResNet-50 conv7, {H}x{W}, spread-bias heads, pre_topk 4,096, max_dets 256): "
        f"{kept} kept, finite; {route}; {s.elapsed_time(e) / 5:.2f} ms a call (CUDA events, mean of 5)")
    return launches


def apps_detect_2d(device):
    """``models/retinanet2d.py`` on the card against the CPU at a small size
    (depth 18, 4 classes): ``forward_raw_2d`` in bf16 with random output
    convs at 64x96 (so the backbone, FPN and towers decide every output),
    held as the CPU tests hold it to JAX (logits and regression within 2e-2
    relative plus 2e-2 of the largest); ``detect_2d`` with zero output
    convs and spread biases at 128x192. Then ``detect_2d`` once at
    1080x1920 with ResNet-50, 80 classes and spread biases."""
    import torch

    from playground3d_tpu_torch.models.anchors import num_anchors_for_shape
    from playground3d_tpu_torch.models.retinanet2d import detect_2d, forward_raw_2d, retinanet2d_init

    net = retinanet2d_init(torch.Generator().manual_seed(1), num_classes=4, depth=18, device="cpu")
    rng = np.random.default_rng(9)
    with torch.no_grad():
        for conv in (net.heads.cls_out, net.heads.reg_out):
            conv.w.copy_(torch.as_tensor(rng.normal(0, 0.0015, tuple(conv.w.shape)), dtype=torch.float32))
    x = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (1, 64, 96, 3)).astype(np.float32))
    (c0, r0), (c1, r1) = forward_raw_2d(net, x), forward_raw_2d(copy.deepcopy(net).to(device), x.to(device))
    l0, l1 = (np.log(c) - np.log1p(-c) for c in (c0.double().cpu().numpy(), c1.double().cpu().numpy()))
    r0, r1 = r0.cpu().numpy(), r1.cpu().numpy()
    if not np.abs(l0).max() < 15:
        fail(f"apps: forward_raw_2d small: logits up to {np.abs(l0).max()}, past what the sigmoid keeps exactly")
    for name, p, q in (("logits", l1, l0), ("regression", r1, r0)):
        if not np.allclose(p, q, rtol=2e-2, atol=2e-2 * np.abs(q).max()):
            fail(f"apps: forward_raw_2d small: {name} differ between the card and the CPU by up to "
                 f"{np.abs(p - q).max()} (largest {np.abs(q).max()})")
    log(f"apps: forward_raw_2d small (depth 18, 4 classes, 64x96, bf16, random output convs) card vs CPU: logits "
        f"max_abs_diff {np.abs(l1 - l0).max():.3g} of {np.abs(l0).max():.3g}, regression {np.abs(r1 - r0).max():.3g} "
        f"of {np.abs(r0).max():.3g} (tolerance 2e-2 relative + 2e-2 of the largest)")

    small = retinanet2d_init(torch.Generator().manual_seed(2), num_classes=4, depth=18, device="cpu")
    spread_biases(small.heads, np.random.default_rng(4), 1.0, 0.3)
    x = torch.as_tensor(np.random.default_rng(8).uniform(-1, 1, (128, 192, 3)).astype(np.float32))
    cpu = detect_2d(small, x, max_dets=32)
    card = detect_2d(copy.deepcopy(small).to(device), x.to(device), max_dets=32)
    log(f"apps: detect_2d small (depth 18, 4 classes, 128x192) card vs CPU: "
        f"{detections_equal('detect_2d small', cpu, card)}")

    model = retinanet2d_init(torch.Generator().manual_seed(0), num_classes=80, depth=50, device=device)
    spread_biases(model.heads, np.random.default_rng(10), 1.0, 0.2)
    image = torch.as_tensor(np.random.default_rng(9).uniform(-1, 1, (H, W, 3)).astype(np.float32)).to(device)
    (scores, classes, boxes, mask), launches = counted(lambda: detect_2d(model, image))
    kept = int(mask.sum())
    if launches["nms"] != 1 or scores.shape != (100,) or not kept or not torch.isfinite(boxes).all():
        fail(f"apps: detect_2d 1080p: launches {launches}, shapes {tuple(scores.shape)}, {kept} kept")
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(3):
        detect_2d(model, image)
    e.record()
    torch.cuda.synchronize()
    log(f"apps: detect_2d (ResNet-50, 80 classes, {H}x{W}, spread-bias heads: the top 1,000 of "
        f"{num_anchors_for_shape((H, W)) * 80:,} scores): {kept} kept above 0.05, finite; nms calls "
        f"{launches['nms']}; {s.elapsed_time(e) / 3:.2f} ms a call (CUDA events, mean of 3)")
    return launches


def apps_benchmark_speed(device):
    """``tools/benchmark_speed.py`` at its defaults (540x960, ResNet-50,
    batches 1/2/4/8, 10 iterations): its lines."""
    from playground3d_tpu_torch.tools import benchmark_speed

    _, text = quiet(lambda: benchmark_speed.main(["--device", str(device)]))
    lines = text.strip().splitlines()
    if len(lines) != 5 or not lines[0].startswith("device: "):
        fail(f"apps: benchmark_speed printed {lines}")
    for line in lines:
        log(f"apps: benchmark_speed: {line}")


def apps_forward_share(device, n: int = 5):
    """How much of a training step is the forward: one ``Trainer.train_step``
    (``apps/train_detector.py``'s defaults: ResNet-50 conv7, FPN/heads 256,
    uint8 frames, batch 4 at 512x768) and one ``forward_raw`` of the same
    batch without gradients, each ``n`` times after a warm-up, their card
    busy time under the profiler and their wall time by CUDA events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.models.retinanet import forward_raw
    from playground3d_tpu_torch.train.trainer import TrainConfig, Trainer

    hw, batch = (512, 768), 4
    frames, labels = next(SyntheticDetectionDataset(image_shape=hw, output_dtype="uint8").batches(batch))
    frames, labels = torch.as_tensor(frames).to(device), torch.as_tensor(labels).to(device)
    trainer = Trainer(TrainConfig(depth=50, image_shape=hw), generator=torch.Generator().manual_seed(0),
                      device=device)

    def forward():
        with torch.no_grad():
            forward_raw(trainer.model, frames)

    def measure(fn):
        for _ in range(2):
            fn()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        busy = sum(ev.self_device_time_total for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
        return busy / n / 1e3, s.elapsed_time(e) / n

    step_busy, step_wall = measure(lambda: trainer.train_step(frames, labels))
    fwd_busy, fwd_wall = measure(forward)
    if not step_busy > 0:
        fail("apps: the profiler saw no device time in a training step")
        return
    log(f"apps: forward's share of a training step (ResNet-50 conv7, {hw[0]}x{hw[1]}, batch {batch}, uint8; "
        f"mean of {n}): step busy {step_busy:.2f} ms / wall {step_wall:.2f} ms; forward without gradients busy "
        f"{fwd_busy:.2f} ms / wall {fwd_wall:.2f} ms: {fwd_busy / step_busy * 100:.1f}% of the step's busy time")
    del trainer
    torch.cuda.empty_cache()


def app_metrics(metrics, keys=("Recall", "Precision", "MOTA", "ID switches")) -> str:
    return ", ".join(f"{k} {float(metrics[k]):.3f}" for k in keys)


def apps_demos(device):
    """The demos with short training at full width (512x768, depth 18, 3
    cameras): ``demo_e2e --quantize``; ``demo_e2e_mc`` trained once
    (``--sequences 0``), then tracking float and ``--quantize --cd-max 8``
    from its checkpoints; ``auto_label_e2e`` at 256x384. Each run's
    launches are counted on their own. No quality floor: the nets are
    barely trained. -> (the multi-camera demo's checkpoint prefix, each
    run's launches)."""
    from playground3d_tpu_torch.apps import auto_label_e2e, demo_e2e, demo_e2e_mc

    out_dir = os.path.join("_outputs", "apps")
    os.makedirs(out_dir, exist_ok=True)
    runs = {}

    def run(label, app, argv, need):
        t0 = time.time()
        (metrics, text), launches = counted(lambda: quiet(lambda: app.main(argv)))
        missing = [k for k in need if launches[k] < 1]
        if missing:
            fail(f"apps: {label}: no launch of {missing} ({counts_text(launches)})")
        runs[label] = launches
        log(f"apps: {label}: {time.time() - t0:.1f} s; {app_metrics(metrics) if metrics else 'trained'}; "
            f"launches {counts_text(launches)}")
        return metrics, text

    prefix = os.path.join(out_dir, "demo")
    _, text = run("demo_e2e --steps 100 --quantize (ResNet-18 s2d, 512x768, 90 frames)", demo_e2e,
                  ["--steps", "100", "--quantize", "--out-prefix", prefix, "--device", str(device)],
                  ("focal_loss", "qconv", "nms", "auction"))
    losses = text.split("training done; loss ")[1].split("\n")[0].split(" -> ")
    if not all(np.isfinite([float(v) for v in losses])):
        fail(f"apps: demo_e2e: losses {losses}")
    check_checkpoint(prefix + "_detector.npz", 18, (512, 768), stem="s2d")

    prefix = os.path.join(out_dir, "mc")
    _, text = run("demo_e2e_mc --steps 100 --crop-steps 60 --sequences 0 (train only)", demo_e2e_mc,
                  ["--steps", "100", "--crop-steps", "60", "--sequences", "0", "--out-prefix", prefix,
                   "--device", str(device)], ("focal_loss",))
    for tag in ("detector", "crop-detector"):
        loss = float(text.split(f"{tag} done: loss=")[1].split("\n")[0])
        if not np.isfinite(loss):
            fail(f"apps: demo_e2e_mc: {tag} loss {loss}")
    check_checkpoint(prefix + "_det.npz", 18, (512, 768), stem="s2d")
    check_checkpoint(prefix + "_crop.npz", 18, (112, 112))
    ckpts = ["--det-ckpt", prefix + "_det.npz", "--crop-ckpt", prefix + "_crop.npz"]
    for label, extra in (("float", []), ("--quantize --cd-max 8", ["--quantize", "--cd-max", "8"])):
        need = ("qconv", "nms", "auction", "crop_resize_s2d") if extra else ("nms", "auction", "crop_resize_s2d")
        run(f"demo_e2e_mc {label} from the checkpoints (3 cameras, 60 frames)", demo_e2e_mc,
            ckpts + extra + ["--out-prefix", prefix + ("_int8" if extra else "_float"), "--device", str(device)],
            need)

    run("auto_label_e2e --steps 100 (256x384, 60 frames)", auto_label_e2e,
        ["--steps", "100", "--out-prefix", os.path.join(out_dir, "al"), "--device", str(device),
         "--height", "256", "--width", "384"],
        ("focal_loss", "nms"))
    for suffix in (".y4m", "_session.npz", "_pred.csv", "_gt.csv"):
        if not os.path.exists(os.path.join(out_dir, "al") + suffix):
            fail(f"apps: auto_label_e2e wrote no {suffix}")
    return prefix, runs


def apps_overlay(device, prefix):
    """``TrackOverlayWriter`` as ``on_frame`` of the multi-camera tracker
    over one clip (``process`` a frame, 512x768) with the demo's trained
    nets: a PNG a camera a frame."""
    import torch

    from playground3d_tpu_torch.apps.demo_e2e_mc import shifted_registry
    from playground3d_tpu_torch.data.dataset import SyntheticDetectionDataset
    from playground3d_tpu_torch.data.synthetic import SyntheticScene, render_frame
    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import retinanet_init
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker
    from playground3d_tpu_torch.tools.visualize import TrackOverlayWriter
    from playground3d_tpu_torch.utils.config import TrackerConfig

    hw = (512, 768)
    ds = SyntheticDetectionDataset(image_shape=hw)
    shifts = [0.0, 160.0, 320.0]
    reg, projectors = shifted_registry(ds, shifts)
    cameras = list(projectors)
    det = load_params(prefix + "_det.npz", retinanet_init(depth=18, stem="s2d", device=device))
    crop = load_params(prefix + "_crop.npz", retinanet_init(depth=18, device=device))
    out = os.path.join("_outputs", "apps", "overlay")
    writer = TrackOverlayWriter(reg, cameras, out)
    cfg = TrackerConfig(max_tracks=32, max_dets=48, pre_topk=1024, x_range=(415.0, 1030.0), sigma_d=0.25,
                        sigma_c=0.2, det_step=3, estimate_ts_bias=False, merge_dist_ft=12.0)
    trk = MultiCameraTracker(reg, cameras, cfg=cfg, det_model=det, crop_model=crop,
                             centers=np.array([[565.0 + dx, 60.0] for dx in shifts], np.float32),
                             stem="s2d", crop_stem="conv7", device=device, on_frame=writer)
    scene = SyntheticScene(n_objects=10, seed=99, x_spawn=(465.0, 980.0), x_visible=(445.0, 1000.0))
    rng = np.random.default_rng(5)
    t0 = time.time()
    for f in range(T_CLIP):
        frames = np.stack([(np.clip(render_frame(scene, f / 30.0, reg.P[ci, 0], height=hw[0], width=hw[1], rng=rng,
                                                 normalized=False)[0], 0, 1) * 255).astype(np.uint8)
                           for ci in range(len(cameras))])
        trk.process(frames, [1.6e9 + f / 30.0] * len(cameras), f)
    writer.close()
    torch.cuda.synchronize()
    pngs = sorted(os.path.join(c, p) for c in cameras for p in os.listdir(os.path.join(out, c)) if p.endswith(".png"))
    if writer.frames_written != T_CLIP or len(pngs) != T_CLIP * len(cameras):
        fail(f"apps: TrackOverlayWriter wrote {len(pngs)} PNGs for {T_CLIP} frames x {len(cameras)} cameras")
    log(f"apps: TrackOverlayWriter on MultiCameraTracker.process (3 cameras, {hw[0]}x{hw[1]}, {T_CLIP} frames): "
        f"{len(pngs)} PNGs in {out} ({time.time() - t0:.1f} s, rendering and PNG encoding included)")


def phase_apps(device) -> dict:
    """The last one-card apps and tools on the card: ``detect_video``,
    ``detect_singleframe``, ``detect_2d``, ``benchmark_speed``, the demos
    with short training, ``TrackOverlayWriter``. Returns each run's
    launches."""
    import torch

    t_phase = time.time()
    os.makedirs("_outputs", exist_ok=True)
    # one ResNet-50 conv7 detector with spread-bias heads for both 1080p detect paths
    ckpt = zero_head_checkpoint(os.path.join("_outputs", "apps_det_r50.npz"), depth=50, seed=1)
    runs = {"detect_video": apps_detect_video(device, ckpt)}
    runs["detect_singleframe"] = apps_detect_singleframe(device, ckpt)
    runs["detect_2d"] = apps_detect_2d(device)
    torch.cuda.empty_cache()
    apps_benchmark_speed(device)
    apps_forward_share(device)
    prefix, demos = apps_demos(device)
    runs.update(demos)
    apps_overlay(device, prefix)
    log(f"apps: phase took {time.time() - t_phase:.1f} s")
    return runs


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    args, kernels_only, loop_calls = sys.argv[1:], False, None
    while args:
        if args[0] == "--kernels-only":
            kernels_only, args = True, args[1:]
        elif args[0] == "--loop-calls" and len(args) > 1:
            loop_calls, args = os.path.abspath(args[1]), args[2:]
        else:
            fail(f"unknown arguments {args} (the options are --kernels-only and --loop-calls PATH)")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA card")
    try:
        import playground3d_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e})")
    device = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.time()
    phase_build()
    entries = phase_kernels(device)
    if kernels_only:
        log(f"total: {time.time() - t0:.1f} s (kernels only: no result line)")
        return
    launches, refs = phase_main(device, loop_calls)
    phase_variants(device, refs)
    phase_mesh(device, refs)
    del refs
    phase_spatial(device)
    phase_single(device)
    phase_session(device)
    launches.update(phase_train(device))
    phase_apps(device)
    for entry in entries:
        entry["launches"] = launches[entry["name"]]
        if entry["launches"] < 1:
            fail(f"{entry['name']} was launched no time on the path that should run it")
    log(f"total: {time.time() - t0:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: entry[k] for k in keys} for entry in entries]}))
    print(device_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
