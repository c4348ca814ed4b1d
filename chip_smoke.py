#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``playground3d_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build   - compile every hand-written kernel from ``playground3d_tpu_torch/
             csrc`` with nvcc (all sources at once), print the build seconds;
2. kernels - run each kernel at the shapes the main path gives it and at
             odd and edge shapes, hold it against its plain PyTorch version,
             and time the kernel, an empty kernel, the plain version and one
             PyTorch library call that computes the same function (never
             used by the port);
3. main    - the multi-camera tracker's main path at full width: one 1080p
             camera, ResNet-50 conv7 detector (FPN/heads 256 wide, bf16),
             ResNet-18 crop net, 24-frame clips through
             ``MultiCameraTracker.track_clips``, live tracks seeded so every
             crop frame crops and updates real slots; per-branch times and
             host syncs; the card's clip held against the CPU's on a small
             input;
4. report  - the ``kernels`` JSON line, the card's name and power limit, and
             the final ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --kernels-only`` stops after phase 2 (for work on a
kernel; it prints no result line).

Only the port and PyTorch are imported; nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import json
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


def bench_registry(h: int = H, w: int = W):
    """One fitted pole camera: 30 ft pole at road-x 250 looking down-road
    over x in [450, 680] (the JAX package's ``register_bench_camera``)."""
    from playground3d_tpu_torch.geometry.homography import CameraRegistry

    f, cx, cy = 2000.0 * w / 1920.0, w / 2.0, h / 2.0
    cam_pos = np.array([250.0, 60.0, -30.0])
    yaw, pitch = np.deg2rad(4.0), np.deg2rad(6.0)
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])

    def project(p3):
        d = p3 - cam_pos
        cam = np.stack([d[:, 1], -d[:, 2], d[:, 0]], 1) @ Ry.T @ Rx.T
        return np.stack([f * cam[:, 0] / cam[:, 2] + cx, f * cam[:, 1] / cam[:, 2] + cy], 1)

    rng = np.random.default_rng(7)
    sp = np.stack([rng.uniform(450, 680, 24), rng.uniform(0, 120, 24)], 1)
    im = project(np.concatenate([sp, np.zeros((24, 1))], 1))
    vp_z = project(np.array([[550.0, 60.0, -1e7]]))[0]
    reg = CameraRegistry()
    reg.add_camera("p1c1", im, sp, np.array([[1e6, cy], [cx, 1e6], vp_z]))
    return reg


def build_models(device, crop_target, small: bool = False):
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
        det = retinanet_init(torch.Generator().manual_seed(0), depth=18, device=device)
        crop = retinanet_init(torch.Generator().manual_seed(1), depth=18, tower_depth=2,
                              shared_tower=True, device=device)
    else:
        det = retinanet_init(torch.Generator().manual_seed(0), depth=50, stem="conv7",
                             feature_size=256, tower_depth=4, shared_tower=False, device=device)
        crop = retinanet_init(torch.Generator().manual_seed(1), depth=18, stem="conv7",
                              tower_depth=2, shared_tower=True, device=device)
    wh = base_anchors(32.0)[:, 2:] * 2.0  # [9, (w, h)] of the stride-8 anchors
    offset = (np.asarray(crop_target, np.float64)[None, :] - 4.0) / wh
    with torch.no_grad():
        for m in (det, crop):
            m.heads.cls_out.b += 3.0
        b = crop.heads.reg_out.b.view(9, 12)
        b[:, 0:2] = torch.as_tensor(offset, dtype=torch.float32, device=b.device)
    return det, crop


def seed_crop_boxes(reg, cfg, n_seed: int):
    """The seeded tracks' crop boxes [n,4] and image corners [n,8,2], built
    as the crop branch builds them (``multi_cam.py::make_crop_step``)."""
    import torch

    from playground3d_tpu_torch.geometry import transforms as T
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry, state_to_im_banked
    from playground3d_tpu_torch.pipeline.tracker_state import init_track_state

    st = seed_tracks(init_track_state(cfg.max_tracks, "cpu"), n_seed)
    s6 = torch.cat([st.kf.x[:n_seed, :5], st.kf.d[:n_seed, None]], 1)
    im = state_to_im_banked(bank_from_registry(reg, "cpu"), s6, torch.zeros(n_seed, dtype=torch.long))
    hull = T.im_hull_xyxy(im)
    scale = torch.maximum(hull[:, 2] - hull[:, 0], hull[:, 3] - hull[:, 1]) * cfg.crop_expand
    corner = (hull[:, :2] + hull[:, 2:]) / 2 - scale[:, None] / 2
    return torch.cat([corner, corner + scale[:, None]], 1), im


def crop_target(reg, cfg, n_seed: int):
    """Mean crop pixel (x, y) of the seeded tracks' bottom centres, for
    crops built as the crop branch builds them."""
    boxes, im = seed_crop_boxes(reg, cfg, n_seed)
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


def make_tracker(reg, det, crop, cfg, device, n_seed):
    from playground3d_tpu_torch.pipeline.multi_cam import MultiCameraTracker

    trk = MultiCameraTracker(reg, ["p1c1"], cfg=cfg, det_model=det, crop_model=crop,
                             centers=np.array([[565.0, 60.0]], np.float32), device=device)
    trk.state = seed_tracks(trk.state, n_seed)
    return trk


def sources(frames: np.ndarray, t0: float = 1.6e9):
    """One camera's (frame, time) stream from [T,H,W,3]."""
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


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


KERNEL_MODULES = ("playground3d_tpu_torch.ops.crop_resize",)


def phase_build():
    import importlib

    mods = [importlib.import_module(m) for m in KERNEL_MODULES]
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as ex:
        paths = list(ex.map(lambda m: m.build(), mods))
    log(f"build: {len(mods)} kernel source(s) in {time.time() - t0:.2f} s")
    for m, p in zip(mods, paths):
        log(f"build: {p.name}")
        for line in m.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build:   {line.strip()}")


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


def phase_kernels(device):
    import torch

    from playground3d_tpu_torch.ops import crop_resize
    from playground3d_tpu_torch.ops.roi_align import crop_and_resize, crop_and_resize_plain

    gen = torch.Generator().manual_seed(3)
    S, n = 112, 32
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
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
    noop_ms = gpu_ms(crop_resize.launch_noop)
    log(f"kernels: an empty kernel takes {noop_ms * 1e3:.2f} us between CUDA events "
        f"(that much of every time below is the launch)")
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


def phase_small_reference(device):
    """The clip on the card (CUDA kernel) against the same clip on the CPU
    (plain versions) at 64x96 with ResNet-18 nets: ids and masks equal,
    states within 1e-3 ft."""
    import torch

    from playground3d_tpu_torch.pipeline.multi_cam import make_mc_clip_step
    from playground3d_tpu_torch.pipeline.tracker_state import init_track_state
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry
    from playground3d_tpu_torch.track.kf import default_params

    reg = bench_registry(64, 96)
    cfg = tracker_config(small=True)
    frames = np.random.default_rng(11).integers(0, 256, (12, 1, 64, 96, 3), dtype=np.uint8)
    times = (np.arange(12, dtype=np.float32)[:, None] / 30.0)
    out = {}
    for dev in ("cpu", device):
        det, crop = build_models(dev, crop_target(reg, cfg, 6), small=True)
        clip = make_mc_clip_step(det, bank_from_registry(reg, dev),
                                 torch.tensor([[565.0, 60.0]], device=dev), default_params(device=dev),
                                 cfg, crop_model=crop)
        st0 = seed_tracks(init_track_state(cfg.max_tracks, dev), 6)
        st, _, snaps = clip(st0, torch.zeros(1, device=dev), torch.as_tensor(frames, device=dev),
                            torch.as_tensor(times, device=dev), 0)
        out[str(dev)] = {k: getattr(snaps, k).cpu() for k in ("ids", "raw_mask", "classes", "states7")}
    cpu, gpu = out["cpu"], out[str(device)]
    for k in ("ids", "raw_mask", "classes"):
        if not torch.equal(cpu[k], gpu[k]):
            fail(f"small clip: {k} differs between the card and the CPU")
    live = cpu["raw_mask"]
    diff = float((cpu["states7"] - gpu["states7"])[live].abs().max()) if live.any() else 0.0
    log(f"main: small clip (12 frames, 64x96) card vs CPU: ids/raw_mask/classes equal, "
        f"{int(live.sum())} live slot-frames, states7 max_abs_diff {diff:.3g} (tolerance 1e-3)")
    if not diff <= 1e-3:
        fail(f"small clip states7 differ by {diff}")
    if int(live.sum()) == 0:
        fail("small clip: no live tracks")


def branch_times(trk, frames_dev, device):
    """Time and host syncs of one detect, one crop and one passthrough frame
    on the tracker's final state, each run alone: CUDA events around the
    branch, so the time includes the card waiting on the host."""
    import torch

    from playground3d_tpu_torch.ops.topk import HostSyncs
    from playground3d_tpu_torch.pipeline.tracker_state import snapshot

    t = torch.zeros(1, device=device)
    bias = torch.zeros(1, device=device)
    runs = {
        "detect": lambda: trk._detect_step(trk.state, frames_dev, t, bias),
        "crop": lambda: trk._crop_step(trk.state, frames_dev, t, bias),
        "passthrough": lambda: snapshot(trk.state, t[0], trk.kfp, trk.cfg),
    }
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        times = []
        syncs0 = HostSyncs.count
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        out[name] = (float(np.median(times)), (HostSyncs.count - syncs0) / 5)
    return out


def profile_branches(trk, frames_dev, device, top: int = 6):
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
            log(f"profile: {name}: the profiler saw no device time (not measured)")
            continue
        log(f"profile: {name}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
            f"({busy / wall_us * 100:.0f}%), {sum(e.count for e in kern)} kernel launches")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
            log(f"profile: {name}:   {e.self_device_time_total / 1e3:7.3f} ms  x{e.count:<4d} {e.key[:90]}")


def phase_main(device):
    import torch

    from playground3d_tpu_torch.ops import crop_resize
    from playground3d_tpu_torch.ops.topk import HostSyncs

    phase_small_reference(device)

    reg = bench_registry()
    cfg = tracker_config()
    det, crop = build_models(device, crop_target(reg, cfg, N_SEED))
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (2 * T_CLIP, H, W, 3), dtype=np.uint8)

    # warm-up: cuDNN algorithm choice and the kernel library load
    warm = make_tracker(reg, det, crop, cfg, device, N_SEED)
    warm.track_clips(sources(frames[:T_CLIP]), clip_len=T_CLIP)
    torch.cuda.synchronize()

    trk = make_tracker(reg, det, crop, cfg, device, N_SEED)
    conf_cnt0 = trk.state.conf_cnt.clone()
    crop_resize.crop_and_resize_cuda.launches = 0
    syncs0 = HostSyncs.count
    torch.cuda.reset_peak_memory_stats()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.time()
    s.record()
    stats = trk.track_clips(sources(frames), clip_len=T_CLIP)
    e.record()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = crop_resize.crop_and_resize_cuda.launches
    syncs = HostSyncs.count - syncs0
    ms = s.elapsed_time(e)
    n_frames = stats["frames"]

    # what came out: every frame a row, finite states, detections, crops
    if n_frames != 2 * T_CLIP or len(trk.rows) != n_frames:
        fail(f"main: {n_frames} frames tracked, {len(trk.rows)} rows, expected {2 * T_CLIP}")
    for row in trk.rows:
        if not np.isfinite(row[3]).all():
            fail(f"main: non-finite states at frame {row[0]}")
    crop_frames = [k for k in range(n_frames) if k % cfg.det_step and k % cfg.skip_step == 0]
    live_at_crop = [len(trk.rows[k][2]) for k in crop_frames]
    births = int(trk.state.next_id) - N_SEED
    crop_measured = float((trk.state.conf_cnt - conf_cnt0).clamp(min=0).sum())
    if births <= 0:
        fail("main: the detector produced no births")
    if min(live_at_crop) == 0 or crop_measured <= 0:
        fail(f"main: crop frames found no live tracks ({live_at_crop}) or updated none")
    if launches < len(crop_frames):
        fail(f"main: crop_and_resize launched {launches} times for {len(crop_frames)} crop frames")
    n_detect = sum(1 for k in range(n_frames) if k % cfg.det_step == 0)
    log(f"main: {n_frames} frames ({n_detect} detect, {len(crop_frames)} crop) of 1x{H}x{W} uint8 "
        f"in {ms:.1f} ms (CUDA events) = {n_frames / ms * 1e3:.2f} frames/s; host wall "
        f"{wall:.2f} s; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"main: births {births}, live tracks at crop frames {live_at_crop}, "
        f"crop measurements {crop_measured:.0f}, crop_and_resize launches {launches}, "
        f"host syncs {syncs} ({syncs / n_detect:.1f} per detect frame incl. the crop frames' "
        f"lifecycle NMS; per-branch below)")

    frames_dev = torch.as_tensor(frames[:1]).to(device)  # [C=1,H,W,3]
    for name, (bms, bsyncs) in branch_times(trk, frames_dev, device).items():
        log(f"main: branch {name}: {bms:.2f} ms median of 5 (CUDA events), {bsyncs:.0f} host syncs")
    profile_branches(trk, frames_dev, device)
    return launches


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import torch

    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        fail(f"unknown arguments {sys.argv[1:]} (the only option is --kernels-only)")
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
    entry = phase_kernels(device)
    if kernels_only:
        log(f"total: {time.time() - t0:.1f} s (kernels only: no result line)")
        return
    entry["launches"] = phase_main(device)
    log(f"total: {time.time() - t0:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    print(device_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
