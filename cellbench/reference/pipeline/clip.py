# A frozen copy of the branches of the port's pipeline/multi_cam.py and of its
# default clip's eager loop, the benchmark's plain reference: plain PyTorch
# only, no kernel launch and no import of the port.
"""The multi-camera clip as plain eager steps: the detect branch (each
camera's top-k candidates, merged, parsed, NMS in roadway space, the
association, the lifecycle), the crop branch (crop, crop net, Kalman update)
and the passthrough snapshot, picked per frame from the global frame index
as the port's default clip picks them (:func:`reference_clip`)."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as Fn

from cellbench.reference.geometry import transforms as T
from cellbench.reference.models.retinanet import (
    Detections,
    RetinaNet,
    frame_anchors,
    image_candidates,
    imagenet_mean_std,
    localize,
    merge_candidates,
)
from cellbench.reference.ops.crop_mxu import crop_and_resize_s2d, max_crop_span_s2d
from cellbench.reference.ops.iou import elementwise_iou, pairwise_iou
from cellbench.reference.ops.roi_align import crop_and_resize
from cellbench.reference.ops.topk import top_k
from cellbench.reference.pipeline.camera_bank import CameraBank, im_to_state_refined, state_to_im_banked
from cellbench.reference.pipeline.tracker_state import (
    ParsedDetections,
    Snapshot,
    TrackState,
    associate_and_update,
    lifecycle,
    parse_detections_pre,
    snapshot,
    space_nms_parsed,
    stack_snapshots,
)
from cellbench.reference.track.kf import KFParams, kf_predict, kf_update, kf_view
from cellbench.reference.utils.config import TrackerConfig
from cellbench.reference.utils.constants import CLASS_HEIGHTS, NUM_CLASSES


# ---------------------------------------------------------------------------
# online clock-bias estimation (MC3D_crop_tracker.py:237-316)
# ---------------------------------------------------------------------------


def estimate_ts_bias(
    parsed: ParsedDetections,
    state: TrackState,
    ts_bias: torch.Tensor,  # [C]
    kfp: KFParams,
    cfg: TrackerConfig,
) -> torch.Tensor:
    """EMA update of per-camera clock bias from cross-camera detection pairs
    whose roadway footprints overlap: the x-offset over the direction's mean
    tracked speed is an observed dt, compared with the camera-clock dt.
    Camera 0 is the reference; each camera takes the mean of its pairs."""
    C = ts_bias.shape[0]
    dev = ts_bias.device
    live = state.kf.mask
    v = state.kf.x[:, 5]
    d = state.kf.d
    eb = live & (d > 0)
    wb = live & (d < 0)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def mean_speed(sel):
        mean = torch.sum(torch.where(sel, v, zero)) / torch.clamp(torch.sum(sel), min=1)
        return torch.where(torch.any(sel), mean, kfp.mu_v)

    eb_speed, wb_speed = mean_speed(eb), mean_speed(wb)

    fp = T.space_footprint_xyxy(T.state_to_space(parsed.state))
    iou = pairwise_iou(fp, fp)
    cam = parsed.cam_idx.long()
    valid_pair = (
        parsed.mask[:, None] & parsed.mask[None, :]
        & (cam[:, None] != cam[None, :]) & (iou > cfg.phi_nms_space)
    )
    dx = parsed.state[None, :, 0] - parsed.state[:, None, 0]  # x_j - x_i
    x_vel = torch.where(parsed.state[:, 5] > 0, eb_speed, -wb_speed)
    x_vel = torch.where(
        torch.abs(x_vel) > 1.0, x_vel, torch.sign(x_vel) * 1.0 + (x_vel == 0).to(torch.float32)
    )
    dt_obs = dx / x_vel[:, None]
    raw_times = parsed.times - ts_bias[cam]
    dt_expected = raw_times[None, :] - raw_times[:, None]
    time_error = dt_obs - dt_expected
    target = -time_error + ts_bias[cam][None, :]
    w = valid_pair.to(torch.float32)
    num = torch.zeros((C,), dtype=torch.float32, device=dev).index_add(0, cam, torch.sum(w * target, dim=1))
    den = torch.zeros((C,), dtype=torch.float32, device=dev).index_add(0, cam, torch.sum(w, dim=1))
    mean_target = num / torch.clamp(den, min=1.0)
    has_update = (den > 0) & (torch.arange(C, device=dev) != 0)
    return torch.where(
        has_update, (1 - cfg.ts_alpha) * ts_bias + cfg.ts_alpha * mean_target, ts_bias
    )


# ---------------------------------------------------------------------------
# crop re-detection branch (MC3D_crop_tracker.py:1146-1254)
# ---------------------------------------------------------------------------


def select_crop_slots(
    live: torch.Tensor, fsld: torch.Tensor, age: torch.Tensor, K: int
) -> torch.Tensor:
    """Stale-first crop schedule: the K live slots longest without a
    detection (fsld), oldest first on ties, lower slot first after that."""
    pri = torch.where(
        live,
        fsld.to(torch.float32) * 1024.0 + torch.clamp(age, max=1023).to(torch.float32),
        torch.full_like(fsld, -1, dtype=torch.float32),
    )
    return top_k(pri, K)[1]


def _normalize_crops(crops: torch.Tensor) -> torch.Tensor:
    mean, std = imagenet_mean_std(1, crops.device)
    return (crops / 255.0 - mean) / std


def square_crop_boxes(bank: CameraBank, state6: torch.Tensor, cam: torch.Tensor, cfg: TrackerConfig,
                      frame_stem: str):
    """(boxes [K, (x0, y0, x1, y1)], side [K]): the square crop box, in
    pixels of camera ``cam``, of each roadway state [K, 6], expanded by
    ``cfg.crop_expand`` (MC3D get_crop_boxes:920-945)."""
    hull = T.im_hull_xyxy(state_to_im_banked(bank, state6, cam))
    w = hull[:, 2] - hull[:, 0]
    h = hull[:, 3] - hull[:, 1]
    scale = torch.maximum(w, h) * cfg.crop_expand
    if frame_stem == "s2d":
        # the s2d crop cannot represent a box beyond its coarsest window
        # (992 px at the defaults): clamp before the box is built, so the
        # crop-to-frame mapping matches the pixels really cropped
        scale = torch.clamp(scale, max=max_crop_span_s2d())
    cx = (hull[:, 0] + hull[:, 2]) / 2
    cy = (hull[:, 1] + hull[:, 3]) / 2
    return torch.stack([cx - scale / 2, cy - scale / 2, cx + scale / 2, cy + scale / 2], dim=1), scale


def make_crop_step(
    crop_model: RetinaNet,
    bank: CameraBank,
    centers: torch.Tensor,  # [C,2] camera view centres in roadway coords
    kfp: KFParams,
    cfg: TrackerConfig,
    stem: str = "conv7",
    frame_stem: str = "conv7",
    observe=None,
):
    """(state, frames, cam_times [C], ts_bias [C]) -> (state', snapshot).
    ``frames`` is [C,H,W,3] when ``frame_stem == "conv7"`` or s2d-packed
    [C,H/4,W/4,48] (uint8 or float) when ``frame_stem == "s2d"``; ``stem`` is
    the crop net's own stem and decides the layout the crops are made in.
    For each of the ``cfg.crop_slots`` stalest live slots (all slots when
    0): nearest camera, roll to its clock, project, crop, re-detect, pick
    the best candidate by (1-W)*IoU + W*conf, Kalman-update. ``observe``,
    when given, is called as ``observe("crop_boxes", boxes [K,4], camera
    [K], live [K])`` before the crops are made."""
    for name, value in (("stem", stem), ("frame_stem", frame_stem)):
        if value not in ("conv7", "s2d"):
            raise ValueError(f"make_crop_step: {name} must be 'conv7' or 's2d', got {value!r}")
    if crop_model.stem != stem:
        raise ValueError(f"make_crop_step: stem={stem!r} but the crop net was built with {crop_model.stem!r}")
    cs = cfg.cs
    class_heights = torch.as_tensor(CLASS_HEIGHTS, device=centers.device)

    @torch.no_grad()
    def step(state: TrackState, frames: torch.Tensor, cam_times: torch.Tensor, ts_bias: torch.Tensor):
        N = state.ids.shape[0]
        dev = state.ids.device
        live = state.kf.mask
        K = cfg.crop_slots if (cfg.crop_slots and cfg.crop_slots < N) else N
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        t_mean = torch.mean(cam_times)

        pre = kf_view(state.kf, torch.where(live, t_mean - state.t_off, zero), kfp)
        if K < N:
            sel = select_crop_slots(live, state.fsld, state.age, K)
        else:
            sel = torch.arange(N, device=dev)
        live_k = live[sel]

        # nearest camera per selected object (MC3D:1156-1164)
        pre_k = pre[sel]
        d2 = (pre_k[:, 0:1] - centers[None, :, 0]) ** 2 + (pre_k[:, 1:2] - centers[None, :, 1]) ** 2
        cam_k = torch.argmin(d2, dim=1)

        # roll each selected object to its camera's bias-corrected clock;
        # unselected slots keep dt = 0 (identity predict)
        obj_t = cam_times[cam_k] + ts_bias[cam_k]
        dt_k = torch.where(live_k, obj_t - state.t_off[sel], zero)
        dt = torch.zeros((N,), dtype=torch.float32, device=dev).index_put((sel,), dt_k)
        kf1 = kf_predict(state.kf, dt, kfp)
        t_off = state.t_off.index_put((sel,), torch.where(live_k, obj_t, state.t_off[sel]))

        state6_k = torch.cat([kf1.x[sel, :5], kf1.d[sel, None]], dim=1)
        crop_boxes, scale = square_crop_boxes(bank, state6_k, cam_k, cfg, frame_stem)

        if observe is not None:
            observe("crop_boxes", crop_boxes, cam_k, live_k)
        if frame_stem == "s2d":
            crops = crop_and_resize_s2d(
                frames, crop_boxes, cam_k.to(torch.int32), out_size=cs,
                layout="s2d" if stem == "s2d" else "hwc",
                normalize=frames.dtype == torch.uint8,
            )
        else:
            # uint8 frames are cropped in place (the kernel converts in
            # registers) and normalized here, as the JAX branch normalizes
            crops = crop_and_resize(frames, crop_boxes, cam_k.to(torch.int32), out_size=cs)
            if frames.dtype == torch.uint8:
                crops = _normalize_crops(crops)

        reg_boxes, cls = localize(crop_model, crops)
        confs = torch.amax(cls, dim=2)
        classes = torch.argmax(cls, dim=2)

        top_conf, top_idx = top_k(confs, cfg.cd_max)  # [K,cd]
        rows = torch.arange(K, device=dev)[:, None]
        cand = reg_boxes[rows, top_idx]  # [K,cd,20]
        cand_cls = classes[rows, top_idx]

        # local crop coords -> global frame coords (MC3D local_to_global:948-971)
        corners = cand[:, :, :16].reshape(K, cfg.cd_max, 8, 2)
        corners = corners * (scale / cs)[:, None, None, None]
        corners = corners + crop_boxes[:, None, None, 0:2]

        flat = corners.reshape(K * cfg.cd_max, 8, 2)
        flat_cam = cam_k[:, None].expand(K, cfg.cd_max).reshape(-1)  # repeat_interleave, no host read
        heights = class_heights[cand_cls.reshape(-1)]
        cand_state = im_to_state_refined(bank, flat, flat_cam, heights).reshape(K, cfg.cd_max, 6)

        # best box per object: (1-W)*IoU(footprint, a-priori) + W*conf
        apri_fp = T.space_footprint_xyxy(T.state_to_space(state6_k))
        cand_fp = T.space_footprint_xyxy(
            T.state_to_space(cand_state.reshape(K * cfg.cd_max, 6))
        ).reshape(K, cfg.cd_max, 4)
        ious = elementwise_iou(cand_fp, apri_fp[:, None, :])
        score = (1 - cfg.w_conf) * ious + cfg.w_conf * top_conf
        best = torch.argmax(score, dim=1)
        rows_k = torch.arange(K, device=dev)
        best_state = cand_state[rows_k, best]
        best_conf = top_conf[rows_k, best]
        best_cls = cand_cls[rows_k, best]

        # crop measurement update (model 2), scattered back to the pool
        meas = torch.zeros((N, 5), dtype=torch.float32, device=dev).index_put(
            (sel,), best_state[:, :5].to(torch.float32)
        )
        no = torch.zeros((N,), dtype=torch.bool, device=dev)
        upd = no.index_put((sel,), live_k)
        good = no.index_put((sel,), live_k & (best_conf >= cfg.sigma_c))
        kf_upd = (upd & good) if cfg.crop_conf_gate else upd
        kf2 = kf_update(kf1, meas, kf_upd, kfp, measurement_idx=2)

        if cfg.size_nudge:
            # class-size nudge (model 3) toward the voted class's mean size
            voted = torch.argmax(state.cls_votes, dim=1)
            kf2 = kf_update(kf2, kfp.class_size[voted], kf_upd, kfp, measurement_idx=3)

        izero = torch.zeros_like(state.fsld)
        fsld = torch.where(good, izero, state.fsld + (live & ~good).to(torch.int32))
        misses = torch.where(good, izero, state.misses + (upd & ~good).to(torch.int32))
        good_k = live_k & (best_conf >= cfg.sigma_c)
        one_hot = Fn.one_hot(best_cls, NUM_CLASSES).to(torch.float32)
        votes = state.cls_votes.index_put(
            (sel,), torch.where(good_k[:, None], one_hot, zero), accumulate=True
        )
        conf_sum = state.conf_sum.index_put(
            (sel,), torch.where(live_k, best_conf, zero), accumulate=True
        )
        conf_cnt = state.conf_cnt.index_put((sel,), live_k.to(torch.float32), accumulate=True)

        new_state = state._replace(
            kf=kf2, fsld=fsld, misses=misses, age=state.age + live.to(torch.int32),
            cls_votes=votes, conf_sum=conf_sum, conf_cnt=conf_cnt, t_off=t_off,
        )
        new_state = lifecycle(new_state, t_mean, kfp, cfg)
        return new_state, snapshot(new_state, t_mean, kfp, cfg)

    return step


def _detect_tail(state, pre, ts_bias, cam_times, kfp, cfg):
    """Shared tail of the detect branch: clock bias, roadway NMS,
    association, lifecycle, snapshot."""
    ts_bias2 = estimate_ts_bias(pre, state, ts_bias, kfp, cfg) if cfg.estimate_ts_bias else ts_bias
    parsed = space_nms_parsed(pre, cfg)
    t_ref = torch.mean(cam_times)
    state, _, _ = associate_and_update(state, parsed, t_ref, kfp, cfg)
    state = lifecycle(state, t_ref, kfp, cfg)
    return state, snapshot(state, t_ref, kfp, cfg), ts_bias2


def make_mc_detect_step_from_detections(bank: CameraBank, kfp: KFParams, cfg: TrackerConfig):
    """Detect-branch step taking precomputed :class:`Detections`."""

    @torch.no_grad()
    def step(state: TrackState, det: Detections, cam_times: torch.Tensor, ts_bias: torch.Tensor):
        pre = parse_detections_pre(det, bank, cam_times + ts_bias, cfg)
        return _detect_tail(state, pre, ts_bias, cam_times, kfp, cfg)

    return step


def reference_clip(det_model: RetinaNet, crop_model, bank: CameraBank, centers: torch.Tensor, kfp: KFParams,
                   cfg: TrackerConfig, stem: str, crop_stem: str, observe=None):
    """(state, ts_bias, frames [T,C,...], cam_times [T,C], frame0) ->
    (state', ts_bias', snapshots stacked over T), eagerly, frame by frame:
    frame ``frame0 + i`` takes the detect branch when its index is a
    multiple of ``det_step``, else the crop branch when it is one of
    ``skip_step``, else the passthrough snapshot. ``observe``, when given,
    is called as ``observe("branch", name)`` before each frame, and by the
    crop branch as :func:`make_crop_step` says."""
    parsed_step = make_mc_detect_step_from_detections(bank, kfp, cfg)
    crop_step = make_crop_step(crop_model, bank, centers, kfp, cfg, stem=crop_stem, frame_stem=stem, observe=observe)
    seen = observe or (lambda *args: None)

    @torch.no_grad()
    def clip(state: TrackState, ts_bias: torch.Tensor, frames: torch.Tensor, cam_times: torch.Tensor, frame0: int):
        anchors = frame_anchors(frames[0], stem, cfg.det_min_level)
        n_cams = frames.shape[1]
        snaps: List[Snapshot] = []
        for li in range(frames.shape[0]):
            i, t = frame0 + li, cam_times[li]
            name = "detect" if i % cfg.det_step == 0 else "crop" if i % cfg.skip_step == 0 else "passthrough"
            seen("branch", name)
            if name == "detect":
                cands = image_candidates(det_model, frames[li], first_image=0, pre_topk=cfg.pre_topk,
                                         min_level=cfg.det_min_level)
                det = merge_candidates(cands, anchors, n_cams, 1, pre_topk=cfg.pre_topk, max_dets=cfg.max_dets)
                state, snap, ts_bias = parsed_step(state, det, t, ts_bias)
            elif name == "crop":
                state, snap = crop_step(state, frames[li], t, ts_bias)
            else:
                snap = snapshot(state, torch.mean(t), kfp, cfg)
            snaps.append(snap)
        return state, ts_bias, stack_snapshots(snaps)

    return clip
