# A frozen copy of the port's pipeline/tracker_state.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Device-resident tracker state and the per-frame update functions (port
of ``playground3d_tpu/pipeline/tracker_state.py``).

The whole tracker lives on the device as fixed-capacity tensors: Kalman
slots, ids, frames-since-last-detection, class votes, per-slot times. Times
are float32 offsets from a host-held epoch. Functions return new tuples and
never write into their inputs, as in the JAX package.

  * :func:`parse_detections` (= :func:`parse_detections_pre` then
    :func:`space_nms_parsed`) - confidence cutoff, per-camera image NMS,
    im->state, cross-camera roadway NMS (MC3D_crop_tracker.py:319-383)
  * :func:`associate_and_update` - match, roll, update, births
    (MC3D_crop_tracker.py:1099-1137, 385-461)
  * :func:`lifecycle` - deaths, anomalies, overlap pruning (MC3D:463-556)
  * :func:`snapshot` - roll all tracks to one clock time (MC3D:1266-1282)
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from cellbench.reference import DeviceLike, resolve_device
from cellbench.reference.geometry import transforms as T
from cellbench.reference.models.retinanet import Detections
from cellbench.reference.ops.assignment import assign_auction
from cellbench.reference.ops.iou import pairwise_iou
from cellbench.reference.ops.nms import batched_nms, nms
from cellbench.reference.pipeline.camera_bank import CameraBank, ignore_hits, im_to_state_refined
from cellbench.reference.track.kf import (
    KFParams,
    KFSlots,
    init_slots,
    kf_add,
    kf_predict,
    kf_update,
    kf_view,
)
from cellbench.reference.utils.config import TrackerConfig
from cellbench.reference.utils.constants import CLASS_HEIGHTS, NUM_CLASSES


class TrackState(NamedTuple):
    kf: KFSlots
    ids: torch.Tensor  # [N] int32, -1 = free
    fsld: torch.Tensor  # [N] int32 frames since last detected
    misses: torch.Tensor  # [N] int32 failed update attempts (death counter)
    age: torch.Tensor  # [N] int32 frames alive
    cls_votes: torch.Tensor  # [N, NUM_CLASSES] float32
    conf_sum: torch.Tensor  # [N] float32
    conf_cnt: torch.Tensor  # [N] float32
    t_off: torch.Tensor  # [N] float32 last KF roll time (epoch offset, s)
    next_id: torch.Tensor  # [] int32


class ParsedDetections(NamedTuple):
    state: torch.Tensor  # [K,6] x,y,l,w,h,dir
    scores: torch.Tensor  # [K]
    classes: torch.Tensor  # [K] int32
    cam_idx: torch.Tensor  # [K] int32
    times: torch.Tensor  # [K] float32 epoch offsets
    mask: torch.Tensor  # [K] bool


class Snapshot(NamedTuple):
    states7: torch.Tensor  # [N,7] x,y,l,w,h,dir,v at snapshot time
    ids: torch.Tensor  # [N]
    classes: torch.Tensor  # [N] dominant class votes
    mask: torch.Tensor  # [N] valid AND past burn-in (age > f_init)
    raw_mask: torch.Tensor  # [N] valid
    t: torch.Tensor  # [] snapshot time offset


def init_track_state(capacity: int, device: DeviceLike = None) -> TrackState:
    dev = resolve_device(device)

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return TrackState(
        kf=init_slots(capacity, dev),
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        fsld=z(capacity),
        misses=z(capacity),
        age=z(capacity),
        cls_votes=z(capacity, NUM_CLASSES, dtype=torch.float32),
        conf_sum=z(capacity, dtype=torch.float32),
        conf_cnt=z(capacity, dtype=torch.float32),
        t_off=z(capacity, dtype=torch.float32),
        next_id=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _footprints(state6: torch.Tensor) -> torch.Tensor:
    return T.space_footprint_xyxy(T.state_to_space(state6))


def _one_hot(cls: torch.Tensor) -> torch.Tensor:
    return Fn.one_hot(cls.long(), NUM_CLASSES).to(torch.float32)


@functools.lru_cache(maxsize=None)
def _class_height_table(device: torch.device) -> torch.Tensor:
    # made once a device: a CUDA graph cannot capture a copy from the host
    return torch.as_tensor(CLASS_HEIGHTS, device=device)


def _class_heights(classes: torch.Tensor) -> torch.Tensor:
    return _class_height_table(classes.device)[classes.long()]


def _scatter_any(size: int, index: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """``zeros(size, bool).at[index].max(flag)``: True where any of the
    (possibly duplicate) indices carries a True flag."""
    out = torch.zeros(size, dtype=torch.int32, device=flag.device)
    return out.scatter_reduce(0, index.long(), flag.to(torch.int32), "amax", include_self=True) > 0


# ---------------------------------------------------------------------------
# detection parsing
# ---------------------------------------------------------------------------


def parse_detections_pre(
    det: Detections, bank: CameraBank, cam_times: torch.Tensor, cfg: TrackerConfig
) -> ParsedDetections:
    """Confidence cutoff, per-camera image NMS, im->state with EB/WB
    dispatch and height refinement (MC3D_crop_tracker.py:334-370); still
    holds cross-camera duplicates (what the clock-bias estimator needs)."""
    K = det.scores.shape[0]
    keep = det.mask & (det.scores > cfg.sigma_d)

    corners = det.boxes[:, :16].reshape(K, 8, 2)
    hulls = T.im_hull_xyxy(corners)
    if bank.ignore is not None:
        centers = torch.stack(
            [(hulls[:, 0] + hulls[:, 2]) / 2, (hulls[:, 1] + hulls[:, 3]) / 2], dim=1
        )
        keep = keep & ~ignore_hits(bank, centers, det.cam_idx)

    idx1, mask1 = batched_nms(hulls, det.scores, det.cam_idx, keep, cfg.phi_nms_im, max_keep=K)
    idx1 = idx1.long()
    corners = corners[idx1]
    scores = det.scores[idx1]
    classes = det.classes[idx1]
    cam_idx = det.cam_idx[idx1]
    state = im_to_state_refined(bank, corners, cam_idx, _class_heights(classes))
    return ParsedDetections(
        state=state, scores=scores, classes=classes, cam_idx=cam_idx,
        times=cam_times[cam_idx.long()], mask=mask1,
    )


def space_nms_parsed(parsed: ParsedDetections, cfg: TrackerConfig) -> ParsedDetections:
    """Cross-camera roadway-plane NMS (MC3D_crop_tracker.py:376-381)."""
    K = parsed.mask.shape[0]
    idx2, mask2 = nms(
        _footprints(parsed.state), parsed.scores, parsed.mask, cfg.phi_nms_space, max_keep=K
    )
    idx2 = idx2.long()
    return ParsedDetections(
        state=parsed.state[idx2], scores=parsed.scores[idx2], classes=parsed.classes[idx2],
        cam_idx=parsed.cam_idx[idx2], times=parsed.times[idx2], mask=mask2,
    )


# ---------------------------------------------------------------------------
# association + measurement update + births
# ---------------------------------------------------------------------------


def associate_and_update(
    state: TrackState,
    parsed: ParsedDetections,
    t_ref: torch.Tensor,
    kfp: KFParams,
    cfg: TrackerConfig,
) -> Tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Match detections to tracks on roadway IoU, roll matched tracks to
    their detection times, update, start new tracks in free slots.
    Returns (new_state, col_of_row [N], matched_col_mask [K])."""
    N = state.ids.shape[0]
    K = parsed.mask.shape[0]
    dev = state.ids.device
    ar_n = torch.arange(N, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    dt_view = torch.where(state.kf.mask, t_ref - state.t_off, zero)
    pre_x = kf_view(state.kf, dt_view, kfp)
    pre6 = torch.cat([pre_x[:, :5], state.kf.d[:, None]], dim=1)
    iou = pairwise_iou(_footprints(pre6), _footprints(parsed.state))  # [N,K]
    iou = torch.where(state.kf.mask[:, None] & parsed.mask[None, :], iou, zero)

    # pre-gate hopeless rows/cols (an intentional approximation; see the
    # JAX module for why it is kept)
    row_hope = torch.amax(iou, dim=1) >= cfg.phi_match
    col_hope = torch.amax(iou, dim=0) >= cfg.phi_match
    col_of_row = assign_auction(iou, state.kf.mask & row_hope, parsed.mask & col_hope).long()
    col_safe = torch.clamp(col_of_row, 0, K - 1)
    match_iou = iou[ar_n, col_safe]
    matched_row = (col_of_row >= 0) & (match_iou >= cfg.phi_match)
    col_of_row = torch.where(matched_row, col_of_row, torch.full_like(col_of_row, -1))
    col_safe = torch.clamp(col_of_row, 0, K - 1)

    det_time_row = parsed.times[col_safe]
    dt_pred = torch.where(matched_row, det_time_row - state.t_off, zero)
    kf1 = kf_predict(state.kf, dt_pred, kfp)
    z = parsed.state[col_safe][:, :5]
    kf2 = kf_update(kf1, z, matched_row, kfp, measurement_idx=1)

    t_off = torch.where(matched_row, det_time_row, state.t_off)
    fsld_grow = state.kf.mask
    if cfg.ghost_frames > 0:
        fsld_grow = fsld_grow | ((~state.kf.mask) & (state.ids >= 0))
    izero = torch.zeros_like(state.fsld)
    fsld = torch.where(matched_row, izero, state.fsld + fsld_grow.to(torch.int32))
    misses = torch.where(matched_row, izero, state.misses + state.kf.mask.to(torch.int32))
    votes = state.cls_votes + matched_row[:, None] * _one_hot(parsed.classes[col_safe])
    conf_sum = state.conf_sum + torch.where(matched_row, parsed.scores[col_safe], zero)
    conf_cnt = state.conf_cnt + matched_row.to(torch.float32)

    # ---- births ------------------------------------------------------------
    matched_col = _scatter_any(K, col_safe, matched_row)

    if cfg.ghost_frames > 0:
        # ghost re-identification: an unmatched detection near a dead but
        # remembered track's prediction (same direction) is reborn in that
        # slot with the old id; one det per ghost, nearest wins
        ghost = (~state.kf.mask) & (state.ids >= 0)
        gdt = torch.where(ghost, t_ref - state.t_off, zero)
        gx = kf_view(state.kf._replace(mask=state.kf.mask | ghost), gdt, kfp)
        dist = torch.hypot(
            gx[:, 0:1] - parsed.state[None, :, 0], gx[:, 1:2] - parsed.state[None, :, 1]
        )
        same_dir = (state.kf.d[:, None] * parsed.state[None, :, 5]) > 0
        free_det = parsed.mask & ~matched_col
        cand = ghost[:, None] & free_det[None, :] & same_dir & (dist < cfg.ghost_r_ft)
        big = 1e9
        cost = torch.where(cand, dist, big) + ar_n[:, None] * 1e-6
        det_pick = torch.argmin(cost, dim=1)
        det_cost = torch.amin(cost, dim=1)
        ok = det_cost < big
        best_for_det = torch.full((K,), 1e9, dtype=torch.float32, device=dev).scatter_reduce(
            0, det_pick, torch.where(ok, det_cost, big), "amin", include_self=True
        )
        reb = ok & (det_cost <= best_for_det[det_pick])
        det_r = torch.clamp(det_pick, 0, K - 1)
        reb_det6 = parsed.state[det_r]
        reb_x = torch.cat([reb_det6[:, :5], state.kf.x[:, 5:6]], dim=1)
        kf2 = kf_add(kf2, reb_x, reb_det6[:, 5], reb, kfp, class_ids=parsed.classes[det_r])
        t_off = torch.where(reb, parsed.times[det_r], t_off)
        fsld = torch.where(reb, izero, fsld)
        misses = torch.where(reb, izero, misses)
        votes = votes + torch.where(reb[:, None], _one_hot(parsed.classes[det_r]), zero)
        conf_sum = conf_sum + torch.where(reb, parsed.scores[det_r], zero)
        conf_cnt = conf_cnt + reb.to(torch.float32)
        matched_col = matched_col | _scatter_any(K, det_r, reb)

    unmatched = parsed.mask & ~matched_col
    free = ~kf2.mask
    if cfg.ghost_frames > 0:
        # recycle never-used / expired slots before live ghosts
        rank = (~free).to(torch.int32) * 2 + (free & (state.ids >= 0)).to(torch.int32)
    else:
        rank = (~free).to(torch.int32)  # free slots first, ascending index
    free_order = torch.argsort(rank, stable=True)
    det_rank = torch.cumsum(unmatched.to(torch.int64), 0) - 1
    n_free = torch.sum(free)
    can_place = unmatched & (det_rank < n_free)
    slot_for_det = free_order[torch.clamp(det_rank, 0, N - 1)]  # [K]

    add_mask = _scatter_any(N, slot_for_det, can_place)
    ar_k = torch.arange(K, dtype=torch.int64, device=dev)
    det_for_slot = torch.zeros((N,), dtype=torch.int64, device=dev).scatter_reduce(
        0, slot_for_det, torch.where(can_place, ar_k, torch.zeros_like(ar_k)), "amax",
        include_self=True,
    )
    new_det = parsed.state[det_for_slot]
    new_x = torch.cat([new_det[:, :5], kfp.mu_v.expand(N, 1)], dim=1)
    new_cls = parsed.classes[det_for_slot]
    kf3 = kf_add(kf2, new_x, new_det[:, 5], add_mask, kfp, class_ids=new_cls)

    ids = torch.where(
        add_mask, state.next_id + (torch.cumsum(add_mask.to(torch.int32), 0) - 1).to(torch.int32),
        state.ids,
    )
    next_id = state.next_id + torch.sum(add_mask).to(torch.int32)
    fsld = torch.where(add_mask, izero, fsld)
    misses = torch.where(add_mask, izero, misses)
    age = torch.where(add_mask, izero, state.age)
    votes = torch.where(add_mask[:, None], _one_hot(new_cls), votes)
    conf_sum = torch.where(add_mask, parsed.scores[det_for_slot], conf_sum)
    conf_cnt = torch.where(add_mask, torch.ones_like(conf_cnt), conf_cnt)
    t_off = torch.where(add_mask, parsed.times[det_for_slot], t_off)

    keep_id = kf3.mask
    if cfg.ghost_frames > 0:
        keep_id = keep_id | (
            (~kf3.mask) & (state.ids >= 0) & (fsld < cfg.f_max + cfg.ghost_frames)
        )
    new_state = TrackState(
        kf=kf3,
        ids=torch.where(keep_id, ids, torch.full_like(ids, -1)),
        fsld=fsld,
        misses=misses,
        age=age + kf3.mask.to(torch.int32),
        cls_votes=votes,
        conf_sum=conf_sum,
        conf_cnt=conf_cnt,
        t_off=t_off,
        next_id=next_id,
    )
    return new_state, col_of_row.to(torch.int32), matched_col


# ---------------------------------------------------------------------------
# lifecycle: deaths, anomalies, overlaps
# ---------------------------------------------------------------------------


def lifecycle(
    state: TrackState, t_ref: torch.Tensor, kfp: KFParams, cfg: TrackerConfig
) -> TrackState:
    """Prune tracks: f_max failed attempts (MC3D:463-477), tentative kill,
    anomaly bounds (MC3D:520-556), overlap NMS with age as the score
    (MC3D:482-518), and the optional duplicate merge."""
    live = state.kf.mask
    die_fsld = live & (state.misses >= cfg.f_max)
    die = die_fsld
    if cfg.tentative_age > 0:
        die = die | (live & (state.age <= cfg.tentative_age) & (state.misses >= 1))

    zero = torch.zeros((), dtype=torch.float32, device=live.device)
    dt = torch.where(live, t_ref - state.t_off, zero)
    x = kf_view(state.kf, dt, kfp)
    y, l, w, h, v = x[:, 1], x[:, 2], x[:, 3], x[:, 4], x[:, 5]
    max_l, max_w, max_h = cfg.max_size
    bad = (
        (y > cfg.y_range[1]) | (y < cfg.y_range[0])
        | (l > max_l) | (l < 0) | (w > max_w) | (w < 0) | (h > max_h) | (h < 0)
        | (v > cfg.v_max) | (v < -cfg.v_max)
        | (x[:, 0] < cfg.x_range[0]) | (x[:, 0] > cfg.x_range[1])
    )
    die = die | (live & bad)

    state6 = torch.cat([x[:, :5], state.kf.d[:, None]], dim=1)
    fp = _footprints(state6)
    alive = live & ~die
    age_f = state.age.to(torch.float32)
    keep_idx, keep_mask = nms(fp, age_f, alive, cfg.phi_over, max_keep=fp.shape[0])
    kept = _scatter_any(alive.shape[0], keep_idx, keep_mask)
    die = die | (alive & ~kept)

    if cfg.merge_dist_ft > 0:
        alive = live & ~die
        half_x = cfg.merge_dist_ft / 2.0
        half_y = cfg.merge_dist_ft / 4.0
        merge_boxes = torch.stack(
            [x[:, 0] - half_x, x[:, 1] - half_y, x[:, 0] + half_x, x[:, 1] + half_y], dim=1
        )
        groups = (state.kf.d > 0).to(torch.int32)
        m_idx, m_mask = batched_nms(
            merge_boxes, age_f, groups, alive, iou_threshold=1e-6,
            max_keep=merge_boxes.shape[0],
        )
        die = die | (alive & ~_scatter_any(alive.shape[0], m_idx, m_mask))

    new_mask = live & ~die
    keep_id = new_mask
    fsld = state.fsld
    if cfg.ghost_frames > 0:
        ghost_new = die_fsld & ~(live & bad)
        ghost_old = (~live) & (state.ids >= 0) & (state.fsld < cfg.f_max + cfg.ghost_frames)
        keep_id = keep_id | ghost_new | ghost_old
        fsld = torch.where(ghost_new, torch.clamp(fsld, max=cfg.f_max), fsld)
    return state._replace(
        kf=state.kf._replace(mask=new_mask),
        ids=torch.where(keep_id, state.ids, torch.full_like(state.ids, -1)),
        fsld=fsld,
    )


def pack_snapshot(snap: Snapshot) -> torch.Tensor:
    """A snapshot (or one stacked over leading axes) as one float64 tensor
    [..., N, 11] for a single device->host read: states7, id, class, raw
    mask and the snapshot time per slot. Every field is exact in float64
    (int32 ids and classes, float32 states and time)."""
    return torch.cat([
        snap.states7.to(torch.float64),
        torch.stack([snap.ids, snap.classes, snap.raw_mask.to(torch.int32)], -1).to(torch.float64),
        snap.t.to(torch.float64)[..., None, None].expand(snap.ids.shape + (1,)),
    ], -1)


def unpack_snapshot(rows: np.ndarray):
    """:func:`pack_snapshot`'s rows [..., N, 11] -> (states7 float32, ids
    int32, classes int32, raw mask bool, t float64 [...])."""
    return (rows[..., :7].astype(np.float32), rows[..., 7].astype(np.int32), rows[..., 8].astype(np.int32),
            rows[..., 9] > 0, rows[..., 0, 10])


def stack_snapshots(snaps: List[Snapshot]) -> Snapshot:
    """Per-frame snapshots -> one snapshot of [T,...] fields (the stacked
    output of the JAX package's clip scans)."""
    return Snapshot(*(torch.stack(xs) for xs in zip(*snaps)))


def snapshot(
    state: TrackState, t_out: torch.Tensor, kfp: KFParams, cfg: TrackerConfig
) -> Snapshot:
    """Roll every live track to a common clock time for output."""
    live = state.kf.mask
    dt = torch.where(live, t_out - state.t_off, torch.zeros_like(state.t_off))
    x = kf_view(state.kf, dt, kfp)
    states7 = torch.cat([x[:, :5], state.kf.d[:, None], x[:, 5:6]], dim=1)
    return Snapshot(
        states7=states7,
        ids=state.ids,
        classes=torch.argmax(state.cls_votes, dim=1).to(torch.int32),
        mask=live & (state.age > cfg.f_init),
        raw_mask=live,
        t=t_out,
    )
