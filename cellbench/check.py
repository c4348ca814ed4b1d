"""What decides ``correct``: the program's clips held against the plain
reference (``reference/``), run on the same frames and weights.

The reference follows the program clip by clip: for each sampled clip it
starts from the state the program's clip started from, runs the same frames
eagerly through plain PyTorch (the YUV420 conversion, the detector, the
candidates and NMS, the crop and the crop net, the assignment, the Kalman
filter), and its snapshots are compared with the rows the program read
back; its end state with the state the program handed to its next clip.
The first clip of the warm-up starts from the seeded state the benchmark
made, so the start is checked too.

Numbers compared, each with a limit of the configuration's file:

* ``rows_differ``: track rows (a live slot of a frame) present on one side
  only, or present on both with another class;
* ``states7_gap``: the largest difference of a states7 value of a track
  present on both sides;
* ``handover_differ``: integer and boolean elements of the handed-over
  state (ids, masks, counters, ages, the next id) that differ;
* ``handover_gap``: the largest difference of a float element of the
  handed-over state and clock bias, relative to the reference's value or
  1, whichever is larger.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cellbench import archs, cell, counts

NUMBERS = ("rows_differ", "states7_gap", "handover_differ", "handover_gap")


class Reference:
    """The reference tracker of one configuration at one precision: each
    net built by its architecture module from the raw weights and quantized
    (int8 and int4 alike) by the reference's own code, the camera bank
    fitted by its own geometry."""

    def __init__(self, cfg: dict, traffic: dict, weights: dict, calib: dict, device, precision: str):
        from cellbench.reference.geometry import homography
        from cellbench.reference.pipeline.camera_bank import bank_from_registry
        from cellbench.reference.pipeline.clip import reference_clip
        from cellbench.reference.track.kf import default_params
        from cellbench.reference.utils.config import TrackerConfig

        self.precision, self.traffic, self.device = precision, traffic, torch.device(device)
        self.stem = archs.layout(cfg["detector"])
        self.tc = cell.tracker_config(TrackerConfig, cfg)
        self.value_bytes = cfg["crop_value_bytes"]
        self.qconv_frames: Dict[str, list] = {}  # branch -> the qconv launches of its first frame
        self.crop_bytes: List[int] = []  # bytes each crop frame the reference ran needs, from its own boxes
        self._recording: Optional[list] = None
        cams = cell.cameras(traffic)
        with self.computing():
            det, crop = (archs.of(cfg[name]).build(cfg[name], weights[name], self.device, precision, calib.get(name),
                                                   "reference") for name in cell.NETS)
        self.bank = bank_from_registry(cell.registry(homography, cams), device=self.device)
        self.kfp = default_params(device=self.device)
        self.centers = torch.tensor([c.centre for c in cams], dtype=torch.float32, device=self.device)
        self.clip = reference_clip(det, crop, self.bank, self.centers, self.kfp, self.tc, self.stem,
                                   archs.layout(cfg["crop_net"]), observe=self._observe)

    @contextlib.contextmanager
    def computing(self):
        """The reference's precision while the block runs, and the int8
        convolution's launches recorded."""
        from cellbench.reference import precision as P
        from cellbench.reference.models import quant

        saved = (P.QMAX, P.FP8, quant.qconv)
        P.QMAX = 7.0 if self.precision == "int4" else 127.0
        P.FP8 = self.precision == "fp8"
        real = quant.qconv

        def recording(x, wq, scale, offset=None, stride=1, relu=False, emit_xs=None, res=None, res_xs=None,
                      pads=None):
            out = real(x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)
            if self._recording is not None:
                res_bytes = 0 if res is None else res.numel() * res.element_size()
                self._recording.append(counts.qconv_launch(tuple(x.shape), tuple(wq.shape), tuple(out.shape),
                                                           emit_xs is not None, res_bytes))
            return out

        quant.qconv = recording
        try:
            yield
        finally:
            P.QMAX, P.FP8, quant.qconv = saved

    def _observe(self, what: str, *args) -> None:
        if what == "branch":
            name = args[0]
            self._recording = self.qconv_frames.setdefault(name, []) if name not in self.qconv_frames else None
        elif what == "crop_boxes":
            boxes, _, live = args
            self.crop_bytes.append(counts.crop_frame_bytes(boxes, live, self.traffic["height"],
                                                           self.traffic["width"], self.tc.cs, self.value_bytes))

    def crop_bytes_from_rows(self, rows: list, epoch: float, calls: list, jitter: np.ndarray,
                             frames: List[int]) -> List[int]:
        """Bytes each crop frame of ``frames`` (global frame numbers) needs,
        worked out from what the program read back: the live tracks of the
        frame before (their states7 at that row's time; a crop frame starts
        from the state that row shows), each rolled to the crop frame's
        clocks and boxed in its nearest camera as the crop branch boxes it
        (:func:`~cellbench.reference.pipeline.clip.square_crop_boxes`). The
        clock bias is the one the frame's clip started from. Where more
        tracks live than the branch crops, the bytes are scaled to its
        ``crop_slots`` (which it picks needs the state's counters)."""
        from cellbench.reference.pipeline.clip import square_crop_boxes

        t = self.traffic
        n_slots = self.tc.crop_slots if 0 < self.tc.crop_slots < self.tc.max_tracks else self.tc.max_tracks
        clip_len = t["clip_len"]
        out = []
        for g in frames:
            _, t_abs, _, states7, _ = rows[g - 1]
            n = len(states7)
            if n == 0:
                out.append(0)
                continue
            s7 = torch.as_tensor(states7, device=self.device)
            times = torch.as_tensor(cam_times(t, jitter, g, 1)[0], device=self.device)
            bias = calls[g // clip_len][1].to(self.device)
            roll = s7[:, 5] * s7[:, 6]  # direction x speed: ft a second along x
            t_row = float(t_abs - epoch)
            x_mean = s7[:, 0] + roll * (times.mean() - t_row)
            cam = torch.argmin((x_mean[:, None] - self.centers[None, :, 0]) ** 2
                               + (s7[:, 1:2] - self.centers[None, :, 1]) ** 2, dim=1)
            x = s7[:, 0] + roll * (times[cam] + bias[cam] - t_row)
            state6 = torch.cat([x[:, None], s7[:, 1:6]], dim=1)
            boxes, _ = square_crop_boxes(self.bank, state6, cam, self.tc, self.stem)
            live = torch.ones(n, dtype=torch.bool)
            nbytes = counts.crop_frame_bytes(boxes, live, t["height"], t["width"], self.tc.cs, self.value_bytes)
            out.append(round(nbytes * min(1.0, n_slots / n)))
        return out

    def frames(self, rings: np.ndarray, first: int, n: int) -> torch.Tensor:
        """The clip's frames as the reference's clip takes them."""
        from cellbench.reference.models.resnet import space_to_depth
        from cellbench.reference.ops.yuv420 import yuv420_flat_to_s2d

        t = self.traffic
        raw = torch.as_tensor(cell.clip_frames(t, rings, first, n)).to(self.device)
        if t["format"] == "yuv420":
            return yuv420_flat_to_s2d(raw, (t["height"], t["width"]))
        if self.stem == "s2d":
            flat = space_to_depth(raw.reshape((-1,) + tuple(raw.shape[2:])), 4)
            return flat.reshape(tuple(raw.shape[:2]) + tuple(flat.shape[1:]))
        return raw

    def run(self, state, ts_bias: torch.Tensor, frames: torch.Tensor, cam_times: torch.Tensor, frame0: int):
        """The clip from a state of the program's (copied into the
        reference's types) -> (state', ts_bias', rows a frame)."""
        from cellbench.reference.pipeline.tracker_state import TrackState, pack_snapshot, unpack_snapshot
        from cellbench.reference.track.kf import KFSlots

        st = TrackState(KFSlots(*(x.to(self.device).clone() for x in state.kf)),
                        *(x.to(self.device).clone() for x in state[1:]))
        with self.computing():
            st2, tb2, snaps = self.clip(st, ts_bias.to(self.device).clone(), frames, cam_times, frame0)
        states, ids, classes, mask, _ = unpack_snapshot(pack_snapshot(snaps).cpu().numpy())
        rows = [(ids[k][mask[k]], states[k][mask[k]], classes[k][mask[k]]) for k in range(ids.shape[0])]
        return st2, tb2, rows


def state_leaves(state, ts_bias) -> List[torch.Tensor]:
    return [*state.kf, *state[1:], ts_bias]


def compare(cand_rows, ref_rows, cand_state, cand_tb, ref_state, ref_tb) -> Dict[str, float]:
    """The four numbers of one clip (see the module docstring)."""
    rows_differ, gap = 0, 0.0
    for (ci, cs, cc), (ri, rs, rc) in zip(cand_rows, ref_rows, strict=True):
        cand = {int(i): (s, int(c)) for i, s, c in zip(ci, cs, cc)}
        ref = {int(i): (s, int(c)) for i, s, c in zip(ri, rs, rc)}
        rows_differ += len(set(cand) ^ set(ref))
        for i in set(cand) & set(ref):
            rows_differ += cand[i][1] != ref[i][1]
            gap = max(gap, _gap(torch.as_tensor(cand[i][0]), torch.as_tensor(ref[i][0]), relative=False))
    differ, hgap = 0, 0.0
    for a, b in zip(state_leaves(cand_state, cand_tb), state_leaves(ref_state, ref_tb), strict=True):
        a, b = a.detach().to("cpu"), b.detach().to("cpu")
        if a.shape != b.shape:
            differ += max(a.numel(), b.numel())
        elif a.is_floating_point():
            hgap = max(hgap, _gap(a, b, relative=True))
        else:
            differ += int((a != b).sum())
    return {"rows_differ": rows_differ, "states7_gap": gap, "handover_differ": differ, "handover_gap": hgap}


def _gap(a: torch.Tensor, b: torch.Tensor, relative: bool) -> float:
    """The largest |a - b| (over max(|b|, 1) when ``relative``); a NaN on
    one side only is an infinite gap, on both none."""
    a, b = a.double(), b.double()
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, torch.zeros_like(a), (a - b).abs())
    if relative:
        d = d / torch.clamp(torch.where(torch.isnan(b), torch.ones_like(b), b.abs()), min=1.0)
    d = torch.where(torch.isnan(d), torch.full_like(d, math.inf), d)
    return float(d.max()) if d.numel() else 0.0


def merge(per_clip: List[Dict[str, float]]) -> Dict[str, float]:
    """Counts add up over the clips; gaps take the largest."""
    return {k: (sum if k.endswith("differ") else max)(c[k] for c in per_clip) for k in NUMBERS}


def picks(seed: int, warm_clips: int, n_calls: int, extra: int) -> List[int]:
    """The clips compared: the warm-up's first (it starts from the seeded
    state), the window's first, and ``extra`` more of the window's drawn
    from the seed."""
    rest = list(range(warm_clips + 1, n_calls))
    rng = np.random.default_rng(seed)
    drawn = sorted(rng.choice(rest, size=min(extra, len(rest)), replace=False).tolist()) if rest else []
    return [0] + ([warm_clips] if warm_clips < n_calls else []) + drawn


def cam_times(traffic: dict, jitter: np.ndarray, first: int, n: int) -> np.ndarray:
    """[n, C] float32 camera times of global frames ``first`` onwards, from
    the first frame's earliest timestamp, as the tracker forms them."""
    def ts(c, k):
        return traffic["t0"] + k / traffic["fps"] + float(jitter[c])

    n_cams = len(traffic["cameras"])
    epoch = float(min(ts(c, 0) for c in range(n_cams)))
    return np.asarray([[ts(c, k) - epoch for c in range(n_cams)] for k in range(first, first + n)], np.float32)


def reference_outputs(ref: Reference, rings: np.ndarray, jitter: np.ndarray, calls: list, chosen: List[int],
                      clip_len: int) -> list:
    """The reference's (state', ts_bias', rows a frame) of each chosen call,
    run from the state the program's call started from."""
    outs = []
    for i in chosen:
        state, tb, _, first = calls[i]
        frames = ref.frames(rings, first, clip_len)
        times = torch.as_tensor(cam_times(ref.traffic, jitter, first, clip_len), device=ref.device)
        outs.append(ref.run(state, tb, frames, times, first))
    return outs


def check(ref: Reference, rings: np.ndarray, jitter: np.ndarray, calls: list, rows: list, final_state, final_tb,
          chosen: List[int], clip_len: int, log):
    """(the numbers, the reference's outputs) over the ``chosen`` calls of
    the program (``calls`` as :class:`~cellbench.window.Recorder` keeps
    them, ``rows`` the tracker's read-back rows, one a frame, in order)."""
    per_clip, outs = [], []
    for i in chosen:
        t0 = time.perf_counter()
        out = reference_outputs(ref, rings, jitter, calls, [i], clip_len)[0]
        nxt_state, nxt_tb = (calls[i + 1][0], calls[i + 1][1]) if i + 1 < len(calls) else (final_state, final_tb)
        cand_rows = [(r[2], r[3], r[4]) for r in rows[i * clip_len:(i + 1) * clip_len]]
        numbers = compare(cand_rows, out[2], nxt_state, nxt_tb, out[0], out[1])
        first = calls[i][3]
        log(f"check: clip {i} (frames {first}-{first + clip_len - 1}): {numbers}; reference track rows "
            f"{sum(len(r[0]) for r in out[2])}; {time.perf_counter() - t0:.2f} s")
        per_clip.append(numbers)
        outs.append(out)
    return merge(per_clip), outs
