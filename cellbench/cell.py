"""What one run of a cell is made of, all from ``--seed``: the cameras'
fitted geometry, the frame rings, the seeded tracks and the calibration
inputs; each net's raw weights come from its architecture module
(``archs/``). The program and the reference are each handed the same of
these and derive the rest themselves.

Everything here is the benchmark's own: it uses the reference's geometry
(``reference/``), never the program's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

SEEDED_SPEED_FT_S = 80.0
NETS = ("detector", "crop_net")  # the configuration's nets, each with an architecture of its own


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of draws of the run's ``seed``."""
    return int(np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, stream]).generate_state(
        1, np.uint64)[0] >> 1)


@dataclass
class Camera:
    name: str
    image_points: np.ndarray  # [n,2] pixels
    space_points: np.ndarray  # [n,2] roadway feet
    vps: np.ndarray  # [3,2] vanishing points
    centre: Tuple[float, float]  # roadway (x, y) of the view's centre


def cameras(traffic: dict) -> List[Camera]:
    """Each camera of the mix as a pole camera looking down-road: on a pole
    ``height_ft`` above the road at road-x ``x_ft + dx_ft``, yawed and
    pitched, fitted from points drawn over its view."""
    pole, h, w = traffic["pole"], traffic["height"], traffic["width"]
    f, cx, cy = pole["focal_px_at_1920"] * w / 1920.0, w / 2.0, h / 2.0
    yaw, pitch = np.deg2rad(pole["yaw_deg"]), np.deg2rad(pole["pitch_deg"])
    Ry = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(pitch), -np.sin(pitch)], [0, np.sin(pitch), np.cos(pitch)]])

    def project(p3, cam_pos):
        d = p3 - cam_pos
        cam = np.stack([d[:, 1], -d[:, 2], d[:, 0]], 1) @ Ry.T @ Rx.T
        return np.stack([f * cam[:, 0] / cam[:, 2] + cx, f * cam[:, 1] / cam[:, 2] + cy], 1)

    out = []
    n = pole["fit_points"]
    for cam in traffic["cameras"]:
        dx = cam["dx_ft"]
        cam_pos = np.array([pole["x_ft"] + dx, pole["y_ft"], -pole["height_ft"]])
        rng = np.random.default_rng(pole["fit_seed"])
        sp = np.stack([rng.uniform(pole["view_x_ft"][0], pole["view_x_ft"][1], n) + dx,
                       rng.uniform(pole["view_y_ft"][0], pole["view_y_ft"][1], n)], 1)
        im = project(np.concatenate([sp, np.zeros((n, 1))], 1), cam_pos)
        vp_z = project(np.array([[pole["vp_x_ft"] + dx, pole["y_ft"], -1e7]]), cam_pos)[0]
        out.append(Camera(cam["name"], im, sp, np.array([[1e6, cy], [cx, 1e6], vp_z]),
                          (pole["centre_ft"][0] + dx, pole["centre_ft"][1])))
    return out


def registry(module, cams: List[Camera]):
    """A camera registry of ``module`` (the program's or the reference's
    ``geometry.homography``), fitted from ``cams``."""
    reg = module.CameraRegistry()
    for cam in cams:
        reg.add_camera(cam.name, cam.image_points, cam.space_points, cam.vps)
    return reg


def tracker_config(config_cls, cfg: dict):
    """The configuration's tracker settings as ``config_cls`` (the program's
    or the reference's ``TrackerConfig``)."""
    return config_cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg["tracker"].items()})


def seed_tracks(state, n_seed: int):
    """``state`` with ``n_seed`` live eastbound tracks in the first camera's
    view, 40 ft apart in 8 lanes, far enough apart that the lifecycle's
    overlap pruning keeps them all."""
    dev = state.ids.device
    n_slots = state.ids.shape[0]
    x = state.kf.x.clone()
    i = torch.arange(n_seed, device=dev, dtype=torch.float32)
    x[:n_seed, 0] = 440.0 + (i // 8) * 40.0 + (i % 8) * 5.0
    x[:n_seed, 1] = 12.0 + (i % 8) * 12.0
    x[:n_seed, 2:5] = torch.tensor([18.0, 6.0, 5.0], device=dev)
    x[:n_seed, 5] = SEEDED_SPEED_FT_S
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


def crop_target(cfg: dict, traffic: dict) -> List[float]:
    """The mean crop pixel (x, y) of the seeded tracks' bottom centres, for
    crops made as the crop branch makes them (reference geometry)."""
    from cellbench import archs
    from cellbench.reference.geometry import homography, transforms as T
    from cellbench.reference.ops.crop_mxu import max_crop_span_s2d
    from cellbench.reference.pipeline.camera_bank import bank_from_registry, state_to_im_banked
    from cellbench.reference.pipeline.tracker_state import init_track_state
    from cellbench.reference.utils.config import TrackerConfig

    tc, n = tracker_config(TrackerConfig, cfg), cfg["seeded_tracks"]
    st = seed_tracks(init_track_state(tc.max_tracks, "cpu"), n)
    s6 = torch.cat([st.kf.x[:n, :5], st.kf.d[:n, None]], 1)
    bank = bank_from_registry(registry(homography, cameras(traffic)), device="cpu")
    im = state_to_im_banked(bank, s6, torch.zeros(n, dtype=torch.long))
    hull = T.im_hull_xyxy(im)
    scale = torch.maximum(hull[:, 2] - hull[:, 0], hull[:, 3] - hull[:, 1]) * tc.crop_expand
    if archs.layout(cfg["crop_net"]) == "s2d":
        scale = torch.clamp(scale, max=max_crop_span_s2d())
    corner = (hull[:, :2] + hull[:, 2:]) / 2 - scale[:, None] / 2
    bottom = im[:, 0:4].mean(1)
    return ((bottom - corner) / scale[:, None] * tc.cs).mean(0).tolist()


def frame_rings(traffic: dict, seed: int, device) -> np.ndarray:
    """[C, ring, ...] uint8 frames made on ``device`` from ``seed`` and kept
    in host memory: flat planar YUV420 bytes, or [H,W,3] RGB."""
    c, r, h, w = len(traffic["cameras"]), traffic["ring"], traffic["height"], traffic["width"]
    shape = (c, r, h * w * 3 // 2) if traffic["format"] == "yuv420" else (c, r, h, w, 3)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8).cpu().numpy()


def ring_offsets(traffic: dict) -> List[int]:
    """Where in its ring each camera starts: spread, so that cameras show
    different frames at one time."""
    c, r = len(traffic["cameras"]), traffic["ring"]
    return [(k * r) // c for k in range(c)]


def clock_jitter_s(traffic: dict, seed: int) -> np.ndarray:
    """Each camera's fixed clock offset in seconds, below ``clock_jitter_ms``
    (under the tracker's 20 ms sync window, so no frame is skipped)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, traffic["clock_jitter_ms"] / 1000.0, len(traffic["cameras"]))


def clip_frames(traffic: dict, rings: np.ndarray, first: int, n: int) -> np.ndarray:
    """[n, C, ...] the frames the source hands over for global frames
    ``first`` .. ``first + n - 1``."""
    offs = ring_offsets(traffic)
    r = rings.shape[1]
    return np.stack([np.stack([rings[c, (k + offs[c]) % r] for c in range(rings.shape[0])])
                     for k in range(first, first + n)])
