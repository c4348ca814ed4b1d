# A frozen copy of the port's pipeline/camera_bank.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Device-side camera bank: per-object homography dispatch as gathers
(port of ``playground3d_tpu/pipeline/camera_bank.py``).

Each detection carries a camera index; its H/P matrices are gathered and the
EB/WB dual-correspondence selection (reference Homography_Wrapper,
homography.py:793-862) happens per object on roadway y.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cellbench.reference import DeviceLike, resolve_device
from cellbench.reference.geometry import transforms as T
from cellbench.reference.utils.constants import EB_WB_Y_SPLIT_FT


class CameraBank(NamedTuple):
    H: torch.Tensor  # [C,2,3,3] image->space; bank 0 EB, 1 WB
    P: torch.Tensor  # [C,2,3,4] space->image
    # optional per-camera ignore-region grid [C,GH,GW] bool, cell size
    # ignore_cell px (reference ignored_regions/*)
    ignore: Optional[torch.Tensor] = None
    ignore_cell: float = 8.0


def bank_from_registry(registry, ignore_polygons=None, image_hw=(1080, 1920), ignore_cell=8,
                       device: DeviceLike = None) -> CameraBank:
    """Ship a :class:`CameraRegistry`'s float32 arrays to ``device`` (the
    card unless the caller asks for the CPU), with the per-camera ignore
    grid of ``ignore_polygons`` ({camera: [n,2] polygon} in ``image_hw``
    pixels, see :func:`~cellbench.reference.data.regions.ignore_grid`)
    when there are any."""
    dev = resolve_device(device)
    arrs = registry.device_arrays()
    ignore = None
    if ignore_polygons:
        from cellbench.reference.data.regions import ignore_grid

        grid = ignore_grid(ignore_polygons, registry.names, image_hw[0], image_hw[1], ignore_cell)
        ignore = torch.as_tensor(grid, device=dev)
    return CameraBank(
        H=torch.as_tensor(arrs["H"], device=dev), P=torch.as_tensor(arrs["P"], device=dev),
        ignore=ignore, ignore_cell=float(ignore_cell),
    )


def ignore_hits(bank: CameraBank, centers_px: torch.Tensor, cam_idx: torch.Tensor) -> torch.Tensor:
    """[n,2] box centers (px) + [n] camera indices -> bool [n]: True where
    the center falls in the camera's ignored region."""
    if bank.ignore is None:
        return torch.zeros(centers_px.shape[0], dtype=torch.bool, device=centers_px.device)
    gh, gw = bank.ignore.shape[1], bank.ignore.shape[2]
    cx = torch.clamp((centers_px[:, 0] / bank.ignore_cell).to(torch.int64), 0, gw - 1)
    cy = torch.clamp((centers_px[:, 1] / bank.ignore_cell).to(torch.int64), 0, gh - 1)
    return bank.ignore[cam_idx.long(), cy, cx]


def im_to_state_banked(
    bank: CameraBank, points: torch.Tensor, cam_idx: torch.Tensor, heights: torch.Tensor
) -> torch.Tensor:
    """[d,8,2] image corners + [d] camera indices -> [d,6] state; the WB
    homography where corner 0's EB-projected y exceeds 60 ft."""
    cam = cam_idx.long()
    y0 = T._apply_h(points[:, 0:1, :], bank.H[cam, 0])[:, 0, 1]
    use_wb = (y0 > EB_WB_Y_SPLIT_FT).long()
    return T.space_to_state(T.im_to_space(points, bank.H[cam, use_wb], heights))


def im_to_state_refined(
    bank: CameraBank, points: torch.Tensor, cam_idx: torch.Tensor, heights: torch.Tensor
) -> torch.Tensor:
    """:func:`im_to_state_banked` with the two-pass height refinement folded
    into one projection (see the JAX module for why it is bitwise equal)."""
    state = im_to_state_banked(bank, points, cam_idx, heights)
    refined = refine_heights_banked(bank, state, cam_idx, points, heights)
    refined = torch.where(torch.isfinite(refined) & (refined > 0.5), refined, heights)
    state = state.clone()
    state[:, 4] = refined
    return state


def state_to_im_banked(
    bank: CameraBank, state: torch.Tensor, cam_idx: torch.Tensor
) -> torch.Tensor:
    """[d,s] states + [d] camera indices -> [d,8,2]; WB bank where state
    y > 60 ft."""
    use_wb = (state[:, 1] > EB_WB_Y_SPLIT_FT).long()
    return T.space_to_im(T.state_to_space(state), bank.P[cam_idx.long(), use_wb])


def refine_heights_banked(
    bank: CameraBank,
    state: torch.Tensor,
    cam_idx: torch.Tensor,
    im_corners: torch.Tensor,
    heights: torch.Tensor,
) -> torch.Tensor:
    """Reproject the guessed-height state and scale the class-prior height
    by observed/reprojected pixel height (minimal_3D_track.py:486-490)."""
    repro = state_to_im_banked(bank, state, cam_idx)
    return T.height_from_template(repro, heights, im_corners)
