# A frozen copy of the port's models/decode.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Fused 12-channel directional box decode (port of
``playground3d_tpu/models/decode.py``).

Per anchor the regression head predicts the object centre (0:2), the
half-length, half-width and half-height vectors (2:4, 4:6, 6:8) and a 2D box
(8:12), in anchor-normalized units. The 8 corners are
``c + S[k,0]*l' + S[k,1]*w' + S[k,2]*h'`` with the reference's sign pattern
(utils.py:102-149); all 20 outputs are scaled by anchor width/height and
shifted by the anchor centre.
"""

from __future__ import annotations

import functools

import torch

_SIGNS = (
    (-1.0, -1.0, 1.0),
    (-1.0, 1.0, 1.0),
    (1.0, -1.0, 1.0),
    (1.0, 1.0, 1.0),
    (-1.0, -1.0, -1.0),
    (-1.0, 1.0, -1.0),
    (1.0, -1.0, -1.0),
    (1.0, 1.0, -1.0),
)


@functools.lru_cache(maxsize=None)
def _signs(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # made once a device: a CUDA graph cannot capture a copy from the host
    return torch.tensor(_SIGNS, dtype=dtype, device=device)


def decode_regression(regression: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """[..., A, 12] raw regression + [A, 4] xyxy anchors -> [..., A, 20]."""
    reg = regression
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    ctr_x = anchors[:, 0] + 0.5 * widths
    ctr_y = anchors[:, 1] + 0.5 * heights

    c = reg[..., 0:2]
    lv = reg[..., 2:4]
    wv = reg[..., 4:6]
    hv = reg[..., 6:8]

    S = _signs(reg.device, reg.dtype)
    corners = (
        c[..., None, :]
        + S[:, 0, None] * lv[..., None, :]
        + S[:, 1, None] * wv[..., None, :]
        + S[:, 2, None] * hv[..., None, :]
    )

    wh = torch.stack([widths, heights], dim=-1).to(reg.dtype)  # [A,2]
    cxy = torch.stack([ctr_x, ctr_y], dim=-1).to(reg.dtype)
    corners = corners * wh[:, None, :] + cxy[:, None, :]
    box2d = reg[..., 8:12] * torch.cat([wh, wh], dim=-1) + torch.cat([cxy, cxy], dim=-1)

    flat_corners = corners.reshape(corners.shape[:-2] + (16,))
    return torch.cat([flat_corners, box2d], dim=-1)
