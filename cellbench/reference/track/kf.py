# A frozen copy of the port's track/kf.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Batched Kalman filter over a fixed-capacity slot pool (port of
``playground3d_tpu/track/kf.py``).

One filter tracks all objects at once with batched matmuls over a pool of
``N`` slots and a validity mask, so every function is fixed-shape. State
[x, y, l, w, h, v]; measurement [x, y, l, w, h]; F[0,5] = direction * dt;
Q scaled by dt/dt_default; innovation y = z + mu_R - Hx; measurement models
1 = detection, 2 = crop re-detection, 3 = class-size nudge (reference
util_track/kf.py). Everything stays float32 with TF32 off.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cellbench.reference import DeviceLike, resolve_device
from cellbench.reference.utils.constants import CLASS_DIMS, DT_DEFAULT

STATE_SIZE = 6
MEAS_SIZE = 5


class KFParams(NamedTuple):
    F: torch.Tensor  # [6,6] base dynamics (F[0,5] overwritten per object)
    H: torch.Tensor  # [5,6] detection measurement model
    R: torch.Tensor  # [5,5]
    mu_R: torch.Tensor  # [5]
    Q: torch.Tensor  # [6,6]
    mu_Q: torch.Tensor  # [6]
    P0: torch.Tensor  # [6,6] initial covariance
    H2: torch.Tensor  # [5,6] crop-measurement model
    R2: torch.Tensor  # [5,5]
    mu_R2: torch.Tensor  # [5]
    H3: torch.Tensor  # [3,6] class-size measurement model (l,w,h)
    R3: torch.Tensor  # [3,3]
    mu_R3: torch.Tensor  # [3]
    mu_v: torch.Tensor  # [] mean initial speed (ft/s)
    class_size: torch.Tensor  # [n_cls,3] mean l,w,h per class
    class_covariance: torch.Tensor  # [n_cls,3,3]


def default_params(
    state_err: float = 10000.0,
    meas_err: float = 1.0,
    mod_err: float = 1.0,
    device: DeviceLike = None,
) -> KFParams:
    """The JAX package's defaults (reference kf.py:55-68), on ``device``."""
    dev = resolve_device(device)
    eye6 = np.eye(STATE_SIZE, dtype=np.float32)
    H = np.zeros((MEAS_SIZE, STATE_SIZE), dtype=np.float32)
    H[:MEAS_SIZE, :MEAS_SIZE] = np.eye(MEAS_SIZE)
    H3 = np.zeros((3, STATE_SIZE), dtype=np.float32)
    H3[0, 2] = H3[1, 3] = H3[2, 4] = 1.0
    P0 = np.diag([10.0, 100.0, 100.0, 100.0, 100.0, 10000.0]).astype(np.float32)
    n_cls = CLASS_DIMS.shape[0]
    arrs = dict(
        F=eye6,
        H=H,
        R=np.eye(MEAS_SIZE, dtype=np.float32) * meas_err,
        mu_R=np.zeros(MEAS_SIZE, np.float32),
        Q=eye6 * mod_err,
        mu_Q=np.zeros(STATE_SIZE, np.float32),
        P0=P0 * (state_err / 10000.0) if state_err != 10000.0 else P0,
        H2=H,
        R2=np.eye(MEAS_SIZE, dtype=np.float32) * meas_err,
        mu_R2=np.zeros(MEAS_SIZE, np.float32),
        H3=H3,
        R3=np.eye(3, dtype=np.float32) * 3.0,
        mu_R3=np.zeros(3, np.float32),
        mu_v=np.float32(30.0),
        class_size=CLASS_DIMS,
        class_covariance=np.tile(np.eye(3, dtype=np.float32), (n_cls, 1, 1)),
    )
    return KFParams(
        **{k: torch.as_tensor(np.asarray(v, np.float32), device=dev) for k, v in arrs.items()}
    )


class KFSlots(NamedTuple):
    """Filter state; ``mask`` marks live slots."""

    x: torch.Tensor  # [N,6] float32
    P: torch.Tensor  # [N,6,6] float32
    d: torch.Tensor  # [N] float32 direction (+1/-1)
    mask: torch.Tensor  # [N] bool


def init_slots(capacity: int, device: DeviceLike = None) -> KFSlots:
    dev = resolve_device(device)
    return KFSlots(
        x=torch.zeros((capacity, STATE_SIZE), dtype=torch.float32, device=dev),
        P=torch.zeros((capacity, STATE_SIZE, STATE_SIZE), dtype=torch.float32, device=dev),
        d=torch.ones((capacity,), dtype=torch.float32, device=dev),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def _f_rep(slots: KFSlots, dt: torch.Tensor, params: KFParams) -> torch.Tensor:
    """Per-object dynamics: F with F[0,5] = direction * dt."""
    n = slots.x.shape[0]
    F = params.F.expand(n, STATE_SIZE, STATE_SIZE).clone()
    F[:, 0, 5] = slots.d * dt
    return F


def _masked_dt(slots: KFSlots, dt: torch.Tensor) -> torch.Tensor:
    return torch.where(slots.mask, dt, torch.zeros_like(dt))


def kf_view(slots: KFSlots, dt: torch.Tensor, params: KFParams) -> torch.Tensor:
    """Predicted states at +dt without changing the filter ([N] -> [N,6])."""
    F = _f_rep(slots, _masked_dt(slots, dt), params)
    return torch.einsum("nij,nj->ni", F, slots.x)


def kf_predict(slots: KFSlots, dt: torch.Tensor, params: KFParams) -> KFSlots:
    """x <- Fx, P <- FPF^T + Q*dt/dt_default on live slots; dead slots are
    untouched (reference kf.py:292-330)."""
    dt = _masked_dt(slots, dt)
    F = _f_rep(slots, dt, params)
    x_new = torch.einsum("nij,nj->ni", F, slots.x)
    P_new = torch.matmul(torch.matmul(F, slots.P), F.transpose(1, 2)) + params.Q[None] * (
        dt[:, None, None] / DT_DEFAULT
    )
    keep = slots.mask
    return slots._replace(
        x=torch.where(keep[:, None], x_new, slots.x),
        P=torch.where(keep[:, None, None], P_new, slots.P),
    )


def _spd_solve(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve S X = B for batched small SPD matrices ([N,m,m] @ [N,m,k]) by a
    statically unrolled Cholesky with a ``max(s, 1e-12)`` pivot clamp and
    two substitutions, exactly as the JAX package writes it (a library
    Cholesky would raise where this clamps)."""
    m = S.shape[-1]
    L = [[None] * m for _ in range(m)]
    for i in range(m):
        for j in range(i + 1):
            s = S[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-12))
            else:
                L[i][j] = s / L[j][j]
    Y = [None] * m
    for i in range(m):
        acc = B[..., i, :]
        for k in range(i):
            acc = acc - L[i][k][..., None] * Y[k]
        Y[i] = acc / L[i][i][..., None]
    X = [None] * m
    for i in reversed(range(m)):
        acc = Y[i]
        for k in range(i + 1, m):
            acc = acc - L[k][i][..., None] * X[k]
        X[i] = acc / L[i][i][..., None]
    return torch.stack(X, dim=-2)


def kf_update(
    slots: KFSlots,
    z: torch.Tensor,
    upd_mask: torch.Tensor,
    params: KFParams,
    measurement_idx: int = 1,
) -> KFSlots:
    """Measurement update of the slots flagged in ``upd_mask`` (and live);
    ``z`` is [N,m] slot-aligned, m = 5 for models 1/2 and 3 for model 3
    (reference kf.py:335-403)."""
    if measurement_idx == 1:
        H, R, mu_R = params.H, params.R, params.mu_R
    elif measurement_idx == 2:
        H, R, mu_R = params.H2, params.R2, params.mu_R2
    elif measurement_idx == 3:
        H, R, mu_R = params.H3, params.R3, params.mu_R3
    else:
        raise ValueError(f"unknown measurement_idx {measurement_idx}")

    upd = upd_mask & slots.mask
    y = z + mu_R[None] - torch.einsum("mj,nj->nm", H, slots.x)
    S = torch.matmul(torch.matmul(H, slots.P), H.T) + R[None]
    PHt = torch.matmul(slots.P, H.T)  # [N,6,m]
    K = _spd_solve(S, PHt.transpose(1, 2)).transpose(1, 2)  # [N,6,m]
    x_new = slots.x + torch.einsum("nim,nm->ni", K, y)
    I = torch.eye(STATE_SIZE, dtype=slots.P.dtype, device=slots.P.device)
    P_new = torch.matmul(I[None] - torch.matmul(K, H), slots.P)
    return slots._replace(
        x=torch.where(upd[:, None], x_new, slots.x),
        P=torch.where(upd[:, None, None], P_new, slots.P),
    )


def kf_add(
    slots: KFSlots,
    new_x: torch.Tensor,  # [N,6] slot-aligned initial states
    new_d: torch.Tensor,  # [N]
    add_mask: torch.Tensor,  # [N] bool
    params: KFParams,
    class_ids: Optional[torch.Tensor] = None,  # [N] int or None
) -> KFSlots:
    """(Re)initialize the flagged slots; with ``class_ids``, l/w/h and
    their covariance block come from the class priors (kf.py:201-207)."""
    x = new_x
    P = params.P0.expand_as(slots.P)
    if class_ids is not None:
        cls = class_ids.long()
        x = x.clone()
        x[:, 2:5] = params.class_size[cls]
        P = P.clone()
        P[:, 2:5, 2:5] = params.class_covariance[cls]
    return slots._replace(
        x=torch.where(add_mask[:, None], x, slots.x),
        P=torch.where(add_mask[:, None, None], P, slots.P),
        d=torch.where(add_mask, new_d, slots.d),
        mask=slots.mask | add_mask,
    )


