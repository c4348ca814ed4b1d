"""Association, births, ghost re-identification, lifecycle and snapshots in
the PyTorch port against the JAX package, on hand-built pools.

Integer state (ids, masks, counters) must be equal; float state within
rtol/atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.pipeline import tracker_state as JS
from playground3d_tpu.track.kf import default_params as jax_kf_params
from playground3d_tpu.utils.config import TrackerConfig as JaxConfig
from playground3d_tpu_torch.pipeline import tracker_state as PS
from playground3d_tpu_torch.track.kf import default_params
from playground3d_tpu_torch.utils.config import TrackerConfig

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


N, K = 12, 10


def _pool(rng):
    """6 live tracks, 2 ghosts (dead, id kept), 4 free slots."""
    x = np.zeros((N, 6), np.float32)
    x[:8, 0] = rng.uniform(400, 700, 8)
    x[:8, 1] = rng.uniform(5, 100, 8)
    x[:8, 2:5] = (16.0, 6.0, 5.0)
    x[:8, 5] = rng.uniform(40, 90, 8)
    P = np.tile(np.eye(6, dtype=np.float32) * 2.0, (N, 1, 1))
    d = np.where(np.arange(N) % 3 == 0, -1.0, 1.0).astype(np.float32)
    mask = np.arange(N) < 6
    ids = np.where(np.arange(N) < 8, np.arange(N) + 100, -1).astype(np.int32)
    return dict(
        kf=(x, P, d, mask), ids=ids,
        fsld=np.where(mask, rng.integers(0, 3, N), np.where(ids >= 0, 2, 0)).astype(np.int32),
        misses=np.where(mask, rng.integers(0, 5, N), 0).astype(np.int32),
        age=np.where(mask, rng.integers(1, 9, N), 0).astype(np.int32),
        cls_votes=rng.integers(0, 3, (N, 8)).astype(np.float32),
        conf_sum=rng.uniform(0, 3, N).astype(np.float32),
        conf_cnt=rng.integers(1, 4, N).astype(np.float32),
        t_off=rng.uniform(0, 0.1, N).astype(np.float32),
        next_id=np.int32(108),
    )


def _parsed(rng, pool):
    """Detections: 4 near live tracks, 2 near the ghosts, 3 new, 1 masked."""
    x, _, d, _ = pool["kf"]
    near = [0, 1, 2, 4, 6, 7]
    st = np.zeros((K, 6), np.float32)
    st[:6, :2] = x[near, :2] + rng.normal(0, 1.0, (6, 2))
    st[:6, 0] += 3.0 * d[near]
    st[6:, 0] = rng.uniform(420, 680, 4)
    st[6:, 1] = rng.uniform(5, 100, 4)
    st[:, 2:5] = (15.0, 6.0, 5.0)
    st[:6, 5] = d[near]
    st[6:, 5] = 1.0
    return dict(
        state=st, scores=rng.uniform(0.3, 1.0, K).astype(np.float32),
        classes=rng.integers(0, 8, K).astype(np.int32), cam_idx=np.zeros(K, np.int32),
        times=np.full(K, 0.2, np.float32), mask=np.arange(K) != 9,
    )


def _jax(tree, cls):
    kf = JS.KFSlots(*(jnp.asarray(a) for a in tree["kf"])) if "kf" in tree else None
    rest = {k: jnp.asarray(v) for k, v in tree.items() if k != "kf"}
    return cls(kf=kf, **rest) if kf is not None else cls(**rest)


def _torch(tree, cls):
    rest = {k: torch.as_tensor(np.array(v)) for k, v in tree.items() if k != "kf"}
    if "kf" in tree:
        return cls(kf=PS.KFSlots(*(torch.as_tensor(np.array(a)) for a in tree["kf"])), **rest)
    return cls(**rest)


def _assert_state(p, j):
    for f in ("ids", "fsld", "misses", "age", "next_id"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(p.kf.mask.numpy(), np.asarray(j.kf.mask))
    for f in ("cls_votes", "conf_sum", "conf_cnt", "t_off"):
        np.testing.assert_allclose(getattr(p, f).numpy(), np.asarray(getattr(j, f)), rtol=1e-4, atol=1e-4, err_msg=f)
    for f in ("x", "P", "d"):
        np.testing.assert_allclose(getattr(p.kf, f).numpy(), np.asarray(getattr(j.kf, f)), rtol=1e-4, atol=1e-4, err_msg=f)


KNOBS = {
    "reference": {},
    "ghosts_merge_tentative": dict(ghost_frames=3, merge_dist_ft=12.0, tentative_age=3),
}


@pytest.mark.parametrize("name", sorted(KNOBS))
@pytest.mark.parametrize("seed", [0, 1])
def test_associate_lifecycle_snapshot(name, seed):
    rng = np.random.default_rng(seed)
    knobs = dict(x_range=(300.0, 900.0), f_max=4, phi_match=0.05, **KNOBS[name])
    jcfg, pcfg = JaxConfig(**knobs), TrackerConfig(**knobs)
    pool = _pool(rng)
    parsed = _parsed(rng, pool)
    jst, pst = _jax(pool, JS.TrackState), _torch(pool, PS.TrackState)
    jpar, ppar = _jax(parsed, JS.ParsedDetections), _torch(parsed, PS.ParsedDetections)
    jkfp, pkfp = jax_kf_params(), default_params(device="cpu")
    t_ref = np.float32(0.15)

    jo, jcol, jmc = JS.associate_and_update(jst, jpar, jnp.asarray(t_ref), jkfp, jcfg)
    po, pcol, pmc = PS.associate_and_update(pst, ppar, torch.tensor(t_ref), pkfp, pcfg)
    np.testing.assert_array_equal(pcol.numpy(), np.asarray(jcol))
    np.testing.assert_array_equal(pmc.numpy(), np.asarray(jmc))
    _assert_state(po, jo)
    assert (np.asarray(jcol) >= 0).sum() >= 2, "some detections should match live tracks"
    if jcfg.ghost_frames:
        # both ghosts are reborn in their slots with their old ids
        assert np.asarray(jo.kf.mask)[6:8].all() and list(np.asarray(jo.ids)[6:8]) == [106, 107]

    jl = JS.lifecycle(jo, jnp.asarray(t_ref), jkfp, jcfg)
    pl = PS.lifecycle(po, torch.tensor(t_ref), pkfp, pcfg)
    _assert_state(pl, jl)

    js_, ps_ = JS.snapshot(jl, jnp.asarray(t_ref + 0.03), jkfp, jcfg), PS.snapshot(
        pl, torch.tensor(t_ref + 0.03), pkfp, pcfg
    )
    for f in ("ids", "classes", "mask", "raw_mask"):
        np.testing.assert_array_equal(getattr(ps_, f).numpy(), np.asarray(getattr(js_, f)), err_msg=f)
    np.testing.assert_allclose(ps_.states7.numpy(), np.asarray(js_.states7), rtol=1e-4, atol=1e-4)


def test_parse_detections_matches(toy_cameras3):
    """Confidence cutoff, camera-grouped image NMS, im->state and roadway
    NMS on random detections."""
    from playground3d_tpu.models.retinanet import Detections as JD
    from playground3d_tpu.pipeline.camera_bank import bank_from_registry as jax_bank
    from playground3d_tpu_torch.models.retinanet import Detections as PD
    from playground3d_tpu_torch.pipeline.camera_bank import bank_from_registry

    rng = np.random.default_rng(4)
    n = 24
    ctr = rng.uniform([200, 300], [1700, 900], (n, 2))
    half = rng.uniform(20, 120, (n, 8, 2)) * rng.choice([-1, 1], (n, 8, 2))
    corners = (ctr[:, None] + half).reshape(n, 16)
    boxes = np.concatenate([corners, np.zeros((n, 4))], 1).astype(np.float32)
    det = dict(
        scores=rng.uniform(0, 1, n).astype(np.float32), classes=rng.integers(0, 8, n).astype(np.int32),
        boxes=boxes, cam_idx=rng.integers(0, 3, n).astype(np.int32), mask=rng.uniform(0, 1, n) > 0.1,
    )
    cfg_kw = dict(phi_nms_im=0.3, phi_nms_space=0.2)
    times = np.array([0.0, 0.01, 0.02], np.float32)
    jb, pb = jax_bank(toy_cameras3["registry"]), bank_from_registry(toy_cameras3["registry"], device="cpu")
    jp = JS.parse_detections(JD(**{k: jnp.asarray(v) for k, v in det.items()}), jb,
                             jnp.asarray(times), JaxConfig(**cfg_kw))
    pp = PS.space_nms_parsed(
        PS.parse_detections_pre(PD(**{k: torch.as_tensor(v) for k, v in det.items()}), pb,
                                torch.as_tensor(times), TrackerConfig(**cfg_kw)),
        TrackerConfig(**cfg_kw),
    )
    np.testing.assert_array_equal(pp.mask.numpy(), np.asarray(jp.mask))
    live = np.asarray(jp.mask)
    assert live.sum() >= 3
    for f in ("classes", "cam_idx"):
        np.testing.assert_array_equal(getattr(pp, f).numpy()[live], np.asarray(getattr(jp, f))[live])
    for f in ("scores", "times", "state"):
        np.testing.assert_allclose(
            getattr(pp, f).numpy()[live], np.asarray(getattr(jp, f))[live], rtol=1e-4, atol=1e-4
        )
