"""Training in the PyTorch port against the JAX package's: the camera fit of
the synthetic dataset (``scale_P_z``), the dataset and its augmentations,
the prefetcher, the optimizer, the gradient of a whole training step, the
trainer and its schedule, checkpoints, and ``apps/train_detector.py``.

Tolerances, each with its reason:

* ``scale_P_z``: the chosen scale C within 1e-5 (ten of the finest grid's
  steps: the float32 errors of neighbouring candidates tie within ulps, and
  the two packages round their einsums in another order); measured equal.
* dataset frames equal (uint8 within 1 LSB), labels within 1e-3 px: the
  renderer and the augmentations are numpy copies drawing from the same
  generator in the same order.
* the whole-model gradient at float32 (depth 18, 64x128): per leaf
  ||g_port - g_jax|| <= 2e-3 ||g_jax|| (cuDNN-free CPU convolutions of the
  two frameworks sum in other orders, through 60 layers).
* clip + Adam against optax on identical gradients: 1e-6 absolute on
  parameters of order 1 (Adam's update is divided by sqrt(nu), whose
  rounding the two libraries order differently).
* three bf16 steps against the JAX Trainer: losses within 2e-2 relative
  (bf16 rounding at other places, as the detector's own tests allow); after
  step n every parameter within 2 n lr of JAX's, so within 2 lr after the
  first (Adam moves each element by about lr a step, and an element whose
  near-zero gradient has the other sign in bf16 moves 2 lr the other way,
  again at each step), and at most 0.1% of the elements beyond 2 lr.
* the plateau schedule and the leaf list: equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.data import dataset as JD
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.train import trainer as JT
from playground3d_tpu_torch.data import dataset as PD
from playground3d_tpu_torch.geometry import homography as PH
from playground3d_tpu_torch.models.bridge import flatten_tree, params_from_jax_numpy
from playground3d_tpu_torch.train import trainer as PT
from test_torch_jax_native import jax_video

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _jax_host_libraries():
    """The JAX package's host libraries whole and ``data.video``'s decoder
    probed with them (``test_torch_jax_native``): JAX's ``resize_frame``
    (the scale-aspect augmentation) follows the decoder, and test processes
    that build the libraries at once leave the decoder probe on cv2."""
    jax_video()


_init = jax.jit(jax_init, static_argnames=("depth", "stem", "tower_depth", "shared_tower", "feature_size"))
HW = (64, 128)


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _hwio(name, a):
    return a.transpose(2, 3, 1, 0) if name.endswith("/w") else a


def _port_flat(model):
    """The port model's leaves as numpy under the JAX keys, convs HWIO."""
    return {k: _hwio(k, t.detach().numpy()) for k, t in PT.train_leaves(model).items()}


# ---------------------------------------------------------------------------
# the camera fit and the dataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,zoom", [((64, 96), 3.0), ((512, 768), 1.5), ((1080, 1920), 1.0)])
def test_scale_P_z_matches_jax(shape, zoom):
    """The dataset's camera: P's z column scaled by the same C."""
    j = JD.SyntheticDetectionDataset(image_shape=shape, zoom=zoom)
    p = PD.SyntheticDetectionDataset(image_shape=shape, zoom=zoom)
    c_j, c_p = j._P[2, 2] / 0.01, p._P[2, 2] / 0.01
    assert abs(c_p - c_j) <= 1e-5, (c_p, c_j)
    np.testing.assert_allclose(p._P[:, [0, 1, 3]], j._P[:, [0, 1, 3]], rtol=0, atol=0)


def test_find_vanishing_point_matches_jax():
    from playground3d_tpu.geometry.homography import find_vanishing_point

    rng = np.random.default_rng(3)
    vp = np.array([900.0, -4000.0])
    starts = rng.uniform(0, 1920, (12, 2))
    lines = np.concatenate([starts, starts + (vp - starts) * rng.uniform(0.1, 0.3, (12, 1))], 1)
    lines[:, 2:] += rng.normal(0, 0.5, (12, 2))
    got = PH.find_vanishing_point(lines)
    np.testing.assert_array_equal(got, find_vanishing_point(lines))
    assert np.linalg.norm(got - vp) < 200.0


_DATASETS = {
    "full": dict(image_shape=(64, 96), zoom=3.0),
    "uint8": dict(image_shape=(64, 96), zoom=3.0, output_dtype="uint8"),
    "crop": dict(image_shape=(128, 192), crop_mode=True, crop_size=32, zoom=2.0),
    "rotate_tile": dict(image_shape=(96, 128), zoom=2.0, p_rotate=1.0, p_tile=1.0),
    "ignore": dict(image_shape=(64, 96), zoom=3.0, ignore_polygon=[[0, 0], [60, 0], [0, 50]]),
    "no_augment": dict(image_shape=(64, 96), zoom=3.0, augment=False, n_objects=9),
}


def _same_sample(fj, lj, fp, lp):
    assert fp.dtype == fj.dtype and fp.shape == fj.shape and lp.shape == lj.shape == (32, 21)
    np.testing.assert_allclose(fp.astype(np.float64), fj.astype(np.float64), rtol=0,
                               atol=1 if fj.dtype == np.uint8 else 0)
    np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-3)


@pytest.mark.parametrize("kind", sorted(_DATASETS))
def test_dataset_samples_match_jax(kind):
    j = JD.SyntheticDetectionDataset(seed=3, **_DATASETS[kind])
    p = PD.SyntheticDetectionDataset(seed=3, **_DATASETS[kind])
    n_labels = 0
    for _ in range(5):
        fj, lj = j.sample()
        fp, lp = p.sample()
        _same_sample(fj, lj, fp, lp)
        n_labels += int((lp[:, 20] >= 0).sum())
    assert n_labels > 0


def _frame_and_labels(seed=0):
    ds = JD.SyntheticDetectionDataset(image_shape=(96, 128), zoom=2.0, augment=False, seed=seed)
    f, lab = ds.sample()
    return f, lab[lab[:, 20] >= 0]


@pytest.mark.parametrize("aug", ["hflip", "photometric_jitter", "scale_aspect", "rotate", "tile_shuffle"])
def test_augmentations_match_jax(aug):
    frame, labels = _frame_and_labels()
    assert len(labels) > 0
    calls = {
        "hflip": lambda m, rng: m.hflip(frame, labels),
        "photometric_jitter": lambda m, rng: (m.photometric_jitter(frame, rng), labels),
        "scale_aspect": lambda m, rng: m.scale_aspect(frame, labels, rng),
        "rotate": lambda m, rng: m.rotate(frame, labels, 13.0),
        "tile_shuffle": lambda m, rng: m.tile_shuffle(frame, labels, rng),
    }[aug]
    for seed in range(3):
        fj, lj = calls(JD, np.random.default_rng(seed))
        fp, lp = calls(PD, np.random.default_rng(seed))
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_allclose(lp, lj, rtol=0, atol=1e-3)


def test_batches_batch_factory_and_registry_match_jax():
    kw = dict(image_shape=(64, 96), zoom=3.0, seed=5)
    j, p = JD.SyntheticDetectionDataset(**kw), PD.SyntheticDetectionDataset(**kw)
    (fj, lj), (fp, lp) = next(j.batches(3)), next(p.batches(3))
    assert fp.shape == (3, 64, 96, 3)
    _same_sample(fj[1], lj[1], fp[1], lp[1])
    mj, mp = j.batch_factory(2, seed=4), p.batch_factory(2, seed=4)
    (fj, lj), (fp, lp) = mj(), mp()
    _same_sample(fj[0], lj[0], fp[0], lp[0])
    rj, rp = j.camera_registry(), p.camera_registry()
    assert rp.names == rj.names
    for attr in ("H", "H_inv", "P", "vps"):
        np.testing.assert_allclose(getattr(rp, attr), getattr(rj, attr), rtol=1e-12, atol=1e-9)


def test_cached_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(2):
        labels = np.stack([PD.pad_labels(rng.uniform(0, 60, (3, 21)).astype(np.float32)) for _ in range(5)])
        np.savez(tmp_path / f"s{i}.npz", frames=rng.integers(0, 256, (5, 16, 24, 3), dtype=np.uint8), labels=labels)
    paths = [str(tmp_path / "s0.npz"), str(tmp_path / "s1.npz")]
    gj, gp = JD.CachedDetectionDataset(paths, seed=2).batches(2), PD.CachedDetectionDataset(paths, seed=2).batches(2)
    for _ in range(5):
        (fj, lj), (fp, lp) = next(gj), next(gp)
        np.testing.assert_array_equal(fp, fj)
        np.testing.assert_array_equal(lp, lj)


def test_prefetcher_single_worker_keeps_order_and_stages_tensors():
    it = ((np.full((2, 3), i, np.float32), np.arange(i, i + 4)) for i in range(7))
    pf = PD.Prefetcher(it, depth=2, device="cpu")
    got = list(pf)
    assert [int(f[0, 0]) for f, _ in got] == list(range(7))
    assert all(isinstance(f, torch.Tensor) and f.device.type == "cpu" for f, _ in got)
    assert pf.batches == 7 and pf.seconds["produce"] >= 0 and pf.seconds["stage"] >= 0
    pf.close()
    assert not any(t.is_alive() for t in pf.threads)


def test_prefetcher_workers_produce_and_close():
    import threading

    seen = set()
    lock = threading.Lock()

    def factory():
        with lock:
            seen.add(threading.get_ident())
        return (np.ones((4, 4), np.float32),)

    pf = PD.Prefetcher(factory=factory, depth=4, workers=3, device="cpu")
    batches = [next(pf) for _ in range(30)]
    assert all(float(b[0].sum()) == 16.0 for b in batches)
    pf.close(timeout=10.0)
    assert not any(t.is_alive() for t in pf.threads) and len(pf.threads) == 3
    with pytest.raises(ValueError):
        PD.Prefetcher(depth=2)


# ---------------------------------------------------------------------------
# optimizer, gradient, trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return _init(jax.random.PRNGKey(0), depth=18, stem="conv7")


def _randomized(p, seed=5):
    """Non-zero output convs (so gradients reach every layer) and BN
    statistics away from identity in layer2."""
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(lambda x: x, p)
    for k in ("cls_out", "reg_out"):
        p["heads"][k]["w"] = jnp.asarray(rng.normal(0, 0.02, p["heads"][k]["w"].shape).astype(np.float32))
    for blk in p["backbone"]["layer2"]:
        ch = blk["bn1"]["mean"].shape[0]
        blk["bn1"] = {"scale": jnp.asarray(rng.uniform(0.5, 1.5, ch).astype(np.float32)),
                      "offset": jnp.asarray(rng.normal(0, 0.1, ch).astype(np.float32)),
                      "mean": jnp.asarray(rng.normal(0, 0.1, ch).astype(np.float32)),
                      "var": jnp.asarray(rng.uniform(0.5, 2.0, ch).astype(np.float32))}
    return p


@pytest.fixture(scope="module")
def batch():
    ds = JD.SyntheticDetectionDataset(image_shape=HW, n_objects=6, seed=2, zoom=8.0, output_dtype="uint8")
    frames, labels = next(ds.batches(2))
    assert (labels[..., 20] >= 0).sum() >= 2
    return frames, labels


def test_train_leaves_are_the_jax_tree_leaves(jax_params):
    model = params_from_jax_numpy(_np_tree(jax_params), device="cpu")
    leaves = PT.train_leaves(model)
    assert sorted(leaves) == sorted(flatten_tree(_np_tree(jax_params)))
    assert any(k.endswith("/var") for k in leaves) and any(k.endswith("/b") for k in leaves)
    opt = PT.make_optimizer(PT.TrainConfig(depth=18), model)
    assert all(t.requires_grad for t in leaves.values()) and len(opt.leaves) == len(leaves)


def test_whole_model_gradient_matches_jax_value_and_grad(jax_params, batch):
    """One step's loss and gradient at float32, leaf by leaf."""
    from playground3d_tpu.losses import detection_loss as jax_loss
    from playground3d_tpu.models.anchors import anchors_for_shape
    from playground3d_tpu.models.retinanet import forward_raw as jax_forward

    p = _randomized(jax_params)
    frames, labels = batch
    anchors = jnp.asarray(anchors_for_shape(HW))

    def loss(params):
        cls, reg = jax_forward(params, frames, depth=18, dtype=jnp.float32)
        return sum(jax_loss(cls, reg, labels, anchors))

    want_loss, want = jax.jit(jax.value_and_grad(loss))(p)
    want = flatten_tree(_np_tree(want))

    model = params_from_jax_numpy(_np_tree(p), device="cpu")
    leaves = PT.train_leaves(model)
    for t in leaves.values():
        t.requires_grad_(True)
    total, parts = PT.loss_fn(model, torch.as_tensor(frames), torch.as_tensor(labels),
                              torch.as_tensor(anchors_for_shape(HW)), dtype=torch.float32)
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(want_loss), rtol=1e-5)
    assert float(parts[1].detach()) > 0  # the batch has positives
    zero = 0
    for k, t in leaves.items():
        g, w = _hwio(k, t.grad.numpy()), want[k]
        nw = np.linalg.norm(w)
        assert np.linalg.norm(g - w) <= 2e-3 * nw + 1e-12, k
        zero += nw == 0
    assert zero < len(leaves) // 10  # the gradient reaches the whole net


@pytest.mark.parametrize("clip", [True, False])
def test_clip_and_adam_match_optax(clip):
    """The same gradients through optax's chain and the port's Optimizer for
    three steps, with the global norm above the clip (scaled) and below."""
    rng = np.random.default_rng(7 + clip)
    shapes = [(3, 3, 4, 8), (8,), (16,), (5, 7)]
    params = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    scale = 1.0 if clip else 1e-3
    grads = [[(rng.normal(0, 1, s) * scale).astype(np.float32) for s in shapes] for _ in range(3)]
    cfg = JT.TrainConfig(lr=1e-2)
    opt = JT.make_optimizer(cfg)
    pj = [jnp.asarray(x) for x in params]
    state = opt.init(pj)
    leaves = [torch.tensor(x) for x in params]
    port = PT.Optimizer(leaves, lr=1e-2, grad_clip=0.1)
    for g in grads:
        import optax

        updates, state = opt.update([jnp.asarray(x) for x in g], state, pj)
        pj = optax.apply_updates(pj, updates)
        for t, x in zip(leaves, g):
            t.grad = torch.tensor(x)
        norm = port.clip()
        assert (float(norm) >= 0.1) == clip
        port.adam.step()
    for t, w in zip(leaves, pj):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def _jax_copy(p):
    """A fresh copy for a JAX Trainer: its step donates (deletes) the state
    it is given."""
    return jax.tree_util.tree_map(jnp.array, _np_tree(p))


def test_three_bf16_steps_match_the_jax_trainer(jax_params, batch):
    frames, labels = batch
    cfg_j = JT.TrainConfig(depth=18, image_shape=HW)
    cfg_p = PT.TrainConfig(depth=18, image_shape=HW)
    lr = cfg_p.lr
    tj = JT.Trainer(cfg_j, params=_jax_copy(jax_params))
    tp = PT.Trainer(cfg_p, model=params_from_jax_numpy(_np_tree(jax_params), device="cpu"), device="cpu")
    start = flatten_tree(_np_tree(jax_params))
    for step in range(1, 4):
        mj, mp = tj.train_step(frames, labels), tp.train_step(frames, labels)
        for k in ("loss", "cls", "reg", "vp"):
            np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=2e-2, atol=1e-6)
        want, got = flatten_tree(_np_tree(tj.state.params)), _port_flat(tp.model)
        beyond = 0
        for k, w in want.items():
            diff = np.abs(got[k] - w)
            assert diff.max() <= 2 * lr * step, (step, k, diff.max() / lr)
            beyond += int((diff > 2 * lr).sum())
        assert beyond <= 1e-3 * sum(w.size for w in want.values())
    moved = sum(np.abs(got[k] - start[k]).max() > 0 for k in want)
    assert moved > len(want) // 2 and tp.state.step == 3


def test_plateau_schedule_matches_jax_step_for_step(jax_params):
    cfg = dict(depth=18, image_shape=HW, lr=1e-3)
    tj = JT.Trainer(JT.TrainConfig(**cfg), params=_jax_copy(jax_params))
    tp = PT.Trainer(PT.TrainConfig(**cfg), model=params_from_jax_numpy(_np_tree(jax_params), device="cpu"),
                    device="cpu")
    for val in [1.0, 0.9, 0.95, 0.97, 0.5, 0.5, 0.5, 0.5, 0.4, 0.4000001, 0.41, 0.42]:
        tj.end_epoch(val)
        tp.end_epoch(val)
        assert tp.lr == tj.lr and tp._bad_epochs == tj._bad_epochs
        assert tp.opt.lr == float(tj.state.opt_state.hyperparams["learning_rate"])
    assert tp.lr < 1e-3 * 0.3 and tp.history == tj.history


def test_trainer_save_loads_in_jax(tmp_path, jax_params, batch):
    from playground3d_tpu.models.nn import load_params as jax_load

    tp = PT.Trainer(PT.TrainConfig(depth=18, image_shape=HW), model=params_from_jax_numpy(_np_tree(jax_params),
                                                                                            device="cpu"),
                    device="cpu")
    tp.train_step(*batch)
    path = str(tmp_path / "det.npz")
    tp.save(path)
    back = flatten_tree(_np_tree(jax_load(path, jax_params)))
    got = _port_flat(tp.model)
    assert sorted(back) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(back[k], got[k])
    other = PT.Trainer(PT.TrainConfig(depth=18, image_shape=HW), device="cpu")
    other.load(path)
    for k, t in PT.train_leaves(other.model).items():
        np.testing.assert_array_equal(_hwio(k, t.detach().numpy()), got[k])
        assert t.requires_grad


def test_train_state_resume_gives_the_same_next_step(tmp_path, batch):
    from playground3d_tpu_torch.utils.checkpoint import CheckpointManager, load_train_state, save_train_state

    cfg = PT.TrainConfig(depth=18, image_shape=HW, feature_size=32, tower_depth=1)
    a = PT.Trainer(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    a.train_step(*batch)
    a.end_epoch(0.5)
    a.end_epoch(0.6)
    path = str(tmp_path / "state.pt")
    save_train_state(path, a)
    a.train_step(*batch)
    b = load_train_state(path, PT.Trainer(cfg, generator=torch.Generator().manual_seed(9), device="cpu"))
    assert b.state.step == 1 and b.lr == a.lr and b._bad_epochs == a._bad_epochs and b.history == a.history
    b.train_step(*batch)
    for (k, x), y in zip(PT.train_leaves(a.model).items(), PT.train_leaves(b.model).values()):
        assert torch.equal(x, y), k
    mgr = CheckpointManager(str(tmp_path / "ckpts"), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, a)
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore(PT.Trainer(cfg, device="cpu")).state.step == 2


def test_one_device_dp_trains_as_without_it(tmp_path, monkeypatch):
    """``--dp`` over the one CPU device runs the no-DP path (JAX's mesh of
    one device): the same checkpoint, parameter for parameter. Over two
    devices (the CPU twice) it trains on two gloo ranks, each on its half of
    the same global batches: the epoch loss within 1e-3 (relative, bf16),
    every parameter within 2 * steps * lr of the one-process checkpoint
    (bf16: an element whose near-zero gradient rounds to the other sign
    moves the other way, as the three-step test against the JAX trainer
    allows), and at most 0.5% of them beyond 0.1 lr: 0.024% measured, and
    16% when each rank steps on rank 0's gradient alone (the check
    ``tests/test_torch_parallel.py`` holds at float32)."""
    from playground3d_tpu_torch.apps import train_detector

    argv = ["--depth", "18", "--height", "64", "--width", "96", "--steps", "2", "--steps-per-epoch", "2",
            "--batch", "2", "--zoom", "3", "--device", "cpu"]
    outs, summaries = {}, {}
    for dp in (False, True):
        outs[dp] = str(tmp_path / f"dp{int(dp)}.npz")
        summaries[dp] = train_detector.main(argv + ["--out", outs[dp]] + (["--dp"] if dp else []))
    with np.load(outs[False]) as a, np.load(outs[True]) as b:
        assert a.files == b.files and len(a.files) > 50
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    monkeypatch.setattr(PT, "data_parallel_devices", lambda device: 2)
    two = str(tmp_path / "dp2.npz")
    summary = train_detector.main(argv + ["--out", two, "--dp"])
    assert summary["ranks"] == 2 and summary["steps"] == 2
    assert summary["epochs"][0]["loss"] == pytest.approx(summaries[False]["epochs"][0]["loss"], rel=1e-3)
    with np.load(outs[False]) as a, np.load(two) as b:
        assert a.files == b.files
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=2 * 2 * 1e-4, err_msg=k)
        diff = np.concatenate([np.abs(b[k].astype(np.float64) - a[k]).ravel() for k in a.files])
    assert (diff > 0.1 * 1e-4).mean() <= 0.005


@pytest.mark.parametrize("mode", ["full", "crop"])
def test_train_detector_app_in_process(tmp_path, mode):
    from playground3d_tpu_torch.apps import train_detector
    from playground3d_tpu_torch.models.nn import load_params
    from playground3d_tpu_torch.models.retinanet import forward_raw, retinanet_init

    out = str(tmp_path / f"{mode}.npz")
    argv = ["--depth", "18", "--height", "64", "--width", "96", "--steps", "3", "--steps-per-epoch", "2",
            "--batch", "2", "--zoom", "3", "--device", "cpu", "--out", out]
    if mode == "crop":
        argv += ["--crop", "--crop-size", "32", "--tower-depth", "2", "--shared-tower"]
    summary = train_detector.main(argv)
    assert summary["steps"] == 3 and os.path.exists(out) and summary["prefetch"]["batches"] >= 3
    assert len(summary["epochs"]) == 1 and np.isfinite(summary["epochs"][0]["loss"])
    like = retinanet_init(depth=18, tower_depth=2 if mode == "crop" else 4, shared_tower=mode == "crop",
                          device="cpu")
    model = load_params(out, like)
    hw = (32, 32) if mode == "crop" else (64, 96)
    cls, reg = forward_raw(model, torch.zeros((1,) + hw + (3,), dtype=torch.uint8))
    assert torch.isfinite(cls).all() and torch.isfinite(reg).all()
    again = [str(tmp_path / "again.npz") if a == out else a for a in argv]
    resumed = train_detector.main(again + ["--resume", out, "--steps", "1"])
    assert resumed["steps"] == 1


def test_bf16_weight_gradient_of_a_one_pixel_stride_2_conv_is_finite():
    """The FPN's P6 / P7 convs see 1-pixel maps at small sizes; PyTorch's CPU
    bf16 convolution with implicit padding leaves NaN in such a weight
    gradient at random, so ``Conv`` pads explicitly there (same values)."""
    from playground3d_tpu_torch.models.nn import Conv

    gen = torch.Generator().manual_seed(0)
    conv = Conv(64, 64, 3, bias=True, generator=gen).requires_grad_(True)
    x = torch.randn((2, 64, 1, 3), generator=gen)
    ref = torch.nn.functional.conv2d(x.to(torch.float32), conv.w, conv.b, stride=2, padding=1)
    for _ in range(40):
        conv.zero_grad()
        y = conv(x, stride=2)
        y.float().square().sum().backward()
        assert torch.isfinite(conv.w.grad).all()
    np.testing.assert_allclose(y.float().detach().numpy(), ref.detach().numpy(), rtol=2e-2, atol=2e-1)
