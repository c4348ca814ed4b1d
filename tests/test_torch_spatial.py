"""Spatial partitioning in the PyTorch port (``parallel/mesh.py``:
``make_mesh2``, ``spatial_sharding``, ``shard_spatial``,
``spatial_constrainer``, ``spatial_forward``, ``camera_spatial_forward``;
``parallel/spatial.py``; ``models/retinanet.py::forward_raw(constrain=)``)
against the JAX package on its virtual 8-device CPU mesh
(``tests/conftest.py``), the cases of ``tests/test_parallel.py:64-161``. The
port's meshes list the CPU once a shard (``make_mesh(devices=["cpu"] * 8)``,
``make_mesh2(4, 2, devices=["cpu"] * 8)``).

Tolerances, each with its reason:

* the sharding specs, the placed shards, the shapes each level reaches the
  heads at, and the int8 forward over 4 and 8 slabs: equal. The int8 convs
  accumulate exactly (``ops/qconv.py``'s plain version) and every scale is
  static; the bfloat16 convs of the stem and layer1 (64 input channels,
  not quantized) give the whole frame's bits at these slab widths (8 and
  16 columns; measured). They need not: at 64 columns PyTorch's CPU
  bfloat16 convolution with the pads in the window differs from the
  implicitly padded one in the last bit of 0.007% of its outputs, and the
  int8 roundings carry that to 4% (relative norm) of the heads' outputs,
  so a one-slab line is held to the float32 bound instead.
* the float forwards: both packages in float32 (JAX's default is bfloat16,
  whose last bits differ between the frameworks; PyTorch's CPU bfloat16
  convolution also returns wrong values at stride 2 for an output one
  column wide, which narrow slabs reach), depth 18, s2d, the JAX
  parameters carried by ``models/bridge.py`` with random output convs (so
  that every score and box depends on its pixels). The port's sharded
  forward against its unsharded forward and against JAX's sharded forward:
  within 1e-4 of the largest output (rtol 1e-4), the bound of
  ``tests/test_torch_parallel.py``; measured 3.5e-5 on the sigmoid scores
  and 1.9e-4 on boxes whose largest is 57 (3.3e-6 of it) between the
  port's sharded and unsharded forwards (the slab convolutions add in
  another order than the whole frame's).
* the canary: with the halo columns zeroed or swapped between the sides of
  each window, the sharded forward must miss that bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from playground3d_tpu.models import retinanet as JR
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.parallel import mesh as JM
from playground3d_tpu_torch.models import quant
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.models.nn import Conv, max_pool
from playground3d_tpu_torch.parallel import mesh as PM
from playground3d_tpu_torch.parallel import spatial as PS

torch.set_num_threads(1)

_init = jax.jit(jax_init, static_argnames=("depth", "stem", "num_classes"))
REL = 1e-4


def _random_heads(p, seed=41, std=0.01):
    p = dict(p, heads=dict(p["heads"]))
    rng = np.random.default_rng(seed)
    for name in ("cls_out", "reg_out"):
        w = p["heads"][name]["w"]
        p["heads"][name] = dict(p["heads"][name], w=jnp.asarray(rng.normal(0.0, std, w.shape).astype(np.float32)))
    return p


@pytest.fixture(scope="module")
def nets():
    out = {}
    for stem in ("s2d", "conv7"):
        p = _random_heads(_init(jax.random.PRNGKey(0), depth=18, stem=stem, num_classes=8))
        out[stem] = (p, params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, p), device="cpu"))
    return out


def _close(got, want, rel=REL):
    """Every output within ``rel`` of the largest of its reference; -> the
    largest error relative to that."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale)
        worst = max(worst, float(np.abs(g - w).max() / scale))
    return worst


def _np(outs):
    return [o.float().numpy() if isinstance(o, torch.Tensor) else np.asarray(o, np.float32) for o in outs]


def _jax_mesh2(n0, n1, names):
    return JaxMesh(np.asarray(jax.devices("cpu")[: n0 * n1]).reshape(n0, n1), names)


# ---------------------------------------------------------------------------
# the mesh and the sharding rule
# ---------------------------------------------------------------------------


def test_make_mesh2_shape_and_lines_as_jax():
    mesh = PM.make_mesh2(4, 2, devices=["cpu"] * 8)
    assert mesh.shape == dict(JM.make_mesh2(4, 2, devices=jax.devices("cpu")).shape) == {"data": 4, "space": 2}
    assert mesh.lines("space") == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh.lines("data") == [[0, 2, 4, 6], [1, 3, 5, 7]]
    assert PM.make_mesh(devices=["cpu"] * 3).lines("data") == [[0, 1, 2]]
    with pytest.raises(KeyError):
        mesh.lines("model")
    with pytest.raises(ValueError, match="n_devices"):
        PM.make_mesh2(4, 3, devices=["cpu"] * 8)


SPEC_CASES = [
    # (mesh shape, axis names, frame shape, axis, batch_axis): test_parallel.py's cases and the forwards'
    ((8,), ("data",), (1, 34, 64, 48), "data", None),
    ((8,), ("data",), (1, 33, 67, 48), "data", None),
    ((2, 4), ("data", "model"), (1, 34, 6, 48), "data", None),
    ((2, 4), ("data", "model"), (1, 34, 12, 48), "model", None),
    ((2, 4), ("data", "model"), (1, 34, 7, 48), "data", None),
    ((2, 4), ("data", "model"), (1, 33, 7, 48), "data", None),
    ((4, 2), ("data", "space"), (4, 34, 64, 48), "space", "data"),
    ((4, 2), ("data", "space"), (3, 34, 64, 48), "space", "data"),
    ((4, 2), ("data", "space"), (8, 33, 67, 48), "space", "data"),
]


@pytest.mark.parametrize("dims, names, shape, axis, batch_axis", SPEC_CASES)
def test_spatial_sharding_spec_equals_jax(dims, names, shape, axis, batch_axis):
    if len(dims) == 1:
        jmesh, mesh = JM.make_mesh(8, devices=jax.devices("cpu")), PM.make_mesh(devices=["cpu"] * 8)
    else:
        jmesh, mesh = _jax_mesh2(*dims, names), PM.make_mesh2(*dims, *names, devices=["cpu"] * 8)
    want = JM.spatial_sharding(jmesh, shape, axis, batch_axis).spec
    got = PM.spatial_sharding(mesh, shape, axis, batch_axis)
    assert tuple(got) == tuple(want)
    assert got == PM.P(*want)


@pytest.mark.parametrize("shape", [(1, 34, 64, 48), (1, 32, 7, 48), (1, 33, 7, 48)])
def test_shard_spatial_places_each_device_as_jax(shape):
    """Each mesh device holds JAX's shard: the width split, the height
    where the width does not divide, the whole frame where neither does."""
    x = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    jmesh = JM.make_mesh(8, devices=jax.devices("cpu"))
    js = JM.shard_spatial(jmesh, x)
    want = [np.asarray(next(s.data for s in js.addressable_shards if s.device == d)) for d in jmesh.devices.flat]
    placed = PM.shard_spatial(PM.make_mesh(devices=["cpu"] * 8), x)
    parts = placed.parts if isinstance(placed, PS.Slabs) else (placed,) * 8
    for got, w in zip(parts, want):
        np.testing.assert_array_equal(got.numpy(), w)


def test_camera_shards_place_as_jax():
    x = np.random.default_rng(3).integers(0, 256, (4, 34, 64, 48), dtype=np.uint8)
    jmesh = JM.make_mesh2(4, 2, devices=jax.devices("cpu"))
    js = jax.device_put(x, JM.spatial_sharding(jmesh, x.shape, "space", "data"))
    want = [np.asarray(next(s.data for s in js.addressable_shards if s.device == d)) for d in jmesh.devices.flat]
    groups = PM.shard_spatial(PM.make_mesh2(4, 2, devices=["cpu"] * 8), x, "space", "data")
    assert len(groups) == 4 and all(isinstance(g, PS.Slabs) and g.shape == (1, 34, 64, 48) for g in groups)
    for got, w in zip([p for g in groups for p in g.parts], want):
        np.testing.assert_array_equal(got.numpy(), w)


@pytest.mark.parametrize("min_level", [3, 5])
def test_forward_raw_constrains_each_level_as_jax(nets, min_level):
    """``constrain`` sees each pyramid level the heads run on, in order, at
    JAX's shapes (NHWC there, NCHW here)."""
    p, model = nets["s2d"]
    x = np.random.default_rng(2).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8)
    seen_j, seen_p = [], []
    JR.forward_raw(p, jnp.asarray(x), depth=18, stem="s2d", dtype=jnp.float32, min_level=min_level,
                   constrain=lambda f: seen_j.append(f.shape) or f)
    PR.forward_raw(model, torch.as_tensor(x), dtype=torch.float32, min_level=min_level,
                   constrain=lambda f: seen_p.append(tuple(f.permute(0, 2, 3, 1).shape)) or f)
    assert seen_p == [tuple(s) for s in seen_j] and len(seen_p) == 8 - min_level


def test_constrainer_keeps_divisible_slabs_and_gathers_the_rest(nets, monkeypatch):
    """JAX's rule for the levels, kept by the slab ops: over 8 slabs of the
    (1,34,64,48) frame, P3-P5 (32, 16 and 8 columns) reach the constrainer
    split and P6 and P7 (4 and 2) whole, and the constrainer passes each on
    as it is. The slabs are joined 7 times: P6's conv gathers C5 once, and
    the heads' two reshapes into anchors gather each split level."""
    _, model = nets["s2d"]
    real, seen = PM.spatial_constrainer, []

    def recording(*a):
        cons = real(*a)
        return lambda f: seen.append((f, cons(f))) or cons(f)

    monkeypatch.setattr(PM, "spatial_constrainer", recording)
    x = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8))
    PS.HALO.update(joins=0)
    PM.spatial_forward(PM.make_mesh(devices=["cpu"] * 8), dtype=torch.float32)(model, x)
    assert [(type(f).__name__, f.shape[3]) for f, _ in seen] == [("Slabs", 32), ("Slabs", 16), ("Slabs", 8),
                                                                ("Tensor", 4), ("Tensor", 2)]
    assert all(out is f for f, out in seen)
    assert PS.HALO["joins"] == 7
    with pytest.raises(KeyError):
        real(PM.make_mesh(devices=["cpu"] * 4), "space")


@pytest.mark.parametrize("op", ["contiguous", "float", "F.relu", "torch.exp", "to_device", "mismatched_add"])
def test_an_op_that_is_not_a_slab_op_raises(op):
    """An op the slabs do not list would gather them onto the lead and run
    the rest of the forward whole there: it raises instead."""
    import torch.nn.functional as F

    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).reshape(2, 3, 4, 8)
    s = PS.place(x, 3, PS.Line(["cpu"] * 4))
    calls = {"contiguous": lambda: s.contiguous(), "float": lambda: s.float(), "F.relu": lambda: F.relu(s),
             "torch.exp": lambda: torch.exp(s), "to_device": lambda: s.to("cpu"),
             "mismatched_add": lambda: s + PS.place(x, 3, PS.Line(["cpu"] * 2))}
    PS.HALO.update(joins=0)
    with pytest.raises(TypeError, match="no operation on slabs"):
        calls[op]()
    assert PS.HALO["joins"] == 0
    assert torch.equal(s.reshape(2, -1), x.reshape(2, -1)) and PS.HALO["joins"] == 1  # the one op that gathers


# ---------------------------------------------------------------------------
# the forwards (tests/test_parallel.py:64-161)
# ---------------------------------------------------------------------------


def test_width_sharded_forward_matches_unsharded_and_jax(nets):
    p, model = nets["s2d"]
    x = np.random.default_rng(2).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8)
    mesh = PM.make_mesh(devices=["cpu"] * 8)
    xs = PM.shard_spatial(mesh, x)
    assert isinstance(xs, PS.Slabs) and [tuple(s.shape) for s in xs.parts] == [(1, 34, 8, 48)] * 8
    PS.HALO.update(bytes=0, copies=0)
    got = _np(PM.spatial_forward(mesh, 18, stem="s2d", dtype=torch.float32)(model, xs))
    assert PS.HALO["copies"] > 0
    whole = _np(PR.forward_raw(model, torch.as_tensor(x), dtype=torch.float32))
    jfwd = JM.spatial_forward(JM.make_mesh(8, devices=jax.devices("cpu")), 18, stem="s2d", dtype=jnp.float32)
    theirs = _np(jax.tree_util.tree_leaves(jfwd(p, JM.shard_spatial(JM.make_mesh(8, devices=jax.devices("cpu")),
                                                                      x))))
    assert [g.shape for g in got] == [(1, 6696, 8), (1, 6696, 12)]
    _close(got, whole)
    _close(got, theirs)
    # the frame whole: placed by the forward itself
    _close(_np(PM.spatial_forward(mesh, dtype=torch.float32)(model, torch.as_tensor(x))), whole)


def test_each_slab_runs_the_copy_of_its_device(nets):
    """Given one model copy a mesh device (as ``replicate`` makes them on
    distinct cards), slab i runs copy i's modules and buffers: equal copies
    give the unsharded forward, and a copy whose stem differs changes the
    output."""
    import copy

    _, model = nets["s2d"]
    x = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8))
    mesh = PM.make_mesh(devices=["cpu"] * 4)
    fwd = PM.spatial_forward(mesh, dtype=torch.float32)
    copies = [model] + [copy.deepcopy(model) for _ in range(3)]
    whole = _np(PR.forward_raw(model, x, dtype=torch.float32))
    _close(_np(fwd(copies, x)), whole)
    with torch.no_grad():
        copies[2].backbone.conv1.w.mul_(0.5)
    with pytest.raises(AssertionError):
        _close(_np(fwd(copies, x)), whole)
    with pytest.raises(ValueError, match="copies"):
        fwd(copies[:3], x)


@pytest.mark.parametrize("cameras", [1, 2])
def test_a_one_shard_line_is_the_unsharded_forward(nets, cameras):
    """One slab holds each frame (a 1-device mesh, or a 2 x 1 camera x space
    mesh): every window is the frame with its "SAME" pads on both sides,
    and the outputs are the unsharded ones."""
    _, model = nets["s2d"]
    x = torch.as_tensor(np.random.default_rng(6).integers(0, 256, (cameras, 34, 64, 48), dtype=np.uint8))
    if cameras == 1:
        got = PM.spatial_forward(PM.make_mesh(devices=["cpu"]), dtype=torch.float32)(model, x)
    else:
        got = PM.camera_spatial_forward(PM.make_mesh2(2, 1, devices=["cpu"] * 2), dtype=torch.float32)(model, x)
    _close(_np(got), _np(PR.forward_raw(model, x, dtype=torch.float32)))


def test_camera_spatial_forward_matches_unsharded_and_jax(nets):
    p, model = nets["s2d"]
    x = np.random.default_rng(3).integers(0, 256, (4, 34, 64, 48), dtype=np.uint8)
    mesh = PM.make_mesh2(4, 2, devices=["cpu"] * 8)
    got = _np(PM.camera_spatial_forward(mesh, 18, stem="s2d", dtype=torch.float32)(model, x))
    whole = _np(PR.forward_raw(model, torch.as_tensor(x), dtype=torch.float32))
    jmesh = JM.make_mesh2(4, 2, devices=jax.devices("cpu"))
    jx = jax.device_put(x, JM.spatial_sharding(jmesh, x.shape, "space", "data"))
    theirs = _np(jax.tree_util.tree_leaves(JM.camera_spatial_forward(jmesh, 18, stem="s2d",
                                                                     dtype=jnp.float32)(p, jx)))
    assert got[0].shape == (4, 6696, 8)
    _close(got, whole)
    _close(got, theirs)


def test_conv7_stem_and_its_max_pool_run_on_slabs(nets, monkeypatch):
    """The 7x7/2 stem conv and the 3x3/2 max pool exchange halos (-inf
    outside the frame for the pool) and give the unsharded forward."""
    _, model = nets["conv7"]
    pools = []
    monkeypatch.setitem(PS._SPLIT, max_pool, lambda x, *a: pools.append(x.width) or PS._max_pool(x, *a))
    x = torch.as_tensor(np.random.default_rng(4).integers(0, 256, (1, 34, 64, 3), dtype=np.uint8))
    got = PM.spatial_forward(PM.make_mesh(devices=["cpu"] * 8), stem="conv7", dtype=torch.float32)(model, x)
    assert pools == [4]  # the stem's 32 columns, 4 a slab
    _close(_np(got), _np(PR.forward_raw(model, x, dtype=torch.float32)))


@pytest.mark.parametrize("k, stride, width, n", [(7, 2, 16, 8), (3, 2, 16, 8), (3, 1, 8, 8), (3, 2, 24, 4)])
def test_a_halo_wider_than_a_slab(k, stride, width, n):
    """Windows that reach past the neighbouring slab (7x7/2 on slabs 2
    wide: 2 columns to the left, 3 to the right) or a conv on 1-column
    slabs give the whole frame's conv and max pool."""
    g = torch.Generator().manual_seed(k * 100 + width)
    conv = Conv(16, 8, k, bias=True, generator=g).requires_grad_(False)
    x = torch.randn((1, 16, 9, width), generator=g).to(memory_format=torch.channels_last)
    xs = PS.place(x.permute(0, 2, 3, 1), 2, PS.Line(["cpu"] * n)).permute(0, 3, 1, 2)
    PS.HALO.update(bytes=0, copies=0)
    got = conv(xs, stride, torch.float32)
    assert isinstance(got, PS.Slabs) and got.width == -(-width // stride) // n
    np.testing.assert_allclose(got.join().numpy(), conv(x, stride, torch.float32).numpy(), rtol=1e-5, atol=1e-5)
    assert PS.HALO["copies"] > (2 * n if k == 7 else 0)  # 7x7/2: more than two neighbours' pieces a window
    np.testing.assert_array_equal(PS._joined(PS._max_pool(xs, 3, 2)).numpy(), max_pool(x, 3, 2).numpy())


@pytest.mark.parametrize("n", [4, 8])
def test_int8_detector_sharded_equals_unsharded(nets, n, monkeypatch):
    """The quantized detector (chained int8 backbone and heads, int8 FPN)
    on slabs: the int8 halos, the explicit pads of ``qconv``, the block
    tails in the last conv's epilogue; equal to the unsharded forward."""
    _, model = nets["s2d"]
    x = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8))
    qm = quant.quantize_detector(model, [x])
    calls = []
    monkeypatch.setitem(PS._SPLIT, quant._qconv_nchw,
                        lambda *a, **k: calls.append(a[2].dtype) or PS._qconv(*a, **k))
    mesh = PM.make_mesh(devices=["cpu"] * n)
    for kw in (dict(compact=True), dict(compact=True, score_path=True), dict()):
        got = PM.spatial_forward(mesh, **kw)(qm, x)
        want = PR.forward_raw(qm, x, **kw)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert calls and set(calls) == {torch.int8}


@pytest.mark.parametrize("mesh", ["2", "4", "2x2"])
def test_int8_detector_quantizes_each_element_once_on_slabs(nets, mesh, monkeypatch):
    """The quantized detector's quantize steps on slabs quantize, over all
    slabs, as many elements as the unsharded forward, each call on a plain
    tensor (one kernel launch a slab on the card); ``chip_smoke.py``'s
    spatial phase holds the card's launches to the same count."""
    _, model = nets["s2d"]
    x = torch.as_tensor(np.random.default_rng(5).integers(0, 256, (2, 34, 64, 48), dtype=np.uint8))
    qm = quant.quantize_detector(model, [x[:1]])
    seen = []
    real = quant.quantize
    monkeypatch.setattr(quant, "quantize", lambda t, s: seen.append((type(t), t.numel())) or real(t, s))
    if mesh == "2x2":
        frames, fwd = x, PM.camera_spatial_forward(PM.make_mesh2(2, 2, devices=["cpu"] * 4), compact=True)
    else:
        frames, fwd = x[:1], PM.spatial_forward(PM.make_mesh(devices=["cpu"] * int(mesh)), compact=True)
    PR.forward_raw(qm, frames, compact=True)
    whole, calls = sum(n for _, n in seen), len(seen)
    seen.clear()
    fwd(qm, frames)
    assert {t for t, _ in seen} == {torch.Tensor} and sum(n for _, n in seen) == whole and len(seen) > calls


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_act_runs_slab_by_slab(n, dtype, monkeypatch):
    """The int8 quantize step on slabs is one call a slab, each on its
    slab's device with its copy of the scale (on the card one kernel launch
    a slab), gathers nothing, and equals the whole tensor's."""
    gen = torch.Generator().manual_seed(4)
    x = (torch.randn(2, 16, 6, 32, generator=gen) * 3).to(dtype).contiguous(memory_format=torch.channels_last)
    xs = torch.tensor(0.0213)
    s = PS.place(x, 3, PS.Line(["cpu"] * n))
    seen = []
    real = quant.quantize
    monkeypatch.setattr(quant, "quantize", lambda t, scale: seen.append((type(t), tuple(t.shape), scale)) or
                        real(t, scale))
    PS.HALO.update(joins=0, copies=0)
    got = quant._quantize_act(s, xs)
    assert isinstance(got, PS.Slabs) and got.dtype == torch.int8 and (got.sdim, got.size) == (3, 32)
    assert PS.HALO["joins"] == 0 and PS.HALO["copies"] == 0
    assert [(t, shape) for t, shape, _ in seen] == [(torch.Tensor, (2, 16, 6, 32 // n))] * n
    assert all(scale is xs for _, _, scale in seen)
    assert torch.equal(got.join(), quant._quantize_act(x, xs))


@pytest.mark.parametrize("corrupt", ["zeroed", "swapped"])
def test_canary_broken_halos_miss_the_bound(nets, monkeypatch, corrupt):
    _, model = nets["s2d"]
    x = torch.as_tensor(np.random.default_rng(2).integers(0, 256, (1, 34, 64, 48), dtype=np.uint8))
    window = PS._window

    def broken(src, d, line, i, lo, hi, fill=None):
        w = window(src, d, line, i, lo, hi, fill)
        if not isinstance(src, PS.Slabs):
            return w
        left, right = max(0, i * src.width - lo), max(0, hi - (i + 1) * src.width)
        if corrupt == "zeroed":
            for at, n in ((0, left), (w.shape[d] - right, right)):
                if n:
                    w.narrow(d, at, n).zero_()
        elif left == right and left:
            a, b = w.narrow(d, 0, left).clone(), w.narrow(d, w.shape[d] - right, right).clone()
            w.narrow(d, 0, left).copy_(b)
            w.narrow(d, w.shape[d] - right, right).copy_(a)
        return w

    monkeypatch.setattr(PS, "_window", broken)
    got = _np(PM.spatial_forward(PM.make_mesh(devices=["cpu"] * 8), dtype=torch.float32)(model, x))
    with pytest.raises(AssertionError):
        _close(got, _np(PR.forward_raw(model, x, dtype=torch.float32)))
