"""int8 post-training quantization of the PyTorch port (``models/quant.py``,
``ops/qconv.py``; plain versions on the CPU) against the JAX package.

What is held to what:

* ``quantize_backbone`` / ``quantize_tail`` from the same float weights and
  the same calibration vector: ``wq`` equal, ``ws`` and ``xs`` to 1e-6
  relative; the same convs quantize (at least 128 input channels).
* one ``_chain_qconv`` and one ``_chain_qconv_b`` on the same int8 input and
  a bridged tree: int32 accumulators equal; int8 outputs equal except at
  counted ties (XLA's CPU code contracts ``acc * scale + offset`` into a
  multiply-add, the port rounds the product first: at most 1e-3 of the values
  may differ, by one step); bfloat16 outputs likewise within one bfloat16 ulp.
* the chained backbone block by block, each block fed the JAX package's own
  block input: every int8 tensor equal, every bfloat16 tensor equal except
  at most 2e-3 of its values by one bfloat16 ulp (the convs that stay
  bfloat16, the stem and the 64-wide ones, sum in another order).
* whole int8 paths (``resnet_apply_int8``, ``resnet_apply_int8_chained``,
  ``head_apply_int8_chained``, ``forward_raw``) on a bridged quantized tree,
  end to end: mean |difference| over mean |value| below 0.08, the bound the
  JAX package's own tests put between its two int8 paths. It cannot be much
  tighter: requantization turns one bfloat16 ulp of difference in layer1 into
  whole int8 steps, each step flips a few roundings in the next conv's
  output, and after a few convs the two runs differ at the level of the
  quantization noise itself (measured here: 0.004 at C3, 0.03 at C5) although
  every block agrees exactly on equal inputs.
* ``quantize_detector`` run in the port from the same calibration batch:
  the same convs quantize, ``wq`` of backbone convs equal, every ``xs`` within
  5% of JAX's (a maximum over bfloat16 activations of the float forward).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playground3d_tpu.models import quant as JQ
from playground3d_tpu.models import retinanet as JR
from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.fpn import fpn_apply as jax_fpn_apply
from playground3d_tpu.models.resnet import resnet_apply as jax_resnet_apply
from playground3d_tpu_torch.models import quant as PQ
from playground3d_tpu_torch.models import retinanet as PR
from playground3d_tpu_torch.models.bridge import params_from_jax_numpy
from playground3d_tpu_torch.models.nn import Conv, FrozenBN
from playground3d_tpu_torch.ops import qconv as QC

torch.set_num_threads(1)

PATH_TOL = 0.08
_init = jax.jit(jax_init, static_argnames=("depth", "stem", "tower_depth", "shared_tower", "feature_size"))


def _np_tree(p):
    return jax.tree_util.tree_map(lambda a: None if a is None else np.asarray(a), p,
                                  is_leaf=lambda a: a is None)


def _bridge(p):
    return params_from_jax_numpy(_np_tree(p), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-6))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).to(torch.float32).numpy()


def _float_params(seed, depth, stem, shared=False, tower_depth=2):
    """A random detector whose output convs are non-zero, so the heads carry
    the backbone's signal."""
    rng = np.random.default_rng(seed)
    p = _init(jax.random.PRNGKey(seed), depth=depth, stem=stem, tower_depth=tower_depth, shared_tower=shared)
    for k in ("cls_out", "reg_out"):
        w = p["heads"][k]["w"]
        p["heads"][k]["w"] = jnp.asarray(rng.normal(0, 0.02, w.shape).astype(np.float32))
    return p


@pytest.fixture(scope="module")
def quantized():
    """depth -> (JAX quantized tree, its bridged twin), quantized by the JAX
    package from one uint8 s2d calibration frame."""
    out = {}
    for depth, stem, shared in ((18, "s2d", True), (50, "s2d", False), (18, "conv7", False)):
        p = _float_params(depth, depth, stem, shared)
        rng = np.random.default_rng(depth)
        shape = (1, 16, 24, 48) if stem == "s2d" else (1, 64, 96, 3)
        calib = rng.integers(0, 256, shape, dtype=np.uint8)
        qj = JQ.quantize_detector(p, calib, depth, stem=stem)
        out[(depth, stem)] = (p, qj, _bridge(qj), calib)
    return out


# ---- quantizing --------------------------------------------------------------


@pytest.mark.parametrize("depth", [18, 50])
def test_quantize_backbone_equals_jax(depth):
    p = _float_params(1, depth, "s2d")["backbone"]
    n = len(list(JQ._iter_conv_bn(p, depth)))
    absmax = np.random.default_rng(2).uniform(0.5, 9.0, n).astype(np.float32)
    qj = JQ.quantize_backbone(p, jnp.asarray(absmax), depth)
    m = _bridge({"backbone": p, **{k: v for k, v in _float_params(1, depth, "s2d").items() if k != "backbone"}})
    qp = PQ.quantize_backbone(m.backbone, torch.as_tensor(absmax))
    assert not PQ.is_quantized(m.backbone) and PQ.is_quantized(qp)
    pairs = list(zip(JQ._iter_conv_bn(qj, depth), PQ._iter_conv_bn(qp)))
    assert len(pairs) == n
    n_q = 0
    for (pc, _), (conv, _) in pairs:
        assert ("wq" in pc) == (conv.wq is not None) == (pc["w"].shape[2] >= 128)
        if conv.wq is None:
            continue
        n_q += 1
        np.testing.assert_array_equal(conv.wq.numpy(), np.asarray(pc["wq"]).transpose(3, 0, 1, 2))
        np.testing.assert_allclose(conv.ws.numpy(), np.asarray(pc["ws"]), rtol=1e-6)
        np.testing.assert_allclose(conv.xs.numpy(), np.asarray(pc["xs"]), rtol=1e-6)
    # the stem and the 64-input convs stay float, the chain starts inside layer1
    assert qp.conv1.wq is None and qp.layer1[0].conv1.wq is None
    if depth == 50:
        assert qp.layer1[1].conv1.wq is not None and qp.layer1[1].conv2.wq is None
    assert n_q > 0
    with pytest.raises(ValueError, match="calibration length"):
        PQ.quantize_backbone(m.backbone, torch.ones(3))


@pytest.mark.parametrize("shared,quant_outputs", [(False, True), (True, True), (False, False)])
def test_quantize_tail_equals_jax(shared, quant_outputs):
    p = _float_params(3, 18, "s2d", shared)
    n = len(list(JQ._iter_tail_convs(p)))
    absmax = np.random.default_rng(4).uniform(0.5, 9.0, n).astype(np.float32)
    qj = JQ.quantize_tail(p, jnp.asarray(absmax), quant_outputs=quant_outputs)
    m = _bridge(p)
    qp = PQ.quantize_tail(m, torch.as_tensor(absmax), quant_outputs=quant_outputs)
    assert not PQ.is_quantized(m.fpn) and PQ.is_quantized(qp["fpn"]) and PQ.is_quantized(qp["heads"])
    convs = list(PQ._iter_tail_convs(qp["fpn"], qp["heads"]))
    assert len(convs) == n == (8 + (2 if shared else 4) + 2)
    for pc, conv in zip(JQ._iter_tail_convs(qj), convs):
        assert ("wq" in pc) == (conv.wq is not None)
        if conv.wq is not None:
            np.testing.assert_array_equal(conv.wq.numpy(), np.asarray(pc["wq"]).transpose(3, 0, 1, 2))
            np.testing.assert_allclose(conv.ws.numpy(), np.asarray(pc["ws"]), rtol=1e-6)
            np.testing.assert_allclose(conv.xs.numpy(), np.asarray(pc["xs"]), rtol=1e-6)
    assert (qp["heads"].cls_out.wq is not None) == quant_outputs


def test_zero_weights_quantize_to_zero():
    """The focal-prior output convs: wq = 0 with ws = eps / 127, so equal
    logits stay equal."""
    conv = Conv(128, 72, 3, bias=True)
    with torch.no_grad():
        conv.w.zero_()
    PQ._quantize_conv_(conv, torch.tensor(3.0))
    assert int(conv.wq.abs().max()) == 0 and float(conv.ws.max()) == pytest.approx(1e-8 / 127)


# ---- one conv ------------------------------------------------------------------


def _one_conv(seed, cin, cout, k):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.05, (k, k, cin, cout)).astype(np.float32)
    ws = (np.maximum(np.abs(w).max((0, 1, 2)), 1e-8) / 127).astype(np.float32)
    wq = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
    b = rng.normal(0, 0.3, cout).astype(np.float32)
    bn = dict(scale=rng.uniform(0.5, 1.5, cout), offset=rng.normal(0, 0.3, cout),
              mean=rng.normal(0, 0.3, cout), var=rng.uniform(0.5, 2.0, cout))
    bn = {name: v.astype(np.float32) for name, v in bn.items()}
    pc = dict(w=jnp.asarray(w), wq=jnp.asarray(wq), ws=jnp.asarray(ws), xs=jnp.asarray(np.float32(0.0371)),
              b=jnp.asarray(b))
    conv = Conv(cin, cout, k, bias=True)
    conv.wq = torch.tensor(wq.transpose(3, 0, 1, 2).copy())
    conv.ws, conv.xs = torch.tensor(ws), torch.tensor(np.float32(0.0371))
    conv.b.data = torch.tensor(b)
    fbn = FrozenBN(cout)
    for name, v in bn.items():
        getattr(fbn, name).copy_(torch.tensor(v))
    return pc, {name: jnp.asarray(v) for name, v in bn.items()}, conv, fbn, wq


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (128, 72, 3, 1, (9, 13)), (256, 64, 1, 2, (9, 13)), (512, 108, 3, 2, (8, 12)), (128, 128, 1, 1, (5, 7)),
])
def test_chain_qconv_matches_jax_on_the_same_integers(cin, cout, k, stride, hw):
    pc, pbn, conv, fbn, wq = _one_conv(cin + k, cin, cout, k)
    rng = np.random.default_rng(cout)
    xq = rng.integers(-127, 128, (2,) + hw + (cin,)).astype(np.int8)
    s_in, emit = np.float32(0.0291), np.float32(0.0913)

    acc_j = jax.lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    acc_p = QC.conv_int32_plain(torch.tensor(xq), conv.wq, stride)
    assert acc_p.dtype == torch.int32
    np.testing.assert_array_equal(acc_p.numpy(), np.asarray(acc_j))

    cur_p = ("i8", torch.tensor(xq).permute(0, 3, 1, 2), torch.tensor(s_in))
    n_ties = 0
    for relu in (False, True):
        for em in (None, emit):
            jem = None if em is None else jnp.asarray(em)
            pem = None if em is None else torch.tensor(em)

            def jbn(pc, pbn, x):
                return JQ._chain_qconv(pc, pbn, ("i8", x, jnp.asarray(s_in)), stride, relu, jem)[1]

            def jb(pc, x):
                return JQ._chain_qconv_b(pc, ("i8", x, jnp.asarray(s_in)), stride, relu, jem)[1]

            want_bn = np.asarray(jax.jit(jbn)(pc, pbn, jnp.asarray(xq)).astype(jnp.float32))
            want_b = np.asarray(jax.jit(jb)(pc, jnp.asarray(xq)).astype(jnp.float32))
            got_bn = PQ._chain_qconv(conv, fbn, cur_p, stride, relu, pem)
            got_b = PQ._chain_qconv_b(conv, cur_p, stride, relu, pem)
            for got, want in ((got_bn, want_bn), (got_b, want_b)):
                assert got[0] == ("f" if em is None else "i8")
                assert got[1].dtype == (torch.bfloat16 if em is None else torch.int8)
                g = _nhwc(got[1])
                neq = g != want
                n_ties += int(neq.sum())
                assert neq.mean() <= 1e-3
                if em is None:  # within one bfloat16 ulp
                    np.testing.assert_allclose(g, want, rtol=2.0 ** -7, atol=0)
                else:
                    assert np.abs(g - want).max() <= 1
    print(f"values off at ties: {n_ties}")


def test_hook_units_match_jax():
    """quant_conv_bn / quant_conv: float in, quantized at the conv's own xs."""
    pc, pbn, conv, fbn, _ = _one_conv(9, 128, 40, 3)
    x = np.random.default_rng(10).normal(0, 2.0, (1, 7, 9, 128)).astype(np.float32)
    xt = torch.tensor(x).permute(0, 3, 1, 2)
    for relu in (False, True):
        want = np.asarray(JQ.quant_conv_bn(pc, pbn, jnp.asarray(x), 1, relu).astype(jnp.float32))
        got = _nhwc(PQ.quant_conv_bn(conv, fbn, xt, 1, relu))
        assert (got != want).mean() <= 1e-3
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    want = np.asarray(JQ.quant_conv(pc, jnp.asarray(x), 2).astype(jnp.float32))
    got = _nhwc(PQ.quant_conv(conv, xt, 2))
    assert (got != want).mean() <= 1e-3
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    # a conv that is not quantized falls through to the float conv
    plain = Conv(16, 8, 3, bias=True)
    y = PQ.quant_conv(plain, torch.zeros((1, 16, 5, 5)))
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (1, 8, 5, 5)


# ---- whole paths on a bridged quantized tree -----------------------------------


@pytest.mark.parametrize("key", [(18, "s2d"), (50, "s2d"), (18, "conv7")], ids=str)
def test_backbone_paths_match_jax(quantized, key):
    depth, stem = key
    _, qj, mb, _ = quantized[key]
    shape = (2, 16, 24, 48) if stem == "s2d" else (2, 64, 96, 3)
    x = np.random.default_rng(11).normal(0, 1, shape).astype(np.float32)
    chain_j = JQ.resnet_apply_int8_chained(qj["backbone"], jnp.asarray(x), depth, stem=stem)
    chain_p = PQ.resnet_apply_int8_chained(mb.backbone, torch.as_tensor(x))
    hook_j = JQ.resnet_apply_int8(qj["backbone"], jnp.asarray(x), depth, stem=stem)
    hook_p = PQ.resnet_apply_int8(mb.backbone, torch.as_tensor(x))
    for name, got, want in (("chained", chain_p, chain_j), ("hook", hook_p, hook_j)):
        for level, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == torch.bfloat16
            rel = _rel(_nhwc(g), np.asarray(w.astype(jnp.float32)))
            print(f"{name} C{level + 3}: rel {rel:.5f}")
            assert rel < PATH_TOL, (name, level, rel)


def test_chained_blocks_equal_jax_on_the_same_block_inputs(quantized):
    """ResNet-18, s2d stem: stem and each block of the chain, the port fed
    what the JAX chain fed its own block."""
    _, qj, mb, _ = quantized[(18, "s2d")]
    bj, bp = qj["backbone"], mb.backbone
    x = np.random.default_rng(11).normal(0, 1, (2, 16, 24, 48)).astype(np.float32)

    def to_port(cur):
        t = torch.tensor(np.asarray(cur[1].astype(jnp.float32))).permute(0, 3, 1, 2)
        if cur[0] == "f":
            return ("f", t.to(torch.bfloat16))
        return ("i8", t.to(torch.int8), torch.tensor(np.asarray(cur[2])))

    def check(name, cur_j, cur_p):
        assert cur_j[0] == cur_p[0], name
        want, got = np.asarray(cur_j[1].astype(jnp.float32)), _nhwc(cur_p[1])
        if cur_j[0] == "i8":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert (got != want).mean() <= 2e-3, name
            # one bfloat16 ulp of the larger operand of the residual add
            np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2.0 ** -5, err_msg=name)

    cur_j = JQ._chain_qconv(bj["conv1"], bj["bn1"], ("f", jnp.asarray(x)), 1, True, None)
    check("stem", cur_j, PQ._chain_qconv(bp.conv1, bp.bn1, ("f", torch.tensor(x).permute(0, 3, 1, 2)), 1, True, None))
    stages_j = [bj[f"layer{i + 1}"] for i in range(4)]
    stages_p = [getattr(bp, f"layer{i + 1}") for i in range(4)]
    kinds = []
    for si in range(4):
        for bi, (blj, blp) in enumerate(zip(stages_j[si], stages_p[si])):
            nxt = (si, bi + 1) if bi + 1 < len(stages_j[si]) else ((1, 0) if si == 0 else None)
            out_j = JQ._xs_of(stages_j[nxt[0]][nxt[1]]["conv1"]) if nxt else None
            out_p = PQ._xs_of(stages_p[nxt[0]][nxt[1]].conv1) if nxt else None
            stride = 2 if si > 0 and bi == 0 else 1

            def block(Q, conv, cur, out_xs, relu):
                h = Q._chain_qconv(*conv("conv1", "bn1"), cur, stride, True, Q._xs_of(conv("conv2", "bn2")[0]))
                hf = Q._chain_f(Q._chain_qconv(*conv("conv2", "bn2"), h, 1, False, None))
                down = conv("down_conv", "down_bn")
                res = Q._chain_f(Q._chain_qconv(*down, cur, stride, False, None) if down[0] is not None else cur)
                return h, Q._chain_requant(relu(hf + res), out_xs)

            h_j, new_j = block(JQ, lambda c, b: (blj.get(c), blj.get(b)), cur_j, out_j, jax.nn.relu)
            # the port's own block: its tail fused into conv2's epilogue where conv2 is quantized
            h_p = PQ._chain_qconv(blp.conv1, blp.bn1, to_port(cur_j), stride, True, PQ._xs_of(blp.conv2))
            new_p = PQ._chain_block(blp, to_port(cur_j), out_p, basic=True)
            check(f"layer{si + 1}.{bi} conv1", h_j, h_p)
            check(f"layer{si + 1}.{bi} out", new_j, new_p)
            kinds.append(new_j[0])
            cur_j = new_j
    assert "i8" in kinds and "f" in kinds


def test_chained_bottlenecks_equal_jax_on_the_same_block_inputs(quantized):
    """ResNet-50, s2d stem: each bottleneck of the port's chain (the tail
    fused into conv3's epilogue from layer2 on) fed what the JAX chain fed
    its own block, and the same block through the unfused tail. Fused and
    unfused are equal bit for bit. Against JAX the int8 outputs differ by at
    most one step at under 1% of the values: the ties of XLA's contracted
    ``acc * scale + offset`` (see the one-conv test) in conv1 and conv2 move
    a few int8 inputs of the next conv within the block (measured: at most
    0.25% in layer2.2, 0 from layer3 on); the bfloat16 outputs that such a
    step reaches differ by its weight (mean relative difference below 1e-3)."""
    _, qj, mb, _ = quantized[(50, "s2d")]
    bj, bp = qj["backbone"], mb.backbone
    x = np.random.default_rng(17).normal(0, 1, (2, 16, 24, 48)).astype(np.float32)

    def to_port(cur):
        t = torch.tensor(np.asarray(cur[1].astype(jnp.float32))).permute(0, 3, 1, 2)
        if cur[0] == "f":
            return ("f", t.to(torch.bfloat16))
        return ("i8", t.to(torch.int8), torch.tensor(np.asarray(cur[2])))

    cur_j = JQ._chain_qconv(bj["conv1"], bj["bn1"], ("f", jnp.asarray(x)), 1, True, None)
    stages_j = [bj[f"layer{i + 1}"] for i in range(4)]
    stages_p = [getattr(bp, f"layer{i + 1}") for i in range(4)]
    fused = 0
    for si in range(4):
        for bi, (blj, blp) in enumerate(zip(stages_j[si], stages_p[si])):
            nxt = (si, bi + 1) if bi + 1 < len(stages_j[si]) else ((1, 0) if si == 0 else None)
            out_j = JQ._xs_of(stages_j[nxt[0]][nxt[1]]["conv1"]) if nxt else None
            out_p = PQ._xs_of(stages_p[nxt[0]][nxt[1]].conv1) if nxt else None
            stride = 2 if si > 0 and bi == 0 else 1
            h = JQ._chain_qconv(blj["conv1"], blj["bn1"], cur_j, 1, True, JQ._xs_of(blj["conv2"]))
            h = JQ._chain_qconv(blj["conv2"], blj["bn2"], h, stride, True, JQ._xs_of(blj["conv3"]))
            hf = JQ._chain_f(JQ._chain_qconv(blj["conv3"], blj["bn3"], h, 1, False, None))
            if "down_conv" in blj:
                res = JQ._chain_f(JQ._chain_qconv(blj["down_conv"], blj["down_bn"], cur_j, stride, False, None))
            else:
                res = JQ._chain_f(cur_j)
            new_j = JQ._chain_requant(jax.nn.relu(hf + res), out_j)
            cur_p = to_port(cur_j)
            new_p = PQ._chain_block(blp, cur_p, out_p, basic=False)
            unfused = PQ._chain_block_unfused(blp, cur_p, out_p, basic=False)
            fused += blp.conv3.wq is not None
            name = f"layer{si + 1}.{bi}"
            assert new_j[0] == new_p[0] == unfused[0], name
            assert torch.equal(new_p[1], unfused[1]), name
            want, got = np.asarray(new_j[1].astype(jnp.float32)), _nhwc(new_p[1])
            assert (got != want).mean() < 1e-2, name
            if new_j[0] == "i8":
                assert np.abs(got - want).max() <= 1, name
            else:  # where an int8 input of conv3 moved by a step, its output moves by that step's weight
                assert _rel(got, want) < 1e-3, name
            cur_j = new_j
    assert fused == 13  # every block but layer1's three


@pytest.mark.parametrize("key,score_path", [((18, "s2d"), False), ((18, "s2d"), True), ((50, "s2d"), True)], ids=str)
def test_chained_heads_match_jax(quantized, key, score_path):
    """Shared tower (ResNet-18 tree) and separate towers (ResNet-50 tree) on
    the same float pyramid."""
    depth, stem = key
    p, qj, mb, _ = quantized[key]
    x = np.random.default_rng(12).normal(0, 1, (1, 32, 48, 48)).astype(np.float32)
    c3, c4, c5 = jax_resnet_apply(p["backbone"], jnp.asarray(x), depth, jnp.float32, stem)
    feats = jax_fpn_apply(p["fpn"], c3, c4, c5, jnp.bfloat16)
    want = JQ.head_apply_int8_chained(qj["heads"], feats, 8, score_path=score_path)
    feats_p = [torch.tensor(np.asarray(f.astype(jnp.float32))).permute(0, 3, 1, 2).to(torch.bfloat16) for f in feats]
    got = PQ.head_apply_int8_chained(mb.heads, feats_p, score_path=score_path)
    assert len(got) == len(want) == (3 if score_path else 2)
    for i, (g, w) in enumerate(zip(got, want)):
        if score_path and i == 1:
            assert g.dtype == torch.int32
            assert (g.numpy() == np.asarray(w)).mean() > 0.97
            continue
        assert g.dtype == torch.bfloat16
        rel = _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        print(f"heads output {i}: rel {rel:.5f}")
        assert rel < PATH_TOL, (i, rel)


@pytest.mark.parametrize("key", [(18, "s2d"), (50, "s2d"), (18, "conv7")], ids=str)
@pytest.mark.parametrize("kw", [dict(compact=True, score_path=True), dict(compact=True), dict()], ids=["score", "compact", "full"])
def test_forward_raw_matches_jax(quantized, key, kw):
    depth, stem = key
    _, qj, mb, _ = quantized[key]
    shape = (2, 16, 24, 48) if stem == "s2d" else (2, 64, 96, 3)
    x = np.random.default_rng(13).integers(0, 256, shape, dtype=np.uint8)
    want = JR.forward_raw(qj, jnp.asarray(x), depth, stem=stem, **kw)
    got = PR.forward_raw(mb, torch.as_tensor(x), **kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype == torch.int32:
            assert (g.numpy() == np.asarray(w)).mean() > 0.95
            continue
        rel = _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        print(f"forward_raw {kw} output {i}: rel {rel:.5f}")
        assert rel < PATH_TOL, (i, rel)


@pytest.mark.parametrize("key", [(18, "s2d"), (50, "s2d")], ids=str)
def test_quantize_detector_matches_jax(quantized, key):
    depth, stem = key
    p, qj, mb, calib = quantized[key]
    m = _bridge(p)
    qp = PQ.quantize_detector(m, torch.as_tensor(calib))
    assert not PQ.is_quantized(m) and PQ.is_quantized(qp.backbone) and PQ.is_quantized(qp.fpn)
    assert qp.fpn is not m.fpn and qp.heads is not m.heads
    worst = 0.0
    for (name, got), (_, want) in zip(qp.named_modules(), mb.named_modules()):
        if not isinstance(got, Conv):
            continue
        assert (got.wq is None) == (want.wq is None), name
        if got.wq is None:
            continue
        np.testing.assert_array_equal(got.wq.numpy(), want.wq.numpy(), err_msg=name)
        np.testing.assert_allclose(got.ws.numpy(), want.ws.numpy(), rtol=1e-6, err_msg=name)
        worst = max(worst, abs(float(got.xs) - float(want.xs)) / float(want.xs))
    print(f"xs: worst relative difference {worst:.4f}")
    assert worst < 0.05
    # the quantized model runs the detect path
    frames = torch.as_tensor(np.random.default_rng(14).integers(0, 256, (2, 16, 24, 48), dtype=np.uint8))
    det = PR.detect_multiframe(qp, frames, pre_topk=64, max_dets=16)
    assert tuple(det.scores.shape) == (16,) and bool(torch.isfinite(det.scores).all())
    # backbone only
    qb = PQ.quantize_detector(m, torch.as_tensor(calib), tail=False)
    assert PQ.is_quantized(qb.backbone) and not PQ.is_quantized(qb.fpn) and qb.fpn is m.fpn


def test_calibrate_backbone_close_to_jax():
    p = _float_params(15, 18, "s2d")["backbone"]
    x = np.random.default_rng(16).normal(0, 1, (2, 16, 24, 48)).astype(np.float32)
    want = np.asarray(JQ.calibrate_backbone(p, jnp.asarray(x), 18, "s2d", dtype=jnp.float32))
    m = _bridge(_float_params(15, 18, "s2d"))
    got = PQ.calibrate_backbone(m.backbone, torch.as_tensor(x), dtype=torch.float32)
    assert tuple(got.shape) == want.shape == (len(list(PQ._iter_conv_bn(m.backbone))),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)


# ---- the kernel's Python side ---------------------------------------------------


@pytest.mark.parametrize("N,H,W,Cin,Cout,k,stride,expect", [
    # (ho, wo, pad_top, pad_left, tiles_m, tiles_n, tile_n, steps, splits, smem_bytes, workspace_ints)
    (1, 135, 240, 256, 256, 3, 1, (135, 240, 1, 1, 254, 1, 256, 18, 1, 201728, 0)),  # enough tiles: no split
    (1, 135, 67, 128, 72, 3, 2, (68, 34, 1, 1, 19, 1, 80, 9, 1, 107520, 0)),  # odd extents: XLA pads (1, 1); N = 80
    (2, 68, 120, 512, 300, 3, 2, (34, 60, 0, 0, 32, 3, 128, 36, 1, 132096, 0)),  # even extents: (0, 1); N = 128
    (1, 270, 480, 256, 64, 1, 2, (135, 240, 0, 0, 254, 1, 64, 2, 1, 99328, 0)),  # up to 64 filters: N = 64
    (1, 34, 60, 2048, 256, 3, 2, (17, 30, 0, 0, 4, 2, 128, 144, 12, 132096, 131136)),  # FPN P6: 12 steps a split
    (32, 1, 1, 256, 256, 3, 1, (1, 1, 1, 1, 1, 2, 128, 18, 18, 132096, 32832)),  # 1x1 crop maps: a step a split
    (1, 9, 15, 48, 256, 3, 1, (9, 15, 1, 1, 2, 2, 128, 9, 1, 132096, 0)),  # a partial channel chunk
    (1, 7, 9, 2048, 256, 3, 1, (7, 9, 1, 1, 1, 2, 128, 144, 29, 132096, 32832)),  # 144 steps over 29: 4 or 5
    (1, 20, 30, 2048, 2048, 3, 1, (20, 30, 1, 1, 5, 8, 256, 144, 3, 201728, 1310784)),  # split 256-wide tiles
])
def test_qconv_launch_plan(N, H, W, Cin, Cout, k, stride, expect):
    assert tuple(QC.launch_plan(N, H, W, Cin, Cout, k, stride)) == expect


@pytest.mark.parametrize("kw,match", [
    (dict(k=5), "kernel size"), (dict(stride=3), "stride"), (dict(Cin=72), "multiple of 16"),
    (dict(Cin=8), "multiple of 16"), (dict(N=0), "empty problem"), (dict(N=64, H=2048, W=2048, Cin=16), "2\\^31"),
    (dict(Cout=256 * 65536), "exceed the grid"),
])
def test_qconv_launch_plan_refuses(kw, match):
    args = dict(N=1, H=8, W=8, Cin=128, Cout=64, k=3, stride=1)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        QC.launch_plan(**args)


@pytest.mark.parametrize("bad,match", [
    ("x_dtype", "x must be int8"), ("w_shape", "wq must be int8"), ("scale", "scale must be float32"),
    ("offset", "offset must be float32"), ("emit", "emit_xs must be one float32"), ("strided", "x must be contiguous"),
    ("res_shape", "res must be int8 or bfloat16"), ("res_dtype", "res must be int8 or bfloat16"),
    ("res_xs_missing", "res_xs goes with an int8 res"), ("res_xs_alone", "res_xs without res"),
    ("res_xs_on_bf16", "res_xs goes with an int8 res"), ("res_offset", "16-byte boundary"), ("ok", None),
])
def test_qconv_check_args(bad, match):
    x = torch.zeros((1, 6, 6, 128), dtype=torch.int8)
    wq = torch.zeros((64, 3, 3, 128), dtype=torch.int8)
    scale, offset, emit = torch.ones(64), torch.zeros(64), torch.tensor(0.1)
    res, res_xs = None, None
    if bad == "x_dtype":
        x = x.float()
    elif bad == "w_shape":
        wq = wq[..., :64]
    elif bad == "scale":
        scale = scale[:-1]
    elif bad == "offset":
        offset = offset.double()
    elif bad == "emit":
        emit = torch.ones(2)
    elif bad == "strided":
        x = torch.zeros((1, 6, 6, 256), dtype=torch.int8)[..., ::2]
    elif bad == "res_shape":
        res, res_xs = torch.zeros((1, 6, 6, 32), dtype=torch.int8), torch.tensor(0.2)
    elif bad == "res_dtype":
        res = torch.zeros((1, 6, 6, 64))
    elif bad == "res_xs_missing":
        res = torch.zeros((1, 6, 6, 64), dtype=torch.int8)
    elif bad == "res_xs_alone":
        res_xs = torch.tensor(0.2)
    elif bad == "res_xs_on_bf16":
        res, res_xs = torch.zeros((1, 6, 6, 64), dtype=torch.bfloat16), torch.tensor(0.2)
    elif bad == "res_offset":
        res, res_xs = torch.zeros(1 + 6 * 6 * 64, dtype=torch.int8)[1:].view(1, 6, 6, 64), torch.tensor(0.2)
    if bad == "ok":
        QC.check_args(x, wq, scale, offset, 1, emit)
        QC.check_args(x, wq, scale, None, 2, None)
        QC.check_args(x, wq, scale, offset, 1, emit, torch.zeros((1, 6, 6, 64), dtype=torch.int8), torch.tensor(0.2))
        QC.check_args(x, wq, scale, offset, 1, None, torch.zeros((1, 6, 6, 64), dtype=torch.bfloat16))
        return
    with pytest.raises(ValueError, match=match):
        QC.check_args(x, wq, scale, offset, 1, emit, res, res_xs)


def test_qconv_dispatch_and_kernel_constants():
    import re

    x = torch.zeros((1, 6, 6, 128), dtype=torch.int8)
    wq = torch.zeros((64, 3, 3, 128), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        QC.qconv_cuda(x, wq, torch.ones(64))
    with pytest.raises(ValueError, match="no implementation"):
        QC.qconv(x.to("meta"), wq, torch.ones(64))
    out = QC.qconv(x, wq, torch.ones(64), torch.full((64,), 0.26), relu=True, emit_xs=torch.tensor(0.5))
    assert out.dtype == torch.int8 and tuple(out.shape) == (1, 6, 6, 64) and (out == 1).all()
    src = QC.LIB.source.read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["kConsumers"], consts["kThreads"], consts["kTileM"], consts["kTileK"], consts["kStages"]) == (
        QC.CONSUMERS, QC.THREADS, QC.TILE_M, QC.TILE_K, QC.STAGES)
    # the launcher's tile widths, each with its wgmma specialization
    assert tuple(int(n) for n in re.findall(r"case (\d+): return launch<\1>", src)) == QC.TILE_NS
    assert tuple(int(n) for n in re.findall(r"struct Wgmma<(\d+)>", src)) == QC.TILE_NS
    assert consts["kPitchPad"] == QC.PITCH_PAD and "constexpr int smem_bytes = kSmemBytes<TN>;" in src
    assert re.search(r"kStages \* \(kTileM \+ TN\) \* kTileK > kTileM \* kPitch<TN> \* 4 \+ kTileM \* TN \* 2", src)
    assert QC.launch_plan(1, 8, 8, 128, 256, 3, 1).smem_bytes <= QC.MAX_SMEM_BYTES
    stores = re.search(r"enum Store \{ kAcc = (\d), kBf16 = (\d), kInt8 = (\d) \}", src).groups()
    assert tuple(int(s) for s in stores) == (QC.ACC, QC.BF16, QC.INT8)
    kinds = re.search(r"enum Residual \{ kNoRes = (\d), kResInt8 = (\d), kResBf16 = (\d) \}", src).groups()
    assert tuple(int(s) for s in kinds) == (QC.NO_RES, QC.RES_INT8, QC.RES_BF16)
    # the split rule the kernel applies is split_range's
    assert "steps) * blockIdx.z / a.splits" in src and "steps) * (blockIdx.z + 1) / a.splits" in src
