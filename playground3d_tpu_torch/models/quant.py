"""Post-training int8 (w8a8) quantization of the detector (port of
``playground3d_tpu/models/quant.py``).

Scheme
------
* weights: per-output-channel symmetric int8 (``wq``/``ws``), folded from
  the float32 weights;
* activations: per-tensor symmetric int8 with static scales (``xs``),
  calibrated by recording ``max|x|`` at every conv input over calibration
  batches, so inference has no data-dependent scale;
* each quantized conv runs int8 x int8 -> int32 and dequantizes in its
  epilogue with one per-channel multiply and add that also folds the frozen
  BN or carries the bias (:func:`playground3d_tpu_torch.ops.qconv.qconv`:
  the hand-written kernel on the card, its exact plain version on the CPU);
* only convs with at least ``min_ch`` input channels quantize; the others
  stay bfloat16 convolutions.

The quantized state lives as buffers on the :class:`~playground3d_tpu_torch.
models.nn.Conv` modules (``wq`` int8 [out,k,k,in], ``ws`` [out], ``xs``
scalar); the float weights stay beside them. The apply paths are plain
functions over the existing ``ResNet`` / ``FPN`` / ``Heads`` modules.

Two apply paths, as in the JAX package: the hook path (``quant_conv_bn``,
``quant_conv``: every conv takes a float tensor, quantizes it at its own
``xs`` and emits bfloat16; used by calibration and by the FPN) and the
chained path (``resnet_apply_int8_chained``, ``head_apply_int8_chained``:
a producer emits int8 at its consumer's scale, so activations stay int8
between convs). Block inputs of the chained path are clipped to the next
conv's range before the residual add: saturation there is part of the
semantics.

Roundings to keep: ``round`` is half-to-even; ``x / xs`` is a true division;
a chained int8 tensor becomes float as ``bfloat16(q) * bfloat16(scale)``; the
epilogue's scale and offset are folded once per conv in float32 on the
device (:func:`_folded`) and handed to the kernel. Where the last conv of a
ResNet block is quantized, the block's tail (dequantize the residual, add,
relu, requantize) runs in that conv's epilogue (:func:`_chain_block`); the
tail of blocks whose last conv stays bfloat16 (:func:`_chain_block_unfused`)
is plain tensor ops. A float input is quantized by :func:`_quantize_act`:
one launch of ``csrc/quantize.cu`` for every tensor on the card
(:mod:`playground3d_tpu_torch.ops.quantize`), the same five plain tensor
ops as the JAX package's expression on the CPU, with the same bits.
"""

from __future__ import annotations

import copy
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function

from playground3d_tpu_torch.models.fpn import FPN
from playground3d_tpu_torch.models.heads import N_REG_OUTPUTS, Heads
from playground3d_tpu_torch.models.nn import Conv, FrozenBN, max_pool
from playground3d_tpu_torch.models.resnet import LAYER_SPECS, ResNet, space_to_depth
from playground3d_tpu_torch.ops.qconv import qconv
from playground3d_tpu_torch.ops.quantize import quantize

_EPS = 1e-8

# a chained value: ("f", float NCHW tensor) or ("i8", int8 NCHW tensor, scale)
Chained = Tuple


def _iter_conv_bn(backbone: ResNet) -> Iterator[Tuple[Conv, FrozenBN]]:
    """(conv, bn) pairs in :meth:`ResNet.forward`'s call order."""
    yield backbone.conv1, backbone.bn1
    for stage in range(4):
        for blk in getattr(backbone, f"layer{stage + 1}"):
            yield blk.conv1, blk.bn1
            yield blk.conv2, blk.bn2
            if hasattr(blk, "conv3"):
                yield blk.conv3, blk.bn3
            if blk.down_conv is not None:
                yield blk.down_conv, blk.down_bn


@torch.no_grad()
def calibrate_backbone(backbone: ResNet, images: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """One float forward recording ``max|x|`` at each conv input -> [n_convs]
    in apply order, on the images' device (stacked there: no read per conv).
    Feed several batches and take the elementwise max."""
    absmax: List[torch.Tensor] = []

    def cb(conv, bn, x, stride=1, relu=False):
        absmax.append(torch.amax(torch.abs(x.to(torch.float32))))
        y = bn(conv(x, stride, dtype))
        return torch.relu(y) if relu else y

    backbone(images, dtype, conv_bn=cb)
    return torch.stack(absmax)


@torch.no_grad()
def _quantize_conv_(conv: Conv, absmax: torch.Tensor) -> None:
    """Attach ``wq``/``ws``/``xs`` to one conv, in place."""
    w = conv.w.detach().to(torch.float32)  # [out,in,k,k]
    ws = torch.clamp(torch.amax(torch.abs(w), dim=(1, 2, 3)), min=_EPS) / 127.0
    wq = torch.clamp(torch.round(w / ws[:, None, None, None]), -127, 127).to(torch.int8)
    conv.wq = wq.permute(0, 2, 3, 1).contiguous()  # [out,k,k,in]
    conv.ws = ws
    conv.xs = torch.clamp(absmax.to(torch.float32), min=_EPS) / 127.0
    conv._folds = {}


def _check_calibration(act_absmax: torch.Tensor, n_convs: int, what: str) -> torch.Tensor:
    act_absmax = torch.as_tensor(act_absmax)
    if act_absmax.shape[0] != n_convs:
        raise ValueError(f"calibration length {act_absmax.shape[0]} != {what} conv count {n_convs}")
    return act_absmax


def quantize_backbone(backbone: ResNet, act_absmax, min_ch: int = 128) -> ResNet:
    """A copy of the backbone whose convs with at least ``min_ch`` input
    channels carry int8 weights and the calibrated activation scales. The
    narrow early convs (64 inputs and the stem) stay bfloat16, so the chained
    path enters and leaves int8 inside layer1."""
    q = copy.deepcopy(backbone)
    convs = list(_iter_conv_bn(q))
    act_absmax = _check_calibration(act_absmax, len(convs), "backbone")
    for i, (conv, _) in enumerate(convs):
        if conv.w.shape[1] >= min_ch:
            _quantize_conv_(conv, act_absmax[i].to(conv.w.device))
    return q


def is_quantized(module: nn.Module) -> bool:
    """True if any conv under ``module`` carries int8 weights."""
    return any(isinstance(m, Conv) and m.wq is not None for m in module.modules())


# ---- the units -------------------------------------------------------------


def _quantize_act(x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """float -> int8 at the scale ``xs`` (a float32 scalar on the device):
    ``int8(clip(round_half_even(float32(x) / xs), -127, 127))``, a true
    division. :func:`~playground3d_tpu_torch.ops.quantize.quantize` runs
    the kernel on the card and the plain ops on the CPU; an activation
    split over devices (``parallel/spatial.py::Slabs``) is quantized slab by
    slab, each on its own device."""
    if has_torch_function((x,)):
        return handle_torch_function(_quantize_act, (x,), x, xs)
    return quantize(x, xs)


def _folded(conv: Conv, bn: Optional[FrozenBN], s_in: torch.Tensor):
    """(scale, offset) [out] float32 of the epilogue for input scale ``s_in``:
    ``s_in * ws`` times the BN's ``rsqrt(var + eps) * scale`` with the BN's
    offset, or ``s_in * ws`` with the bias. Folded once per (conv, producer
    scale) and kept on the conv: the networks' wiring is fixed, so each conv
    sees one or two producer scales (a block's input feeds ``conv1`` and
    ``down_conv``)."""
    folds = conv.__dict__.setdefault("_folds", {})
    key = (id(s_in), id(bn))
    hit = folds.get(key)
    if hit is not None and hit[0] is s_in:
        return hit[1], hit[2]
    if bn is not None:
        inv = torch.rsqrt(bn.var + bn.eps) * bn.scale
        scale = s_in * conv.ws * inv
        offset = bn.offset - bn.mean * inv
    else:
        scale = s_in * conv.ws
        offset = conv.b.detach().to(torch.float32) if conv.b is not None else None
    scale = scale.to(torch.float32).contiguous()
    if offset is not None:
        offset = offset.contiguous()
    folds[key] = (s_in, scale, offset)
    return scale, offset


def _qconv_nchw(conv, bn, xq, s_in, stride, relu, emit_xs, res=None, res_xs=None, pads=None) -> torch.Tensor:
    """The int8 conv on an NCHW view (channels-last memory, as every
    activation of the networks) -> NCHW view; ``res`` is an NCHW view too.
    ``pads`` as in ``Conv.forward``; an int8 activation split over devices
    (``parallel/spatial.py::Slabs``) runs it slab by slab, its halo
    exchanged as int8."""
    if has_torch_function((xq, res)):
        return handle_torch_function(_qconv_nchw, (xq, res), conv, bn, xq, s_in, stride, relu, emit_xs, res,
                                     res_xs, pads)
    scale, offset = _folded(conv, bn, s_in)
    if res is not None:
        res = res.permute(0, 2, 3, 1)
    y = qconv(xq.permute(0, 2, 3, 1), conv.wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)
    return y.permute(0, 3, 1, 2)


def quant_conv_bn(conv: Conv, bn: FrozenBN, x: torch.Tensor, stride: int = 1, relu: bool = False):
    """Hook-path unit: int8 conv -> fused dequantize + BN (-> relu), bfloat16
    out; a conv that is not quantized runs as bfloat16. ``x`` is float and is
    quantized at the conv's static input scale."""
    if conv.wq is None:
        y = bn(conv(x, stride, torch.bfloat16))
        return torch.relu(y) if relu else y
    return _qconv_nchw(conv, bn, _quantize_act(x, conv.xs), conv.xs, stride, relu, None)


def quant_conv(conv: Conv, x: torch.Tensor, stride: int = 1, dtype=torch.bfloat16):
    """Hook-path unit for biased convs (FPN, heads), compatible with
    :func:`~playground3d_tpu_torch.models.nn.apply_conv`."""
    if conv.wq is None:
        return conv(x, stride, dtype)
    return _qconv_nchw(conv, None, _quantize_act(x, conv.xs), conv.xs, stride, False, None)


@torch.no_grad()
def resnet_apply_int8(backbone: ResNet, x: torch.Tensor):
    """The backbone through the hook path (activations round-trip through
    bfloat16 between convs): calibration uses it, and it is the reference
    int8 semantics. NHWC images -> NCHW (C3, C4, C5)."""
    return backbone(x, torch.bfloat16, conv_bn=quant_conv_bn)


# ---- chained int8: activations stay int8 between convs ----------------------


def _chain_f(cur: Chained) -> torch.Tensor:
    """Chained value -> float tensor (dequantize if int8)."""
    if cur[0] == "f":
        return cur[1]
    return cur[1].to(torch.bfloat16) * cur[2].to(torch.bfloat16)


def _xs_of(conv: Conv) -> Optional[torch.Tensor]:
    return conv.xs if conv.wq is not None else None


def _chain_requant(x_float: torch.Tensor, emit_xs: Optional[torch.Tensor]) -> Chained:
    if emit_xs is None:
        return ("f", x_float)
    return ("i8", _quantize_act(x_float, emit_xs), emit_xs)


def _int8_input(conv: Conv, cur: Chained):
    """(int8 tensor, its scale) for a quantized conv: a float value is
    quantized at the conv's own input scale."""
    if cur[0] == "f":
        return _quantize_act(cur[1], conv.xs), conv.xs
    return cur[1], cur[2]


def _chain_any(conv, bn, cur, stride, relu, emit_xs, dtype) -> Chained:
    if conv.wq is None:
        y = conv(_chain_f(cur), stride, dtype)
        if bn is not None:
            y = bn(y)
        if relu:
            y = torch.relu(y)
        return _chain_requant(y, emit_xs)
    out = _qconv_nchw(conv, bn, *_int8_input(conv, cur), stride, relu, emit_xs)
    return ("f", out) if emit_xs is None else ("i8", out, emit_xs)


def _chain_qconv(conv, bn, cur, stride, relu, emit_xs) -> Chained:
    """One conv + BN (+ relu) on a chained value; ``emit_xs`` is the
    consumer's activation scale (emit int8) or None (emit bfloat16). The
    epilogue folds the scale the input really has."""
    return _chain_any(conv, bn, cur, stride, relu, emit_xs, torch.bfloat16)


def _chain_qconv_b(conv, cur, stride, relu, emit_xs, dtype=torch.bfloat16) -> Chained:
    """Biased-conv twin of :func:`_chain_qconv` (FPN and head convs)."""
    return _chain_any(conv, None, cur, stride, relu, emit_xs, dtype)


def _chain_block_unfused(bp, cur: Chained, out_xs: Optional[torch.Tensor], basic: bool) -> Chained:
    """One ResNet block on a chained value, its tail as separate tensor ops,
    as the JAX package's ``block`` does it: ``relu(last conv's bfloat16
    output + residual)``, requantized at ``out_xs`` (the next block's input
    scale) or bfloat16. The residual is the block input or ``down_conv``'s
    bfloat16 output. It runs the blocks whose last conv stays bfloat16, and
    is the definition :func:`_chain_block` is held to."""
    if basic:
        h = _chain_qconv(bp.conv1, bp.bn1, cur, bp.stride, True, _xs_of(bp.conv2))
        hf = _chain_f(_chain_qconv(bp.conv2, bp.bn2, h, 1, False, None))
    else:
        h = _chain_qconv(bp.conv1, bp.bn1, cur, 1, True, _xs_of(bp.conv2))
        h = _chain_qconv(bp.conv2, bp.bn2, h, bp.stride, True, _xs_of(bp.conv3))
        hf = _chain_f(_chain_qconv(bp.conv3, bp.bn3, h, 1, False, None))
    if bp.down_conv is not None:
        res = _chain_f(_chain_qconv(bp.down_conv, bp.down_bn, cur, bp.stride, False, None))
    else:
        res = _chain_f(cur)
    return _chain_requant(torch.relu(hf + res), out_xs)


def _chain_block(bp, cur: Chained, out_xs: Optional[torch.Tensor], basic: bool) -> Chained:
    """:func:`_chain_block_unfused`, with the tail in the last conv's
    epilogue (one launch) where that conv is quantized: ``down_conv`` runs
    first, and its bfloat16 output, or the int8 block input, is the
    epilogue's residual. The plain version computes the tail with the same
    tensor ops, so both give the same bits."""
    last, last_bn = (bp.conv2, bp.bn2) if basic else (bp.conv3, bp.bn3)
    if last.wq is None:
        return _chain_block_unfused(bp, cur, out_xs, basic)
    h = _chain_qconv(bp.conv1, bp.bn1, cur, bp.stride if basic else 1, True, _xs_of(bp.conv2))
    if not basic:
        h = _chain_qconv(bp.conv2, bp.bn2, h, bp.stride, True, _xs_of(bp.conv3))
    res = cur if bp.down_conv is None else _chain_qconv(bp.down_conv, bp.down_bn, cur, bp.stride, False, None)
    out = _qconv_nchw(last, last_bn, *_int8_input(last, h), 1, False, out_xs,
                      res[1], res[2] if res[0] == "i8" else None)
    return ("f", out) if out_xs is None else ("i8", out, out_xs)


@torch.no_grad()
def head_apply_int8_chained(heads: Heads, features: Sequence[torch.Tensor], score_path: bool = False):
    """Chained-int8 twin of ``Heads.forward(compact=True)``: tower
    activations stay int8 between convs; with a shared tower the last tower
    tensor feeds both output convs, which fold the same producer scale.
    Returns bfloat16 logits and regression; with ``score_path`` the class
    axis is reduced per level: (max logit [N,A], class [N,A] int32, reg)."""
    A, K = heads.num_anchors, heads.num_classes

    def tower(tw, f, out_conv):
        cur = ("f", f)
        for i, c in enumerate(tw):
            nxt = tw[i + 1] if i + 1 < len(tw) else out_conv
            cur = _chain_qconv_b(c, cur, 1, True, _xs_of(nxt))
        return cur

    cls_all, reg_all, arg_all = [], [], []
    for f in features:
        n, _, h, w = f.shape
        ct = tower(heads.cls_tower, f, heads.cls_out)
        rt = ct if heads.reg_tower is None else tower(heads.reg_tower, f, heads.reg_out)
        c = _chain_f(_chain_qconv_b(heads.cls_out, ct, 1, False, None)).permute(0, 2, 3, 1)
        r = _chain_f(_chain_qconv_b(heads.reg_out, rt, 1, False, None)).permute(0, 2, 3, 1)
        if score_path:
            c5 = c.reshape(n, h, w, A, K)
            cls_all.append(torch.amax(c5, dim=-1).reshape(n, h * w * A))
            arg_all.append(torch.argmax(c5, dim=-1).to(torch.int32).reshape(n, h * w * A))
        else:
            cls_all.append(c.reshape(n, h * w * A, K))
        reg_all.append(r.reshape(n, h * w * A, N_REG_OUTPUTS))
    cls = torch.cat(cls_all, dim=1).to(torch.bfloat16)
    reg = torch.cat(reg_all, dim=1).to(torch.bfloat16)
    if score_path:
        return cls, torch.cat(arg_all, dim=1), reg
    return cls, reg


@torch.no_grad()
def resnet_apply_int8_chained(backbone: ResNet, x: torch.Tensor):
    """Chained-int8 twin of :meth:`ResNet.forward` -> NCHW (C3, C4, C5) in
    bfloat16, with the same block structure."""
    basic = LAYER_SPECS[backbone.depth][0] == "basic"
    if backbone.stem == "s2d" and x.shape[-1] == 3:
        x = space_to_depth(x, 4)
    x = x.permute(0, 3, 1, 2)
    if backbone.stem == "s2d":
        cur = _chain_qconv(backbone.conv1, backbone.bn1, ("f", x), 1, True, None)
    else:
        cur = _chain_qconv(backbone.conv1, backbone.bn1, ("f", x), 2, True, None)
        cur = ("f", max_pool(_chain_f(cur), 3, 2))

    feats = []
    stages = [getattr(backbone, f"layer{i + 1}") for i in range(4)]
    for stage_i, blocks in enumerate(stages):
        for bi, bp in enumerate(blocks):
            # the block output's consumer: the next block's conv1, or the
            # next stage's. C3/C4/C5 also feed the FPN, so the outputs of
            # stages 2-4 are bfloat16; layer1's stays inside the chain
            if bi + 1 < len(blocks):
                out_xs = _xs_of(blocks[bi + 1].conv1)
            elif stage_i == 0:
                out_xs = _xs_of(stages[1][0].conv1)
            else:
                out_xs = None
            cur = _chain_block(bp, cur, out_xs, basic)
        if stage_i >= 1:
            feats.append(_chain_f(cur))
    return feats[0], feats[1], feats[2]


# ---- FPN + heads ("tail") ----------------------------------------------------


def _iter_tail_convs(fpn: FPN, heads: Heads) -> Iterator[Conv]:
    """The FPN and head convs in a canonical order, each once: a tower conv
    applies to all five levels and its one static ``xs`` covers them all."""
    for k in ("P5_1", "P5_2", "P4_1", "P4_2", "P3_1", "P3_2", "P6", "P7_2"):
        yield getattr(fpn, k)
    yield from heads.cls_tower
    if heads.reg_tower is not None:
        yield from heads.reg_tower
    yield heads.cls_out
    yield heads.reg_out


@torch.no_grad()
def calibrate_tail(model, c3, c4, c5) -> torch.Tensor:
    """One FPN + heads float forward on (quantized-)backbone features (NCHW),
    recording ``max|x|`` at every conv input, the max over a conv's call
    sites -> [n_tail_convs] in :func:`_iter_tail_convs` order."""
    store: dict = {}

    def conv(m, x, stride=1, dtype=torch.bfloat16):
        a = torch.amax(torch.abs(x.to(torch.float32)))
        store[id(m)] = a if id(m) not in store else torch.maximum(store[id(m)], a)
        return m(x, stride, dtype)

    feats = model.fpn(c3, c4, c5, conv=conv)
    model.heads(feats, apply_sigmoid=False, conv=conv)
    return torch.stack([store[id(m)] for m in _iter_tail_convs(model.fpn, model.heads)])


def quantize_tail(model, act_absmax, quant_outputs: bool = True, min_ch: int = 128):
    """Copies of the model's FPN and heads with int8 weights and scales
    attached -> ``{"fpn": FPN, "heads": Heads}``. ``quant_outputs=False``
    keeps the two output convs bfloat16."""
    fpn, heads = copy.deepcopy(model.fpn), copy.deepcopy(model.heads)
    convs = list(_iter_tail_convs(fpn, heads))
    act_absmax = _check_calibration(act_absmax, len(convs), "tail")
    for i, conv in enumerate(convs):
        if not quant_outputs and (conv is heads.cls_out or conv is heads.reg_out):
            continue
        if conv.w.shape[1] >= min_ch:
            _quantize_conv_(conv, act_absmax[i].to(conv.w.device))
    return {"fpn": fpn, "heads": heads}


@torch.no_grad()
def quantize_detector(model, calib_images: Union[torch.Tensor, Sequence[torch.Tensor]],
                      tail: bool = True, quant_outputs: bool = True):
    """Full-detector PTQ: calibrate on representative frames (the dtype and
    layout the pipeline feeds; uint8 is normalized as at inference), quantize
    the backbone, then calibrate the FPN and heads on the *quantized*
    backbone's features and quantize them too. Returns a new model (a shallow
    copy holding the quantized parts) that drops into every forward:
    ``forward_raw`` dispatches on the ``wq`` buffers. The calibration batches
    must lie on the model's device."""
    from playground3d_tpu_torch.models.retinanet import normalize_on_device

    batches = calib_images if isinstance(calib_images, (list, tuple)) else [calib_images]
    batches = [normalize_on_device(torch.as_tensor(im)) for im in batches]
    absmax = None
    for im in batches:
        a = calibrate_backbone(model.backbone, im)
        absmax = a if absmax is None else torch.maximum(absmax, a)
    out = copy.copy(model)  # a shallow copy with a child table of its own:
    out._modules = dict(model._modules)  # replacing its parts leaves ``model`` as it was
    out.backbone = quantize_backbone(model.backbone, absmax)
    if tail:
        tail_absmax = None
        for im in batches:
            c3, c4, c5 = resnet_apply_int8(out.backbone, im)
            a = calibrate_tail(model, c3, c4, c5)
            tail_absmax = a if tail_absmax is None else torch.maximum(tail_absmax, a)
        qt = quantize_tail(model, tail_absmax, quant_outputs=quant_outputs)
        out.fpn, out.heads = qt["fpn"], qt["heads"]
    return out
