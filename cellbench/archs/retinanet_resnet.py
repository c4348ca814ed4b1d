"""The directional RetinaNet on a ResNet (``depth`` 18/34/50/101/152, conv7
or s2d stem), FPN on C3-C5 to P3-P7 and the 3D heads: the port's
``models/retinanet.py``, and its frozen copy in ``cellbench/reference/``.
An int8 configuration quantizes the whole net (backbone, FPN and heads) by
``quantize_detector``."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from cellbench import archs

KERNELS = ("qconv", "quantize")  # the int8 convolution and the activations' quantize step


def _model(model_cls, net: dict):
    """A RetinaNet of ``model_cls`` (the program's or the reference's) as
    ``net`` says, on the meta device."""
    with torch.device("meta"):
        return model_cls(net["num_classes"], net["depth"], net["stem"], net["tower_depth"], net["shared_tower"],
                         net["feature_size"])


def shapes(net: dict) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every parameter and buffer (the reference's module
    tree, which names them as the program's does), without allocating."""
    from cellbench.reference.models.retinanet import RetinaNet

    return {k: tuple(v.shape) for k, v in _model(RetinaNet, net).state_dict().items()}


def raw_weights(net: dict, seed: int, device, out_std: float, reg_bias_xy=None) -> Dict[str, torch.Tensor]:
    """He-normal convs, identity frozen batch norm, the heads' outputs as
    :func:`cellbench.archs.draw_weights` draws them."""
    return archs.draw_weights(shapes(net), seed, device, out_std, reg_bias_xy)


def build(net: dict, weights: Dict[str, torch.Tensor], device, precision: str, calib, side: str):
    """``side``'s RetinaNet holding ``weights``: the port's, or the
    reference's; for int8 (and the reference's int4 control), quantized by
    that side's own ``quantize_detector`` on ``calib`` (the reference at
    its ``QMAX``, which ``Reference.computing()`` sets)."""
    if side == "program":
        from playground3d_tpu_torch.models import quant, retinanet
    elif side == "reference":
        from cellbench.reference.models import quant, retinanet
    else:
        raise ValueError(f"side {side!r} is not one of {archs.SIDES}")
    model = archs.load(_model(retinanet.RetinaNet, net), weights, device)
    return quant.quantize_detector(model, calib) if precision in ("int8", "int4") else model


def layout(net: dict) -> str:
    """The stem's: s2d-packed frames, or RGB for the 7x7 conv."""
    return net["stem"]


def ops(net: dict, images_shape: Tuple[int, ...], precision: str, min_level: int = 3) -> Dict[str, int]:
    """Operations (2 per multiply-add) of every convolution of one forward
    over uint8 images of ``images_shape`` (NHWC, raw or s2d-packed as the
    stem takes them), heads on levels ``min_level`` and up: the reference's
    module tree run on the meta device, so nothing is computed. All of it
    counts at the configuration's ``precision``."""
    from cellbench.reference.models.nn import Conv
    from cellbench.reference.models.retinanet import RetinaNet, forward_raw

    model = _model(RetinaNet, net)
    macs = [0]

    def count(conv, args, out):
        macs[0] += out.numel() * conv.w.shape[1] * conv.k * conv.k

    hooks = [m.register_forward_hook(count) for m in model.modules() if isinstance(m, Conv)]
    try:
        with torch.no_grad():
            forward_raw(model, torch.empty(images_shape, dtype=torch.uint8, device="meta"), compact=True,
                        min_level=min_level, score_path=True)
    finally:
        for h in hooks:
            h.remove()
    return {precision: 2 * macs[0]}


def tiny(net: dict) -> dict:
    """ResNet-18, 32 wide, one-conv towers."""
    return dict(net, depth=18, feature_size=32, tower_depth=1)
