"""Architecture modules, found by name as the metric readers are.

Each net of a configuration (``detector``, ``crop_net``) may name its
architecture under ``"arch"``; without the key it is ``retinanet_resnet``.
The module ``cellbench/archs/<arch>.py`` gives what the harness needs of a
net, so that a new architecture is a new module (and its reference copy
under ``cellbench/reference/``), not an edit to the harness:

* ``shapes(net)``: name -> shape of every parameter and buffer;
* ``raw_weights(net, seed, device, out_std, reg_bias_xy=None)``: the net's
  float32 weights drawn on ``device`` from ``seed`` in one call;
* ``build(net, weights, device, precision, calib, side)``: the net of
  ``side``, holding ``weights``. For ``"program"`` it is built through the
  port's own entry points and quantized by the port's own code for the
  configuration's ``precision``; for ``"reference"`` the same from
  ``cellbench/reference/`` at ``precision`` (the configuration's, or the
  control's), and the caller builds it inside ``Reference.computing()``.
  ``calib`` is the calibration batch, ``None`` for a float configuration;
* ``layout(net)``: the frames' layout the net takes, as the trackers'
  ``stem`` arguments name it: ``"s2d"`` (4x4 space-to-depth, 48 channels)
  or ``"conv7"`` (RGB);
* ``ops(net, images_shape, precision, min_level=3)``: operations (2 per
  multiply-add) of one forward over images of ``images_shape``, by the
  precision each part runs in for a configuration of ``precision``;
* ``KERNELS``: the program's kernel modules (``ops/<name>.py``) it needs
  beyond the common ones;
* ``tiny(net)``: the net cut to run in seconds on the CPU.
"""

from __future__ import annotations

import importlib
import math
import pkgutil
import re
from types import ModuleType
from typing import Dict, List, Tuple

import torch

DEFAULT = "retinanet_resnet"
_NAME_RE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def available() -> List[str]:
    """The architecture modules there are."""
    return sorted(m.name for m in pkgutil.iter_modules(__path__) if not m.name.startswith("_"))


def of(net: dict) -> ModuleType:
    """The architecture module of ``net`` (its ``"arch"``, or the default)."""
    name = net.get("arch", DEFAULT)
    if isinstance(name, str) and _NAME_RE.match(name):
        try:
            return importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
    raise ValueError(f"no architecture {name!r}: cellbench/archs has {', '.join(available())}")


SIDES = ("program", "reference")


def layout(net: dict) -> str:
    """The frames' layout ``net`` takes, by its architecture module."""
    return of(net).layout(net)


def images_shape(net: dict, n: int, h: int, w: int) -> Tuple[int, ...]:
    """The shape of ``n`` images of ``h`` x ``w`` pixels in the layout
    ``net`` takes (NHWC)."""
    kind = layout(net)
    if kind == "s2d":
        return (n, h // 4, w // 4, 48)
    if kind == "conv7":
        return (n, h, w, 3)
    raise ValueError(f"unknown frame layout {kind!r}")


def draw_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device, out_std: float,
                 reg_bias_xy=None) -> Dict[str, torch.Tensor]:
    """A RetinaNet-headed net's float32 weights, drawn on ``device`` from
    ``seed`` in one call: He-normal ``.w`` leaves (by the fan-in of all but
    the first axis), the two output convs N(0, ``out_std``), ones for
    ``scale`` and ``var`` leaves (identity frozen batch norm), zeros for
    the rest but the classification output's bias (the focal prior raised
    by 3, so scores cross the trackers' gates) and, with ``reg_bias_xy``,
    the regression output's, which puts every anchor's box corner offsets
    at that crop pixel."""
    conv_w = [k for k in shapes if k.endswith(".w")]
    sizes = [math.prod(shapes[k]) for k in conv_w]
    stds = [out_std if k.startswith("heads.") and k.split(".")[1] in ("cls_out", "reg_out")
            else math.sqrt(2.0 / math.prod(shapes[k][1:])) for k in conv_w]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), torch.tensor(sizes, device=device)))
    out = dict(zip(conv_w, (p.view(shapes[k]) for p, k in zip(torch.split(flat, sizes), conv_w))))
    for k, shape in shapes.items():
        if k in out:
            continue
        leaf = k.rsplit(".", 1)[1]
        out[k] = (torch.ones if leaf in ("scale", "var") else torch.zeros)(shape, device=device)
    prior = -math.log((1.0 - 0.01) / 0.01)
    out["heads.cls_out.b"].fill_(prior + 3.0)
    if reg_bias_xy is not None:
        from cellbench.reference.models.anchors import base_anchors

        wh = torch.as_tensor(base_anchors(32.0)[:, 2:] * 2.0, dtype=torch.float32, device=device)
        offset = (torch.as_tensor(reg_bias_xy, dtype=torch.float32, device=device)[None, :] - 4.0) / wh
        out["heads.reg_out.b"].view(-1, 12)[:, 0:2] = offset
    return out


def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """``model`` (built on the meta device) on ``device``, holding copies of
    ``weights``, for inference."""
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval().requires_grad_(False)
