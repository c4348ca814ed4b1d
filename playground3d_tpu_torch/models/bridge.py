"""Carry weights across from the JAX package.

``params_from_jax_numpy`` takes the JAX parameter tree as numpy arrays
(nested dicts and lists, conv weights HWIO, frozen-BN scale/offset/mean/var)
and fills a :class:`~playground3d_tpu_torch.models.retinanet.RetinaNet`
whose architecture matches the tree; ``models/nn.py::load_params`` reads the
flat ``/``-joined npz that either package's ``save_params`` writes through
it. Conv weights go HWIO -> OIHW; channel order is kept, so the heads'
(anchor, class) packing survives. A quantized
tree (``models/quant.py``) carries ``wq`` (int8, HWIO -> [out,k,k,in]),
``ws`` and ``xs`` beside the float weights of its quantized convs: they land
in the buffers of the same names, so both packages run the same integers.
A tree whose regression conv has 9 x 4 outputs is the stock 2D detector
(``models/retinanet2d.py``) and fills a
:class:`~playground3d_tpu_torch.models.retinanet2d.RetinaNet2D`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from playground3d_tpu_torch import DeviceLike, resolve_device
from torch import nn

from playground3d_tpu_torch.models.retinanet import RetinaNet, retinanet_init
from playground3d_tpu_torch.models.retinanet2d import retinanet2d_init
from playground3d_tpu_torch.models.resnet import LAYER_SPECS


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts / lists -> {"a/0/b": array}; None leaves are skipped,
    as ``save_params`` skips them."""
    flat: Dict[str, np.ndarray] = {}
    if tree is None:
        return flat
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            flat.update(flatten_tree(v, f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(flatten_tree(v, f"{prefix}/{i}"))
    else:
        flat[prefix] = np.asarray(tree)
    return flat


def to_jax_layout(model: nn.Module) -> Dict[str, np.ndarray]:
    """The model's tensors under the JAX tree's flat keys, conv weights
    back in HWIO (the inverse of :func:`load_flat`)."""
    out = {}
    for name, t in list(model.named_parameters()) + list(model.named_buffers()):
        a = t.detach().cpu().numpy()
        if name.endswith(".w"):
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        out[name.replace(".", "/")] = a
    return out


def load_flat(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """Copy a flat ``/``-keyed JAX tree into ``model``. Every model tensor
    must be present with a matching shape, and every key used."""
    tensors = dict(model.named_parameters())
    tensors.update(dict(model.named_buffers()))
    expected = {name.replace(".", "/"): name for name in tensors}
    quantized = {k for k in flat if k.rsplit("/", 1)[-1] in ("wq", "ws", "xs") and k not in expected}
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected) - quantized)
    if missing or extra:
        raise ValueError(f"param tree mismatch: missing {missing[:5]} extra {extra[:5]}")
    with torch.no_grad():
        for key, name in expected.items():
            a = np.asarray(flat[key], dtype=np.float32)
            if key.endswith("/w"):
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            t = tensors[name]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{key}: shape {a.shape} != {tuple(t.shape)}")
            t.copy_(torch.tensor(a))
        for key in sorted(quantized):
            path, leaf = key.rsplit("/", 1)
            conv = model.get_submodule(path.replace("/", "."))
            a = np.asarray(flat[key])
            if leaf == "wq":
                a = np.ascontiguousarray(a.astype(np.int8).transpose(3, 0, 1, 2))  # HWIO -> OHWI
            else:
                a = a.astype(np.float32)
            setattr(conv, leaf, torch.tensor(a, device=conv.w.device))
    return model


def _is_2d(flat: Mapping[str, np.ndarray]) -> bool:
    """The stock 2D detector's tree: 4 regression outputs an anchor."""
    return flat["heads/reg_out/w"].shape[3] == 9 * 4


def _depth(flat: Mapping[str, np.ndarray]) -> int:
    blocks = []
    for stage in range(1, 5):
        ids = {int(k.split("/")[2]) for k in flat if k.startswith(f"backbone/layer{stage}/")}
        blocks.append(len(ids))
    bottleneck = any(k.startswith("backbone/layer1/0/conv3/") for k in flat)
    return next(
        d for d, (kind, layers) in LAYER_SPECS.items()
        if tuple(layers) == tuple(blocks) and (kind == "bottleneck") == bottleneck
    )


def _infer_arch(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """Architecture knobs of a flat JAX tree of the directional detector."""
    stem_w = flat["backbone/conv1/w"]
    stem = "s2d" if stem_w.shape[2] == 48 else "conv7"
    cls_w = flat["heads/cls_out/w"]
    tower_depth = len({k.split("/")[2] for k in flat if k.startswith("heads/cls_tower/")})
    return dict(
        depth=_depth(flat), stem=stem, feature_size=cls_w.shape[2], num_classes=cls_w.shape[3] // 9,
        tower_depth=tower_depth,
        shared_tower=not any(k.startswith("heads/reg_tower/") for k in flat),
    )


def model_from_flat(flat: Mapping[str, np.ndarray], device: DeviceLike = None) -> nn.Module:
    """A RetinaNet (or RetinaNet2D) shaped like the flat tree, holding its
    weights, on ``device`` (the card unless the caller asks for the CPU)."""
    if _is_2d(flat):
        model = retinanet2d_init(num_classes=flat["heads/cls_out/w"].shape[3] // 9, depth=_depth(flat),
                                 device="cpu")
    else:
        model = retinanet_init(device="cpu", **_infer_arch(flat))
    load_flat(model, flat)
    return model.to(resolve_device(device))


def params_from_jax_numpy(tree: Any, device: DeviceLike = None) -> nn.Module:
    """JAX ``retinanet_init`` (or ``retinanet2d_init``) tree (numpy leaves)
    -> RetinaNet (or RetinaNet2D)."""
    return model_from_flat(flatten_tree(tree), device)
