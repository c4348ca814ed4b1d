"""Weights carried from the JAX package into the PyTorch port: every leaf
of a ``retinanet_init`` tree comes back equal through
``params_from_jax_numpy`` and through a ``save_params`` npz."""

import jax
import numpy as np
import pytest
import torch

from playground3d_tpu.models import retinanet_init as jax_init
from playground3d_tpu.models.nn import save_params
from playground3d_tpu_torch.models.bridge import (
    flatten_tree,
    params_from_jax_numpy,
    to_jax_layout,
)
from playground3d_tpu_torch.models.nn import load_params

# the suite runs in several worker processes at once: one intra-op thread
# each keeps torch's small CPU ops from oversubscribing the cores
torch.set_num_threads(1)


_init = jax.jit(jax_init, static_argnames=("depth", "stem", "tower_depth", "shared_tower", "feature_size"))


@pytest.mark.parametrize("depth,stem,shared", [
    (18, "conv7", False), (18, "s2d", True), (50, "conv7", False), (50, "s2d", False),
])
def test_roundtrip(tmp_path, depth, stem, shared):
    tree = _init(
        jax.random.PRNGKey(depth), depth=depth, stem=stem,
        tower_depth=2 if shared else 4, shared_tower=shared,
    )
    flat = flatten_tree(jax.tree_util.tree_map(np.asarray, tree))
    model = params_from_jax_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    assert (model.depth, model.stem) == (depth, stem)
    assert (model.heads.reg_tower is None) == shared
    back = to_jax_layout(model)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # conv weights land OIHW
    w = dict(model.named_parameters())["backbone.conv1.w"]
    assert tuple(w.shape) == tuple(flat["backbone/conv1/w"].transpose(3, 2, 0, 1).shape)

    path = str(tmp_path / "p.npz")
    save_params(path, tree)
    back_npz = to_jax_layout(load_params(path, model))
    for k, v in flat.items():
        np.testing.assert_array_equal(back_npz[k], v, err_msg=k)


def test_head_channel_order_survives():
    """The heads' (anchor, class) channel packing is kept: output channel
    a*K + k of the JAX conv is output channel a*K + k of the port's."""
    tree = jax.tree_util.tree_map(np.asarray, _init(jax.random.PRNGKey(3), depth=18, stem="conv7"))
    w = np.arange(np.prod(tree["heads"]["cls_out"]["w"].shape), dtype=np.float32)
    tree["heads"]["cls_out"]["w"] = w.reshape(tree["heads"]["cls_out"]["w"].shape)
    model = params_from_jax_numpy(tree, device="cpu")
    got = model.heads.cls_out.w.detach()
    for o in (0, 7, 8, 71):
        np.testing.assert_array_equal(got[o].permute(1, 2, 0).numpy(), tree["heads"]["cls_out"]["w"][..., o])


def test_mismatched_tree_is_refused():
    tree = jax.tree_util.tree_map(np.asarray, _init(jax.random.PRNGKey(3), depth=18, stem="conv7"))
    del tree["fpn"]["P6"]
    with pytest.raises((ValueError, KeyError)):
        params_from_jax_numpy(tree, device="cpu")
