"""Detector training on one device, or data-parallel over a mesh (port of
``playground3d_tpu/train/trainer.py``).

Reference parity (train_detector_3D_angle.py:254-419): Adam 1e-4, gradient
clipping at global norm 0.1, loss = cls + reg + vp summed equally,
ReduceLROnPlateau (factor 0.3, patience 1 epoch, on the host, by setting
the optimizer's learning rate), per-epoch checkpoints.

What is trained is exactly the JAX parameter tree's leaves
(:func:`train_leaves`): every conv's ``w`` / ``b`` and each frozen BN's
``scale``, ``offset``, ``mean`` and ``var``. ``jax.value_and_grad`` over the
tree differentiates all four BN tensors, so Adam moves them and their
gradients count in the global norm; the port's ``FrozenBN`` keeps them as
buffers, which the trainer sets to require gradients. Inference is
unchanged: ``retinanet_init`` still returns a model without gradients.

The step runs ``forward_raw`` (bf16 convs, float32 sigmoid heads), the loss
(``losses/focal.py``: the CUDA kernels on the card), the backward, optax's
``clip_by_global_norm`` and Adam (``torch.optim.Adam``, optax's ``adam`` up
to rounding), and reads nothing back to the host: the metrics stay on the
device.

Data parallelism (``mesh=``): JAX shards the batch on the mesh's ``data``
axis inside one program and lets XLA insert the gradient all-reduce. Here
each mesh device is a process of its own (``torch.distributed``, joined by
``parallel.mesh.join_data_parallel``; NCCL between cards, gloo on the CPU or
for a card listed twice): the eager step is launch-bound, and one host
thread would issue every replica's launches one after another. Each rank is
given the global batch, as JAX's step is, and takes its slice; the
gradients and the metrics are averaged over the ranks with one all-reduce
of a flat buffer, and every rank applies the same clip and Adam update, so
the replicas stay equal bit for bit. The loss is a mean over images, so the
mean of the ranks' equal shards' losses is the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from playground3d_tpu_torch import DeviceLike, resolve_device
from playground3d_tpu_torch.losses.focal import detection_loss
from playground3d_tpu_torch.models.retinanet import RetinaNet, _anchors, forward_raw, retinanet_init
from playground3d_tpu_torch.parallel.mesh import Mesh, batch_sharding, canonical_device, mesh_rank

_QUANT = ("wq", "ws", "xs")
_METRICS = ("loss", "cls", "reg", "vp")


@dataclass
class TrainConfig:
    depth: int = 50
    stem: str = "conv7"  # "s2d" = space-to-depth stem
    num_classes: int = 8
    lr: float = 1e-4
    grad_clip: float = 0.1
    image_shape: Tuple[int, int] = (1080, 1920)
    plateau_factor: float = 0.3  # ReduceLROnPlateau parity
    plateau_patience: int = 1
    # head/FPN width + tower shape (256/4/separate = reference parity,
    # model.py:59,120-205; slimmer settings trade head FLOPs for capacity)
    feature_size: int = 256
    tower_depth: int = 4
    shared_tower: bool = False


def data_parallel_devices(device: torch.device) -> int:
    """The devices a ``--dp`` run spans: JAX's ``make_mesh()`` takes every
    device of the backend (``parallel/mesh.py:31-42``), so every visible
    card, or the one CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else 1


def average_over_ranks(leaves: List[torch.Tensor], metrics: torch.Tensor, world: int) -> torch.Tensor:
    """The mean over the ranks of every leaf's gradient (written back in
    place) and of ``metrics``, by one all-reduce of one flat buffer."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    grads = [t.grad for t in leaves]
    flat = _flatten_dense_tensors(grads + [metrics.to(grads[0].dtype)])
    dist.all_reduce(flat)
    flat /= world
    n = flat.numel() - metrics.numel()
    torch._foreach_copy_(grads, _unflatten_dense_tensors(flat[:n], grads))
    return flat[n:]


def broadcast_leaves(leaves: List[torch.Tensor]) -> None:
    """Rank 0's leaves to every rank (JAX replicates one state over the
    mesh), by one broadcast of one flat buffer."""
    import torch.distributed as dist
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    with torch.no_grad():
        flat = _flatten_dense_tensors([t.detach() for t in leaves])
        dist.broadcast(flat, 0)
        torch._foreach_copy_([t.detach() for t in leaves], _unflatten_dense_tensors(flat, leaves))


def train_leaves(model: RetinaNet) -> Dict[str, torch.Tensor]:
    """The tensors JAX differentiates, under the JAX tree's flat keys: conv
    ``w`` / ``b`` and the four frozen-BN tensors (a quantized conv's int8
    state is not a leaf of training)."""
    named = list(model.named_parameters()) + list(model.named_buffers())
    return {name.replace(".", "/"): t for name, t in named if name.rsplit(".", 1)[-1] not in _QUANT}


class Optimizer:
    """optax's ``chain(clip_by_global_norm(grad_clip), adam(lr))`` over the
    leaves: the global norm over every gradient, the gradients scaled by
    ``max_norm / norm`` only where ``norm >= max_norm`` (as optax writes
    it, ``(g / norm) * max_norm``), then ``torch.optim.Adam`` (b1 0.9, b2
    0.999, eps 1e-8, no eps inside the root). ``lr`` is set on the host."""

    def __init__(self, leaves: List[torch.Tensor], lr: float, grad_clip: float):
        self.leaves = leaves
        self.grad_clip = grad_clip
        self.adam = torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)

    @property
    def lr(self) -> float:
        return self.adam.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.adam.param_groups:
            group["lr"] = value

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def clip(self) -> torch.Tensor:
        """Clip the leaves' gradients in place; -> the global norm (on the
        device, not read)."""
        grads = [t.grad for t in self.leaves]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        return norm

    def step(self) -> None:
        self.clip()
        self.adam.step()

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def make_optimizer(cfg: TrainConfig, model: RetinaNet) -> Optimizer:
    """Set the model's leaves to require gradients and wrap them in the
    clip + Adam optimizer."""
    leaves = list(train_leaves(model).values())
    for t in leaves:
        t.requires_grad_(True)
    return Optimizer(leaves, cfg.lr, cfg.grad_clip)


class TrainState(NamedTuple):
    model: RetinaNet
    step: int


def init_train_state(
    generator: Optional[torch.Generator],
    cfg: TrainConfig,
    model: Optional[RetinaNet] = None,
    device: DeviceLike = None,
) -> Tuple[TrainState, Optimizer]:
    """A new model from ``generator`` (or ``model``, moved to ``device``) and
    its optimizer; the card unless the caller asks for the CPU."""
    dev = resolve_device(device)
    if model is None:
        model = retinanet_init(
            generator, num_classes=cfg.num_classes, depth=cfg.depth, stem=cfg.stem,
            feature_size=cfg.feature_size, tower_depth=cfg.tower_depth, shared_tower=cfg.shared_tower,
            device=dev,
        )
    else:
        model = model.to(dev)
    return TrainState(model, 0), make_optimizer(cfg, model)


def loss_fn(model: RetinaNet, images: torch.Tensor, annotations: torch.Tensor, anchors: torch.Tensor,
            dtype=torch.bfloat16):
    """-> (total, (cls, reg, vp)): the equal-weight sum (train_...py:378)."""
    cls, reg = forward_raw(model, images, dtype=dtype)
    l_cls, l_reg, l_vp = detection_loss(cls, reg, annotations, anchors)
    return l_cls + l_reg + l_vp, (l_cls, l_reg, l_vp)


def make_train_step(cfg: TrainConfig, opt: Optimizer, mesh: Optional[Mesh] = None):
    """-> step(state, images [B,H,W,3], annotations [B,M,21]) -> (state,
    metrics): one forward, backward and optimizer update; the metrics are
    device scalars. With a ``mesh``, in a rank of its data-parallel group:
    the step takes the rank's slice of the global batch (B must divide over
    the mesh) and averages the gradients and the metrics over the ranks
    before the update."""
    rank = mesh_rank(mesh) if mesh is not None else 0

    def step_fn(state: TrainState, images: torch.Tensor, annotations: torch.Tensor):
        if mesh is not None:
            rows = batch_sharding(mesh, images.shape[0])[rank]
            images, annotations = images[rows], annotations[rows]
        anchors = _anchors(tuple(cfg.image_shape), (3, 4, 5, 6, 7), images.device)
        opt.zero_grad()
        total, (l_cls, l_reg, l_vp) = loss_fn(state.model, images, annotations, anchors)
        total.backward()
        values = [total.detach(), l_cls.detach(), l_reg.detach(), l_vp.detach()]
        if mesh is not None:
            values = list(average_over_ranks(opt.leaves, torch.stack(values), mesh.size))
        opt.step()
        return state._replace(step=state.step + 1), dict(zip(_METRICS, values))

    return step_fn


class Trainer:
    """Host loop: feeds batches, keeps the plateau learning-rate schedule,
    checkpoints. Runs on ``device`` (the card unless the caller asks for the
    CPU); with a ``mesh``, in one rank of its data-parallel group, on the
    rank's mesh device, starting from rank 0's parameters."""

    def __init__(self, cfg: TrainConfig, generator: Optional[torch.Generator] = None,
                 mesh: Optional[Mesh] = None, model: Optional[RetinaNet] = None, device: DeviceLike = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            rank_device = mesh.devices[mesh_rank(mesh)]
            if device is not None and canonical_device(device) != rank_device:
                raise ValueError(f"Trainer: device {device}, but this rank's mesh device is {rank_device}")
            device = rank_device
        self.device = resolve_device(device)
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self._init(generator, model)
        self.lr = cfg.lr
        self._best = float("inf")
        self._bad_epochs = 0
        self.history: List[float] = []

    def _init(self, generator: Optional[torch.Generator], model: Optional[RetinaNet]) -> None:
        self.state, self.opt = init_train_state(generator, self.cfg, model, self.device)
        if self.mesh is not None:
            broadcast_leaves(self.opt.leaves)
        self._step = make_train_step(self.cfg, self.opt, self.mesh)

    @property
    def model(self) -> RetinaNet:
        return self.state.model

    def train_step(self, images, annotations) -> Dict[str, torch.Tensor]:
        """One step on a batch (numpy arrays or tensors; moved to the
        trainer's device): the global batch, with a mesh."""
        images = torch.as_tensor(images).to(self.device, non_blocking=True)
        annotations = torch.as_tensor(annotations).to(self.device, non_blocking=True)
        self.state, metrics = self._step(self.state, images, annotations)
        return metrics

    def end_epoch(self, val_loss: float) -> None:
        """ReduceLROnPlateau parity (train_detector_3D_angle.py:412)."""
        self.history.append(val_loss)
        if val_loss < self._best - 1e-6:
            self._best = val_loss
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > self.cfg.plateau_patience:
                self.lr *= self.cfg.plateau_factor
                self._bad_epochs = 0
        # the JAX package injects the rate as a float32 hyperparameter
        self.opt.lr = float(np.float32(self.lr))

    def save(self, path: str) -> None:
        """The model in the JAX package's flat npz format."""
        from playground3d_tpu_torch.models.nn import save_params

        save_params(path, self.model)

    def load(self, path: str) -> None:
        """Weights from a flat npz of either package; the optimizer starts
        anew (as ``opt.init(params)`` does)."""
        from playground3d_tpu_torch.models.nn import load_params

        self._init(None, load_params(path, self.model))
        self.opt.lr = float(np.float32(self.lr))
