"""Device mesh and batch sharding (port of the device and batch half of
``playground3d_tpu/parallel/mesh.py``).

The JAX package's parallelism is a 1-D mesh on a ``data`` axis: training
splits the batch over it with parameters replicated, and the multi-camera
clip splits its camera axis over it. Here a :class:`Mesh` is an ordered
tuple of ``torch.device`` s named by that axis, and a sharded tensor is a
tuple of per-device tensors, one chunk of the sharded dimension each, in
mesh order:

* the camera-sharded clip (``pipeline/multi_cam.py``) is driven by one host
  thread: each shard's device runs the detector over its cameras, and only
  the top-k candidates cross to the lead device ``mesh.devices[0]``, which
  holds the tracker state;
* data-parallel training (``train/trainer.py``) runs one process a mesh
  device, joined by :func:`join_data_parallel` (``torch.distributed``): each
  rank takes its slice of the global batch and the gradients are averaged
  by one all-reduce.

A mesh may list a device more than once (``["cpu"] * 8``, or one card
twice): that plays the part of the JAX tests' virtual CPU devices, and is how
the CPU tests and a one-card run reach the sharded code.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices on one named axis."""

    devices: Tuple[torch.device, ...]
    axis: str = DATA_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def lead(self) -> torch.device:
        """The device that holds what the JAX package replicates: the
        tracker state, the merge of the shards' candidates."""
        return self.devices[0]


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` alone names the current card.
    Raises for a card that is not there."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev} requested but torch.cuda.is_available() is False")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device cuda:{index} requested but {torch.cuda.device_count()} cards are visible")
    return torch.device("cuda", index)


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS, devices=None) -> Mesh:
    """A 1-D mesh of ``devices`` (default: every visible card, which raises
    when there is none), cut to the first ``n_devices``. ``devices`` may
    repeat a device."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("make_mesh: no CUDA card is visible; pass devices=[...] (e.g. ['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [canonical_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"make_mesh: n_devices={n_devices} of {len(devices)} devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    return Mesh(tuple(devices), axis)


def batch_sharding(mesh: Mesh, n: int) -> List[slice]:
    """The slice of a sharded dimension of length ``n`` that each mesh
    device holds, in mesh order. Raises unless the mesh divides ``n``, as
    JAX's ``device_put`` does."""
    if n % mesh.size:
        raise ValueError(f"a dimension of {n} does not divide over the {mesh.size} devices of the "
                         f"'{mesh.axis}' mesh axis")
    m = n // mesh.size
    return [slice(i * m, (i + 1) * m) for i in range(mesh.size)]


def shard_batch(mesh: Mesh, x: torch.Tensor, dim: int = 0) -> Tuple[torch.Tensor, ...]:
    """``x`` split on ``dim`` (the leading dimension by default; the clip
    shards its frames' camera dimension, 1) into one contiguous chunk a mesh
    device, each on its device."""
    index = [slice(None)] * dim
    return tuple(x[(*index, rows)].to(dev, non_blocking=True).contiguous()
                 for rows, dev in zip(batch_sharding(mesh, x.shape[dim]), mesh.devices))


def replicate(mesh: Mesh, module: nn.Module) -> Tuple[nn.Module, ...]:
    """One copy of ``module`` a mesh device, in mesh order: the module
    itself on the devices it lies on, a deep copy moved to each other
    device (an int8 model's ``wq`` / ``ws`` / ``xs`` are buffers and move
    with it; its folded epilogues are dropped and refolded on first use)."""
    copies = {canonical_device(next(module.parameters()).device): module}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            replica = copy.deepcopy(module).to(dev)
            for m in replica.modules():
                if "_folds" in m.__dict__:
                    m._folds = {}
            copies[dev] = replica
        out.append(copies[dev])
    return tuple(out)


def data_parallel_backend(mesh: Mesh) -> str:
    """NCCL for a mesh of distinct cards; gloo on the CPU and for a card
    listed more than once (NCCL refuses two ranks on one card; gloo
    all-reduces CUDA tensors through the host)."""
    cards = [d for d in mesh.devices if d.type == "cuda"]
    if len(cards) == mesh.size and len(set(cards)) == mesh.size:
        return "nccl"
    return "gloo"


def join_data_parallel(mesh: Mesh, rank: int, init_method: str) -> torch.device:
    """Join this process to the data-parallel group of ``mesh`` as ``rank``
    (one process a mesh device) through ``init_method`` (e.g.
    ``file:///tmp/x/rendezvous``, a file that no earlier group used, or
    ``tcp://localhost:PORT``); -> this rank's device. A failed rendezvous
    raises."""
    import torch.distributed as dist

    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} of a {mesh.size}-device mesh")
    dev = mesh.devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(data_parallel_backend(mesh), init_method=init_method, world_size=mesh.size,
                            rank=rank)
    return dev


def mesh_rank(mesh: Mesh) -> int:
    """This process's rank in the data-parallel group of ``mesh``; raises
    when no group of the mesh's size has been joined."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(f"data parallelism over a {mesh.size}-device mesh runs one process a device: call "
                           "parallel.mesh.join_data_parallel(mesh, rank, init_method) in each first")
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"the process group has {dist.get_world_size()} ranks, the mesh {mesh.size} devices")
    return dist.get_rank()


def shard_devices(mesh: Mesh, tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless ``tensors`` are one a mesh device, each on its own."""
    if len(tensors) != mesh.size:
        raise ValueError(f"{what}: {len(tensors)} shards for a {mesh.size}-device mesh")
    for i, (t, dev) in enumerate(zip(tensors, mesh.devices)):
        if canonical_device(t.device) != dev:
            raise ValueError(f"{what}: shard {i} lies on {t.device}, its mesh device is {dev}")
