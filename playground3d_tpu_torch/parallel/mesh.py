"""Device mesh, batch sharding and spatial partitioning (port of
``playground3d_tpu/parallel/mesh.py``).

The JAX package's parallelism is a mesh with a ``data`` axis: training
splits the batch over it with parameters replicated, and the multi-camera
clip splits its camera axis over it. Here a :class:`Mesh` is an ordered
tuple of ``torch.device`` s named by that axis (and, from
:func:`make_mesh2`, a second axis, ``space``), and a batch-sharded tensor
is a tuple of per-device tensors, one chunk of the sharded dimension each,
in mesh order:

* the camera-sharded clip (``pipeline/multi_cam.py``) is driven by one host
  thread: each shard's device runs the detector over its cameras, and only
  the top-k candidates cross to the lead device ``mesh.devices[0]``, which
  holds the tracker state;
* data-parallel training (``train/trainer.py``) runs one process a mesh
  device, joined by :func:`join_data_parallel` (``torch.distributed``): each
  rank takes its slice of the global batch and the gradients are averaged
  by one all-reduce.

* spatial partitioning (:func:`spatial_forward`, :func:`camera_spatial_forward`)
  splits one frame's width (else its height) over an axis, so that several
  devices share one frame's detector forward: :func:`shard_spatial` places
  the frame as ``parallel/spatial.py``'s :class:`~playground3d_tpu_torch.
  parallel.spatial.Slabs`, the network code runs on them with the halo
  exchanges that XLA inserts in the JAX package, and the outputs come back
  whole on the lead device. On a :func:`make_mesh2` mesh each camera group
  (one index of the batch axis) runs on its own line of the space axis; a
  level that does not divide the axis lies whole on that line's first
  device (JAX replicates it over the whole mesh: the values are the same).

A mesh may list a device more than once (``["cpu"] * 8``, or one card
twice): that plays the part of the JAX tests' virtual CPU devices, and is how
the CPU tests and a one-card run reach the sharded code.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from playground3d_tpu_torch.parallel import spatial
from playground3d_tpu_torch.parallel.spatial import Line, Slabs

DATA_AXIS = "data"
SPACE_AXIS = "space"


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices on one named axis, or, with
    ``space_axis``, on two: ``devices`` row-major over (``axis``,
    ``space_axis``), ``n_space`` to a row."""

    devices: Tuple[torch.device, ...]
    axis: str = DATA_AXIS
    space_axis: Optional[str] = None
    n_space: int = 1

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as JAX's ``Mesh.shape``."""
        if self.space_axis is None:
            return {self.axis: self.size}
        return {self.axis: self.size // self.n_space, self.space_axis: self.n_space}

    def lines(self, axis: str) -> List[List[int]]:
        """The positions in ``devices`` of each line along ``axis`` (one a
        index of the other axis, in order)."""
        if axis not in self.shape:
            raise KeyError(f"mesh axes are {tuple(self.shape)}, not {axis!r}")
        rows = [list(range(r * self.n_space, (r + 1) * self.n_space)) for r in range(self.size // self.n_space)]
        return rows if axis == self.space_axis else [list(c) for c in zip(*rows)]

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


def make_mesh2(n_batch: int, n_space: int, batch_axis: str = DATA_AXIS, space_axis: str = SPACE_AXIS,
               devices=None) -> Mesh:
    """A 2-axis (batch or camera x space) mesh over the first ``n_batch *
    n_space`` of ``devices`` (default: every visible card), row-major: a row
    of ``n_space`` devices shares each camera group's frames, split on the
    width."""
    if batch_axis == space_axis:
        raise ValueError(f"make_mesh2: both axes are named {batch_axis!r}")
    flat = make_mesh(n_batch * n_space, devices=devices).devices
    return Mesh(flat, batch_axis, space_axis, n_space)


class P(tuple):
    """A partition spec, read as JAX's ``PartitionSpec``: the mesh axis (or
    None) each leading dimension is split on; ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spatial_sharding(mesh: Mesh, shape, axis: str = DATA_AXIS, batch_axis: Optional[str] = None) -> P:
    """The split of a frame batch ``[N, H', W', C]`` that shares one frame
    over ``axis``: the width where the size of the named axis divides it,
    else the height, else none. With ``batch_axis``, the leading dimension
    keeps that axis where it divides it."""
    n = mesh.shape[axis]
    b = batch_axis if (batch_axis is not None and len(shape) >= 1 and shape[0] % mesh.shape[batch_axis] == 0) else None
    if len(shape) >= 3 and shape[2] % n == 0:
        return P(b, None, axis)
    if len(shape) >= 2 and shape[1] % n == 0:
        return P(b, axis)
    return P(b) if b is not None else P()


def shard_spatial(mesh: Mesh, frames, axis: str = DATA_AXIS, batch_axis: Optional[str] = None):
    """``frames`` placed by :func:`spatial_sharding`: ``Slabs`` over the
    devices of ``axis`` (the frames whole on its first device where neither
    dimension divides it). With ``batch_axis``, a tuple of those, one a
    camera group along ``batch_axis`` on its own line of ``axis`` (one group
    on the first line where the axis does not divide the cameras)."""
    frames = torch.as_tensor(frames)
    spec = spatial_sharding(mesh, frames.shape, axis, batch_axis)
    dim = spec.index(axis) if axis in spec else None
    lines = [Line([mesh.devices[i] for i in pos]) for pos in mesh.lines(axis)]
    if batch_axis is None:
        return spatial.place(frames, dim, lines[0])
    groups = frames.chunk(len(lines)) if spec[0] == batch_axis else (frames,)
    return tuple(spatial.place(f, dim, line) for f, line in zip(groups, lines))


def spatial_constrainer(mesh: Mesh, axis: str = DATA_AXIS, batch_axis: Optional[str] = None):
    """The callable ``forward_raw(constrain=)`` applies to each pyramid
    level. JAX's rule (a level stays split over ``axis`` while its extent
    divides the axis, and is replicated otherwise) is kept where each level
    is made: a conv or pool on slabs whose output extent does not divide
    the axis gathers its input and runs whole on the line's first device
    (``parallel/spatial.py::_split_conv``). So every level reaches the
    heads placed by that rule, and the callable returns it as it is.
    ``axis`` and ``batch_axis`` (JAX's signature) must name axes of the
    mesh."""
    for name in (axis,) if batch_axis is None else (axis, batch_axis):
        if name not in mesh.shape:
            raise KeyError(f"the mesh has no axis {name!r}: {mesh.shape}")
    return _as_placed


def _as_placed(level):
    return level


def _line_forward(mesh: Mesh, model, placed: Sequence, lines: List[List[int]], constrain, depth, stem,
                  fw_kwargs, cache: dict):
    """``forward_raw`` of each placed camera group on its line, joined in
    group order on the mesh's lead device."""
    from playground3d_tpu_torch.models.retinanet import forward_raw

    if isinstance(model, (tuple, list)):
        copies = tuple(model)
    else:  # the copies of the last model given, kept
        if cache.get("model") is not model:
            cache.clear()
            cache["model"], cache["copies"] = model, replicate(mesh, model)
        copies = cache["copies"]
    if len(copies) != mesh.size:
        raise ValueError(f"{len(copies)} model copies for a {mesh.size}-device mesh")
    if (depth is not None and copies[0].depth != depth) or (stem is not None and copies[0].stem != stem):
        raise ValueError(f"the model is depth {copies[0].depth} / {copies[0].stem}, the forward was built for "
                         f"{depth} / {stem}")
    outs = []
    for x, pos in zip(placed, lines):
        models = tuple(copies[i] for i in pos)
        key = tuple(map(id, models))
        line = cache.get(key)
        if line is None:
            line = cache[key] = Line([mesh.devices[i] for i in pos], models)
        x = x.bind(line) if isinstance(x, Slabs) else x.to(line.devices[0])
        outs.append(forward_raw(models[0], x, constrain=constrain, **fw_kwargs))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[j].to(mesh.lead) for o in outs]) for j in range(len(outs[0])))


def spatial_forward(mesh: Mesh, depth: Optional[int] = None, stem: Optional[str] = None, axis: str = DATA_AXIS,
                    **fw_kwargs):
    """``fwd(model, frame) -> forward_raw(model, frame, **fw_kwargs)`` with
    the frame's width (else height) split over ``axis`` and every level
    constrained by :func:`spatial_constrainer`. ``model`` is the detector
    (copied to each device by :func:`replicate`) or its copies, one a mesh
    device; ``frame`` is placed by :func:`shard_spatial` or whole (then
    placed here; an s2d detector takes it packed, ``[N, H/4, W/4, 48]``).
    The outputs are whole tensors on the lead device, anchors in
    ``forward_raw``'s order. ``depth`` and ``stem``, where given, must be
    the model's."""
    constrain = spatial_constrainer(mesh, axis)
    cache: dict = {}

    def fwd(model, frame):
        placed = frame if isinstance(frame, Slabs) else shard_spatial(mesh, frame, axis)
        return _line_forward(mesh, model, (placed,), mesh.lines(axis)[:1], constrain, depth, stem, fw_kwargs,
                             cache)

    return fwd


def camera_spatial_forward(mesh: Mesh, depth: Optional[int] = None, stem: Optional[str] = None,
                           batch_axis: str = DATA_AXIS, space_axis: str = SPACE_AXIS, **fw_kwargs):
    """:func:`spatial_forward` on a :func:`make_mesh2` mesh: the cameras
    split over ``batch_axis``, each camera group's frames split on the
    width over its line of ``space_axis``; ``frames`` whole or placed by
    ``shard_spatial(mesh, frames, space_axis, batch_axis)``. The outputs
    are whole on the lead device, cameras in order."""
    constrain = spatial_constrainer(mesh, space_axis, batch_axis)
    cache: dict = {}

    def fwd(model, frames):
        placed = frames if isinstance(frames, tuple) else shard_spatial(mesh, frames, space_axis, batch_axis)
        return _line_forward(mesh, model, placed, mesh.lines(space_axis)[:len(placed)], constrain, depth, stem,
                             fw_kwargs, cache)

    return fwd


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
