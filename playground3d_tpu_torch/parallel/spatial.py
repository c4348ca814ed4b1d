"""One frame split over the devices of a mesh axis: the slab tensor the
detector runs on and the halo exchange between slabs. This is the part of
``playground3d_tpu/parallel/mesh.py``'s spatial partitioning that XLA's
partitioner inserts on its own; PyTorch has no partitioner, so it is done
here, and ``parallel/mesh.py`` builds ``spatial_forward`` on it.

A :class:`Slabs` is an activation split on one spatial dimension (the width,
or the height where the width does not divide the axis) into contiguous
slabs of equal extent, one a device of the axis in mesh order, each on its
device; it keeps the global shape. A tensor that is not split (a level whose
extent does not divide the axis) is *replicated*: one plain tensor on the
axis's first device, the lead, which runs everything on it.

Slabs take part in PyTorch's ``__torch_function__`` protocol, so the one copy
of the network code (``models/resnet.py``, ``fpn.py``, ``heads.py``,
``quant.py`` and ``retinanet.forward_raw``) runs on them as it is:

* a convolution or the conv7 stem's max pool (``Conv.forward``,
  ``quant._qconv_nchw``, ``nn.max_pool``) splits its output evenly where the
  output extent divides the axis. Shard i's output columns [a, b) need the
  input columns [a*s - pad, (b-1)*s - pad + k), ``pad`` being the ``"SAME"``
  pad of the *global* extent: they are copied from whichever slabs hold them
  (more than one neighbour where a slab is narrower than its halo), with
  zeros (-inf for the pool) outside the frame, and the slab's conv runs with
  no padding on the split dimension and the ``"SAME"`` pads of the other.
  Where the output extent does not divide the axis, the input is gathered
  onto the lead and the output is replicated. int8 activations are
  exchanged as int8;
* ``FrozenBN``, elementwise arithmetic, ``relu``, ``sigmoid``, dtype
  casts, ``permute`` and ``quant._quantize_act`` (on the card one quantize
  kernel a slab) run slab by slab (an operand that does not span the split
  dimension is broadcast);
  ``upsample2x_nearest`` doubles each slab; ``crop_add`` crops at the
  frame's right or bottom edge, which lies in the last slab;
* ``reshape``, the heads' reshape of each level into anchors, gathers its
  split argument onto the lead and runs there, so anchors keep the unsplit
  order, (H, W, anchor) in level order;
* any other function raises ``TypeError``: it would gather the slabs and
  run the rest of the forward whole on the lead, unseen.

So JAX's placement rule for the pyramid levels (a level stays split while
its extent divides the axis, and is replicated otherwise) is kept by the
window ops themselves, in :func:`_split_conv` and :func:`_crop_add`.

Each slab runs the modules and buffers of the model's copy on its device
(:class:`Line`, from ``mesh.replicate``), found by the lead copy's identity;
an operand that no copy holds (a constant made during the forward) is copied
to the slab's device. A copy between cards waits for both cards' streams
(``Tensor.to``). :data:`HALO` counts what the windows took from other slabs
and the joins of slabs onto the lead.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch.utils._pytree import tree_map

from playground3d_tpu_torch.models import quant
from playground3d_tpu_torch.models.nn import Conv, FrozenBN, crop_add, max_pool, same_pads, upsample2x_nearest

# slab pieces copied into other shards' windows, and slabs joined onto the lead; the caller resets it
HALO = {"bytes": 0, "copies": 0, "joins": 0}


class Line:
    """The devices of one line of a mesh axis, in mesh order, and the model
    copies on them (none: every slab runs the lead's modules, which is right
    where all the devices are one)."""

    def __init__(self, devices: Sequence[torch.device], models: Sequence[torch.nn.Module] = ()):
        self.devices = tuple(torch.device(d) for d in devices)
        self.models = tuple(models)
        self._maps: List[dict] = [{} for _ in self.devices]
        for mp, m in zip(self._maps, self.models):
            if m is self.models[0]:
                continue
            lead = self.models[0]
            for a, b in zip(lead.modules(), m.modules()):
                mp[id(a)] = b
            for a, b in zip(list(lead.parameters()) + list(lead.buffers()), list(m.parameters()) + list(m.buffers())):
                mp[id(a)] = b

    def obj(self, i: int, o):
        """Shard ``i``'s copy of the lead's module or tensor ``o``."""
        return self._maps[i].get(id(o), o)

    def tensor(self, i: int, t: torch.Tensor) -> torch.Tensor:
        t = self.obj(i, t)
        dev = self.devices[i]
        return t if t.device == dev else t.to(dev, non_blocking=True)


class Slabs:
    """An activation split evenly on dimension ``sdim`` over ``line``'s
    devices (see the module docstring)."""

    def __init__(self, parts: Sequence[torch.Tensor], sdim: int, size: int, line: Line):
        if len(parts) != len(line.devices) or size % len(parts):
            raise ValueError(f"{len(parts)} slabs of an extent of {size} over {len(line.devices)} devices")
        self.parts, self.sdim, self.size, self.line = tuple(parts), sdim, size, line

    @property
    def width(self) -> int:
        """The extent of each slab on the split dimension."""
        return self.size // len(self.parts)

    @property
    def shape(self) -> torch.Size:
        s = list(self.parts[0].shape)
        s[self.sdim] = self.size
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.line.devices[0]

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    def join(self) -> torch.Tensor:
        """The whole tensor on the lead."""
        if len(self.parts) == 1:
            return self.parts[0]
        HALO["joins"] += 1
        lead = self.line.devices[0]
        return torch.cat([p.to(lead, non_blocking=True) for p in self.parts], self.sdim)

    def bind(self, line: Line) -> "Slabs":
        """The same slabs, run with ``line``'s model copies."""
        if line.devices != self.line.devices:
            raise ValueError(f"slabs on {self.line.devices} bound to a line of {line.devices}")
        return Slabs(self.parts, self.sdim, self.size, line)

    def __repr__(self) -> str:
        return f"Slabs({tuple(self.shape)}, {self.dtype}, split on {self.sdim} over {len(self.parts)})"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        split = _SPLIT.get(func)
        if split is not None:
            return split(*args, **kwargs)
        if func in _PER_SLAB:
            out = _per_slab(func, args, kwargs)
            if out is not None:
                return out
        if func not in _GATHER:
            raise TypeError(f"{getattr(func, '__qualname__', func)} is no operation on slabs (parallel/spatial.py): "
                            "it would gather them onto the lead and run the rest of the forward whole there")
        args, kwargs = tree_map(_joined, (args, kwargs))
        return func(*args, **kwargs)

    def __getattr__(self, name):
        # tensor methods (reshape, permute, to, ...) go through __torch_function__
        if name.startswith("_") or not hasattr(torch.Tensor, name):
            raise AttributeError(name)
        f = getattr(torch.Tensor, name)
        return lambda *a, **k: Slabs.__torch_function__(f, (Slabs,), (self,) + a, k)


def _operator(name):
    f = getattr(torch.Tensor, name)
    return lambda self, *a: Slabs.__torch_function__(f, (Slabs,), (self,) + a)


_OPERATORS = ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__", "__rmul__", "__truediv__",
              "__rtruediv__", "__neg__")
for _name in _OPERATORS:
    setattr(Slabs, _name, _operator(_name))

_PER_SLAB = {torch.add, torch.sub, torch.mul, torch.div, torch.relu, torch.sigmoid, torch.Tensor.add, torch.Tensor.sub,
             torch.Tensor.mul, torch.Tensor.div, torch.Tensor.relu, torch.Tensor.sigmoid, torch.Tensor.to,
             *(getattr(torch.Tensor, n) for n in _OPERATORS), quant._quantize_act}


_GATHER = {torch.Tensor.reshape}  # the heads' reshape of each level into anchors


def _joined(x):
    return x.join() if isinstance(x, Slabs) else x


def _per_slab(func, args, kwargs) -> Optional[Slabs]:
    """``func`` slab by slab, or None where that would not be ``func`` of the
    whole (split operands that differ, an operand spanning the split
    dimension, a cast that names a device)."""
    split = [a for a in args if isinstance(a, Slabs)]
    ref = split[0]
    if any((a.sdim, a.size, a.line.devices) != (ref.sdim, ref.size, ref.line.devices) for a in split):
        return None
    if func is torch.Tensor.to and (set(kwargs) - {"dtype"} or not all(isinstance(a, torch.dtype) for a in args[1:])):
        return None
    back = ref.ndim - ref.sdim  # the split dimension, counted from the right
    if any(isinstance(a, torch.Tensor) and a.ndim >= back and a.shape[-back] != 1 for a in args):
        return None
    parts = []
    for i in range(len(ref.parts)):
        pieces = [a.parts[i] if isinstance(a, Slabs) else ref.line.tensor(i, a) if isinstance(a, torch.Tensor)
                  else a for a in args]
        parts.append(func(*pieces, **kwargs))
    return Slabs(parts, ref.sdim, ref.size, ref.line)


def _window(x, d: int, line: Line, i: int, lo: int, hi: int, fill=None) -> torch.Tensor:
    """Indices [lo, hi) of dimension ``d`` of ``x`` (slabs, or a replicated
    tensor) on shard ``i``'s device, ``fill`` outside [0, extent)."""
    if isinstance(x, Slabs):
        sources, size = [(j, j * x.width, p) for j, p in enumerate(x.parts)], x.size
    else:
        sources, size = [(None, 0, x)], x.shape[d]
    dev = line.devices[i]
    pieces = []
    for j, start, p in sources:
        a, b = max(lo, start), min(hi, start + p.shape[d])
        if a < b:
            piece = p.narrow(d, a - start, b - a)
            if j is not None and j != i:
                HALO["bytes"] += piece.numel() * piece.element_size()
                HALO["copies"] += 1
            pieces.append(piece.to(dev, non_blocking=True))
    left, right = max(0, -lo), max(0, hi - size)
    if left or right:
        if fill is None:
            raise ValueError(f"window [{lo}, {hi}) outside an extent of {size}")
        like = pieces[0]
        fmt = torch.channels_last if like.ndim == 4 else torch.contiguous_format

        def filled(n):
            shape = list(like.shape)
            shape[d] = n
            return [torch.empty(shape, dtype=like.dtype, device=dev, memory_format=fmt).fill_(fill)] if n else []

        pieces = filled(left) + pieces + filled(right)
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, d)


def _split_conv(x: Slabs, k: int, stride: int, run, fill) -> "Slabs | torch.Tensor":
    """A k x k / stride window op on NCHW slabs: ``run(i, window, pads, a,
    b)`` gives shard i's output indices [a, b) from its window; where the
    output extent does not divide the axis, ``run(0, whole, None, 0, n)``
    gives the replicated output."""
    d, n, line = x.sdim, len(x.parts), x.line
    out = -(-x.size // stride)
    if out % n:
        return run(0, x.join(), None, 0, out)
    m, pad = out // n, same_pads(x.size, k, stride)[0]
    other = same_pads(x.shape[5 - d], k, stride)  # NCHW: the height's pads for a split width, and back
    pads = (other, (0, 0)) if d == 3 else ((0, 0), other)
    parts = [run(i, _window(x, d, line, i, i * m * stride - pad, ((i + 1) * m - 1) * stride - pad + k, fill),
                 pads, i * m, (i + 1) * m) for i in range(n)]
    return Slabs(parts, d, out, line)


def _conv(conv: Conv, x: Slabs, stride: int = 1, dtype=torch.bfloat16, pads=None):
    if pads is not None:
        raise ValueError("a conv on slabs takes the frame's pads from the slabs")
    return _split_conv(x, conv.k, stride, lambda i, w, p, a, b: x.line.obj(i, conv)(w, stride, dtype, pads=p), 0)


def _bn(bn: FrozenBN, x: Slabs):
    return Slabs([x.line.obj(i, bn)(p) for i, p in enumerate(x.parts)], x.sdim, x.size, x.line)


def _max_pool(x: Slabs, k: int = 3, stride: int = 2, pads=None):
    if pads is not None:
        raise ValueError("a max pool on slabs takes the frame's pads from the slabs")
    return _split_conv(x, k, stride, lambda i, w, p, a, b: max_pool(w, k, stride, p), float("-inf"))


def _upsample(x: Slabs):
    return Slabs([upsample2x_nearest(p) for p in x.parts], x.sdim, 2 * x.size, x.line)


def _crop_add(a, b):
    s = a if isinstance(a, Slabs) else b
    d, line, n = s.sdim, s.line, len(s.parts)
    e = min(a.shape[d], b.shape[d])
    if e % n or any(isinstance(t, Slabs) and t.sdim != d for t in (a, b)):
        return crop_add(_joined(a), _joined(b))
    m = e // n
    parts = [crop_add(_window(a, d, line, i, i * m, (i + 1) * m), _window(b, d, line, i, i * m, (i + 1) * m))
             for i in range(n)]
    return Slabs(parts, d, e, line)


def _qconv(conv, bn, xq, s_in, stride, relu, emit_xs, res=None, res_xs=None, pads=None):
    if pads is not None:
        raise ValueError("an int8 conv on slabs takes the frame's pads from the slabs")
    if not isinstance(xq, Slabs):  # a replicated input: so is the output
        return quant._qconv_nchw(conv, bn, xq, s_in, stride, relu, emit_xs, _joined(res), res_xs)
    line = xq.line

    def run(i, w, p, a, b):
        o, t = line.obj, line.tensor
        r = None if res is None else _joined(res) if p is None else _window(res, xq.sdim, line, i, a, b)
        return quant._qconv_nchw(o(i, conv), None if bn is None else o(i, bn), w, t(i, s_in), stride, relu,
                                 None if emit_xs is None else t(i, emit_xs), r,
                                 None if res_xs is None else t(i, res_xs), p)

    return _split_conv(xq, conv.wq.shape[1], stride, run, 0)


def _permute(x: Slabs, *dims):
    if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
        dims = tuple(dims[0])
    dims = [dd % x.ndim for dd in dims]
    return Slabs([p.permute(*dims) for p in x.parts], dims.index(x.sdim), x.size, x.line)


_SPLIT = {Conv.forward: _conv, FrozenBN.forward: _bn, max_pool: _max_pool, upsample2x_nearest: _upsample,
          crop_add: _crop_add, quant._qconv_nchw: _qconv, torch.Tensor.permute: _permute}


def place(x: torch.Tensor, dim: Optional[int], line: Line) -> "Slabs | torch.Tensor":
    """``x`` split evenly on ``dim`` over ``line``'s devices, or whole on
    its lead for ``dim`` None."""
    if dim is None:
        return x.to(line.devices[0])
    m = x.shape[dim] // len(line.devices)
    return Slabs([x.narrow(dim, i * m, m).contiguous().to(dev, non_blocking=True)
                  for i, dev in enumerate(line.devices)], dim, x.shape[dim], line)
