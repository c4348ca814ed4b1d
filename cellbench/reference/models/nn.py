# A frozen copy of the port's models/nn.py, the benchmark's plain reference: the plain
# PyTorch paths only, no kernel launch and no import of the port.
"""Layer building blocks (port of ``playground3d_tpu/models/nn.py``).

Modules hold float32 parameters named as the JAX tree's keys (``w``, ``b``;
frozen BN ``scale``/``offset``/``mean``/``var`` as buffers); conv weights
are OIHW. Activations inside the networks are NCHW tensors in
channels-last memory order (the public entry points take NHWC, as the JAX
package does). The compute dtype is a call argument, bf16 by default.

Two details keep the numerics of ``jax.lax.conv_general_dilated``:

* ``"SAME"`` padding. XLA pads ``total = max((ceil(n/s)-1)*s + k - n, 0)``
  with the odd pixel at the end: the 7x7/2 stem pads (2,3) on an even
  extent, stride-2 3x3 convs (0,1). Torch's ``padding=`` is symmetric, so
  the asymmetric cases go through an explicit ``F.pad``.
* rounding order. Input and weight are cast to the compute dtype, the conv
  emits that dtype, and the bias is added after the conv in that dtype, as
  ``conv_apply`` does (``nn.py:64-74``); frozen BN is ``x*a + b`` with
  ``a``/``b`` folded in float32 and then cast.

``Conv.forward``, ``FrozenBN.forward``, :func:`max_pool`,
:func:`upsample2x_nearest` and :func:`crop_add` take part in PyTorch's
``__torch_function__`` protocol: an activation split over devices
(``parallel/spatial.py::Slabs``) runs them slab by slab, with the halo
exchange, through the same network code.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function, has_torch_function_unary

from cellbench.reference import precision


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA ``"SAME"`` padding (before, after) of one spatial extent."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def he_normal(shape, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.randn(shape, generator=generator, dtype=torch.float32) * math.sqrt(2.0 / fan_in)


class Conv(nn.Module):
    """k x k convolution with ``"SAME"`` padding; the stride is a call
    argument, as in ``conv_apply``.

    A conv that post-training quantization has reached (``models/quant.py``)
    also holds ``wq`` (int8 weights, [out, k, k, in]), ``ws`` (float32
    per-output-channel weight scale) and ``xs`` (float32 scalar, the static
    scale of its input activations); they are ``None`` otherwise. ``forward``
    is the float convolution either way."""

    def __init__(self, in_ch: int, out_ch: int, k: int, bias: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.k = k
        self.w = nn.Parameter(he_normal((out_ch, in_ch, k, k), k * k * in_ch, generator))
        self.b = nn.Parameter(torch.zeros(out_ch)) if bias else None
        for name in ("wq", "ws", "xs"):
            self.register_buffer(name, None)

    def forward(self, x: torch.Tensor, stride: int = 1, dtype=torch.bfloat16, pads=None) -> torch.Tensor:
        """``pads`` ((top, bottom), (left, right)) replaces the ``"SAME"``
        pads of ``x``'s own extent: a slab of a wider frame that carries its
        halo takes those of the frame (``parallel/spatial.py``)."""
        if has_torch_function_unary(x):
            return handle_torch_function(Conv.forward, (x,), self, x, stride, dtype, pads)
        ph, pw = pads if pads is not None else (same_pads(x.shape[2], self.k, stride),
                                                 same_pads(x.shape[3], self.k, stride))
        x = x.to(dtype)
        w = self.w.to(dtype)
        if precision.FP8:
            x, w = precision.fp8_round(x), precision.fp8_round(w)
        # PyTorch's CPU bf16 convolution leaves the weight gradient's padding
        # taps unset (NaN at random) for a 1-pixel input at stride 2 with
        # implicit padding; padded explicitly, every tap reads a zero
        one_pixel = stride > 1 and 1 in x.shape[2:]
        if ph[0] == ph[1] and pw[0] == pw[1] and not one_pixel:
            out = F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
        else:
            out = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)
        if self.b is not None:
            out = out + self.b.to(dtype)[None, :, None, None]
        return out


def apply_conv(conv: Conv, x: torch.Tensor, stride: int = 1, dtype=torch.bfloat16) -> torch.Tensor:
    """The float convolution as a callable ``conv(module, x, stride=, dtype=)``:
    the default unit of the FPN and the heads, which take another in its
    place (``models/quant.py``)."""
    return conv(x, stride, dtype)


class FrozenBN(nn.Module):
    """Inference-mode batch norm folded to one multiply-add (the reference
    never trains BN statistics, model.py:260,278-282)."""

    def __init__(self, ch: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("scale", torch.ones(ch))
        self.register_buffer("offset", torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if has_torch_function_unary(x):
            return handle_torch_function(FrozenBN.forward, (x,), self, x)
        inv = torch.rsqrt(self.var + self.eps) * self.scale
        a = inv.to(x.dtype)[None, :, None, None]
        b = (self.offset - self.mean * inv).to(x.dtype)[None, :, None, None]
        return x * a + b


def max_pool(x: torch.Tensor, k: int = 3, stride: int = 2, pads=None) -> torch.Tensor:
    """``"SAME"`` max pooling: -inf padding, XLA's split of the pad;
    ``pads`` as in :meth:`Conv.forward`."""
    if has_torch_function_unary(x):
        return handle_torch_function(max_pool, (x,), x, k, stride, pads)
    ph, pw = pads if pads is not None else (same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k, stride))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (reference FPN, model.py:65)."""
    if has_torch_function_unary(x):
        return handle_torch_function(upsample2x_nearest, (x,), x)
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def crop_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Add after cropping both to the common spatial size (the reference's
    shape-mismatch fix, model.py:92-97)."""
    if has_torch_function((a, b)):
        return handle_torch_function(crop_add, (a, b), a, b)
    h = min(a.shape[2], b.shape[2])
    w = min(a.shape[3], b.shape[3])
    return a[:, :, :h, :w] + b[:, :, :h, :w]


# ---------------------------------------------------------------------------
# checkpoints in the JAX package's format
# ---------------------------------------------------------------------------


