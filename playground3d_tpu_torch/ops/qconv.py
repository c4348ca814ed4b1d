"""int8 x int8 -> int32 NHWC convolution with the dequantize epilogue fused
(and, for the last conv of a ResNet block, the block's residual add, relu
and requantize): the plain PyTorch version, the wrapper of the hand-written
CUDA kernel (``csrc/qconv.cu``), and the one entry that chooses.

It is the unit that ``models/quant.py`` builds its int8 paths from (the JAX
package's ``_chain_qconv`` / ``_chain_qconv_b`` / ``quant_conv_bn`` /
``quant_conv`` bodies after the input is quantized, and the tail of its
``block``):

    acc = conv(x int8 [N,H,W,Cin], wq int8 [Cout,k,k,Cin], stride, "SAME")   int32, exact
    out = float32(acc) * scale[c] + offset[c]         float32, two roundings
    out = relu(out)                                    if asked
    with a residual res [N,Ho,Wo,Cout] (int8 at scale res_xs, or bfloat16):
        r   = bfloat16(res) * bfloat16(res_xs)         or res as it is
        out = relu(bfloat16(out) + r)                  bfloat16 add
    emit None  -> bfloat16(out)
    emit xs    -> int8(clip(round_half_even(out / xs), -127, 127))

``"SAME"`` padding is split as XLA splits it (``models/nn.py::same_pads``).
The accumulator is an integer: K reaches 3*3*2048 = 18,432 and 18,432 * 127 *
127 = 3.0e8 is above 2^24, so a float32 sum would round (it stays below
2^31). ``out / xs`` is a true division by a scalar that lives on the device.

The plain version is exact on both devices: an int32 ``F.conv2d`` on the CPU
(torch has no integer convolution on the card) and a float64 convolution
there (every partial sum is an integer below 2^53). Its residual tail is the
unfused tensor-op sequence of the block, and is the definition the kernel is
held to. It is for the tests and for holding the kernel against; on the
card the paths of the package go through :func:`qconv`, which launches the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from playground3d_tpu_torch.models.nn import same_pads
from playground3d_tpu_torch.ops.cuda_build import KernelLibrary, count_launch

__all__ = ["LIB", "LaunchPlan", "check_args", "conv_int32_plain", "epilogue_plain", "explicit_pads", "launch_plan",
           "modelled_us", "qconv", "qconv_cuda", "qconv_plain", "split_range"]

# The kernel's layout constants (csrc/qconv.cu holds the same values).
CONSUMERS = 256  # two consumer warpgroups, 64 tile rows each
THREADS = 384  # and one producer warpgroup
TILE_M = 128  # output pixels per block
TILE_K = 128  # channels of one kernel tap per step: one 128-byte swizzled row
TILE_NS = (48, 64, 80, 112, 128, 256)  # output channels per block: the widths of wgmma the kernel has
STAGES = 4  # operand tiles in flight in shared memory
PITCH_PAD = 8  # ints after each row of the epilogue's int32 tile
MAX_SMEM_BYTES = 232448  # 227 KB: the most shared memory one block may ask for
MAX_BLOCKS_Y = 65535
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 32
# the plan's cost model (measured by scripts/qconv_block_timeline.py on an NVIDIA H100 80GB HBM3 at
# 700.00 W; PERF.md), by tile width:
STEP_US = {256: 0.6, 128: 0.4}  # one K step of a block (128 channels of one tap); 128 for every width below 256
EPILOGUE_US = {256: 7.0, 128: 3.5}  # a block's parked tile and epilogue
SPLIT_US = 3.0  # what splitting adds whatever the tile: the reductions' latency, the counter, the read-back
REDUCE_BYTES_PER_US = 1.3e6  # the rate of the partial tiles' bulk reductions into L2, all blocks together

ACC, BF16, INT8 = 0, 1, 2  # what the kernel stores
NO_RES, RES_INT8, RES_BF16 = 0, 1, 2  # the residual the epilogue adds


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qconv.argtypes = [ptr] * 9 + [i32] * 16 + [ptr]
    lib.qconv.restype = i32


LIB = KernelLibrary("qconv", _bind)


def explicit_pads(H: int, W: int, k: int, stride: int, pads=None):
    """((top, bottom), (left, right)): ``pads`` as given, or the ``"SAME"``
    pads of H and W. A slab of a wider frame that already carries its halo
    is given the frame's (``parallel/spatial.py``)."""
    return pads if pads is not None else (same_pads(H, k, stride), same_pads(W, k, stride))


def conv_int32_plain(x: torch.Tensor, wq: torch.Tensor, stride: int = 1, pads=None) -> torch.Tensor:
    """The exact accumulator: x int8 [N,H,W,Cin], wq int8 [Cout,k,k,Cin] ->
    int32 [N,Ho,Wo,Cout]; ``pads`` see :func:`explicit_pads`."""
    k = wq.shape[1]
    ph, pw = explicit_pads(x.shape[1], x.shape[2], k, stride, pads)
    kind = torch.int32 if x.device.type == "cpu" else torch.float64
    xi = F.pad(x.permute(0, 3, 1, 2).to(kind), (pw[0], pw[1], ph[0], ph[1]))
    acc = F.conv2d(xi, wq.permute(0, 3, 1, 2).to(kind), stride=stride)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def epilogue_plain(acc: torch.Tensor, scale: torch.Tensor, offset: Optional[torch.Tensor],
                   relu: bool, emit_xs: Optional[torch.Tensor], res: Optional[torch.Tensor] = None,
                   res_xs: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 [..,Cout] -> bfloat16, or int8 at the scale ``emit_xs``. With
    ``res`` (int8 at ``res_xs``, or bfloat16, the shape of ``acc``) the
    block's tail follows: ``relu(bfloat16(out) + dequantized res)``."""
    out = acc.to(torch.float32) * scale
    if offset is not None:
        out = out + offset
    if relu:
        out = torch.relu(out)
    if res is not None:
        r = res.to(torch.bfloat16) * res_xs.to(torch.bfloat16) if res.dtype == torch.int8 else res
        out = torch.relu(out.to(torch.bfloat16) + r)
    if emit_xs is None:
        return out.to(torch.bfloat16)
    return torch.clamp(torch.round(out.to(torch.float32) / emit_xs), -127.0, 127.0).to(torch.int8)


def qconv_plain(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None,
                res=None, res_xs=None, pads=None):
    """The plain version of :func:`qconv` (see the module docstring)."""
    return epilogue_plain(conv_int32_plain(x, wq, stride, pads), scale, offset, relu, emit_xs, res, res_xs)


class LaunchPlan(NamedTuple):
    ho: int
    wo: int
    pad_top: int
    pad_left: int
    tiles_m: int  # tiles of TILE_M output pixels (grid x)
    tiles_n: int  # tiles of tile_n output channels (grid y)
    tile_n: int  # one of TILE_NS
    steps: int  # K steps: taps x chunks of TILE_K channels
    splits: int  # blocks that share one tile's K steps (grid z)
    smem_bytes: int  # dynamic shared memory per block
    workspace_ints: int  # int32 workspace of a split conv: counters, then partial sums (0 unsplit)


def split_range(steps: int, splits: int, j: int):
    """The K steps [s0, s1) of split ``j`` (the kernel's own rule)."""
    return steps * j // splits, steps * (j + 1) // splits


def modelled_us(steps: int, tiles: int, splits: int, m: int, tiles_n: int, tile_n: int) -> float:
    """Modelled microseconds of a conv's blocks: waves of ``SMS`` blocks, each
    a share of the K steps and an epilogue at its tile width, and where K is
    split, the fixed cost plus every block's partial sums (its ``m`` output
    pixels' rows of ``tile_n`` int32, per column tile) added into the
    workspace."""
    width = 256 if tile_n == 256 else 128
    waves = -(-tiles * splits // SMS)
    cost = waves * (-(-steps // splits) * STEP_US[width] + EPILOGUE_US[width])
    if splits > 1:
        cost += SPLIT_US + splits * m * tiles_n * tile_n * 4 / REDUCE_BYTES_PER_US
    return cost


@functools.lru_cache(maxsize=4096)
def launch_plan(N: int, H: int, W: int, Cin: int, Cout: int, k: int, stride: int, pads=None) -> LaunchPlan:
    """What the host decides for one call, from shapes alone (``pads`` see
    :func:`explicit_pads`; the kernel reads zeros past the bottom and right
    edges, so only the top and left pads are passed). Raises
    ValueError for what the kernel does not take. Cached: a network
    launches the same few dozen shapes every frame.

    The tile is 128 pixels by the narrowest width of ``TILE_NS`` that holds
    the layer's filters, or for more than 128 filters, 256 or 128 wide. Where
    the tiles leave SMs idle, K may be split among ``splits`` blocks per
    tile, at most ``MAX_SPLITS`` and within one wave of ``SMS``. Of these the
    plan takes the width and split of the least :func:`modelled_us` (the
    wider tile and the fewer splits on a tie)."""
    if k not in (1, 3) or stride not in (1, 2):
        raise ValueError(f"qconv: kernel size must be 1 or 3 and stride 1 or 2, got k={k} stride={stride}")
    if Cin < 16 or Cin % 16:
        raise ValueError(f"qconv: input channels must be a positive multiple of 16, got {Cin}")
    if min(N, H, W, Cout) < 1:
        raise ValueError(f"qconv: empty problem N={N} H={H} W={W} Cout={Cout}")
    (pt, pb), (pl, pr) = explicit_pads(H, W, k, stride, pads)
    ho, wo = (H + pt + pb - k) // stride + 1, (W + pl + pr - k) // stride + 1
    if min(ho, wo) < 1:
        raise ValueError(f"qconv: pads {pads} leave no output of {H}x{W}")
    m = N * ho * wo
    if N * H * W * Cin >= 2**31 or m * Cout >= 2**31:
        raise ValueError("qconv: input or output exceed 2^31 elements")
    tiles_m = -(-m // TILE_M)
    steps = k * k * -(-Cin // TILE_K)
    widths = (256, 128) if Cout > 128 else (next(t for t in TILE_NS if t >= Cout),)
    if -(-Cout // widths[-1]) > MAX_BLOCKS_Y:
        raise ValueError(f"qconv: {Cout} output channels exceed the grid")
    options = [(tn, s) for tn in widths
               for s in range(1, max(1, min(SMS // (tiles_m * -(-Cout // tn)), steps, MAX_SPLITS)) + 1)]
    tile_n, splits = min(options, key=lambda o: (
        modelled_us(steps, tiles_m * -(-Cout // o[0]), o[1], m, -(-Cout // o[0]), o[0]), -o[0], o[1]))
    tiles_n = -(-Cout // tile_n)
    tiles = tiles_m * tiles_n
    workspace = -(-tiles // 64) * 64 + tiles * TILE_M * tile_n if splits > 1 else 0
    # the operand stages, or the epilogue's int32 tile and residual tile where larger; + 1,024 to align
    smem = max(STAGES * (TILE_M + tile_n) * TILE_K, TILE_M * (tile_n + PITCH_PAD) * 4 + TILE_M * tile_n * 2) + 1024
    return LaunchPlan(ho, wo, pt, pl, tiles_m, tiles_n, tile_n, steps, splits, smem, workspace)


def check_args(x, wq, scale, offset, stride, emit_xs, res=None, res_xs=None, pads=None) -> None:
    """Raise ValueError on anything the kernel does not take: x int8
    [N,H,W,Cin], wq int8 [Cout,k,k,Cin], scale (and offset) float32 [Cout],
    emit_xs a float32 scalar tensor, res int8 (with res_xs, a float32
    scalar tensor) or bfloat16 of the output's shape, all contiguous and on
    one device."""
    if x.dtype != torch.int8 or x.ndim != 4:
        raise ValueError(f"qconv: x must be int8 [N,H,W,Cin], got {x.dtype} {tuple(x.shape)}")
    if wq.dtype != torch.int8 or wq.ndim != 4 or wq.shape[1] != wq.shape[2] or wq.shape[3] != x.shape[3]:
        raise ValueError(
            f"qconv: wq must be int8 [Cout,k,k,{x.shape[3]}], got {wq.dtype} {tuple(wq.shape)}"
        )
    cout = wq.shape[0]
    for name, t in (("scale", scale), ("offset", offset)):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) != (cout,)):
            raise ValueError(f"qconv: {name} must be float32 [{cout}], got {t.dtype} {tuple(t.shape)}")
    for name, t in (("emit_xs", emit_xs), ("res_xs", res_xs)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
            raise ValueError(f"qconv: {name} must be one float32, got {t.dtype} {tuple(t.shape)}")
    plan = launch_plan(x.shape[0], x.shape[1], x.shape[2], x.shape[3], cout, wq.shape[1], stride, pads)
    if res is not None:
        want = (x.shape[0], plan.ho, plan.wo, cout)
        if res.dtype not in (torch.int8, torch.bfloat16) or tuple(res.shape) != want:
            raise ValueError(f"qconv: res must be int8 or bfloat16 {list(want)}, got {res.dtype} {tuple(res.shape)}")
        if (res.dtype == torch.int8) != (res_xs is not None):
            raise ValueError("qconv: res_xs goes with an int8 res, and only with one")
    elif res_xs is not None:
        raise ValueError("qconv: res_xs without res")
    for name, t in (("x", x), ("wq", wq), ("scale", scale), ("offset", offset), ("emit_xs", emit_xs),
                    ("res", res), ("res_xs", res_xs)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"qconv: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"qconv: {name} is on {t.device}, x on {x.device}")
    if any(t is not None and t.data_ptr() % 16 for t in (x, wq, res)):
        raise ValueError("qconv: x, wq and res must start on a 16-byte boundary")


_WORKSPACE: dict = {}


def _workspace(device: torch.device, ints: int) -> torch.Tensor:
    """The split convs' int32 workspace on ``device``, zero between calls
    (the kernel leaves it so), grown when a call needs more. Calls share it,
    so they run on one stream, as the package's do."""
    ws = _WORKSPACE.get(device)
    if ws is None or ws.numel() < ints:
        ws = torch.zeros(max(ints, 1 << 20), dtype=torch.int32, device=device)
        _WORKSPACE[device] = ws
    return ws


def qconv_cuda(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None,
               res=None, res_xs=None, store: Optional[int] = None, pads=None) -> torch.Tensor:
    """Launch the kernel on the current stream -> [N,Ho,Wo,Cout] bfloat16, or
    int8 when ``emit_xs`` is given. ``store=ACC`` returns the raw int32
    accumulators instead (for holding them against the plain version).
    ``qconv_cuda.launches`` counts the launches."""
    if x.device.type != "cuda":
        raise ValueError(f"qconv: the CUDA kernel takes CUDA tensors, got {x.device}")
    check_args(x, wq, scale, offset, stride, emit_xs, res, res_xs, pads)
    N, H, W, Cin = x.shape
    cout, k = wq.shape[0], wq.shape[1]
    plan = launch_plan(N, H, W, Cin, cout, k, stride, pads)
    if store is None:
        store = BF16 if emit_xs is None else INT8
    if store == ACC and res is not None:
        raise ValueError("qconv: store=ACC takes no residual")
    kind = {ACC: torch.int32, BF16: torch.bfloat16, INT8: torch.int8}[store]
    out = torch.empty((N, plan.ho, plan.wo, cout), dtype=kind, device=x.device)
    ws = _workspace(x.device, plan.workspace_ints) if plan.splits > 1 else None
    res_kind = NO_RES if res is None else (RES_INT8 if res.dtype == torch.int8 else RES_BF16)
    lib = LIB.load()
    with torch.cuda.device(x.device):
        err = lib.qconv(
            x.data_ptr(), wq.data_ptr(), scale.data_ptr(),
            offset.data_ptr() if offset is not None else None,
            emit_xs.data_ptr() if emit_xs is not None else None,
            res.data_ptr() if res is not None else None,
            res_xs.data_ptr() if res_xs is not None else None,
            out.data_ptr(), ws.data_ptr() if ws is not None else None,
            N, H, W, Cin, cout, k, stride, plan.ho, plan.wo, plan.pad_top, plan.pad_left,
            int(bool(relu)), store, res_kind, plan.tile_n, plan.splits, torch.cuda.current_stream().cuda_stream,
        )
    LIB.check(err)
    count_launch(qconv_cuda)
    return out


qconv_cuda.launches = 0


def qconv(x, wq, scale, offset=None, stride: int = 1, relu: bool = False, emit_xs=None,
          res=None, res_xs=None, pads=None) -> torch.Tensor:
    """The int8 convolution with its fused epilogue (see the module
    docstring): the CUDA kernel for tensors on the card, the plain version
    for tensors on the CPU. ``pads`` see :func:`explicit_pads`."""
    if x.device.type == "cuda":
        return qconv_cuda(x.contiguous(), wq, scale, offset, stride, relu, emit_xs,
                          None if res is None else res.contiguous(), res_xs, pads=pads)
    if x.device.type == "cpu":
        return qconv_plain(x, wq, scale, offset, stride, relu, emit_xs, res, res_xs, pads)
    raise ValueError(f"qconv: no implementation for device {x.device}")
