"""What the host decides for the int8 convolution kernel, and the residual
tail fused into its epilogue, tested without a card.

* ``ops/qconv.py::launch_plan``: the tile width (a wgmma width, the extra
  columns zero-filled; 128 or 256 for wider layers) and the split of the K
  loop among blocks for small maps, of least modelled cost, the shared
  memory and the workspace, from shapes alone; ``split_range`` gives every
  (tap, channel chunk) step to exactly one block of a tile.
* ``epilogue_plain`` with a residual equals the unfused tensor-op tail of a
  ResNet block (``relu(bfloat16 conv output + dequantized residual)``, then
  requantize or not) bit for bit, and ``models/quant.py::_chain_block``,
  which fuses that tail into the last conv, equals the unfused block on the
  CPU bit for bit, for basic and bottleneck blocks, int8 and bfloat16
  residuals, int8 and bfloat16 outputs.

The kernel itself is held against the plain version on the card
(``chip_smoke.py``).
"""

import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from playground3d_tpu_torch.models import quant as PQ
from playground3d_tpu_torch.models.retinanet import retinanet_init
from playground3d_tpu_torch.ops import qconv as QC

torch.set_num_threads(1)


def _check_plan(plan, N, H, W, Cin, Cout, k, stride):
    """The invariants of every plan."""
    # the tile width: the narrowest wgmma width that holds the layer's filters, or 128 / 256 beyond 128
    widths = (256, 128) if Cout > 128 else (min(t for t in QC.TILE_NS if t >= Cout),)
    assert plan.tile_n in QC.TILE_NS and plan.tile_n in widths
    assert plan.tiles_n * plan.tile_n >= Cout > (plan.tiles_n - 1) * plan.tile_n
    assert plan.tiles_m * QC.TILE_M >= N * plan.ho * plan.wo > (plan.tiles_m - 1) * QC.TILE_M
    # shared memory: the operand stages, or the epilogue's int32 tile and bfloat16 residual tile if larger
    stages = QC.STAGES * (QC.TILE_M + plan.tile_n) * QC.TILE_K
    epilogue = QC.TILE_M * (plan.tile_n + QC.PITCH_PAD) * 4 + QC.TILE_M * plan.tile_n * 2
    assert plan.smem_bytes == max(stages, epilogue) + 1024 <= QC.MAX_SMEM_BYTES
    # K: taps x chunks of TILE_K channels, split only where the tiles leave SMs idle; the width and the
    # split of the least modelled cost, the wider tile and the fewer splits on a tie
    assert plan.steps == k * k * -(-Cin // QC.TILE_K)
    tiles = plan.tiles_m * plan.tiles_n
    assert 1 <= plan.splits <= min(plan.steps, QC.MAX_SPLITS)
    m = N * plan.ho * plan.wo
    costs = {}
    for tn in widths:
        tiles_n = -(-Cout // tn)
        for s in range(1, max(1, min(QC.SMS // (plan.tiles_m * tiles_n), plan.steps, QC.MAX_SPLITS)) + 1):
            costs[tn, s] = QC.modelled_us(plan.steps, plan.tiles_m * tiles_n, s, m, tiles_n, tn)
    best = costs[plan.tile_n, plan.splits]
    assert best == min(costs.values())
    assert all(c > best for (tn, s), c in costs.items() if tn > plan.tile_n or (tn == plan.tile_n and s < plan.splits))
    if plan.splits > 1:
        assert tiles * plan.splits <= QC.SMS
        # the counters, then each tile's partial sums
        assert plan.workspace_ints == -(-tiles // 64) * 64 + tiles * QC.CONSUMERS * plan.tile_n // 2
    else:
        assert plan.workspace_ints == 0
    # every (tap, chunk) step of a tile goes to exactly one block
    chunks = plan.steps // (k * k)
    taken = [divmod(s, chunks) for j in range(plan.splits) for s in range(*QC.split_range(plan.steps, plan.splits, j))]
    assert taken == [(tap, c) for tap in range(k * k) for c in range(chunks)]


@given(N=st.integers(1, 40), H=st.integers(1, 300), W=st.integers(1, 500), cin16=st.integers(1, 160),
       Cout=st.integers(1, 2048), k=st.sampled_from([1, 3]), stride=st.sampled_from([1, 2]))
@settings(max_examples=300, deadline=None)
def test_launch_plan_invariants(N, H, W, cin16, Cout, k, stride):
    Cin = 16 * cin16
    assume(N * H * W * Cin < 2**31 and N * -(-H // stride) * -(-W // stride) * Cout < 2**31)
    _check_plan(QC.launch_plan(N, H, W, Cin, Cout, k, stride), N, H, W, Cin, Cout, k, stride)


@given(steps=st.integers(1, 20000), splits=st.integers(1, 64))
@settings(max_examples=300, deadline=None)
def test_split_range_covers_every_step_once(steps, splits):
    assume(splits <= steps)
    ranges = [QC.split_range(steps, splits, j) for j in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [s1 - s0 for s0, s1 in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("shape,tile_n", [
    ((1, 135, 240, 256, 108, 3, 1), 112), ((1, 135, 240, 256, 72, 3, 1), 80), ((1, 20, 30, 144, 40, 3, 1), 48),
    ((1, 270, 480, 256, 64, 1, 1), 64), ((1, 135, 240, 512, 128, 1, 1), 128), ((1, 135, 240, 128, 512, 1, 1), 256),
])
def test_narrow_layers_run_at_the_next_wgmma_width(shape, tile_n):
    """The head output convs' 108 and 72 filters at N = 112 and 80."""
    assert QC.launch_plan(*shape).tile_n == tile_n


@pytest.mark.parametrize("shape,tile_n", [
    ((1, 135, 240, 256, 256, 3, 1), 256),  # 254 tiles of 256: two waves either way, the wider tile cheaper
    ((1, 68, 120, 256, 256, 3, 1), 128),  # 64 tiles of 256 would leave half the SMs idle: 128 of 128
    ((1, 34, 60, 256, 256, 3, 1), 128), ((32, 7, 7, 256, 256, 3, 1), 128),  # P5, the crop net's 7x7
    ((1, 68, 120, 256, 1024, 1, 1), 256),  # 256 tiles of 256 fill the card
])
def test_wide_layers_on_few_tiles_take_128_wide_tiles(shape, tile_n):
    plan = QC.launch_plan(*shape)
    assert plan.tile_n == tile_n
    _check_plan(plan, *shape)


@pytest.mark.parametrize("shape,split", [
    ((1, 135, 240, 256, 256, 3, 1), False),  # 254 tiles: more than the card's SMs
    ((1, 68, 120, 256, 256, 3, 1), False),  # 64 tiles: adding the partial tiles costs more than it saves
    ((1, 17, 30, 256, 256, 3, 1), True), ((1, 9, 15, 256, 256, 3, 1), True),  # P6, P7
    ((1, 34, 60, 256, 256, 3, 1), False),  # P5: 16 tiles
    ((32, 4, 4, 512, 512, 3, 1), True), ((32, 1, 1, 256, 256, 3, 1), True),  # crop-net maps
    ((1, 34, 60, 2048, 256, 3, 2), True),  # FPN P6 from C5
    ((32, 14, 14, 128, 256, 1, 1), False),  # one step: nothing to split
])
def test_small_maps_split_k(shape, split):
    plan = QC.launch_plan(*shape)
    assert (plan.splits > 1) == split
    _check_plan(plan, *shape)


# ---- the residual tail -----------------------------------------------------------


def _unfused_tail(acc, scale, offset, res, res_xs, emit_xs):
    """The block's tail as separate tensor ops: the last conv's bfloat16
    output, the residual dequantized as ``_chain_f`` does, add, relu,
    requantize as ``_chain_requant`` does."""
    hf = QC.epilogue_plain(acc, scale, offset, False, None)
    r = res.to(torch.bfloat16) * res_xs.to(torch.bfloat16) if res.dtype == torch.int8 else res
    out = torch.relu(hf + r)
    return out if emit_xs is None else PQ._quantize_act(out, emit_xs)


@pytest.mark.parametrize("res_kind", ["int8", "bf16"])
@pytest.mark.parametrize("emit", [None, 0.061])
@pytest.mark.parametrize("with_offset", [True, False])
def test_residual_epilogue_equals_unfused_tail(res_kind, emit, with_offset):
    gen = torch.Generator().manual_seed(21)
    acc = torch.randint(-300000, 300000, (2, 5, 7, 40), generator=gen, dtype=torch.int32)
    scale = torch.rand(40, generator=gen) * 2e-5
    offset = torch.randn(40, generator=gen) if with_offset else None
    if res_kind == "int8":
        res, res_xs = torch.randint(-127, 128, acc.shape, generator=gen, dtype=torch.int8), torch.tensor(0.0371)
    else:
        res, res_xs = (torch.randn(acc.shape, generator=gen) * 3).to(torch.bfloat16), None
    emit_xs = None if emit is None else torch.tensor(emit)
    got = QC.epilogue_plain(acc, scale, offset, False, emit_xs, res, res_xs)
    want = _unfused_tail(acc, scale, offset, res, torch.tensor(0.0371), emit_xs)
    assert got.dtype == want.dtype == (torch.bfloat16 if emit is None else torch.int8)
    assert torch.equal(got, want)
    assert 0.2 < float((got == 0).float().mean()) < 0.8  # the relu cuts a real share


@pytest.fixture(scope="module")
def quantized_nets():
    """Port-only quantized ResNet-18 and ResNet-50 detectors (s2d stems),
    calibrated on one small uint8 frame."""
    calib = torch.randint(0, 256, (1, 16, 24, 48), generator=torch.Generator().manual_seed(3), dtype=torch.uint8)
    return {depth: PQ.quantize_detector(retinanet_init(torch.Generator().manual_seed(depth), depth=depth,
                                                       stem="s2d", tower_depth=1, device="cpu"), calib)
            for depth in (18, 50)}


@pytest.mark.parametrize("depth", [18, 50], ids=["basic", "bottleneck"])
@pytest.mark.parametrize("res_kind", ["int8", "bf16"])
@pytest.mark.parametrize("out_int8", [True, False], ids=["int8_out", "bf16_out"])
def test_fused_block_equals_unfused_block(quantized_nets, depth, res_kind, out_int8):
    """layer2[1] (identity residual: the int8 block input) and layer2[0]
    (``down_conv``'s bfloat16 output) on an int8 input, out at the next
    block's input scale or in bfloat16."""
    bb = quantized_nets[depth].backbone
    bp = bb.layer2[1] if res_kind == "int8" else bb.layer2[0]
    last = bp.conv2 if depth == 18 else bp.conv3
    assert last.wq is not None  # the tail is fused
    cin = bp.conv1.w.shape[1]
    gen = torch.Generator().manual_seed(depth + out_int8)
    q = torch.randint(-127, 128, (2, 8 if res_kind == "int8" else 16, 12 if res_kind == "int8" else 24, cin),
                      generator=gen, dtype=torch.int8)
    cur = ("i8", q.permute(0, 3, 1, 2), torch.tensor(0.0213))
    out_xs = bb.layer2[2 if depth == 50 else 1].conv1.xs if out_int8 else None
    got = PQ._chain_block(bp, cur, out_xs, basic=depth == 18)
    want = PQ._chain_block_unfused(bp, cur, out_xs, basic=depth == 18)
    assert got[0] == want[0] == ("i8" if out_int8 else "f")
    assert got[1].dtype == want[1].dtype and got[1].shape == want[1].shape
    assert torch.equal(got[1], want[1])
    if out_int8:
        assert got[2] is out_xs
    assert float((got[1] != 0).float().mean()) > 0.1  # not all cut by the relu
