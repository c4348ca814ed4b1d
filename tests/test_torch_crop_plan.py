"""What the host decides for the CUDA crop-and-resize kernel, tested without
a card: ``ops/crop_resize.py::launch_plan`` (tile of output rows, grid,
shared-memory bytes, from shapes alone) and what ``check_args`` takes and
refuses, and that ``csrc/crop_resize.cu`` holds the same layout constants.
The kernel itself is held against the plain version on the card
(``chip_smoke.py``).
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from playground3d_tpu_torch.ops import crop_resize
from playground3d_tpu_torch.ops.crop_resize import (
    COLUMN_BYTES, HEADER_BYTES, MAX_SMEM_BYTES, MAX_TILE_ROWS, THREADS, TILE_ROWS, launch_plan,
)

torch.set_num_threads(1)


def _check_plan(plan, S, n):
    """The invariants of every plan."""
    assert plan.threads == THREADS == 256
    assert plan.tile_rows == min(TILE_ROWS, S) <= MAX_TILE_ROWS
    assert plan.smem_bytes == HEADER_BYTES + COLUMN_BYTES * S <= MAX_SMEM_BYTES
    assert HEADER_BYTES >= MAX_TILE_ROWS * (8 + 4 + 2 * 4)  # room for the row table
    # every output row lies in exactly one tile, and no tile is empty
    covered = [i for t in range(plan.tiles) for i in range(t * plan.tile_rows, min((t + 1) * plan.tile_rows, S))]
    assert covered == list(range(S))
    assert (plan.tiles - 1) * plan.tile_rows < S
    assert plan.tiles * n <= crop_resize.MAX_BLOCKS


@pytest.mark.parametrize("S,n,tile,tiles", [
    (112, 32, 8, 14),  # the main path: 448 blocks, all resident at once
    (112, 4096, 8, 14),
    (112, 8, 8, 14),  # the tile does not depend on the number of crops
    (37, 7, 8, 5),  # a last tile of 5 rows
    (37, 1, 8, 5),
    (1, 1, 1, 1),
    (5, 3, 5, 1),  # a crop lower than a tile
    (600, 1, 8, 75),
])
def test_launch_plan_cases(S, n, tile, tiles):
    plan = launch_plan(S, n)
    assert (plan.tile_rows, plan.tiles) == (tile, tiles)
    _check_plan(plan, S, n)


@settings(max_examples=300, deadline=None, database=None)
@given(S=st.integers(1, 2000), n=st.integers(1, 100000))
def test_launch_plan_invariants(S, n):
    _check_plan(launch_plan(S, n), S, n)


@pytest.mark.parametrize("kwargs,reason", [
    (dict(out_size=20000), "column table"),
    (dict(out_size=0), "empty"),
    (dict(out_size=16, n=0), "empty"),
    (dict(out_size=1, n=2**31), "blocks"),
])
def test_launch_plan_refuses_by_name(kwargs, reason):
    with pytest.raises(ValueError, match=reason):
        launch_plan(**kwargs)


def _cu_constant(name):
    """An integer ``constexpr int`` of csrc/crop_resize.cu, its initialiser
    evaluated with the constants defined before it."""
    env = {}
    for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", crop_resize.SOURCE.read_text()):
        env[m.group(1)] = eval(m.group(2), {"__builtins__": {}}, dict(env))
    return env[name]


@pytest.mark.parametrize("cu_name,py_value", [
    ("kThreads", THREADS),
    ("kMaxTileRows", MAX_TILE_ROWS),
    ("kOffCols", HEADER_BYTES),
    ("kColBytes", COLUMN_BYTES),
    ("kMaxSmemBytes", MAX_SMEM_BYTES),
])
def test_kernel_source_holds_the_plans_constants(cu_name, py_value):
    """The launcher in the .cu derives grid and shared-memory bytes from the
    tile height by launch_plan's rule: both sides must hold the same layout."""
    assert _cu_constant(cu_name) == py_value


def _args(frames, n=2):
    return frames, torch.zeros((n, 4)), torch.zeros(n, dtype=torch.int32)


def test_check_args_takes_a_view_at_an_odd_storage_offset():
    """Pixels are read in place with one-element loads, so a view that starts
    3 bytes into its storage is taken as it is."""
    base = torch.zeros(3 + 2 * 9 * 11 * 3, dtype=torch.uint8)
    view = base[3:].view(2, 9, 11, 3)
    assert view.data_ptr() % 16 != base.data_ptr() % 16
    crop_resize.check_args(*_args(view), 16)
    crop_resize.check_args(*_args(torch.zeros(1 + 9 * 11 * 3)[1:].view(1, 9, 11, 3)), 16)


def test_check_args_refuses_an_output_size_above_shared_memory():
    frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="column table"):
        crop_resize.check_args(*_args(frames, 1), 20000)
    crop_resize.check_args(*_args(frames, 0), 20000)  # nothing to launch: nothing to refuse


def test_check_args_refuses_frames_off_their_element_boundary():
    """float32 frames 2 bytes past a 4-byte boundary (numpy and torch both
    allow the view) would fault the kernel's 4-byte loads."""
    raw = np.zeros(2 + 4 * 8 * 8 * 3, np.uint8)
    crop_resize.check_args(*_args(torch.from_numpy(raw[:-2].view(np.float32)).view(1, 8, 8, 3)), 16)
    off = torch.from_numpy(raw[2:].view(np.float32)).view(1, 8, 8, 3)
    assert off.data_ptr() % 4 == 2
    with pytest.raises(ValueError, match="boundary"):
        crop_resize.check_args(*_args(off), 16)
