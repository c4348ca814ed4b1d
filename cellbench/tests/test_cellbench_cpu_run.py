"""One cell's set-up and a few clips at a tiny size on the CPU: the whole
run but the look for a card, its checks sound, no device metric."""

import json
import subprocess
import sys

import pytest

from cellbench import run
from cellbench.manifest import ROOT, Manifest
from cellbench.tests.tiny import tiny_cell

CELLS = [("r50_s2d_int8", "pole6_yuv_backlog"), ("r50_conv7_bf16", "pole6_rgb_backlog")]
SEED = 2**31 + 2**30 + 17  # larger than 32 signed bits hold


@pytest.mark.parametrize("config,traffic", CELLS)
def test_tiny_cell_runs_and_is_correct(config, traffic):
    cfg, tr = tiny_cell(config, traffic)
    e2e = Manifest().data["end_to_end"]
    res = run.run_cell(cfg, tr, SEED, 1.0, False, "cpu", end_to_end=e2e)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"camera_frames_per_s", "setup_s"}
    assert res["device"] == {"platform": "cpu"}  # no device number from a CPU run
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 for c in res["checks"].values())


@pytest.mark.parametrize("config,traffic", CELLS)
def test_crop_bytes_from_the_rows_read_back_match_the_reference_crops(config, traffic):
    # the window's crop bytes are worked out from the rows the program read
    # back; on the clips the check ran they equal those of the boxes the
    # reference's own crop branch made (every live track cropped, so which
    # the branch picks does not enter)
    cfg, tr = tiny_cell(config, traffic)
    cfg["tracker"]["crop_slots"] = cfg["tracker"]["max_tracks"]
    keep: dict = {}
    run.run_cell(cfg, tr, SEED + 5, 1.0, False, "cpu", keep=keep)
    ref, calls, tc = keep["ref"], keep["calls"], cfg["tracker"]
    frames = [calls[i][3] + j for i in keep["chosen"] for j in range(tr["clip_len"])
              if j % tc["det_step"] and j % tc["skip_step"] == 0]
    got = ref.crop_bytes_from_rows(keep["rows"], keep["epoch"], calls, keep["jitter"], frames)
    assert len(got) == len(ref.crop_bytes) > 0 and sum(ref.crop_bytes) > 0
    assert got == pytest.approx(ref.crop_bytes, rel=1e-3)


def test_same_seed_same_inputs():
    from cellbench import cell

    _, tr = tiny_cell(*CELLS[0])
    a = cell.frame_rings(tr, cell.sub_seed(SEED, 1), "cpu")
    b = cell.frame_rings(tr, cell.sub_seed(SEED, 1), "cpu")
    c = cell.frame_rings(tr, cell.sub_seed(SEED + 1, 1), "cpu")
    assert (a == b).all() and not (a == c).all()


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "cellbench.run", "--workload", "r50_s2d_int8.pole6_yuv_backlog",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                                           "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
