"""``correct`` comes out false when the timed path is broken underneath,
once for each fault the cells can have, and for the control (the
reference in the precision below the configuration's): all at a tiny size
on the CPU, the whole run but the look for a card."""

import pytest
import torch

from cellbench import control, program, run
from cellbench.tests.tiny import tiny_cell

SEED = 2**31 + 12345


def state_unchanged(clip):
    def broken(state, ts_bias, frames, cam_times, frame0):
        _, _, snaps = clip(state, ts_bias, frames, cam_times, frame0)
        return state, ts_bias, snaps
    return broken


def half_the_cameras(clip):
    def broken(state, ts_bias, frames, cam_times, frame0):
        frames = frames.clone()
        frames[:, frames.shape[1] // 2:] = 0
        return clip(state, ts_bias, frames, cam_times, frame0)
    return broken


def altered_answer(clip):
    def broken(state, ts_bias, frames, cam_times, frame0):
        st, tb, snaps = clip(state, ts_bias, frames, cam_times, frame0)
        return st, tb, snaps._replace(states7=snaps.states7 + 1.0)
    return broken


@pytest.mark.parametrize("fault", [state_unchanged, half_the_cameras, altered_answer])
def test_fault_is_not_correct(monkeypatch, fault):
    cfg, tr = tiny_cell("r50_s2d_int8", "pole6_yuv_backlog")
    real = program.build

    def faulty_build(*args, **kw):
        trk, rec = real(*args, **kw)
        rec.clip = fault(rec.clip)
        return trk, rec

    monkeypatch.setattr(program, "build", faulty_build)
    res = run.run_cell(cfg, tr, SEED, 1.0, False, "cpu")
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("config,traffic", [("r50_s2d_int8", "pole6_yuv_backlog"),
                                            ("r50_conv7_bf16", "pole6_rgb_backlog")])
def test_control_is_not_correct(config, traffic):
    cfg, tr = tiny_cell(config, traffic)
    keep: dict = {}
    res = run.run_cell(cfg, tr, SEED, 1.0, False, "cpu", keep=keep)
    assert res["correct"] is True
    numbers = control.control_numbers(cfg, tr, keep, "cpu")
    assert any(numbers[k] > cfg["limits"][k] for k in numbers)
    torch.set_num_threads(2)


@pytest.mark.chip
def test_control_on_the_card(card):
    """The control at the cells' own widths on the card, two cameras and a
    short window (the full-size readings come from ``cellbench.control``)."""
    from cellbench.manifest import Manifest

    man = Manifest()
    for wl in man.data["workloads"]:
        cfg, tr = man.config(wl["config"]), man.traffic(wl["traffic"])
        tr = dict(tr, cameras=tr["cameras"][:2], warm_clips=2, check_clips=1)
        keep: dict = {}
        res = run.run_cell(cfg, tr, SEED, 2.0, False, card, keep=keep)
        assert res["correct"] is True, res["checks"]
        numbers = control.control_numbers(cfg, tr, keep, card)
        assert any(numbers[k] > cfg["limits"][k] for k in numbers), numbers
