"""The yardstick's arithmetic on known shapes."""

from types import SimpleNamespace

import pytest
import torch

from cellbench import archs, counts
from cellbench.manifest import Manifest
from cellbench.run import branch_frames

MAN = Manifest()


def test_qconv_launch():
    # a 3x3 conv, 64 -> 128 channels over 2 x 10 x 12 pixels, int8 out, no residual
    macs, act, w = counts.qconv_launch((2, 10, 12, 64), (128, 3, 3, 64), (2, 10, 12, 128), True, 0)
    assert macs == 2 * 10 * 12 * 128 * 64 * 9
    assert act == 2 * 10 * 12 * 64 + 2 * 10 * 12 * 128
    assert w == 128 * 9 * 64 + 128 * 8
    _, act16, _ = counts.qconv_launch((1, 4, 4, 8), (16, 1, 1, 8), (1, 4, 4, 16), False, 100)
    assert act16 == 128 + 256 * 2 + 100


def test_qconv_bound_takes_the_larger_side():
    ops_bound = counts.qconv_bound_s([(1_000_000_000, 1, 0)])
    assert ops_bound == pytest.approx(2e9 / counts.INT8_OPS_PER_S)
    bytes_bound = counts.qconv_bound_s([(1, 3_350_000, 0)])
    assert bytes_bound == pytest.approx(1e-6)
    assert counts.qconv_bound_s([(1_000_000_000, 1, 0), (1, 3_350_000, 0)]) == pytest.approx(ops_bound + bytes_bound)
    # activations and weights together
    assert counts.qconv_bound_s([(1, 1_000_000, 2_350_000)]) == pytest.approx(1e-6)


def test_crop_bytes_count_the_pixels_the_samples_read():
    # a 4 x 4 crop of a 40 x 40 box: 4 samples an axis, 2 taps each, all distinct
    boxes = torch.tensor([[0.0, 0.0, 40.0, 40.0], [10.0, 10.0, 12.0, 12.0], [-5.0, -5.0, 3.0, 3.0]])
    assert counts.tap_pixels(boxes[:1], 100, 100, 4) == 8 * 8
    # a box smaller than the crop: the taps overlap, each pixel once (columns 9-12)
    assert counts.tap_pixels(boxes[1:2], 100, 100, 4) == 4 * 4
    # a box over the frame's corner: taps clipped to the frame (columns 0-2)
    assert counts.tap_pixels(boxes[2:], 100, 100, 4) == 3 * 3
    live = torch.tensor([True, True, False])
    assert counts.crop_frame_bytes(boxes, live, 100, 100, 4, 2) == (64 + 16) * 3 + 2 * 4 * 4 * 3 * 2


def test_yuv420_bytes_a_clip_of_one_camera():
    assert counts.yuv420_bytes(24, 1080, 1920) == 223_948_800


def test_net_ops_of_one_conv_net():
    tiny = {"num_classes": 8, "depth": 18, "stem": "conv7", "tower_depth": 1, "shared_tower": True,
            "feature_size": 32}
    arch = archs.of(tiny)
    one, two = arch.ops(tiny, (1, 64, 96, 3), "bf16")["bf16"], arch.ops(tiny, (2, 64, 96, 3), "bf16")["bf16"]
    assert two == 2 * one
    # the 7x7/2 stem alone: 32 x 48 outputs x 64 filters x 7 x 7 x 3
    assert one > 2 * 32 * 48 * 64 * 49 * 3


def test_branch_frames():
    assert branch_frames(24, 6, 3) == {"detect": 4, "crop": 4, "passthrough": 16}
    assert branch_frames(48, 6, 3) == {"detect": 8, "crop": 8, "passthrough": 32}


def ctx(**kw):
    base = dict(camera_frames=600, clips=10, frames=240, window_s=2.0, timers={"stage": 0.3},
                clip_starts_ns=[i * 200_000_000 for i in range(10)], trace=None, replay_ms={},
                branch_frames=branch_frames(240, 6, 3), det_ops={"int8": 5e12}, crop_ops={"int8": 7e10},
                cfg={"precision": "int8", "peak_ops_per_s": 1e15, "crop_kernels": ["sample_kernel"],
                     "tracker": {"det_step": 6}}, clip_len=24,
                traffic={"format": "yuv420", "height": 1080, "width": 1920}, qconv_frames={}, crop_bytes=[])
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers_on_known_numbers():
    assert MAN.reader("host_stage_ms_per_frame").read(ctx()) == pytest.approx(0.5)
    # clip calls 200 ms apart but one 900 ms stall among 9 gaps: the 95th percentile sees it
    starts = [i * 200_000_000 for i in range(9)] + [8 * 200_000_000 + 900_000_000]
    p95 = MAN.reader("clip_gap_ms_p95").read(ctx(clip_starts_ns=starts))
    assert 600 < p95 <= 900
    mfu = MAN.reader("mfu_pct").read(ctx())
    assert mfu == pytest.approx(100 * (40 * 5e12 + 40 * 7e10) / 2.0 / 1e15)
    assert MAN.reader("detect_replay_ms").read(ctx(replay_ms={"frame": 40.0, "detect": 1.5})) == 41.5
    for name in ("qconv_roofline", "crop_roofline", "yuv420_roofline", "nms_auction_us_per_clip",
                 "device_idle_pct", "crop_replay_ms"):
        assert MAN.reader(name).read(ctx()) is None, name  # nothing to read: no trace, no replays


class FakeTrace:
    def __init__(self, kernels, busy_s=1.5):
        self.kernels, self.busy_s, self.events = kernels, busy_s, 1

    def kernel_seconds(self, names):
        from cellbench.trace import DeviceTrace

        return DeviceTrace.kernel_seconds(self, names)


def test_trace_readers():
    tr = FakeTrace({"void (anonymous namespace)::qconv_kernel<256>(CUtensorMap_st)": [0.5, 100],
                    "void (anonymous namespace)::yuv420_s2d_kernel(unsigned char const*)": [0.1, 10],
                    "void (anonymous namespace)::auction_kernel<true, 8>(float const*)": [0.002, 10],
                    "void at::native::vectorized_elementwise_kernel<4>(int)": [0.9, 1000]})
    frames = {"detect": [(10**9, 10**6, 10**8)], "crop": [(10**6, 10**5, 10**4)]}
    c = ctx(trace=tr, qconv_frames=frames)
    want = 40 * counts.qconv_bound_s(frames["detect"]) + 40 * counts.qconv_bound_s(frames["crop"])
    assert MAN.reader("qconv_roofline").read(c) == pytest.approx(100 * want / 0.5)
    assert MAN.reader("yuv420_roofline").read(c) == pytest.approx(
        100 * counts.yuv420_bytes(600, 1080, 1920) / counts.HBM_BYTES_PER_S / 0.1)
    assert MAN.reader("nms_auction_us_per_clip").read(c) == pytest.approx(200.0)
    # 335 MB over the window's crop frames in 1 ms of the crop kernels: a tenth of 3.35 TB/s
    crop_trace = FakeTrace({"void (anonymous namespace)::sample_kernel<4>(float const*)": [0.001, 40]})
    assert MAN.reader("crop_roofline").read(ctx(trace=crop_trace, crop_bytes=[335_000_000, 0, 0])) == pytest.approx(10.0)
    assert MAN.reader("crop_roofline").read(ctx(trace=crop_trace, crop_bytes=[0, 0])) is None
    assert MAN.reader("device_idle_pct").read(c) == pytest.approx(25.0)


def test_busy_and_gaps():
    from cellbench.trace import busy_and_gaps, label_gaps

    # two overlapping kernels and a copy, in a window of 100 ns
    busy, gaps = busy_and_gaps([10, 15, 60], [30, 40, 70], 0, 100)
    assert busy == pytest.approx(40e-9)
    assert gaps == [(70, 100), (40, 60), (0, 10)]
    # calls at 0-5 and 50-55 (perf ns; offset 0); the second clip's last frame handed at 45
    labels = label_gaps([(3, 4), (20, 30), (56, 60), (-5, -1)], [(0, 5), (50, 55)], [0, 45], 0)
    assert [w for w, _ in labels] == ["in_enqueue", "await_producer", "after_last_call", "before_first_call"]
    assert label_gaps([(46, 48)], [(0, 5), (50, 55)], [0, 45], 0)[0][0] == "between_calls"
